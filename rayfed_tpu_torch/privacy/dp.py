# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Differential privacy for federated aggregation: per-party clipping,
aggregator-side Gaussian noise, and the per-party epsilon ledger (port of
``rayfed_tpu/privacy/dp.py``).

The mechanism is DP-FedAvg (McMahan et al. 2018): each party clips its
update to L2 norm ``privacy.clip_norm`` BEFORE it leaves the party (so
the sensitivity bound holds even against the aggregator), and the root
adds Gaussian noise with per-coordinate stddev
``noise_multiplier * clip_norm / n`` to the aggregated MEAN — the
standard calibration for sensitivity ``clip_norm / n`` of one party's
contribution to the mean of ``n``.

Everything runs on the device of the leaves, in the JAX package's bits:

- the norm sums each leaf's f64 squares in numpy's pairwise order (blocks
  of at most 128 with eight accumulators, halved at multiples of 8), and
  the leaf totals in JAX's leaf order, so the clip factor is the JAX
  package's to the last bit;
- the clipped and noised leaves are cast back to the leaf dtype as numpy
  casts them (float16 through ``secagg._cast``);
- the noise is threefry ``normal`` keyed on ``(noise_seed, round)`` and
  the leaf index, so every replica of the root adds the same bits as a
  JAX root.

The ledger accounts a per-round epsilon for the Gaussian mechanism at
the configured delta (``eps = sqrt(2 ln(1.25/delta)) / z``, the classic
analytic bound) and composes rounds with BASIC composition — a
deliberately conservative over-estimate; callers wanting moments
accounting can post-process the per-round record the snapshot exposes.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.privacy import threefry
from rayfed_tpu_torch.privacy.secagg import _cast, _leaves, dtype_name

#: numpy's pairwise summation: blocks of at most this many elements.
_PW_BLOCK = 128
#: numpy's reduction buffer: its inner loop sums this many at a time.
_NP_BUFSIZE = 8192
#: Blocks summed per gather, bounding the temporaries of a large leaf.
_BLOCKS_PER_PASS = 1 << 16


def _as_f64(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().double()
    return torch.as_tensor(np.asarray(leaf, dtype=np.float64))


def _pairwise_tree(n: int):
    """The segments of numpy's pairwise sum of ``n`` elements, level by
    level: ``levels[i]`` holds the segment lengths at depth ``i`` and
    ``splits[i]`` which of them halve (a segment of at most 128 is a leaf
    and is carried down unchanged)."""
    levels = [np.array([n], dtype=np.int64)]
    splits = []
    while True:
        lens = levels[-1]
        sp = lens > _PW_BLOCK
        if not sp.any():
            return levels, splits
        half = lens // 2
        half -= half % 8
        left = np.where(sp, half, lens)
        right = lens - left
        nxt = np.stack([left, right], axis=1).reshape(-1)
        keep = np.stack([np.ones_like(sp), sp], axis=1).reshape(-1)
        splits.append(sp)
        levels.append(nxt[keep])


def _block_sums(a: torch.Tensor, starts: np.ndarray,
                lens: np.ndarray) -> torch.Tensor:
    """numpy's unrolled sum of each block ``a[start:start+len]`` (8 <=
    len <= 128): eight strided accumulators, combined as ((0+1)+(2+3))+
    ((4+5)+(6+7)), then the tail added in order. Gathers pad with a zero,
    which adds nothing to a sum of squares."""
    n = a.numel()
    padded = torch.cat([a, a.new_zeros(1)])
    dev = a.device
    out = []
    rows = torch.arange(_PW_BLOCK // 8, device=dev)[:, None] * 8
    lanes = torch.arange(8, device=dev)[None, :]
    for lo in range(0, len(starts), _BLOCKS_PER_PASS):
        st = torch.as_tensor(starts[lo:lo + _BLOCKS_PER_PASS], device=dev)
        ln = torch.as_tensor(lens[lo:lo + _BLOCKS_PER_PASS], device=dev)
        full = ln - ln % 8
        off = rows[None] + lanes[None]                     # (1, 16, 8)
        idx = torch.where(off < full[:, None, None], st[:, None, None] + off,
                          torch.full_like(off, n))
        g = padded[idx]                                    # (b, 16, 8)
        r = g[:, 0]
        for i in range(1, _PW_BLOCK // 8):
            r = r + g[:, i]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + (
            (r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for k in range(7):
            i = torch.where(k < ln % 8, st + full + k, torch.full_like(st, n))
            res = res + padded[i]
        out.append(res)
    return torch.cat(out)


def _pairwise_rows(rows: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of each row of ``rows`` (m, L), each level of
    its recursion one vectorized step over every row."""
    m, n = rows.shape
    blocks = n // _PW_BLOCK
    if n % _PW_BLOCK == 0 and blocks & (blocks - 1) == 0:
        # A power of two of full blocks (numpy's 8192-element chunks):
        # every halving is even, so the tree sums adjacent pairs.
        g = rows.reshape(m, blocks, _PW_BLOCK // 8, 8)
        r = g[:, :, 0]
        for i in range(1, _PW_BLOCK // 8):
            r = r + g[:, :, i]
        sums = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
            (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        while sums.shape[1] > 1:
            sums = sums[:, 0::2] + sums[:, 1::2]
        return sums[:, 0]
    if n < 8:
        res = rows.new_zeros(m)
        for j in range(n):
            res = res + rows[:, j]
        return res
    levels, splits = _pairwise_tree(n)
    leaf_lens = levels[-1]
    starts = np.concatenate([[0], np.cumsum(leaf_lens)[:-1]])
    starts = (np.arange(m)[:, None] * n + starts[None, :]).reshape(-1)
    sums = _block_sums(rows.reshape(-1), starts,
                       np.tile(leaf_lens, m)).reshape(m, -1)
    for sp in reversed(splits):
        # Each segment's first child sits at the running count of the
        # children before it; a split segment adds its two children.
        first = torch.as_tensor(np.concatenate([[0], np.cumsum(1 + sp)[:-1]]),
                                device=rows.device)
        sp_t = torch.as_tensor(sp, device=rows.device)
        left = sums[:, first]
        right = sums[:, torch.where(sp_t, first + 1, first)]
        sums = torch.where(sp_t, left + right, left)
    return sums[:, 0]


def pairwise_sum(a: torch.Tensor) -> float:
    """``float(np.sum(a))`` of a flat f64 tensor, bit for bit, computed on
    its device. numpy's reduction hands its inner loop :data:`_NP_BUFSIZE`
    elements at a time and adds each chunk's pairwise sum to a running
    total that starts at 0."""
    n = a.numel()
    full = n // _NP_BUFSIZE
    parts = []
    if full:
        parts.append(_pairwise_rows(
            a[:full * _NP_BUFSIZE].reshape(full, _NP_BUFSIZE)))
    if n % _NP_BUFSIZE:
        parts.append(_pairwise_rows(a[full * _NP_BUFSIZE:].reshape(1, -1)))
    total = 0.0
    for v in (torch.cat(parts).tolist() if parts else []):
        total += v
    return total


def _jax_positions(tree: Any):
    """``tree``'s leaves (in its own order), its spec, and the position
    of each leaf in JAX's leaf order (JAX sorts dict keys)."""
    leaves, spec = tree_util.tree_flatten(tree)
    pos = tree_util.tree_unflatten(list(range(len(leaves))), spec)
    return leaves, spec, _leaves(pos)[0]


def tree_l2_norm(tree: Any) -> float:
    """The global L2 norm: each leaf's f64 squares summed as numpy sums
    them, the leaf totals added in JAX's leaf order."""
    total = 0.0
    for leaf in _leaves(tree)[0]:
        arr = _as_f64(leaf).reshape(-1)
        total += pairwise_sum(arr * arr)
    return math.sqrt(total)


def _cast_back(x64: torch.Tensor, like: Any) -> Any:
    """An f64 result cast to ``like``'s dtype as numpy's ``astype`` casts
    it."""
    if isinstance(like, torch.Tensor):
        if like.is_floating_point():
            return _cast(x64, dtype_name(like.dtype))
        return x64.to(like.dtype)
    return np.asarray(x64.cpu().numpy()).astype(np.asarray(like).dtype)


def clip_tree(tree: Any, clip_norm: float) -> Any:
    """Scale the whole tree so its global L2 norm is at most
    ``clip_norm`` (identity when already within the ball — bit-
    preserving, so clipping never perturbs an in-bound update)."""
    norm = tree_l2_norm(tree)
    if norm <= clip_norm or norm == 0.0:
        return tree
    factor = clip_norm / norm
    return tree_util.tree_map(
        lambda x: _cast_back(_as_f64(x) * factor, x), tree)


def gaussian_noise_tree(
    tree: Any, stddev: float, seed: int, round_index: int
) -> Any:
    """Add iid N(0, stddev^2) per coordinate, drawn from the threefry
    stream keyed on (seed, round) and then on the leaf's index in JAX's
    leaf order, so every replica of the root task (a JAX root included)
    adds the identical noise (the determinism contract survives DP).
    Leaf by leaf on the leaf's device; ``x64 + noise64 * stddev`` is two
    separate roundings, as numpy computes it."""
    if stddev <= 0.0:
        return tree
    key = threefry.prng_key(int(seed) % (1 << 63))
    key = threefry.fold_in(key, int(round_index) & 0x7FFFFFFF)
    leaves, spec, order = _jax_positions(tree)
    out = list(leaves)
    for idx, pos in enumerate(order):
        leaf = leaves[pos]
        arr = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        noise = threefry.normal(threefry.fold_in(key, idx), arr.shape,
                                arr.device).double()
        noise = noise * stddev
        out[pos] = _cast_back(arr.double() + noise, leaf)
        del noise
    return tree_util.tree_unflatten(out, spec)


def gaussian_epsilon(noise_multiplier: float, delta: float) -> float:
    """Per-round epsilon of the Gaussian mechanism at noise multiplier
    ``z`` (stddev / sensitivity) and ``delta``: the analytic
    ``sqrt(2 ln(1.25/delta)) / z`` bound (valid for eps <= 1 regimes;
    reported as-is otherwise — the ledger is an accounting surface, not
    a proof)."""
    if noise_multiplier <= 0.0:
        return math.inf
    return math.sqrt(2.0 * math.log(1.25 / delta)) / noise_multiplier


class PrivacyLedger:
    """Per-party, per-session epsilon accounting.

    ``record_round`` charges every contributing party one Gaussian-
    mechanism round; ``snapshot`` is msgpack-clean (it rides telemetry
    and ``fed.privacy_ledger()``)."""

    def __init__(self, delta: float) -> None:
        self._delta = float(delta)
        self._lock = threading.Lock()
        self._rounds: Dict[str, int] = {}
        self._epsilon: Dict[str, float] = {}

    def record_round(
        self, parties, noise_multiplier: Optional[float]
    ) -> None:
        if not noise_multiplier:
            return
        eps = gaussian_epsilon(float(noise_multiplier), self._delta)
        with self._lock:
            for p in parties:
                self._rounds[p] = self._rounds.get(p, 0) + 1
                self._epsilon[p] = self._epsilon.get(p, 0.0) + eps

    def epsilon(self, party: str) -> float:
        with self._lock:
            return self._epsilon.get(party, 0.0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                p: {
                    "epsilon": self._epsilon[p],
                    "delta": self._delta,
                    "rounds": self._rounds[p],
                }
                for p in sorted(self._epsilon)
            }

    def restore(self, snapshot: Optional[Dict[str, Dict]]) -> None:
        """Reload a :meth:`snapshot` (a job checkpoint cut): the spent
        budget must survive a restart — a ledger that resets with the
        process would under-count every pre-crash round's epsilon."""
        with self._lock:
            for p, rec in (snapshot or {}).items():
                self._rounds[p] = int(rec.get("rounds", 0))
                self._epsilon[p] = float(rec.get("epsilon", 0.0))
