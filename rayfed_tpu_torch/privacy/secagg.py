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

"""Pairwise-mask secure aggregation over a fixed-point ring (port of
``rayfed_tpu/privacy/secagg.py``).

The scheme (Bonawitz et al. 2017 shape, docs/privacy.md):

1. Every unordered party pair ``(i, j)`` agrees a seed ``s_ij`` over
   authenticated ``prv:`` control frames (privacy/protocol.py).
2. A contribution's float leaves are encoded into the ring ``Z_{2^32}``
   as fixed-point words: ``q = rint(x * 2^f)`` reduced mod ``2^32``.
   Modular addition is exact and associative, so mask cancellation is
   bitwise by construction.
3. Party ``i`` adds, per leaf, ``+stream(s_ij)`` for every partner
   ``j > i`` and ``-stream(s_ij)`` for every ``j < i`` (mod ``2^32``);
   the ring sum of all masked contributions is the ring sum of the plain
   encodings.
4. The root decodes the sum to the leaf dtype and applies the plaintext
   fold's own scaling ops (``federated.py``), so the secure aggregate is
   bitwise the plaintext one wherever both arithmetics are exact.
5. Dropout recovery: survivors re-offer their seeds with a dead party
   (``prv:recover``); the root regenerates its orphaned streams and
   subtracts them.

The port computes the same words as the JAX package on any device:

- the mask streams are ``jax.random.bits`` words from this package's
  threefry (``privacy/threefry.py``), keyed by (pair seed, domain,
  round, leaf index) through ``fold_in`` as the reference keys them;
- leaves are numbered in JAX's order: :func:`jax_order` sorts every
  dict's keys as ``jax.tree_util`` does (this package's trees keep
  insertion order), so encode, masks, decode and the orphan correction
  put each stream on the leaf a JAX party puts it on;
- the words are int64 tensors in ``[0, 2**32)`` on the leaf's device
  (``torch.uint32`` cannot add); an envelope carries them as
  ``torch.uint32`` (:func:`to_wire`), which the wire names "uint32", and
  a received ``uint32`` leaf is widened back (:func:`from_wire`).
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Sequence, Tuple

import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.privacy import threefry

MODULUS_BITS = 32
_MOD = 1 << MODULUS_BITS
_MASK = _MOD - 1

#: Headroom bound: the TRUE integer sum over all parties must stay in
#: [-2^31, 2^31) for the centered lift at the root to recover it.
_HALF_MOD = 1 << (MODULUS_BITS - 1)


class SecAggError(ValueError):
    """A secure-aggregation contract violation (non-float leaves,
    fixed-point overflow, missing seeds)."""


# ---------------------------------------------------------------------------
# JAX's leaf order, and the words on the wire
# ---------------------------------------------------------------------------


def jax_order(tree: Any) -> Any:
    """``tree`` with every plain dict's keys sorted, as
    ``jax.tree_util`` orders (and rebuilds) them; an OrderedDict keeps
    its order, as in JAX."""
    if isinstance(tree, OrderedDict):
        return OrderedDict((k, jax_order(v)) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: jax_order(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[jax_order(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_order(v) for v in tree)
    return tree


def _leaves(tree: Any) -> Tuple[List[Any], tree_util.TreeSpec]:
    return tree_util.tree_flatten(jax_order(tree))


def to_wire(words: torch.Tensor) -> torch.Tensor:
    """Ring words (int64) as the ``torch.uint32`` leaf an envelope
    carries."""
    return words.to(torch.uint32)


def from_wire(leaf: torch.Tensor) -> torch.Tensor:
    """An envelope leaf (``torch.uint32``) as int64 ring words on its
    device."""
    return leaf.to(torch.int64) & _MASK


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch float dtype ("float32", "bfloat16")."""
    return str(dtype).rpartition(".")[2]


# ---------------------------------------------------------------------------
# Fixed-point ring encode / decode
# ---------------------------------------------------------------------------


def encode_tree(
    tree: Any, fixedpoint_bits: int, n_parties: int
) -> Tuple[List[torch.Tensor], List[str], tree_util.TreeSpec]:
    """Encode every float leaf into ``Z_{2^32}`` fixed-point words, on
    the leaf's device, in JAX's leaf order.

    Returns ``(ring_leaves, dtype_names, spec)``. Raises
    :class:`SecAggError` on non-float leaves, or when any encoded word
    could overflow the ring's headroom once summed over ``n_parties``
    contributors (the caller sees the bound in the message — shrink the
    update or lower ``privacy.fixedpoint_bits``).
    """
    leaves, spec = _leaves(tree)
    scale = float(1 << int(fixedpoint_bits))
    limit = _HALF_MOD / max(1, int(n_parties))
    ring: List[torch.Tensor] = []
    dtypes: List[str] = []
    for idx, leaf in enumerate(leaves):
        x = torch.as_tensor(leaf).detach()
        if not x.is_floating_point():
            raise SecAggError(
                f"secure aggregation masks floating-point leaves only; "
                f"leaf {idx} has dtype {dtype_name(x.dtype)} (cast it or "
                f"aggregate it in a separate plaintext call)"
            )
        # torch.round is round-half-to-even, as np.rint.
        q = torch.round(x.double() * scale)
        peak = float(q.abs().max()) if q.numel() else 0.0
        if peak >= limit:
            raise SecAggError(
                f"fixed-point overflow: leaf {idx} encodes to "
                f"|q|={peak:.3g} but the 2^{MODULUS_BITS} ring over "
                f"{n_parties} parties holds |q| < {limit:.3g}; shrink "
                f"the update or lower privacy.fixedpoint_bits "
                f"(currently {fixedpoint_bits})"
            )
        ring.append(q.to(torch.int64) & _MASK)
        dtypes.append(dtype_name(x.dtype))
    return ring, dtypes, spec


def _round_to_odd_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 to f32 rounded to odd: a later rounding to a narrower type is
    then the correct rounding of ``x`` (no double rounding)."""
    t = x.float()
    err = x - t.double()
    even = (t.view(torch.int32) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(t.dtype)
    return torch.where((err != 0) & even, torch.nextafter(t, toward), t)


def _cast(x: torch.Tensor, name: str) -> torch.Tensor:
    """An f64 tensor cast to the leaf dtype ``name`` as numpy casts it:
    numpy rounds f64 to float16 once, torch through f32, so float16 goes
    through f32 rounded to odd; ml_dtypes' bfloat16 and torch's both
    round through f32."""
    dtype = getattr(torch, name)
    if dtype == torch.float16:
        return _round_to_odd_f32(x).to(dtype)
    return x.to(dtype)


def decode_sum(
    ring_leaves: Sequence[torch.Tensor],
    dtype_names: Sequence[str],
    spec: tree_util.TreeSpec,
    fixedpoint_bits: int,
) -> Any:
    """Decode a modular sum of encodings back to the leaf dtype.

    The centered lift reads each ring word as a signed integer in
    [-2^31, 2^31) — exact as long as the true sum respected the
    :func:`encode_tree` headroom bound — then rescales by ``2^-f`` in
    float64 (exact for any value the ring can hold) and casts to the
    original leaf dtype.
    """
    inv_scale = 2.0 ** -float(fixedpoint_bits)
    out = []
    for words, dt in zip(ring_leaves, dtype_names):
        s = torch.where(words >= _HALF_MOD, words - _MOD, words)
        out.append(_cast(s.double() * inv_scale, dt))
    return tree_util.tree_unflatten(out, spec)


# ---------------------------------------------------------------------------
# Mask streams
# ---------------------------------------------------------------------------


def _domain_tag(domain: str) -> int:
    return zlib.crc32(domain.encode("utf-8")) & 0x7FFFFFFF


def _mask_key(
    pair_seed: int, domain: str, round_index: int, leaf_index: int
) -> threefry.Key:
    key = threefry.prng_key(int(pair_seed) % (1 << 63))
    key = threefry.fold_in(key, _domain_tag(domain))
    key = threefry.fold_in(key, int(round_index) & 0x7FFFFFFF)
    return threefry.fold_in(key, int(leaf_index))


def mask_stream(
    pair_seed: int, domain: str, round_index: int, leaf_index: int,
    shape: Tuple[int, ...], device=None,
) -> torch.Tensor:
    """The pairwise mask words for one leaf of one round (int64, on
    ``device``): the reference's ``jax.random.bits`` uint32 stream, which
    both pair members derive identically. ``domain`` separates sync
    aggregation, async sessions, and tests so a seed is never reused on
    two different plaintexts."""
    key = _mask_key(pair_seed, domain, round_index, leaf_index)
    return threefry.random_bits(key, shape, device)


def pair_sign(party: str, partner: str) -> int:
    """+1 when ``party`` adds the pair's stream, -1 when it subtracts —
    the lexicographically smaller name adds, so the two applications
    cancel mod 2^32."""
    if party == partner:
        raise SecAggError("a party has no pairwise mask with itself")
    return 1 if party < partner else -1


def _accumulate(acc: torch.Tensor, pair_seed: int, domain: str,
                round_index: int, leaf_index: int, sign: int) -> None:
    """``acc`` (flat int64 words) += ``sign`` * the leaf's mask stream of
    ``pair_seed``, mod 2^32, in place, one chunk of the stream at a time
    (no temporary is larger than a chunk, whatever the leaf's size)."""
    key = _mask_key(pair_seed, domain, round_index, leaf_index)
    n = acc.numel()
    for lo in range(0, n, threefry.CHUNK_WORDS):
        hi = min(n, lo + threefry.CHUNK_WORDS)
        seg = acc[lo:hi]
        stream = threefry.words(key, lo, hi, acc.device)
        if sign > 0:
            seg.add_(stream)
        else:
            seg.sub_(stream)
        seg.bitwise_and_(_MASK)


def _partners(party, parties, pair_seeds) -> List[str]:
    partners = [p for p in parties if p != party]
    missing = [p for p in partners if p not in pair_seeds]
    if missing:
        raise SecAggError(
            f"party {party!r} holds no pairwise seed for {missing} "
            "(the prv: seed exchange did not complete)"
        )
    return partners


def mask_leaf(
    words: torch.Tensor,
    leaf_index: int,
    party: str,
    parties: Sequence[str],
    pair_seeds: Dict[str, int],
    domain: str,
    round_index: int,
    inplace: bool = False,
) -> torch.Tensor:
    """One ring leaf plus this party's pairwise mask total (into
    ``words`` itself with ``inplace``)."""
    acc = words if inplace else words.clone()
    flat = acc.view(-1)
    for partner in _partners(party, parties, pair_seeds):
        _accumulate(flat, pair_seeds[partner], domain, round_index,
                    leaf_index, pair_sign(party, partner))
    return acc


def apply_masks(
    ring_leaves: Sequence[torch.Tensor],
    party: str,
    parties: Sequence[str],
    pair_seeds: Dict[str, int],
    domain: str,
    round_index: int,
) -> List[torch.Tensor]:
    """Add this party's pairwise mask total to each ring leaf."""
    _partners(party, parties, pair_seeds)
    return [mask_leaf(words, idx, party, parties, pair_seeds, domain,
                      round_index)
            for idx, words in enumerate(ring_leaves)]


def orphan_correction(
    dead_party: str,
    survivor_seeds: Dict[str, int],
    domain: str,
    round_index: int,
    shapes: Sequence[Tuple[int, ...]],
    device=None,
) -> List[torch.Tensor]:
    """The net orphaned mask words a dead party's absence leaves in the
    survivors' modular sum: ``sum_s sign(s, dead) * stream(s_sd)`` per
    leaf, where ``s`` ranges over the survivors whose seeds were
    re-offered. Subtracting this (mod 2^32) from the survivor sum
    restores exact cancellation."""
    out = []
    for idx, shape in enumerate(shapes):
        acc = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
        for survivor, seed in survivor_seeds.items():
            _accumulate(acc.view(-1), seed, domain, round_index, idx,
                        pair_sign(survivor, dead_party))
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# Modular folds
# ---------------------------------------------------------------------------


def modular_sum_host(
    contributions: Sequence[Sequence[torch.Tensor]],
) -> List[torch.Tensor]:
    """Leaf-wise sum mod 2^32 in contribution order, as int64 words on
    the first contribution's device. The leaves may be int64 words or
    envelope leaves (uint32), widened one at a time. Modular addition is
    associative, so every fold order gives the same words."""
    assert contributions, "nothing to sum"
    out = [from_wire(w) for w in contributions[0]]
    for contrib in contributions[1:]:
        for idx, words in enumerate(contrib):
            out[idx].add_(from_wire(words).to(out[idx].device))
            out[idx].bitwise_and_(_MASK)
    return out


def modular_sum_mesh(mesh, contributions):
    """The JAX package's same-mesh lowering of the secure fold (one
    collective across a composed party mesh) is the cross-party
    collective lane, ROADMAP Queue 1 item 12."""
    raise NotImplementedError(
        "the same-mesh modular sum (one collective across a composed "
        "party mesh) is the cross-party collective lane, ROADMAP Queue 1 "
        "item 12, not ported to rayfed_tpu_torch yet"
    )


def modular_sub(
    words: Sequence[torch.Tensor], correction: Sequence[torch.Tensor]
) -> List[torch.Tensor]:
    return [(a - b) & _MASK for a, b in zip(words, correction)]
