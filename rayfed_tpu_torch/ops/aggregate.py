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

"""Federated aggregation folds over parameter trees of tensors (port of
``rayfed_tpu/ops/aggregate.py``).

Determinism: summation order over parties is fixed by argument order — a
left-to-right fold — and accumulation happens in ``acc_dtype`` (default
float32) before the cast back to the leaf dtype, so the same inputs give
bitwise-identical outputs on every party.

The folds also reproduce, bit for bit, what XLA makes of the reference on
the CPU: ``/ n`` in the mean is a multiply by the f32 reciprocal, and the
products of the weighted mean and the mix are fused into their sums
(fused multiply-add, emulated exactly here so the result is the same on
every device).

The reference's plan-driven reduction (:func:`reduce_by_plan`, and
``federated.fed_aggregate``'s tasks) is a different chain: an eager
``x * w``, the jitted :func:`tree_sum`, then an eager ``x / total``. Its
scalar ``w`` or ``total`` is a weakly-typed Python number, which JAX
rounds to the leaf's dtype before the op, and its divide is a true
division; :func:`tree_scale` and :func:`tree_divide` do the same on any
device.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from rayfed_tpu_torch import tree_util


def _dtype(acc_dtype: Optional[str]) -> Optional[torch.dtype]:
    return getattr(torch, acc_dtype) if acc_dtype else None


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to f32, as a 0-dim tensor on ``like``'s device."""
    return torch.tensor(np.float32(x), device=like.device)


def _one_device(xs):
    devices = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(
            f"a fold's leaves lie on different devices "
            f"{sorted(map(str, devices))}: under transport='tcp' received "
            "trees arrive on the CPU; fold trees that live on a card with "
            "transport='cuda', which places received leaves on the "
            "party's card"
        )
    return xs


def _tree_map_n(fn, trees):
    """``fn`` over the trees' leaves at each key path, in the structure
    (and dict key order) of the first tree. The leaves at one key path
    must lie on one device."""
    leaves, spec = tree_util.tree_flatten(trees[0])
    rest = [tree_util.leaves_like(t, spec) for t in trees[1:]]
    return tree_util.tree_unflatten(
        [fn(*_one_device(xs)) for xs in zip(leaves, *rest)], spec
    )


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, like a hardware fused multiply-add.

    The f32 product is exact in f64 and the f64 sum is rounded to odd, so
    the final rounding to f32 is the correct one (no double rounding)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly (TwoSum)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _fold_sum(leaves: Sequence[Any], acc_dtype):
    acc = leaves[0].to(acc_dtype) if acc_dtype else leaves[0]
    for x in leaves[1:]:
        acc = acc + (x.to(acc_dtype) if acc_dtype else x)
    return acc


def tree_sum(*trees, acc_dtype: Optional[str] = "float32"):
    """Elementwise sum of N identically-shaped trees (FedSum)."""
    if len(trees) == 1:
        return trees[0]
    dtype = _dtype(acc_dtype)
    return _tree_map_n(
        lambda *xs: _fold_sum(xs, dtype).to(xs[0].dtype), trees
    )


def tree_mean(*trees, acc_dtype: Optional[str] = "float32"):
    """Elementwise mean of N identically-shaped trees (FedAvg): the fold,
    times the f32 reciprocal of N, cast back to the leaf dtype."""
    if len(trees) == 1:
        return trees[0]
    dtype = _dtype(acc_dtype)

    def leaf(*xs):
        acc = _fold_sum(xs, dtype)
        return (acc.float() * _scalar(1.0 / len(xs), acc)).to(xs[0].dtype)

    return _tree_map_n(leaf, trees)


def tree_weighted_mean(trees, weights, acc_dtype: Optional[str] = "float32"):
    """Sample-count-weighted FedAvg: sum_i w_i * tree_i / sum_i w_i."""
    if len(trees) != len(weights) or not trees:
        raise ValueError(f"{len(trees)} trees vs {len(weights)} weights")
    if len(trees) == 1:
        return trees[0]
    dtype = _dtype(acc_dtype)

    def leaf(*xs):
        acc_dt = dtype or xs[0].dtype
        ws = [_scalar(w, xs[0]).to(acc_dt) for w in weights]
        total = _fold_sum(ws, dtype)
        xa = [x.to(acc_dt) for x in xs]
        # XLA fuses the first product into the second sum, then chains.
        acc = _fma(xa[0], ws[0], xa[1] * ws[1]).to(acc_dt)
        for x, w in zip(xa[2:], ws[2:]):
            acc = _fma(x, w, acc).to(acc_dt)
        return (acc / total).to(xs[0].dtype)

    return _tree_map_n(leaf, trees)


def tree_mix(old, new, lr: float, acc_dtype: Optional[str] = "float32"):
    """Server-learning-rate mix for buffered-async rounds (FedBuff's
    server step): ``old + lr * (new - old)`` per leaf, accumulated in
    ``acc_dtype`` and cast back to the leaf dtype.

    ``lr == 1.0`` or ``old is None`` returns ``new`` UNTOUCHED — the
    async determinism contract requires the default configuration's
    published model to be bitwise the buffered mean."""
    if old is None or lr == 1.0:
        return new
    dtype = _dtype(acc_dtype)

    def leaf(o, n):
        oa = o.to(dtype) if dtype is not None else o
        na = n.to(dtype) if dtype is not None else n
        return _fma(_scalar(lr, oa), na - oa, oa).to(n.dtype)

    return _tree_map_n(leaf, (old, new))


def _like(scalar, x: torch.Tensor) -> torch.Tensor:
    """A Python scalar as the reference's weakly-typed operand: rounded to
    ``x``'s floating dtype (f32 for an integer ``x``), a 0-dim tensor on
    ``x``'s device. A Python scalar would meet a bf16 leaf in f32, and on
    a card a CPU scalar turns ``x / s`` into ``x * (1/s)``."""
    return torch.full((), scalar, device=x.device,
                      dtype=x.dtype if x.is_floating_point() else None)


def tree_scale(tree, w):
    """Every leaf times the scalar ``w`` in the leaf's dtype (the
    reference's eager ``x * w``)."""
    return tree_util.tree_map(lambda x: x * _like(w, x), tree)


def tree_divide(tree, denom):
    """Every leaf over the scalar ``denom`` in the leaf's dtype, a true
    division (the reference's eager ``x / denom``)."""
    return tree_util.tree_map(lambda x: x / _like(denom, x), tree)


def reduce_by_plan(
    plan,
    contributions,
    weights=None,
    acc_dtype: Optional[str] = "float32",
):
    """Fold ``{party: tree}`` following a
    :class:`~rayfed_tpu_torch.topology.TopologyPlan`'s exact association
    order.

    This is the local-execution twin of ``fed_aggregate``'s distributed
    lowering: each plan step k-ary-folds its ``srcs`` partials (weighted:
    premultiplied trees + running weight totals), so the arithmetic — and
    therefore the bits — matches what the wire topology produces.

    Returns the weighted mean over ``plan.parties``.
    """
    missing = set(plan.parties) - set(contributions)
    if missing:
        raise ValueError(
            f"plan references parties with no contribution: {sorted(missing)}"
        )
    held = {}
    totals = {}
    for p in plan.parties:
        w = 1.0 if weights is None else weights[p]
        held[p] = tree_scale(contributions[p], w)
        totals[p] = w
    for level in plan.levels:
        for step in level:
            held[step.dst] = tree_sum(
                *[held[s] for s in step.srcs], acc_dtype=acc_dtype
            )
            totals[step.dst] = sum(totals[s] for s in step.srcs)
            for s in step.srcs[1:]:
                del held[s], totals[s]
    return tree_divide(held[plan.root], totals[plan.root])


def elastic_weighted_mean(
    contributions,
    weights=None,
    liveness=None,
    acc_dtype: Optional[str] = "float32",
    topology: Optional[str] = None,
    group_size: Optional[int] = None,
):
    """Degraded-mode FedAvg: the weighted mean over SURVIVING
    contributors, re-normalized so the aggregate stays an average of what
    actually arrived.

    ``contributions`` is ``{party: tree_or_missing}``. A contributor is
    dropped when its value is absent — None or the ``fed.MISSING``
    sentinel, what ``fed.get(..., on_missing="default")`` yields for a
    lost push — or when ``liveness`` (a ``{party: state}`` view from
    ``fed.liveness_view()``) marks it DEAD, even when its value arrived: a
    partitioned peer's stale update is worse than no update.

    ``weights`` maps party -> sample count (uniform when None). Raises
    ``ValueError`` when no contributor survives. Survivors fold in
    party-name order, so the same surviving set gives bitwise-identical
    aggregates on every party.

    ``topology`` (None = the flat left-to-right :func:`tree_weighted_mean`)
    folds along a reduction plan laid out over the survivors instead (a
    DEAD party re-plans the topology rather than leaving a hole in it), in
    the association order ``fed_aggregate`` produces on the wire.
    """
    from rayfed_tpu_torch.resilience.degraded import MISSING
    from rayfed_tpu_torch.resilience.liveness import DEAD

    liveness = liveness or {}
    survivors = [
        p for p in sorted(contributions)
        if contributions[p] is not None
        and contributions[p] is not MISSING
        and liveness.get(p) != DEAD
    ]
    if not survivors:
        raise ValueError(
            "no surviving contributors to aggregate: all values missing "
            "or their parties marked DEAD"
        )
    if topology is not None:
        from rayfed_tpu_torch import topology as topo

        surv_plan = topo.plan(survivors, topology, group_size=group_size)
        return reduce_by_plan(
            surv_plan,
            {p: contributions[p] for p in survivors},
            weights=None if weights is None
            else {p: weights[p] for p in survivors},
            acc_dtype=acc_dtype,
        )
    trees = [contributions[p] for p in survivors]
    w = [1.0 if weights is None else weights[p] for p in survivors]
    return tree_weighted_mean(trees, w, acc_dtype=acc_dtype)
