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

"""High-level federated learning API over the execution engine (port of
``rayfed_tpu/federated.py``, sync mode).

Every helper builds an ordinary fed DAG, so the owner-push perimeter,
seq-id determinism and error envelopes all apply unchanged.

``fed_aggregate`` reduces per-party FedObjects along a **planned
reduction topology** (``rayfed_tpu_torch/topology.py``): flat star,
binary tree, ring chain, or hierarchical edge-aggregator fan-in, selected
per call (``topology=``) or job-wide (``config['aggregation']['topology']``,
default ``auto``). Each plan step is one k-ary reduce executing at the
step's destination party. Degraded rounds re-plan over survivors: pass
``liveness=`` (the ``fed.liveness_view()`` dict) and DEAD parties are
excluded before the schedule is laid out.

The tasks are the JAX package's, in the same order, so a job whose
parties run different packages lays out one DAG; and their arithmetic is
the JAX package's bit for bit (``ops/aggregate.tree_scale`` /
``tree_divide``: scalars rounded to the leaf dtype, a true division).
Async rounds, secure aggregation, publishing to a serving handle and the
same-mesh fast path are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import topology as topo
from rayfed_tpu_torch.ops.aggregate import tree_divide, tree_scale, tree_sum
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

_m_aggregates = telemetry_metrics.get_registry().counter(
    "fed_driver_aggregates_total",
    "fed_aggregate calls laid out by this driver, by mode.",
    labels=("mode",),
)


@fed.remote
def _agg_kary_sum(*trees):
    return tree_sum(*trees)


@fed.remote
def _agg_kary_weighted(*pairs):
    # pairs: (tree, weight) partials; returns (weighted-sum tree, total).
    trees = [t for t, _ in pairs]
    total = pairs[0][1]
    for _, w in pairs[1:]:
        total = total + w
    return tree_sum(*trees), total


@fed.remote
def _scale(tree, denom):
    return tree_divide(tree, denom)


@fed.remote
def _scale_weighted(pair):
    tree, total = pair
    return tree_divide(tree, total)


@fed.remote
def _premul(tree, w):
    return tree_scale(tree, w), w


def fed_aggregate(
    objs: Dict[str, Any],
    op: str = "mean",
    weights: Optional[Dict[str, float]] = None,
    topology: Optional[str] = None,
    liveness: Optional[Dict[str, str]] = None,
    plan: Optional[topo.TopologyPlan] = None,
    publish_to: Any = None,
    mode: str = "sync",
    buffer_k: Optional[int] = None,
    staleness_fn: Optional[str] = None,
    round_tag: Optional[int] = None,
    secure: bool = False,
) -> Any:
    """Reduce ``{party: FedObject-of-tree}`` along a planned topology.

    The result lives at the plan's root (the first surviving party); pass
    it to ``fed.get`` to broadcast, or feed it onwards in the DAG. All
    parties must call this with the same arguments (multi-controller
    contract: the plan is a pure function of them, so every driver lays
    out the identical DAG).

    op: "sum", "mean", or "wmean" (sample-count weighting via ``weights``).
    topology: "auto" | "flat" | "tree" | "ring" | "hier"; None reads the
        job default set by ``config['aggregation']['topology']``.
    liveness: a ``fed.liveness_view()``-shaped ``{party: state}`` dict;
        DEAD parties are dropped and the schedule re-planned over the
        survivors (their FedObjects are never consumed, "mean" divides by
        the survivor count).
    plan: a pre-computed :class:`~rayfed_tpu_torch.topology.TopologyPlan`
        — overrides ``topology``/``liveness``.
    mode, buffer_k, staleness_fn, round_tag, secure, publish_to: the JAX
        package's async rounds, secure aggregation and serving hookup,
        not ported yet: anything but their defaults raises
        ``NotImplementedError`` naming the ROADMAP item that brings it.
    """
    if not objs:
        raise ValueError("fed_aggregate needs at least one party's object")
    if secure:
        raise NotImplementedError(
            "fed_aggregate(secure=True): secure aggregation is ROADMAP "
            "Queue 1 item 11, not ported to rayfed_tpu_torch yet"
        )
    if mode == "async":
        raise NotImplementedError(
            "fed_aggregate(mode='async'): buffered async rounds are ROADMAP "
            "Queue 1 item 10, not ported to rayfed_tpu_torch yet"
        )
    if publish_to is not None:
        raise NotImplementedError(
            "fed_aggregate(publish_to=...): the serving plane is ROADMAP "
            "Queue 1 item 9, not ported to rayfed_tpu_torch yet"
        )
    if mode != "sync":
        raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
    _m_aggregates.labels(mode=mode).inc()
    if buffer_k is not None or staleness_fn is not None or round_tag is not None:
        raise ValueError(
            "buffer_k/staleness_fn/round_tag are async-only knobs; "
            "pass mode='async'"
        )
    if plan is None:
        default_topo, group_size = topo.get_default()
        dead = set()
        if liveness:
            from rayfed_tpu_torch.resilience.liveness import DEAD

            dead = {p for p, st in liveness.items() if st == DEAD}
        plan = topo.plan(
            list(objs.keys()),
            topology or default_topo,
            group_size=group_size,
            dead=dead,
        )
    missing = set(plan.parties) - set(objs)
    if missing:
        raise ValueError(
            f"plan references parties with no contribution: {sorted(missing)}"
        )

    if op == "wmean":
        if weights is None:
            raise ValueError("op='wmean' needs weights={party: w}")
        missing_w = set(plan.parties) - set(weights)
        if missing_w:
            raise ValueError(
                f"op='wmean' weights missing entries for parties "
                f"{sorted(missing_w)}"
            )
        held = {
            p: _premul.party(p).remote(objs[p], float(weights[p]))
            for p in plan.parties
        }
        reducer = _agg_kary_weighted
    elif op in ("sum", "mean"):
        held = {p: objs[p] for p in plan.parties}
        reducer = _agg_kary_sum
    else:
        raise ValueError(f"op must be 'sum', 'mean' or 'wmean', got {op!r}")

    # Walk the schedule: each step is one k-ary reduce executing at the
    # step's destination, folding in the plan's explicit src order.
    for level in plan.levels:
        for step in level:
            held[step.dst] = reducer.party(step.dst).remote(
                *[held[s] for s in step.srcs]
            )
            for s in step.srcs[1:]:
                del held[s]

    root, root_owner = held[plan.root], plan.root
    if op == "mean":
        root = _scale.party(root_owner).remote(root, float(len(plan.parties)))
    elif op == "wmean":
        root = _scale_weighted.party(root_owner).remote(root)
    return root


class FedAvgTrainer:
    """Multi-round FedAvg orchestration: per-party worker actors train
    locally, aggregates flow through :func:`fed_aggregate`, and the global
    model feeds the next round.

    ``worker_cls`` is a ``@fed.remote`` actor class exposing
    ``train(global_params_or_None) -> params`` (and optionally
    ``num_samples() -> float`` for weighted averaging).
    """

    def __init__(
        self,
        worker_cls,
        parties: Sequence[str],
        worker_args: Optional[Dict[str, tuple]] = None,
        op: str = "mean",
        weights: Optional[Dict[str, float]] = None,
        topology: Optional[str] = None,
    ):
        self._parties = list(parties)
        self._op = op
        self._weights = weights
        self._topology = topology
        worker_args = worker_args or {}
        self._workers = {
            p: worker_cls.party(p).remote(*worker_args.get(p, ()))
            for p in self._parties
        }

    @property
    def workers(self):
        return self._workers

    def run(self, rounds: int, global_params=None):
        """Run ``rounds`` federated rounds; returns the final aggregate as
        a FedObject owned by the first party."""
        for _ in range(rounds):
            locals_ = {
                p: self._workers[p].train.remote(global_params)
                for p in self._parties
            }
            global_params = fed_aggregate(
                locals_, op=self._op, weights=self._weights,
                topology=self._topology,
            )
        return global_params
