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
``rayfed_tpu/federated.py``).

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
``publish_to=`` hot-publishes the aggregate into a serving engine
(``fed.serve``'s handle) as its next version. ``mode="async"`` offers
each contribution to the FedBuff aggregator at the root
(``async_rounds.py``). ``secure=True`` lowers through the privacy plane
(``privacy/``): each contribution is encoded and pairwise-masked at its
party and the root cancels the masks in the ``Z_{2^32}`` ring, with the
JAX package's tasks and mask streams, so JAX and torch parties mask one
round together. The same-mesh fast path is ROADMAP Queue 1 item 12 and
is never taken.
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


@fed.remote
def _secagg_mask(tree, party, parties, domain, round_index, weight):
    # Party-side secure step: premultiply (wmean), encode into the
    # fixed-point ring, mask against every co-contributor. Executes AT
    # the contributing party — only the masked envelope rides the wire.
    from rayfed_tpu_torch.privacy.manager import require_privacy_manager

    mgr = require_privacy_manager("fed_aggregate(secure=True)")
    return mgr.mask_contribution(
        tree, party=party, parties=list(parties), domain=domain,
        round_index=round_index, weight=weight,
    )


@fed.remote
def _secagg_reduce(op, parties, domain, round_index, weights, *envelopes):
    # Root-side secure step: ring-sum the masked envelopes, cancel the
    # orphaned masks of dropped parties, decode, scale. The envelopes of
    # parties that died before contributing arrive as None (their
    # FedObject never resolved at the caller).
    from rayfed_tpu_torch.privacy.manager import require_privacy_manager

    mgr = require_privacy_manager("fed_aggregate(secure=True)")
    envs = {
        e["party"]: e
        for e in envelopes
        if isinstance(e, dict) and e.get("__secagg__")
    }
    return mgr.secure_reduce(
        op, list(parties), domain, round_index, weights, envs
    )


# Secure rounds are numbered per aggregation domain by a driver-local
# counter. Every controller calls fed_aggregate in the same order with
# the same arguments (the multi-controller contract), so every driver —
# and therefore every party's masking task — derives the same round
# index without any extra coordination.
from rayfed_tpu_torch.tenancy.context import JobScoped

_secure_round_counters: JobScoped = JobScoped(
    "federated.secure_rounds", default_factory=dict
)

SECURE_SYNC_DOMAIN = "fedagg"


def _next_secure_round(domain: str) -> int:
    counters = _secure_round_counters.get()
    rnd = counters.get(domain, 0)
    counters[domain] = rnd + 1
    return rnd


def _reset_secure_rounds() -> None:
    _secure_round_counters.pop()


def _secure_sync_aggregate(plan, objs, op, weights, publish_to):
    """The secure=True sync lowering: one masking task per party, one
    unmask-by-cancellation reduce at the root. Always single-hop — a
    masked envelope is only unmaskable once ALL contributions meet, so
    intermediate tree/ring hops would see nothing but could compute
    nothing either."""
    rnd = _next_secure_round(SECURE_SYNC_DOMAIN)
    w = None
    if op == "wmean":
        w = {p: float(weights[p]) for p in plan.parties}
    masked = [
        _secagg_mask.party(p).remote(
            objs[p], p, tuple(plan.parties), SECURE_SYNC_DOMAIN, rnd,
            None if w is None else w[p],
        )
        for p in plan.parties
    ]
    root = _secagg_reduce.party(plan.root).remote(
        op, tuple(plan.parties), SECURE_SYNC_DOMAIN, rnd, w, *masked
    )
    if publish_to is not None:
        publish_to.publish(root)
    return root


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
    publish_to: a :class:`~rayfed_tpu_torch.serving.ServeHandle`; the
        aggregate is published to it as the served model's next version
        (an owner-push of the tree when the root is not the serving
        party).
    mode: "sync" (default — the lock-step reduction below) or "async"
        (FedBuff-style buffered aggregation, docs/async_rounds.md): each
        contribution is OFFERED to a buffered aggregator at the root and
        the call returns an :class:`~rayfed_tpu_torch.async_rounds.AsyncRoundHandle`
        immediately — ``handle.model`` is a FedObject of the newest
        published ``{"version", "params"}`` at the root. ``buffer_k``,
        ``staleness_fn`` ("poly" | "constant" | "exp") and ``round_tag``
        apply only to async mode, which supports op "mean"/"wmean";
        ``topology``/``plan`` are sync-only.
    secure: lower the aggregation through the privacy plane
        (docs/privacy.md): each contribution is fixed-point encoded and
        pairwise-masked AT its party; only masked envelopes ride the
        wire; the root cancels the masks in the modular ring and recovers
        exactly the aggregate. Requires
        ``config["privacy"]["secure_aggregation"] = True`` at
        ``fed.init``. Supports op sum/mean/wmean; the plan is forced
        flat (an envelope is only unmaskable where ALL contributions
        meet, so intermediate hops cannot partially reduce). Works with
        ``mode="async"`` (masked offers buffer per round at the root).
    """
    if not objs:
        raise ValueError("fed_aggregate needs at least one party's object")
    if secure:
        from rayfed_tpu_torch.privacy.manager import require_privacy_manager

        mgr = require_privacy_manager("fed_aggregate(secure=True)")
        if not mgr.config.secure_aggregation:
            raise ValueError(
                "fed_aggregate(secure=True) needs "
                'config["privacy"]["secure_aggregation"] = True at '
                "fed.init (the privacy block is present but secure "
                "aggregation is off)"
            )
        if op not in ("sum", "mean", "wmean"):
            raise ValueError(
                f"secure aggregation supports op sum/mean/wmean, got {op!r}"
            )
        if mode == "sync":
            if topology not in (None, "auto", "flat"):
                raise ValueError(
                    f"secure aggregation is single-hop: a masked envelope "
                    f"is only unmaskable once every contribution meets, so "
                    f"topology={topology!r} cannot partially reduce at "
                    f"intermediate hops — use 'flat' (or drop topology=)"
                )
            topology = "flat"
            if plan is not None and not topo.plan_is_flat(plan):
                raise ValueError(
                    "secure aggregation needs a flat plan (single hop); "
                    "re-plan with topology='flat'"
                )
    if mode in ("sync", "async"):
        _m_aggregates.labels(mode=mode).inc()
    if mode == "async":
        if op not in ("mean", "wmean"):
            raise ValueError(
                f"mode='async' aggregates a staleness-weighted mean; "
                f"op={op!r} is sync-only"
            )
        if plan is not None or topology is not None:
            raise ValueError(
                "mode='async' folds in arrival order — topology=/plan= "
                "are sync-only knobs"
            )
        if op == "wmean" and weights is None:
            raise ValueError("op='wmean' needs weights={party: w}")
        from rayfed_tpu_torch import async_rounds

        return async_rounds.async_round(
            objs,
            round_tag=round_tag,
            weights=weights if op == "wmean" else None,
            buffer_k=buffer_k,
            staleness_fn=staleness_fn,
            publish_to=publish_to,
            secure=secure,
        )
    if mode != "sync":
        raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
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
        # Elastic membership: parties evicted (or departed) since the
        # caller built ``objs`` are outside the current roster — exclude
        # them like DEAD parties so the schedule re-plans over the
        # members. Every party applied the same epoch bump at the same
        # sync point, so every driver excludes identically.
        from rayfed_tpu_torch.membership.manager import get_membership_manager

        membership = get_membership_manager()
        if membership is not None:
            roster = set(membership.roster())
            dead |= {p for p in objs if p not in roster}
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

    if secure:
        # Privacy-plane lowering: masks at the parties, one cancel-and-
        # decode reduce at the root.
        return _secure_sync_aggregate(plan, objs, op, weights, publish_to)

    if op == "wmean":
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
    if publish_to is not None:
        publish_to.publish(root)
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
