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

"""Reduction-topology planner for N-party aggregation.

``fed_aggregate`` historically reduced parties pairwise at the driver
level; at N parties that shape is fixed and implicit. This module makes
the reduction DAG an explicit, planned artifact: :func:`plan` lays out a
schedule of k-ary reduce steps over the surviving parties for one of four
shapes, and the federated/driver executors lower that schedule to actual
traffic (or local folds).

Shapes (PAPERS.md: HierFAVG edge aggregation, Horovod ring/tree
scheduling):

``flat``
    One k-ary star: every party pushes to the root, which folds all N
    contributions in one step. Minimal rounds (1), maximal root fan-in
    (N-1 concurrent inbound transfers) — fine for small N or tiny
    payloads.
``tree``
    Binary tree: ceil(log2 N) rounds of pairwise reduces. Fan-in per
    node is 1 inbound transfer per round; total traffic N-1 pushes,
    spread across many links — the latency-optimal shape when per-push
    latency dominates.
``ring``
    Chain reduction: the partial flows through every party in sequence,
    N-1 rounds of exactly one transfer each. No node ever handles more
    than one inbound transfer total — the bandwidth-fairest shape (each
    link carries exactly one model's worth of bytes), at the cost of
    latency linear in N.
``hier``
    Hierarchical edge aggregation: parties are split into
    ``group_size``-sized groups (default ~sqrt(N)); each group's leader
    star-folds its group, then the root star-folds the leaders. Two
    rounds, fan-in bounded by the group size at every node — the
    scale-out default, matching edge-aggregator deployments where groups
    map to racks/sites.
``auto``
    N <= 2 -> flat (nothing to shape), N <= 8 -> tree (latency-optimal
    at small N), else hier (bounded fan-in at large N).

Degraded rounds re-plan: pass the DEAD set from ``fed.liveness_view()``
(or any parties known missing) as ``dead=`` and the schedule is laid out
over the survivors only — a dead mid-tree aggregator never appears as a
reduce destination, so one lost party degrades the round instead of
wedging its whole subtree.

Determinism: for a given (surviving party set, topology, root) the plan
is a pure function — every party computes the identical schedule, which
keeps the multi-controller contract (same DAG on every driver). Fold
order at every step is explicit in ``srcs``. Note that different
topologies associate floating-point sums differently; aggregates are
bitwise-identical across topologies when leaf values are exactly
representable (integer-valued updates, or any dtype where the sums don't
round), and within one topology they are always bitwise-deterministic.

In ``rayfed_tpu_torch`` this module is a copy of ``rayfed_tpu/topology.py``
with the package renamed, so both packages plan the same schedule for the
same arguments (a mixed-package job lays out one DAG). The same-mesh
lowering that :func:`plan_is_flat` gates (``psum_by_plan``) is not ported
yet (ROADMAP Queue 1 item 12b).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

TOPOLOGIES = ("auto", "flat", "tree", "ring", "hier")


@dataclasses.dataclass(frozen=True)
class ReduceStep:
    """One k-ary fold: ``dst`` combines the partials currently held by
    ``srcs`` (in order; ``srcs[0]`` is ``dst``'s own partial) and becomes
    the sole holder of the result."""

    dst: str
    srcs: Tuple[str, ...]

    def __post_init__(self):
        if not self.srcs or self.srcs[0] != self.dst:
            raise ValueError(
                f"step srcs must start with dst={self.dst!r}: {self.srcs}"
            )


@dataclasses.dataclass(frozen=True)
class TopologyPlan:
    """A schedule of reduce rounds. After ``levels`` run in order, the
    full reduction over ``parties`` lives at ``root``."""

    topology: str  # resolved concrete shape ("auto" never appears here)
    parties: Tuple[str, ...]  # survivors, in fold order
    root: str
    levels: Tuple[Tuple[ReduceStep, ...], ...]

    @property
    def num_rounds(self) -> int:
        return len(self.levels)

    @property
    def max_fan_in(self) -> int:
        """Largest number of inbound transfers any node handles in one
        round (its own partial in ``srcs`` doesn't move)."""
        return max(
            (len(s.srcs) - 1 for lvl in self.levels for s in lvl),
            default=0,
        )

    def validate(self) -> None:
        """Every party's partial is consumed exactly once and the last
        holder is the root — a malformed plan would silently drop or
        double-count contributions."""
        holders = set(self.parties)
        for lvl in self.levels:
            consumed_this_round = set()
            for step in lvl:
                for s in step.srcs:
                    if s not in holders:
                        raise ValueError(
                            f"step {step} reads {s!r} which holds no "
                            f"partial at that round"
                        )
                    if s in consumed_this_round:
                        raise ValueError(
                            f"partial of {s!r} consumed twice in one round"
                        )
                    consumed_this_round.add(s)
            for step in lvl:
                for s in step.srcs[1:]:
                    holders.discard(s)
        if holders != {self.root}:
            raise ValueError(
                f"plan leaves partials at {sorted(holders)}, expected "
                f"only root {self.root!r}"
            )


def plan_is_flat(plan: TopologyPlan) -> bool:
    """True when the schedule is a single k-ary star folding every party
    into the root in party order — the only shape the same-mesh fast
    path can lower to one collective across the composed mesh's party
    axis (``ops.aggregate.psum_by_plan``). Single-party plans (no steps)
    count: their reduction is the identity fold."""
    if not plan.levels:
        return len(plan.parties) == 1
    if len(plan.levels) != 1 or len(plan.levels[0]) != 1:
        return False
    (step,) = plan.levels[0]
    return step.dst == plan.root and step.srcs == plan.parties


def resolve_auto(n: int) -> str:
    """The shape ``auto`` picks for ``n`` surviving parties."""
    if n <= 2:
        return "flat"
    if n <= 8:
        return "tree"
    return "hier"


def _plan_flat(parties: Sequence[str]) -> Tuple[Tuple[ReduceStep, ...], ...]:
    if len(parties) == 1:
        return ()
    return ((ReduceStep(parties[0], tuple(parties)),),)


def _plan_tree(parties: Sequence[str]) -> Tuple[Tuple[ReduceStep, ...], ...]:
    levels = []
    holders = list(parties)
    while len(holders) > 1:
        steps, nxt = [], []
        for i in range(0, len(holders) - 1, 2):
            steps.append(ReduceStep(holders[i], (holders[i], holders[i + 1])))
            nxt.append(holders[i])
        if len(holders) % 2:
            nxt.append(holders[-1])
        levels.append(tuple(steps))
        holders = nxt
    return tuple(levels)


def _plan_ring(parties: Sequence[str]) -> Tuple[Tuple[ReduceStep, ...], ...]:
    # The partial starts at the tail and folds through each party toward
    # the root: round i moves one hop, so every link carries exactly one
    # transfer over the whole reduction.
    levels = []
    for i in range(len(parties) - 2, -1, -1):
        levels.append(
            (ReduceStep(parties[i], (parties[i], parties[i + 1])),)
        )
    return tuple(levels)


def _plan_hier(
    parties: Sequence[str], group_size: Optional[int]
) -> Tuple[Tuple[ReduceStep, ...], ...]:
    n = len(parties)
    if n == 1:
        return ()
    k = group_size or max(2, int(math.ceil(math.sqrt(n))))
    groups = [parties[i:i + k] for i in range(0, n, k)]
    leaders = [g[0] for g in groups]
    levels = []
    edge_steps = tuple(
        ReduceStep(g[0], tuple(g)) for g in groups if len(g) > 1
    )
    if edge_steps:
        levels.append(edge_steps)
    if len(leaders) > 1:
        levels.append((ReduceStep(leaders[0], tuple(leaders)),))
    return tuple(levels)


def plan(
    parties: Iterable[str],
    topology: str = "auto",
    *,
    root: Optional[str] = None,
    group_size: Optional[int] = None,
    dead: Iterable[str] = (),
) -> TopologyPlan:
    """Lay out the reduction schedule over the surviving parties.

    ``parties`` keeps its given order (callers pass a deterministic
    order — sorted names or config order — so all drivers agree).
    ``dead`` parties are dropped BEFORE shaping: the schedule is laid
    out over survivors, never routed around holes. ``root`` (default:
    first survivor) is moved to the front so every shape reduces toward
    it. Raises ``ValueError`` when nothing survives.
    """
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {TOPOLOGIES}"
        )
    dead = set(dead)
    survivors = [p for p in parties if p not in dead]
    if not survivors:
        raise ValueError(
            "no surviving parties to aggregate over (all dead/missing)"
        )
    if root is not None and root in survivors:
        survivors.remove(root)
        survivors.insert(0, root)
    resolved = (
        resolve_auto(len(survivors)) if topology == "auto" else topology
    )
    if resolved == "flat":
        levels = _plan_flat(survivors)
    elif resolved == "tree":
        levels = _plan_tree(survivors)
    elif resolved == "ring":
        levels = _plan_ring(survivors)
    else:
        levels = _plan_hier(survivors, group_size)
    out = TopologyPlan(
        topology=resolved,
        parties=tuple(survivors),
        root=survivors[0],
        levels=levels,
    )
    out.validate()
    return out


def replan(old: TopologyPlan, dead: Iterable[str],
           topology: Optional[str] = None) -> TopologyPlan:
    """Re-plan ``old`` with additional ``dead`` parties removed (a party
    went DEAD mid-round: lay the remaining reduction out over survivors).
    Keeps the old root when it survived."""
    dead = set(dead)
    root = old.root if old.root not in dead else None
    return plan(
        old.parties,
        topology or old.topology,
        root=root,
        dead=dead,
    )


def plan_secure(
    parties: Iterable[str], dead: Iterable[str] = ()
) -> TopologyPlan:
    """The one plan shape secure aggregation can lower to: a flat
    single-hop star (docs/privacy.md). A pairwise-masked envelope is a
    one-time pad — only the COMPLETE group's modular sum decodes — so an
    intermediate tree/ring/hier hop could neither read nor partially
    reduce what passes through it; ``fed_aggregate(secure=True)`` forces
    this shape regardless of the job's topology default."""
    return plan(list(parties), "flat", dead=set(dead))


def plan_buffer(slots: Iterable[str]) -> TopologyPlan:
    """A flat plan over buffered-arrival SLOT labels (async rounds,
    docs/async_rounds.md): the async aggregator folds its buffer in
    arrival order, labeling each contribution ``party#arrival_idx`` so a
    party contributing twice in one buffer occupies two slots. The plan's
    association order IS the arrival order — replaying the same arrivals
    through ``ops.aggregate.reduce_by_plan`` reproduces the aggregate
    bitwise (the async determinism contract)."""
    slots = list(slots)
    if not slots:
        raise ValueError("plan_buffer needs at least one buffered slot")
    if len(set(slots)) != len(slots):
        raise ValueError(f"buffer slot labels must be unique, got {slots}")
    return plan(slots, "flat")


# ---------------------------------------------------------------------------
# Job-level default (config: aggregation.topology / aggregation.group_size)
# ---------------------------------------------------------------------------

from rayfed_tpu_torch.tenancy.context import JobScoped

_defaults: JobScoped = JobScoped(
    "topology.default",
    default_factory=lambda: {"topology": "auto", "group_size": None},
)


def set_default(topology: str = "auto",
                group_size: Optional[int] = None) -> None:
    """Install the job-wide default (called by ``fed.init`` from the
    ``aggregation`` config section)."""
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"aggregation.topology must be one of {TOPOLOGIES}, "
            f"got {topology!r}"
        )
    if group_size is not None and int(group_size) < 2:
        raise ValueError("aggregation.group_size must be >= 2")
    _defaults.set({
        "topology": topology,
        "group_size": None if group_size is None else int(group_size),
    })


def get_default() -> Tuple[str, Optional[int]]:
    d = _defaults.get()
    return d["topology"], d["group_size"]


def reset_default() -> None:
    _defaults.pop()
