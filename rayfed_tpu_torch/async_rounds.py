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

"""Asynchronous buffered aggregation (FedBuff-style) + round pipelining
(port of ``rayfed_tpu/async_rounds.py``).

Synchronous ``fed_aggregate`` is lock-step: a round completes only when
every party arrives, so one straggler stalls the job. This module adds
the buffered alternative (Nguyen et al. 2022, "Federated Learning with
Buffered Asynchronous Aggregation"): contributions fold into a buffer on
the receiving party *as they arrive*, each weighted by how stale its
base round is, and a new global model is published every K accepted
contributions. Stragglers cost themselves staleness decay instead of
costing the job wall-clock.

Division of labor:

- :class:`BufferedAggregator` — the pure, transport-free server state
  (buffer, staleness weighting, K-publish, liveness filtering). Unit
  tests drive it directly; determinism is its contract: a fixed arrival
  order folds through the same topology plans ``fed_aggregate`` lowers
  to (``ops.aggregate.reduce_by_plan`` stepwise, then ``tree_mix``), so
  replaying the same arrivals reproduces the aggregate bitwise, and the
  JAX package's aggregator given the same arrivals publishes the same
  bits. The same-mesh ``psum_by_plan`` fold is ROADMAP Queue 1 item 12b
  and is never taken here.
- ``_async_offer`` / ``_async_current`` — ordinary ``@fed.remote`` POOL
  tasks executing at the aggregating (root) party. Deliberately not an
  actor: actor lanes resolve arguments inside one serial thread, so a
  straggler's in-flight push would head-of-line-block every later offer
  and degenerate async back to sync. Pool tasks each park on their own
  worker while their contribution is in flight.
- :func:`async_round` / ``fed_aggregate(mode="async")`` — the driver
  surface. Every driver lays out the identical calls (multi-controller
  contract); each party's contribution owner-pushes to the root, and
  the returned handle is non-blocking so round t+1 compute starts while
  the round-t push is still on the wire. The aggregator SNAPSHOTS each
  contribution's leaves when the offer lands (a buffered tree may sit
  un-folded across several rounds; a torch tensor is mutable, so without
  the copy a driver reusing its gradient buffer in place would poison
  the pending fold).

Staleness is measured in *round tags*: the driver stamps every
contribution with its round index (auto-incremented per session when not
given), and a contribution's staleness is how many tags the aggregator
has seen beyond it at fold time. Tags ride the offer task's arguments —
identical on every driver, so no party's local clock leaks into the
fold. DEAD parties (the root's ``fed.liveness_view()``) are dropped from
the buffer; SUSPECT ones are down-weighted by ``async_suspect_factor``.

Secure (masked) offers (``secure=True``, privacy plane): each contribution
is masked at its party (``privacy/manager.py``) and the aggregator
buffers the envelopes per mask round, folding a round's group only once
it is complete (or its missing parties are DEAD and their masks
recovered), so its fold is the JAX package's bit for bit.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from rayfed_tpu_torch import api as fed
from rayfed_tpu_torch import tracing
from rayfed_tpu_torch.config import AsyncAggregationConfig
from rayfed_tpu_torch.fed_object import FedObject
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Staleness decay
# ---------------------------------------------------------------------------

#: Named staleness-decay families (``aggregation.async_staleness``).
STALENESS_FNS = ("poly", "constant", "exp")


def resolve_staleness_fn(
    spec: Any, exp: float = 0.5
) -> Callable[[int], float]:
    """Resolve a staleness spec to ``f(s) -> weight multiplier``.

    ``"poly"`` (FedBuff's default): ``(1 + s) ** -exp`` — gentle decay,
    a one-round-stale update still carries most of its weight.
    ``"constant"``: 1.0 regardless of staleness (pure FedAsync buffer).
    ``"exp"``: ``exp ** s`` for ``0 < exp <= 1`` — aggressive decay.
    A callable passes through unchanged (local/unit-test use only: a
    callable cannot ride the wire to the aggregating party).
    """
    if callable(spec):
        return spec
    if spec == "poly":
        return lambda s: (1.0 + float(s)) ** -float(exp)
    if spec == "constant":
        return lambda s: 1.0
    if spec == "exp":
        if not (0.0 < float(exp) <= 1.0):
            raise ValueError(
                f"staleness='exp' needs 0 < async_staleness_exp <= 1 "
                f"(the per-round multiplier), got {exp}"
            )
        return lambda s: float(exp) ** float(s)
    raise ValueError(
        f"unknown staleness fn {spec!r}; expected one of {STALENESS_FNS} "
        f"or a callable"
    )


# ---------------------------------------------------------------------------
# The buffered aggregator (pure server-side state)
# ---------------------------------------------------------------------------


@dataclass
class _Contribution:
    slot: str          # unique buffer label ("party#arrival_idx")
    party: str
    round_tag: int
    staleness: int
    tree: Any
    weight: float      # base * staleness decay * liveness factor


def _snapshot_tree(tree: Any) -> Any:
    """Copy mutable leaves so the buffered contribution is immune to the
    offering driver reusing its buffer in place while the fold is still
    pending: every tensor is cloned on its own device, every numpy array
    copied. Everything else small (scalars, lists) is left alone — the
    buffer never hands leaves back out for mutation."""
    import numpy as np
    import torch

    from rayfed_tpu_torch import tree_util

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        return x.copy() if isinstance(x, np.ndarray) else x

    return tree_util.tree_map(leaf, tree)


class BufferedAggregator:
    """FedBuff server state for one async session.

    ``offer()`` is the only mutating entry point: it applies the
    liveness verdict (DEAD drops, SUSPECT down-weights), stamps the
    contribution's staleness against the newest round tag seen, and —
    every ``buffer_k`` accepted contributions — folds the buffer into a
    staleness-weighted mean, mixes it into the current global model at
    ``server_lr``, bumps the version, and fires ``publish_cb``.

    Determinism contract (asserted in tests/test_torch_async_rounds.py):
    the fold consumes the buffer in arrival order through
    ``ops.aggregate.reduce_by_plan`` over a flat plan whose slots are
    the arrival sequence — the same premultiply/fold/scale association
    ``fed_aggregate`` produces on the wire — so a fixed arrival order
    yields a bitwise-identical aggregate on every replay, equal to the
    JAX package's aggregator fed the same arrivals.
    """

    def __init__(
        self,
        cfg: AsyncAggregationConfig,
        *,
        liveness_fn: Optional[Callable[[], Dict[str, str]]] = None,
        publish_cb: Optional[Callable[[int, Any], None]] = None,
        staleness_fn: Optional[Callable[[int], float]] = None,
        session: str = "default",
    ):
        self.cfg = cfg
        self.session = session
        self._staleness_fn = staleness_fn or resolve_staleness_fn(
            cfg.staleness, cfg.staleness_exp
        )
        self._liveness_fn = liveness_fn
        self._publish_cb = publish_cb
        self._lock = threading.Lock()
        self._buffer: List[_Contribution] = []
        #: Pending secure-aggregation groups, keyed by mask round:
        #: {round: {party: masked envelope}} (docs/privacy.md). A group
        #: folds when every party named in its envelopes has arrived —
        #: or when the missing parties are DEAD/evicted and every
        #: survivor's recovery seed has been re-offered.
        self._secure_groups: Dict[int, Dict[str, Any]] = {}
        self._arrivals = 0
        self._latest_tag = -1
        self._current: Any = None
        self.version = 0
        self.stats: Dict[str, int] = {
            "accepted": 0,
            "dropped_dead": 0,
            "dropped_ghost": 0,
            "dropped_stale": 0,
            "publishes": 0,
            "publish_errors": 0,
            "handoffs": 0,
        }
        # Mirror every stats bump into the process-global telemetry
        # registry so the fleet view sees aggregator health without
        # polling snapshot_stats() (docs/observability.md).
        _reg = telemetry_metrics.get_registry()
        _offers = _reg.counter(
            "fed_async_offers_total",
            "Buffered-aggregator offers by outcome.",
            labels=("session", "result"),
        )
        self._m_offers = {
            k: _offers.labels(session=session, result=k)
            for k in ("accepted", "dropped_dead", "dropped_ghost",
                      "dropped_stale")
        }
        self._m_publishes = _reg.counter(
            "fed_async_publishes_total", "K-publishes folded and installed.",
            labels=("session",),
        ).labels(session=session)
        self._m_publish_errors = _reg.counter(
            "fed_async_publish_errors_total",
            "Publish hooks that raised (aggregation itself unaffected).",
            labels=("session",),
        ).labels(session=session)
        self._m_depth = _reg.gauge(
            "fed_async_buffer_depth", "Contributions currently buffered.",
            labels=("session",),
        ).labels(session=session)
        self._m_version = _reg.gauge(
            "fed_async_version", "Published model version.",
            labels=("session",),
        ).labels(session=session)
        self._m_latest_tag = _reg.gauge(
            "fed_async_latest_round_tag",
            "Newest round tag seen across offers.",
            labels=("session",),
        ).labels(session=session)
        self._m_handoffs = _reg.counter(
            "fed_async_handoffs_total",
            "Aggregator states this party adopted from a handed-off or "
            "checkpointed predecessor.",
            labels=("session",),
        ).labels(session=session)

    def _bump_stat_locked(self, key: str) -> None:
        self.stats[key] += 1
        m = self._m_offers.get(key)
        if m is not None:
            m.inc()
        elif key == "publishes":
            self._m_publishes.inc()
        elif key == "publish_errors":
            self._m_publish_errors.inc()

    def _sync_gauges_locked(self) -> None:
        self._m_depth.set(len(self._buffer))
        self._m_version.set(self.version)
        self._m_latest_tag.set(self._latest_tag)

    # -- queries ------------------------------------------------------------

    def current(self) -> Dict[str, Any]:
        """The newest published global model: ``{"version", "params"}``
        (version 0 / params None before the first K-publish)."""
        with self._lock:
            return {"version": self.version, "params": self._current}

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.stats)
            out["version"] = self.version
            out["buffered"] = len(self._buffer)
            out["latest_round_tag"] = self._latest_tag
            return out

    # -- state handoff (HA, docs/ha.md) -------------------------------------

    def export_state(self) -> Dict[str, Any]:
        """One consistent snapshot of everything a successor aggregator
        needs to continue this session bitwise: the un-folded buffer in
        arrival order, the arrival counter (slot labels must not
        collide), the staleness ledger (latest round tag), the pending
        secure groups, the published model, and the counters. The
        returned dict is wire-clean — it rides a normal fed push to the
        successor, or a checkpoint to disk."""
        with self._lock:
            return {
                "session": self.session,
                "cfg": self.cfg.as_dict(),
                "buffer": [
                    {
                        "slot": c.slot, "party": c.party,
                        "round_tag": c.round_tag, "staleness": c.staleness,
                        "tree": c.tree, "weight": c.weight,
                    }
                    for c in self._buffer
                ],
                "arrivals": self._arrivals,
                "latest_tag": self._latest_tag,
                "secure_groups": {
                    int(r): dict(g) for r, g in self._secure_groups.items()
                },
                "current": self._current,
                "version": self.version,
                "stats": dict(self.stats),
            }

    def adopt_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Install a predecessor's :meth:`export_state` snapshot,
        REPLACING this aggregator's state (the handoff target is a
        fresh/empty successor; a checkpoint restore starts from an empty
        registry). Counts one handoff. Returns ``snapshot_stats()``."""
        with self._lock:
            self._buffer = [
                _Contribution(
                    c["slot"], c["party"], int(c["round_tag"]),
                    int(c["staleness"]), _snapshot_tree(c["tree"]),
                    float(c["weight"]),
                )
                for c in state.get("buffer") or []
            ]
            self._arrivals = int(state.get("arrivals") or 0)
            self._latest_tag = int(state.get("latest_tag", -1))
            self._secure_groups = {
                int(r): dict(g)
                for r, g in (state.get("secure_groups") or {}).items()
            }
            self._current = state.get("current")
            self.version = int(state.get("version") or 0)
            prior = state.get("stats") or {}
            for k in self.stats:
                if k in prior:
                    self.stats[k] = int(prior[k])
            self.stats["handoffs"] += 1
            self._m_handoffs.inc()
            self._sync_gauges_locked()
        tracing.record(
            "failover", "", f"async:{self.session}", f"v{self.version}",
            0, time.perf_counter(), event="handoff",
            buffered=len(self._buffer),
        )
        logger.info(
            "async session %r adopted handed-off state: v%d, %d buffered, "
            "latest tag %d", self.session, self.version,
            len(self._buffer), self._latest_tag,
        )
        return self.snapshot_stats()

    # -- the one mutating entry point ---------------------------------------

    def offer(
        self,
        party: str,
        tree: Any,
        *,
        round_tag: int,
        weight: float = 1.0,
        epoch: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Fold one contribution into the buffer; publish on the Kth.

        ``epoch`` is the membership epoch the offering driver stamped at
        send time (None on membership-free jobs). On a membership-enabled
        job, an offer from outside the current roster — or stamped with
        an epoch predating the party's current incarnation (a pre-crash
        ghost of a since-rejoined party) — is dropped before it can fold
        into the buffer.

        Returns a small status dict (msgpack-clean scalars only — it
        rides the inline small-message lane back to the offering party):
        ``accepted``, ``reason`` (when not), ``staleness``, ``weight``
        (the effective post-decay weight), ``buffered``, ``version``.
        """
        from rayfed_tpu_torch.membership.manager import get_membership_manager
        from rayfed_tpu_torch.resilience.liveness import DEAD, state_weight

        t0 = time.perf_counter()
        view = self._liveness_fn() if self._liveness_fn else {}
        state = view.get(party)
        membership = get_membership_manager()
        if isinstance(tree, dict) and tree.get("__secagg__"):
            return self._offer_secure(
                party, tree, round_tag=round_tag, epoch=epoch,
                t0=t0, view=view, membership=membership,
            )
        tree = _snapshot_tree(tree)
        with self._lock:
            self._latest_tag = max(self._latest_tag, int(round_tag))
            self._m_latest_tag.set(self._latest_tag)
            staleness = self._latest_tag - int(round_tag)
            if membership is not None and membership.is_ghost(party, epoch):
                self._bump_stat_locked("dropped_ghost")
                return {
                    "accepted": False, "reason": "ghost",
                    "staleness": staleness, "weight": 0.0,
                    "buffered": len(self._buffer), "version": self.version,
                }
            if state == DEAD:
                self._bump_stat_locked("dropped_dead")
                return {
                    "accepted": False, "reason": "dead",
                    "staleness": staleness, "weight": 0.0,
                    "buffered": len(self._buffer), "version": self.version,
                }
            if (
                self.cfg.max_staleness is not None
                and staleness > self.cfg.max_staleness
            ):
                self._bump_stat_locked("dropped_stale")
                return {
                    "accepted": False, "reason": "stale",
                    "staleness": staleness, "weight": 0.0,
                    "buffered": len(self._buffer), "version": self.version,
                }
            eff = (
                float(weight)
                * float(self._staleness_fn(staleness))
                * state_weight(state, self.cfg.suspect_factor)
            )
            slot = f"{party}#{self._arrivals}"
            self._arrivals += 1
            self._buffer.append(
                _Contribution(slot, party, int(round_tag), staleness,
                              tree, eff)
            )
            self._bump_stat_locked("accepted")
            published = None
            if len(self._buffer) >= self.cfg.buffer_k:
                published = self._fold_and_publish_locked(t0)
            self._sync_gauges_locked()
            return {
                "accepted": True, "staleness": staleness, "weight": eff,
                "buffered": len(self._buffer), "version": self.version,
                **({"published": published} if published else {}),
            }

    # -- internals ----------------------------------------------------------

    def _fold_and_publish_locked(self, t0: float) -> int:
        from rayfed_tpu_torch import topology as topo
        from rayfed_tpu_torch.ops.aggregate import reduce_by_plan

        buf, self._buffer = self._buffer, []
        # The reference lowers a buffer of distinct parties that compose
        # onto one registered mesh to ``psum_by_plan`` (same bits for a
        # fixed arrival set); that same-mesh lane is ROADMAP Queue 1 item
        # 12, so this package always folds in arrival order.
        slot_plan = topo.plan_buffer([c.slot for c in buf])
        mean = reduce_by_plan(
            slot_plan,
            {c.slot: c.tree for c in buf},
            weights={c.slot: c.weight for c in buf},
        )
        return self._install_locked(
            mean, t0, path="fold", k=len(buf),
            round_tags=[c.round_tag for c in buf],
        )

    def _install_locked(self, mean, t0, *, path, k, round_tags) -> int:
        """Mix a folded mean into the global model, bump the version,
        and fire the publish hook (shared by the plaintext and secure
        folds)."""
        from rayfed_tpu_torch.ops.aggregate import tree_mix

        self._current = tree_mix(self._current, mean, self.cfg.server_lr)
        self.version += 1
        self._bump_stat_locked("publishes")
        tracing.record(
            "fold", "", f"async:{self.session}", f"v{self.version}",
            0, t0,
            path=path, k=k,
            round_tags=round_tags,
        )
        if self._publish_cb is not None:
            tp = time.perf_counter()
            try:
                self._publish_cb(self.version, self._current)
                tracing.record(
                    "publish", "", f"async:{self.session}",
                    f"v{self.version}", 0, tp,
                )
            except Exception as e:  # noqa: BLE001 - a failed downstream
                # publish must not poison the aggregation itself
                self._bump_stat_locked("publish_errors")
                tracing.record(
                    "publish", "", f"async:{self.session}",
                    f"v{self.version}", 0, tp, ok=False,
                )
                logger.warning(
                    "async session %r publish hook failed at v%d: %r",
                    self.session, self.version, e,
                )
        return self.version

    # -- secure groups (privacy plane, docs/privacy.md) ---------------------

    def _offer_secure(
        self, party, env, *, round_tag, epoch, t0, view, membership
    ) -> Dict[str, Any]:
        """Buffer one MASKED contribution. Masked envelopes group by
        their mask round (not by arrival count): an individual envelope
        is a one-time-pad — only the complete group's modular sum means
        anything — so the effective ``buffer_k`` of a secure session is
        the contributing group's size. The uniform group staleness
        factor cancels in the mean, which is what keeps the secure fold
        bit-comparable to the plaintext one (docs/privacy.md)."""
        from rayfed_tpu_torch.resilience.liveness import DEAD

        with self._lock:
            self._latest_tag = max(self._latest_tag, int(round_tag))
            self._m_latest_tag.set(self._latest_tag)
            staleness = self._latest_tag - int(round_tag)
            buffered = sum(len(g) for g in self._secure_groups.values())
            if membership is not None and membership.is_ghost(party, epoch):
                self._bump_stat_locked("dropped_ghost")
                return {
                    "accepted": False, "reason": "ghost",
                    "staleness": staleness, "weight": 0.0,
                    "buffered": buffered, "version": self.version,
                }
            if view.get(party) == DEAD:
                self._bump_stat_locked("dropped_dead")
                return {
                    "accepted": False, "reason": "dead",
                    "staleness": staleness, "weight": 0.0,
                    "buffered": buffered, "version": self.version,
                }
            if (
                self.cfg.max_staleness is not None
                and staleness > self.cfg.max_staleness
            ):
                self._bump_stat_locked("dropped_stale")
                return {
                    "accepted": False, "reason": "stale",
                    "staleness": staleness, "weight": 0.0,
                    "buffered": buffered, "version": self.version,
                }
            rnd = int(env["round"])
            group = self._secure_groups.setdefault(rnd, {})
            group[party] = env
            self._bump_stat_locked("accepted")
            published = self._try_fold_secure_locked(rnd, t0)
            self._sync_gauges_locked()
            w = 1.0 if env.get("w") is None else float(env["w"])
            return {
                "accepted": True, "secure": True, "staleness": staleness,
                "weight": w,
                "buffered": sum(len(g) for g in self._secure_groups.values()),
                "version": self.version,
                **({"published": published} if published else {}),
            }

    def _try_fold_secure_locked(self, rnd: int, t0: float) -> Optional[int]:
        """Fold the round's secure group if it is completable: every
        expected party arrived, or every missing one is DEAD/evicted AND
        every survivor's recovery seed has been re-offered
        (``prv:recover``). Returns the new version, or None to keep the
        group pending (re-tried on the next offer and on every
        :func:`poke_secure_sessions`)."""
        from rayfed_tpu_torch.privacy.manager import get_privacy_manager

        group = self._secure_groups.get(rnd)
        if not group:
            return None
        mgr = get_privacy_manager()
        if mgr is None:
            logger.warning(
                "masked offers buffered at a party without a privacy "
                "plane; session %r round %s cannot fold", self.session, rnd,
            )
            return None
        first = next(iter(group.values()))
        expected = list(first["parties"])
        missing = [p for p in expected if p not in group]
        if missing:
            from rayfed_tpu_torch.membership.manager import (
                get_membership_manager,
            )
            from rayfed_tpu_torch.resilience.liveness import DEAD

            view = self._liveness_fn() if self._liveness_fn else {}
            membership = get_membership_manager()
            roster = (
                set(membership.roster()) if membership is not None else None
            )
            survivors = [p for p in expected if p in group]
            for p in missing:
                gone = view.get(p) == DEAD or (
                    roster is not None and p not in roster
                )
                if not gone:
                    return None  # still expecting its envelope
                if mgr.recovery_seeds(p, survivors) is None:
                    return None  # survivors' re-offers still in flight
        weights = None
        op = "mean"
        if first.get("w") is not None:
            op = "wmean"
            weights = {p: float(e["w"]) for p, e in group.items()}
        try:
            mean = mgr.secure_reduce(
                op, expected, first["domain"], rnd, weights, dict(group)
            )
        except Exception:  # noqa: BLE001 - fold stays pending, retried
            logger.warning(
                "secure fold for session %r round %s not completable yet",
                self.session, rnd, exc_info=True,
            )
            return None
        del self._secure_groups[rnd]
        return self._install_locked(
            mean, t0, path="secure", k=len(group), round_tags=[rnd]
        )

    def poke_secure(self) -> None:
        """Re-try every pending secure group (called when a recovery
        seed lands — the fold it was blocking may now be completable)."""
        with self._lock:
            for rnd in sorted(self._secure_groups):
                self._try_fold_secure_locked(rnd, time.perf_counter())
            self._sync_gauges_locked()


# ---------------------------------------------------------------------------
# Process-local session registry (lives at the aggregating party)
# ---------------------------------------------------------------------------

from rayfed_tpu_torch.tenancy.context import JobScoped

_sessions: JobScoped = JobScoped("async_rounds.sessions", default_factory=dict)
_sessions_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the per-job session registries)


def _serve_publish_cb(serve_name: str) -> Callable[[int, Any], None]:
    def cb(version: int, params: Any) -> None:
        from rayfed_tpu_torch.serving.server import get_server

        get_server(serve_name).publish(params)

    return cb


def _get_or_create_session(
    name: str, cfg_dict: Dict[str, Any], serve_name: Optional[str]
) -> BufferedAggregator:
    with _sessions_lock:
        sessions = _sessions.get()
        agg = sessions.get(name)
        if agg is None:
            from rayfed_tpu_torch.resilience.liveness import liveness_view

            agg = BufferedAggregator(
                AsyncAggregationConfig(**cfg_dict),
                liveness_fn=liveness_view,
                publish_cb=(
                    _serve_publish_cb(serve_name) if serve_name else None
                ),
                session=name,
            )
            sessions[name] = agg
        return agg


def get_session(name: str = "default") -> Optional[BufferedAggregator]:
    """The named session's aggregator in THIS process (None when this
    process is not the aggregating party, or nothing arrived yet)."""
    with _sessions_lock:
        return _sessions.get().get(name)


def reset_sessions() -> None:
    """Drop all aggregator state and driver-side round counters (called
    by ``fed.shutdown`` — a new job must not fold into an old buffer)."""
    with _sessions_lock:
        _sessions.pop()
    with _tags_lock:
        _driver_round_tags.pop()
        _last_rounds.pop()


def poke_secure_sessions() -> None:
    """Re-try every session's pending secure folds (the privacy manager
    calls this when a ``prv:recover`` seed lands — a dropout-blocked
    group may now be completable)."""
    with _sessions_lock:
        aggs = list(_sessions.get().values())
    for agg in aggs:
        agg.poke_secure()


# ---------------------------------------------------------------------------
# Remote surface (pool tasks at the root — see module docstring for why
# these are deliberately not an actor)
# ---------------------------------------------------------------------------


@fed.remote
def _async_offer(
    name, cfg_dict, serve_name, party, round_tag, weight, epoch, tree
):
    agg = _get_or_create_session(name, cfg_dict, serve_name)
    return agg.offer(
        party, tree, round_tag=round_tag, weight=weight, epoch=epoch
    )


@fed.remote
def _async_secure_mask(tree, party, parties, domain, round_index, weight):
    # Party-side masking for a secure async offer (the async twin of
    # federated._secagg_mask): only the masked envelope rides to the
    # root's buffer.
    from rayfed_tpu_torch.privacy.manager import require_privacy_manager

    mgr = require_privacy_manager("async_round(secure=True)")
    return mgr.mask_contribution(
        tree, party=party, parties=list(parties), domain=domain,
        round_index=round_index, weight=weight,
    )


@fed.remote
def _async_current(name, cfg_dict, serve_name):
    agg = _get_or_create_session(name, cfg_dict, serve_name)
    return agg.current()


@fed.remote
def _async_export(name, cfg_dict, serve_name):
    agg = _get_or_create_session(name, cfg_dict, serve_name)
    return agg.export_state()


@fed.remote
def _async_adopt(name, cfg_dict, serve_name, state):
    agg = _get_or_create_session(name, cfg_dict, serve_name)
    _handoff_begin()
    try:
        return agg.adopt_state(state)
    finally:
        _handoff_end()


# In-flight handoff adoption counter: ``fed.shutdown`` drains it so a
# job shutting down during an aggregator handoff finishes installing the
# adopted state before the session registry is cleared.
_handoff_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (per-job async state; reset_sessions()/reset_default_async_config() clear at shutdown)
_handoff_cond = threading.Condition(_handoff_lock)  # fedlint: disable=global-mutable-singleton (per-job async state; reset_sessions()/reset_default_async_config() clear at shutdown)
_handoffs_inflight = 0  # fedlint: disable=global-mutable-singleton (per-job async state; reset_sessions()/reset_default_async_config() clear at shutdown)


def _handoff_begin() -> None:
    global _handoffs_inflight
    with _handoff_lock:
        _handoffs_inflight += 1


def _handoff_end() -> None:
    global _handoffs_inflight
    with _handoff_lock:
        _handoffs_inflight -= 1
        _handoff_cond.notify_all()


def drain_handoffs(timeout: float = 2.0) -> bool:
    """Block until no aggregator handoff is mid-adopt (or the timeout
    lapses). Returns True when quiescent."""
    deadline = time.monotonic() + max(0.0, timeout)
    with _handoff_lock:
        while _handoffs_inflight > 0:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            _handoff_cond.wait(remaining)
        return True


@fed.remote
def _async_stats(name, cfg_dict, serve_name):
    agg = _get_or_create_session(name, cfg_dict, serve_name)
    return agg.snapshot_stats()


# ---------------------------------------------------------------------------
# Driver surface
# ---------------------------------------------------------------------------

# Job default (config['aggregation']['async_*'] from fed.init), following
# the topology.set_default pattern: every driver reads the same config,
# so every driver ships the identical cfg to the root.
_default_cfgs: "JobScoped[AsyncAggregationConfig]" = JobScoped(
    "async_rounds.default_cfg"
)

# Driver-side auto round tags, per session name. Every driver runs the
# same program, so the counters advance identically on all parties.
_tags_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the per-job round-tag counters)
_driver_round_tags: JobScoped = JobScoped(
    "async_rounds.round_tags", default_factory=dict
)

# Driver-side memory of the last async_round call per session — the
# survivor re-offer source for :func:`async_rebuild` when the root died
# without handing its buffer off. Identical on every driver (same calls,
# same arguments), so a rebuild lays out the same DAG everywhere.
_last_rounds: JobScoped = JobScoped(
    "async_rounds.last_rounds", default_factory=dict
)


def validate_async_config(
    aggregation_dict: Dict[str, Any]
) -> AsyncAggregationConfig:
    """The ``aggregation.async_*`` keys as a config; raises on unknown
    keys or bad values (``fed.init`` calls it before building any state,
    so a typo'd config rejects init, not the first round)."""
    cfg = AsyncAggregationConfig.from_aggregation_dict(aggregation_dict)
    resolve_staleness_fn(cfg.staleness, cfg.staleness_exp)  # validate combo
    return cfg


def set_default_async_config(aggregation_dict: Dict[str, Any]) -> None:
    """Validate and install the ``aggregation.async_*`` job defaults
    (called by ``fed.init``)."""
    _default_cfgs.set(validate_async_config(aggregation_dict))


def get_default_async_config() -> AsyncAggregationConfig:
    return _default_cfgs.peek() or AsyncAggregationConfig()


def reset_default_async_config() -> None:
    _default_cfgs.pop()


def _next_round_tag(session: str) -> int:
    with _tags_lock:
        tags = _driver_round_tags.get()
        tag = tags.get(session, 0)
        tags[session] = tag + 1
        return tag


@dataclass
class AsyncRoundHandle:
    """Non-blocking view of one async round: the per-party offer-status
    FedObjects and the newest global model at the root.

    Nothing here blocks — pull ``model`` with ``fed.get(handle.model,
    timeout=..., on_missing=...)`` for a bounded wait; ``params`` may be
    None (version 0) until the buffer first fills to K."""

    round_tag: int
    root: str
    session: str
    offers: Dict[str, FedObject] = field(default_factory=dict)
    model: Optional[FedObject] = None


def async_round(
    objs: Dict[str, Any],
    *,
    round_tag: Optional[int] = None,
    root: Optional[str] = None,
    weights: Optional[Dict[str, float]] = None,
    buffer_k: Optional[int] = None,
    staleness_fn: Optional[str] = None,
    server_lr: Optional[float] = None,
    session: str = "default",
    publish_to: Any = None,
    fetch_model: bool = True,
    secure: bool = False,
) -> AsyncRoundHandle:
    """Offer ``{party: FedObject-of-pytree}`` into the session's buffer
    at the root and return without waiting for anything.

    Every driver must make the identical call (multi-controller
    contract — offers and the model fetch burn seq ids). Each party's
    contribution owner-pushes to ``root`` when that party's driver
    reaches this call; the aggregator folds arrivals as they land and
    publishes every ``buffer_k``. The returned handle's ``model`` is the
    root's newest published global model *at the time the root executes
    the fetch* — it may or may not include this round's contributions;
    that is the async contract (docs/async_rounds.md).

    ``round_tag`` stamps the contributions' staleness bucket; when None,
    a per-``session`` driver-side counter auto-increments (identically
    on every driver). ``buffer_k`` / ``staleness_fn`` (a name from
    :data:`STALENESS_FNS`) / ``server_lr`` override the
    ``aggregation.async_*`` job defaults. ``publish_to`` (a
    ``ServeHandle`` hosted at the root party) hot-publishes each
    K-publish into the serving plane in-process. ``fetch_model=False``
    skips the model fetch (pipelined inner rounds that only push).

    ``secure=True`` masks each contribution AT its party before it is
    offered (privacy plane, docs/privacy.md): the root buffers masked
    envelopes per round and folds a round's group only once every
    contributor has arrived (or dropped out and been recovered), so the
    effective ``buffer_k`` is the group size. Requires
    ``config["privacy"]["secure_aggregation"] = True``.
    """
    assert objs, "need at least one party's contribution"
    if secure:
        from rayfed_tpu_torch.privacy.manager import require_privacy_manager

        mgr = require_privacy_manager("async_round(secure=True)")
        if not mgr.config.secure_aggregation:
            raise ValueError(
                "async_round(secure=True) needs "
                'config["privacy"]["secure_aggregation"] = True at fed.init'
            )
    if root is None:
        root = next(iter(objs))
    cfg = get_default_async_config()
    overrides: Dict[str, Any] = {}
    if buffer_k is not None:
        overrides["buffer_k"] = int(buffer_k)
    if staleness_fn is not None:
        if callable(staleness_fn):
            raise TypeError(
                "async staleness_fn must be a name from STALENESS_FNS "
                "here (a callable cannot ride the wire to the root); "
                "pass callables to BufferedAggregator directly"
            )
        overrides["staleness"] = staleness_fn
    if server_lr is not None:
        overrides["server_lr"] = float(server_lr)
    if overrides:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, **overrides)
    cfg_dict = cfg.as_dict()
    resolve_staleness_fn(cfg.staleness, cfg.staleness_exp)

    serve_name = None
    if publish_to is not None:
        if publish_to.party != root:
            raise ValueError(
                f"publish_to must be hosted at the aggregating root "
                f"(serving party {publish_to.party!r} != root {root!r}): "
                f"the K-publish hook installs versions in-process"
            )
        serve_name = publish_to.name
    if round_tag is None:
        round_tag = _next_round_tag(session)

    handle = AsyncRoundHandle(
        round_tag=int(round_tag), root=root, session=session
    )
    # Stamp each offer with this driver's membership epoch (None on
    # membership-free jobs): the root's aggregator rejects offers whose
    # stamp predates the offering party's current incarnation.
    from rayfed_tpu_torch.membership.manager import current_epoch_or_none

    epoch = current_epoch_or_none()
    secure_parties = tuple(sorted(objs)) if secure else None
    for party in objs:
        w = 1.0 if weights is None else float(weights[party])
        contribution = objs[party]
        if secure:
            # Mask at the contributing party; the envelope carries the
            # wmean weight (premultiplied), so the offer itself rides
            # weight 1.0. The mask round is the round tag — identical on
            # every driver, so both pair members derive the same streams.
            contribution = _async_secure_mask.party(party).remote(
                objs[party], party, secure_parties, f"async:{session}",
                int(round_tag), None if weights is None else w,
            )
            w = 1.0
        handle.offers[party] = _async_offer.party(root).remote(
            session, cfg_dict, serve_name, party, int(round_tag), w, epoch,
            contribution,
        )
    if fetch_model:
        handle.model = _async_current.party(root).remote(
            session, cfg_dict, serve_name
        )
    with _tags_lock:
        _last_rounds.get()[session] = {
            "objs": dict(objs),
            "round_tag": int(round_tag),
            "weights": None if weights is None else dict(weights),
            "secure": bool(secure),
        }
    return handle


def async_handoff(
    old_root: str, new_root: str, session: str = "default"
) -> FedObject:
    """Hand the session's aggregator state from ``old_root`` to
    ``new_root``: the old root exports one consistent snapshot (buffer,
    staleness ledger, secure groups, published model), the snapshot
    rides a normal fed push, and the successor adopts it wholesale.
    Every driver must make the identical call (multi-controller
    contract). Returns a FedObject of the successor's post-adopt stats
    at ``new_root`` — ``fed.get`` it for a bounded wait. Use when the
    old root is still reachable (planned migration, drain); when it is
    DEAD, use :func:`async_rebuild` instead."""
    cfg_dict = get_default_async_config().as_dict()
    state = _async_export.party(old_root).remote(session, cfg_dict, None)
    return _async_adopt.party(new_root).remote(
        session, cfg_dict, None, state
    )


def async_rebuild(
    new_root: str,
    session: str = "default",
    parties: Optional[Any] = None,
) -> AsyncRoundHandle:
    """Rebuild the session's buffer at ``new_root`` from survivor
    re-offers — the ``prv:recover`` pattern applied to the aggregator:
    when the root died WITH its buffer, each surviving driver re-offers
    its own last contribution (remembered from the most recent
    :func:`async_round`) at the same round tag, and the successor's
    fresh aggregator refolds them in re-arrival order. In-flight
    contributions from dead parties are lost — the round DEGRADES to
    the survivor set rather than disappearing with the root.

    ``parties`` restricts the re-offer to the surviving roster (default:
    every party of the remembered round). Every driver must make the
    identical call."""
    with _tags_lock:
        last = _last_rounds.get().get(session)
    if last is None:
        raise RuntimeError(
            f"async_rebuild({session!r}): no prior async_round to re-offer "
            f"from on this driver"
        )
    keep = None if parties is None else set(parties)
    objs = {
        p: o for p, o in last["objs"].items()
        if keep is None or p in keep
    }
    if not objs:
        raise RuntimeError(
            f"async_rebuild({session!r}): no surviving contributor to "
            f"re-offer from (parties={sorted(keep or ())})"
        )
    weights = last["weights"]
    if weights is not None:
        weights = {p: w for p, w in weights.items() if p in objs}
    return async_round(
        objs,
        round_tag=last["round_tag"],
        root=new_root,
        weights=weights,
        session=session,
        secure=last["secure"],
    )


def async_session_stats(
    root: str, session: str = "default"
) -> FedObject:
    """FedObject of the session's counters at the root (accepted /
    dropped_dead / dropped_stale / publishes / version / buffered)."""
    return _async_stats.party(root).remote(
        session, get_default_async_config().as_dict(), None
    )
