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

"""Per-party membership state and the join/leave/sync driving logic.

One :class:`MembershipManager` lives on every party of a membership-
enabled job (module singleton, wired by ``fed.init`` /  ``fed.join``).
It owns the party's copy of the agreed view, the ghost tables
(admission/eviction epochs per party), and the side effects an epoch
bump applies to the rest of the engine:

- cluster-config addresses (KV + module cache) — which parties a
  ``fed.get`` owner-push fans out to;
- sender-proxy peer set (``barriers.admit_peer`` / ``forget_peer``) —
  which destinations the reactor pool will dial;
- liveness monitor peer set;
- rendezvous ghost purge (``rendezvous.evict_source_everywhere``);
- the seq-id space: the driver-side counter resets to 0 and the barrier
  layer stamps subsequent integer seq ids with the new epoch, so a
  rejoining party can never collide with its pre-crash ghosts.

The sync protocol (``fed.membership_sync()``, one call per round
boundary on EVERY party — a seq-id-free collective): the coordinator
folds its pending joins/leaves/evictions into a successor view and
broadcasts it at the deterministic key ``("mbr:sync", sync_index)``;
every other party recvs that key. The sync index is a per-driver
monotonic counter advanced identically on all parties (multi-controller
contract), and it is never reset — unlike data seq ids it survives epoch
bumps, so a joiner admitted at sync S knows to recv sync S+1 next.
"""

# fedlint: disable-file=seq-divergence
# Membership is asymmetric by design: the coordinator broadcasts
# epoch bumps and collects acks while followers only respond, so
# sends/gets here are necessarily gated on the local role. Control
# traffic rides reserved ctl: seq ids outside the data DAG;
# FED002's lockstep rule is for drivers, not the control plane.

from __future__ import annotations

import logging
import pickle
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, Optional, Tuple

import rayfed_tpu_torch._private.constants as constants
import rayfed_tpu_torch.config as fed_config
from rayfed_tpu_torch import tracing
from rayfed_tpu_torch._private import kv as internal_kv
from rayfed_tpu_torch._private.global_context import get_global_context
from rayfed_tpu_torch.exceptions import StaleCoordinatorError
from rayfed_tpu_torch.membership import protocol
from rayfed_tpu_torch.membership.config import MembershipConfig
from rayfed_tpu_torch.membership.view import MembershipView
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

_m_epoch = telemetry_metrics.get_registry().gauge(
    "fed_membership_epoch",
    "This party's applied membership epoch.",
)
_m_roster_size = telemetry_metrics.get_registry().gauge(
    "fed_membership_roster_size",
    "Parties in this party's applied roster.",
)
_m_term = telemetry_metrics.get_registry().gauge(
    "fed_membership_coordinator_term",
    "This party's adopted coordinator term (0 = configured coordinator, "
    "bumped once per failover).",
)
_m_failovers = telemetry_metrics.get_registry().counter(
    "fed_membership_failovers_total",
    "Coordinator depositions this party adopted (term bumps).",
)
_m_stale_syncs = telemetry_metrics.get_registry().counter(
    "fed_membership_stale_syncs_rejected_total",
    "Sync broadcasts rejected because their term predates the adopted "
    "term (a deposed coordinator's stale view).",
)


def resolve_coordinator(config: MembershipConfig, roster) -> str:
    """The coordinator party: configured name, else the root party by the
    planner's convention (lexicographically first of the initial roster) —
    identical on every driver, so every party elects the same coordinator
    without a message."""
    if config.coordinator is not None:
        return config.coordinator
    return sorted(roster)[0]


class MembershipManager:
    """This party's membership-plane state (see module docstring)."""

    def __init__(
        self,
        job_name: str,
        self_party: str,
        view: MembershipView,
        config: Optional[MembershipConfig] = None,
        *,
        sync_index: int = 0,
        admissions: Optional[Dict[str, int]] = None,
        evictions: Optional[Dict[str, int]] = None,
        term: int = 0,
    ) -> None:
        self._job_name = job_name
        self._self_party = self_party
        self._config = config or MembershipConfig()
        self._lock = threading.RLock()
        self._view = view
        _m_epoch.set(view.epoch)
        _m_roster_size.set(len(view.roster))
        self._sync_index = int(sync_index)
        # Coordinator term (HA): bumped once per failover, carried in
        # every sync/request frame and in the sync rendezvous key. The
        # deposed chain records every coordinator this party stopped
        # trusting; elections pick sorted(roster - deposed)[0], which is
        # deterministic because liveness never enters the CHOICE — it
        # only decides WHEN a member gives up on the current holder.
        self._term = int(term)
        _m_term.set(self._term)
        self._deposed: set = set()
        # Recent agreed sync broadcasts ({sync_index: msg}, bounded by
        # failover.resync_window): a takeover coordinator re-sends these
        # VERBATIM (term restamped) for members trailing at older
        # indices, so every sync index maps to one view on every party.
        self._recent_syncs: Dict[int, Dict] = {}
        self._ha_stats: Dict[str, int] = {
            "failovers": 0,
            "takeovers": 0,
            "stale_syncs_rejected": 0,
        }
        # In-flight sync/takeover counter: fed.shutdown drains this so a
        # job shutting down during a failover exits cleanly instead of
        # tearing proxies out from under a mid-broadcast takeover.
        self._inflight = 0
        self._drain_cond = threading.Condition(self._lock)
        # Ghost tables. A party's ADMISSION epoch is the epoch of the
        # bump that added it (0 for the initial roster); its EVICTION
        # epoch is the epoch as of which it is out. An offer stamped
        # with epoch e from party p is a ghost iff p is not in the
        # roster, or e predates p's current incarnation (p rejoined
        # after a crash and e belongs to the pre-crash self).
        self._admissions: Dict[str, int] = dict(admissions or {})
        self._evictions: Dict[str, int] = dict(evictions or {})
        self._coordinator_name = resolve_coordinator(self._config, view.roster)
        self._bootstrap_provider: Optional[Callable[[], Any]] = None
        # The coordinator party's pending-change state; None elsewhere.
        self._coordinator = None
        if self._coordinator_name == self_party:
            from rayfed_tpu_torch.membership.coordinator import (
                MembershipCoordinator,
            )

            self._coordinator = MembershipCoordinator(self)

    # -- queries -------------------------------------------------------

    @property
    def job_name(self) -> str:
        return self._job_name

    @property
    def self_party(self) -> str:
        return self._self_party

    @property
    def config(self) -> MembershipConfig:
        return self._config

    def view(self) -> MembershipView:
        with self._lock:
            return self._view

    def current_epoch(self) -> int:
        """Registered as the barrier layer's seq-epoch hook: every
        integer seq id sent or received while this manager is installed
        is stamped ``e<epoch>:<n>``."""
        with self._lock:
            return self._view.epoch

    def roster(self) -> Tuple[str, ...]:
        with self._lock:
            return self._view.roster

    def sync_index(self) -> int:
        with self._lock:
            return self._sync_index

    def coordinator(self) -> str:
        with self._lock:
            return self._coordinator_name

    def is_coordinator(self) -> bool:
        return self._coordinator is not None

    def get_coordinator_state(self):
        return self._coordinator

    def term(self) -> int:
        with self._lock:
            return self._term

    def ha_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._ha_stats)

    def is_ghost(self, party: str, epoch: Optional[int]) -> bool:
        """True when an offer stamped ``epoch`` from ``party`` belongs to
        an evicted incarnation (see the ghost-table comment in
        ``__init__``). ``epoch=None`` (a pre-membership driver) is never
        a ghost unless the party itself is out of the roster."""
        with self._lock:
            if party not in self._view.roster:
                return True
            if epoch is None:
                return False
            return int(epoch) < int(self._admissions.get(party, 0))

    def ghost_tables(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        with self._lock:
            return dict(self._admissions), dict(self._evictions)

    def eviction_table(self) -> Dict[str, int]:
        """Snapshot of the eviction ghost table (party -> epoch as of
        which it is out). The rendezvous expire loop sweeps parked
        frames from exactly these sources — NOT from "anyone outside the
        roster", which would reap a fresh joiner's early frames on a
        member that has not applied the admitting sync yet."""
        with self._lock:
            return dict(self._evictions)

    def plan(self, topology: Optional[str] = None,
             group_size: Optional[int] = None):
        """The aggregation plan over the CURRENT roster — what
        ``fed_aggregate`` lowers to after this epoch's re-plan. Bitwise
        identical to a fresh ``topology.plan`` over the same roster
        (pinned by tests/test_membership.py)."""
        from rayfed_tpu_torch import topology as topo

        with self._lock:
            parties = list(self._view.roster)
        return topo.plan(
            parties,
            topology or topo.get_default()[0],
            group_size=group_size or topo.get_default()[1],
        )

    # -- bootstrap -----------------------------------------------------

    def set_bootstrap_provider(self, fn: Optional[Callable[[], Any]]) -> None:
        """Register the callable whose return value rides each
        JoinAccept as the joiner's bootstrap state. Return BOTH the
        model and the optimizer state (e.g. ``{"model": params,
        "opt_state": opt_state, "round": r}``) — a replacement party
        bootstrapped without optimizer state resumes inference, not
        training. Overrides the ``bootstrap_dir`` checkpoint fallback
        and the live ModelBank fallback."""
        self._bootstrap_provider = fn

    def make_bootstrap(self) -> Any:
        """Bootstrap state for a JoinAccept, by priority: the registered
        provider, else the newest ``checkpoint.py`` snapshot under
        ``membership.bootstrap_dir``, else the newest live ModelBank
        version on this party, else None.

        The checkpoint kind INLINES the snapshot's model and optimizer
        state (plus the pointer for anything else in the cut): a
        replacement joiner must resume training from the same optimizer
        trajectory, not restart momentum from zero against a trained
        model."""
        if self._bootstrap_provider is not None:
            return {"kind": "provider", "state": self._bootstrap_provider()}
        if self._config.bootstrap_dir:
            try:
                from rayfed_tpu_torch import checkpoint

                step = checkpoint.latest_step(self._config.bootstrap_dir)
                if step is not None:
                    path = checkpoint.step_dir(
                        self._config.bootstrap_dir, step
                    )
                    payload = {
                        "kind": "checkpoint",
                        "base_dir": self._config.bootstrap_dir,
                        "step": int(step),
                        "path": path,
                    }
                    try:
                        meta = checkpoint.load_meta(path)
                        if meta.get("kind") == "job":
                            restored = checkpoint.restore_job_state(
                                self._config.bootstrap_dir, step=int(step),
                                install=False,
                            )
                            payload["model"] = restored["model"]
                            payload["opt_state"] = restored["opt_state"]
                        else:
                            state = checkpoint.restore_party_state(path)
                            if isinstance(state, dict):
                                payload["model"] = state.get("model", state)
                                payload["opt_state"] = state.get("opt_state")
                            else:
                                payload["model"] = state
                    except Exception:  # noqa: BLE001 - pointer-only
                        # fallback: the joiner can still read the dir
                        logger.warning(
                            "membership: could not inline checkpoint "
                            "bootstrap state (sending pointer only)",
                            exc_info=True,
                        )
                    return payload
            except Exception:  # noqa: BLE001 - bootstrap is best-effort
                logger.warning(
                    "membership: checkpoint bootstrap lookup failed",
                    exc_info=True,
                )
        import sys as _sys

        server_mod = _sys.modules.get("rayfed_tpu_torch.serving.server")
        if server_mod is not None:
            try:
                # The registry is per job (the JAX package iterates the
                # JobScoped holder itself, which raises and is logged).
                servers = server_mod._servers.get()
                for name in sorted(servers):
                    bank = servers[name].bank
                    if bank.current_version() > 0:
                        version, params = bank.acquire()
                        try:
                            return {
                                "kind": "model_bank",
                                "serve_name": name,
                                "version": int(version),
                                "params": params,
                            }
                        finally:
                            bank.release(version)
            except Exception:  # noqa: BLE001 - bootstrap is best-effort
                logger.warning(
                    "membership: ModelBank bootstrap lookup failed",
                    exc_info=True,
                )
        return None

    # -- engine wiring -------------------------------------------------

    def install(self) -> None:
        """Register this manager's hooks with the rest of the engine:
        the barrier layer's seq-epoch stamp, the rendezvous eviction
        table (for ghost expiry), and — on the coordinator — the
        control-frame handler and the liveness DEAD escalation."""
        from rayfed_tpu_torch.proxy import barriers, rendezvous

        barriers.set_seq_epoch_fn(self.current_epoch)
        rendezvous.set_evicted_fn(self._job_name, self.eviction_table)
        if self._coordinator is not None:
            rendezvous.set_control_handler(
                self._job_name, self._coordinator.handle_control
            )
            from rayfed_tpu_torch.resilience import liveness

            monitor = liveness.get_monitor()
            if monitor is not None and self._config.evict_dead:
                monitor.set_on_dead(self._coordinator.note_dead)

    def uninstall(self) -> None:
        from rayfed_tpu_torch.proxy import barriers, rendezvous

        barriers.clear_seq_epoch_fn()
        rendezvous.clear_evicted_fn(self._job_name)
        rendezvous.clear_control_handler(self._job_name)
        from rayfed_tpu_torch.resilience import liveness

        monitor = liveness.get_monitor()
        if monitor is not None:
            monitor.set_on_dead(None)

    # -- the sync point ------------------------------------------------

    def membership_sync(
        self, timeout: Optional[float] = None
    ) -> MembershipView:
        """One membership sync: every roster party calls this at the
        same program point (a round boundary). Advances the sync index,
        then either folds-and-broadcasts (coordinator) or receives-and-
        applies (member). Consumes NO data seq ids — the sync key is the
        string pair ``("mbr:sync", <sync_index>)``."""
        with self._lock:
            self._sync_index += 1
            idx = self._sync_index
            self._inflight += 1
        try:
            if self._coordinator is not None:
                return self._coordinator.run_sync(idx)
            return self._member_sync(idx, timeout)
        finally:
            with self._lock:
                self._inflight -= 1
                self._drain_cond.notify_all()

    def _member_sync(
        self, idx: int, timeout: Optional[float]
    ) -> MembershipView:
        """The member side of one sync: wait on the coordinator's
        broadcast in ``failover.takeover_timeout_s`` slices; when a slice
        expires AND liveness says the coordinator is DEAD, depose it,
        adopt the next term, and either promote (we are the deterministic
        successor) or re-park at the successor's term-qualified key. The
        overall ``sync_timeout_s`` still bounds the whole wait, and a
        final failure still rolls the sync index back so a retry re-waits
        the SAME sync point."""
        from rayfed_tpu_torch.proxy import barriers
        from rayfed_tpu_torch.resilience import liveness

        fo = self._config.failover
        total = timeout if timeout is not None else self._config.sync_timeout_s
        deadline = time.monotonic() + total
        fut = None
        fut_key = None
        try:
            while True:
                with self._lock:
                    coord = self._coordinator_name
                    term = self._term
                key = protocol.sync_down_key(idx, term)
                if fut_key != (coord, key):
                    # One parked waiter per (coordinator, key): only a
                    # term change re-parks, so waiters never pile up.
                    fut = barriers.recv(
                        self._self_party, coord, protocol.SYNC_SEQ, key
                    )
                    fut_key = (coord, key)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise FuturesTimeout(
                        f"membership sync {idx} timed out after {total}s "
                        f"(coordinator {coord!r}, term {term})"
                    )
                slice_s = remaining
                if fo.enabled:
                    slice_s = min(remaining, float(fo.takeover_timeout_s))
                try:
                    msg = fut.result(timeout=slice_s)
                except (FuturesTimeout, TimeoutError):
                    # Slice expired — or the rendezvous store expired the
                    # parked waiter at its own recv deadline (the future
                    # itself failed; a fresh recv re-parks it).
                    if fut.done():
                        fut_key = None
                    if (
                        fo.enabled
                        and liveness.party_state(coord) == liveness.DEAD
                    ):
                        self._failover_elect(coord)
                        if self._coordinator is not None:
                            return self._coordinator.run_takeover(idx)
                    continue
                with self._lock:
                    self._record_sync_locked(idx, msg)
                return self.apply_sync_msg(msg)
        except BaseException:
            # The sync did NOT land: roll the index back so a retry
            # re-waits the SAME key (the coordinator's broadcast for it
            # may still be in flight and will park). Without this, the
            # index is consumed and the retry skips straight to the next
            # sync's key, leaving this one permanently unapplied.
            with self._lock:
                if self._sync_index == idx:
                    self._sync_index = idx - 1
            raise

    # -- coordinator failover ------------------------------------------

    def _record_sync_locked(self, idx: int, msg: Dict) -> None:
        self._recent_syncs[int(idx)] = msg
        window = int(self._config.failover.resync_window)
        for old in sorted(self._recent_syncs):
            if len(self._recent_syncs) <= window:
                break
            del self._recent_syncs[old]

    def recent_syncs(self) -> Dict[int, Dict]:
        with self._lock:
            return dict(self._recent_syncs)

    def _failover_elect(self, dead_coord: str) -> str:
        """Depose ``dead_coord``: adopt the next term and elect the
        deterministic successor — sorted(roster − deposed chain)[0].
        Liveness gates WHEN this runs, never WHO wins, so every survivor
        that deposes term T elects the identical term-T+1 coordinator
        without a message. Promotes this party (control handler, DEAD
        escalation, eviction of the deposed holder) when the election
        lands on us. Returns the successor's name."""
        from rayfed_tpu_torch.proxy import rendezvous
        from rayfed_tpu_torch.resilience import liveness

        promote = False
        with self._lock:
            if self._coordinator_name != dead_coord:
                return self._coordinator_name
            self._deposed.add(dead_coord)
            candidates = sorted(set(self._view.roster) - self._deposed)
            if not candidates:
                raise RuntimeError(
                    "membership failover: no candidate left for the "
                    "coordinator role (every roster party is deposed)"
                )
            old_term = self._term
            self._term += 1
            self._coordinator_name = candidates[0]
            successor = self._coordinator_name
            self._ha_stats["failovers"] += 1
            _m_term.set(self._term)
            _m_failovers.inc()
            if successor == self._self_party and self._coordinator is None:
                from rayfed_tpu_torch.membership.coordinator import (
                    MembershipCoordinator,
                )

                self._coordinator = MembershipCoordinator(self)
                self._ha_stats["takeovers"] += 1
                promote = True
            new_term = self._term
        tracing.record(
            "failover", dead_coord, f"term:{old_term}", f"term:{new_term}",
            0, time.perf_counter(), event="depose", successor=successor,
        )
        logger.warning(
            "membership failover: coordinator %r is DEAD — term %d -> %d, "
            "successor %r%s", dead_coord, old_term, new_term, successor,
            " (this party takes over)" if promote else "",
        )
        if promote:
            coordinator = self._coordinator
            rendezvous.set_control_handler(
                self._job_name, coordinator.handle_control
            )
            monitor = liveness.get_monitor()
            if monitor is not None and self._config.evict_dead:
                monitor.set_on_dead(coordinator.note_dead)
            if self._config.evict_dead:
                # The deposed holder leaves the roster at our first sync
                # as coordinator — the takeover bump.
                coordinator.note_dead(dead_coord)
        return successor

    def adopt_term(self, term: int, coordinator: Optional[str]) -> None:
        """Adopt a HIGHER term learned from a frame (a sync or request
        stamped ahead of us): record the deposition we missed and track
        the sender's coordinator. A coordinator that learns of its own
        deposition this way demotes — it stops folding; its own stale
        broadcasts are rejected by every member's term check anyway."""
        with self._lock:
            if int(term) <= self._term:
                return
            old_term = self._term
            self._term = int(term)
            _m_term.set(self._term)
            _m_failovers.inc()
            self._ha_stats["failovers"] += 1
            if coordinator is None:
                # The frame proves a deposition happened but not who
                # won: depose the current holder and elect from the
                # chain — the same deterministic choice the deposers
                # made, so it names the same winner.
                self._deposed.add(self._coordinator_name)
                candidates = sorted(set(self._view.roster) - self._deposed)
                coordinator = (
                    candidates[0] if candidates else self._self_party
                )
            demoted = False
            if coordinator != self._self_party:
                if self._coordinator_name != coordinator:
                    self._deposed.add(self._coordinator_name)
                    self._coordinator_name = coordinator
                demoted = self._coordinator is not None
                if demoted:
                    self._coordinator = None
        if demoted:
            from rayfed_tpu_torch.proxy import rendezvous

            rendezvous.clear_control_handler(self._job_name)
            logger.warning(
                "membership failover: this party was deposed as "
                "coordinator (term %d -> %d, successor %r)",
                old_term, term, coordinator,
            )
        else:
            logger.info(
                "membership failover: adopted term %d (coordinator %r)",
                term, coordinator,
            )

    # -- checkpoint cut (docs/ha.md) -----------------------------------

    def export_snapshot(self) -> Dict[str, Any]:
        """This party's membership state for a job checkpoint cut: the
        agreed view, the never-reset sync index, the adopted term and
        deposed chain, and the full ghost tables. Wire/JSON-clean."""
        with self._lock:
            return {
                "view": self._view.to_wire(),
                "sync_index": self._sync_index,
                "term": self._term,
                "deposed": sorted(self._deposed),
                "admissions": dict(self._admissions),
                "evictions": dict(self._evictions),
            }

    def restore_snapshot(self, snap: Dict[str, Any]) -> None:
        """Fast-forward this manager to a checkpointed cut. Only state
        AT or AHEAD of ours applies (sync index, term, epoch) — a
        restart re-inits at epoch 0/term 0 and then replays the cut, so
        every restored party resumes with the identical epoch stamp,
        sync key, and ghost tables it checkpointed with."""
        view = MembershipView.from_wire(snap["view"])
        promote = False
        with self._lock:
            if int(snap.get("sync_index", 0)) > self._sync_index:
                self._sync_index = int(snap["sync_index"])
            if int(snap.get("term", 0)) > self._term:
                self._term = int(snap["term"])
                _m_term.set(self._term)
            self._deposed |= set(snap.get("deposed") or ())
            if self._term > 0:
                # Post-failover cut: the election result, not the
                # configured name, is the coordinator going forward.
                candidates = sorted(set(view.roster) - self._deposed)
                if candidates:
                    self._coordinator_name = candidates[0]
            if view.epoch > self._view.epoch:
                self._apply_bump_locked(
                    view, {}, {},
                    snap.get("admissions"), snap.get("evictions"),
                )
            else:
                self._admissions.update(
                    {p: int(e) for p, e in
                     (snap.get("admissions") or {}).items()}
                )
                self._evictions.update(
                    {p: int(e) for p, e in
                     (snap.get("evictions") or {}).items()}
                )
            if (
                self._coordinator_name == self._self_party
                and self._coordinator is None
            ):
                from rayfed_tpu_torch.membership.coordinator import (
                    MembershipCoordinator,
                )

                self._coordinator = MembershipCoordinator(self)
                promote = True
        if promote:
            # Re-run the coordinator half of install(): the cut says the
            # role migrated to this party before the checkpoint.
            self.install()
        logger.info(
            "membership: restored checkpoint cut (epoch %d, sync %d, "
            "term %d)", self.current_epoch(), self.sync_index(),
            self.term(),
        )

    def drain_takeover(self, timeout: float = 2.0) -> bool:
        """Block until no membership sync / takeover is in flight (or
        the timeout lapses). ``fed.shutdown`` calls this before tearing
        the membership plane down so a mid-takeover broadcast finishes
        against live proxies. Returns True when quiescent."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._lock:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._drain_cond.wait(remaining)
            return True

    def apply_sync_msg(self, msg: Dict) -> MembershipView:
        # Term fencing FIRST: a deposed coordinator's sync was folded
        # without the failover's evictions — applying it would fork the
        # roster. (The rendezvous key already keeps it from consuming
        # the live broadcast's slot; this rejects one handed to us
        # directly.) A HIGHER term is a failover we missed: adopt it.
        msg_term = int(msg.get("term") or 0)
        with self._lock:
            if msg_term < self._term:
                self._ha_stats["stale_syncs_rejected"] += 1
                _m_stale_syncs.inc()
                raise StaleCoordinatorError(
                    msg_term, self._term, msg.get("coordinator")
                )
        if msg_term > self.term():
            self.adopt_term(msg_term, msg.get("coordinator"))
        new_view = MembershipView.from_wire(msg["view"])
        admitted = dict(msg.get("admitted") or {})
        evicted = {
            p: int(e) for p, e in (msg.get("evicted") or {}).items()
        }
        with self._lock:
            if new_view.epoch == self._view.epoch:
                return self._view
            if new_view.epoch < self._view.epoch:
                raise RuntimeError(
                    f"membership sync went backwards: applied epoch "
                    f"{self._view.epoch}, received {new_view.epoch}"
                )
            return self._apply_bump_locked(
                new_view, admitted, evicted,
                msg.get("admissions"), msg.get("evictions"),
            )

    def _apply_bump_locked(
        self,
        new_view: MembershipView,
        admitted: Dict[str, str],
        evicted: Dict[str, int],
        admissions: Optional[Dict[str, int]] = None,
        evictions: Optional[Dict[str, int]] = None,
    ) -> MembershipView:
        """Install a successor view and apply its side effects. Caller
        holds the lock; the side effects below touch only module-level
        seams (KV, proxies, monitor) that take their own locks.

        ``admitted``/``evicted`` are THIS bump's delta (tracing, eager
        ghost purge); ``admissions``/``evictions`` are the coordinator's
        full post-bump ghost tables. The side effects reconcile the FULL
        view, not the delta — the received epoch may be several bumps
        ahead of ours (a sync recv timed out and a later one applied),
        and a delta-only apply would leave intermediate joiners unknown
        to the sender proxy and intermediate leavers undropped."""
        old_view = self._view
        old_epoch = old_view.epoch
        if admissions is not None and evictions is not None:
            # Self-contained sync: the tables replace ours wholesale.
            self._admissions = {p: int(e) for p, e in admissions.items()}
            self._evictions = {p: int(e) for p, e in evictions.items()}
        else:
            for p, e in evicted.items():
                self._evictions[p] = int(e)
                self._admissions.pop(p, None)
            for p in admitted:
                self._admissions[p] = new_view.epoch
                self._evictions.pop(p, None)
        self._view = new_view
        _m_epoch.set(new_view.epoch)
        _m_roster_size.set(len(new_view.roster))
        # A re-admitted party is a fresh incarnation: make it electable
        # again (the deposed chain fences the DEAD incarnation, not the
        # name forever).
        self._deposed -= set(admitted)

        from rayfed_tpu_torch.proxy import barriers, rendezvous

        # Addresses first: the cluster config is what fed.get broadcasts
        # and new sender workers dial from.
        self._store_addresses_locked(new_view.addresses)
        from rayfed_tpu_torch.resilience import liveness

        monitor = liveness.get_monitor()
        # Removal side effects FIRST, admissions second: a rejoining
        # party appears in BOTH sets (implicit evict-then-admit) and has
        # to come out the other side admitted — connection cycled, pre-
        # crash parked frames purged. Beyond the delta, drop any peer
        # that silently fell out of the roster across a missed bump.
        stale = set(old_view.roster) - set(new_view.roster)
        for p in sorted(set(evicted) | stale):
            if p == self._self_party:
                continue
            barriers.forget_peer(p)
            if monitor is not None:
                monitor.remove_peer(p)
            # Purge the party's parked frames NOW. For a rejoiner this
            # eager purge is the ONLY purge: once re-admitted it leaves
            # the eviction table, so the expire-loop sweep no longer
            # matches its old frames.
            rendezvous.evict_source_everywhere(self._job_name, p)
        # Admissions reconcile the full roster: every roster address is
        # (re-)taught to the sender proxy and the liveness monitor, both
        # idempotent — so joiners admitted at a bump we never saw still
        # get dialed.
        for p, addr in new_view.addresses.items():
            if p == self._self_party:
                continue
            barriers.admit_peer(p, addr)
            if monitor is not None:
                monitor.add_peer(p)

        # Re-key the seq-id space: the driver-side counter restarts at 0
        # and the barrier layer stamps the new epoch onto every integer
        # seq id from here on. Every party performs this at its own sync
        # call — the same program point — so the DAG numbering stays
        # aligned across the bump.
        ctx = get_global_context()
        if ctx is not None:
            ctx.reset_seq_id()

        now = time.perf_counter()
        for p in admitted:
            tracing.record(
                "membership", p, f"epoch:{old_epoch}",
                f"epoch:{new_view.epoch}", 0, now, event="join",
            )
        for p in evicted:
            tracing.record(
                "membership", p, f"epoch:{old_epoch}",
                f"epoch:{new_view.epoch}", 0, now, event="evict",
            )
        tracing.record(
            "membership", self._self_party, f"epoch:{old_epoch}",
            f"epoch:{new_view.epoch}", 0, now, event="epoch-bump",
            roster=list(new_view.roster),
        )
        logger.info(
            "membership epoch %d -> %d: roster=%s admitted=%s evicted=%s",
            old_epoch, new_view.epoch, list(new_view.roster),
            sorted(admitted), sorted(evicted),
        )
        return new_view

    def _store_addresses_locked(self, addresses: Dict[str, str]) -> None:
        """Rewrite the KV cluster config with the new roster addresses
        (preserving party identity and TLS) and drop the module cache so
        the next ``get_cluster_config`` re-reads it."""
        cfg = fed_config.get_cluster_config(self._job_name)
        tls = cfg.tls_config if cfg is not None else {}
        cluster_config = {
            constants.KEY_OF_CLUSTER_ADDRESSES: dict(addresses),
            constants.KEY_OF_CURRENT_PARTY_NAME: self._self_party,
            constants.KEY_OF_TLS_CONFIG: tls,
        }
        internal_kv.kv_put(
            self._job_name,
            constants.KEY_OF_CLUSTER_CONFIG,
            pickle.dumps(cluster_config),
        )
        fed_config.reset_config_cache()

    # -- graceful departure -------------------------------------------

    def leave(self, timeout: Optional[float] = None) -> None:
        """Graceful departure: tell the coordinator (it removes us at
        its next sync), then stop participating. The caller (fed.leave)
        tears the runtime down afterwards — the cleanup manager drains
        in-flight sends there, and shutdown releases our rendezvous
        entries with the proxies."""
        if self._coordinator is not None:
            raise RuntimeError(
                "the coordinator party cannot leave the job it "
                "coordinates (hand the role off by restarting the job "
                "with a different membership.coordinator)"
            )
        from rayfed_tpu_torch.proxy import barriers
        from rayfed_tpu_torch.resilience import liveness

        timeout = (
            timeout if timeout is not None else self._config.sync_timeout_s
        )
        nonce = protocol.new_nonce()
        coord = self.coordinator()
        try:
            barriers.send(
                coord,
                protocol.make_leave_request(
                    self._self_party, nonce, term=self.term()
                ),
                protocol.LEAVE_REQ_SEQ,
                nonce,
            ).result(timeout=timeout)
        except Exception:  # noqa: BLE001 - departure is best-effort: an
            # unreachable coordinator will evict us via liveness anyway.
            # Re-offer once against the failover successor first — the
            # takeover replays membership intent from exactly these
            # re-offered requests (docs/ha.md).
            reoffered = False
            if (
                self._config.failover.enabled
                and liveness.party_state(coord) == liveness.DEAD
            ):
                successor = self._failover_elect(coord)
                if successor not in (coord, self._self_party):
                    try:
                        barriers.send(
                            successor,
                            protocol.make_leave_request(
                                self._self_party, nonce, term=self.term()
                            ),
                            protocol.LEAVE_REQ_SEQ,
                            nonce,
                        ).result(timeout=timeout)
                        reoffered = True
                    except Exception:  # noqa: BLE001 - same best-effort
                        pass
            if not reoffered:
                logger.warning(
                    "membership: leave notification to coordinator %s "
                    "failed (liveness eviction will reap this party "
                    "instead)", coord, exc_info=True,
                )
        tracing.record(
            "membership", self._self_party,
            f"epoch:{self.current_epoch()}", "left", 0,
            time.perf_counter(), event="leave",
        )


# -- joiner handshake --------------------------------------------------


def join_handshake(
    job_name: str,
    self_party: str,
    self_address: str,
    coordinator_party: str,
    config: MembershipConfig,
    timeout: Optional[float] = None,
) -> Tuple[MembershipManager, Any]:
    """Run the join handshake against an already-initialized two-party
    runtime ({self, coordinator}): send a JoinRequest, park on the
    JoinAccept, then build + install the manager and admit the full
    roster. Returns ``(manager, bootstrap)``.

    The accept arrives at the coordinator's NEXT sync point, where the
    whole roster's epoch bump admits us — so by the time this returns,
    every member party has (or is applying) a view containing us, our
    seq counter is 0, and our epoch stamp matches theirs.
    """
    from rayfed_tpu_torch.proxy import barriers

    timeout = timeout if timeout is not None else config.join_timeout_s
    deadline = time.monotonic() + timeout
    nonce = protocol.new_nonce()
    # Park on the accept BEFORE the request is acked: the coordinator's
    # sync may fire between ack and a later recv registration, and the
    # accept must find a waiter (or park as arrived) either way.
    accept_fut = barriers.recv(
        self_party, coordinator_party, protocol.RESPONSE_SEQ, nonce
    )
    req_fut = barriers.send(
        coordinator_party,
        protocol.make_join_request(
            self_party, self_address, nonce, config.auth_token
        ),
        protocol.JOIN_REQ_SEQ,
        nonce,
    )
    # The request's ack carries the control handler's verdict: a 403
    # (bad token) fails this future immediately, long before the accept
    # timeout would expire.
    req_fut.result(timeout=max(0.1, deadline - time.monotonic()))
    accept = accept_fut.result(
        timeout=max(0.1, deadline - time.monotonic())
    )
    if not isinstance(accept, dict) or accept.get("kind") != "join-accept":
        raise RuntimeError(
            f"malformed join accept from coordinator: {type(accept)}"
        )

    view = MembershipView.from_wire(accept["view"])
    manager = MembershipManager(
        job_name,
        self_party,
        view,
        config,
        sync_index=int(accept["sync_index"]),
        admissions=accept.get("admissions") or {},
        evictions=accept.get("evictions") or {},
        term=int(accept.get("term") or 0),
    )
    # Admit the full roster locally: addresses into the KV config and
    # the sender proxy, peers into the liveness monitor.
    manager._store_addresses_locked(view.addresses)
    from rayfed_tpu_torch.resilience import liveness

    monitor = liveness.get_monitor()
    for p, addr in view.addresses.items():
        if p == self_party:
            continue
        barriers.admit_peer(p, addr)
        if monitor is not None:
            monitor.add_peer(p)
    # Align the seq-id space with the epoch bump that admitted us: every
    # member reset to 0 at that bump; we start there too.
    ctx = get_global_context()
    if ctx is not None:
        ctx.reset_seq_id()
    manager.install()
    set_membership_manager(manager)
    # Warm the reactor dial to every peer (best-effort — the data lane
    # dials lazily on first send regardless).
    for p in view.roster:
        if p != self_party:
            try:
                barriers.send_ping(p)
            except Exception:  # noqa: BLE001 - lazy dial covers it
                pass
    tracing.record(
        "membership", self_party, "join",
        f"epoch:{view.epoch}", 0, time.perf_counter(), event="joined",
        sync_index=manager.sync_index(),
    )
    logger.info(
        "membership: joined job %r as %r at epoch %d (roster=%s)",
        job_name, self_party, view.epoch, list(view.roster),
    )
    return manager, accept.get("bootstrap")


# -- per-job manager slot wired by fed.init / fed.join -----------------

from rayfed_tpu_torch.tenancy.context import JobScoped

_managers: "JobScoped[MembershipManager]" = JobScoped("membership.manager")


def set_membership_manager(manager: Optional[MembershipManager]) -> None:
    if manager is None:
        _managers.pop()
    else:
        _managers.set(manager)


def get_membership_manager() -> Optional[MembershipManager]:
    return _managers.peek()


def clear_membership_manager() -> None:
    manager = _managers.pop()
    if manager is not None:
        try:
            manager.uninstall()
        except Exception:  # noqa: BLE001 - teardown best-effort
            logger.warning("membership uninstall failed", exc_info=True)


def current_epoch_or_none() -> Optional[int]:
    """The installed manager's epoch, or None on membership-free jobs —
    the stamp the async plane attaches to offers."""
    manager = _managers.peek()
    return None if manager is None else manager.current_epoch()
