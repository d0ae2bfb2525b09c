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

"""The coordinator role: pending membership changes and the sync fold.

Lives on exactly one party (``membership.coordinator``, defaulting to
the root party). Requests arrive asynchronously — join/leave control
frames on the transport thread (dispatched by the rendezvous store's
control handler), DEAD verdicts from the liveness monitor's tick thread
— and are only *queued* there; the roster changes exactly at the next
``fed.membership_sync()`` on the driver thread, where the fold computes
one successor view, broadcasts it to the old roster, and sends each
admitted joiner its JoinAccept. Folding at the sync point (not at
arrival) is what keeps the multi-controller contract intact: every
party applies the same bump at the same program point.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Tuple

from rayfed_tpu_torch import tracing
from rayfed_tpu_torch._private.constants import CODE_FORBIDDEN, CODE_OK
from rayfed_tpu_torch.membership import protocol

logger = logging.getLogger(__name__)


class MembershipCoordinator:
    """Pending-change queue + sync-point fold (see module docstring)."""

    def __init__(self, manager) -> None:
        self._manager = manager
        self._lock = threading.Lock()
        # party -> join request dict (party-keyed so BOTH retry shapes
        # collapse to one admission: a retransmit with the same nonce
        # and a fresh-nonce retry after a timed-out handshake. The
        # latest nonce wins — exactly one JoinAccept goes out, addressed
        # to the request the joiner is still parked on).
        self._pending_joins: Dict[str, Dict] = {}
        self._pending_leaves: set = set()
        self._pending_evictions: set = set()
        self.stats: Dict[str, int] = {
            "joins_accepted": 0,
            "joins_rejected": 0,
            "leaves": 0,
            "evictions": 0,
            "epoch_bumps": 0,
        }

    # -- intake (transport / monitor threads) --------------------------

    def handle_control(self, header: Dict, value) -> Tuple[int, str]:
        """Dispatch one ``mbr:req:*`` control frame; the returned code
        rides the frame's ack (403 fails the sender's future). A request
        stamped with a HIGHER term than ours is proof we were deposed
        while partitioned: demote and refuse, naming the successor."""
        if isinstance(value, dict):
            req_term = int(value.get("term") or 0)
            if req_term > self._manager.term():
                self._manager.adopt_term(req_term, None)
                if not self._manager.is_coordinator():
                    return CODE_FORBIDDEN, (
                        f"this party was deposed as coordinator at term "
                        f"{req_term}; re-offer the request to "
                        f"{self._manager.coordinator()!r}"
                    )
        up = header.get("up", "")
        if up == protocol.JOIN_REQ_SEQ:
            return self._handle_join(value)
        if up == protocol.LEAVE_REQ_SEQ:
            return self._handle_leave(value)
        return CODE_FORBIDDEN, f"unknown membership request {up!r}"

    def _handle_join(self, req) -> Tuple[int, str]:
        if not isinstance(req, dict) or req.get("kind") != "join":
            return CODE_FORBIDDEN, "malformed join request"
        party, address, nonce = (
            req.get("party"), req.get("address"), req.get("nonce"),
        )
        if not party or not address or not nonce:
            return CODE_FORBIDDEN, "join request missing party/address/nonce"
        expected = self._manager.config.auth_token
        if expected is not None and req.get("token") != expected:
            with self._lock:
                self.stats["joins_rejected"] += 1
            logger.warning(
                "membership: rejecting join from %r (bad auth token)", party
            )
            return CODE_FORBIDDEN, "membership auth token mismatch"
        with self._lock:
            self._pending_joins[party] = {
                "party": party, "address": address, "nonce": nonce,
            }
        logger.info(
            "membership: queued join of %r (admitted at next sync)", party
        )
        return CODE_OK, "join queued"

    def _handle_leave(self, req) -> Tuple[int, str]:
        if not isinstance(req, dict) or req.get("kind") != "leave":
            return CODE_FORBIDDEN, "malformed leave request"
        party = req.get("party")
        if not party:
            return CODE_FORBIDDEN, "leave request missing party"
        with self._lock:
            # A retransmitted leave (ack lost, sender retried) must not
            # inflate the stat: count only the first insertion.
            if party not in self._pending_leaves:
                self._pending_leaves.add(party)
                self.stats["leaves"] += 1
        logger.info(
            "membership: queued departure of %r (removed at next sync)",
            party,
        )
        return CODE_OK, "leave queued"

    def note_dead(self, party: str) -> None:
        """Liveness DEAD escalation (monitor tick thread): queue the
        eviction; the roster change lands at the next sync."""
        if party not in self._manager.roster():
            return
        with self._lock:
            if party in self._pending_evictions:
                return
            self._pending_evictions.add(party)
        logger.warning(
            "membership: party %r is DEAD — evicting at next sync", party
        )

    def pending(self) -> Dict[str, List[str]]:
        with self._lock:
            return {
                "joins": sorted(
                    j["party"] for j in self._pending_joins.values()
                ),
                "leaves": sorted(self._pending_leaves),
                "evictions": sorted(self._pending_evictions),
            }

    # -- the sync-point fold (driver thread) ---------------------------

    def run_sync(self, sync_index: int):
        """Fold pending changes into a successor view, broadcast it to
        the old roster at ``("mbr:sync", sync_index)``, apply it locally,
        then send each admitted joiner its JoinAccept. Returns the
        (possibly unchanged) applied view."""
        from rayfed_tpu_torch.proxy import barriers

        manager = self._manager
        with self._lock:
            joins = list(self._pending_joins.values())
            self._pending_joins.clear()
            leaves = set(self._pending_leaves)
            self._pending_leaves.clear()
            evictions = set(self._pending_evictions)
            self._pending_evictions.clear()

        old_view = manager.view()
        # A party both joining and leaving/evicted in one window: the
        # explicit removal wins (its new incarnation can re-request); a
        # removal of a non-member is a no-op.
        remove_requested = (leaves | evictions) & set(old_view.roster)
        admitted = {
            j["party"]: j["address"]
            for j in joins
            if j["party"] not in remove_requested
        }
        # A join whose name is ALREADY in the roster is a rejoin: the
        # previous incarnation crashed and restarted before a liveness
        # eviction caught up (impostors are the auth token's problem).
        # Fold it as an implicit evict-then-admit — the epoch MUST bump
        # even when the address is unchanged, so every member purges the
        # pre-crash ghosts, cycles the connection, and the new admission
        # epoch outdates the old incarnation's frames. The joiner itself
        # gets the view from its JoinAccept, never the sync broadcast.
        rejoining = set(admitted) & set(old_view.roster)
        remove = remove_requested | rejoining
        accepted = [j for j in joins if j["party"] in admitted]
        new_view = old_view.with_changes(
            admitted, remove_requested, force_bump=bool(rejoining)
        )
        changed = new_view.epoch != old_view.epoch
        evicted_stamp = (
            {p: new_view.epoch for p in sorted(remove)} if changed else {}
        )
        # Full post-bump ghost tables ride every sync: a member that
        # missed an intermediate bump (recv timeout, lost frame) still
        # reconciles to complete state, not just this bump's delta.
        admissions_tbl, evictions_tbl = manager.ghost_tables()
        if changed:
            for p in remove:
                evictions_tbl[p] = new_view.epoch
                admissions_tbl.pop(p, None)
            for p in admitted:
                admissions_tbl[p] = new_view.epoch
                evictions_tbl.pop(p, None)
        term = manager.term()
        msg = protocol.make_sync(
            new_view.to_wire(), sync_index,
            admitted if changed else {}, evicted_stamp,
            admissions_tbl, evictions_tbl,
            term=term, coordinator=manager.self_party,
        )
        # Broadcast to the OLD roster (minus self, minus the removed):
        # those parties are parked at the same sync point; post-failover
        # terms qualify the key so a deposed predecessor's frame can
        # never have consumed the slot. Joiners learn the view from
        # their JoinAccept instead.
        down_key = protocol.sync_down_key(sync_index, term)
        for p in old_view.roster:
            if p == manager.self_party or p in remove:
                continue
            barriers.send(p, msg, protocol.SYNC_SEQ, down_key)
        with manager._lock:
            manager._record_sync_locked(sync_index, msg)
        if changed:
            applied = manager.apply_sync_msg(msg)
            with self._lock:
                self.stats["epoch_bumps"] += 1
                self.stats["joins_accepted"] += len(accepted)
                self.stats["evictions"] += len(evictions & remove)
        else:
            applied = old_view
        # Accepts AFTER the local apply: the joiner's address is admitted
        # into our sender proxy by the apply, and the ghost tables the
        # accept carries include this very bump.
        if accepted:
            bootstrap = manager.make_bootstrap()
            for j in accepted:
                barriers.send(
                    j["party"],
                    protocol.make_join_accept(
                        applied.to_wire(), sync_index,
                        admissions_tbl, evictions_tbl, bootstrap,
                        term=term,
                    ),
                    protocol.RESPONSE_SEQ,
                    j["nonce"],
                )
                tracing.record(
                    "membership", j["party"],
                    f"epoch:{old_view.epoch}", f"epoch:{applied.epoch}",
                    0, time.perf_counter(), event="admit",
                )
        return applied

    # -- liveness-triggered takeover (HA) ------------------------------

    def run_takeover(self, sync_index: int):
        """First sync after this party won a failover election. Before
        the term-``sync_index`` fold, re-broadcast the retained recent
        sync views VERBATIM (term restamped) at their new-term keys:
        a member whose previous recv failed rolled its index back and is
        re-waiting an OLDER sync point — it must receive the exact view
        the old coordinator agreed there, not our post-takeover fold,
        or rosters diverge per-round across the fleet. Then fold at
        ``sync_index`` as usual, which lands the deposed predecessor's
        eviction and replays every re-offered join/leave."""
        from rayfed_tpu_torch.proxy import barriers

        manager = self._manager
        term = manager.term()
        recent = manager.recent_syncs()
        roster = manager.roster()
        with self._lock:
            pending_remove = set(self._pending_leaves) | set(
                self._pending_evictions
            )
        for idx in sorted(recent):
            if idx >= sync_index:
                continue
            msg = dict(recent[idx])
            msg["term"] = term
            msg["coordinator"] = manager.self_party
            down_key = protocol.sync_down_key(idx, term)
            for p in roster:
                if p == manager.self_party or p in pending_remove:
                    continue
                barriers.send(p, msg, protocol.SYNC_SEQ, down_key)
        tracing.record(
            "failover", manager.self_party, f"sync:{sync_index}",
            f"term:{term}", 0, time.perf_counter(), event="takeover",
            resync=sorted(i for i in recent if i < sync_index),
        )
        logger.warning(
            "membership takeover: %r coordinating from sync %d at term "
            "%d (re-broadcast %s)", manager.self_party, sync_index, term,
            sorted(i for i in recent if i < sync_index),
        )
        return self.run_sync(sync_index)
