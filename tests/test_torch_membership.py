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

"""The port's elastic membership (``rayfed_tpu_torch.membership``): the
mirrors of ``tests/test_membership.py`` — the view/epoch algebra, the
coordinator's control intake and sync-point fold, the barrier layer's
epoch seq-id stamp, topology re-planning over a bumped roster,
ghost-offer rejection in the async plane on torch trees, rendezvous
ghost eviction, mid-run liveness peer mutation, and the spawned
lifecycle runs (join and leave; crash, evict and replace) with torch
contributions — plus a mixed-package ``fed.join``: a torch party joins a
JAX job, and a JAX party joins a torch job.
"""

import json
import os
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import topology as topo
from rayfed_tpu_torch._private.constants import CODE_FORBIDDEN, CODE_OK
from rayfed_tpu_torch.membership import (
    MembershipConfig,
    MembershipManager,
    MembershipView,
)
from rayfed_tpu_torch.membership import protocol
from rayfed_tpu_torch.membership.manager import set_membership_manager
from rayfed_tpu_torch.proxy import barriers, rendezvous
from rayfed_tpu_torch.resilience.liveness import (
    ALIVE,
    DEAD,
    LivenessConfig,
    LivenessMonitor,
)
from tests.utils import get_addresses, run_parties

# ---------------------------------------------------------------------------
# View / config algebra
# ---------------------------------------------------------------------------


def _view(parties, epoch=0):
    addrs = {p: f"127.0.0.1:{9000 + i}" for i, p in enumerate(parties)}
    return MembershipView(
        epoch=epoch, roster=tuple(sorted(parties)), addresses=addrs
    )


def test_view_with_changes_bumps_epoch_only_on_change():
    v = _view(["alice", "bob"])
    same = v.with_changes({}, set())
    assert same.epoch == 0 and same.roster == v.roster
    # Removing a non-member is a no-op, not a bump.
    assert v.with_changes({}, {"nobody"}).epoch == 0
    grown = v.with_changes({"carol": "127.0.0.1:1"}, set())
    assert grown.epoch == 1
    assert grown.roster == ("alice", "bob", "carol")
    assert grown.addresses["carol"] == "127.0.0.1:1"
    shrunk = grown.with_changes({}, {"bob"})
    assert shrunk.epoch == 2
    assert shrunk.roster == ("alice", "carol")
    assert "bob" not in shrunk.addresses
    # Wire round-trip preserves everything.
    back = MembershipView.from_wire(shrunk.to_wire())
    assert back == shrunk


def test_membership_config_rejects_unknown_keys():
    cfg = MembershipConfig.from_dict(
        {"coordinator": "alice", "auth_token": "t", "evict_dead": False}
    )
    assert cfg.coordinator == "alice" and not cfg.evict_dead
    with pytest.raises(ValueError, match="unknown"):
        MembershipConfig.from_dict({"coordinatr": "alice"})


# ---------------------------------------------------------------------------
# Epoch re-key: the barrier layer's seq-id stamp
# ---------------------------------------------------------------------------


def test_epoch_stamp_rekeys_integer_seq_ids():
    try:
        barriers.set_seq_epoch_fn(lambda: 3)
        assert barriers._stamp_epoch(7) == "e3:7"
        assert barriers._stamp_epoch(0) == "e3:0"
        # Strings (pings, membership control keys) pass through untouched.
        assert barriers._stamp_epoch("ping") == "ping"
        assert barriers._stamp_epoch("mbr:sync") == "mbr:sync"
    finally:
        barriers.clear_seq_epoch_fn()
    # No hook (membership-free job): identity, zero behavior change.
    assert barriers._stamp_epoch(7) == 7
    # Hook returning None (no epoch yet): identity too.
    try:
        barriers.set_seq_epoch_fn(lambda: None)
        assert barriers._stamp_epoch(7) == 7
    finally:
        barriers.clear_seq_epoch_fn()


def test_manager_current_epoch_follows_view():
    m = MembershipManager("j", "alice", _view(["alice", "bob"], epoch=4))
    assert m.current_epoch() == 4
    # The same function the barrier hook calls: a different seq-id space
    # per epoch means an e4 frame can never collide with an e5 frame.
    assert f"e{m.current_epoch()}:0" != "e5:0"


# ---------------------------------------------------------------------------
# Topology re-plan over a bumped roster
# ---------------------------------------------------------------------------


def test_manager_plan_matches_fresh_plan_over_roster():
    parties = [f"p{i}" for i in range(6)]
    m = MembershipManager("j", "p0", _view(parties))

    def canon(plan):
        return (
            plan.parties,
            plan.root,
            [[(s.dst, tuple(s.srcs)) for s in lvl] for lvl in plan.levels],
        )

    for shape in ("flat", "tree", "ring"):
        assert canon(m.plan(topology=shape)) == canon(
            topo.plan(sorted(parties), shape)
        ), shape
    # After a bump that evicts p3 and admits p6, the manager's plan must
    # equal a FRESH plan over the new roster — bit-for-bit the same
    # schedule any fixed-roster driver would lay out. No hole, no stale
    # slot where the evicted party used to reduce.
    bumped = m.view().with_changes({"p6": "127.0.0.1:1"}, {"p3"})
    m2 = MembershipManager("j", "p0", bumped)
    survivors = sorted(set(parties) - {"p3"} | {"p6"})
    for shape in ("flat", "tree", "ring"):
        plan = m2.plan(topology=shape)
        assert canon(plan) == canon(topo.plan(survivors, shape)), shape
        assert not any(
            "p3" in (s.dst, *s.srcs) for lvl in plan.levels for s in lvl
        )


# ---------------------------------------------------------------------------
# Sync application + ghost tables
# ---------------------------------------------------------------------------


def _no_kv_store(monkeypatch):
    # apply_sync_msg rewrites the KV cluster config; unit tests have no
    # KV (no fed.init), so stub the seam out.
    monkeypatch.setattr(
        MembershipManager, "_store_addresses_locked", lambda self, a: None
    )


def test_apply_sync_bump_updates_roster_and_ghost_tables(monkeypatch):
    _no_kv_store(monkeypatch)
    m = MembershipManager("j", "alice", _view(["alice", "bob", "dave"]))
    new_view = m.view().with_changes({"erin": "127.0.0.1:1"}, {"dave"})
    msg = protocol.make_sync(
        new_view.to_wire(), 5, {"erin": "127.0.0.1:1"}, {"dave": 1}
    )
    applied = m.apply_sync_msg(msg)
    assert applied.epoch == 1
    assert applied.roster == ("alice", "bob", "erin")
    # dave is out at epoch 1: any offer from it is now a ghost.
    assert m.is_ghost("dave", 0) and m.is_ghost("dave", 1)
    # erin's admission epoch is 1: an epoch-0 stamp would be a frame from
    # a pre-admission incarnation — ghost; epoch-1 (and None) are live.
    assert m.is_ghost("erin", 0)
    assert not m.is_ghost("erin", 1)
    assert not m.is_ghost("erin", None)
    assert not m.is_ghost("bob", 0)
    # Re-applying the same epoch is idempotent; an older epoch is a bug.
    assert m.apply_sync_msg(msg).epoch == 1
    stale = protocol.make_sync(_view(["alice"], epoch=0).to_wire(), 6, {}, {})
    with pytest.raises(RuntimeError, match="backwards"):
        m.apply_sync_msg(stale)


# ---------------------------------------------------------------------------
# Coordinator intake + sync-point fold (the handshake, server side)
# ---------------------------------------------------------------------------


def test_coordinator_join_intake_and_auth():
    m = MembershipManager(
        "j", "alice", _view(["alice", "bob"]),
        MembershipConfig(auth_token="s3cret"),
    )
    assert m.is_coordinator() and m.coordinator() == "alice"
    coord = m.get_coordinator_state()
    hdr = {"up": protocol.JOIN_REQ_SEQ, "src": "erin"}
    code, _ = coord.handle_control(
        hdr, protocol.make_join_request("erin", "127.0.0.1:1", "n1", "s3cret")
    )
    assert code == CODE_OK
    assert coord.pending()["joins"] == ["erin"]
    # Wrong token: 403 rides the request's ack and fails the joiner fast.
    code, msg = coord.handle_control(
        hdr, protocol.make_join_request("mallory", "127.0.0.1:2", "n2", "no")
    )
    assert code == CODE_FORBIDDEN and "token" in msg
    assert coord.stats["joins_rejected"] == 1
    # Malformed payloads never throw into the transport thread.
    assert coord.handle_control(hdr, "garbage")[0] == CODE_FORBIDDEN
    assert coord.handle_control({"up": "mbr:req:wat"}, {})[0] == CODE_FORBIDDEN
    # Retransmitted request (same nonce): still one pending admission.
    coord.handle_control(
        hdr, protocol.make_join_request("erin", "127.0.0.1:1", "n1", "s3cret")
    )
    assert coord.pending()["joins"] == ["erin"]


def test_coordinator_join_retry_fresh_nonce_stays_one_admission(monkeypatch):
    _no_kv_store(monkeypatch)
    sent = []
    monkeypatch.setattr(
        barriers, "send",
        lambda dest, data, up, down: sent.append((dest, data, up, down)),
    )
    m = MembershipManager("j", "alice", _view(["alice", "bob"]))
    coord = m.get_coordinator_state()
    hdr = {"up": protocol.JOIN_REQ_SEQ}
    coord.handle_control(
        hdr, protocol.make_join_request("erin", "127.0.0.1:1", "n1", None)
    )
    # The joiner timed out and retried with a FRESH nonce: still one
    # pending admission, addressed to the nonce it is parked on NOW.
    coord.handle_control(
        hdr, protocol.make_join_request("erin", "127.0.0.1:1", "n2", None)
    )
    assert coord.pending()["joins"] == ["erin"]
    coord.run_sync(1)
    accepts = [s for s in sent if s[2] == protocol.RESPONSE_SEQ]
    assert [(s[0], s[3]) for s in accepts] == [("erin", "n2")]
    assert coord.stats["joins_accepted"] == 1


def test_coordinator_leave_retransmit_counts_once():
    m = MembershipManager("j", "alice", _view(["alice", "bob"]))
    coord = m.get_coordinator_state()
    hdr = {"up": protocol.LEAVE_REQ_SEQ}
    req = protocol.make_leave_request("bob", "n1")
    assert coord.handle_control(hdr, req)[0] == CODE_OK
    assert coord.handle_control(hdr, req)[0] == CODE_OK  # ack-lost resend
    assert coord.pending()["leaves"] == ["bob"]
    assert coord.stats["leaves"] == 1


def test_run_sync_rejoin_of_live_name_is_evict_then_admit(monkeypatch):
    """A join whose party name is ALREADY in the roster — a crashed
    party restarted before liveness eviction caught up — must land as an
    implicit evict-then-admit: the epoch bumps even at an unchanged
    address, so the pre-crash incarnation's frames become ghosts and the
    joiner's fresh seq-0 space cannot collide with them."""
    _no_kv_store(monkeypatch)
    sent = []
    monkeypatch.setattr(
        barriers, "send",
        lambda dest, data, up, down: sent.append((dest, data, up, down)),
    )
    m = MembershipManager("j", "alice", _view(["alice", "bob", "dave"]))
    coord = m.get_coordinator_state()
    addr = m.view().addresses["dave"]  # SAME address: the no-change trap
    coord.handle_control(
        {"up": protocol.JOIN_REQ_SEQ},
        protocol.make_join_request("dave", addr, "n9", None),
    )
    applied = coord.run_sync(1)
    assert applied.epoch == 1
    assert applied.roster == ("alice", "bob", "dave")
    # The rejoiner is excluded from the sync broadcast (its accept
    # carries the view) and shows up in BOTH deltas of the message.
    syncs = [s for s in sent if s[2] == protocol.SYNC_SEQ]
    assert [s[0] for s in syncs] == ["bob"]
    msg = syncs[0][1]
    assert msg["admitted"] == {"dave": addr}
    assert msg["evicted"] == {"dave": 1}
    assert msg["admissions"]["dave"] == 1 and "dave" not in msg["evictions"]
    accepts = [s for s in sent if s[2] == protocol.RESPONSE_SEQ]
    assert [(s[0], s[3]) for s in accepts] == [("dave", "n9")]
    # Pre-crash frames (epoch 0) are ghosts; the new incarnation is live.
    assert m.is_ghost("dave", 0) and not m.is_ghost("dave", 1)
    assert coord.stats["joins_accepted"] == 1
    assert coord.stats["epoch_bumps"] == 1


def test_coordinator_note_dead_queues_one_eviction():
    m = MembershipManager("j", "alice", _view(["alice", "bob"]))
    coord = m.get_coordinator_state()
    coord.note_dead("bob")
    coord.note_dead("bob")  # monitor re-verdicts are deduped
    coord.note_dead("stranger")  # not in the roster: ignored
    assert coord.pending()["evictions"] == ["bob"]


def test_run_sync_folds_pending_and_emits_accept(monkeypatch):
    _no_kv_store(monkeypatch)
    sent = []
    monkeypatch.setattr(
        barriers, "send",
        lambda dest, data, up, down: sent.append((dest, data, up, down)),
    )
    m = MembershipManager("j", "alice", _view(["alice", "bob", "dave"]))
    coord = m.get_coordinator_state()
    # No pending changes: a same-epoch broadcast to the roster minus self.
    coord.run_sync(1)
    assert m.current_epoch() == 0
    assert sorted(s[0] for s in sent) == ["bob", "dave"]
    assert all(s[2] == protocol.SYNC_SEQ and s[3] == "1" for s in sent)

    sent.clear()
    coord.handle_control(
        {"up": protocol.JOIN_REQ_SEQ},
        protocol.make_join_request("erin", "127.0.0.1:1", "n1", None),
    )
    coord.note_dead("dave")
    applied = coord.run_sync(2)
    assert applied.epoch == 1
    assert applied.roster == ("alice", "bob", "erin")
    # Broadcast goes to the OLD roster minus self minus the evicted;
    # the joiner learns the view from its JoinAccept instead.
    syncs = [s for s in sent if s[2] == protocol.SYNC_SEQ]
    assert [s[0] for s in syncs] == ["bob"] and syncs[0][3] == "2"
    accepts = [s for s in sent if s[2] == protocol.RESPONSE_SEQ]
    assert [(s[0], s[3]) for s in accepts] == [("erin", "n1")]
    accept = accepts[0][1]
    assert accept["kind"] == "join-accept" and accept["sync_index"] == 2
    assert MembershipView.from_wire(accept["view"]) == applied
    assert accept["admissions"] == {"erin": 1}
    assert accept["evictions"] == {"dave": 1}
    assert coord.stats["epoch_bumps"] == 1
    assert coord.pending() == {"joins": [], "leaves": [], "evictions": []}
def test_membership_sync_rolls_back_index_on_timeout(monkeypatch):
    from concurrent.futures import TimeoutError as FuturesTimeout

    m = MembershipManager("j", "bob", _view(["alice", "bob"]))
    assert not m.is_coordinator()
    monkeypatch.setattr(barriers, "recv", lambda *a: Future())  # never lands
    with pytest.raises(FuturesTimeout):
        m.membership_sync(timeout=0.05)
    # The index rolled back: a retry re-waits the SAME sync key instead
    # of permanently consuming it and skipping a bump.
    assert m.sync_index() == 0
    done = Future()
    done.set_result(protocol.make_sync(m.view().to_wire(), 1, {}, {}))
    keys = []

    def recv(party, src, up, down):
        keys.append((up, down))
        return done

    monkeypatch.setattr(barriers, "recv", recv)
    applied = m.membership_sync(timeout=1.0)
    assert keys == [(protocol.SYNC_SEQ, "1")]
    assert m.sync_index() == 1 and applied.epoch == 0


def test_apply_sync_reconciles_full_view_across_missed_bump(monkeypatch):
    """A sync may arrive several epochs ahead of the local view (the
    previous sync's recv failed). Applying it must reconcile the WHOLE
    view — peers admitted at the missed bump still reach the sender
    proxy, departed ones are still dropped — not just the final delta."""
    _no_kv_store(monkeypatch)
    admits, forgets = [], []
    monkeypatch.setattr(
        barriers, "admit_peer", lambda p, a: admits.append((p, a))
    )
    monkeypatch.setattr(barriers, "forget_peer", forgets.append)
    m = MembershipManager("j", "alice", _view(["alice", "bob"]))
    # Missed bump 1 admitted carol; bump 2 evicted bob. The received
    # message carries only bump 2's delta, plus the full ghost tables.
    final = _view(["alice", "carol"], epoch=2)
    msg = protocol.make_sync(
        final.to_wire(), 2, {}, {"bob": 2},
        admissions={"alice": 0, "carol": 1}, evictions={"bob": 2},
    )
    applied = m.apply_sync_msg(msg)
    assert applied.roster == ("alice", "carol")
    assert admits == [("carol", final.addresses["carol"])]
    assert forgets == ["bob"]
    # Ghost tables were replaced wholesale from the sync's full tables.
    assert m.is_ghost("carol", 0) and not m.is_ghost("carol", 1)
    assert m.is_ghost("bob", 3)


# ---------------------------------------------------------------------------
# Ghost-offer rejection in the async plane
# ---------------------------------------------------------------------------


def test_buffered_aggregator_rejects_ghost_offers():
    from rayfed_tpu_torch.async_rounds import BufferedAggregator
    from rayfed_tpu_torch.config import AsyncAggregationConfig

    m = MembershipManager(
        "j", "alice", _view(["alice", "bob"], epoch=2),
        admissions={"bob": 2},
    )
    agg = BufferedAggregator(AsyncAggregationConfig(buffer_k=10))
    tree = {"w": torch.ones((2,))}
    set_membership_manager(m)
    try:
        # Not in the roster at all: ghost regardless of stamp.
        out = agg.offer("carol", tree, round_tag=0, epoch=2)
        assert out == {
            "accepted": False, "reason": "ghost", "staleness": 0,
            "weight": 0.0, "buffered": 0, "version": 0,
        }
        # Stamped with an epoch predating bob's current incarnation: a
        # pre-crash ghost of a since-rejoined party.
        assert not agg.offer("bob", tree, round_tag=0, epoch=1)["accepted"]
        assert agg.snapshot_stats()["dropped_ghost"] == 2
        # Current incarnation (and membership-free None stamp): accepted.
        assert agg.offer("bob", tree, round_tag=0, epoch=2)["accepted"]
        assert agg.offer("bob", tree, round_tag=0, epoch=None)["accepted"]
        assert agg.snapshot_stats()["dropped_ghost"] == 2
    finally:
        set_membership_manager(None)


# ---------------------------------------------------------------------------
# Rendezvous: ghost eviction + control-frame dispatch
# ---------------------------------------------------------------------------


def _store():
    return rendezvous.RendezvousStore("job", lambda header, payload: payload)


def _hdr(src, up, down):
    return {"job": "job", "src": src, "up": up, "down": down}


def test_rendezvous_evicts_departed_partys_parked_frames():
    store = _store()
    try:
        assert store.offer(_hdr("dave", "e0:1", "e0:1"), b"x")[0] == CODE_OK
        assert store.offer(_hdr("dave", "e0:2", "e0:2"), b"y")[0] == CODE_OK
        assert store.offer(_hdr("bob", "e0:1", "e0:3"), b"z")[0] == CODE_OK
        assert store.evict_source("dave") == 2
        assert store.get_stats()["ghost_evicted"] == 2
        # Evicted keys are tombstoned: a straggling resend from the dead
        # incarnation is acked-and-dropped, never re-parked — the
        # replacement's identically-numbered frames can't collide (they
        # carry a NEW epoch stamp anyway).
        code, msg = store.offer(_hdr("dave", "e0:1", "e0:1"), b"x")
        assert (code, msg) == (CODE_OK, "duplicate")
        # The bystander's frame is untouched.
        assert store.take("e0:1", "e0:3").result(timeout=1) == b"z"
        assert store.evict_source("dave") == 0  # idempotent
    finally:
        store.shutdown()


def test_evict_source_epoch_filter_spares_rejoined_incarnation():
    store = _store()
    try:
        store.offer(_hdr("dave", "e1:1", "e1:1"), b"old")
        store.offer(_hdr("dave", "e2:1", "e2:1"), b"new")
        store.offer(_hdr("dave", "mbr:rsp", "n1"), b"unstamped")
        # Eviction epoch 2: pre-eviction stamps and unstamped keys go;
        # the rejoined incarnation's e2 frame survives.
        assert store.evict_source("dave", before_epoch=2) == 2
        assert store.take("e2:1", "e2:1").result(timeout=1) == b"new"
    finally:
        store.shutdown()


def test_expire_sweep_reaps_only_known_evicted_sources():
    """The expire-loop sweep keys off the membership EVICTION table, not
    'src outside the roster': a fresh joiner's early frames (sent before
    this member applied the admitting sync) must park untouched, and a
    rejoined incarnation's post-eviction frames must survive too."""
    store = rendezvous.RendezvousStore(
        "job", lambda header, payload: payload, recv_timeout_s=0.4
    )
    try:
        rendezvous.set_evicted_fn("job", lambda: {"dave": 2})
        store.offer(_hdr("dave", "e1:1", "e1:1"), b"pre-crash")
        store.offer(_hdr("dave", "e2:1", "e2:1"), b"rejoined")
        store.offer(_hdr("erin", "e2:2", "e2:2"), b"joiner")
        deadline = time.monotonic() + 5
        while (
            time.monotonic() < deadline
            and store.get_stats()["ghost_evicted"] < 1
        ):
            time.sleep(0.05)
        assert store.get_stats()["ghost_evicted"] == 1
        # The reaped key is tombstoned; the survivors are deliverable.
        assert store.offer(_hdr("dave", "e1:1", "e1:1"), b"x")[1] == "duplicate"
        assert store.take("e2:1", "e2:1").result(timeout=1) == b"rejoined"
        assert store.take("e2:2", "e2:2").result(timeout=1) == b"joiner"
    finally:
        rendezvous.clear_evicted_fn("job")
        store.shutdown()


def test_rendezvous_dispatches_control_frames_to_handler():
    store = _store()
    try:
        hdr = _hdr("erin", protocol.JOIN_REQ_SEQ, "n1")
        # No coordinator registered at this party: 403 in the ack.
        code, msg = store.offer(hdr, b"req")
        assert code == CODE_FORBIDDEN and "coordinator" in msg
        seen = []

        def handler(header, value):
            seen.append((header["src"], value))
            return CODE_OK, "queued"

        rendezvous.set_control_handler("job", handler)
        try:
            assert store.offer(hdr, b"req") == (CODE_OK, "queued")
            assert seen == [("erin", b"req")]
        finally:
            rendezvous.clear_control_handler("job")
        # Control frames are never parked for a consumer.
        assert not store._arrived
    finally:
        store.shutdown()


# ---------------------------------------------------------------------------
# Liveness: mid-run peer mutation + DEAD escalation
# ---------------------------------------------------------------------------


def test_liveness_monitor_peers_mutable_and_on_dead_fires_once():
    alive = {"bob": True, "erin": True}

    def probe(p):
        f = Future()
        if alive[p]:
            f.set_result(True)
        else:
            f.set_exception(ConnectionError("down"))
        return f

    dead_calls = []
    mon = LivenessMonitor(
        ["bob"],
        LivenessConfig(interval_ms=10, suspect_after=1, dead_after=2),
        probe_fn=probe,
    )
    mon.set_on_dead(dead_calls.append)
    mon.tick()  # issue
    mon.tick()  # ack
    assert mon.view() == {"bob": ALIVE}
    # Satellite: a party added AFTER the monitor started shows up in the
    # view and is probed from the next tick — the set is not frozen.
    mon.add_peer("erin")
    assert mon.view() == {"bob": ALIVE, "erin": ALIVE}
    mon.tick()
    mon.tick()
    assert mon.state("erin") == ALIVE
    alive["erin"] = False
    mon.tick()  # settles last good probe, reissues a failing one
    mon.tick()  # miss 1
    mon.tick()  # miss 2 -> DEAD, on_dead fires on the edge
    assert mon.state("erin") == DEAD
    assert dead_calls == ["erin"]
    mon.tick()  # miss 3: NO second escalation
    assert dead_calls == ["erin"]
    # Eviction applied: the party vanishes from the view and its
    # outstanding probe is dropped.
    mon.remove_peer("erin")
    assert mon.view() == {"bob": ALIVE}
    mon.tick()
    assert "erin" not in mon.view()
    # add_peer is idempotent and a re-added party starts fresh.
    mon.add_peer("bob")
    assert mon.view() == {"bob": ALIVE}


# ===========================================================================
# Spawn-based lifecycle runs (slow)
# ===========================================================================

MBR_TOKEN = "mbr-test-token"
MBR_BASES = {
    "alice": 1.0, "bob": 2.0, "carol": 3.0, "dave": 4.0, "erin": 5.0,
}


def _fast_comm(extra=None):
    cfg = {
        "retry_policy": {
            "max_attempts": 2,
            "initial_backoff_ms": 50,
            "max_backoff_ms": 100,
        },
        "timeout_in_ms": 2000,
        "recv_timeout_in_ms": 2000,
        "send_deadline_in_ms": 4000,
    }
    cfg.update(extra or {})
    return cfg


# Slower than the JAX package's test timings (100 ms beats, DEAD after 4
# misses), which run apart as slow tests: these run with the suite on a
# loaded host, where a late heartbeat must not evict a live party. A
# crashed party is still DEAD within about 3 s.
_LIVENESS = {
    "interval_ms": 250, "suspect_after": 4, "dead_after": 12,
    "timeout_ms": 1000,
}


@fed.remote
def _mbr_update(base, r):
    return {"w": torch.full((4,), base * (r + 1), dtype=torch.float32)}


def _expected_mean(contributors, r):
    # Mirror of elastic_weighted_mean's float32 arithmetic: the updates
    # are integer-valued float32 (exact partial sums), uniform weights,
    # one float32 division at the end.
    total = np.float32(sum(MBR_BASES[p] * (r + 1) for p in contributors))
    return float(total / np.float32(len(contributors)))


def _run_rounds(party, entry_round, total_rounds, skip_first_sync,
                marker_dir, records):
    """The shared per-round driver: membership sync at the top (the ONE
    program point where the roster may change), contributions over the
    view's roster, elastic aggregation over what survived."""
    from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean

    for r in range(entry_round, total_rounds):
        if skip_first_sync and r == entry_round:
            # The joiner already holds the view of the sync that
            # admitted it (docs/membership.md) — syncing again here
            # would desynchronize the sync index with everyone else.
            view = fed.membership_view()
        else:
            view = fed.membership_sync(timeout=30.0)
        roster = sorted(view.roster)
        objs = {p: _mbr_update.party(p).remote(MBR_BASES[p], r)
                for p in roster}
        got = fed.get([objs[p] for p in roster], timeout=3.0,
                      on_missing="default")
        contribs = dict(zip(roster, got))
        live = fed.liveness_view()
        agg = elastic_weighted_mean(contribs, liveness=live)
        contributors = [
            p for p in roster
            if contribs[p] is not fed.MISSING and live.get(p) != DEAD
        ]
        assert party in contributors  # own update is local
        assert isinstance(agg["w"], torch.Tensor)
        np.testing.assert_allclose(
            agg["w"].numpy(),
            np.full((4,), _expected_mean(contributors, r), np.float32),
        )
        records.append({
            "round": r,
            "epoch": view.epoch,
            "roster": roster,
            "contributors": contributors,
            "agg": float(agg["w"][0]),
        })
        if marker_dir and party == "alice":
            # Round beacon: the joiner process keys its fed.join() off
            # these instead of wall-clock guesses.
            with open(os.path.join(marker_dir, f"round-{r}"), "w"):
                pass
        time.sleep(0.25)


def _wait_for_marker(marker_dir, r, timeout=120.0):
    deadline = time.monotonic() + timeout
    path = os.path.join(marker_dir, f"round-{r}")
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return
        time.sleep(0.05)
    raise AssertionError(f"no round-{r} marker within {timeout}s")


def _join_running_job(addresses, join_trigger_round, marker_dir):
    """Block until the founders reach ``join_trigger_round``, then run
    the fed.join handshake; returns this party's entry round."""
    from rayfed_tpu_torch.membership.manager import get_membership_manager

    _wait_for_marker(marker_dir, join_trigger_round)
    t0 = time.monotonic()
    bootstrap = fed.join(
        address=addresses["erin"],
        party="erin",
        coordinator="alice",
        coordinator_address=addresses["alice"],
        config={
            "cross_silo_comm": _fast_comm(),
            "resilience": {"liveness": dict(_LIVENESS)},
            "membership": {
                "auth_token": MBR_TOKEN,
                "coordinator": "alice",
                "sync_timeout_s": 30.0,
            },
        },
        timeout=90.0,
    )
    join_ms = (time.monotonic() - t0) * 1e3
    assert bootstrap is None  # no checkpoint/model-bank configured
    manager = get_membership_manager()
    view = fed.membership_view()
    assert "erin" in view.roster and view.epoch >= 1
    # Round r runs sync index r+1, and the accept's sync index is the
    # sync that admitted us — so our entry round is that index minus 1.
    entry_round = manager.sync_index() - 1
    return entry_round, join_ms


# ---------------------------------------------------------------------------
# Join + leave lifecycle (no faults)
# ---------------------------------------------------------------------------

LIFE_ROUNDS = 10
LIFE_JOIN_TRIGGER = 1  # erin dials in once the founders pass round 1


def run_lifecycle_party(party, addresses, workdir):
    founders = {p: a for p, a in addresses.items() if p != "erin"}
    records = []
    if party == "erin":
        entry, _ = _join_running_job(addresses, LIFE_JOIN_TRIGGER, workdir)
        # Participate for two rounds, then depart gracefully mid-training
        # (fed.leave runs the intended shutdown itself).
        leave_round = min(entry + 2, LIFE_ROUNDS - 2)
        _run_rounds(party, entry, leave_round, True, None, records)
        assert records, "joiner never completed a round"
        fed.leave(timeout=30.0)
        return
    fed.init(
        addresses=founders,
        party=party,
        config={
            "barrier_on_initializing": True,
            "cross_silo_comm": _fast_comm(),
            "resilience": {"liveness": dict(_LIVENESS)},
            "membership": {
                "coordinator": "alice",
                "auth_token": MBR_TOKEN,
                "sync_timeout_s": 30.0,
            },
        },
    )
    _run_rounds(party, 0, LIFE_ROUNDS, False, workdir, records)
    if party == "alice":
        with open(os.path.join(workdir, "alice.json"), "w") as f:
            json.dump(records, f, sort_keys=True)
    fed.shutdown()


def test_torch_join_leave_lifecycle(tmp_path):
    """A 2-party job grows to 3 when erin joins mid-training and shrinks
    back when it leaves: both roster changes land as epoch bumps at sync
    points, no round is lost, and every round's aggregate matches the
    contributors the coordinator recorded for it."""
    parties = ["alice", "bob", "erin"]
    run_parties(
        run_lifecycle_party, parties, timeout=180,
        extra_args=(str(tmp_path),),
        addresses=get_addresses(parties),
    )
    records = json.loads((tmp_path / "alice.json").read_text())
    assert [rec["round"] for rec in records] == list(range(LIFE_ROUNDS))
    assert all(rec["contributors"] for rec in records)  # no round lost
    rosters = [set(rec["roster"]) for rec in records]
    assert rosters[0] == {"alice", "bob"}
    assert {"alice", "bob", "erin"} in rosters, "join bump never landed"
    assert rosters[-1] == {"alice", "bob"}, "leave bump never landed"
    assert records[-1]["epoch"] >= 2  # one bump in, one bump out
    # Epochs only move forward, one sync at a time.
    epochs = [rec["epoch"] for rec in records]
    assert epochs == sorted(epochs)
    for rec in records:
        assert rec["agg"] == _expected_mean(
            rec["contributors"], rec["round"]
        )


# ---------------------------------------------------------------------------
# Churn chaos: crash + evict + replace, mid-training (the acceptance run)
# ---------------------------------------------------------------------------

CHURN_PARTIES = ["alice", "bob", "carol", "dave"]
CHURN_ROUNDS = 12
# dave pushes its update to 3 peers per 4-party round; after 9 data
# sends the injector's permanent crash fires on the FIRST push of round
# 3 — a mid-round kill, not a tidy boundary.
CHURN_CRASH_ROUND = 3
CHURN_CRASH_AFTER = 3 * CHURN_CRASH_ROUND
CHURN_JOIN_TRIGGER = 4  # erin dials in while the eviction is in flight


def run_churn_party(party, addresses, workdir):
    founders = {p: a for p, a in addresses.items() if p != "erin"}
    records = []
    if party == "erin":
        entry, join_ms = _join_running_job(
            addresses, CHURN_JOIN_TRIGGER, workdir
        )
        _run_rounds(party, entry, CHURN_ROUNDS, True, None, records)
        assert records, "replacement never completed a round"
        with open(os.path.join(workdir, "erin.json"), "w") as f:
            json.dump({"entry": entry, "join_ms": join_ms}, f)
        fed.shutdown()
        return
    config = {
        "barrier_on_initializing": True,
        "cross_silo_comm": _fast_comm(
            {"exit_on_sending_failure": True} if party == "dave" else None
        ),
        "resilience": {"liveness": dict(_LIVENESS)},
        "membership": {
            "coordinator": "alice",
            "auth_token": MBR_TOKEN,
            "evict_dead": True,
            "sync_timeout_s": 30.0,
        },
    }
    if party == "dave":
        # The kill switch: dave's 10th data push raises a permanent
        # InjectedFault, the unintended-shutdown path fires, and the
        # handler turns it into a clean exit the parent can assert on.
        config["resilience"]["fault_schedule"] = {
            "seed": 7,
            "rules": [{"fault": "crash", "src": "dave",
                       "after": CHURN_CRASH_AFTER}],
        }
    fed.init(
        addresses=founders,
        party=party,
        config=config,
        sending_failure_handler=(
            (lambda e: os._exit(0)) if party == "dave" else None
        ),
    )
    try:
        _run_rounds(party, 0, CHURN_ROUNDS, False, workdir, records)
    except BaseException:
        if party == "dave" and records and \
                records[-1]["round"] >= CHURN_CRASH_ROUND - 1:
            # Anything after the crash point is the expected death throes
            # (evicted mid-sync, interrupted by the exit signal, ...).
            os._exit(0)
        raise
    if party == "dave":
        raise AssertionError("dave survived its own crash schedule")
    if party == "alice":
        with open(os.path.join(workdir, "alice.json"), "w") as f:
            json.dump(records, f, sort_keys=True)
    fed.shutdown()


def test_torch_churn_chaos_replace_dead_party(tmp_path):
    """Acceptance: 4-party FedAvg; dave is killed mid-round by
    an injected crash, the liveness monitor's DEAD verdict evicts it at
    the next sync, and erin joins as its replacement mid-training.
    Training completes on every surviving party, no round loses its
    aggregate (churn_rounds_lost == 0), and each round's aggregate
    equals the fixed-roster recomputation over that round's recorded
    contributors."""
    parties = CHURN_PARTIES + ["erin"]
    run_parties(
        run_churn_party, parties, timeout=200,
        extra_args=(str(tmp_path),),
        addresses=get_addresses(parties),
    )
    records = json.loads((tmp_path / "alice.json").read_text())
    erin = json.loads((tmp_path / "erin.json").read_text())
    assert [rec["round"] for rec in records] == list(range(CHURN_ROUNDS))
    # The headline churn metric: every round aggregated something.
    rounds_lost = sum(1 for rec in records if not rec["contributors"])
    assert rounds_lost == 0
    final = records[-1]
    assert "dave" not in final["roster"], "dead party never evicted"
    assert "erin" in final["roster"], "replacement never admitted"
    assert "erin" in final["contributors"], "replacement never contributed"
    assert final["epoch"] >= 1
    assert 0 < erin["entry"] < CHURN_ROUNDS
    # dave contributed before the crash and is gone from the roster (not
    # merely MISSING) once the eviction bump lands.
    assert "dave" in records[0]["contributors"]
    evicted_at = min(
        rec["round"] for rec in records if "dave" not in rec["roster"]
    )
    assert evicted_at > CHURN_CRASH_ROUND - 1
    for rec in records[evicted_at:]:
        assert "dave" not in rec["roster"]
    # Aggregate correctness every round — including the degraded rounds
    # between crash and eviction, and the grown-roster rounds after the
    # join: the elastic mean equals the fixed-roster recomputation over
    # exactly the contributors that survived that round.
    for rec in records:
        assert rec["agg"] == _expected_mean(
            rec["contributors"], rec["round"]
        )


# ---------------------------------------------------------------------------
# A mixed-package fed.join: a torch party joins a JAX job, and the reverse
# ---------------------------------------------------------------------------

MIXED_ROUNDS = 5
MIXED_JOIN_TRIGGER = 1
MIXED_JOINS = {
    "torch_joins_jax_job": {"alice": "jax", "bob": "jax", "erin": "torch"},
    "jax_joins_torch_job": {"alice": "torch", "bob": "torch", "erin": "jax"},
}


def run_mixed_join_party(party, addresses, workdir, case):
    """The lifecycle driver with each party on its own package: founders
    alice and bob run one, erin joins on the other once the founders pass
    round MIXED_JOIN_TRIGGER, takes part in two rounds and leaves."""
    pkg = MIXED_JOINS[case][party]
    if pkg == "jax":
        import jax.numpy as jnp

        import rayfed_tpu as fed_
        from rayfed_tpu.membership.manager import get_membership_manager
        from rayfed_tpu.ops.aggregate import elastic_weighted_mean

        def full(v):
            return jnp.full((4,), v, jnp.float32)
    else:
        import rayfed_tpu_torch as fed_
        from rayfed_tpu_torch.membership.manager import get_membership_manager
        from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean

        def full(v):
            return torch.full((4,), v, dtype=torch.float32)

    @fed_.remote
    def update(base, r):
        return {"w": full(base * (r + 1))}

    config = {
        "cross_silo_comm": _fast_comm(),
        "membership": {"coordinator": "alice", "auth_token": MBR_TOKEN,
                       "sync_timeout_s": 30.0},
    }
    if party == "erin":
        _wait_for_marker(workdir, MIXED_JOIN_TRIGGER)
        fed_.join(address=addresses["erin"], party="erin",
                  coordinator="alice", coordinator_address=addresses["alice"],
                  config=config, timeout=90.0)
        entry = get_membership_manager().sync_index() - 1
        last = entry + 2
    else:
        fed_.init(addresses={p: a for p, a in addresses.items()
                             if p != "erin"},
                  party=party, config=dict(config,
                                           barrier_on_initializing=True))
        entry, last = 0, MIXED_ROUNDS
    records = []
    for r in range(entry, last):
        coord = (get_membership_manager().get_coordinator_state()
                 if party == "alice" else None)
        if party == "alice" and r == MIXED_JOIN_TRIGGER + 1:
            # erin's join lands at this sync, whatever the load.
            deadline = time.monotonic() + 60
            while "erin" not in coord.pending()["joins"]:
                assert time.monotonic() < deadline, "erin never joined"
                time.sleep(0.02)
        if party == "alice" and sum("erin" in rec["roster"]
                                    for rec in records) == 2:
            # erin has run her two rounds: her leave lands at this sync.
            deadline = time.monotonic() + 60
            while "erin" not in coord.pending()["leaves"]:
                assert time.monotonic() < deadline, "erin never left"
                time.sleep(0.02)
        view = (fed_.membership_view() if party == "erin" and r == entry
                else fed_.membership_sync(timeout=30.0))
        roster = sorted(view.roster)
        objs = {p: update.party(p).remote(MBR_BASES[p], r) for p in roster}
        got = dict(zip(roster, fed_.get([objs[p] for p in roster])))
        agg = elastic_weighted_mean(got)
        records.append({"round": r, "epoch": view.epoch, "roster": roster,
                        "agg": float(np.asarray(agg["w"])[0])})
        if party == "alice":
            with open(os.path.join(workdir, f"round-{r}"), "w"):
                pass
        time.sleep(0.25)
    if party == "erin":
        fed_.leave(timeout=30.0)
    else:
        fed_.shutdown()
    with open(os.path.join(workdir, f"{party}.json"), "w") as f:
        json.dump(records, f, sort_keys=True)


@pytest.mark.parametrize("case", sorted(MIXED_JOINS))
def test_mixed_package_join_and_leave(tmp_path, case):
    parties = ["alice", "bob", "erin"]
    run_parties(run_mixed_join_party, parties, timeout=150,
                extra_args=(str(tmp_path), case),
                addresses=get_addresses(parties))
    recs = {p: json.loads((tmp_path / f"{p}.json").read_text())
            for p in parties}
    rosters = [set(r["roster"]) for r in recs["alice"]]
    assert rosters[0] == {"alice", "bob"} and rosters[-1] == {"alice", "bob"}
    assert {"alice", "bob", "erin"} in rosters
    # Every party that ran a round saw the same view and aggregate.
    by_round = {}
    for p, rs in recs.items():
        for r in rs:
            by_round.setdefault(r["round"], []).append(
                (r["epoch"], tuple(r["roster"]), r["agg"]))
    for rnd, seen in by_round.items():
        assert len(set(seen)) == 1, (rnd, seen)
        epoch, roster, agg = seen[0]
        assert agg == _expected_mean(roster, rnd)
    assert len(recs["erin"]) == 2
