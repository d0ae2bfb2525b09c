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

"""The port's control-plane HA (``rayfed_tpu_torch``: membership failover,
aggregator handoff, job checkpoints): the mirrors of ``tests/test_ha.py``
on torch trees — term fencing and the term-qualified sync key, the
deterministic deposed-chain election, takeover re-broadcast, demotion of
a deposed coordinator, the aggregator's export/adopt handoff continuing
bitwise, the job checkpoint cut round trip, retention pruning, the
shutdown drain hooks, and the three spawned chaos runs. The job
checkpoint restart runs in plaintext: the JAX package's secure version
waits for the privacy plane (ROADMAP item 11), and so does its DP-ledger
restore.
"""

import json
import os
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import async_rounds as ar
from rayfed_tpu_torch import checkpoint
from rayfed_tpu_torch._private.constants import CODE_FORBIDDEN
from rayfed_tpu_torch.config import AsyncAggregationConfig
from rayfed_tpu_torch.membership import (
    MembershipConfig,
    MembershipManager,
    MembershipView,
)
from rayfed_tpu_torch.membership import protocol
from rayfed_tpu_torch.membership.config import FailoverConfig
from rayfed_tpu_torch.proxy import barriers, rendezvous
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics
from tests.utils import get_addresses, run_parties

# ---------------------------------------------------------------------------
# Config algebra
# ---------------------------------------------------------------------------


def _view(parties, epoch=0):
    addrs = {p: f"127.0.0.1:{9000 + i}" for i, p in enumerate(parties)}
    return MembershipView(
        epoch=epoch, roster=tuple(sorted(parties)), addresses=addrs
    )


def _no_kv_store(monkeypatch):
    # apply_sync_msg rewrites the KV cluster config; unit tests have no
    # KV (no fed.init), so stub the seam out.
    monkeypatch.setattr(
        MembershipManager, "_store_addresses_locked", lambda self, a: None
    )


def test_failover_config_strict():
    cfg = MembershipConfig.from_dict(
        {"coordinator": "alice",
         "failover": {"takeover_timeout_s": 0.5, "resync_window": 4}}
    )
    assert cfg.failover.takeover_timeout_s == 0.5
    assert cfg.failover.resync_window == 4
    assert cfg.failover.enabled
    with pytest.raises(ValueError, match="unknown membership.failover"):
        MembershipConfig.from_dict({"failover": {"takover_timeout_s": 1}})
    with pytest.raises(ValueError, match="failover must be a dict"):
        MembershipConfig.from_dict({"failover": 5})
    with pytest.raises(ValueError, match="takeover_timeout_s must be > 0"):
        FailoverConfig(takeover_timeout_s=0)
    with pytest.raises(ValueError, match="resync_window must be >= 1"):
        FailoverConfig(resync_window=0)


def test_checkpoint_config_strict():
    cfg = checkpoint.CheckpointConfig.from_dict(
        {"base_dir": "/tmp/x", "keep": 5}
    )
    assert cfg.base_dir == "/tmp/x" and cfg.keep == 5
    with pytest.raises(ValueError, match="unknown checkpoint"):
        checkpoint.CheckpointConfig.from_dict({"kep": 2})
    with pytest.raises(ValueError, match="keep must be >= 0"):
        checkpoint.CheckpointConfig.from_dict({"keep": -1})
    try:
        checkpoint.set_default_checkpoint_config({"base_dir": "/tmp/y"})
        assert checkpoint.get_default_checkpoint_config().base_dir == "/tmp/y"
    finally:
        checkpoint.reset_default_checkpoint_config()
    assert checkpoint.get_default_checkpoint_config().base_dir is None


def test_init_rejects_checkpoint_typo_before_any_state():
    addresses = get_addresses(["alice"])
    with pytest.raises(ValueError, match="unknown checkpoint"):
        fed.init(
            addresses=addresses, party="alice",
            config={"checkpoint": {"kep": 1}},
        )


def test_sync_down_key_term_qualified():
    # Term 0 keeps the pre-HA wire shape (a mixed-version fleet at term
    # 0 interoperates); any positive term qualifies the key so a deposed
    # coordinator's frame can never consume the live broadcast's slot.
    assert protocol.sync_down_key(5, 0) == "5"
    assert protocol.sync_down_key(5, 2) == "5t2"
    assert protocol.sync_down_key(1, 1) != protocol.sync_down_key(1, 2)


# ---------------------------------------------------------------------------
# Term fencing + deterministic election
# ---------------------------------------------------------------------------


def test_stale_sync_rejected_and_higher_term_adopted(monkeypatch):
    _no_kv_store(monkeypatch)
    m = MembershipManager("ha-fence", "carol", _view(["alice", "bob", "carol"]))
    assert m.coordinator() == "alice" and m.term() == 0
    # A term-1 sync proves a failover happened while we were not looking:
    # adopt the term and track the new coordinator.
    m.apply_sync_msg(protocol.make_sync(
        m.view().to_wire(), 1, {}, {}, term=1, coordinator="bob"
    ))
    assert m.term() == 1 and m.coordinator() == "bob"
    assert m.ha_stats()["failovers"] == 1
    # The deposed coordinator's term-0 sync — folded without the
    # failover's evictions — must NOT apply, even when it admits someone.
    forged_view = m.view().with_changes({"mallory": "127.0.0.1:66"}, set())
    forged = protocol.make_sync(
        forged_view.to_wire(), 2, {"mallory": "127.0.0.1:66"}, {},
        term=0, coordinator="alice",
    )
    with pytest.raises(fed.StaleCoordinatorError) as ei:
        m.apply_sync_msg(forged)
    assert ei.value.received_term == 0 and ei.value.current_term == 1
    assert "mallory" not in m.roster()
    assert m.ha_stats()["stale_syncs_rejected"] == 1


def test_failover_election_deterministic():
    jobs = ("ha-elect-b", "ha-elect-c")
    try:
        m_bob = MembershipManager(
            "ha-elect-b", "bob", _view(["alice", "bob", "carol"])
        )
        m_carol = MembershipManager(
            "ha-elect-c", "carol", _view(["alice", "bob", "carol"])
        )
        # Both survivors depose alice independently and elect the SAME
        # successor without a message: sorted(roster - deposed)[0].
        assert m_bob._failover_elect("alice") == "bob"
        assert m_carol._failover_elect("alice") == "bob"
        assert m_bob.is_coordinator() and m_bob.term() == 1
        assert m_bob.ha_stats()["takeovers"] == 1
        assert not m_carol.is_coordinator() and m_carol.term() == 1
        assert m_carol.ha_stats()["takeovers"] == 0
        # Deposing an already-replaced coordinator is a no-op.
        assert m_carol._failover_elect("alice") == "bob"
        assert m_carol.term() == 1
        # The chain continues deterministically when the successor dies.
        assert m_carol._failover_elect("bob") == "carol"
        assert m_carol.is_coordinator() and m_carol.term() == 2
        assert m_carol.ha_stats()["takeovers"] == 1
    finally:
        for job in jobs:
            rendezvous.clear_control_handler(job)
    # Nobody left to elect: a hard error, not a silent hang.
    lone = MembershipManager("ha-elect-x", "bob", _view(["alice"]))
    with pytest.raises(RuntimeError, match="no candidate left"):
        lone._failover_elect("alice")


def test_adopt_term_without_winner_demotes():
    m = MembershipManager("ha-demote", "alice", _view(["alice", "bob", "carol"]))
    assert m.is_coordinator()
    # A higher-term frame that does not name the winner still proves a
    # deposition: the holder demotes and elects from the chain — the
    # identical choice the deposers made.
    m.adopt_term(1, None)
    assert not m.is_coordinator()
    assert m.coordinator() == "bob" and m.term() == 1


def test_deposed_coordinator_refuses_requests_naming_successor():
    m = MembershipManager("ha-refuse", "alice", _view(["alice", "bob"]))
    coord = m.get_coordinator_state()
    code, msg = coord.handle_control(
        {"up": protocol.LEAVE_REQ_SEQ, "src": "bob"},
        protocol.make_leave_request("bob", "n1", term=2),
    )
    assert code == CODE_FORBIDDEN and "bob" in msg
    assert m.term() == 2 and not m.is_coordinator()


def test_member_sync_fails_over_and_takes_over(monkeypatch):
    """The whole member-side failover path: the sync wait slices at
    ``takeover_timeout_s``, a DEAD verdict deposes the coordinator, the
    deterministic successor (us) promotes and re-folds the sync under
    the new term at the term-qualified key."""
    from rayfed_tpu_torch.resilience import liveness

    _no_kv_store(monkeypatch)
    recvs, sends = [], []

    def fake_recv(self_party, src, up, down):
        recvs.append((src, up, down))
        return Future()  # never lands — the coordinator is dead

    monkeypatch.setattr(barriers, "recv", fake_recv)
    monkeypatch.setattr(
        barriers, "send",
        lambda dest, data, up, down: sends.append((dest, data, up, down)),
    )
    monkeypatch.setattr(
        liveness, "party_state",
        lambda p: liveness.DEAD if p == "alice" else liveness.ALIVE,
    )
    cfg = MembershipConfig(
        coordinator="alice",
        failover=FailoverConfig(takeover_timeout_s=0.05),
    )
    m = MembershipManager(
        "ha-takeover", "bob", _view(["alice", "bob", "carol"]), cfg
    )
    try:
        view = m.membership_sync(timeout=5.0)
    finally:
        rendezvous.clear_control_handler("ha-takeover")
    # We first parked on alice's term-0 broadcast for sync 1...
    assert recvs[0] == ("alice", protocol.SYNC_SEQ, "1")
    # ...then took over: term 1, the takeover bump evicts alice.
    assert m.is_coordinator() and m.term() == 1
    assert m.ha_stats() == {
        "failovers": 1, "takeovers": 1, "stale_syncs_rejected": 0,
    }
    assert view.epoch == 1 and view.roster == ("bob", "carol")
    # The fold went out to the one other survivor at the term-qualified
    # key, stamped with the new term and coordinator.
    (dest, msg, up, down), = sends
    assert (dest, up, down) == ("carol", protocol.SYNC_SEQ, "1t1")
    assert msg["term"] == 1 and msg["coordinator"] == "bob"
    assert "alice" in msg["evicted"]
    # The telemetry mirror followed the promotion.
    gauge = telemetry_metrics.get_registry().get(
        "fed_membership_coordinator_term"
    )
    assert gauge.value() == 1


def test_takeover_rebroadcasts_recent_views_under_new_term(monkeypatch):
    _no_kv_store(monkeypatch)
    m = MembershipManager(
        "ha-resync", "bob", _view(["alice", "bob", "carol"]),
        MembershipConfig(coordinator="alice"),
    )
    msg1 = protocol.make_sync(
        m.view().to_wire(), 1, {}, {}, term=0, coordinator="alice"
    )
    with m._lock:
        m._record_sync_locked(1, msg1)
    sends = []
    monkeypatch.setattr(
        barriers, "send",
        lambda dest, data, up, down: sends.append((dest, data, up, down)),
    )
    try:
        m._failover_elect("alice")
        applied = m.get_coordinator_state().run_takeover(2)
    finally:
        rendezvous.clear_control_handler("ha-resync")
    # First the retained sync-1 view goes out VERBATIM (term restamped)
    # at its new-term key — a member whose recv failed is re-waiting
    # sync 1 and must receive the exact view alice agreed there.
    dest, remsg, up, down = sends[0]
    assert (dest, up, down) == ("carol", protocol.SYNC_SEQ, "1t1")
    assert remsg["term"] == 1 and remsg["coordinator"] == "bob"
    assert remsg["view"] == msg1["view"]
    # Then the term-1 fold at sync 2 lands the deposed holder's eviction.
    dest, fold, up, down = sends[1]
    assert (dest, up, down) == ("carol", protocol.SYNC_SEQ, "2t1")
    assert "alice" in fold["evicted"]
    assert applied.epoch == 1 and applied.roster == ("bob", "carol")
    assert len(sends) == 2  # never to self, never to the evicted party


def test_recent_sync_retention_honors_resync_window():
    m = MembershipManager(
        "ha-window", "bob", _view(["alice", "bob"]),
        MembershipConfig(failover=FailoverConfig(resync_window=2)),
    )
    for i in (1, 2, 3):
        with m._lock:
            m._record_sync_locked(
                i, protocol.make_sync(m.view().to_wire(), i, {}, {})
            )
    assert sorted(m.recent_syncs()) == [2, 3]


def test_expired_membership_waiter_key_is_not_tombstoned():
    """A member RE-TAKES the same ``mbr:sync`` key after its recv deadline
    (sync-index rollback; takeover re-broadcast lands on the old key under
    the new term), so an expiry must not tombstone membership keys — the
    late frame has to park and satisfy the re-parked waiter. Data keys keep
    the tombstone: their seq ids are monotonic and never re-taken."""
    store = rendezvous.RendezvousStore(
        "job", lambda header, payload: payload, recv_timeout_s=0.3
    )
    try:
        hdr = {"job": "job", "src": "bob", "up": protocol.SYNC_SEQ}
        mbr = store.take(protocol.SYNC_SEQ, "3t1")
        data = store.take("e0:7", "e0:7")
        with pytest.raises((TimeoutError, Exception)):
            mbr.result(timeout=5)
        with pytest.raises((TimeoutError, Exception)):
            data.result(timeout=5)
        # Late frame on the EXPIRED membership key: parks, and the
        # re-parked waiter gets it.
        assert store.offer({**hdr, "down": "3t1"}, b"view")[1] == "ok"
        assert store.take(protocol.SYNC_SEQ, "3t1").result(timeout=1) == b"view"
        # Late frame on the expired DATA key: acked-and-dropped.
        code, msg = store.offer(
            {"job": "job", "src": "bob", "up": "e0:7", "down": "e0:7"}, b"x"
        )
        assert msg == "duplicate"
    finally:
        store.shutdown()


# ---------------------------------------------------------------------------
# Aggregator handoff + serving-bank handoff
# ---------------------------------------------------------------------------


def test_aggregator_export_adopt_continues_bitwise():
    a = ar.BufferedAggregator(
        AsyncAggregationConfig(buffer_k=4, staleness="constant"),
        session="ha-src",
    )
    g = torch.Generator().manual_seed(3)
    trees = {p: {"g": torch.randn(16, generator=g)}
             for p in ("alice", "bob", "carol", "dave")}
    a.offer("alice", trees["alice"], round_tag=0)
    a.offer("bob", trees["bob"], round_tag=1)
    state = a.export_state()
    b = ar.BufferedAggregator(
        AsyncAggregationConfig(buffer_k=4, staleness="constant"),
        session="ha-dst",
    )
    stats = b.adopt_state(state)
    assert stats["handoffs"] == 1 and stats["buffered"] == 2
    assert stats["latest_round_tag"] == 1
    # Same further arrivals in the same order on BOTH: the successor's
    # fold is bitwise identical to the uninterrupted predecessor's.
    for agg in (a, b):
        agg.offer("carol", trees["carol"], round_tag=1)
        agg.offer("dave", trees["dave"], round_tag=1)
    assert a.version == b.version == 1
    wa = a.current()["params"]["g"]
    wb = b.current()["params"]["g"]
    assert np.asarray(wa).tobytes() == np.asarray(wb).tobytes()


def test_model_bank_export_restore_continues_versions():
    from rayfed_tpu_torch.serving.publish import ModelBank

    a = ModelBank(device="cpu")
    a.publish({"w": torch.ones(4)})
    a.publish({"w": torch.full((4,), 2.0)})
    state = a.export_state()
    b = ModelBank(device="cpu")
    assert b.restore_state(state) == 2
    assert b.current_version() == 2
    np.testing.assert_array_equal(
        np.asarray(b.get(2)["w"]), np.full(4, 2.0, np.float32)
    )
    # Version numbering CONTINUES across the handoff...
    assert b.publish({"w": torch.zeros(4)}) == 3
    # ...and a stale re-restore is a no-op.
    assert b.restore_state(state) == 3
    # An unpublished bank exports a version-0 snapshot that no-ops.
    empty = ModelBank(device="cpu")
    assert ModelBank(device="cpu").restore_state(empty.export_state()) == 0


# ---------------------------------------------------------------------------
# Job checkpoint cut
# ---------------------------------------------------------------------------


def test_membership_snapshot_roundtrip(monkeypatch):
    _no_kv_store(monkeypatch)
    m = MembershipManager("ha-snap", "carol", _view(["alice", "bob", "carol"]))
    new_view = m.view().with_changes({"dave": "127.0.0.1:77"}, set())
    m.apply_sync_msg(protocol.make_sync(
        new_view.to_wire(), 4, {"dave": "127.0.0.1:77"}, {},
        term=1, coordinator="bob",
    ))
    with m._lock:
        m._sync_index = 4
    snap = m.export_snapshot()
    m2 = MembershipManager(
        "ha-snap2", "carol", _view(["alice", "bob", "carol"])
    )
    m2.restore_snapshot(snap)
    assert m2.sync_index() == 4 and m2.term() == 1
    assert m2.current_epoch() == 1
    assert m2.coordinator() == "bob"
    assert "dave" in m2.roster()
    assert m2.ghost_tables() == m.ghost_tables()
    # Restoring a cut that elected US re-promotes (and re-installs the
    # control handler) so the role survives the restart.
    m3 = MembershipManager(
        "ha-snap3", "bob", _view(["alice", "bob", "carol"])
    )
    try:
        m3.restore_snapshot(snap)
        assert m3.is_coordinator() and m3.term() == 1
    finally:
        m3.uninstall()


def test_job_checkpoint_cut_roundtrip(tmp_path):
    cfg = AsyncAggregationConfig(buffer_k=4, staleness="constant")
    g = torch.Generator().manual_seed(11)
    trees = {p: {"g": torch.randn(8, generator=g)}
             for p in ("alice", "bob", "carol", "dave")}
    model = {"w": torch.arange(8, dtype=torch.float32)}
    opt_state = {"m": torch.full((8,), 0.5), "v": torch.full((8,), 0.25)}
    try:
        ar.reset_sessions()
        agg = ar._get_or_create_session("hacut", cfg.as_dict(), None)
        # A MID-BUFFER cut: two contributions folded in, two short of K.
        agg.offer("alice", trees["alice"], round_tag=0)
        agg.offer("bob", trees["bob"], round_tag=1)
        with ar._tags_lock:
            ar._driver_round_tags.get()["hacut"] = 7
        path = fed.save_job_state(
            str(tmp_path), step=7, model=model, opt_state=opt_state
        )
        assert os.path.isdir(path)
        # Control run: the uninterrupted aggregator finishes the buffer.
        for p in ("carol", "dave"):
            agg.offer(p, trees[p], round_tag=1)
        control_w = np.asarray(agg.current()["params"]["g"])

        ar.reset_sessions()  # the restart: all in-memory state gone
        st = fed.restore_job_state(str(tmp_path))
        assert st["step"] == 7
        np.testing.assert_array_equal(np.asarray(st["model"]["w"]), model["w"])
        np.testing.assert_array_equal(
            np.asarray(st["opt_state"]["m"]), opt_state["m"]
        )
        restored = ar.get_session("hacut")
        assert restored is not None
        stats = restored.snapshot_stats()
        assert stats["buffered"] == 2 and stats["handoffs"] == 1
        # The driver-side round-tag counter resumes where it left off.
        assert ar._next_round_tag("hacut") == 7
        # The restored buffer finishes the SAME fold bitwise.
        for p in ("carol", "dave"):
            restored.offer(p, trees[p], round_tag=1)
        assert restored.version == 1
        got_w = np.asarray(restored.current()["params"]["g"])
        assert got_w.tobytes() == control_w.tobytes()
    finally:
        ar.reset_sessions()
        checkpoint.reset_default_checkpoint_config()


def test_job_checkpoint_prunes_and_requires_base_dir(tmp_path):
    try:
        ar.reset_sessions()
        checkpoint.set_default_checkpoint_config(
            {"base_dir": str(tmp_path), "keep": 2}
        )
        for step in (1, 2, 3):
            fed.save_job_state(step=step)
        kept = sorted(p for p in os.listdir(tmp_path) if p.startswith("step_"))
        assert kept == ["step_2", "step_3"]
        assert fed.restore_job_state()["step"] == 3
        checkpoint.reset_default_checkpoint_config()
        with pytest.raises(ValueError, match="no checkpoint directory"):
            fed.save_job_state(step=4)
    finally:
        ar.reset_sessions()
        checkpoint.reset_default_checkpoint_config()


def test_membership_stats_empty_without_plane():
    assert fed.membership_stats() == {}


def test_shutdown_drain_helpers():
    m = MembershipManager("ha-drain", "bob", _view(["alice", "bob"]))
    assert m.drain_takeover(0.1)
    with m._lock:
        m._inflight += 1
    assert not m.drain_takeover(0.05)
    with m._lock:
        m._inflight -= 1
        m._drain_cond.notify_all()
    assert m.drain_takeover(0.1)
    assert ar.drain_handoffs(0.1)
    ar._handoff_begin()
    assert not ar.drain_handoffs(0.05)
    ar._handoff_end()
    assert ar.drain_handoffs(0.1)


# ===========================================================================
# Chaos spawn runs (slow)
# ===========================================================================

# Slower than the JAX package's test timings (100 ms beats, DEAD after 4
# misses), which run apart as slow tests: these run with the suite on a
# loaded host, where a late heartbeat must not evict a live party. A
# crashed party is still DEAD within about 3 s.
_LIVENESS = {
    "interval_ms": 250, "suspect_after": 4, "dead_after": 12,
    "timeout_ms": 1000,
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


# ---------------------------------------------------------------------------
# 1) Kill the coordinator mid-round
# ---------------------------------------------------------------------------

FO_PARTIES = ["alice", "bob", "carol"]
FO_ROUNDS = 8
FO_BASES = {"alice": 1.0, "bob": 2.0, "carol": 3.0}
# alice (the coordinator) makes 4 data sends per healthy round: the sync
# broadcast to bob then carol, then its update push to each consumer.
# after=9 lets rounds 0-1 complete (8 sends) and kills alice MID round
# 2's sync broadcast: bob receives sync 3, carol never does — exactly
# the asymmetry the takeover re-broadcast exists for.
FO_CRASH_AFTER = 9


@fed.remote
def _fo_update(base, r):
    return {"w": torch.full((4,), base * (r + 1), dtype=torch.float32)}


def _fo_expected_mean(contributors, r):
    total = np.float32(sum(FO_BASES[p] * (r + 1) for p in contributors))
    return float(total / np.float32(len(contributors)))


def _fo_rounds(party, records):
    from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean
    from rayfed_tpu_torch.resilience.liveness import DEAD

    for r in range(FO_ROUNDS):
        view = fed.membership_sync(timeout=30.0)
        roster = sorted(view.roster)
        objs = {p: _fo_update.party(p).remote(FO_BASES[p], r)
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
        records.append({
            "round": r,
            "epoch": view.epoch,
            "roster": roster,
            "contributors": contributors,
            "agg": float(np.asarray(agg["w"])[0]),
            "term": fed.membership_stats().get("term", 0),
        })
        time.sleep(0.2)


def _run_failover_party(party, addresses, workdir):
    records = []
    config = {
        "barrier_on_initializing": True,
        "cross_silo_comm": _fast_comm(
            {"exit_on_sending_failure": True} if party == "alice" else None
        ),
        "resilience": {"liveness": dict(_LIVENESS)},
        "membership": {
            "coordinator": "alice",
            "evict_dead": True,
            "sync_timeout_s": 30.0,
            "failover": {"takeover_timeout_s": 0.5, "resync_window": 4},
        },
    }
    if party == "alice":
        config["resilience"]["fault_schedule"] = {
            "seed": 13,
            "rules": [{"fault": "crash", "src": "alice",
                       "after": FO_CRASH_AFTER}],
        }
    fed.init(
        addresses=addresses,
        party=party,
        config=config,
        sending_failure_handler=(
            (lambda e: os._exit(0)) if party == "alice" else None
        ),
    )
    try:
        _fo_rounds(party, records)
    except BaseException:
        if party == "alice" and records and records[-1]["round"] >= 1:
            # Expected death throes past the crash point.
            os._exit(0)
        raise
    if party == "alice":
        raise AssertionError("alice survived its own crash schedule")
    # Survivors: the role moved to the deterministic successor.
    from rayfed_tpu_torch.membership.manager import get_membership_manager

    mgr = get_membership_manager()
    assert mgr.coordinator() == "bob"
    stats = fed.membership_stats()
    assert stats["term"] >= 1 and stats["failovers"] >= 1
    if party == "bob":
        assert stats["takeovers"] >= 1
    # The deposed coordinator's stale term-0 sync is PROVABLY rejected.
    forged = protocol.make_sync(
        mgr.view().to_wire(), mgr.sync_index() + 1, {}, {},
        term=0, coordinator="alice",
    )
    before = stats["stale_syncs_rejected"]
    stale_rejected = False
    try:
        mgr.apply_sync_msg(forged)
    except fed.StaleCoordinatorError:
        stale_rejected = (
            fed.membership_stats()["stale_syncs_rejected"] == before + 1
        )
    with open(os.path.join(workdir, f"{party}.json"), "w") as f:
        json.dump({
            "records": records,
            "stats": fed.membership_stats(),
            "stale_rejected": stale_rejected,
        }, f, sort_keys=True)
    fed.shutdown()


def test_torch_coordinator_failover_mid_round(tmp_path):
    """kill the coordinator mid sync broadcast. Every
    survivor finishes all rounds (rounds_lost == 0), bob takes over at a
    bumped term, the trailing member converges through the takeover
    re-broadcast, and a stale-term sync from the deposed coordinator is
    provably rejected on every survivor."""
    run_parties(
        _run_failover_party, FO_PARTIES, timeout=200,
        extra_args=(str(tmp_path),),
        addresses=get_addresses(FO_PARTIES),
    )
    bob = json.loads((tmp_path / "bob.json").read_text())
    carol = json.loads((tmp_path / "carol.json").read_text())
    for doc in (bob, carol):
        recs = doc["records"]
        assert [rec["round"] for rec in recs] == list(range(FO_ROUNDS))
        rounds_lost = sum(1 for rec in recs if not rec["contributors"])
        assert rounds_lost == 0
        # alice led and contributed before the crash, and is evicted —
        # gone from the roster, not merely MISSING — by the end.
        assert "alice" in recs[0]["roster"]
        assert "alice" in recs[0]["contributors"]
        assert "alice" not in recs[-1]["roster"]
        assert recs[-1]["epoch"] >= 1
        # Terms only move forward, and the failover bumped them.
        terms = [rec["term"] for rec in recs]
        assert terms == sorted(terms) and terms[-1] >= 1
        assert doc["stats"]["failovers"] >= 1
        assert doc["stale_rejected"] is True
        # Aggregate correctness every round, including the degraded
        # rounds between the crash and the takeover bump.
        for rec in recs:
            assert rec["agg"] == _fo_expected_mean(
                rec["contributors"], rec["round"]
            )
    assert bob["stats"]["takeovers"] >= 1
    assert carol["stats"]["takeovers"] == 0
    # Both survivors agree on the roster at every round — the takeover
    # re-broadcast kept every sync index mapped to one view fleet-wide.
    assert [rec["roster"] for rec in bob["records"]] == \
        [rec["roster"] for rec in carol["records"]]


# ---------------------------------------------------------------------------
# 2) Kill the async aggregation root mid-buffer
# ---------------------------------------------------------------------------

ARB_PARTIES = ["alice", "bob", "carol"]
ARB_BASES = {"alice": 3.0, "bob": 6.0, "carol": 9.0}
ARB_SESSION = "harb"
# The root's data sends are the offer statuses it pushes back to the
# other two drivers (up to 6 per round). after=8 guarantees alice dies
# inside round 1 or 2 with contributions still buffered.
ARB_CRASH_AFTER = 8


@fed.remote
def _arb_contrib(base, r):
    return {"g": torch.full((8,), base * (r + 1), dtype=torch.float32)}


def _arb_round(r, root):
    objs = {p: _arb_contrib.party(p).remote(ARB_BASES[p], r)
            for p in (ARB_PARTIES if root == "alice" else ["bob", "carol"])}
    h = fed.async_round(
        objs, round_tag=r, root=root, session=ARB_SESSION,
        fetch_model=False,
    )
    fed.get(list(h.offers.values()), timeout=3.0, on_missing="default")


def _run_arb_party(party, addresses, workdir):
    from rayfed_tpu_torch.async_rounds import _async_current, async_session_stats
    from rayfed_tpu_torch.async_rounds import get_default_async_config
    from rayfed_tpu_torch.resilience.liveness import DEAD

    config = {
        "barrier_on_initializing": True,
        "cross_silo_comm": _fast_comm(
            {"exit_on_sending_failure": True} if party == "alice" else None
        ),
        "resilience": {"liveness": dict(_LIVENESS)},
        "aggregation": {"async_buffer_k": 2, "async_staleness": "constant"},
    }
    if party == "alice":
        config["resilience"]["fault_schedule"] = {
            "seed": 29,
            "rules": [{"fault": "crash", "src": "alice",
                       "after": ARB_CRASH_AFTER}],
        }
    fed.init(
        addresses=addresses,
        party=party,
        config=config,
        sending_failure_handler=(
            (lambda e: os._exit(0)) if party == "alice" else None
        ),
    )
    try:
        for r in range(3):
            _arb_round(r, "alice")
    except BaseException:
        if party == "alice":
            os._exit(0)
        raise
    if party == "alice":
        # The injector kills alice from a status-push thread; wait for it.
        time.sleep(60)
        raise AssertionError("alice survived its own crash schedule")
    # Survivors: wait for the DEAD verdict, then every driver makes the
    # IDENTICAL rebuild call — the successor refolds the survivors' last
    # round from their re-offers (the root died WITH its buffer).
    deadline = time.monotonic() + 30
    while fed.party_state("alice") != DEAD:
        assert time.monotonic() < deadline, "no DEAD verdict for alice"
        time.sleep(0.05)
    h = fed.async_rebuild("bob", ARB_SESSION, parties=["bob", "carol"])
    fed.get(list(h.offers.values()), timeout=10.0)
    deadline = time.monotonic() + 30
    while True:
        stats = fed.get(async_session_stats("bob", ARB_SESSION))
        if stats["publishes"] >= 1:
            break
        assert time.monotonic() < deadline, stats
        time.sleep(0.05)
    # Round 3 continues at the successor over the surviving roster.
    _arb_round(3, "bob")
    deadline = time.monotonic() + 30
    while True:
        stats = fed.get(async_session_stats("bob", ARB_SESSION))
        if stats["publishes"] >= 2:
            break
        assert time.monotonic() < deadline, stats
        time.sleep(0.05)
    cfg_dict = get_default_async_config().as_dict()
    model = fed.get(
        _async_current.party("bob").remote(ARB_SESSION, cfg_dict, None)
    )
    with open(os.path.join(workdir, f"{party}.json"), "w") as f:
        json.dump({
            "stats": {k: stats[k] for k in
                      ("accepted", "publishes", "version", "handoffs")},
            "version": model["version"],
            "g0": float(np.asarray(model["params"]["g"])[0]),
        }, f, sort_keys=True)
    fed.shutdown()


def test_torch_async_root_killed_rebuild_publishes(tmp_path):
    """the async aggregation root dies mid-buffer; the
    deterministic successor rebuilds the session from survivor re-offers
    and publishes — the round DEGRADES to the survivor set instead of
    disappearing with the root."""
    run_parties(
        _run_arb_party, ARB_PARTIES, timeout=200,
        extra_args=(str(tmp_path),),
        addresses=get_addresses(ARB_PARTIES),
    )
    for party in ("bob", "carol"):
        doc = json.loads((tmp_path / f"{party}.json").read_text())
        assert doc["stats"]["publishes"] >= 2
        assert doc["version"] >= 2
        # The last published fold is round 3 over the survivors:
        # mean(bob 6*4, carol 9*4) = 30 exactly (float32 integers).
        assert doc["g0"] == 30.0


# ---------------------------------------------------------------------------
# 3) Restart from a job checkpoint, continue bitwise
# ---------------------------------------------------------------------------

CKPT_PARTIES = ["alice", "bob", "carol"]
CKPT_SESSION = "hackpt"
CKPT_CUT = 3     # checkpoint after rounds 0..2
CKPT_TOTAL = 5   # then rounds 3..4, in both runs


@fed.remote
def _ckpt_contrib(p, r):
    rng = np.random.default_rng(1000 * r + sum(map(ord, p)))
    return {"g": torch.from_numpy(
        rng.integers(-400, 400, (16,)).astype(np.float32))}


def _ckpt_config(party, base_dir):
    return {
        "barrier_on_initializing": True,
        # No party dies in this test, so the aggressive failover-test
        # recv deadline would only inject flakes: a checkpoint restore
        # skews parties by seconds, and an internal task-argument
        # rendezvous must ride that out.
        "cross_silo_comm": _fast_comm({"recv_timeout_in_ms": 60000}),
        # No liveness monitor: no party dies here (the JAX package's secure
        # version needs it for dropout recovery), and a heartbeat late
        # under load would drop a live party's offer as DEAD.
        # Plaintext: one version per round of all three offers, whose
        # integer-valued sum is exact in float32, so the fold's bits do
        # not depend on the order the three arrive in.
        "aggregation": {"async_staleness": "constant", "async_buffer_k": 3},
        "checkpoint": {"base_dir": base_dir, "keep": 2},
    }


def _ckpt_round(records):
    """One async round with the AUTO round tag (exercises the restored
    driver-side counter); every party drains its offers and alice
    records the published model."""
    from rayfed_tpu_torch.async_rounds import (
        _async_current,
        async_session_stats,
        get_default_async_config,
    )

    objs = {p: _ckpt_contrib.party(p).remote(p, _ckpt_round.counter)
            for p in CKPT_PARTIES}
    h = fed.async_round(
        objs, root="alice", session=CKPT_SESSION, fetch_model=False,
    )
    _ckpt_round.counter += 1
    fed.get(list(h.offers.values()), timeout=30.0)
    target = _ckpt_round.counter
    deadline = time.monotonic() + 60
    while True:
        stats = fed.get(async_session_stats("alice", CKPT_SESSION))
        if stats["publishes"] >= target:
            break
        assert time.monotonic() < deadline, stats
        time.sleep(0.02)
    cfg_dict = get_default_async_config().as_dict()
    model = fed.get(
        _async_current.party("alice").remote(CKPT_SESSION, cfg_dict, None)
    )
    records.append({
        "version": model["version"],
        "w": np.asarray(model["params"]["g"]).tolist(),
    })


def _run_ckpt_party(party, addresses, workdir, phase):
    base_dir = os.path.join(workdir, f"ckpt_{party}")
    fed.init(
        addresses=addresses, party=party,
        config=_ckpt_config(party, base_dir),
    )
    model = {"w": torch.full((8,), 3.0)}
    opt_state = {"m": torch.arange(8, dtype=torch.float32)}
    records = []
    if phase == "first":
        _ckpt_round.counter = 0
        for _ in range(CKPT_CUT):
            _ckpt_round(records)
        # The consistent cut: every party is at the same round boundary
        # with nothing in flight (offers drained, publishes confirmed).
        fed.save_job_state(step=CKPT_CUT, model=model, opt_state=opt_state)
        run_key = "run1"
    else:
        st = fed.restore_job_state()
        assert st["step"] == CKPT_CUT
        np.testing.assert_array_equal(
            np.asarray(st["model"]["w"]), model["w"]
        )
        np.testing.assert_array_equal(
            np.asarray(st["opt_state"]["m"]), opt_state["m"]
        )
        _ckpt_round.counter = CKPT_CUT
        run_key = "run2"
    for _ in range(CKPT_CUT, CKPT_TOTAL):
        _ckpt_round(records)
    if party == "alice":
        with open(os.path.join(workdir, f"{run_key}.json"), "w") as f:
            json.dump(records[-(CKPT_TOTAL - CKPT_CUT):], f, sort_keys=True)
    fed.shutdown()


def test_torch_job_checkpoint_restart_bitwise(tmp_path):
    """A 3-party plaintext async job checkpoints a consistent cut at
    round 3 of 5, restarts from it, and the continued rounds publish
    aggregates BITWISE identical to the uninterrupted run (JSON float
    round-trip is exact for float32-derived doubles)."""
    run_parties(
        _run_ckpt_party, CKPT_PARTIES, timeout=220,
        extra_args=(str(tmp_path), "first"),
        addresses=get_addresses(CKPT_PARTIES),
    )
    run_parties(
        _run_ckpt_party, CKPT_PARTIES, timeout=220,
        extra_args=(str(tmp_path), "resume"),
        addresses=get_addresses(CKPT_PARTIES),
    )
    run1 = json.loads((tmp_path / "run1.json").read_text())
    run2 = json.loads((tmp_path / "run2.json").read_text())
    assert len(run1) == len(run2) == CKPT_TOTAL - CKPT_CUT
    for a, b in zip(run1, run2):
        assert a["version"] == b["version"]
        assert a["w"] == b["w"]  # bitwise: exact float equality
