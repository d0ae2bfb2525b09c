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

"""The port's WAN-grade self-healing transport on torch trees, mirroring
``test_wan.py`` with the same assertions.

Unit layer: netem-style link emulation (LinkProfile shaping), per-peer
LinkHealth estimation and the adaptive deadlines derived from it, FTP1
frame crc compute/verify, the retry engine's final-fit deadline clamp,
shm in-flight reclamation on peer death, lane re-promotion hysteresis,
and the rendezvous duplicate-offer instrument.

System layer: a 2-party delay-fault × ack-timeout run (duplicates stay
bounded via the rendezvous done-ring) and the acceptance chaos run — a
3-party FedAvg over an emulated 50ms/±20ms/1%-loss/100Mbit link with a
mid-job corrupt burst, frame crc on, and a forced shm demotion; every
round must complete bitwise-identical to a clean-link run, with zero
DEAD false positives, at least one crc-triggered retransmit, and the
demoted lane verifiably re-promoted.
"""

import json
import os
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import sanitize
from rayfed_tpu_torch.proxy import lanes
from rayfed_tpu_torch.proxy.rendezvous import RendezvousStore
from rayfed_tpu_torch.proxy.tcp import checksum
from rayfed_tpu_torch.resilience import linkhealth
from rayfed_tpu_torch.resilience.inject import (
    FaultSchedule,
    InjectingSenderProxy,
    LinkProfile,
    corrupt_wire_buffers,
    register_wire_taint,
    reset_wire_taints,
    take_wire_taint,
)
from rayfed_tpu_torch.resilience.retry import Deadline, RetryPolicy, run_with_retry
from tests.utils import get_addresses, run_parties


@pytest.fixture(autouse=True)
def _fresh_health():
    linkhealth.reset_health()
    yield
    linkhealth.reset_health()


# ---------------------------------------------------------------------------
# LinkProfile: validation, deterministic shaping, composition
# ---------------------------------------------------------------------------


def test_link_profile_validates_keys_and_ranges():
    with pytest.raises(ValueError, match="unknown link-profile key"):
        LinkProfile.from_dict({"latency": 50})  # typo'd key must be loud
    with pytest.raises(ValueError, match="loss"):
        LinkProfile.from_dict({"loss": 1.5})
    with pytest.raises(ValueError, match="rate_mbit"):
        LinkProfile.from_dict({"rate_mbit": 0})
    lp = LinkProfile.from_dict(
        {"latency_ms": 50, "jitter_ms": 20, "rate_mbit": 100, "loss": 0.01}
    )
    assert lp.pings  # shaping hits pings by default: latency is the link's


class _NullSender:
    def __init__(self):
        self.sent = []

    def send(self, dest, data, up, down, is_error=False):
        self.sent.append((dest, up, down))
        out = Future()
        out.set_result(True)
        return out

    def get_stats(self):
        return {}


def _injector(links, seed=7, rules=()):
    sched = FaultSchedule.from_dict(
        {"seed": seed, "rules": list(rules), "links": links}
    )
    return InjectingSenderProxy(_NullSender(), sched, "alice")


def test_link_shaping_is_deterministic_and_composes():
    links = [
        {"latency_ms": 40, "jitter_ms": 10},
        {"latency_ms": 20},  # second pipe in series
    ]
    inj = _injector(links)
    d1 = inj._shape_delay("bob", 3, 4, False, 0, 1024)
    d2 = inj._shape_delay("bob", 3, 4, False, 0, 1024)
    assert d1 == d2  # same frame key, same seed -> same delay
    # Both profiles contribute: total is at least the sum of the fixed
    # latencies minus the worst-case jitter, and jitter stays bounded.
    assert 0.050 <= d1 <= 0.070
    # A different frame key draws different jitter but stays in range.
    d3 = inj._shape_delay("bob", 3, 5, False, 0, 1024)
    assert 0.050 <= d3 <= 0.070
    # A fresh injector with the same seed replays the exact same delay.
    d4 = _injector(links, seed=7)._shape_delay("bob", 3, 4, False, 0, 1024)
    assert d4 == d1
    # Shaping is timing-only: nothing lands in the fault trace.
    assert inj.fault_trace() == []
    stats = inj.link_stats()
    assert stats["latency"] >= 2  # both profiles counted per call


def test_link_loss_is_rto_delay_never_a_drop():
    # loss=1.0 -> every frame "needs a retransmit": delay grows by
    # max(3*latency, 200ms) but the frame still forwards.
    inj = _injector([{"latency_ms": 50, "loss": 1.0}])
    d = inj._shape_delay("bob", 1, 1, False, 0, 512)
    assert d >= 0.050 + 0.200
    fut = inj.send("bob", {"x": torch.zeros(4, dtype=torch.float32)}, 1, 1)
    assert fut.result(timeout=5.0) is True  # forwarded, not destroyed
    assert inj.inner.sent == [("bob", 1, 1)]
    assert inj.link_stats()["loss"] >= 1


def test_link_token_bucket_paces_by_payload_size():
    # 1 Mbit/s: a 12.5 KB frame occupies the pipe for ~100ms; a second
    # frame queued immediately behind it waits for the pipe to drain.
    inj = _injector([{"rate_mbit": 1}])
    nbytes = 12500
    d1 = inj._shape_delay("bob", 1, 1, False, 0, nbytes)
    d2 = inj._shape_delay("bob", 1, 2, False, 0, nbytes)
    assert d1 >= 0.099
    assert d2 >= d1 + 0.099  # queued behind the first frame
    assert inj.link_stats()["paced_bytes"] == 2 * nbytes


def test_wire_taint_pops_once_and_flips_one_bit():
    reset_wire_taints()
    try:
        register_wire_taint("bob", 5, 6, seed=42)
        taint = take_wire_taint("bob", 5, 6)
        assert taint == 42
        # Popped: the retransmit path sees no taint -> sends clean.
        assert take_wire_taint("bob", 5, 6) is None
        clean = [b"hello", b"world!!"]
        dirty = corrupt_wire_buffers(clean, "bob", 5, 6, taint)
        joined_c = b"".join(bytes(b) for b in clean)
        joined_d = b"".join(bytes(b) for b in dirty)
        assert joined_c != joined_d
        diff = [
            i for i, (a, b) in enumerate(zip(joined_c, joined_d)) if a != b
        ]
        assert len(diff) == 1
        assert bin(joined_c[diff[0]] ^ joined_d[diff[0]]).count("1") == 1
        # Deterministic: same key + seed flips the same bit.
        again = corrupt_wire_buffers(clean, "bob", 5, 6, 42)
        assert b"".join(bytes(b) for b in again) == joined_d
        # Originals untouched (the lane's stored resend buffers).
        assert clean == [b"hello", b"world!!"]
    finally:
        reset_wire_taints()


# ---------------------------------------------------------------------------
# Frame crc: compute/verify and its three-valued verdict
# ---------------------------------------------------------------------------


def test_checksum_roundtrip_and_mismatch():
    bufs = [b"abc", os.urandom(1000)]
    crc, alg = checksum.compute(bufs)
    header = {"crc": crc, "crca": alg}
    assert checksum.verify(header, b"".join(bufs)) is True
    flipped = bytearray(b"".join(bufs))
    flipped[17] ^= 0x20
    assert checksum.verify(header, bytes(flipped)) is False


def test_checksum_verifies_a_segmented_payload():
    """A received frame of 1 MiB or more arrives as a SegmentedPayload
    (scatter reads); its crc is checked over the segments in order (the
    JAX package's check raises TypeError on one)."""
    from rayfed_tpu_torch._private.serialization import SegmentedPayload

    bufs = [os.urandom(4096), os.urandom(1 << 20), os.urandom(7)]
    crc, alg = checksum.compute(bufs)
    header = {"crc": crc, "crca": alg}
    segs, pos = [], 0
    for b in bufs:
        segs.append((pos, memoryview(bytearray(b))))
        pos += len(b)
    assert checksum.verify(header, SegmentedPayload(segs)) is True
    segs[1][1][12345] ^= 0x01
    assert checksum.verify(header, SegmentedPayload(segs)) is False


@pytest.mark.parametrize("tls", [False, True], ids=["tcp", "tls"])
def test_frame_crc_carries_a_segmented_torch_tree(tmp_path, tls):
    """frame_crc on a push of 4 MiB of torch leaves, plaintext and over
    TLS: the receiver checks the crc over the scatter-read segments and
    the tree arrives bitwise."""
    import sys

    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import (
        TcpReceiverProxy,
        TcpSenderProxy,
    )

    tls_cfg = {}
    if tls:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        from tools.generate_tls_certs import generate, tls_config_for

        generate(str(tmp_path), ["alice", "bob"])
        tls_cfg = {p: tls_config_for(str(tmp_path), p)
                   for p in ("alice", "bob")}
    cfg = {"retry_policy": {"max_attempts": 3, "initial_backoff_ms": 100},
           "frame_crc": True}
    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", tls_cfg.get("bob"),
                          dict(cfg))
    rp.start()
    assert rp.is_ready()[0]
    sp = TcpSenderProxy(addr, "alice", "job", tls_cfg.get("alice"), dict(cfg))
    sp.start()
    try:
        tree = {"w": torch.arange(1 << 20, dtype=torch.float32),
                "b": torch.ones(3, dtype=torch.bfloat16)}
        fut = rp.get_data("alice", "1#0", 2)
        assert sp.send("bob", tree, "1#0", 2).result(timeout=60)
        got = fut.result(timeout=60)
        assert torch.equal(got["w"], tree["w"])
        assert torch.equal(got["b"], tree["b"])
        assert rp.get_stats().get("frame_crc_failures", 0) == 0
    finally:
        sp.stop()
        rp.stop()


def test_checksum_verdict_is_none_when_unverifiable():
    # No crc in the header: sender didn't stamp (frame_crc off).
    assert checksum.verify({}, b"payload") is None
    # Unknown algorithm id: a future sender variant; never a NACK.
    assert checksum.verify({"crc": 1, "crca": "?"}, b"x") is None


def test_checksum_zlib_fallback_agrees_with_itself():
    bufs = [b"the quick brown fox"]
    crc, alg = checksum.compute(bufs, alg=checksum.ALG_ZLIB)
    assert alg == checksum.ALG_ZLIB
    assert checksum.verify({"crc": crc, "crca": alg}, bufs[0]) is True


def test_crc32c_known_check_value():
    if checksum.preferred_alg() != checksum.ALG_CRC32C:
        pytest.skip("native crc32c not built")
    # The Castagnoli check value for b"123456789" (RFC 3720 appendix).
    crc, alg = checksum.compute([b"123456789"], alg=checksum.ALG_CRC32C)
    assert alg == checksum.ALG_CRC32C
    assert crc == 0xE3069283


# ---------------------------------------------------------------------------
# LinkHealth: RFC 6298 estimators and the adaptive derivations
# ---------------------------------------------------------------------------


def test_linkhealth_first_sample_and_ewma():
    h = linkhealth.LinkHealth()
    h.observe_rtt("bob", 0.100)
    stats = h.get_stats()["bob"]
    assert stats["srtt_ms"] == pytest.approx(100.0)
    assert stats["rttvar_ms"] == pytest.approx(50.0)  # first sample: s/2
    h.observe_rtt("bob", 0.100)  # steady link: rttvar decays
    stats = h.get_stats()["bob"]
    assert stats["srtt_ms"] == pytest.approx(100.0)
    assert stats["rttvar_ms"] == pytest.approx(37.5)  # 50 * (1 - beta)
    assert stats["samples"] == 2.0


def test_linkhealth_loss_ewma_and_decay():
    h = linkhealth.LinkHealth()
    assert h.loss_ratio("bob") == 0.0
    h.observe_loss("bob")
    assert h.loss_ratio("bob") == pytest.approx(linkhealth.LOSS_GAMMA)
    h.observe_rtt("bob", 0.01)  # success decays loss
    assert h.loss_ratio("bob") < linkhealth.LOSS_GAMMA


def test_ack_timeout_clamps_between_floor_and_base():
    h = linkhealth.LinkHealth()
    # No samples: the configured timeout stands untouched.
    assert h.ack_timeout_s("bob", 20.0) == 20.0
    # Fast link: rto = 8*0.001 + 4*0.0005 = 10ms -> clamped up to floor.
    h.observe_rtt("bob", 0.001)
    assert h.ack_timeout_s("bob", 20.0, mult=8.0, floor_s=0.25) == 0.25
    # Slow link: rto exceeds base -> base stays the hard ceiling.
    h2 = linkhealth.LinkHealth()
    h2.observe_rtt("bob", 10.0)
    assert h2.ack_timeout_s("bob", 20.0, mult=8.0, floor_s=0.25) == 20.0
    # In-range rto passes through: 8*0.1 + 4*0.05 = 1.0s.
    h3 = linkhealth.LinkHealth()
    h3.observe_rtt("bob", 0.1)
    assert h3.ack_timeout_s("bob", 20.0, mult=8.0, floor_s=0.25) == (
        pytest.approx(1.0)
    )


def test_recv_slack_only_extends_and_max_covers_worst_peer():
    h = linkhealth.LinkHealth()
    assert h.recv_slack_s("bob") == 0.0  # no samples: never shrinks
    assert h.max_recv_slack_s() == 0.0
    h.observe_rtt("bob", 0.050)
    h.observe_rtt("carol", 0.200)
    # mult*srtt + 4*rttvar with first-sample rttvar = srtt/2.
    assert h.recv_slack_s("bob", mult=8.0) == pytest.approx(0.5)
    assert h.max_recv_slack_s(mult=8.0) == pytest.approx(2.0)  # carol


def test_backoff_ceiling_scales_with_rtt():
    h = linkhealth.LinkHealth()
    assert h.backoff_ceiling_s("bob", 30.0) == 30.0  # no samples
    h.observe_rtt("bob", 0.005)  # 5ms LAN: 16*srtt = 80ms, floor 50ms
    assert h.backoff_ceiling_s("bob", 30.0) == pytest.approx(0.08)
    h2 = linkhealth.LinkHealth()
    h2.observe_rtt("bob", 10.0)  # pathological: policy cap still wins
    assert h2.backoff_ceiling_s("bob", 30.0) == 30.0


# ---------------------------------------------------------------------------
# Retry engine: backoff ceiling + the final-fit deadline clamp
# ---------------------------------------------------------------------------


def test_backoff_ceiling_caps_every_pause(monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    policy = RetryPolicy(
        max_attempts=3, initial_backoff_ms=5000, max_backoff_ms=30000,
        jitter=False,
    )

    def fail(attempt):
        raise OSError("nope")

    with pytest.raises(ConnectionError, match="failed after 3 attempt"):
        run_with_retry(fail, policy, backoff_ceiling_s=0.08)
    assert sleeps == [0.08, 0.08]  # WAN-tuned 5s/10s capped to the link


def test_final_attempt_always_fits_the_deadline():
    """The boundary case: WAN-scale backoff (5s) against a sub-second
    deadline. Without the final-fit clamp the loop sleeps the budget
    away and the last attempt starts exactly as the deadline expires;
    with it, all attempts run and the loop finishes within the budget
    (pauses are shortened to leave one attempt's cost of headroom)."""
    calls = []
    policy = RetryPolicy(
        max_attempts=3, initial_backoff_ms=5000, max_backoff_ms=30000,
        jitter=False,
    )

    def fail(attempt):
        calls.append(time.monotonic())
        raise OSError("nope")

    deadline = Deadline(0.4)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="failed after 3 attempt"):
        run_with_retry(fail, policy, deadline=deadline)
    elapsed = time.monotonic() - t0
    assert len(calls) == 3
    assert elapsed < 1.0  # not 5s+5s of uncapped backoff
    # Every attempt STARTED before the budget ran out.
    assert all(t - t0 <= 0.45 for t in calls)


# ---------------------------------------------------------------------------
# FedSanitizer: crc-retransmit-idempotence probe
# ---------------------------------------------------------------------------


def test_probe_crc_retransmit_trips_above_limit():
    sanitize.reset()
    sanitize.enable()
    try:
        key = ("alice", "3", "4")
        sanitize.probe_crc_retransmit(key)  # first failure: chaos taint
        sanitize.probe_crc_retransmit(key)  # second: noisy-link headroom
        with pytest.raises(sanitize.SanitizerError, match="crc-retransmit"):
            sanitize.probe_crc_retransmit(key)
        assert sanitize.trips().get("crc-retransmit-idempotence") == 1
        # Distinct keys have independent budgets.
        sanitize.probe_crc_retransmit(("alice", "9", "9"))
        sanitize.reset()
        sanitize.probe_crc_retransmit(key)  # budget restored after reset
    finally:
        sanitize.disable()
        sanitize.reset()


# ---------------------------------------------------------------------------
# Rendezvous: the duplicate-offer instrument
# ---------------------------------------------------------------------------


def test_rendezvous_counts_done_ring_duplicates():
    store = RendezvousStore("job", lambda h, p: bytes(p))
    try:
        header = {"job": "job", "src": "alice", "up": "1", "down": "2",
                  "pkind": "bytes"}
        fut = store.take("1", "2")
        assert store.offer(dict(header), b"payload") == (200, "ok")
        assert fut.result(timeout=5) == b"payload"
        # An ack-lost resend of the consumed frame: acked, dropped, counted.
        assert store.offer(dict(header), b"payload") == (200, "duplicate")
        assert store.offer(dict(header), b"payload") == (200, "duplicate")
        stats = store.get_stats()
        assert stats["duplicate_offers"] == 2
    finally:
        store.shutdown()


# ---------------------------------------------------------------------------
# Shm: peer-death reclamation + re-promotion hysteresis
# ---------------------------------------------------------------------------


class _ShmCfg:
    shm_ring_mb = 1
    shm_min_bytes = 0
    shm_push_timeout_ms = 20
    shm_repromote_after_ms = 50


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_cancel_peer_inflight_reclaims_undelivered_chunks():
    sender = lanes.ShmSender("job", "alice", "bob", _ShmCfg())
    header = {"pkind": "tree"}
    try:
        blob = b"x" * 100_000
        offs = []
        for _ in range(3):
            assert sender.eligible(header, len(blob))
            got = sender.push([blob], len(blob))
            assert got is not None
            offs.append(got[1])
        # One descriptor was ACKed: that chunk belongs to the receiver.
        sender.on_delivered(offs[0])
        assert sender.outstanding_count() == 2
        assert sender.cancel_peer_inflight() == 2
        assert sender.outstanding_count() == 0
        # The reclaimed space is immediately reusable (no leak): the
        # 1 MB ring absorbs another full wave.
        for _ in range(3):
            assert sender.push([blob], len(blob)) is not None
        assert sender.cancel_peer_inflight() == 3
        # Idempotent once drained.
        assert sender.cancel_peer_inflight() == 0
    finally:
        sender.close()


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_repromotion_probe_gate_and_hysteresis():
    sender = lanes.ShmSender("job", "alice", "bob", _ShmCfg())
    header = {"pkind": "tree"}
    try:
        assert sender.eligible(header, 1000)
        sender.mark_broken()
        assert sender.demotions == 1
        # Hold-off running: the lane stays demoted, no probe yet.
        assert not sender.eligible(header, 1000)
        time.sleep(0.08)  # past the 50ms base hold-off
        # Exactly ONE probe opens; a second concurrent push stays out.
        assert sender.eligible(header, 1000)
        assert sender.probing
        assert not sender.eligible(header, 1000)
        # Probe ACKed: recovered — and the transition is reported once.
        assert sender.mark_recovered() is True
        assert not sender.broken
        assert sender.mark_recovered() is False  # already healthy
        # Hysteresis: the demotion count survives recovery, so the next
        # break backs off twice as long (base * 2^(demotions-1)).
        sender.mark_broken()
        assert sender.demotions == 2
        time.sleep(0.08)  # one base interval: NOT enough the second time
        assert not sender.eligible(header, 1000)
        time.sleep(0.05)
        assert sender.eligible(header, 1000)  # 2x base elapsed: probe opens
    finally:
        sender.close()


def test_sticky_demotion_when_repromotion_disabled():
    class _Sticky(_ShmCfg):
        shm_repromote_after_ms = 0  # sticky demotion, no re-promotion

    sender = lanes.ShmSender("job", "alice", "bob", _Sticky())
    sender.mark_broken()
    time.sleep(0.06)
    assert not sender.eligible({"pkind": "tree"}, 1000)
    sender.close()


def test_forced_attach_fail_counts_down(monkeypatch):
    adopter = lanes.ShmAdopter(lambda h, p: (200, "ok"))
    header = {"pkind": "shm"}
    monkeypatch.setenv("FEDTPU_SHM_FORCE_ATTACH_FAIL", "2")
    code1, _ = adopter.offer(dict(header), b"junk")
    code2, _ = adopter.offer(dict(header), b"junk")
    assert code1 == code2 == 424  # first N adoptions forced to fail
    code3, msg3 = adopter.offer(dict(header), b"junk")
    assert code3 != 424  # budget spent: the gate lifted (junk payload
    assert "descriptor" in msg3  # now fails validation instead)
    # Legacy always-fail spelling still works.
    monkeypatch.setenv("FEDTPU_SHM_FORCE_ATTACH_FAIL", "always")
    for _ in range(3):
        code, _ = adopter.offer(dict(header), b"junk")
        assert code == 424


# ---------------------------------------------------------------------------
# System: delay-fault x ack-timeout — duplicates stay bounded
# ---------------------------------------------------------------------------

DELAY_PARTIES = ("alice", "bob")
DELAY_ROUNDS = 3


@fed.remote
def _delay_update(base, r):
    return {"w": torch.full((64,), base * (r + 1), dtype=torch.float32)}


def run_delay_party(party, addresses, seed):
    fed.init(
        addresses=addresses,
        party=party,
        config={
            "barrier_on_initializing": True,
            "cross_silo_comm": {
                "retry_policy": {
                    "max_attempts": 3,
                    "initial_backoff_ms": 50,
                    "max_backoff_ms": 200,
                },
                "timeout_in_ms": 1500,
                "recv_timeout_in_ms": 8000,
                "send_deadline_in_ms": 10000,
                "adaptive_timeouts": True,
            },
            "resilience": {
                "fault_schedule": {
                    "seed": seed,
                    # A seeded 200ms +/- 100ms link profile,
                    # plus duplicated frames to exercise the done-ring.
                    "links": [{"latency_ms": 200, "jitter_ms": 100}],
                    "rules": [
                        {"fault": "duplicate", "prob": 0.5},
                    ],
                },
            },
        },
    )
    inbound = 0
    for r in range(DELAY_ROUNDS):
        a = _delay_update.party("alice").remote(1.0, r)
        b = _delay_update.party("bob").remote(3.0, r)
        got = fed.get([a, b], timeout=15.0)
        inbound += 1  # one data frame from the peer per round
        expect = {"alice": 1.0 * (r + 1), "bob": 3.0 * (r + 1)}
        for p, v in zip(DELAY_PARTIES, got):
            assert isinstance(v["w"], torch.Tensor), type(v["w"])
            assert np.asarray(v["w"]).tobytes() == np.full(
                (64,), expect[p], np.float32
            ).tobytes(), (party, r, p)
    from rayfed_tpu_torch.proxy import barriers

    stats = barriers.receiver_proxy().get_stats()
    # Bounded duplicates: the done-ring absorbed at most one dedup hit
    # per inbound frame transmission (duplicate fault or ack-timeout
    # resend), never a storm.
    assert stats.get("duplicate_offers", 0) <= 2 * inbound, stats
    fed.shutdown()


def test_delay_fault_with_tight_ack_timeout_bounds_duplicates():
    run_parties(
        run_delay_party,
        list(DELAY_PARTIES),
        timeout=120,
        extra_args=(20260808,),
        addresses=get_addresses(list(DELAY_PARTIES)),
    )


# ---------------------------------------------------------------------------
# Acceptance: 3-party FedAvg over an emulated WAN, chaos vs clean
# ---------------------------------------------------------------------------

WAN_PARTIES = ("alice", "bob", "carol")
WAN_ROUNDS = 5
WAN_BASES = {"alice": 1.0, "bob": 3.0, "carol": 5.0}
WAN_CORRUPT_AFTER = 2  # alice->bob data frame index hit by the burst


def _series_value(name, **labels):
    from rayfed_tpu_torch.telemetry.metrics import get_registry

    ent = get_registry().snapshot().get(name)
    if not ent:
        return 0.0
    return sum(
        s["value"] for s in ent["series"]
        if all(s["labels"].get(k) == v for k, v in labels.items())
    )


def _wan_comm_config():
    return {
        "retry_policy": {
            "max_attempts": 4,
            "initial_backoff_ms": 100,
            "max_backoff_ms": 1000,
        },
        "timeout_in_ms": 5000,
        "recv_timeout_in_ms": 10000,
        "send_deadline_in_ms": 20000,
        "frame_crc": True,
        "adaptive_timeouts": True,
        "shm_enabled": True,
        "shm_min_bytes": 4096,
        "shm_ring_mb": 8,
        "shm_repromote_after_ms": 300,
    }


def _wan_schedule(seed):
    return {
        "seed": seed,
        "links": [
            {"latency_ms": 50, "jitter_ms": 20, "loss": 0.01,
             "rate_mbit": 100}
        ],
        "rules": [
            {"fault": "corrupt", "src": "alice", "dst": "bob", "prob": 1.0,
             "after": WAN_CORRUPT_AFTER, "for": 1},
        ],
    }


@fed.remote
def _wan_update(base, r):
    # 64 KB per leaf: over shm_min_bytes, so data frames ride the ring.
    return {"w": torch.full((128, 128), base * (r + 1), dtype=torch.float32)}


def run_wan_party(party, addresses, seed, chaos, out_dir):
    out_path = os.path.join(out_dir, f"wan-{party}.json")
    if chaos:
        # Each receiver refuses its FIRST ring adoption: the sender that
        # lands it is demoted to tcp and must later re-promote.
        os.environ["FEDTPU_SHM_FORCE_ATTACH_FAIL"] = "1"
    config = {
        "barrier_on_initializing": True,
        "cross_silo_comm": _wan_comm_config(),
    }
    if chaos:
        config["resilience"] = {
            "fault_schedule": _wan_schedule(seed),
            "liveness": {
                "interval_ms": 500,
                "suspect_after": 2,
                "dead_after": 5,
                "timeout_ms": 2500,
            },
        }
    fed.init(addresses=addresses, party=party, config=config)
    from rayfed_tpu_torch.resilience import liveness

    agg = None
    for r in range(WAN_ROUNDS):
        handles = [
            _wan_update.party(p).remote(WAN_BASES[p], r) for p in WAN_PARTIES
        ]
        got = fed.get(handles, timeout=30.0)
        for p, v in zip(WAN_PARTIES, got):
            expect = np.full((128, 128), WAN_BASES[p] * (r + 1), np.float32)
            assert isinstance(v["w"], torch.Tensor), type(v["w"])
            assert np.asarray(v["w"]).tobytes() == expect.tobytes(), (
                party, r, p,
            )
        agg = np.mean([np.asarray(v["w"]) for v in got], axis=0)
        time.sleep(0.2)  # lets the re-promotion hold-off expire mid-job
    monitor = liveness.get_monitor()
    view = monitor.view() if monitor is not None else {}
    result = {
        "party": party,
        "agg_hex": agg.astype(np.float32).tobytes().hex(),
        "dead": sorted(p for p, s in view.items() if s == liveness.DEAD),
        "crc_retransmits": _series_value(
            "fed_transport_frame_crc_retransmits_total"
        ),
        "crc_failures": _series_value(
            "fed_transport_frame_crc_failures_total"
        ),
        "fallbacks": _series_value(
            "fed_transport_lane_fallbacks_total", lane="shm", to="tcp"
        ),
        "repromotions": _series_value(
            "fed_transport_lane_repromotions_total", lane="shm"
        ),
    }
    if chaos:
        # Zero DEAD false positives: every peer stayed reachable through
        # the shaped link for the whole run.
        assert result["dead"] == [], view
    with open(out_path, "w") as f:
        json.dump(result, f)
    fed.shutdown()


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_wan_chaos_fedavg_matches_clean_run_bitwise(tmp_path):
    """The acceptance run: 3-party FedAvg over an emulated
    50ms/±20ms-jitter/1%-loss/100Mbit link, with one mid-job corrupt
    burst (crc-NACKed and retransmitted) and a forced shm demotion
    (probed and re-promoted). All rounds complete bitwise-identical to
    the clean-link run, with zero DEAD false positives, at least one
    crc-triggered retransmit, and a verified shm->tcp->shm cycle."""
    seed = 20260817
    results = {}
    for mode, chaos in (("chaos", True), ("clean", False)):
        out_dir = tmp_path / mode
        out_dir.mkdir()
        run_parties(
            run_wan_party,
            list(WAN_PARTIES),
            timeout=180,
            extra_args=(seed, chaos, str(out_dir)),
            addresses=get_addresses(list(WAN_PARTIES)),
        )
        results[mode] = {
            p: json.loads((out_dir / f"wan-{p}.json").read_text())
            for p in WAN_PARTIES
        }
    for p in WAN_PARTIES:
        # Chaos run aggregate == clean run aggregate, byte for byte.
        assert results["chaos"][p]["agg_hex"] == results["clean"][p][
            "agg_hex"
        ], p
    chaos = results["chaos"]
    # The corrupt burst was caught by the receiver's crc check (bob) and
    # repaired by the sender's retransmit (alice).
    assert chaos["alice"]["crc_retransmits"] >= 1, chaos["alice"]
    assert chaos["bob"]["crc_failures"] >= 1, chaos["bob"]
    # At least one shm demotion happened and was later re-promoted.
    assert sum(r["fallbacks"] for r in chaos.values()) >= 1, chaos
    assert sum(r["repromotions"] for r in chaos.values()) >= 1, chaos
    # The clean run never NACKed a frame.
    assert all(r["crc_failures"] == 0 for r in results["clean"].values())
