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

"""Lane-tier negotiation and the same-host shared-memory lane, on the port
(the JAX package's ``test_lanes.py`` mirrored, with torch trees).

Covers the fallback matrix (same-process / same-host / cross-host /
TLS-required; the port's ``"cuda"`` transport where the JAX package has
``"tpu"``), the shm ring (the native one from
``rayfed_tpu_torch._fastwire`` and the pure-Python twin share one on-disk
format), and the end-to-end proxy path: torch trees over 127.0.0.1 ride
the shm ring byte-identically, and a forced attach failure mid-job
demotes the peer to the socket lane without losing a byte."""

import os

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.config import LANE_TIERS, TcpCrossSiloMessageConfig
from rayfed_tpu_torch.proxy import lanes
from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy, TcpSenderProxy
from rayfed_tpu_torch.telemetry.metrics import get_registry
from tests.utils import get_addresses

FAST = {"retry_policy": {"max_attempts": 5, "initial_backoff_ms": 100}}


def _cfg(**kw):
    return TcpCrossSiloMessageConfig.from_dict({**FAST, **kw})


def _series_value(name, **labels):
    ent = get_registry().snapshot().get(name)
    if not ent:
        return 0.0
    for s in ent["series"]:
        if s["labels"] == labels:
            return s["value"]
    return 0.0


# ---------------------------------------------------------------------------
# Negotiation matrix
# ---------------------------------------------------------------------------


def test_tier_order_is_canonical():
    assert LANE_TIERS == ("meshref", "shm", "tcp", "tls", "grpc")
    assert [lanes.tier_rank(t) for t in LANE_TIERS] == [0, 1, 2, 3, 4]
    assert lanes.tier_rank("no-such-tier") == len(LANE_TIERS)


@pytest.mark.parametrize(
    "caps,expect",
    [
        # Same-process colocated mesh beats everything.
        (lanes.PeerCapabilities(same_process=True, same_host=True,
                                shm=True), "meshref"),
        # Same-host plaintext with shm enabled -> shm.
        (lanes.PeerCapabilities(same_host=True, shm=True), "shm"),
        # Same-host but shm not enabled -> plain socket lane.
        (lanes.PeerCapabilities(same_host=True, shm=False), "tcp"),
        # Cross-host plaintext -> tcp even with shm enabled.
        (lanes.PeerCapabilities(same_host=False, shm=True), "tcp"),
        # TLS-required: shm and tcp predicates never fire.
        (lanes.PeerCapabilities(same_host=True, shm=True,
                                plaintext=False), "tls"),
        # gRPC parity transport.
        (lanes.PeerCapabilities(same_host=True, shm=True,
                                transport="grpc"), "grpc"),
        # The CUDA proxy is a socket transport for tier purposes.
        (lanes.PeerCapabilities(same_host=True, shm=True,
                                transport="cuda"), "shm"),
    ],
)
def test_negotiate_matrix(caps, expect):
    assert lanes.negotiate(caps).tier == expect


def test_restricted_tiers_deny_overlays_not_connectivity():
    caps = lanes.PeerCapabilities(same_host=True, shm=True)
    # shm denied by policy -> next matching tier.
    assert lanes.negotiate(caps, ("tcp",)).tier == "tcp"
    # A policy that names no usable tier still yields the wire the
    # connection needs, never a dead end.
    d = lanes.negotiate(caps, ("meshref",))
    assert d.tier == "tcp" and "no permitted tier" in d.reason
    # ... and TLS is never downgraded to plaintext by policy.
    tls_caps = lanes.PeerCapabilities(same_host=True, shm=True,
                                      plaintext=False)
    d = lanes.negotiate(tls_caps, ("shm", "tcp"))
    assert d.tier == "tls"


def test_same_host_predicate():
    assert lanes.same_host(None, "127.0.0.1:8000")
    assert lanes.same_host("10.0.0.1:1", "localhost:2")
    assert lanes.same_host("node-a:9000", "node-a:9001")
    assert lanes.same_host("[::1]:1", "::1:2")
    assert not lanes.same_host("node-a:9000", "node-b:9000")
    assert not lanes.same_host("0.0.0.0:9000", "node-b:9000")
    assert not lanes.same_host("node-a:9000", None)


def test_negotiate_for_dest_reads_config_and_tls():
    cfg = _cfg(shm_enabled=True)
    d = lanes.negotiate_for_dest(cfg, None, "tcp",
                                 "127.0.0.1:1", "127.0.0.1:2")
    assert d.tier == ("shm" if lanes.shm_available() else "tcp")
    d = lanes.negotiate_for_dest(cfg, {"cert": "x"}, "tcp",
                                 "127.0.0.1:1", "127.0.0.1:2")
    assert d.tier == "tls"
    d = lanes.negotiate_for_dest(_cfg(), None, "tcp",
                                 "127.0.0.1:1", "127.0.0.1:2")
    assert d.tier == "tcp"  # shm is opt-in


def test_lane_tiers_config_validation():
    with pytest.raises(ValueError, match="lane_tiers"):
        _cfg(lane_tiers=["warp-drive"])
    cfg = _cfg(lane_tiers=["tcp"], shm_enabled=True)
    d = lanes.negotiate_for_dest(cfg, None, "tcp",
                                 "127.0.0.1:1", "127.0.0.1:2")
    assert d.tier == "tcp"


# ---------------------------------------------------------------------------
# Ring units (parametrized over the available implementations)
# ---------------------------------------------------------------------------


def _impls():
    # The port builds its native module wherever a C++ compiler exists.
    return [("py", lanes._PyShmRing), ("native", lanes._NativeShmRing)]


def test_the_native_ring_is_live():
    assert lanes._native_ok() and lanes.shm_available()


@pytest.fixture(params=[n for n, _ in _impls()])
def ring_impl(request):
    return dict(_impls())[request.param]


@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="no /dev/shm")
def test_ring_roundtrip_and_occupancy(ring_impl):
    name = lanes.ring_name("job", "alice", "bob")
    tx = ring_impl.create(name, 1 << 20)
    try:
        rx = ring_impl.attach(name)
        payload = [b"abc", os.urandom(70000), b"z"]
        n = sum(len(b) for b in payload)
        off = tx.push(payload)
        assert off is not None
        used, cap = tx.occupancy()
        assert used > 0 and cap == 1 << 20
        got = bytes(rx.adopt(off, n))
        assert got == b"".join(payload)
        assert tx.occupancy()[0] == 0  # adopt released the chunk
        rx.close()
    finally:
        tx.close()
    assert not os.path.exists(os.path.join("/dev/shm", name))


@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="no /dev/shm")
def test_ring_wraps_and_reports_full(ring_impl):
    name = lanes.ring_name("job", "alice", "bob")
    tx = ring_impl.create(name, 1 << 16)
    try:
        rx = ring_impl.attach(name)
        blob = os.urandom(20000)
        # Push/adopt several times the capacity: the write head must
        # wrap and every adoption must still be byte-identical.
        for _ in range(12):
            off = tx.push([blob])
            assert off is not None
            assert bytes(rx.adopt(off, len(blob))) == blob
        # Fill without adopting -> eventually full -> push returns None.
        pushes = 0
        while tx.push([blob]) is not None:
            pushes += 1
            assert pushes < 100
        assert pushes >= 1
        rx.close()
    finally:
        tx.close()


@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="no /dev/shm")
def test_ring_cancel_reclaims_space(ring_impl):
    name = lanes.ring_name("job", "alice", "bob")
    tx = ring_impl.create(name, 1 << 16)
    try:
        blob = b"x" * 30000
        for _ in range(8):  # without cancel the 64KB ring fills at 2
            off = tx.push([blob])
            assert off is not None
            tx.cancel(off)
        assert tx.occupancy()[0] == 0
    finally:
        tx.close()


@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="no /dev/shm")
def test_ring_cross_implementation_interop():
    payload = os.urandom(100000)
    for tx_cls, rx_cls in (
        (lanes._NativeShmRing, lanes._PyShmRing),
        (lanes._PyShmRing, lanes._NativeShmRing),
    ):
        name = lanes.ring_name("job", "a", "b")
        tx = tx_cls.create(name, 1 << 20)
        try:
            rx = rx_cls.attach(name)
            off = tx.push([payload])
            assert bytes(rx.adopt(off, len(payload))) == payload
            rx.close()
        finally:
            tx.close()


# ---------------------------------------------------------------------------
# End-to-end proxy pair over 127.0.0.1
# ---------------------------------------------------------------------------

SHM_CFG = dict(FAST, shm_enabled=True, shm_min_bytes=4096, shm_ring_mb=8)


def _pair(sender_cfg=None, receiver_cfg=None):
    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", None,
                          dict(receiver_cfg or SHM_CFG))
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = TcpSenderProxy(addr, "alice", "job", None,
                        dict(sender_cfg or SHM_CFG))
    sp.start()
    return sp, rp


def _tree_payload(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(1024,)).astype(np.float64)),
        "h": torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32))
        .to(torch.bfloat16),
    }


def _bytes(x):
    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


def _assert_bitwise_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert _bytes(a[k]) == _bytes(b[k])


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_shm_lane_end_to_end_byte_identical():
    before = _series_value("fed_transport_lane_send_ops_total", lane="shm")
    sp, rp = _pair()
    try:
        value = _tree_payload()
        recv = rp.get_data("alice", "1#0", 2)
        assert sp.send("bob", value, "1#0", 2).result(timeout=30)
        _assert_bitwise_equal(value, recv.result(timeout=30))
        after = _series_value("fed_transport_lane_send_ops_total", lane="shm")
        assert after == before + 1
        assert _series_value("fed_transport_peer_tier", peer="bob") == float(
            lanes.tier_rank("shm")
        )
    finally:
        sp.stop()
        rp.stop()


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_shm_vs_tcp_aggregates_bitwise_identical():
    """Acceptance: the same tree crosses the shm lane and the plain tcp
    lane bitwise-identically — lane choice must never change payload
    bytes (the fedavg aggregate equivalence check, proxy-level)."""
    value = _tree_payload(seed=7)

    sp, rp = _pair()  # shm-enabled pair
    try:
        recv = rp.get_data("alice", "1#0", 2)
        assert sp.send("bob", value, "1#0", 2).result(timeout=30)
        via_shm = recv.result(timeout=30)
    finally:
        sp.stop()
        rp.stop()

    sp, rp = _pair(sender_cfg=dict(FAST), receiver_cfg=dict(FAST))
    try:
        recv = rp.get_data("alice", "1#0", 2)
        assert sp.send("bob", value, "1#0", 2).result(timeout=30)
        via_tcp = recv.result(timeout=30)
    finally:
        sp.stop()
        rp.stop()

    _assert_bitwise_equal(via_shm, via_tcp)
    _assert_bitwise_equal(value, via_shm)


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_small_payloads_stay_on_socket_lane():
    before = _series_value("fed_transport_lane_send_ops_total", lane="shm")
    sp, rp = _pair()
    try:
        recv = rp.get_data("alice", "1#0", 2)
        small = {"x": torch.arange(16, dtype=torch.int32)}  # < shm_min_bytes
        assert sp.send("bob", small, "1#0", 2).result(timeout=30)
        got = recv.result(timeout=30)
        assert _bytes(got["x"]) == _bytes(small["x"])
        after = _series_value("fed_transport_lane_send_ops_total", lane="shm")
        assert after == before  # rode the socket, not the ring
    finally:
        sp.stop()
        rp.stop()


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_forced_attach_failure_falls_back_to_tcp_mid_job(monkeypatch):
    """Acceptance: kill the receiver's ability to attach the ring
    MID-JOB — the in-flight push must be NACKed (424), the sender must
    demote the peer to the socket lane, and every payload (the failed
    one included) must arrive byte-identical."""
    fb_before = _series_value("fed_transport_lane_fallbacks_total",
                              lane="shm", to="tcp")
    sp, rp = _pair()
    try:
        # First send rides shm (proves the lane was actually up before
        # the failure is injected).
        v0 = _tree_payload(seed=1)
        recv = rp.get_data("alice", "1#0", 2)
        assert sp.send("bob", v0, "1#0", 2).result(timeout=30)
        _assert_bitwise_equal(v0, recv.result(timeout=30))

        monkeypatch.setenv("FEDTPU_SHM_FORCE_ATTACH_FAIL", "1")
        v1 = _tree_payload(seed=2)
        recv = rp.get_data("alice", "2#0", 3)
        assert sp.send("bob", v1, "2#0", 3).result(timeout=30)
        _assert_bitwise_equal(v1, recv.result(timeout=30))
        assert _series_value("fed_transport_lane_fallbacks_total",
                             lane="shm", to="tcp") > fb_before
        assert _series_value("fed_transport_peer_tier", peer="bob") == float(
            lanes.tier_rank("tcp")
        )

        # Demotion is sticky: later sends skip the ring entirely (they
        # must still deliver after the env flag is lifted).
        monkeypatch.delenv("FEDTPU_SHM_FORCE_ATTACH_FAIL")
        v2 = _tree_payload(seed=3)
        recv = rp.get_data("alice", "3#0", 4)
        assert sp.send("bob", v2, "3#0", 4).result(timeout=30)
        _assert_bitwise_equal(v2, recv.result(timeout=30))
    finally:
        sp.stop()
        rp.stop()


@pytest.mark.skipif(not lanes.shm_available(), reason="no shm support")
def test_peer_tier_gauge_cleared_on_stop():
    sp, rp = _pair()
    sp.stop()
    rp.stop()
    ent = get_registry().snapshot().get("fed_transport_peer_tier")
    series = (ent or {}).get("series", [])
    assert not any(s["labels"] == {"peer": "bob"} for s in series)
