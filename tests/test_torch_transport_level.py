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

"""The port's transport-level tests driving the proxies directly,
mirroring ``test_transport_level.py`` with the same assertions and torch
payloads: concurrent send/recv pairs, job-name 417 on the wire, recv
deadlines, tracing spans, strict (arrays-only) mode and the default
receive cap."""

import threading

import numpy as np
import pytest
import torch

from rayfed_tpu_torch import tracing
from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy, TcpSenderProxy
from tests.utils import get_addresses

FAST = {"retry_policy": {"max_attempts": 5, "initial_backoff_ms": 100}}


def _pair(job_sender="job", job_receiver="job", sender_cfg=None,
          receiver_cfg=None):
    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(
        addr["bob"], "bob", job_receiver, None, receiver_cfg or dict(FAST)
    )
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = TcpSenderProxy(addr, "alice", job_sender, None,
                        sender_cfg or dict(FAST))
    sp.start()
    return sp, rp


def test_concurrent_send_recv_pairs():
    sp, rp = _pair()
    n = 20
    recvs = [rp.get_data("alice", f"{i}#0", i) for i in range(0, n, 2)]
    sends = [
        sp.send("bob", {"i": torch.full((64,), i, dtype=torch.int32)}, f"{i}#0", i)
        for i in range(n)
    ]
    assert all(f.result(timeout=30) for f in sends)
    late_recvs = [rp.get_data("alice", f"{i}#0", i) for i in range(1, n, 2)]
    for i, f in zip(range(0, n, 2), recvs):
        assert f.result(timeout=30)["i"][0] == i
    for i, f in zip(range(1, n, 2), late_recvs):
        assert f.result(timeout=30)["i"][0] == i
    assert sp.get_stats()["send_op_count"] == n
    assert rp.get_stats()["receive_op_count"] == n
    sp.stop()
    rp.stop()


def test_job_name_mismatch_417_on_wire():
    sp, rp = _pair(job_sender="jobA", job_receiver="jobB")
    fut = sp.send("bob", "data", "1#0", 2)
    with pytest.raises(RuntimeError, match="417"):
        fut.result(timeout=30)
    # The alien payload must NOT be delivered to a waiter.
    parked = rp.get_data("alice", "1#0", 2)
    assert not parked.done()
    sp.stop()
    rp.stop()


def test_recv_deadline_expires_waiter():
    cfg = {**FAST, "recv_timeout_in_ms": 500}
    sp, rp = _pair(receiver_cfg=cfg)
    fut = rp.get_data("alice", "99#0", 100)
    with pytest.raises(TimeoutError, match="recv_timeout_in_ms"):
        fut.result(timeout=10)
    # Data arriving after expiry hits the tombstoned key and is
    # acked-and-dropped like a duplicate (no leak, no crash).
    assert sp.send("bob", "late", "99#0", 100).result(timeout=10)
    sp.stop()
    rp.stop()


def test_recv_deadline_not_triggered_when_data_flows():
    cfg = {**FAST, "recv_timeout_in_ms": 2000}
    sp, rp = _pair(receiver_cfg=cfg)
    fut = rp.get_data("alice", "5#0", 6)
    assert sp.send("bob", {"x": torch.ones(8, dtype=torch.float64)}, "5#0",
                   6).result(timeout=10)
    assert torch.equal(fut.result(timeout=10)["x"],
                       torch.ones(8, dtype=torch.float64))
    sp.stop()
    rp.stop()


def test_tracing_spans_record_transfers():
    tracing.clear()
    tracing.enable()
    try:
        sp, rp = _pair()
        fut = rp.get_data("alice", "1#0", 2)
        payload = {"g": torch.ones((1024,), dtype=torch.float32)}
        assert sp.send("bob", payload, "1#0", 2).result(timeout=30)
        assert torch.equal(fut.result(timeout=30)["g"].ravel(),
                           torch.ones(1024, dtype=torch.float32))
        sp.stop()
        rp.stop()
        sends = tracing.get_spans("send")
        recvs = tracing.get_spans("recv")
        decodes = tracing.get_spans("decode")
        assert len(sends) == 1 and sends[0].nbytes == 4096
        assert sends[0].peer == "bob" and sends[0].ok
        assert len(recvs) == 1 and recvs[0].peer == "alice"
        assert len(decodes) == 1
        s = tracing.summary()
        assert s["send"]["count"] == 1 and s["send"]["bytes"] == 4096
    finally:
        tracing.disable()
        tracing.clear()


def test_chrome_trace_export(tmp_path):
    """Spans export as a valid Chrome trace-event file: timed kinds as
    complete events with durations, arrivals as instants."""
    import json

    tracing.clear()
    tracing.enable()
    try:
        sp, rp = _pair()
        fut = rp.get_data("alice", "9#0", 7)
        assert sp.send("bob", {"g": torch.zeros(256, dtype=torch.float32)}, "9#0", 7
                       ).result(timeout=30)
        fut.result(timeout=30)
        sp.stop()
        rp.stop()
        out = tmp_path / "trace.json"
        n = tracing.export_chrome_trace(str(out), party="alice")
        assert n >= 3  # send + recv + decode at minimum
        doc = json.loads(out.read_text())
        events = doc["traceEvents"]
        phases = {e["cat"]: e["ph"] for e in events}
        assert phases["send"] == "X" and phases["recv"] == "i"
        send_ev = next(e for e in events if e["cat"] == "send")
        assert send_ev["dur"] > 0 and send_ev["args"]["nbytes"] == 1024
        assert send_ev["pid"] == "alice"
    finally:
        tracing.disable()
        tracing.clear()


def test_tracing_disabled_records_nothing():
    tracing.clear()
    sp, rp = _pair()
    fut = rp.get_data("alice", "1#0", 2)
    assert sp.send("bob", "x", "1#0", 2).result(timeout=30)
    assert fut.result(timeout=30) == "x"
    sp.stop()
    rp.stop()
    assert tracing.get_spans() == []


def test_retry_policy_plumbed_to_proxy_config():
    # Mirror of ref test_retry_policy.py / test_grpc_options_on_proxies.py:
    # user-supplied retry policy must reach the transport's effective config.
    cfg = {
        "retry_policy": {
            "max_attempts": 7,
            "initialBackoff": "2s",   # reference-style camelCase accepted
            "maxBackoff": "9s",
            "backoffMultiplier": 3,
        },
        "timeout_in_ms": 12345,
    }
    sp, rp = _pair(sender_cfg=cfg)
    eff = sp.get_proxy_config()
    assert eff.timeout_in_ms == 12345
    policy = eff.get_retry_policy()
    assert policy.max_attempts == 7
    assert policy.initial_backoff_ms == 2000
    assert policy.max_backoff_ms == 9000
    assert policy.backoff_multiplier == 3
    sp.stop()
    rp.stop()


class _Custom:
    pass


def test_strict_mode_sender_refuses_pickle_payloads():
    cfg = {**FAST, "allow_pickle_payloads": False}
    sp, rp = _pair(sender_cfg=cfg, receiver_cfg=cfg)
    # Array pytrees still flow.
    fut = rp.get_data("alice", "1#0", 2)
    assert sp.send("bob", {"w": torch.ones(4, dtype=torch.float64)}, "1#0",
                   2).result(timeout=30)
    assert fut.result(timeout=30)["w"].sum() == 4
    # A payload needing pickle fails fast at the sender.
    bad = sp.send("bob", _Custom(), "3#0", 4)
    with pytest.raises(ValueError, match="arrays-only"):
        bad.result(timeout=30)
    sp.stop()
    rp.stop()


def test_strict_mode_receiver_rejects_pickle_frames():
    # Lenient sender vs strict receiver: the frame is refused on the wire
    # with code 415 and the unpickler never runs.
    sp, rp = _pair(receiver_cfg={**FAST, "allow_pickle_payloads": False})
    fut = sp.send("bob", _Custom(), "1#0", 2)
    with pytest.raises(RuntimeError, match="415"):
        fut.result(timeout=30)
    parked = rp.get_data("alice", "1#0", 2)
    assert not parked.done()
    sp.stop()
    rp.stop()


def test_strict_mode_error_envelopes_decode_under_empty_whitelist():
    # An attacker stamping is_error=True on a pickle frame must NOT reach
    # the unrestricted unpickler: strict receivers decode error frames
    # under the empty whitelist (FedRemoteError + builtin exceptions only).
    import pickle as _pickle

    from rayfed_tpu_torch.exceptions import FedRemoteError

    sp, rp = _pair(receiver_cfg={**FAST, "allow_pickle_payloads": False})
    # Legit envelope passes.
    fut = rp.get_data("alice", "1#0", 2)
    sp.send("bob", FedRemoteError("alice", None), "1#0", 2,
            is_error=True).result(timeout=30)
    got = fut.result(timeout=30)
    assert isinstance(got, FedRemoteError)
    # Malicious "error" carrying a non-whitelisted class is refused by the
    # unpickler (surfaces as UnpicklingError on the waiter, no execution).
    fut2 = rp.get_data("alice", "3#0", 4)
    sp.send("bob", _Custom(), "3#0", 4, is_error=True).result(timeout=30)
    with pytest.raises(_pickle.UnpicklingError):
        fut2.result(timeout=30)
    sp.stop()
    rp.stop()


def test_strict_mode_rejects_grpc_transport():
    import rayfed_tpu_torch as fed

    with pytest.raises(ValueError, match="incompatible"):
        fed.init(
            addresses={"alice": "127.0.0.1:45999"},
            party="alice",
            transport="grpc",
            config={"cross_silo_comm": {"allow_pickle_payloads": False}},
        )
    # The rejected init must not leave a half-built context behind.
    from rayfed_tpu_torch._private.global_context import get_global_context

    assert get_global_context() is None


def test_default_receive_cap_is_500mb():
    """ADVICE r1: an unauthenticated peer must not be able to make the
    receiver allocate arbitrarily large buffers — with no explicit
    messages_max_size_in_bytes the effective cap is 500MB (gRPC parity)."""
    import socket

    from rayfed_tpu_torch.config import (
        DEFAULT_MAX_MESSAGE_BYTES,
        TcpCrossSiloMessageConfig,
    )
    from rayfed_tpu_torch.proxy.tcp import wire

    cfg = TcpCrossSiloMessageConfig()
    assert cfg.effective_max_message_bytes() == DEFAULT_MAX_MESSAGE_BYTES
    assert TcpCrossSiloMessageConfig(
        messages_max_size_in_bytes=0
    ).effective_max_message_bytes() is None
    assert TcpCrossSiloMessageConfig(
        messages_max_size_in_bytes=123
    ).effective_max_message_bytes() == 123

    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", None, {})
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    host, port = addr["bob"].rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=10)
    # Claim a 600MB payload: the receiver must drop the connection before
    # buffering anything rather than np.empty(600MB) on attacker say-so.
    s.sendall(wire.encode_prefix_and_header(
        wire.FTYPE_DATA, {"job": "job"}, 600 * 1024 * 1024
    ))
    s.settimeout(10)
    # Drop may surface as EOF or RST depending on unread socket state.
    try:
        assert s.recv(1) == b"", "receiver kept an over-cap connection open"
    except ConnectionError:
        pass
    s.close()
    rp.stop()
