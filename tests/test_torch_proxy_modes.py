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

"""The port's proxy deployment modes, mirroring ``test_proxy_modes.py``
with the same assertions and torch payloads:

- combined SenderReceiverProxy (one object, one advertised port; ref
  ``fed/proxy/base_proxy.py:77-106``, ``barriers.py:415-459``);
- per-job proxy registry names with ``use_global_proxy=False`` (ref
  ``barriers.py:31-85``, ``fed/tests/multi-jobs/test_multi_proxy_actor.py``);
- receiver accept-loop supervision (``proxy_max_restarts``);
- per-destination proxy config (ref ``grpc_proxy.py:156-177``), and the
  pipelined lane's send window.
"""

import pytest
import torch

from rayfed_tpu_torch.config import TcpCrossSiloMessageConfig
from rayfed_tpu_torch.proxy import barriers
from rayfed_tpu_torch.proxy.tcp.tcp_proxy import (
    TcpReceiverProxy,
    TcpSenderProxy,
    TcpSenderReceiverProxy,
)
from tests.utils import get_addresses

FAST = {"retry_policy": {"max_attempts": 5, "initial_backoff_ms": 100}}


def test_combined_proxy_roundtrip():
    addrs = get_addresses(["alice", "bob"])
    a = TcpSenderReceiverProxy(addrs, "alice", "job", None, dict(FAST))
    b = TcpSenderReceiverProxy(addrs, "bob", "job", None, dict(FAST))
    a.start()
    b.start()
    assert a.is_ready()[0] and b.is_ready()[0]
    fut_b = b.get_data("alice", "1#0", 2)
    fut_a = a.get_data("bob", "3#0", 4)
    assert a.send("bob", torch.arange(8, dtype=torch.float32), "1#0", 2).result(30)
    assert b.send("alice", torch.arange(4, dtype=torch.float32), "3#0", 4).result(30)
    assert torch.equal(fut_b.result(30), torch.arange(8, dtype=torch.float32))
    assert torch.equal(fut_a.result(30), torch.arange(4, dtype=torch.float32))
    assert a.get_stats()["send_op_count"] == 1
    a.stop()
    b.stop()


def test_combined_proxy_via_fed_init():
    """Mirror of ref test_multi_proxy_actor semantics: fed.init with the
    combined class + use_global_proxy=False registers ONE job-suffixed
    proxy serving both directions."""
    import rayfed_tpu_torch as fed

    addrs = get_addresses(["alice"])
    fed.init(
        addresses=addrs,
        party="alice",
        job_name="combined_job",
        receiver_sender_proxy_cls=TcpSenderReceiverProxy,
        config={"cross_silo_comm": dict(FAST, use_global_proxy=False)},
    )
    try:
        name = barriers.proxy_name("sender_receiver", "combined_job", False)
        assert name == "SenderReceiverProxy_combined_job"
        proxy = barriers.get_registered_proxy(name)
        assert proxy is not None
        assert barriers.sender_proxy() is proxy
        assert barriers.receiver_proxy() is proxy

        @fed.remote
        def echo(v):
            return v * 2

        out = echo.party("alice").remote(torch.tensor(21))
        assert torch.equal(fed.get(out), torch.tensor(42))
    finally:
        fed.shutdown()
    assert barriers.get_registered_proxy(name) is None


def test_per_job_proxy_names():
    import rayfed_tpu_torch as fed

    addrs = get_addresses(["alice"])
    fed.init(
        addresses=addrs,
        party="alice",
        job_name="job_test",
        config={"cross_silo_comm": dict(FAST, use_global_proxy=False)},
    )
    try:
        assert barriers.get_registered_proxy(
            barriers.sender_proxy_name("job_test", False)
        ) is not None
        assert barriers.get_registered_proxy(
            barriers.receiver_proxy_name("job_test", False)
        ) is not None
        # The global-singleton names are NOT taken by this job.
        assert barriers.get_registered_proxy("SenderProxy") is None
    finally:
        fed.shutdown()


def test_two_jobs_proxies_coexist_in_one_process():
    """Stronger than the reference: two jobs' proxy pairs run concurrently
    in one process (distinct ports, distinct registry names), each honoring
    its own job isolation."""
    addrs1 = get_addresses(["bob"])
    addrs2 = get_addresses(["bob"])
    r1 = TcpReceiverProxy(addrs1["bob"], "bob", "jobA", None, dict(FAST))
    r2 = TcpReceiverProxy(addrs2["bob"], "bob", "jobB", None, dict(FAST))
    r1.start(), r2.start()
    assert r1.is_ready()[0] and r2.is_ready()[0]
    barriers._proxy_registry[barriers.receiver_proxy_name("jobA", False)] = r1
    barriers._proxy_registry[barriers.receiver_proxy_name("jobB", False)] = r2
    try:
        s1 = TcpSenderProxy(addrs1, "alice", "jobA", None, dict(FAST))
        s2 = TcpSenderProxy(addrs2, "alice", "jobB", None, dict(FAST))
        s1.start(), s2.start()
        f1 = r1.get_data("alice", "1#0", 2)
        f2 = r2.get_data("alice", "1#0", 2)
        assert s1.send("bob", "payload-A", "1#0", 2).result(30)
        assert s2.send("bob", "payload-B", "1#0", 2).result(30)
        assert f1.result(30) == "payload-A"
        assert f2.result(30) == "payload-B"
        # Cross-job frames are rejected with 417.
        bad = TcpSenderProxy(addrs1, "alice", "jobB", None, dict(FAST))
        bad.start()
        with pytest.raises(RuntimeError, match="417"):
            bad.send("bob", "alien", "9#0", 9).result(30)
        bad.stop()
        s1.stop(), s2.stop()
    finally:
        barriers.stop_proxies("jobA")
        barriers.stop_proxies("jobB")
    assert barriers.get_registered_proxy(
        barriers.receiver_proxy_name("jobA", False)
    ) is None


def test_accept_loop_supervision_restarts_listener(monkeypatch):
    """A crashed accept loop rebinds and keeps serving (proxy_max_restarts),
    instead of leaving the job deaf."""
    from rayfed_tpu_torch.proxy.tcp import tcp_proxy as mod

    addrs = get_addresses(["bob"])
    rp = TcpReceiverProxy(addrs["bob"], "bob", "job", None,
                          dict(FAST, proxy_max_restarts=2))
    # First _accept_once call blows up; later calls run normally.
    real_accept_once = TcpReceiverProxy._accept_once
    calls = {"n": 0}

    def flaky(self):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected accept crash")
        return real_accept_once(self)

    monkeypatch.setattr(TcpReceiverProxy, "_accept_once", flaky)
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    import time

    deadline = time.monotonic() + 10
    while calls["n"] < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert calls["n"] >= 2, "accept loop was not restarted"
    sp = TcpSenderProxy(addrs, "alice", "job", None, dict(FAST))
    sp.start()
    fut = rp.get_data("alice", "1#0", 2)
    assert sp.send("bob", "still-alive", "1#0", 2).result(30)
    assert fut.result(30) == "still-alive"
    sp.stop()
    rp.stop()


def test_per_dest_proxy_config():
    cfg = TcpCrossSiloMessageConfig.from_dict({
        "timeout_in_ms": 60000,
        "messages_max_size_in_bytes": 1000,
        "per_party_config": {
            "bob": {"messages_max_size_in_bytes": 50,
                    "timeout_in_ms": 5000},
        },
    })
    assert cfg.for_dest("alice").messages_max_size_in_bytes == 1000
    assert cfg.for_dest(None) is cfg
    bob = cfg.for_dest("bob")
    assert bob.messages_max_size_in_bytes == 50
    assert bob.timeout_in_ms == 5000
    assert bob.retry_policy == cfg.retry_policy

    # And the sender enforces the per-dest cap on its send path.
    addrs = get_addresses(["bob"])
    rp = TcpReceiverProxy(addrs["bob"], "bob", "job", None, dict(FAST))
    rp.start()
    assert rp.is_ready()[0]
    sp = TcpSenderProxy(
        addrs, "alice", "job", None,
        dict(FAST, per_party_config={
            "bob": {"messages_max_size_in_bytes": 64},
        }),
    )
    sp.start()
    assert sp.get_proxy_config("bob").messages_max_size_in_bytes == 64
    with pytest.raises(ValueError, match="exceeds"):
        sp.send("bob", torch.zeros(1024), "1#0", 2).result(30)
    # Small payloads still flow.
    fut = rp.get_data("alice", "3#0", 4)
    assert sp.send("bob", torch.zeros(4), "3#0", 4).result(30)
    assert fut.result(30).shape == (4,)
    sp.stop()
    rp.stop()


def test_send_window_configurable():
    """send_window plumbs through to the pipelined lane; window=1 behaves
    as half-duplex and still delivers."""
    addrs = get_addresses(["bob"])
    rp = TcpReceiverProxy(addrs["bob"], "bob", "job", None, dict(FAST))
    rp.start()
    assert rp.is_ready()[0]
    sp = TcpSenderProxy(addrs, "alice", "job", None,
                        dict(FAST, send_window=1))
    sp.start()
    futs = [rp.get_data("alice", f"{i}#0", i) for i in range(6)]
    sends = [
        sp.send("bob", torch.full((32,), float(i)), f"{i}#0", i)
        for i in range(6)
    ]
    assert all(f.result(30) for f in sends)
    for i, f in enumerate(futs):
        assert f.result(30)[0] == i
    worker = sp._workers["bob"]
    assert worker._lane._window._value <= 1  # window restored after acks
    sp.stop()
    rp.stop()
