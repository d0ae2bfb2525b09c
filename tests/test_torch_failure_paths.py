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

"""The port's failure paths, mirroring ``test_failure_paths.py`` with the
same assertions and torch payloads: send failures (exit-on-failure, the
failure handler, a peer that never starts), the readiness barrier and
its ping attribution, a recv from a dead peer timing out, and a peer
crashing mid-stream. The JAX package's gRPC and ``tpu`` cases have no
counterpart here: the port has no gRPC lane (ROADMAP item 15), and its
``cuda`` transport needs a card."""

import multiprocessing

import pytest

import rayfed_tpu_torch as fed
from tests.utils import FAST_COMM_CONFIG, MP, get_addresses, run_parties


@fed.remote
def boom():
    raise ValueError("intentional failure")


@fed.remote
def consume(x):
    return x


def run_exit_on_sending_failure(party, addresses):
    # Mirrors ref test_cross_silo_error.py:268-308: the producing party's
    # failed push triggers exit(1) via SIGINT-driven unintended shutdown.
    fed.init(
        addresses=addresses,
        party=party,
        config={
            "cross_silo_comm": {
                **FAST_COMM_CONFIG,
                "exit_on_sending_failure": True,
            }
        },
    )
    bad = boom.party("alice").remote()
    out = consume.party("bob").remote(bad)
    try:
        fed.get(out)
    except fed.FedRemoteError:
        pass
    # Like the reference test, park the main thread: the drain thread's
    # SIGINT interrupts the sleep and runs the unintended-shutdown path.
    # (Calling fed.shutdown() here instead would RACE the drain thread for
    # the shutdown-once flag and make the exit code nondeterministic.)
    import time

    time.sleep(60)
    fed.shutdown()


def test_exit_on_sending_failure_exits_nonzero():
    addresses = get_addresses(["alice", "bob"])
    procs = {
        p: MP.Process(target=run_exit_on_sending_failure, args=(p, addresses))
        for p in ("alice", "bob")
    }
    for p in procs.values():
        p.start()
    for p in procs.values():
        p.join(timeout=120)
    # Both parties exit 1 (ref test_cross_silo_error.py:268-308): alice's
    # push of `bad` failed (producer raised); bob's broadcast of `out`
    # failed the same way (its input was the error).
    assert procs["alice"].exitcode == 1, procs["alice"].exitcode
    assert procs["bob"].exitcode == 1, procs["bob"].exitcode


def run_failure_handler(party, addresses, q):
    def handler(err):
        q.put(repr(err))

    fed.init(
        addresses=addresses,
        party=party,
        config={
            "cross_silo_comm": {
                **FAST_COMM_CONFIG,
                "exit_on_sending_failure": True,
            }
        },
        sending_failure_handler=handler,
    )
    bad = boom.party("alice").remote()
    consume.party("bob").remote(bad)
    import time

    time.sleep(30)  # the SIGINT from the drain thread interrupts this
    fed.shutdown()


def test_sending_failure_handler_fires():
    # Mirrors ref test_exit_on_failure_sending.py:38-84 (handler observed
    # via a multiprocessing queue; process exits 1 instead of hanging).
    addresses = get_addresses(["alice", "bob"])
    q = multiprocessing.get_context("spawn").Queue()
    alice = MP.Process(target=run_failure_handler, args=("alice", addresses, q))
    bob = MP.Process(target=run_failure_handler, args=("bob", addresses, q))
    alice.start()
    bob.start()
    alice.join(timeout=120)
    got = q.get(timeout=10)
    assert "FedLocalError" in got or "intentional failure" in got, got
    assert alice.exitcode == 1, alice.exitcode
    bob.terminate()
    bob.join(timeout=30)


def run_peer_never_starts(party, addresses, q):
    fed.init(
        addresses=addresses,
        party=party,
        config={
            "cross_silo_comm": {
                "retry_policy": {
                    "max_attempts": 3,
                    "initial_backoff_ms": 100,
                    "max_backoff_ms": 300,
                },
                "timeout_in_ms": 5000,
                "exit_on_sending_failure": True,
            }
        },
        sending_failure_handler=lambda e: q.put(type(e).__name__),
    )

    @fed.remote
    def produce():
        return 42

    v = produce.party("alice").remote()
    consume.party("bob").remote(v)  # bob never starts -> send must fail
    import time

    time.sleep(60)
    fed.shutdown()


def test_send_failure_when_peer_never_starts():
    addresses = get_addresses(["alice", "bob"])
    q = multiprocessing.get_context("spawn").Queue()
    alice = MP.Process(target=run_peer_never_starts, args=("alice", addresses, q))
    alice.start()
    alice.join(timeout=120)
    assert alice.exitcode == 1, alice.exitcode
    assert q.get(timeout=10) == "ConnectionError"


def run_barrier(party, addresses):
    fed.init(
        addresses=addresses,
        party=party,
        config={
            "cross_silo_comm": dict(FAST_COMM_CONFIG),
            "barrier_on_initializing": True,
        },
    )
    # Barrier passed -> both receivers were reachable before any task ran
    # (ref fed/tests/test_ping_others.py).
    fed.shutdown()


def test_ping_others_barrier():
    run_parties(run_barrier, ["alice", "bob"])


def test_ping_others_down_peer_keeps_cadence():
    """A still-down peer costs ONE outstanding ping, polled on the
    cadence — not a new multi-second send job piled into the worker
    queue every cycle (VERDICT r2 weak #8) and not a skipped cycle that
    races a peer exiting right after its own barrier passes."""
    import time
    from concurrent.futures import Future

    import pytest

    from rayfed_tpu_torch.proxy import barriers

    calls = []

    class _NeverResolvingSender:
        def send(self, dest, *a, **k):
            calls.append(dest)
            return Future()  # in flight forever (peer never comes up)

    old = barriers._sender_proxies.peek()
    barriers._sender_proxies.set(_NeverResolvingSender())
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="Failed to wait"):
            barriers.ping_others(
                {"alice": "127.0.0.1:1", "bob": "127.0.0.1:2"},
                "alice", max_retries=4, interval_s=0.2,
            )
        elapsed = time.perf_counter() - t0
    finally:
        if old is None:
            barriers._sender_proxies.pop()
        else:
            barriers._sender_proxies.set(old)
    # Exactly one ping stays in flight for the down peer across all
    # cycles (the data lane retries inside it).
    assert calls == ["bob"], calls
    # 4 cycles x ~0.2s cadence plus slack — not 4 x a multi-second
    # send/retry budget.
    assert elapsed < 10, elapsed


def test_ping_others_mutual_and_grace():
    """ping_others passes only after mutual contact when attribution is
    available; a peer that answers pings but never pings back (barrier
    disabled on its side, or src-less reference wire) is released after
    the bounded grace instead of blocking forever."""
    from concurrent.futures import Future

    from rayfed_tpu_torch.proxy import barriers

    class _OkSender:
        def send(self, dest, *a, **k):
            f = Future()
            f.set_result(True)
            return f

    class _Recv:
        def __init__(self, srcs=(), anon=0):
            self._srcs, self._anon = set(srcs), anon

        def ping_sources(self):
            return set(self._srcs), self._anon

    old_s = barriers._sender_proxies.peek()
    old_r = barriers._receiver_proxies.peek()
    try:
        barriers._sender_proxies.set(_OkSender())
        # Mutual: bob pinged us -> immediate pass, no grace burned.
        barriers._receiver_proxies.set(_Recv(srcs={"bob"}))
        assert barriers.ping_others(
            {"alice": "a:1", "bob": "b:1"}, "alice",
            max_retries=3, interval_s=0.02,
        )
        # Anonymous ping covers an unattributable peer (reference wire).
        barriers._receiver_proxies.set(_Recv(anon=1))
        assert barriers.ping_others(
            {"alice": "a:1", "bob": "b:1"}, "alice",
            max_retries=3, interval_s=0.02,
        )
        # Never pinged back: released after the grace cycles.
        barriers._receiver_proxies.set(_Recv())
        assert barriers.ping_others(
            {"alice": "a:1", "bob": "b:1"}, "alice",
            max_retries=barriers._MUTUAL_GRACE_CYCLES + 3, interval_s=0.02,
        )

        # A backend whose wire can never attribute pings (ping_sources()
        # -> None, e.g. the reference gRPC wire) skips the mutual wait
        # outright — no grace burned on every init.
        import time as _time

        class _NoAttr:
            def ping_sources(self):
                return None

        barriers._receiver_proxies.set(_NoAttr())
        t0 = _time.perf_counter()
        assert barriers.ping_others(
            {"alice": "a:1", "bob": "b:1"}, "alice",
            max_retries=3, interval_s=0.5,
        )
        assert _time.perf_counter() - t0 < 1.0  # << grace (5 x 0.5s)
    finally:
        for slot, old in ((barriers._sender_proxies, old_s),
                          (barriers._receiver_proxies, old_r)):
            if old is None:
                slot.pop()
            else:
                slot.set(old)


def test_ping_sources_backend_capabilities():
    """The combined TCP proxy delegates ping attribution to its inner
    receiver. (The JAX package's gRPC receiver, which declares
    attribution unsupported, has no counterpart in the port yet.)"""
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpSenderReceiverProxy

    assert "ping_sources" in TcpSenderReceiverProxy.__dict__


def test_store_records_ping_sources():
    """Ping frames are acked + attributed, never parked in the store."""
    from rayfed_tpu_torch._private.constants import CODE_OK
    from rayfed_tpu_torch.proxy.rendezvous import RendezvousStore

    store = RendezvousStore("jobx", decode_fn=lambda h, p: p)
    try:
        hdr = {"job": "jobx", "up": "ping", "down": "ping", "src": "bob"}
        assert store.offer(hdr, b"ping") == (CODE_OK, "ping")
        anon = {"job": "jobx", "up": "ping", "down": "ping", "src": ""}
        assert store.offer(anon, b"ping") == (CODE_OK, "ping")
        srcs, n_anon = store.ping_sources()
        assert srcs == {"bob"} and n_anon == 1
        assert not store._arrived  # pings never park in the store
        # Job isolation still applies to pings.
        bad = {"job": "other", "up": "ping", "down": "ping", "src": "eve"}
        code, _ = store.offer(bad, b"ping")
        assert code != CODE_OK
        assert store.ping_sources()[0] == {"bob"}
    finally:
        store.shutdown()


def run_recv_timeout_dead_peer(party, addresses, transport, q):
    import time

    fed.init(
        addresses=addresses,
        party=party,
        config={
            "transport": transport,
            "cross_silo_comm": {
                **FAST_COMM_CONFIG,
                "recv_timeout_in_ms": 2000,
            },
        },
    )
    t0 = time.monotonic()
    fut = fed.recv(party, "bob", 1, 1)
    try:
        fut.result(timeout=60)
        q.put(("no-error", 0.0))
    except Exception as e:  # noqa: BLE001
        q.put((type(e).__name__, time.monotonic() - t0))
    fed.shutdown()


@pytest.mark.parametrize("transport", ["tcp"])
def test_recv_from_dead_peer_times_out(transport):
    """A recv whose peer never starts fails with TimeoutError after
    recv_timeout_in_ms on EVERY transport — bounded, not a hang. The
    timeout fires in the local rendezvous store, so the semantics must
    not depend on which wire carries the data (docs/resilience.md)."""
    addresses = get_addresses(["alice", "bob"])
    q = multiprocessing.get_context("spawn").Queue()
    alice = MP.Process(
        target=run_recv_timeout_dead_peer,
        args=("alice", addresses, transport, q),
    )
    alice.start()
    try:
        kind, elapsed = q.get(timeout=90)
        assert kind == "TimeoutError", kind
        # Fired by the store's expire loop near the 2s deadline, not by
        # the 60s result() backstop.
        assert elapsed < 30, elapsed
        alice.join(timeout=60)
        assert alice.exitcode == 0, alice.exitcode
    finally:
        if alice.is_alive():
            alice.terminate()
            alice.join(timeout=30)


def run_victim(party, addresses, q):
    fed.init(
        addresses=addresses,
        party=party,
        config={
            "cross_silo_comm": {
                "retry_policy": {
                    "max_attempts": 3,
                    "initial_backoff_ms": 100,
                    "max_backoff_ms": 300,
                },
                "timeout_in_ms": 4000,
                "recv_timeout_in_ms": 8000,
                "exit_on_sending_failure": True,
            }
        },
        sending_failure_handler=lambda e: q.put("handler-fired"),
    )

    @fed.remote
    def stream(i):
        import torch

        return torch.full((1 << 20,), float(i), dtype=torch.float32)

    @fed.remote
    def sink(x):
        if party == "bob" and float(x[0]) == 1.0:
            import os

            os._exit(17)  # simulate a hard crash mid-stream
        return float(x[0])

    import time

    crashed = False
    for i in range(8):
        # Keep pushing even after the crash is detected: the failing pushes
        # are what drive the drain thread's exit signal on alice.
        out = sink.party("bob").remote(stream.party("alice").remote(float(i)))
        if not crashed:
            try:
                fed.get(out)
            except Exception:
                crashed = True
        time.sleep(0.2)
    time.sleep(60)  # SIGINT from drain interrupts (alice) after bob dies
    fed.shutdown()


def test_peer_crash_mid_stream_is_detected():
    """Bob hard-crashes (os._exit) mid-run: alice's pipelined sends fail
    after the reconnect budget, the failure handler fires, and alice exits
    1 instead of hanging."""
    addresses = get_addresses(["alice", "bob"])
    q = multiprocessing.get_context("spawn").Queue()
    alice = MP.Process(target=run_victim, args=("alice", addresses, q))
    bob = MP.Process(target=run_victim, args=("bob", addresses, q))
    try:
        alice.start()
        bob.start()
        bob.join(timeout=120)
        assert bob.exitcode == 17, bob.exitcode
        alice.join(timeout=120)
        assert alice.exitcode == 1, alice.exitcode
        assert q.get(timeout=10) == "handler-fired"
    finally:
        # A failed assert must not wedge pytest behind live non-daemon
        # children (multiprocessing joins them at interpreter exit).
        for p in (alice, bob):
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
