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

"""Edge-case tests for the epoll reactor transport, on the port (the JAX
package's ``test_reactor.py`` mirrored). Here the reactor runs the native
lane: its batched ``flush_many`` and nonblocking ``sendv_nb`` /
``recv_into_nb`` from ``rayfed_tpu_torch._fastwire``.

These drive :class:`~rayfed_tpu_torch.proxy.tcp.reactor.ReactorLane` directly
against a scriptable ack server so the awkward interleavings — peer gone
mid-frame, send ring full, inline lane racing the loop — are forced, not
hoped for. The proxy-level suites (test_transports, test_proxy_modes)
cover the happy paths; here every test is a specific failure geometry.
"""

import socket
import threading
import time
from concurrent.futures import Future

import pytest

from rayfed_tpu_torch._private.constants import CODE_OK
from rayfed_tpu_torch.proxy.tcp import reactor, sockio, wire
from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy, TcpSenderProxy
from tests.utils import get_addresses

pytestmark = pytest.mark.skipif(
    not reactor.available(), reason="epoll not available on this platform"
)

FAST = {"retry_policy": {"max_attempts": 5, "initial_backoff_ms": 100}}


def test_the_reactor_runs_the_native_lane():
    fw = reactor._native()
    assert fw is not None and fw is sockio._fastwire
    assert all(hasattr(fw, f) for f in ("flush_many", "sendv_nb",
                                        "recv_into_nb"))


class _AckServer:
    """Minimal FTP1 ack server with scriptable misbehavior: drop the
    first connection after N raw bytes (mid-frame disconnect), park reads
    (fills the sender's kernel buffer, then its ring), park acks (fills
    the send window)."""

    def __init__(self):
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(16)
        self.addr = self._srv.getsockname()
        self.frames = []  # (header, payload_len) in arrival order
        self.conn_count = 0
        self.drop_first_conn_after_bytes = None
        self.read_gate = threading.Event()
        self.read_gate.set()
        self.ack_gate = threading.Event()
        self.ack_gate.set()
        self._lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stopped:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self.conn_count += 1
                first = self.conn_count == 1
            if first and self.drop_first_conn_after_bytes is not None:
                try:
                    need = self.drop_first_conn_after_bytes
                    got = 0
                    conn.settimeout(10)
                    while got < need:
                        chunk = conn.recv(need - got)
                        if not chunk:
                            break
                        got += len(chunk)
                finally:
                    conn.close()  # mid-frame: no complete frame was read
                continue
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn):
        conn.settimeout(30)
        try:
            while True:
                self.read_gate.wait(30)
                ftype, header, payload = sockio.recv_frame(conn)
                with self._lock:
                    self.frames.append(
                        (header, memoryview(bytes(payload)).nbytes)
                    )
                self.ack_gate.wait(30)
                sockio.send_frame(
                    conn, wire.FTYPE_RESP,
                    {"code": CODE_OK, "msg": "",
                     "fseq": header.get("fseq")},
                )
        except Exception:  # noqa: BLE001 - EOF/reset ends the connection
            pass
        finally:
            conn.close()

    def close(self):
        self._stopped = True
        try:
            self._srv.close()
        except OSError:
            pass


def _make_lane(server, window=4, small_threshold=0, max_attempts=3,
               ack_timeout_s=10.0):
    def connect(attempts):
        try:
            return socket.create_connection(server.addr, timeout=5)
        except OSError as e:
            raise ConnectionError(str(e)) from e

    return reactor.ReactorLane(
        "bob", connect, max_attempts=max_attempts,
        ack_timeout_s=ack_timeout_s, on_ack=lambda: None,
        window=window, small_threshold=small_threshold,
    )


def _submit(lane, i, payload):
    out = Future()
    lane.submit(out, {"seq": f"{i}#0", "i": i}, [payload], len(payload))
    return out


def test_burst_roundtrip_order_and_window_restore():
    srv = _AckServer()
    lane = _make_lane(srv, window=4)
    try:
        futs = [_submit(lane, i, b"x" * 256) for i in range(50)]
        assert all(f.result(timeout=30) for f in futs)
        # Pipelined over one connection: arrival order == submission order.
        assert [h["i"] for h, _ in srv.frames] == list(range(50))
        # Every window slot returned (the observability contract:
        # occupancy is readable off the semaphore).
        deadline = time.monotonic() + 5
        while lane._window._value < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lane._window._value == 4
    finally:
        lane.close()
        srv.close()


def test_peer_disconnect_mid_frame_resends_on_new_connection():
    srv = _AckServer()
    # First connection dies after 10 bytes — inside the 18-byte prefix of
    # frame 1. The lane must treat it as a break, redial, and resend.
    srv.drop_first_conn_after_bytes = 10
    lane = _make_lane(srv)
    try:
        fut = _submit(lane, 0, b"p" * 65536)
        assert fut.result(timeout=30) is True
        assert srv.conn_count >= 2
        # The torn connection parsed no frame; the retry delivered one.
        assert [h["i"] for h, _ in srv.frames] == [0]
        assert srv.frames[0][1] == 65536
    finally:
        lane.close()
        srv.close()


def test_peer_disconnect_mid_frame_fails_after_attempt_budget():
    srv = _AckServer()
    srv.drop_first_conn_after_bytes = 10
    # Every reconnect lands on a healthy server thread, so make the
    # FIRST failure terminal: budget of 1 attempt.
    lane = _make_lane(srv, max_attempts=1)
    try:
        fut = _submit(lane, 0, b"p" * 65536)
        with pytest.raises(ConnectionError, match="after 1 attempts"):
            fut.result(timeout=30)
    finally:
        lane.close()
        srv.close()


def test_full_send_ring_write_interest_churn():
    """Stall the peer's reads so the kernel buffer and then the send ring
    fill (partial writes -> EPOLLOUT raised), drain, stall again, drain —
    the interest churn must not wedge or reorder anything."""
    srv = _AckServer()
    lane = _make_lane(srv, window=8)
    try:
        futs = []
        seq = 0
        for cycle in range(2):
            srv.read_gate.clear()
            for _ in range(6):
                futs.append(_submit(lane, seq, b"y" * (1 << 20)))
                seq += 1
            time.sleep(0.3)  # let the ring hit the full-buffer wall
            srv.read_gate.set()
            for f in futs:
                assert f.result(timeout=60) is True
        assert [h["i"] for h, _ in srv.frames] == list(range(seq))
        assert all(n == 1 << 20 for _, n in srv.frames)
    finally:
        lane.close()
        srv.close()


def test_inline_lane_vs_reactor_ownership_race():
    """Hammer the inline small-send gate from many threads while large
    frames force the reactor path concurrently. Frame bytes interleaving
    on the wire would show up as a WireError on the server (it parses a
    strict frame stream) or a hung future; neither may happen."""
    srv = _AckServer()
    lane = _make_lane(srv, window=8, small_threshold=8192)
    n_threads, per_thread = 6, 25
    results = [[] for _ in range(n_threads)]
    try:
        def worker(t):
            for k in range(per_thread):
                i = t * per_thread + k
                results[t].append(_submit(lane, i, b"s" * 512))

        threads = [
            threading.Thread(target=worker, args=(t,))
            for t in range(n_threads)
        ]
        for th in threads:
            th.start()
        # Interleave large (reactor-path) frames from this thread.
        big = [
            _submit(lane, 10_000 + j, b"B" * 65536) for j in range(10)
        ]
        for th in threads:
            th.join(30)
        futs = [f for lst in results for f in lst] + big
        assert all(f.result(timeout=60) is True for f in futs)
        got = sorted(h["i"] for h, _ in srv.frames)
        want = sorted(
            list(range(n_threads * per_thread))
            + [10_000 + j for j in range(10)]
        )
        assert got == want
    finally:
        lane.close()
        srv.close()


def test_ack_timeout_expires_head_frame():
    srv = _AckServer()
    srv.ack_gate.clear()  # receive but never ack
    lane = _make_lane(srv, window=2, max_attempts=1, ack_timeout_s=0.5)
    try:
        fut = _submit(lane, 0, b"z" * 128)
        with pytest.raises((TimeoutError, ConnectionError)):
            fut.result(timeout=30)
    finally:
        srv.ack_gate.set()
        lane.close()
        srv.close()


def test_close_fails_queued_frames():
    srv = _AckServer()
    srv.ack_gate.clear()  # park everything in flight
    lane = _make_lane(srv, window=2)
    try:
        futs = [_submit(lane, i, b"q" * 128) for i in range(6)]
        time.sleep(0.3)
        lane.close()
        for f in futs:
            with pytest.raises(ConnectionError, match="sender stopped"):
                f.result(timeout=10)
    finally:
        srv.ack_gate.set()
        srv.close()


def test_receiver_survives_client_disconnect_mid_frame():
    """A client that dies halfway through a frame must cost the receiver
    one ServerConnection, not the accept loop or the store: a real
    sender on a fresh connection still gets through."""
    import numpy as np

    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", None, dict(FAST))
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = None
    try:
        host, port = addr["bob"].rsplit(":", 1)
        # Valid prefix + header, then 100 of 1000 payload bytes, then RST.
        raw = socket.create_connection((host, int(port)), timeout=5)
        blob = wire.encode_prefix_and_header(
            wire.FTYPE_DATA, {"seq": "1#0", "fseq": 1}, 1000
        )
        raw.sendall(blob + b"x" * 100)
        raw.close()
        time.sleep(0.2)

        sp = TcpSenderProxy(addr, "alice", "job", None, dict(FAST))
        sp.start()
        fut = sp.send("bob", {"a": np.arange(8, dtype=np.int32)}, "2#0", 2)
        assert fut.result(timeout=30) is True
        got = rp.get_data("alice", "2#0", 2).result(timeout=30)
        assert got["a"][3] == 3
    finally:
        if sp is not None:
            sp.stop()
        rp.stop()


def test_reactor_pool_refcount():
    r1 = reactor.acquire_reactors(2)
    r2 = reactor.acquire_reactors(2)
    assert r1 == r2 and len(r1) == 2
    assert all(r.is_alive() for r in r1)
    reactor.release_reactors()
    assert all(r.is_alive() for r in r1)  # still referenced
    reactor.release_reactors()
    deadline = time.monotonic() + 5
    while any(r.is_alive() for r in r1) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not any(r.is_alive() for r in r1)
