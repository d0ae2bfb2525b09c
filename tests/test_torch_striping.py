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

"""The port's striped (multi-stream) data plane against the JAX
package's functions on the same inputs: ``serialization.plan_stripes``
gives the same plan, the stripe frames cut from a torch tree carry the
bytes and descriptors of those cut from the numpy tree, and either
package's ``rendezvous.StripeAssembler`` reassembles the other's frames
with the same verdicts. Then the assertions of ``test_multistream.py``
(which cannot be collected under jax 0.9.0) on the port: the assembler's
cases, a torch tree round-tripping byte-identical through K in {1, 2, 4}
stripe lanes, and a mid-transfer stream drop resumed by the lane's
resend.
"""

import random
import socket
import threading

import numpy as np
import pytest
import torch

from rayfed_tpu._private import serialization as jser
from rayfed_tpu.proxy import rendezvous as jrendezvous
from rayfed_tpu_torch._private import serialization as ser
from rayfed_tpu_torch._private.constants import CODE_INTERNAL_ERROR, CODE_OK
from rayfed_tpu_torch.proxy import rendezvous
from rayfed_tpu_torch.proxy.tcp import reactor
from tests.utils import get_addresses

FAST = {"retry_policy": {"max_attempts": 8, "initial_backoff_ms": 100}}

_BUFFER_LISTS = {
    "mixed": [b"a" * 100, b"b" * 300, b"", b"c" * 250, b"d" * 50, b"e" * 300],
    "equal": [bytes([i]) * 4096 for i in range(8)],
    "one_big": [b"x" * 10, b"y" * 100_000, b"z" * 10, b"w" * 7],
    "empties": [b"", b"q" * 33, b"", b"", b"r" * 65, b""],
}


@pytest.fixture
def min_bytes_1(monkeypatch):
    monkeypatch.setattr(ser, "STRIPE_MIN_BYTES", 1)
    monkeypatch.setattr(jser, "STRIPE_MIN_BYTES", 1)


def _plan_bytes(plan):
    if plan is None:
        return None
    return [(soff, [bytes(b) for b in bufs], nbytes, list(segs))
            for soff, bufs, nbytes, segs in plan]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("name", sorted(_BUFFER_LISTS))
def test_plan_stripes_equals_the_jax_package(min_bytes_1, name, k):
    buffers = _BUFFER_LISTS[name]
    assert _plan_bytes(ser.plan_stripes(buffers, k)) == _plan_bytes(
        jser.plan_stripes(buffers, k))


def test_plan_stripes_tiles_and_balances(min_bytes_1):
    buffers = _BUFFER_LISTS["mixed"]
    plan = ser.plan_stripes(buffers, 3)
    assert plan is not None and len(plan) == 3
    pos = 0
    for soff, bufs, nbytes, segs in plan:
        assert soff == pos  # contiguous tiling, zero-size buffers skipped
        assert nbytes == sum(len(b) for b in bufs)
        assert nbytes > 0
        assert sum(segs) == nbytes  # per-stripe scatter plan covers it
        pos += nbytes
    assert pos == sum(len(b) for b in buffers)
    # Splits land only at buffer boundaries: reassembling the stripes'
    # buffer lists must give back the non-empty originals in order.
    flat = [b for _, bufs, _, _ in plan for b in bufs]
    assert flat == [b for b in buffers if b]


def test_plan_stripes_declines_when_pointless(monkeypatch):
    monkeypatch.setattr(ser, "STRIPE_MIN_BYTES", 1)
    assert ser.plan_stripes([b"x" * 4096], 4) is None  # one buffer
    assert ser.plan_stripes([b"x" * 4096, b"y"], 1) is None  # one lane
    monkeypatch.setattr(ser, "STRIPE_MIN_BYTES", 1 << 20)
    assert ser.plan_stripes([b"x" * 4096, b"y" * 4096], 4) is None  # small


# ---------------------------------------------------------------------------
# Stripe frames, cut as the sender cuts them
# ---------------------------------------------------------------------------


def _numpy_tree():
    return {f"p{i}": np.arange(1024, dtype=np.float32) + i for i in range(8)}


def _torch_tree():
    return {k: torch.from_numpy(v) for k, v in _numpy_tree().items()}


def _stripe_frames(k, module=ser, tree=None):
    """Encode a tree and cut it into stripe frames the way the sender
    does, returning (frames, meta_bytes, flat_payload_bytes)."""
    if tree is None:
        tree = _torch_tree()
    kind, meta, buffers = module.encode_payload(tree)
    assert kind == "tree"
    plan = module.plan_stripes(buffers, k)
    assert plan is not None
    base = {"job": "job", "src": "alice", "up": "1#0", "down": "2",
            "is_error": False, "pkind": "tree", "pmeta": meta}
    frames = []
    n = len(plan)
    total = sum(module.buffer_nbytes(b) for b in buffers)
    for i, (soff, bufs, nbytes, segs) in enumerate(plan):
        h = dict(base)
        h["pkind"] = "stripe"
        h["sd"] = {"i": i, "n": n, "off": soff, "tot": total, "segs": segs}
        if i == 0:
            h["pk"] = "tree"
        else:
            h["pmeta"] = b""
        frames.append((h, bytes(module.concat_buffers(bufs))))
    return frames, meta, bytes(module.concat_buffers(buffers))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_torch_tree_stripes_equal_the_numpy_trees(min_bytes_1, k):
    frames_t, meta_t, flat_t = _stripe_frames(k, ser, _torch_tree())
    frames_n, meta_n, flat_n = _stripe_frames(k, jser, _numpy_tree())
    assert meta_t == meta_n and flat_t == flat_n
    assert frames_t == frames_n


@pytest.mark.parametrize("direction", ["torch_frames-jax_assembler",
                                       "jax_frames-torch_assembler"])
def test_assembler_takes_the_other_packages_stripes(min_bytes_1, direction):
    if direction == "torch_frames-jax_assembler":
        frames, meta, flat = _stripe_frames(4, ser, _torch_tree())
        asm_cls = jrendezvous.StripeAssembler
        decode = jser.decode_payload
    else:
        frames, meta, flat = _stripe_frames(4, jser, _numpy_tree())
        asm_cls = rendezvous.StripeAssembler
        decode = ser.decode_payload
    captured = []
    asm = asm_cls(lambda h, p: captured.append((h, p)) or (CODE_OK, "stored"))
    order = [2, 0, 3, 1]
    verdicts = [asm.offer(dict(frames[j][0]), frames[j][1]) for j in order]
    assert verdicts == [(CODE_OK, "stripe buffered")] * 3 + [(CODE_OK,
                                                              "stored")]
    (header, payload), = captured
    assert header["pkind"] == "tree" and header["pmeta"] == meta
    assert payload.tobytes() == flat
    got = decode("tree", header["pmeta"], payload)
    for k, v in _numpy_tree().items():
        assert np.asarray(got[k]).tobytes() == v.tobytes(), k


# ---------------------------------------------------------------------------
# StripeAssembler (test_multistream.py's cases on the port)
# ---------------------------------------------------------------------------


def test_assembler_reassembles_any_arrival_order(min_bytes_1):
    frames, meta, flat = _stripe_frames(4)
    for seed in range(3):
        order = list(range(len(frames)))
        random.Random(seed).shuffle(order)
        captured = []

        def offer(header, payload):
            captured.append((header, payload))
            return CODE_OK, "stored"

        asm = rendezvous.StripeAssembler(offer)
        for j in order[:-1]:
            code, msg = asm.offer(dict(frames[j][0]), frames[j][1])
            assert (code, msg) == (CODE_OK, "stripe buffered")
        code, msg = asm.offer(dict(frames[order[-1]][0]), frames[order[-1]][1])
        assert (code, msg) == (CODE_OK, "stored")  # inner verdict surfaced
        (header, payload), = captured
        assert header["pkind"] == "tree"
        assert header["pmeta"] == meta
        assert "sd" not in header and "pk" not in header
        assert isinstance(payload, ser.SegmentedPayload)
        assert payload.tobytes() == flat


def test_assembler_duplicates_and_late_arrivals(min_bytes_1):
    frames, _, _ = _stripe_frames(2)
    hits = []
    asm = rendezvous.StripeAssembler(
        lambda h, p: hits.append(1) or (CODE_OK, "stored")
    )
    assert asm.offer(dict(frames[0][0]), frames[0][1])[1] == "stripe buffered"
    # Resent stripe (lost ack) before completion: absorbed, not double-counted.
    assert asm.offer(dict(frames[0][0]), frames[0][1])[1] == "duplicate stripe"
    assert asm.offer(dict(frames[1][0]), frames[1][1])[1] == "stored"
    # Resent stripe after completion: acked OK so the sender's retry ends.
    assert asm.offer(dict(frames[1][0]), frames[1][1])[1] == (
        "duplicate stripe group"
    )
    assert hits == [1]


def test_assembler_rejects_inconsistent_descriptors(min_bytes_1):
    frames, _, _ = _stripe_frames(2)
    asm = rendezvous.StripeAssembler(lambda h, p: (CODE_OK, "stored"))
    assert asm.offer(dict(frames[0][0]), frames[0][1])[0] == CODE_OK
    bad = dict(frames[1][0])
    bad["sd"] = dict(bad["sd"], tot=bad["sd"]["tot"] + 1)
    code, msg = asm.offer(bad, frames[1][1])
    assert code == CODE_INTERNAL_ERROR and "disagrees" in msg
    # Oversized declared total is refused before buffering a byte.
    big = dict(frames[0][0], up="9#9")
    big["sd"] = dict(big["sd"], tot=1 << 40)
    small_cap = rendezvous.StripeAssembler(
        lambda h, p: (CODE_OK, "stored"), max_payload_bytes=1 << 20
    )
    code, msg = small_cap.offer(big, frames[0][1])
    assert code == CODE_INTERNAL_ERROR and "exceeding" in msg


def test_assembler_passthrough_non_stripe():
    seen = []
    asm = rendezvous.StripeAssembler(
        lambda h, p: seen.append((h, p)) or (CODE_OK, "stored")
    )
    h = {"pkind": "tree", "pmeta": b"m"}
    assert asm.offer(h, b"payload") == (CODE_OK, "stored")
    assert seen == [(h, b"payload")]


# ---------------------------------------------------------------------------
# End to end: K-lane round trip over the port's TCP proxies
# ---------------------------------------------------------------------------

needs_reactor = pytest.mark.skipif(
    not reactor.available(), reason="epoll not available on this platform"
)


def _big_tree():
    # "w": 2 MB in four rows (512 KB each), "p": 64 KB, "b": tiny; the
    # buffers are the leaves, so stripes split between them.
    host = {
        "w": np.arange(4 * 131072, dtype=np.float32).reshape(4, 131072),
        "p": np.arange(4 * 4096, dtype=np.float32).reshape(4, 4096),
        "b": np.arange(16, dtype=np.float32),
    }
    tree = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    tree["w2"] = tree["w"][2:].clone()  # a second large leaf
    host["w2"] = host["w"][2:]
    return tree, host


@needs_reactor
@pytest.mark.parametrize("streams", [1, 2, 4])
def test_multistream_roundtrip_byte_identical(monkeypatch, streams):
    from rayfed_tpu_torch.proxy.tcp import sockio
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import (
        TcpReceiverProxy,
        TcpSenderProxy,
    )

    # Force scatter reads so stripe segment plans are exercised too.
    monkeypatch.setattr(sockio, "_SEGMENT_THRESHOLD", 1)

    cfg = dict(FAST, num_streams=streams)
    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", None, dict(cfg))
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = TcpSenderProxy(addr, "alice", "job", None, dict(cfg))
    sp.start()
    try:
        tree, hosts = _big_tree()
        for rnd in range(2):  # second round reuses the warm lanes
            fut = rp.get_data("alice", f"{rnd}#0", rnd + 1)
            assert sp.send("bob", tree, f"{rnd}#0", rnd + 1).result(timeout=60)
            got = fut.result(timeout=60)
            for k, host in hosts.items():
                assert isinstance(got[k], torch.Tensor), k
                out = got[k].numpy()
                assert out.dtype == host.dtype
                assert out.tobytes() == host.tobytes()  # byte-identical
        if streams > 1:
            worker = sp._workers["bob"]
            assert len(worker._lanes) == streams
    finally:
        sp.stop()
        rp.stop()


class _FlakyForwarder:
    """TCP forwarder that kills its Nth accepted connection (both sides)
    after relaying a few KB client->server — a mid-transfer stream drop
    on exactly one of the sender's stripe lanes. Later connections relay
    cleanly, so the lane's redial succeeds and resends unacked frames."""

    def __init__(self, target, drop_conn_index=2, drop_after=4096):
        self._target = target
        self._drop_index = drop_conn_index
        self._drop_after = drop_after
        self.conn_count = 0
        self.dropped = threading.Event()
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(16)
        self.addr = "{}:{}".format(*self._srv.getsockname())
        self._stopped = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stopped:
            try:
                client, _ = self._srv.accept()
            except OSError:
                return
            self.conn_count += 1
            doomed = self.conn_count == self._drop_index
            host, port = self._target.rsplit(":", 1)
            try:
                upstream = socket.create_connection((host, int(port)),
                                                    timeout=10)
            except OSError:
                client.close()
                continue
            budget = [self._drop_after] if doomed else None
            for src, dst in ((client, upstream), (upstream, client)):
                threading.Thread(
                    target=self._pump,
                    args=(src, dst, budget if src is client else None,
                          (client, upstream)),
                    daemon=True,
                ).start()

    def _pump(self, src, dst, budget, pair):
        try:
            while True:
                chunk = src.recv(65536)
                if not chunk:
                    break
                if budget is not None:
                    take = min(len(chunk), budget[0])
                    if take:
                        dst.sendall(chunk[:take])
                    budget[0] -= take
                    if budget[0] <= 0:
                        self.dropped.set()
                        break
                    continue
                dst.sendall(chunk)
        except OSError:
            pass
        finally:
            for s in pair:
                try:
                    s.close()
                except OSError:
                    pass

    def close(self):
        self._stopped = True
        try:
            self._srv.close()
        except OSError:
            pass


@needs_reactor
def test_midtransfer_stream_drop_resumed_by_resend():
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import (
        TcpReceiverProxy,
        TcpSenderProxy,
    )

    addr = get_addresses(["bob"])
    rp = TcpReceiverProxy(addr["bob"], "bob", "job", None, dict(FAST))
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    fwd = _FlakyForwarder(addr["bob"], drop_conn_index=2, drop_after=4096)
    cfg = dict(FAST, num_streams=2)
    sp = TcpSenderProxy({"bob": fwd.addr}, "alice", "job", None, dict(cfg))
    sp.start()
    try:
        tree, hosts = _big_tree()
        fut = rp.get_data("alice", "1#0", 2)
        assert sp.send("bob", tree, "1#0", 2).result(timeout=90)
        got = fut.result(timeout=90)
        for k, host in hosts.items():
            assert got[k].numpy().tobytes() == host.tobytes()
        assert fwd.dropped.is_set()  # the drop actually happened
        assert fwd.conn_count >= 3  # and a redial followed it
    finally:
        sp.stop()
        rp.stop()
        fwd.close()
