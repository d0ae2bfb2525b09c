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

"""Frame IO unit tests over socketpair, on the port's ``sockio`` (the JAX
package's ``test_sockio.py`` mirrored): the native lane
(``rayfed_tpu_torch._fastwire``, built here by the C++ compiler) and the
pure-Python path must be wire-compatible."""

import socket
import threading

import numpy as np
import pytest

from rayfed_tpu_torch.proxy.tcp import sockio, wire


def roundtrip_frame(header, buffers, max_payload=None, force_python=False):
    a, b = socket.socketpair()
    result = {}

    def reader():
        try:
            result["frame"] = sockio.recv_frame(b, max_payload=max_payload)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test
            result["error"] = e

    # Swap the lane BEFORE the reader thread starts and restore only
    # after it joins: recv_frame snapshots sockio._fastwire once at
    # entry, so flipping it mid-frame under the reader's feet would race
    # (the [True] param flaked exactly that way before the snapshot).
    old = sockio._fastwire
    if force_python:
        sockio._fastwire = None
    t = threading.Thread(target=reader)
    t.start()
    try:
        sockio.send_frame(a, wire.FTYPE_DATA, header, buffers)
        t.join(timeout=10)
    finally:
        sockio._fastwire = old
        a.close()
        b.close()
    assert not t.is_alive(), "reader thread did not finish within 10s"
    if "error" in result:
        raise result["error"]
    return result["frame"]


@pytest.mark.parametrize("force_python", [False, True])
def test_frame_roundtrip(force_python):
    header = {"job": "j", "up": "1#0", "down": "2", "pkind": "tree",
              "pmeta": b"\x80", "is_error": False, "src": "alice"}
    payload = np.arange(1000, dtype=np.float64)
    ftype, got_header, got_payload = roundtrip_frame(
        header, [payload], force_python=force_python
    )
    assert ftype == wire.FTYPE_DATA
    assert got_header == header
    np.testing.assert_array_equal(
        np.frombuffer(got_payload, np.float64), payload
    )
    # Received payloads must be writable (consumers may mutate in place).
    arr = np.frombuffer(got_payload, np.float64)
    arr[0] = -1.0


def test_empty_payload():
    ftype, header, payload = roundtrip_frame({"code": 200, "msg": "ok"}, [])
    assert payload.nbytes == 0


def test_oversized_frame_rejected_before_buffering():
    a, b = socket.socketpair()
    # Hand-craft a prefix claiming a 1GB payload with a 1MB cap.
    a.sendall(wire.encode_prefix_and_header(wire.FTYPE_DATA, {}, 1 << 30))
    with pytest.raises(wire.WireError, match="exceeds cap"):
        sockio.recv_frame(b, max_payload=1 << 20)
    a.close()
    b.close()


def test_multi_buffer_send():
    bufs = [np.ones(10, np.float32), b"tail-bytes", np.zeros(3, np.int64)]
    ftype, header, payload = roundtrip_frame({"k": 1}, bufs)
    total = sum(memoryview(wire.as_byte_view(x)).nbytes for x in bufs)
    assert payload.nbytes == total


def test_fastwire_timeout():
    assert sockio.io_path() == "native"
    a, b = socket.socketpair()
    b.settimeout(0.2)
    buf = bytearray(10)
    with pytest.raises((socket.timeout, TimeoutError)):
        sockio._recv_exact_into(b, memoryview(buf))
    a.close()
    b.close()

class TestBufferPool:
    def test_small_requests_bypass_pool(self):
        pool = sockio.BufferPool(max_bytes=1 << 30, min_size=1 << 20)
        a = pool.take(100)
        assert a.nbytes == 100
        assert pool._entries == []

    def test_reuse_after_views_die(self):
        import weakref

        pool = sockio.BufferPool(max_bytes=1 << 30, min_size=16)
        a = pool.take(1024)
        block = weakref.ref(a.base)  # a strong ref would block reuse
        assert block() is not None
        del a  # consumer dropped every view
        b = pool.take(1024)
        assert b.base is block()  # same block recycled
        assert len(pool._entries) == 1

    def test_no_reuse_while_view_alive(self):
        pool = sockio.BufferPool(max_bytes=1 << 30, min_size=16)
        a = pool.take(1024)
        a[:] = 7
        b = pool.take(1024)  # a still alive -> must get a fresh block
        b[:] = 9
        assert a.base is not b.base
        assert (a == 7).all()

    def test_derived_numpy_view_keeps_block_busy(self):
        # The delivery path hands consumers np.frombuffer views of the
        # recv buffer; those must keep the block out of the free list.
        import weakref

        pool = sockio.BufferPool(max_bytes=1 << 30, min_size=16)
        a = pool.take(1024)
        a[:] = 3
        consumer = np.frombuffer(memoryview(a), dtype=np.uint8)
        block = weakref.ref(a.base)
        del a
        b = pool.take(1024)
        assert b.base is not block()  # consumer view keeps block busy
        b[:] = 9
        assert (consumer == 3).all()  # consumer data untouched
        del consumer
        d = pool.take(1024)
        assert d.base is block()  # freed once the view died

    def test_size_tolerance_bounds_waste(self):
        pool = sockio.BufferPool(max_bytes=1 << 30, min_size=16)
        a = pool.take(64 * 1024)
        block = a.base
        del a
        small = pool.take(64)  # far below 1/4 of the block: no reuse
        assert small.base is not block

    def test_eviction_caps_tracked_bytes(self):
        import weakref

        pool = sockio.BufferPool(max_bytes=4096, min_size=16)
        # Keep every block busy so each take() allocates fresh and the
        # eviction branch (not refcount reuse) must enforce the cap.
        busy = [pool.take(2048) for _ in range(3)]
        assert sum(e.nbytes for e in pool._entries) <= 4096
        # The newest (just-returned) block is never the eviction victim.
        assert pool._entries[-1] is busy[-1].base
        # Untracked busy blocks stay alive through their consumer views...
        assert all((b == b).all() for b in busy)
        evicted_ref = weakref.ref(busy[0].base)
        del busy
        # ...and are freed by GC once the views die.
        assert evicted_ref() is None

    def test_zero_cap_disables_pooling(self):
        pool = sockio.BufferPool(max_bytes=0, min_size=16)
        a = pool.take(1024)
        assert pool._entries == []
        assert a.nbytes == 1024

    def test_trim_drops_free_keeps_busy(self):
        import weakref

        pool = sockio.BufferPool(max_bytes=1 << 30, min_size=16)
        busy = pool.take(1024)
        free = pool.take(1024)
        free_ref = weakref.ref(free.base)
        del free
        pool.trim()
        assert free_ref() is None  # free block dropped
        assert len(pool._entries) == 1  # busy block still tracked
        assert (busy == busy).all()
        assert pool._total == pool._entries[0].nbytes
