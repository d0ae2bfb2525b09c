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

"""The port's native wire module, ``rayfed_tpu_torch._fastwire``.

Its C API is pinned as the JAX package's ``test_fastwire_native.py`` pins
``rayfed_tpu._fastwire`` (validation before allocation, pooled-buffer
lifetime, scatter reads across many segments, EOF/garbage handling), on
the module the port builds from its own copy of the source
(``rayfed_tpu_torch/csrc/fastwire.cc``) with the machine's C++ compiler.
Then the loader (``_private/native_wire.py``): builds that start together
load one intact module, a changed source rebuilds, a failed build raises
with the compiler's output, and a machine without a compiler keeps the
Python IO path.
"""

import os
import shutil
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from rayfed_tpu_torch._private import native_wire
from rayfed_tpu_torch.proxy.tcp import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Built here by g++ from the port's copy of the source.
_fastwire = native_wire.load()

_PREFIX = struct.Struct(">4sBBIQ")


def _pair():
    a, b = socket.socketpair()
    return a, b


def _frame(hdr: bytes, payload: bytes, ftype=0) -> bytes:
    return _PREFIX.pack(wire.WIRE_MAGIC, wire.WIRE_VERSION, ftype,
                        len(hdr), len(payload)) + hdr + payload


def _recv_ph(sock, max_header=1 << 20, max_payload=1 << 30):
    return _fastwire.recv_prefix_header(
        sock.fileno(), 5000, wire.WIRE_MAGIC, wire.WIRE_VERSION,
        max_header, max_payload,
    )


def test_the_port_builds_and_shares_one_native_module():
    from rayfed_tpu_torch.proxy import lanes
    from rayfed_tpu_torch.proxy.tcp import checksum, reactor, sockio

    assert _fastwire is not None, "a C++ compiler is on this machine"
    assert _fastwire.__name__ == "rayfed_tpu_torch._fastwire"
    assert sys.modules["rayfed_tpu_torch._fastwire"] is _fastwire
    assert os.path.dirname(_fastwire.__file__) == native_wire.BUILD_DIR
    # Every call site of the wire sees the same module.
    assert sockio._fastwire is checksum._fw is lanes._fw is _fastwire
    assert reactor._native() is _fastwire
    assert sockio.io_path() == "native"
    # The port's copy is the JAX package's source, unchanged.
    with open(native_wire.SOURCE, "rb") as a, \
            open(os.path.join(REPO, "native", "fastwire.cc"), "rb") as b:
        assert a.read() == b.read()


def test_prefix_header_roundtrip():
    a, b = _pair()
    with a, b:
        a.sendall(_frame(b"\x81\xa1k\xa1v", b"xyz", ftype=1))
        ftype, plen, hbytes = _recv_ph(b)
        assert (ftype, plen, hbytes) == (1, 3, b"\x81\xa1k\xa1v")
        (buf,) = _fastwire.recv_scatter(b.fileno(), 5000, [3])
        assert bytes(memoryview(buf)) == b"xyz"


def test_bad_magic_rejected_before_any_read_of_body():
    a, b = _pair()
    with a, b:
        a.sendall(b"EVIL" + bytes(14))
        with pytest.raises(ValueError, match="bad magic"):
            _recv_ph(b)


def test_wrong_version_rejected():
    a, b = _pair()
    with a, b:
        raw = _PREFIX.pack(wire.WIRE_MAGIC, wire.WIRE_VERSION + 1, 0, 0, 0)
        a.sendall(raw)
        with pytest.raises(ValueError, match="version"):
            _recv_ph(b)


def test_hostile_header_length_rejected_before_allocation():
    a, b = _pair()
    with a, b:
        raw = _PREFIX.pack(wire.WIRE_MAGIC, wire.WIRE_VERSION, 0,
                           0x7FFFFFFF, 0)
        a.sendall(raw)
        with pytest.raises(ValueError, match="header length"):
            _recv_ph(b, max_header=1 << 20)


def test_hostile_payload_length_rejected_before_allocation():
    a, b = _pair()
    with a, b:
        raw = _PREFIX.pack(wire.WIRE_MAGIC, wire.WIRE_VERSION, 0, 0,
                           1 << 50)
        a.sendall(raw)
        with pytest.raises(ValueError, match="payload length"):
            _recv_ph(b, max_payload=1 << 30)


def test_eof_mid_prefix_and_mid_header():
    a, b = _pair()
    with b:
        a.sendall(b"FTP")  # partial magic
        a.close()
        with pytest.raises(ConnectionError):
            _recv_ph(b)
    a, b = _pair()
    with b:
        raw = _PREFIX.pack(wire.WIRE_MAGIC, wire.WIRE_VERSION, 0, 10, 0)
        a.sendall(raw + b"half")  # 4 of 10 header bytes
        a.close()
        with pytest.raises(ConnectionError):
            _recv_ph(b)


def test_timeout_raises_timeout_error():
    a, b = _pair()
    with a, b:
        # The poll-based timeout engages on non-blocking fds, the mode
        # Python's settimeout() uses and the only one the lane passes a
        # finite timeout_ms for.
        b.setblocking(False)
        with pytest.raises(TimeoutError):
            _fastwire.recv_prefix_header(
                b.fileno(), 50, wire.WIRE_MAGIC, wire.WIRE_VERSION,
                1 << 20, 1 << 30,
            )


def test_scatter_many_segments_exact_bytes():
    # More segments than one readv batch (64 iovecs) to cover batching.
    sizes = [3, 1, 7, 64, 129] + [5] * 100
    blob = b"".join(bytes([i % 251]) * n for i, n in enumerate(sizes))
    a, b = _pair()
    with a, b:
        t = threading.Thread(target=a.sendall, args=(blob,))
        t.start()
        bufs = _fastwire.recv_scatter(b.fileno(), 5000, sizes)
        t.join()
    assert [len(x) for x in bufs] == sizes
    got = b"".join(bytes(memoryview(x)) for x in bufs)
    assert got == blob


def test_scatter_eof_mid_payload():
    a, b = _pair()
    with b:
        a.sendall(b"123")
        a.close()
        with pytest.raises(ConnectionError):
            _fastwire.recv_scatter(b.fileno(), 5000, [10])


def _buffer_addr(view: memoryview) -> int:
    import ctypes

    c = (ctypes.c_char * view.nbytes).from_buffer(view)
    try:
        return ctypes.addressof(c)
    finally:
        del c


def test_pooled_buffer_recycled_after_views_die():
    # Two sequential >=1MB receives reuse the same pooled block once the
    # first buffer and every view of it are dead; a torch tensor over the
    # block keeps it out of the pool while it lives.
    n = 1 << 20
    payload = bytes(n)

    def _one_recv():
        a, b = _pair()
        with a, b:
            t = threading.Thread(target=a.sendall, args=(payload,))
            t.start()
            (buf,) = _fastwire.recv_scatter(b.fileno(), 5000, [n])
            t.join()
            view = memoryview(buf)
            addr = _buffer_addr(view)
            view.release()
            return addr, buf

    addr1, buf1 = _one_recv()
    held = torch.frombuffer(buf1, dtype=torch.uint8)
    del buf1
    addr2, buf2 = _one_recv()
    assert addr2 != addr1, "a block under a live tensor was handed out"
    del held, buf2  # both blocks return to the C pool
    addr3, buf3 = _one_recv()
    assert addr3 in (addr1, addr2), "pool did not recycle a freed block"
    del buf3
    _fastwire.pool_trim()
    addr4, buf4 = _one_recv()  # after trim a fresh block is allocated
    del buf4
    assert isinstance(addr4, int)


def test_pooled_buffer_is_writable_and_sized():
    a, b = _pair()
    with a, b:
        a.sendall(b"abcd")
        (buf,) = _fastwire.recv_scatter(b.fileno(), 5000, [4])
    assert len(buf) == 4
    view = memoryview(buf)
    assert not view.readonly
    view[0] = ord("z")
    assert bytes(view) == b"zbcd"


def test_zero_length_scatter_entry():
    a, b = _pair()
    with a, b:
        a.sendall(b"ab")
        bufs = _fastwire.recv_scatter(b.fileno(), 5000, [1, 0, 1])
        assert [bytes(memoryview(x)) for x in bufs] == [b"a", b"", b"b"]


def test_sendv_batches_past_64_iovecs():
    # A model tree's frame can carry hundreds of leaf buffers; sendv must
    # batch writev calls internally, not reject the sequence.
    bufs = [bytes([i % 251]) * (i % 9 + 1) for i in range(200)]
    total = sum(len(x) for x in bufs)
    a, b = _pair()
    with a, b:
        # Timeout so a sender-side fault fails the test instead of
        # hanging the suite.
        b.settimeout(10)
        t = threading.Thread(
            target=_fastwire.sendv, args=(a.fileno(), 5000, bufs)
        )
        t.start()
        got = bytearray()
        while len(got) < total:
            chunk = b.recv(65536)
            assert chunk
            got.extend(chunk)
        t.join()
    assert bytes(got) == b"".join(bufs)


def test_many_leaf_tree_frame_roundtrips_on_native_path():
    # End to end: a 150-leaf tree of torch tensors (f32 and bf16) crosses
    # send_frame/recv_frame with the native engine on both sides.
    from rayfed_tpu_torch._private import serialization
    from rayfed_tpu_torch.proxy.tcp import sockio

    tree = {f"layer{i}": torch.full((17,), float(i),
                                    dtype=torch.bfloat16 if i % 2
                                    else torch.float32)
            for i in range(150)}
    kind, meta, bufs = serialization.encode_payload(tree)
    assert kind == "tree" and len(bufs) == 150
    a, b = _pair()
    with a, b:
        b.settimeout(10)  # fail (not hang) on a sender-side fault
        hdr = {"job": "j", "src": "alice", "up": "1", "down": "1",
               "is_error": False, "pkind": kind, "pmeta": meta}
        t = threading.Thread(
            target=sockio.send_frame, args=(a, 0, hdr, bufs)
        )
        t.start()
        ftype, header, payload = sockio.recv_frame(b)
        t.join()
    out = serialization.decode_payload(
        header["pkind"], header.get("pmeta", b""), payload, {}
    )
    for i in range(150):
        assert torch.equal(out[f"layer{i}"], tree[f"layer{i}"])
        assert out[f"layer{i}"].dtype == tree[f"layer{i}"].dtype


def _crc32c_bitwise(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def test_crc32c_streams_and_matches_the_definition():
    # The checksum lane's crc32c (opt-in frame integrity) is native here.
    from rayfed_tpu_torch.proxy.tcp import checksum

    assert _fastwire.crc32c(b"123456789") == 0xE3069283  # the check value
    data = np.random.default_rng(0).bytes(10_007)
    assert _fastwire.crc32c(data) == _crc32c_bitwise(data)
    assert checksum.compute([data[:333], data[333:]]) == \
        (_crc32c_bitwise(data), checksum.ALG_CRC32C)


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

_BUILD_AND_LOAD = """
import os, sys, time
from rayfed_tpu_torch._private import native_wire as nw
build_dir, source, go = sys.argv[1:4]
while not os.path.exists(go):
    time.sleep(0.005)
path = nw.build(source, build_dir)
mod = nw.load_from(path)
print(path, mod.crc32c(b"123456789"))
"""


def test_builds_started_together_load_one_intact_module(tmp_path):
    go = tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path / "build"),
         native_wire.SOURCE, str(go)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    go.touch()  # both start their build at once
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.split()[0]: out.split()[1] for out, _ in outs}
    assert len(lines) == 1  # one module, at one path
    (path, crc), = lines.items()
    assert int(crc) == 0xE3069283
    assert path == native_wire.library_path(native_wire.SOURCE,
                                            str(tmp_path / "build"))
    # Nothing partial is left beside it.
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path), "fastwire.lock"])


def test_a_changed_source_rebuilds(tmp_path):
    src = tmp_path / "fastwire.cc"
    shutil.copy(native_wire.SOURCE, src)
    build_dir = str(tmp_path / "build")
    first = native_wire.build(str(src), build_dir)
    assert native_wire.build(str(src), build_dir) == first  # no rebuild
    mtime = os.path.getmtime(first)
    with open(src, "a") as f:
        f.write("\n// changed\n")
    second = native_wire.build(str(src), build_dir)
    assert second != first and os.path.exists(second)
    assert os.path.getmtime(first) == mtime


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "fastwire.cc"
    src.write_text("#include <Python.h>\nint broken( {\n")
    with pytest.raises(RuntimeError, match="(?s)failed.*error"):
        native_wire.build(str(src), str(tmp_path / "build"))
    assert os.listdir(tmp_path / "build") == ["fastwire.lock"]


def test_no_compiler_leaves_the_python_io_path(monkeypatch):
    monkeypatch.setattr(native_wire, "_loaded", False)
    monkeypatch.setattr(native_wire, "_module", None)
    monkeypatch.setattr(native_wire, "compiler", lambda: None)
    assert native_wire.load() is None
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_wire.build(native_wire.SOURCE,
                          os.path.join(native_wire.BUILD_DIR, "none"))
