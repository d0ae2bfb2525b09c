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

"""Blocking-socket frame IO for the FTP1 wire protocol.

The data plane runs on dedicated threads with blocking sockets:
``sendall`` over memoryviews on the way out, ``recv_into`` a preallocated
``bytearray`` on the way in — one copy each side, measured ~20x faster than
asyncio streams on this workload (loopback ceiling ~2.9 GB/s vs ~0.13 GB/s
through StreamReader). Frame layout is defined in
:mod:`rayfed_tpu_torch.proxy.tcp.wire`.
"""

from __future__ import annotations

import os
import socket
import ssl
import sys
import threading
from typing import Dict, List, Optional, Tuple

from rayfed_tpu_torch._private import msgpack_codec as msgpack
from rayfed_tpu_torch._private import native_wire

from rayfed_tpu_torch.proxy.tcp import wire

# The native C++ lane, built from csrc/fastwire.cc at first import; None
# (no C++ compiler on the machine) leaves the Python IO path.
_fastwire = native_wire.load()

_SOCK_BUF = 8 * 1024 * 1024

# Small-message fast path (receive-side IO shaping): frames whose payload
# fits within this bound are received in one window — native builds pull
# prefix+header+payload inside a single GIL release, the Python/TLS path
# combines the header and payload reads. Independent of the *sender's*
# configurable ``small_message_threshold``: this is a local buffering
# decision, not a wire-format knob, so the two need not agree.
SMALL_FRAME_MAX = 64 * 1024

# Coalesced sends at or below this total are joined into one buffer for a
# single ``sendall`` on the Python/TLS path — one copy beats N syscalls
# (and keeps TLS to one record per batch). Larger batches send
# sequentially rather than double-buffer a big payload.
_COALESCE_COPY_MAX = 256 * 1024

# Sentinel for "caller did not pass a fastwire snapshot" — distinct from
# None, which legitimately means "no native engine".
_UNSET = object()


def io_path() -> str:
    """The IO path plaintext frames take in this process: ``"native"``
    (``rayfed_tpu_torch._fastwire``) or ``"python"``."""
    return "python" if _fastwire is None else "native"


def _native_ok(sock, fw=_UNSET) -> bool:
    # The fastwire path works on raw fds only; TLS stays on the ssl module.
    # Callers on a multi-step path pass their own snapshot of ``_fastwire``
    # so one frame never sees the module global change mid-frame (tests
    # swap it to force the Python path; see test_sockio.py).
    if fw is _UNSET:
        fw = _fastwire
    return fw is not None and not isinstance(sock, ssl.SSLSocket)


def _timeout_ms(sock: socket.socket) -> int:
    t = sock.gettimeout()
    return -1 if t is None else int(t * 1000)


def tune_socket(sock: socket.socket) -> None:
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF)
    except OSError:  # pragma: no cover - platform-specific
        pass


def send_frames(sock: socket.socket,
                frames: List[Tuple[int, Dict, Optional[List]]]) -> None:
    """Send one or more complete frames in a single vectored write.

    ``frames`` is a list of (ftype, header, buffers). On native plaintext
    sockets every prefix, header and payload buffer of the whole batch
    goes out through one ``sendv`` (writev) call; the Python/TLS fallback
    joins small batches into one ``sendall``. This is the syscall-level
    half of the small-message coalescer: N queued small frames to the
    same peer cost one syscall, not 2N.
    """
    fw = _fastwire
    chunks: List = []
    for ftype, header, buffers in frames:
        buffers = buffers or []
        payload_len = sum(memoryview(b).nbytes for b in buffers)
        chunks.append(
            wire.encode_prefix_and_header(ftype, header, payload_len)
        )
        for b in buffers:
            v = wire.as_byte_view(b)
            if v.nbytes:
                chunks.append(v)
    if _native_ok(sock, fw):
        try:
            fw.sendv(sock.fileno(), _timeout_ms(sock), chunks)
            return
        except TimeoutError:
            raise socket.timeout("fastwire send timed out") from None
        except ValueError:
            # Stale v1 extension build: sendv capped at 64 iovecs ("too
            # many buffers") and nothing has been written yet — fall
            # through to the Python sendall path.
            pass
    total = sum(memoryview(c).nbytes for c in chunks)
    if len(chunks) > 1 and total <= _COALESCE_COPY_MAX:
        sock.sendall(b"".join(chunks))
        return
    for chunk in chunks:
        sock.sendall(chunk)


def send_frame(sock: socket.socket, ftype: int, header: Dict,
               buffers: Optional[List] = None) -> None:
    send_frames(sock, [(ftype, header, buffers)])


def _recv_exact_into(sock: socket.socket, view: memoryview,
                     fw=_UNSET) -> None:
    if fw is _UNSET:
        fw = _fastwire
    if _native_ok(sock, fw):
        try:
            fw.recv_exact(sock.fileno(), _timeout_ms(sock), view)
            return
        except TimeoutError:
            raise socket.timeout("fastwire recv timed out") from None
    got = 0
    total = view.nbytes
    while got < total:
        n = sock.recv_into(view[got:])
        if n == 0:
            raise ConnectionError("peer closed connection mid-frame")
        got += n


def _recv_exact(sock: socket.socket, n: int, fw=_UNSET) -> bytearray:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf), fw)
    return buf


# Tree payloads at least this large are scatter-read into per-buffer
# segments (so a sharded array never lands in one global-size host buffer).
_SEGMENT_THRESHOLD = 1 << 20


def _effective_cap(max_payload: Optional[int]) -> int:
    return wire._MAX_PAYLOAD if max_payload is None else min(
        max_payload, wire._MAX_PAYLOAD
    )


def _segment_sizes(header: Dict, plen: int):
    """Per-segment byte lengths for a scatter-read, or None when the
    frame is received into one contiguous buffer. Shared by the Python
    and native receive paths — the segmentation rule must never diverge
    between them (TLS rides the Python path, plaintext the native)."""
    if plen >= _SEGMENT_THRESHOLD and "comp" not in header:
        pkind = header.get("pkind")
        if pkind == "tree":
            from rayfed_tpu_torch._private import serialization

            lengths = serialization.tree_segment_lengths(
                header.get("pmeta", b""), plen
            )
            if lengths is not None and len(lengths) > 1:
                return lengths
        elif pkind == "stripe":
            # Stripe frames carry their own pre-validated segment plan
            # (the sender computed it from the same coalescing rule).
            from rayfed_tpu_torch._private import serialization

            return serialization.stripe_segment_lengths(
                header.get("sd") or {}, plen
            )
    return None


class BufferPool:
    """Recycles large receive buffers across frames.

    A fresh ``np.empty`` per 100MB frame costs ~40% of loopback throughput
    on this class of host: glibc serves big allocations from per-thread
    arenas that always mmap >64MB requests, so every frame pays page
    faults on first touch plus munmap on free. Delivered arrays are
    zero-copy views of the receive buffer, so a buffer is safe to reuse
    exactly when every consumer view has died — detected by its refcount
    dropping back to the pool's own reference.
    """

    def __init__(
        self, max_bytes: int, min_size: int = 1 << 20, max_entries: int = 64
    ):
        # Free detection relies on exact refcounts; a free-threaded
        # interpreter biases/defers them, so pooling must stand down
        # there (plain allocation, no dead-weight cache).
        if not getattr(sys, "_is_gil_enabled", lambda: True)():
            max_bytes = 0  # pragma: no cover - nogil builds only
        self._max_bytes = max_bytes
        self._min_size = min_size
        # Bounds the O(entries) refcount scan every take() pays under the
        # lock (and with it, worst-case lock hold time).
        self._max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: List = []  # np.ndarray blocks, oldest first
        self._total = 0  # running sum of tracked bytes

    # refs to a free entry at the getrefcount() call site: the pool's
    # list slot + getrefcount's argument. Any live consumer view (ndarray
    # slice / memoryview chains back to the block) adds more.
    _FREE_RC = 2

    def take(self, n: int):
        """A writable 1-d uint8 array of exactly ``n`` bytes."""
        import numpy as np

        if n < self._min_size or n > self._max_bytes:
            return np.empty(n, dtype=np.uint8)
        with self._lock:
            best = -1
            for i in range(len(self._entries)):
                nbytes = self._entries[i].nbytes
                # <=4n bound: don't burn a huge block on a small frame.
                if (
                    n <= nbytes <= (n << 2)
                    and sys.getrefcount(self._entries[i]) == self._FREE_RC
                    and (best < 0 or nbytes < self._entries[best].nbytes)
                ):
                    best = i
            if best >= 0:
                block = self._entries.pop(best)
                self._entries.append(block)  # LRU: reused = most recent
                return block[:n] if block.nbytes > n else block[:]
        # Allocate outside the lock: mmap + page faults of a GB-scale
        # block must not stall other receiver threads' pool hits.
        block = np.empty(n, dtype=np.uint8)
        evicted = []
        with self._lock:
            self._entries.append(block)
            self._total += block.nbytes
            while len(self._entries) > 1 and (
                self._total > self._max_bytes
                or len(self._entries) > self._max_entries
            ):
                # Evict oldest-first; a busy block is merely untracked and
                # is freed by GC once its consumers drop their views.
                self._total -= self._entries[0].nbytes
                evicted.append(self._entries.pop(0))
        del evicted  # munmap of evicted blocks happens after lock release
        return block[:]

    def trim(self) -> None:
        """Drop every currently-free block (busy blocks stay tracked).

        Transports call this at shutdown so a burst of large frames does
        not pin pool memory for the rest of the process's life."""
        dropped = []
        keep = []
        with self._lock:
            for block in self._entries:
                # refs at the check: list slot + loop var + getrefcount
                # arg = 3 for a free block; consumer views add more.
                (keep if sys.getrefcount(block) > 3 else dropped).append(block)
            self._entries = keep
            self._total = sum(b.nbytes for b in keep)
        del dropped  # frees outside the lock


def trim_recv_pool() -> None:
    """Release the module pool's free blocks (called on transport stop)."""
    _RECV_POOL.trim()
    if _fastwire is not None and hasattr(_fastwire, "pool_trim"):
        _fastwire.pool_trim()


def _pool_max_bytes() -> int:
    mb = os.environ.get("FEDTPU_RECV_POOL_MB")
    try:
        return max(0, int(mb)) << 20 if mb is not None else 2 << 30
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "ignoring malformed FEDTPU_RECV_POOL_MB=%r (want integer MB)", mb
        )
        return 2 << 30


# FEDTPU_RECV_POOL_MB bounds the TOTAL receive-pool memory of the process.
# When the native extension is loaded, its C-side pool (which reads the
# same env var) serves every plaintext connection; the Python pool keeps a
# quarter-cap residual budget for the TLS connections that still ride the
# Python receive path (they pay per-byte crypto, but a fresh 100MB
# allocation per frame still costs page faults + munmap). Worst case the
# process retains 1.25x the configured cap — documented trade against
# TLS receivers getting zero recycling. Without the native engine the
# Python pool owns the whole budget.
_RECV_POOL = BufferPool(
    _pool_max_bytes() // 4
    if (_fastwire is not None and hasattr(_fastwire, "recv_prefix_header"))
    else _pool_max_bytes()
)


def recv_frame(
    sock: socket.socket,
    max_payload: Optional[int] = None,
):
    """Blocking read of one frame. Size caps are enforced before the
    payload is buffered, so an oversized frame costs no memory — the
    connection is torn down instead of answered. Payload is a writable
    buffer view, or a :class:`serialization.SegmentedPayload` when a
    large ``tree`` frame is scatter-read into leaf/shard-aligned buffers.

    On plaintext sockets with the native extension available, the whole
    receive path (prefix+header read, validation, pooled payload buffers,
    scatter readv) runs in C++ (the role gRPC's C-core plays for the
    reference's data plane). Frames whose payload fits SMALL_FRAME_MAX
    ride a one-window fast lane: the native engine pulls prefix, header
    and payload inside a single GIL release; the Python path combines
    the header+payload reads into one recv."""
    fw = _fastwire  # snapshot: one frame never mixes native/Python steps
    if _native_ok(sock, fw) and hasattr(fw, "recv_prefix_header"):
        return _recv_frame_native(sock, max_payload, fw)
    prefix = _recv_exact(sock, wire.PREFIX_LEN, fw)
    magic, version, ftype, hlen, plen = wire._PREFIX.unpack(bytes(prefix))
    if magic != wire.WIRE_MAGIC:
        raise wire.WireError(f"bad magic {magic!r}")
    if version != wire.WIRE_VERSION:
        raise wire.WireError(f"unsupported wire version {version}")
    if hlen > wire._MAX_HEADER:
        raise wire.WireError(f"header length {hlen} exceeds cap")
    cap = _effective_cap(max_payload)
    if plen > cap:
        raise wire.WireError(f"payload length {plen} exceeds cap {cap}")
    if plen and plen <= SMALL_FRAME_MAX:
        # Small frame: header + payload in one read (2 recv windows per
        # frame instead of 3; the payload view stays writable).
        buf = memoryview(_recv_exact(sock, hlen + plen, fw))
        header = msgpack.unpackb(bytes(buf[:hlen]), raw=False)
        return ftype, header, buf[hlen:]
    header = msgpack.unpackb(bytes(_recv_exact(sock, hlen, fw)), raw=False)
    if not plen:
        return ftype, header, memoryview(b"")
    # Buffers come from the recycling pool (np.empty also skips the
    # zero-fill a bytearray would pay — pure waste since recv_into
    # overwrites every byte); the returned view stays writable.
    from rayfed_tpu_torch._private import serialization

    sizes = _segment_sizes(header, plen)
    if sizes is not None:
        segments = []
        pos = 0
        for n in sizes:
            buf = _RECV_POOL.take(n)
            _recv_exact_into(sock, memoryview(buf), fw)
            segments.append((pos, buf))
            pos += n
        return ftype, header, serialization.SegmentedPayload(segments)

    payload = _RECV_POOL.take(plen)
    _recv_exact_into(sock, memoryview(payload), fw)
    return ftype, header, memoryview(payload)


def _recv_frame_native(sock: socket.socket, max_payload: Optional[int], fw):
    """Native (C++) receive path. Small frames (payload within
    SMALL_FRAME_MAX): ONE GIL window for the whole frame via
    ``recv_frame_small``. Large frames: one window for prefix+header
    (validation before allocation), one for the payload scatter-read into
    C-pooled buffers. ``fw`` is the caller's snapshot of the fastwire
    module — taken once per frame so a concurrent swap of the module
    global (tests forcing the Python path) cannot split one frame across
    engines."""
    timeout_ms = _timeout_ms(sock)
    fd = sock.fileno()
    small = None
    try:
        if hasattr(fw, "recv_frame_small"):
            ftype, plen, hbytes, small = fw.recv_frame_small(
                fd, timeout_ms, wire.WIRE_MAGIC, wire.WIRE_VERSION,
                wire._MAX_HEADER, _effective_cap(max_payload),
                SMALL_FRAME_MAX,
            )
        else:  # stale extension build without the small-frame lane
            ftype, plen, hbytes = fw.recv_prefix_header(
                fd, timeout_ms, wire.WIRE_MAGIC, wire.WIRE_VERSION,
                wire._MAX_HEADER, _effective_cap(max_payload),
            )
    except TimeoutError:
        raise socket.timeout("fastwire recv timed out") from None
    except ValueError as e:  # protocol violation detected in C
        raise wire.WireError(str(e)) from None
    header = msgpack.unpackb(hbytes, raw=False)
    if not plen:
        return ftype, header, memoryview(b"")
    if small is not None:
        return ftype, header, memoryview(small)
    from rayfed_tpu_torch._private import serialization

    sizes = _segment_sizes(header, plen)
    try:
        bufs = fw.recv_scatter(fd, timeout_ms, sizes or [plen])
    except TimeoutError:
        raise socket.timeout("fastwire recv timed out") from None
    if sizes is None:
        return ftype, header, memoryview(bufs[0])
    segments = []
    pos = 0
    for n, buf in zip(sizes, bufs):
        segments.append((pos, buf))
        pos += n
    return ftype, header, serialization.SegmentedPayload(segments)
