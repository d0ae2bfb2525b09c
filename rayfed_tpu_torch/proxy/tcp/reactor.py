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

"""Epoll reactor: shared event-loop transport for the plaintext TCP lanes.

Thread-per-connection caps the transport at tens of peers — every party
costs a writer thread, a reader thread per reconnect generation, and a
receiver thread per inbound connection, and each hop is a context switch
on the latency path. This module replaces all of them with a small fixed
set of reactor threads (``cross_silo_comm.num_reactors``, default 1), each
running one epoll loop that owns many connections:

 - **Send rings.** Every connection keeps a deque of encoded frame chunks
   (prefix+header bytes and payload buffer views). Writes are nonblocking
   ``writev``; all connections that became writable in one poll batch are
   flushed through ONE native call (``fastwire.flush_many`` — batched
   submission, one GIL window for N peers). Write interest (EPOLLOUT) is
   raised only while a ring is non-empty.
 - **Recv state machines.** Inbound bytes feed an incremental FTP1 parser
   (prefix → header → payload) that validates caps before allocating and
   scatter-fills pooled buffers for large tree payloads, exactly like the
   blocking path in ``sockio.recv_frame``.
 - **Sender lanes.** :class:`ReactorLane` preserves the pipelined lane's
   contract bit for bit: fseq-matched acks, a bounded send window,
   resend-unacked-after-reconnect, per-frame attempt budgets, ack
   timeouts, the peer-down fast-fail probe, and the PR 5 inline
   small-send on the caller's thread when the lane is idle.

Blocking work never runs on a reactor thread: dials happen on short-lived
dialer threads that hand the connected socket back to the loop, and large
payload decode stays on the rendezvous store's worker pool. TLS
connections keep the threaded half-duplex paths (``ssl.SSLSocket`` cannot
be polled usefully through raw fds without buffering surprises).

The native epoll core in ``fastwire.cc`` (``reactor_wait`` /
``flush_many`` / ``recv_into_nb``) accelerates the loop when built;
``select.epoll`` + ``os.writev`` are the pure-Python fallback, and on
platforms without epoll the transport falls back to the threaded lanes
entirely (see :func:`available`).
"""

from __future__ import annotations

import logging
import os
import select
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from rayfed_tpu_torch._private import msgpack_codec as msgpack

from rayfed_tpu_torch import sanitize
from rayfed_tpu_torch.proxy.tcp import sockio, wire
from rayfed_tpu_torch.proxy.tcp.pipeline import _Inflight, _m_crc_resends
from rayfed_tpu_torch.resilience import inject as fault_inject
from rayfed_tpu_torch.resilience import linkhealth
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

# Lane-level health series (docs/observability.md). Module-scope: lanes
# come and go per peer, the series are process totals.
_REG = telemetry_metrics.get_registry()
_m_open_lanes = _REG.gauge(
    "fed_transport_open_lanes", "Reactor sender lanes currently open."
)
_m_lane_dials = _REG.counter(
    "fed_transport_lane_dials_total", "Successful lane (re)connects."
)
_m_lane_breaks = _REG.counter(
    "fed_transport_lane_breaks_total",
    "Lane connection breaks (frames resend after reconnect).",
)
_m_inline_sends = _REG.counter(
    "fed_transport_inline_sends_total",
    "Small frames written zero-hop on the caller's thread.",
)

_EPOLLIN = getattr(select, "EPOLLIN", 0x001)
_EPOLLOUT = getattr(select, "EPOLLOUT", 0x004)
_EPOLLERR = getattr(select, "EPOLLERR", 0x008)
_EPOLLHUP = getattr(select, "EPOLLHUP", 0x010)

# EPOLL_CTL_* kernel values (fastwire.reactor_ctl takes them raw).
_CTL_ADD, _CTL_DEL, _CTL_MOD = 1, 2, 3

# Housekeeping cadence: ack-timeout checks and broken-lane redials run at
# this interval (the poll timeout), matching the pipelined lane's 0.2s
# tick so failure latencies stay identical across the two engines.
_TICK_S = 0.2

# Frames parsed per connection per readiness event before yielding back to
# the loop — level-triggered epoll re-signals leftover bytes immediately,
# so the bound costs nothing and keeps one chatty peer from starving the
# rest of the batch.
_FRAMES_PER_EVENT = 64


def available() -> bool:
    """Epoll-backed reactor usable on this platform?"""
    return hasattr(select, "epoll")


def _native():
    fw = sockio._fastwire
    if fw is not None and hasattr(fw, "flush_many"):
        return fw
    return None


def _nb_writev(fd: int, chunks: List) -> int:
    """One nonblocking gather-write. Returns bytes written (0 = would
    block) or -errno on a hard error — never raises for socket errors."""
    fw = _native()
    if fw is not None:
        return fw.sendv_nb(fd, chunks)
    try:
        return os.writev(fd, chunks[:64])
    except BlockingIOError:
        return 0
    except OSError as e:
        return -(e.errno or 1)


def _advance_chunks(chunks: List, n: int) -> List:
    """Remaining chunk views after ``n`` bytes were written."""
    out = []
    for c in chunks:
        v = memoryview(c) if not isinstance(c, memoryview) else c
        if n >= v.nbytes:
            n -= v.nbytes
            continue
        out.append(v[n:] if n else v)
        n = 0
    return out


def _frame_chunks(header: Dict, buffers: Optional[List]) -> List:
    """Encoded wire chunks for one DATA frame (prefix+header blob first,
    then the payload buffer views)."""
    buffers = buffers or []
    views = []
    plen = 0
    for b in buffers:
        v = wire.as_byte_view(b)
        if v.nbytes:
            views.append(v)
            plen += v.nbytes
    return [
        wire.encode_prefix_and_header(wire.FTYPE_DATA, header, plen)
    ] + views


class Reactor(threading.Thread):
    """One epoll loop owning many connections.

    All handler state (registry, tickers, dirty set, epoll interest) is
    touched ONLY on the loop thread; other threads communicate through
    :meth:`run_soon` + the wakeup pipe. Handlers implement::

        fd                  -> int (registered file descriptor)
        on_readable()       -> consume inbound bytes
        on_error(exc)       -> fatal fd-level event (EPOLLERR/EPOLLHUP)
        pending_chunks()    -> list of buffer views to write
        on_flushed(result)  -> bytes written or -errno from the batch flush
    """

    def __init__(self, name: str = "fedtpu-reactor"):
        super().__init__(name=name, daemon=True)
        fw = _native()
        self._fw = fw if fw is not None and hasattr(fw, "reactor_wait") else None
        if self._fw is not None:
            self._epfd = self._fw.reactor_new()
        else:
            self._epoll = select.epoll()
            self._epfd = self._epoll.fileno()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._ctl(_CTL_ADD, self._wake_r, _EPOLLIN)
        self._handlers: Dict[int, object] = {}
        self._masks: Dict[int, int] = {}
        self._calls: deque = deque()
        self._calls_lock = threading.Lock()
        self._tickers: List[Callable[[float], None]] = []
        self._dirty: deque = deque()
        self._dirty_set: set = set()
        self._stopped = False
        self.start()

    # -- cross-thread entry points -------------------------------------------

    def run_soon(self, fn: Callable[[], None]) -> None:
        with self._calls_lock:
            self._calls.append(fn)
        self.wake()

    def wake(self) -> None:
        try:
            os.write(self._wake_w, b"\0")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wake is already pending; closed = stopping

    def stop(self) -> None:
        self._stopped = True
        self.wake()

    def register(self, handler) -> None:
        """Add a handler (any thread). Read interest is always on."""
        if threading.current_thread() is self:
            self._register(handler)
        else:
            self.run_soon(lambda: self._register(handler))

    def unregister(self, fd: int) -> None:
        if threading.current_thread() is self:
            self._unregister(fd)
        else:
            self.run_soon(lambda: self._unregister(fd))

    def add_ticker(self, fn: Callable[[float], None]) -> None:
        self.run_soon(lambda: self._tickers.append(fn))

    def remove_ticker(self, fn: Callable[[float], None]) -> None:
        def rm():
            try:
                self._tickers.remove(fn)
            except ValueError:
                pass

        self.run_soon(rm)

    # -- loop-thread internals ------------------------------------------------

    def _ctl(self, op: int, fd: int, events: int) -> None:
        if self._fw is not None:
            self._fw.reactor_ctl(self._epfd, op, fd, events)
        elif op == _CTL_ADD:
            self._epoll.register(fd, events)
        elif op == _CTL_DEL:
            self._epoll.unregister(fd)
        else:
            self._epoll.modify(fd, events)

    def _register(self, handler) -> None:
        fd = handler.fd
        self._handlers[fd] = handler
        self._masks[fd] = _EPOLLIN
        try:
            self._ctl(_CTL_ADD, fd, _EPOLLIN)
        except FileExistsError:
            self._ctl(_CTL_MOD, fd, _EPOLLIN)
        except OSError as e:
            self._handlers.pop(fd, None)
            self._masks.pop(fd, None)
            handler.on_error(ConnectionError(f"epoll register failed: {e}"))

    def _unregister(self, fd: int) -> None:
        self._handlers.pop(fd, None)
        if self._masks.pop(fd, None) is not None:
            try:
                self._ctl(_CTL_DEL, fd, 0)
            except OSError:
                pass  # fd already closed: the kernel dropped it for us

    def mark_dirty(self, handler) -> None:
        """Queue a handler for the end-of-batch flush (loop thread only)."""
        if handler not in self._dirty_set:
            self._dirty_set.add(handler)
            self._dirty.append(handler)

    def set_write_interest(self, fd: int, want: bool) -> None:
        mask = self._masks.get(fd)
        if mask is None:
            return
        new = (_EPOLLIN | _EPOLLOUT) if want else _EPOLLIN
        if new != mask:
            try:
                self._ctl(_CTL_MOD, fd, new)
                self._masks[fd] = new
            except OSError:
                pass

    def _wait(self, timeout_ms: int):
        if self._fw is not None:
            return self._fw.reactor_wait(self._epfd, timeout_ms)
        try:
            return self._epoll.poll(timeout_ms / 1000)
        except InterruptedError:  # pragma: no cover - EINTR
            return []

    def _drain_calls(self) -> None:
        while True:
            with self._calls_lock:
                if not self._calls:
                    return
                fn = self._calls.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 - one handler must not kill the loop
                logger.exception("reactor callback failed")

    def _flush_dirty(self) -> None:
        if not self._dirty:
            return
        handlers, jobs = [], []
        while self._dirty:
            h = self._dirty.popleft()
            self._dirty_set.discard(h)
            try:
                chunks = h.pending_chunks()
            except Exception:  # noqa: BLE001
                logger.exception("pending_chunks failed")
                continue
            if chunks:
                handlers.append(h)
                jobs.append((h.fd, chunks))
        if not jobs:
            return
        fw = _native()
        if fw is not None and len(jobs) > 1:
            # Batched submission: every writable peer's ring in one GIL
            # window. Per-fd errors come back as -errno so one dead peer
            # cannot fail its neighbours' flushes.
            results = fw.flush_many(jobs)
        else:
            results = [_nb_writev(fd, chunks) for fd, chunks in jobs]
        for h, res in zip(handlers, results):
            try:
                h.on_flushed(res)
            except Exception:  # noqa: BLE001
                logger.exception("on_flushed failed")

    def run(self) -> None:
        last_tick = time.monotonic()
        try:
            while not self._stopped:
                self._drain_calls()
                events = self._wait(int(_TICK_S * 1000))
                for fd, ev in events:
                    if fd == self._wake_r:
                        try:
                            while os.read(self._wake_r, 4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                        continue
                    h = self._handlers.get(fd)
                    if h is None:
                        continue
                    try:
                        if ev & _EPOLLIN:
                            h.on_readable()
                        # Re-check: on_readable may have unregistered us.
                        if ev & _EPOLLOUT and self._handlers.get(fd) is h:
                            self.mark_dirty(h)
                        if (
                            ev & (_EPOLLERR | _EPOLLHUP)
                            and not ev & _EPOLLIN
                            and self._handlers.get(fd) is h
                        ):
                            h.on_error(ConnectionError("connection reset"))
                    except Exception as e:  # noqa: BLE001 - isolate per conn
                        logger.exception("reactor handler failed")
                        try:
                            h.on_error(e)
                        except Exception:  # noqa: BLE001
                            pass
                self._drain_calls()
                self._flush_dirty()
                now = time.monotonic()
                if now - last_tick >= _TICK_S:
                    last_tick = now
                    for t in list(self._tickers):
                        try:
                            t(now)
                        except Exception:  # noqa: BLE001
                            logger.exception("reactor ticker failed")
        finally:
            self._drain_calls()  # resolve teardowns queued during stop
            try:
                if self._fw is not None:
                    self._fw.reactor_close(self._epfd)
                else:
                    self._epoll.close()
            except OSError:
                pass
            for p in (self._wake_r, self._wake_w):
                try:
                    os.close(p)
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# Process-global reactor pool (refcounted across proxies)
# ---------------------------------------------------------------------------

_pool_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (shared reactor pool, refcounted via acquire/release_reactors)
_pool: List[Reactor] = []  # fedlint: disable=global-mutable-singleton (shared reactor pool, refcounted via acquire/release_reactors)
_pool_refs = 0  # fedlint: disable=global-mutable-singleton (shared reactor pool, refcounted via acquire/release_reactors)


def acquire_reactors(n: int = 1) -> List[Reactor]:
    """Take a reference on the shared reactor pool, growing it to at
    least ``n`` threads. Callers MUST pair with :func:`release_reactors`."""
    global _pool_refs
    n = max(1, int(n))
    with _pool_lock:
        _pool_refs += 1
        while len(_pool) < n:
            _pool.append(Reactor(name=f"fedtpu-reactor-{len(_pool)}"))
        return list(_pool[:n])


def release_reactors() -> None:
    global _pool_refs
    with _pool_lock:
        _pool_refs -= 1
        if _pool_refs > 0:
            return
        _pool_refs = 0
        stopped, _pool[:] = list(_pool), []
    for r in stopped:
        r.stop()
    for r in stopped:
        r.join(timeout=5)


# ---------------------------------------------------------------------------
# Incremental FTP1 readers
# ---------------------------------------------------------------------------


def _read_into_nb(sock, view: memoryview) -> int:
    """Nonblocking read into ``view``. Returns bytes read (0 = would
    block), -2 on EOF; raises OSError on hard errors."""
    fw = sockio._fastwire
    if fw is not None and hasattr(fw, "recv_into_nb"):
        n = fw.recv_into_nb(sock.fileno(), view)
        if n < 0 and n != -2:
            raise OSError(-n, os.strerror(-n))
        return n
    try:
        n = sock.recv_into(view)
    except (BlockingIOError, InterruptedError):
        return 0
    return -2 if n == 0 else n


_AGAIN = "again"
_EOF = "eof"


class _FrameReader:
    """Incremental FTP1 frame parser: prefix → header → payload, caps
    validated before any payload allocation, large tree payloads
    scatter-filled into pooled per-segment buffers (the same segmentation
    rule as the blocking receive path)."""

    def __init__(self, max_payload: Optional[int]):
        self._cap = sockio._effective_cap(max_payload)
        self._targets: List[memoryview] = []
        self._bufs: List = []
        self._ti = 0
        self._got = 0
        self._ftype = 0
        self._plen = 0
        self._header: Optional[Dict] = None
        self._reset()

    def _reset(self) -> None:
        self._stage = "prefix"
        self._header = None
        self._bufs = []
        self._targets = [memoryview(bytearray(wire.PREFIX_LEN))]
        self._ti = 0
        self._got = 0

    def step(self, sock):
        """Advance the state machine. Returns ``_AGAIN`` (would block),
        ``_EOF``, or a completed ``(ftype, header, payload)`` frame.
        Raises WireError on protocol violations."""
        while True:
            view = self._targets[self._ti]
            if self._got < view.nbytes:
                n = _read_into_nb(sock, view[self._got:])
                if n == 0:
                    return _AGAIN
                if n == -2:
                    return _EOF
                self._got += n
                if self._got < view.nbytes:
                    return _AGAIN
            self._ti += 1
            self._got = 0
            if self._ti < len(self._targets):
                continue
            if self._stage == "prefix":
                frame = self._on_prefix()
            elif self._stage == "header":
                frame = self._on_header()
            else:
                frame = self._assemble()
            if frame is not None:
                return frame

    def _on_prefix(self):
        magic, version, ftype, hlen, plen = wire._PREFIX.unpack(
            bytes(self._targets[0])
        )
        if magic != wire.WIRE_MAGIC:
            raise wire.WireError(f"bad magic {magic!r}")
        if version != wire.WIRE_VERSION:
            raise wire.WireError(f"unsupported wire version {version}")
        if hlen > wire._MAX_HEADER:
            raise wire.WireError(f"header length {hlen} exceeds cap")
        if plen > self._cap:
            raise wire.WireError(
                f"payload length {plen} exceeds cap {self._cap}"
            )
        self._ftype, self._plen = ftype, plen
        self._stage = "header"
        self._targets = [memoryview(bytearray(hlen))]
        self._ti = 0
        return None

    def _on_header(self):
        self._header = msgpack.unpackb(bytes(self._targets[0]), raw=False)
        plen = self._plen
        if not plen:
            frame = (self._ftype, self._header, memoryview(b""))
            self._reset()
            return frame
        self._stage = "payload"
        sizes = sockio._segment_sizes(self._header, plen)
        self._bufs = []
        if sizes is None:
            buf = (
                bytearray(plen)
                if plen <= sockio.SMALL_FRAME_MAX
                else sockio._RECV_POOL.take(plen)
            )
            self._bufs.append(buf)
            self._targets = [memoryview(buf)]
        else:
            self._targets = []
            for n in sizes:
                buf = sockio._RECV_POOL.take(n)
                self._bufs.append(buf)
                self._targets.append(memoryview(buf))
        self._ti = 0
        return None

    def _assemble(self):
        from rayfed_tpu_torch._private import serialization

        if len(self._bufs) == 1:
            payload = memoryview(self._bufs[0])
        else:
            segments = []
            pos = 0
            for buf in self._bufs:
                segments.append((pos, buf))
                pos += memoryview(buf).nbytes
            payload = serialization.SegmentedPayload(segments)
        frame = (self._ftype, self._header, payload)
        self._reset()
        return frame


class _AckParser:
    """RESP-frame accumulator for sender lanes (acks are tiny: the whole
    frame is buffered, then parsed)."""

    def __init__(self):
        self._acc = bytearray()

    def reset(self) -> None:
        self._acc.clear()

    def feed(self, data) -> List[Dict]:
        self._acc += data
        out = []
        while len(self._acc) >= wire.PREFIX_LEN:
            magic, version, ftype, hlen, plen = wire._PREFIX.unpack_from(
                self._acc
            )
            if magic != wire.WIRE_MAGIC:
                raise wire.WireError(f"bad magic {magic!r}")
            if version != wire.WIRE_VERSION:
                raise wire.WireError(f"unsupported wire version {version}")
            if ftype != wire.FTYPE_RESP:
                raise wire.WireError(f"expected RESP, got {ftype}")
            if wire.PREFIX_LEN + hlen + plen > wire.MAX_RESP_FRAME:
                raise wire.WireError("oversized RESP frame")
            need = wire.PREFIX_LEN + hlen + plen
            if len(self._acc) < need:
                break
            header = msgpack.unpackb(
                bytes(self._acc[wire.PREFIX_LEN:wire.PREFIX_LEN + hlen]),
                raw=False,
            )
            out.append(header)
            del self._acc[:need]
        return out


# ---------------------------------------------------------------------------
# Sender lane
# ---------------------------------------------------------------------------


class ReactorLane:
    """Pipelined sender lane driven by a shared reactor instead of a
    per-peer writer thread + per-reconnect reader thread.

    Drop-in for :class:`~rayfed_tpu_torch.proxy.tcp.pipeline.PipelinedLane`:
    same constructor shape, same ``submit(out, header, buffers, nbytes)``
    / ``close()`` interface, same failure semantics (see module
    docstring). The send window is a semaphore so window occupancy stays
    observable the same way (``_window._value``)."""

    def __init__(
        self,
        dest: str,
        connect,
        max_attempts: int,
        ack_timeout_s: float,
        on_ack,
        window: int = 8,
        small_threshold: int = 0,
        reactor: Optional[Reactor] = None,
        adaptive_timeout=None,
    ):
        self._dest = dest
        self._connect = connect
        self._max_attempts = max_attempts
        self._ack_timeout_s = ack_timeout_s
        # Optional (base_s, nbytes) -> timeout_s hook: link-health RTT
        # estimate plus a transfer-time allowance for the frame size, so
        # a slow WAN shrinks the ack deadline no further than the bytes
        # in flight can actually clear it (resilience/linkhealth.py).
        self._adaptive_timeout = adaptive_timeout
        self._on_ack = on_ack
        self._small_threshold = small_threshold
        self._reactor = reactor or acquire_reactors(1)[0]
        self._owns_ref = reactor is None
        self._next_fseq = 0
        self._submit_lock = threading.Lock()
        self._lock = threading.Lock()
        self._window = threading.Semaphore(max(1, window))
        self._pending: deque = deque()  # jobs without a window slot yet
        self._inflight: deque = deque()  # written, awaiting fseq ack
        self._outbox: deque = deque()  # wire chunks not yet written
        self._acks = _AckParser()
        self._rbuf = bytearray(64 * 1024)
        self._sock = None
        self.fd = -1
        self._broken = True
        self._closed = False
        self._peer_down = False
        self._dialing = False
        self._inline_busy = False
        self._reactor.add_ticker(self._tick)
        _m_open_lanes.inc()

    # -- submission (any thread) ---------------------------------------------

    def submit(self, out: Future, header, buffers, nbytes: int = 0) -> None:
        # fseq assignment is locked: inline sends submit from arbitrary
        # caller threads; acks match by fseq, never by position.
        with self._submit_lock:
            self._next_fseq += 1
            fseq = self._next_fseq
        job = _Inflight(out, dict(header, fseq=fseq), buffers, fseq, nbytes)
        if (
            self._small_threshold > 0
            and 0 < nbytes <= self._small_threshold
            and self._try_inline_send(job)
        ):
            return
        with self._lock:
            if self._closed:
                out.set_exception(ConnectionError("sender stopped"))
                return
            self._pending.append(job)
        self._reactor.run_soon(self._pump)

    def _try_inline_send(self, job: _Inflight) -> bool:
        """Zero-hop dispatch on the CALLER's thread when the lane is idle
        (live connection, free window slot, empty ring+queue). Every gate
        is nonblocking; contention falls back to the reactor. A partial
        write parks the remainder at the ring head and raises write
        interest — the reactor finishes the frame."""
        if not self._window.acquire(blocking=False):
            return False
        with self._lock:
            ok = (
                self.fd >= 0
                and not self._broken
                and not self._closed
                and not self._pending
                and not self._outbox
                and not self._inline_busy
            )
            if ok:
                job.attempts += 1
                job.sent_at = time.monotonic()
                self._inflight.append(job)
                self._inline_busy = True
                fd = self.fd
        if not ok:
            self._window.release()
            return False
        if sanitize.enabled():
            sanitize.probe_inline_busy_set(id(self))
        chunks = self._wire_chunks(job)
        total = sum(c.nbytes if isinstance(c, memoryview) else len(c)
                    for c in chunks)
        n = _nb_writev(fd, chunks)
        if n < 0:
            with self._lock:
                self._inline_busy = False
            if sanitize.enabled():
                sanitize.probe_inline_busy_clear(id(self))
            err = ConnectionError(
                f"send failed: {os.strerror(-n) if n != -1 else 'io error'}"
            )
            self._reactor.run_soon(lambda: self._on_break(err))
            return True  # the break machinery owns the job now
        if n < total:
            rem = _advance_chunks(chunks, n)
            with self._lock:
                self._inline_busy = False
                self._outbox.extendleft(reversed(rem))
            if sanitize.enabled():
                sanitize.probe_inline_busy_clear(id(self))
            self._reactor.run_soon(self._resume_write)
        else:
            with self._lock:
                self._inline_busy = False
                backlog = bool(self._pending or self._outbox)
            if sanitize.enabled():
                sanitize.probe_inline_busy_clear(id(self))
            _m_inline_sends.inc()
            if backlog:
                self._reactor.run_soon(self._pump)
        return True

    def close(self) -> None:
        """Synchronous teardown: every queued/unacked frame's future
        resolves (ConnectionError) even if the reactor is already gone."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            jobs = list(self._inflight) + list(self._pending)
            self._inflight.clear()
            self._pending.clear()
            self._outbox.clear()
            sock, fd = self._sock, self.fd
            self._sock, self.fd = None, -1
        # An inline send may have captured the fd under the lock *before*
        # _closed was set and still be inside its nonblocking writev.
        # Closing the socket now would free the descriptor mid-write: the
        # kernel can hand the same fd number to an unrelated file, and
        # the stray writev then corrupts it. Drain the inline writer
        # (bounded — it never blocks, so this is microseconds in
        # practice) before releasing the descriptor.
        deadline = time.monotonic() + 0.5
        while True:
            with self._lock:
                busy = self._inline_busy
            if not busy or time.monotonic() >= deadline:
                break
            time.sleep(0.0005)
        _m_open_lanes.inc(-1)
        err = ConnectionError("sender stopped")
        for job in jobs:
            if not job.out.done():
                job.out.set_exception(err)
        if sock is not None:
            try:
                sock.close()  # closing the fd drops it from epoll too
            except OSError:
                pass
        self._reactor.remove_ticker(self._tick)
        if fd >= 0:
            self._reactor.unregister(fd)  # registry cleanup (fd reuse)
        if self._owns_ref:
            release_reactors()

    # -- reactor-thread machinery --------------------------------------------

    def _wire_chunks(self, job: _Inflight) -> List:
        """Wire chunks for one transmission of ``job``. A registered
        wire taint (chaos ``corrupt`` fault with frame_crc on) flips one
        bit in a COPY of the affected buffer for THIS transmission only —
        ``job.buffers`` stays clean, so the crc-NACK retransmit carries
        the original bytes (resilience/inject.py)."""
        buffers = job.buffers
        up, down = job.header.get("up"), job.header.get("down")
        taint = fault_inject.take_wire_taint(self._dest, up, down)
        if taint is not None:
            buffers = fault_inject.corrupt_wire_buffers(
                buffers, self._dest, up, down, taint
            )
        return _frame_chunks(job.header, buffers)

    def _pump(self) -> None:
        """Move pending jobs into the ring as window slots allow; dial if
        the connection is down. Loop thread only."""
        if sanitize.enabled():
            sanitize.probe_reactor_affinity(self._reactor, "ReactorLane._pump")
        with self._lock:
            if self._closed or self._inline_busy:
                return
            if self._broken or self.fd < 0:
                need_dial = (
                    bool(self._pending or self._inflight)
                    and not self._dialing
                )
                if need_dial:
                    self._dialing = True
            else:
                need_dial = False
        if need_dial:
            threading.Thread(
                target=self._dial_thread,
                name=f"fedtpu-dial-{self._dest}",
                daemon=True,
            ).start()
            return
        if self._broken or self.fd < 0:
            return
        moved = False
        while self._window.acquire(blocking=False):
            with self._lock:
                if not self._pending:
                    self._window.release()
                    break
                job = self._pending.popleft()
                job.attempts += 1
                job.sent_at = time.monotonic()
                self._inflight.append(job)
                self._outbox.extend(self._wire_chunks(job))
                moved = True
        if moved or self._outbox:
            self._reactor.mark_dirty(self)

    def _resume_write(self) -> None:
        if self._outbox and not self._closed:
            self._reactor.mark_dirty(self)

    def pending_chunks(self) -> List:
        with self._lock:
            if self._inline_busy:
                return []
            return list(self._outbox)

    def on_flushed(self, result: int) -> None:
        if sanitize.enabled():
            sanitize.probe_reactor_affinity(
                self._reactor, "ReactorLane.on_flushed"
            )
        if result < 0:
            self._on_break(ConnectionError(
                f"send failed: {os.strerror(-result)}"
            ))
            return
        with self._lock:
            n = result
            while n > 0 and self._outbox:
                head = self._outbox[0]
                size = head.nbytes if isinstance(head, memoryview) \
                    else len(head)
                if n >= size:
                    self._outbox.popleft()
                    n -= size
                else:
                    self._outbox[0] = memoryview(head)[n:]
                    n = 0
            remaining = bool(self._outbox)
        self._reactor.set_write_interest(self.fd, remaining)
        if not remaining:
            self._pump()  # pull in whatever queued behind the ring

    def on_readable(self) -> None:
        sock = self._sock
        if sock is None:
            return
        try:
            while True:
                view = memoryview(self._rbuf)
                n = _read_into_nb(sock, view)
                if n == 0:
                    return
                if n == -2:
                    raise ConnectionError("peer closed connection")
                for resp in self._acks.feed(view[:n]):
                    self._handle_ack(resp)
        except (OSError, ConnectionError, wire.WireError) as e:
            if not self._closed:
                self._on_break(e)

    def _handle_ack(self, resp: Dict) -> None:
        from rayfed_tpu_torch._private.constants import CODE_DATA_CORRUPT, CODE_OK

        fseq = resp.get("fseq")
        now = time.monotonic()
        with self._lock:
            job = None
            for candidate in self._inflight:
                if candidate.fseq == fseq:
                    job = candidate
                    break
            if job is None:
                return  # ack for a frame we already timed out / resent
            self._inflight.remove(job)
            backlog = bool(self._pending)
        self._window.release()
        if backlog:
            # The freed slot must pull the next queued job in — the
            # threaded lane's writer blocks on the semaphore and wakes on
            # release; here the pump has to be scheduled explicitly.
            self._pump()
        code = resp.get("code")
        if code == CODE_OK:
            # Ack round-trip = wire latency + receiver offer; both belong
            # in the adaptive-deadline estimate (resilience/linkhealth.py).
            linkhealth.observe_rtt(self._dest, now - job.sent_at)
            self._on_ack()
            job.out.set_result(True)
        elif code == CODE_DATA_CORRUPT and job.attempts < self._max_attempts:
            # Frame-integrity NACK: the bytes we hold are fine (the crc
            # was stamped over them), the wire mangled the frame. Requeue
            # at the head — the stored buffers retransmit clean, bounded
            # by the same attempt budget as reconnect resends.
            _m_crc_resends.inc()
            logger.warning(
                "peer %s NACKed frame fseq=%s as corrupt; retransmitting "
                "(attempt %d/%d)",
                self._dest, fseq, job.attempts, self._max_attempts,
            )
            with self._lock:
                if self._closed:
                    job.out.set_exception(ConnectionError("sender stopped"))
                    return
                self._pending.appendleft(job)
            self._pump()
        else:
            logger.warning(
                "peer rejected send: code=%s message=%s",
                code, resp.get("msg"),
            )
            job.out.set_exception(
                RuntimeError(f"send rejected: code={code} {resp.get('msg')}")
            )

    def on_error(self, err: Exception) -> None:
        if not self._closed:
            self._on_break(err)

    def _tick(self, now: float) -> None:
        """Ack timeouts + broken-lane redials (reactor tick cadence)."""
        expired = None
        timeout_s = self._ack_timeout_s
        with self._lock:
            if self._closed:
                return
            if self._inflight and not self._broken and not self._dialing:
                head = self._inflight[0]
                if self._adaptive_timeout is not None:
                    timeout_s = self._adaptive_timeout(
                        self._ack_timeout_s, head.nbytes
                    )
                if now - head.sent_at > timeout_s:
                    expired = self._inflight.popleft()
        if expired is not None:
            linkhealth.observe_loss(self._dest)
            self._window.release()
            expired.out.set_exception(
                TimeoutError(
                    f"no ack from {self._dest} within {timeout_s:.3f}s"
                )
            )
            self._on_break(ConnectionError("ack timeout"))
            return
        with self._lock:
            stalled = (
                (self._broken or self.fd < 0)
                and (self._inflight or self._pending)
                and not self._dialing
            )
        if stalled:
            self._pump()

    # -- failure / reconnect --------------------------------------------------

    def _on_break(self, err: Exception) -> None:
        """Mark broken; fail frames that exhausted their attempt budget,
        keep the rest for resend after reconnect. Loop thread only."""
        with self._lock:
            if self._closed:
                return
            self._broken = True
            _m_lane_breaks.inc()
            sock, self._sock, fd, self.fd = self._sock, None, self.fd, -1
            self._outbox.clear()
            self._acks.reset()
            survivors: deque = deque()
            failed = []
            for job in self._inflight:
                if job.attempts >= self._max_attempts:
                    failed.append(job)
                else:
                    survivors.append(job)
            self._inflight = survivors
            has_work = bool(survivors or self._pending)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._reactor.unregister(fd)
        for job in failed:
            self._window.release()
            job.out.set_exception(
                ConnectionError(
                    f"send to {self._dest} failed after "
                    f"{job.attempts} attempts: {err}"
                )
            )
        if has_work:
            self._pump()  # schedules the redial

    def _dial_thread(self) -> None:
        """Blocking connect on a transient thread — the reactor never
        blocks on a dial. Probe budget (2 attempts) once the peer is
        known down, full budget otherwise (the pipelined lane's fast-fail
        contract)."""
        probe_only = self._peer_down
        try:
            sock = self._connect(2 if probe_only else None)
        except Exception as e:  # noqa: BLE001 - budget exhausted
            self._peer_down = True
            # Default-arg capture: the except variable is unbound once the
            # block exits, long before the loop runs this callback.
            self._reactor.run_soon(lambda err=e: self._dial_failed(err))
            return
        sock.setblocking(False)
        self._reactor.run_soon(lambda: self._dial_done(sock))

    def _dial_done(self, sock) -> None:
        with self._lock:
            self._dialing = False
            if self._closed:
                closed = True
            else:
                closed = False
                self._sock = sock
                self.fd = sock.fileno()
                self._broken = False
                self._peer_down = False
                self._acks.reset()
                # Resend every unacked frame in fseq order before any new
                # frame (receiver offers are idempotent per (up, down)).
                now = time.monotonic()
                for job in self._inflight:
                    job.attempts += 1
                    job.sent_at = now
                    self._outbox.extend(self._wire_chunks(job))
        if closed:
            try:
                sock.close()
            except OSError:
                pass
            return
        _m_lane_dials.inc()
        self._reactor.register(self)
        self._pump()
        if self._outbox:
            self._reactor.mark_dirty(self)

    def _dial_failed(self, err: Exception) -> None:
        """The full connect budget is exhausted: the peer is gone. Fail
        every queued and unacked frame NOW with the dial's ConnectionError
        — retrying forever would leave futures unresolved and wedge the
        cleanup drain (exact pipelined-lane semantics)."""
        with self._lock:
            self._dialing = False
            if self._closed:
                return
            inflight = list(self._inflight)
            pending = list(self._pending)
            self._inflight.clear()
            self._pending.clear()
            self._outbox.clear()
        for job in inflight:
            self._window.release()
            if not job.out.done():
                job.out.set_exception(err)
        for job in pending:
            if not job.out.done():
                job.out.set_exception(err)


# ---------------------------------------------------------------------------
# Receiver-side connection
# ---------------------------------------------------------------------------


class ServerConnection:
    """One inbound plaintext connection served by the reactor: an
    incremental DATA-frame reader feeding the rendezvous store, with RESP
    acks queued on the connection's ring and flushed once per poll batch
    (ack piggybacking: a burst of N frames costs one ack write)."""

    def __init__(self, reactor: Reactor, sock, peer, offer, on_close=None,
                 max_payload: Optional[int] = None):
        sock.setblocking(False)
        self._sock = sock
        self.fd = sock.fileno()
        self._peer = peer
        self._offer = offer  # (header, payload) -> (code, msg)
        self._on_close = on_close
        self._reactor = reactor
        self._reader = _FrameReader(max_payload)
        self._outbox: deque = deque()
        self._closed = False
        reactor.register(self)

    def queue_resp(self, resp_header: Dict) -> None:
        self._outbox.append(
            wire.encode_prefix_and_header(wire.FTYPE_RESP, resp_header, 0)
        )

    def on_readable(self) -> None:
        from rayfed_tpu_torch._private.constants import CODE_INTERNAL_ERROR

        try:
            for _ in range(_FRAMES_PER_EVENT):
                result = self._reader.step(self._sock)
                if result is _AGAIN:
                    break
                if result is _EOF:
                    self.close()
                    break
                ftype, header, payload = result
                if ftype != wire.FTYPE_DATA:
                    self.queue_resp(
                        {"code": CODE_INTERNAL_ERROR,
                         "msg": "expected DATA frame"}
                    )
                    continue
                code, msg = self._offer(header, payload)
                # Echo fseq: pipelined acks match by it, never by position.
                self.queue_resp(
                    {"code": code, "msg": msg, "fseq": header.get("fseq")}
                )
        except wire.WireError as e:
            # Oversized/bad frame: tear the connection down before
            # buffering anything (memory protection).
            logger.warning(
                "dropping connection from %s: %s", self._peer, e
            )
            self.close()
            return
        except (OSError, ConnectionError):
            self.close()
            return
        if self._outbox and not self._closed:
            self._reactor.mark_dirty(self)

    def pending_chunks(self) -> List:
        return list(self._outbox)

    def on_flushed(self, result: int) -> None:
        if result < 0:
            self.close()
            return
        n = result
        while n > 0 and self._outbox:
            head = self._outbox[0]
            size = head.nbytes if isinstance(head, memoryview) else len(head)
            if n >= size:
                self._outbox.popleft()
                n -= size
            else:
                self._outbox[0] = memoryview(head)[n:]
                n = 0
        self._reactor.set_write_interest(self.fd, bool(self._outbox))

    def on_error(self, err: Exception) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._outbox.clear()
        try:
            self._sock.close()
        except OSError:
            pass
        self._reactor.unregister(self.fd)
        if self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:  # noqa: BLE001 - bookkeeping only
                pass
