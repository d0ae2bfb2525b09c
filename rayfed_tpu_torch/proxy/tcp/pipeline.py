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

"""Pipelined sender lane: stream DATA frames back-to-back, ack asynchronously.

The request-response shape of the reference's transport (one unary RPC per
object, ``fed/grpc/fed.proto:5-7``) leaves the pipe idle for a full
round-trip per payload — on a shared-core host that alternation halves
throughput. This lane keeps a bounded window of unacknowledged frames in
flight: a writer thread streams frames, a reader thread consumes RESP
frames (TCP ordering guarantees acks arrive FIFO), and on a connection
break every unacked frame is resent after reconnect (receiver offers are
idempotent per (up, down) rendezvous key, so duplicates are harmless).

Used for plaintext connections only: ``ssl.SSLSocket`` does not support
concurrent send/recv from two threads, so TLS sends use the half-duplex
worker in ``tcp_proxy``.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Empty, Queue
from typing import Callable, Optional

from rayfed_tpu_torch._private.constants import CODE_DATA_CORRUPT, CODE_OK
from rayfed_tpu_torch.proxy.tcp import sockio, wire
from rayfed_tpu_torch.resilience import inject as fault_inject
from rayfed_tpu_torch.resilience import linkhealth
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

# Shared by both lane engines (reactor.py imports it from here): frames
# retransmitted after a peer frame-integrity NACK (docs/observability.md).
_m_crc_resends = telemetry_metrics.get_registry().counter(
    "fed_transport_frame_crc_retransmits_total",
    "Frames retransmitted after a peer crc NACK (CODE_DATA_CORRUPT).",
)

# Default max unacknowledged frames in flight (config knob: send_window).
# Payload buffers stay referenced until acked, so the window bounds resend
# memory at window x payload size — 8 x 100MB = 800MB worst case; lower it
# for memory-tight hosts, raise it for high-BDP links.
WINDOW = 8


# Max frames drained into one coalesced small-frame dispatch. Each batch
# frame still occupies its own window slot, so the window semaphore keeps
# bounding resend memory; the batch cap only bounds a single writev's
# latency cost for the frames queued behind it.
_BATCH_MAX = 16


class _Inflight:
    __slots__ = (
        "out", "header", "buffers", "attempts", "sent_at", "fseq", "nbytes"
    )

    def __init__(self, out: Future, header, buffers, fseq: int,
                 nbytes: int = 0):
        self.out = out
        self.header = header
        self.buffers = buffers
        self.attempts = 0
        self.sent_at = 0.0
        self.fseq = fseq
        self.nbytes = nbytes


class PipelinedLane:
    """One destination's pipelined connection. ``submit`` enqueues an
    encoded frame; its Future resolves True on ack (or raises)."""

    def __init__(
        self,
        dest: str,
        connect: Callable[[Optional[int]], socket.socket],
        max_attempts: int,
        ack_timeout_s: float,
        on_ack: Callable[[], None],
        window: int = WINDOW,
        small_threshold: int = 0,
        adaptive_timeout=None,
    ):
        self._dest = dest
        self._connect = connect
        self._max_attempts = max_attempts
        self._ack_timeout_s = ack_timeout_s
        # Optional (base_s, nbytes) -> timeout_s hook from the link-health
        # estimator — same contract as ReactorLane (resilience/linkhealth.py).
        self._adaptive_timeout = adaptive_timeout
        self._on_ack = on_ack
        # Frames at/below this payload size may be coalesced with other
        # queued frames into one vectored write (0 disables batching).
        self._small_threshold = small_threshold
        self._next_fseq = 0
        self._submit_lock = threading.Lock()
        self._jobs: Queue = Queue()
        self._lock = threading.Lock()
        # Serializes actual socket writes: the writer thread, resend path
        # and the inline small-send fast path must never interleave the
        # bytes of two frames on the wire.
        self._send_mutex = threading.Lock()
        self._inflight: deque = deque()
        self._window = threading.Semaphore(max(1, window))
        self._sock: Optional[socket.socket] = None
        self._broken = True
        self._closed = False
        # Set once a full connect budget failed: subsequent frames probe
        # with a single connect attempt (fast-fail for a queued backlog to
        # a dead peer) instead of each burning the whole budget; any
        # successful connect clears it, so a recovered peer resumes.
        self._peer_down = False
        self._reader_gen = 0
        self._writer = threading.Thread(
            target=self._writer_loop, name=f"fedtpu-pipe-w-{dest}", daemon=True
        )
        self._writer.start()

    def submit(self, out: Future, header, buffers, nbytes: int = 0) -> None:
        # Frames carry a per-lane sequence number which the receiver echoes
        # in its RESP; acks are matched by it, never by position — a late
        # ack for a timed-out/resent frame must not resolve its successor.
        # fseq assignment is locked: the inline send fast path submits
        # from arbitrary caller threads, not only the dest worker (frames
        # may hit the wire out of fseq order, which is harmless — acks
        # match by fseq, never by position).
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
        self._jobs.put(job)

    def _wire_frame(self, job: _Inflight):
        """(ftype, header, buffers) for one transmission of ``job``. A
        registered wire taint (chaos ``corrupt`` fault with frame_crc on)
        flips one bit in a COPY of the affected buffer for THIS
        transmission only — ``job.buffers`` stays clean, so the crc-NACK
        retransmit carries the original bytes (resilience/inject.py)."""
        buffers = job.buffers
        up, down = job.header.get("up"), job.header.get("down")
        taint = fault_inject.take_wire_taint(self._dest, up, down)
        if taint is not None:
            buffers = fault_inject.corrupt_wire_buffers(
                buffers, self._dest, up, down, taint
            )
        return (wire.FTYPE_DATA, job.header, buffers)

    def _try_inline_send(self, job: _Inflight) -> bool:
        """Zero-hop dispatch: when the lane is idle — live connection,
        free window slot, no queued backlog, write mutex uncontended —
        write the frame on the CALLER's thread instead of waking the
        writer. Every gate is non-blocking; any contention falls back to
        the queue. An inline frame may overtake queued frames on the
        wire, which is harmless: acks match by fseq and every (up, down)
        edge is a unique rendezvous key. Returns True when the job was
        dispatched (or handed to the break/resend machinery)."""
        if not self._window.acquire(blocking=False):
            return False
        if not self._send_mutex.acquire(blocking=False):
            self._window.release()
            return False
        try:
            with self._lock:
                sock = self._sock
                ok = (
                    sock is not None
                    and not self._broken
                    and not self._closed
                    and self._jobs.empty()
                )
                if ok:
                    job.attempts += 1
                    job.sent_at = time.monotonic()
                    self._inflight.append(job)
            if not ok:
                self._window.release()
                return False
            try:
                sockio.send_frames(sock, [self._wire_frame(job)])
            except (OSError, ConnectionError) as e:
                # The job is tracked in _inflight: the break machinery
                # owns it now (resend from _tick, or attempt-budget fail).
                self._handle_break(e)
            return True
        finally:
            self._send_mutex.release()

    def close(self) -> None:
        self._closed = True
        self._jobs.put(None)

    # -- writer ---------------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            try:
                job = self._jobs.get(timeout=0.2)
            except Empty:
                self._tick()
                continue
            if job is None:
                self._teardown(ConnectionError("sender stopped"))
                return
            # Head job's window slot first. The acquire must not park
            # unconditionally: if the connection broke while the window
            # is full, only _tick() can time out / resend stuck frames.
            stopped = False
            while not self._window.acquire(timeout=0.2):
                self._tick()
                if self._closed:
                    stopped = True
                    break
            if stopped:
                err = ConnectionError("sender stopped")
                job.out.set_exception(err)
                self._teardown(err)
                return
            # Small-frame coalescing: when the head job is small, drain
            # whatever else is already queued (up to _BATCH_MAX; a large
            # job ends the batch) so the whole run goes out in ONE
            # vectored write instead of one syscall per frame. Each extra
            # frame must find a free window slot RIGHT NOW: blocking for
            # one later would park waiting for the ack of a frame this
            # very batch hasn't sent yet (deadlock when window < batch).
            batch = [job]
            close_after = False
            if (
                self._small_threshold > 0
                and job.nbytes <= self._small_threshold
            ):
                while len(batch) < _BATCH_MAX:
                    if not self._window.acquire(blocking=False):
                        break
                    try:
                        nxt = self._jobs.get_nowait()
                    except Empty:
                        self._window.release()
                        break
                    if nxt is None:
                        self._window.release()
                        close_after = True
                        break
                    batch.append(nxt)
                    if nxt.nbytes > self._small_threshold:
                        break
            if not self._dispatch(batch):
                # Closed during a failed dispatch: drain every pending
                # future so no consumer blocks forever.
                self._teardown(ConnectionError("sender stopped"))
                return
            if close_after:
                self._teardown(ConnectionError("sender stopped"))
                return

    def _dispatch(self, jobs) -> bool:
        """Send a batch of jobs (reconnecting/resending as needed) in one
        vectored write. Returns False only when the lane is closed."""
        if self._closed:
            # Closed before the first attempt: these jobs are in neither
            # _inflight nor _jobs, so fail them here or nobody ever will.
            for job in jobs:
                self._window.release()
                job.out.set_exception(ConnectionError("sender stopped"))
            return False
        while not self._closed:
            try:
                sock = self._ensure_conn()
            except Exception as e:  # noqa: BLE001 - connect budget exhausted
                for job in jobs:
                    self._window.release()
                    job.out.set_exception(e)
                return True
            with self._lock:
                now = time.monotonic()
                for job in jobs:
                    self._inflight.append(job)
                    job.attempts += 1
                    job.sent_at = now
            try:
                with self._send_mutex:
                    sockio.send_frames(
                        sock, [self._wire_frame(j) for j in jobs]
                    )
                return True
            except (OSError, ConnectionError) as e:
                self._handle_break(e)
                # _handle_break either requeued the jobs for resend (they
                # were unacked) or failed them; either way this dispatch
                # is done once the resend path below drains.
                if not self._resend_unacked():
                    return not self._closed
                return True
        return False

    def _ensure_conn(self) -> socket.socket:
        with self._lock:
            if self._sock is not None and not self._broken:
                return self._sock
            probe_only = self._peer_down
        try:
            # Probe with a small budget (not 1): a lone attempt landing in
            # a transient blip of a *recovered* peer would spuriously fail
            # the frame — and possibly escalate via exit_on_sending_failure.
            sock = self._connect(2 if probe_only else None)
        except (OSError, ConnectionError):
            self._peer_down = True
            raise
        with self._lock:
            self._sock = sock
            self._broken = False
            self._peer_down = False
            self._reader_gen += 1
            gen = self._reader_gen
        threading.Thread(
            target=self._reader_loop, args=(sock, gen),
            name=f"fedtpu-pipe-r-{self._dest}", daemon=True,
        ).start()
        return sock

    def _resend_unacked(self) -> bool:
        """After a reconnect, resend every inflight (unacked) frame in
        order. Returns True on success."""
        while not self._closed:
            with self._lock:
                pending = list(self._inflight)
            if not pending:
                return True
            try:
                sock = self._ensure_conn()
            except (OSError, ConnectionError) as e:
                # The full connect budget is exhausted: the peer is gone.
                # Fail every unacked frame NOW — retrying forever would
                # leave their futures unresolved, wedging the cleanup
                # drain and any exit_on_sending_failure escalation.
                self._fail_all_inflight(e)
                return False
            try:
                now = time.monotonic()
                for job in pending:
                    job.attempts += 1
                    job.sent_at = now
                with self._send_mutex:
                    sockio.send_frames(
                        sock, [self._wire_frame(j) for j in pending]
                    )
                return True
            except (OSError, ConnectionError) as e:
                self._handle_break(e)
        return False

    def _fail_all_inflight(self, err: Exception) -> None:
        with self._lock:
            self._broken = True
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            jobs = list(self._inflight)
            self._inflight.clear()
        for job in jobs:
            self._window.release()
            job.out.set_exception(
                ConnectionError(
                    f"peer {self._dest} unreachable with frame in flight: {err}"
                )
            )

    def _tick(self) -> None:
        """Idle housekeeping: ack timeouts and broken-connection resends."""
        now = time.monotonic()
        expired = None
        timeout_s = self._ack_timeout_s
        with self._lock:
            if self._inflight:
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
            self._handle_break(ConnectionError("ack timeout"))
            return
        with self._lock:
            broken_with_work = self._broken and self._inflight
        if broken_with_work:
            self._resend_unacked()

    # -- reader ---------------------------------------------------------------

    def _reader_loop(self, sock: socket.socket, gen: int) -> None:
        try:
            while True:
                try:
                    ftype, resp, _ = sockio.recv_frame(
                        sock, max_payload=wire.MAX_RESP_FRAME
                    )
                except socket.timeout:
                    # Idle timeout with nothing in flight is benign (no RESP
                    # is owed, so we are at a frame boundary); with frames
                    # in flight it means the peer stalled.
                    with self._lock:
                        waiting = bool(self._inflight)
                    if not waiting:
                        continue
                    raise ConnectionError("peer stalled: ack overdue")
                if ftype != wire.FTYPE_RESP:
                    raise wire.WireError(f"expected RESP, got {ftype}")
                fseq = resp.get("fseq")
                with self._lock:
                    if gen != self._reader_gen and not self._inflight:
                        return  # superseded by a reconnect, nothing to ack
                    job = None
                    for candidate in self._inflight:
                        if candidate.fseq == fseq:
                            job = candidate
                            break
                    if job is None:
                        # Ack for a frame we already timed out / resent and
                        # matched elsewhere — drop it.
                        continue
                    self._inflight.remove(job)
                self._window.release()
                code = resp.get("code")
                if code == CODE_OK:
                    # Ack round-trip feeds the adaptive-deadline estimate
                    # (resilience/linkhealth.py).
                    linkhealth.observe_rtt(
                        self._dest, time.monotonic() - job.sent_at
                    )
                    self._on_ack()
                    job.out.set_result(True)
                elif (
                    code == CODE_DATA_CORRUPT
                    and job.attempts < self._max_attempts
                ):
                    # Frame-integrity NACK: our stored buffers are clean
                    # (the crc was stamped over them) — requeue for a
                    # retransmit, bounded by the same attempt budget as
                    # reconnect resends.
                    _m_crc_resends.inc()
                    logger.warning(
                        "peer %s NACKed frame fseq=%s as corrupt; "
                        "retransmitting (attempt %d/%d)",
                        self._dest, fseq, job.attempts, self._max_attempts,
                    )
                    self._jobs.put(job)
                else:
                    logger.warning(
                        "peer rejected send: code=%s message=%s",
                        code, resp.get("msg"),
                    )
                    job.out.set_exception(
                        RuntimeError(
                            f"send rejected: code={code} {resp.get('msg')}"
                        )
                    )
        except (OSError, ConnectionError, wire.WireError) as e:
            with self._lock:
                stale = gen != self._reader_gen
            if not stale and not self._closed:
                self._handle_break(e)

    # -- failure --------------------------------------------------------------

    def _handle_break(self, err: Exception) -> None:
        """Mark the connection broken; fail jobs that exhausted their
        attempt budget, keep the rest queued for resend."""
        with self._lock:
            self._broken = True
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            survivors = deque()
            failed = []
            for job in self._inflight:
                if job.attempts >= self._max_attempts:
                    failed.append(job)
                else:
                    survivors.append(job)
            self._inflight = survivors
        for job in failed:
            self._window.release()
            job.out.set_exception(
                ConnectionError(
                    f"send to {self._dest} failed after "
                    f"{job.attempts} attempts: {err}"
                )
            )

    def _teardown(self, err: Exception) -> None:
        with self._lock:
            jobs = list(self._inflight)
            self._inflight.clear()
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
        for job in jobs:
            if not job.out.done():
                job.out.set_exception(err)
        while True:
            try:
                job = self._jobs.get_nowait()
            except Empty:
                return
            if job is not None and not job.out.done():
                job.out.set_exception(err)
