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

"""Default native transport: threaded blocking-socket sender/receiver.

Capability parity with the reference's gRPC transport
(``fed/proxy/grpc/grpc_proxy.py``):

 - persistent per-destination connection reused across sends
   (ref grpc_proxy.py:117,123-141 reuses one channel/stub per dest);
 - retry policy with exponential backoff on connection failures
   (ref grpc_options.py:19-25 — 5 attempts, 5s..30s, x2);
 - (upstream_seq_id, downstream_seq_id) rendezvous where data may arrive
   before or after the consumer asks (ref grpc_proxy.py:276-283,332-340);
 - job-name isolation with code 417 (ref grpc_proxy.py:311-320);
 - mutual TLS (ref grpc_proxy.py:124-141,362-372);
 - per-proxy op-count stats (ref barriers.py:132,154,204,223).

TPU-first differences: payloads ride the array fast path
(``serialization.try_encode_tree``) — raw device bytes + a msgpack
skeleton, no cloudpickle on the hot loop — and plaintext connections are
multiplexed over a small shared pool of epoll reactor threads
(``proxy/tcp/reactor.py``; ``cross_silo_comm.num_reactors``), with the
bulk byte work (batched ``writev`` flushes, scatter reads) done by the
native fastwire engine. Per-peer dedicated threads survive only where
they must: TLS connections (SSLSocket cannot be polled usefully through
raw fds), the device-DMA lane, ``use_reactor: false``, and platforms
without epoll — those keep one sender worker per destination and one
reader thread per inbound connection.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import ssl
import threading
import time
from concurrent.futures import Future, InvalidStateError
from queue import Empty, Queue
from typing import Dict, Optional, Tuple

from rayfed_tpu_torch import sanitize, tracing
from rayfed_tpu_torch._private import executor, serialization
from rayfed_tpu_torch._private.constants import (
    CODE_DATA_CORRUPT,
    CODE_FORBIDDEN,
    CODE_INTERNAL_ERROR,
    CODE_OK,
    CODE_SHM_UNAVAILABLE,
)
from rayfed_tpu_torch.config import TcpCrossSiloMessageConfig
from rayfed_tpu_torch.exceptions import FedLocalError
from rayfed_tpu_torch.proxy import lanes, rendezvous
from rayfed_tpu_torch.proxy.base import (
    ReceiverProxy,
    SenderProxy,
    SenderReceiverProxy,
)
from rayfed_tpu_torch.proxy.rendezvous import RendezvousStore
from rayfed_tpu_torch.proxy.tcp import checksum
from rayfed_tpu_torch.proxy.tcp import reactor as reactor_mod
from rayfed_tpu_torch.proxy.tcp import sockio, wire
from rayfed_tpu_torch.proxy.tcp.pipeline import _m_crc_resends
from rayfed_tpu_torch.resilience import inject as fault_inject
from rayfed_tpu_torch.resilience import linkhealth
from rayfed_tpu_torch.resilience.retry import Deadline, run_with_retry
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics
from rayfed_tpu_torch.tenancy.context import TenantQuotaExceeded

logger = logging.getLogger(__name__)

# Received DATA frames whose payload failed crc verification (NACKed
# with CODE_DATA_CORRUPT for retransmit — docs/observability.md).
_m_crc_failures = telemetry_metrics.get_registry().counter(
    "fed_transport_frame_crc_failures_total",
    "Received frames failing crc verification.",
)


def _reactor_mode(cfg, tls_config) -> bool:
    """Back-compat shim: the decision moved to proxy/lanes.py, the
    single transport-selection point."""
    return lanes.reactor_mode(cfg, tls_config)


class _ConnectExhausted(Exception):
    """Internal marker: the dial inside a stream attempt already ran its
    whole retry budget — abort the stream loop and surface the dial's
    ConnectionError (its ``__cause__``) unchanged."""


def _parse_addr(addr: str) -> Tuple[str, int]:
    from rayfed_tpu_torch.utils import parse_address

    return parse_address(addr)


class _DestWorker(threading.Thread):
    """Owns the persistent connection to one destination party and executes
    its send jobs in order (the reference serializes per-dest sends on one
    channel the same way).

    In reactor mode the thread NEVER STARTS: jobs are prepared on the
    submitting thread (or on the thread that completes the value future)
    and handed straight to the reactor-owned lane — no per-peer worker
    hop, no per-peer thread. The thread body only runs for the TLS
    half-duplex path and the device-DMA lane."""

    def __init__(self, proxy: "TcpSenderProxy", dest_party: str):
        super().__init__(name=f"fedtpu-send-{dest_party}", daemon=True)
        self._proxy = proxy
        self._dest = dest_party
        # Per-destination effective config (ref grpc_proxy.py:156-177).
        self._cfg = proxy._config.for_dest(dest_party)
        self._jobs: Queue = Queue()
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self._lane = None
        self._lanes: list = []
        self._small_threshold = max(
            0, getattr(self._cfg, "small_message_threshold", 0) or 0
        )
        # One transport-selection point: lanes.py negotiates this peer's
        # tier from the capability snapshot (proxy/lanes.py). The overlay
        # tiers (meshref/shm) keep the socket lane underneath for control
        # frames, descriptor frames and per-push fallback.
        self._lane_decision = lanes.negotiate_for_dest(
            self._cfg,
            proxy._tls_config,
            proxy._TRANSPORT,
            self_addr=proxy._addresses.get(proxy._party),
            dest_addr=proxy._addresses.get(dest_party),
        )
        lanes.set_peer_tier(dest_party, self._lane_decision.tier)
        self._shm: Optional[lanes.ShmSender] = None
        if self._lane_decision.tier == "shm":
            self._shm = lanes.ShmSender(
                proxy._job_name, proxy._party, dest_party, self._cfg
            )
        self._frame_crc = bool(getattr(self._cfg, "frame_crc", False))
        self._adaptive = bool(getattr(self._cfg, "adaptive_timeouts", False))
        use_reactor = _reactor_mode(self._cfg, proxy._tls_config)
        if not wire.tls_enabled(proxy._tls_config):
            # Plaintext connections pipeline frames (window of unacked
            # sends); TLS keeps half-duplex request-response because
            # ssl.SSLSocket cannot be read and written concurrently.
            policy = self._cfg.get_retry_policy()

            def bump_acks() -> None:
                proxy._bump_stat("send_op_count")

            lane_kwargs = dict(
                connect=lambda attempts: self._fresh_sock(attempts),
                max_attempts=policy.max_attempts,
                ack_timeout_s=self._cfg.timeout_in_ms / 1000,
                on_ack=bump_acks,
                window=self._cfg.send_window,
                small_threshold=self._small_threshold,
                adaptive_timeout=(
                    self._adaptive_ack_timeout if self._adaptive else None
                ),
            )
            if use_reactor:
                # K parallel lanes for shard striping; lane 0 carries all
                # ordinary traffic, the extras only ever see stripe frames.
                # Each lane gets its own connection and (round-robin over
                # the reactor pool) possibly its own reactor thread.
                num_streams = max(1, getattr(self._cfg, "num_streams", 1))
                self._lanes = [
                    reactor_mod.ReactorLane(
                        dest_party,
                        reactor=proxy._reactor_for(dest_party, i),
                        **lane_kwargs,
                    )
                    for i in range(num_streams)
                ]
                self._lane = self._lanes[0]
            else:
                from rayfed_tpu_torch.proxy.tcp.pipeline import PipelinedLane

                self._lane = PipelinedLane(dest_party, **lane_kwargs)
                self._lanes = [self._lane]
        # The device-DMA lane's register step is not vetted for arbitrary
        # submitter threads, so it keeps the serialized worker.
        self._threaded = (
            self._lane is None
            or not use_reactor
            or lanes.dma_enabled(self._cfg)
        )
        if self._threaded:
            self.start()

    # Conservative wire-rate floor for the per-frame transfer allowance:
    # the adaptive ack deadline is learned from (mostly small) ack
    # round-trips, so a bulk frame gets extra time proportional to its
    # size or a 100MB push on a 100Mbit link would be declared lost
    # while its bytes are still clearing the pipe.
    _MIN_WIRE_BITS_PER_S = 50e6

    def _adaptive_ack_timeout(self, base_s: float, nbytes: int) -> float:
        """Lane hook: link-health ack deadline for this peer plus the
        frame's transfer-time allowance (resilience/linkhealth.py). The
        configured ``timeout_in_ms`` stays the hard ceiling on the
        health-derived part; with no RTT samples yet it returns the base
        unchanged."""
        t = linkhealth.get_health().ack_timeout_s(
            self._dest,
            base_s,
            mult=self._cfg.rtt_timeout_multiple,
            floor_s=self._cfg.min_timeout_in_ms / 1000,
        )
        return t + nbytes * 8.0 / self._MIN_WIRE_BITS_PER_S

    def _stamp_crc(self, header: Dict, buffers) -> None:
        """Stamp the frame-integrity checksum over the FINAL wire bytes
        of this frame (post-serialization, post-compression; for shm/
        stripe frames: the descriptor / stripe slice actually sent).
        Stamped at the last point before lane submit so every frame
        shape checks the bytes it really carries."""
        if self._frame_crc:
            header["crc"], header["crca"] = checksum.compute(buffers)

    def submit(self, job) -> None:
        if self._threaded:
            self._jobs.put(job)
            return
        out, data, *_ = job
        if isinstance(data, Future) and not data.done():
            # Finish on whichever thread completes the value — the
            # executor worker that produced it, usually. The send stays
            # ordered per edge because every (up, down) pair is a unique
            # rendezvous key.
            data.add_done_callback(lambda _f, j=job: self._run_job_inline(j))
            return
        self._run_job_inline(job)

    def _run_job_inline(self, job) -> None:
        """Reactor-mode job dispatch: prepare + lane-submit with the same
        error envelope as the threaded drain loop, minus the queue hop."""
        out, data, upstream_seq_id, downstream_seq_id, is_error = job
        if self._closed:
            if not out.done():
                out.set_exception(ConnectionError("sender stopped"))
            return
        try:
            header, buffers, payload_len, on_done = self._prepare(
                data, upstream_seq_id, downstream_seq_id, is_error
            )
        except BaseException as e:  # noqa: BLE001 - routed to drain
            out.set_exception(e)
            return
        # Weighted-fair admission runs on the submitting/producer thread
        # (never a reactor loop): a bulk push from this job waits here
        # while a lighter co-tenant's inline traffic clears.
        lanes.qos_admit(
            self._proxy._job_name, payload_len, self._small_threshold
        )
        self._attach_done_callbacks(
            out, on_done, payload_len, upstream_seq_id, downstream_seq_id
        )
        if on_done is None and self._try_submit_shm(
            out, header, buffers, payload_len
        ):
            return
        self._submit_socket(out, header, buffers, payload_len)

    def _try_submit_striped(self, out, header, buffers, payload_len) -> bool:
        """Stripe one large multi-buffer tree payload across all lanes.

        Engages only when it can win: multiple lanes configured, an
        uncompressed ``tree`` payload big enough to amortize the extra
        frames, more than one wire buffer (stripes split strictly at
        buffer — i.e. leaf/shard extent — boundaries so the receiver's
        scatter segments stay intact), and not an error envelope (errors
        ride the ordered lane 0). Returns False to fall through to the
        single-lane path."""
        if (
            len(self._lanes) <= 1
            or header.get("is_error")
            or header.get("pkind") != "tree"
            or "comp" in header
            or payload_len < serialization.STRIPE_MIN_BYTES
        ):
            return False
        plan = serialization.plan_stripes(buffers, len(self._lanes))
        if plan is None or len(plan) <= 1:
            return False
        n = len(plan)
        agg_lock = threading.Lock()
        state = {"left": n}

        def _on_part(f: Future) -> None:
            err = f.exception()
            if err is None and f.result() is not True:
                err = ConnectionError("stripe send rejected by peer")
            with agg_lock:
                if err is None:
                    state["left"] -= 1
                finished = state["left"] == 0
            try:
                if err is not None:
                    out.set_exception(err)
                elif finished:
                    out.set_result(True)
            except InvalidStateError:
                pass  # another stripe already resolved the send

        for i, (soff, bufs, nbytes, segs) in enumerate(plan):
            h = dict(header)
            h["pkind"] = "stripe"
            h["sd"] = {
                "i": i, "n": n, "off": soff, "tot": payload_len,
                "segs": segs,
            }
            if i == 0:
                h["pk"] = header["pkind"]
            else:
                h["pmeta"] = b""
            self._stamp_crc(h, bufs)
            part: Future = Future()
            part.add_done_callback(_on_part)
            self._lanes[i % len(self._lanes)].submit(part, h, bufs, nbytes)
        return True

    def _submit_socket(self, out, header, buffers, payload_len) -> None:
        """The socket tiers: striped across lanes when that wins, the
        ordered lane 0 otherwise."""
        if self._try_submit_striped(out, header, buffers, payload_len):
            return
        self._stamp_crc(header, buffers)
        self._lane.submit(out, header, buffers, payload_len)

    def _try_submit_shm(self, out, header, buffers, payload_len) -> bool:
        """Divert one bulk frame to the same-host shm ring: payload bytes
        land in /dev/shm and only a tiny descriptor frame crosses the
        socket lane, so the ack/resend/peer-down machinery is reused
        unchanged. Returns False to fall through to the socket tiers.
        Every failure after the push falls back per push — cancel the
        chunk, resend the original frame on the socket — so a send is
        never lost; a peer NACK with code 424 (cannot attach or adopt)
        additionally demotes this peer for the rest of the job."""
        shm = self._shm
        if shm is None or not shm.eligible(header, payload_len):
            return False
        try:
            pushed = shm.push(buffers, payload_len)
        except TenantQuotaExceeded as e:
            # A quota breach is a hard admission failure, never a silent
            # fallback: riding the socket instead would let one tenant
            # spend transport capacity its quota says it does not have.
            if not out.done():
                out.set_exception(e)
            return True
        if pushed is None:
            # Ring saturated or create failed: this push rides the
            # socket; later pushes try the ring again unless broken.
            lanes.record_fallback("shm", "tcp")
            return False
        # stored_len covers the in-payload job tag the adopter strips
        # after verifying it against the descriptor's job field.
        name, off, stored_len = pushed
        desc = lanes.encode_shm_descriptor(
            name, off, stored_len, header, job=self._proxy._job_name
        )
        dheader = dict(header)
        dheader["pkind"] = "shm"
        dheader["pmeta"] = b""
        # The descriptor IS this frame's wire payload: the crc covers it,
        # not the ring bytes (same-host memory is not the WAN's problem).
        self._stamp_crc(dheader, [desc])
        was_probe = shm.probing

        inner: Future = Future()

        def _on_desc(f: Future) -> None:
            err = f.exception()
            if err is None and f.result() is True:
                shm.on_delivered(off)
                if was_probe and shm.mark_recovered():
                    lanes.set_peer_tier(self._dest, "shm")
                    lanes.record_repromotion("shm")
                    logger.info(
                        "peer %s adopted the shm probe frame; re-promoted "
                        "to the shm lane (demotion count %d)",
                        self._dest, shm.demotions,
                    )
                lanes.record_lane_send("shm")
                try:
                    out.set_result(True)
                except InvalidStateError:
                    pass
                return
            shm.cancel(off)
            if err is not None and (
                f"code={CODE_SHM_UNAVAILABLE}" in str(err)
            ):
                shm.mark_broken()
                lanes.set_peer_tier(self._dest, "tcp")
                logger.warning(
                    "peer %s cannot adopt shm frames (%s); demoted to "
                    "the socket lane for the rest of the job",
                    self._dest, err,
                )
            elif was_probe:
                # Probe inconclusive (socket failure, not a 424): close
                # the probe window and re-arm the hold-off — leaving
                # _probing set would admit unbounded pushes while broken.
                shm.mark_broken()
            lanes.record_fallback("shm", "tcp")
            try:
                self._submit_socket(out, header, buffers, payload_len)
            except BaseException as e:  # noqa: BLE001 - resolve the send
                if not out.done():
                    out.set_exception(e)

        inner.add_done_callback(_on_desc)
        self._lane.submit(inner, dheader, [desc], len(desc))
        return True

    def close(self) -> None:
        self._closed = True
        if self._shm is not None:
            self._shm.close()
        lanes.clear_peer_tier(self._dest)
        if self._threaded:
            self._jobs.put(None)
        for lane in self._lanes or ():
            lane.close()
        if self._lane is not None and self._lane not in self._lanes:
            self._lane.close()

    # -- connection management ----------------------------------------------

    def _connect_once(self, op_timeout: Optional[float] = -1) -> socket.socket:
        host, port = _parse_addr(self._proxy._addresses[self._dest])
        cfg = self._cfg
        raw = socket.create_connection(
            (host, port), timeout=cfg.connect_timeout_in_ms / 1000
        )
        sockio.tune_socket(raw)
        if wire.tls_enabled(self._proxy._tls_config):
            ctx = wire.make_client_ssl_context(self._proxy._tls_config)
            raw = ctx.wrap_socket(raw)
        raw.settimeout(
            cfg.timeout_in_ms / 1000 if op_timeout == -1 else op_timeout
        )
        return raw

    def _connect_retry(self, max_attempts: Optional[int], op_timeout,
                       deadline: Optional[Deadline] = None) -> socket.socket:
        """Connect via the unified retry engine (resilience/retry.py).
        ``op_timeout`` is the blocking-op timeout installed on the
        resulting socket (-1 = config default); ``deadline`` is the
        enclosing send's total wall-clock budget, shared with the stream
        attempts that follow."""
        policy = self._cfg.get_retry_policy()
        if max_attempts is not None:
            policy = dataclasses.replace(policy, max_attempts=max_attempts)

        def on_retry(attempt: int, err: BaseException) -> None:
            logger.debug(
                "connect to %s failed (attempt %d/%d): %s",
                self._dest, attempt, policy.max_attempts, err,
            )

        return run_with_retry(
            lambda attempt: self._connect_once(op_timeout=op_timeout),
            policy,
            retry_on=(OSError,),
            deadline=deadline,
            describe=(
                f"cannot reach party {self._dest} at "
                f"{self._proxy._addresses[self._dest]}"
            ),
            on_retry=on_retry,
        )

    def _fresh_sock(self, max_attempts: Optional[int] = None) -> socket.socket:
        """Pipelined-lane socket: blocking ops bounded by the send timeout
        so a stalled peer surfaces as socket.timeout instead of wedging the
        writer/reader threads; the lane maps idle reader timeouts back to
        'keep waiting' when nothing is in flight."""
        return self._connect_retry(
            max_attempts, op_timeout=self._cfg.timeout_in_ms / 1000
        )

    def _get_sock(self, max_attempts: Optional[int] = None,
                  deadline: Optional[Deadline] = None) -> socket.socket:
        if self._sock is not None:
            return self._sock
        self._sock = self._connect_retry(
            max_attempts, op_timeout=-1, deadline=deadline
        )
        return self._sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- job loop -------------------------------------------------------------

    def run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                self._drop_sock()
                # Fail anything queued behind the close sentinel (a
                # deferred fast-send fallback can race close) — stranded
                # jobs would leave their futures unresolved forever.
                while True:
                    try:
                        late = self._jobs.get_nowait()
                    except Empty:
                        return
                    if late is not None and not late[0].done():
                        late[0].set_exception(
                            ConnectionError("sender stopped")
                        )
            out, data, upstream_seq_id, downstream_seq_id, is_error = job
            try:
                header, buffers, payload_len, on_done = self._prepare(
                    data, upstream_seq_id, downstream_seq_id, is_error
                )
            except BaseException as e:  # noqa: BLE001 - routed to drain
                out.set_exception(e)
                continue
            # Same weighted-fair gate as the reactor path; this worker
            # thread is exactly where a bulk frame should wait.
            lanes.qos_admit(
                self._proxy._job_name, payload_len, self._small_threshold
            )
            self._attach_done_callbacks(
                out, on_done, payload_len, upstream_seq_id,
                downstream_seq_id,
            )
            if self._lane is not None:
                if on_done is None and self._try_submit_shm(
                    out, header, buffers, payload_len
                ):
                    continue
                self._submit_socket(out, header, buffers, payload_len)
                continue
            try:
                out.set_result(self._send_half_duplex(header, buffers))
            except BaseException as e:  # noqa: BLE001 - routed to drain
                out.set_exception(e)

    def _attach_done_callbacks(self, out, on_done, payload_len,
                               upstream_seq_id, downstream_seq_id) -> None:
        if on_done is not None:
            # Alternate-lane accounting hook (device-DMA failed-send
            # leak bound): tell the lane whether the descriptor frame
            # was actually delivered.
            def _notify(f, cb=on_done):
                try:
                    cb(f.exception() is None and f.result() is True)
                except Exception:  # noqa: BLE001 - accounting only
                    logger.exception("send on_done callback failed")

            out.add_done_callback(_notify)
        if tracing.is_enabled():
            t0 = time.perf_counter()
            out.add_done_callback(
                lambda f, t0=t0, nbytes=payload_len, up=upstream_seq_id,
                down=downstream_seq_id: tracing.record(
                    "send", self._dest, up, down, nbytes, t0,
                    ok=f.exception() is None,
                )
            )

    def try_fast_send(self, out: Future, data, upstream_seq_id,
                      downstream_seq_id, is_error: bool) -> bool:
        """Inline small-send path: encode and hand the frame straight to
        the pipelined lane WITHOUT a worker-queue hop. A value that is
        ready now is sent on the caller's thread; a still-pending value
        future gets a done-callback that finishes the send on the thread
        that completes it (usually the executor worker that produced the
        value) — the common case on the latency-critical chain, where
        send() runs before the producing task has finished. Returns
        False to decline — the caller then queues the job on the worker,
        which produces the canonical error handling; the deferred path
        falls back to the same queue on any failure.

        Declines unless: the pipelined lane exists (plaintext only), the
        fast path is enabled, the payload's encoded size provably fits
        the threshold, and the device-DMA lane is off (its register step
        is not vetted for arbitrary caller threads). Reordering against
        queued worker jobs is safe: every (up, down) edge is a unique
        rendezvous key, and error envelopes (which reuse an edge) never
        take this path."""
        thr = self._small_threshold
        if (
            self._lane is None
            or thr <= 0
            or self._closed
            or is_error
            or lanes.dma_enabled(self._cfg)
        ):
            return False
        if isinstance(data, Future) and not data.done():
            job = (out, data, upstream_seq_id, downstream_seq_id, is_error)

            def _on_ready(f):
                try:
                    sent = (
                        f.exception() is None
                        and self._finish_fast_send(
                            out, f.result(), upstream_seq_id,
                            downstream_seq_id,
                        )
                    )
                except BaseException:  # noqa: BLE001 - worker re-raises
                    sent = False
                if not sent:
                    self.submit(job)

            data.add_done_callback(_on_ready)
            return True
        resolved, value = executor.try_resolved(data)
        if not resolved:
            return False
        return self._finish_fast_send(
            out, value, upstream_seq_id, downstream_seq_id
        )

    def _finish_fast_send(self, out: Future, value, upstream_seq_id,
                          downstream_seq_id) -> bool:
        """Encode + dispatch an already-resolved success value on the
        current thread. False declines to the worker queue."""
        if self._closed:
            return False
        if not serialization.quick_payload_bound(
            value, self._small_threshold
        ):
            return False
        try:
            header, buffers, payload_len, on_done = self._prepare(
                value, upstream_seq_id, downstream_seq_id, False
            )
        except BaseException:  # noqa: BLE001 - worker path re-raises it
            return False
        # Fast sends are inline-class by construction (bounded by the
        # small threshold): admission never waits, it only accounts the
        # tenant's bytes for the fairness ledger.
        lanes.qos_admit(
            self._proxy._job_name, payload_len, self._small_threshold
        )
        self._attach_done_callbacks(
            out, on_done, payload_len, upstream_seq_id, downstream_seq_id
        )
        self._submit_socket(out, header, buffers, payload_len)
        return True

    def _prepare(self, data, upstream_seq_id, downstream_seq_id,
                 is_error: bool):
        # Resolve the value future; a producer failure becomes a
        # FedLocalError so the drain thread can substitute an error
        # envelope (the reference's RayError branch, cleanup.py:160-172).
        if isinstance(data, Future):
            try:
                value = data.result()
            except BaseException as e:  # noqa: BLE001
                raise FedLocalError(e) from None
        else:
            value = data

        cfg = self._cfg
        # Build the header skeleton BEFORE _try_encode_special: once that
        # call succeeds the alternate lane may have pinned device buffers
        # whose leak bound depends on on_done firing, so nothing fallible
        # may run between encode and returning on_done to the job loop.
        header = {
            "job": self._proxy._job_name,
            "src": self._proxy._party,
            "up": str(upstream_seq_id),
            "down": str(downstream_seq_id),
            "is_error": bool(is_error),
        }
        special = self._proxy._try_encode_special(
            value, is_error, cfg, dest_party=self._dest
        )
        if special is not None:
            kind, payload, on_done = special
            header["pkind"] = kind
            header["pmeta"] = b""
            return header, [payload], len(payload), on_done

        kind, meta, buffers = serialization.encode_payload(
            value,
            wire_dtype=serialization.wire_dtype_name(
                getattr(cfg, "payload_wire_dtype", None)
            ),
            small_threshold=self._small_threshold,
        )
        if kind == "pickle" and not cfg.allow_pickle_payloads and not is_error:
            raise ValueError(
                "payload requires pickling but allow_pickle_payloads=False "
                "(strict arrays-only mode): send pytrees of arrays/scalars"
            )
        payload_len = sum(serialization.buffer_nbytes(b) for b in buffers)
        max_bytes = cfg.effective_max_message_bytes()
        if max_bytes is not None and payload_len > max_bytes:
            raise ValueError(
                f"payload of {payload_len} bytes exceeds the effective "
                f"messages_max_size_in_bytes={max_bytes}"
            )
        header["pkind"] = kind
        header["pmeta"] = meta
        # Sub-threshold payloads skip compression: at kilobyte scale the
        # compressor's fixed cost exceeds any wire-time saving, and the
        # fast receive lane wants raw bytes.
        if (
            cfg.payload_compression
            and payload_len
            and payload_len > self._small_threshold
        ):
            packed = serialization.compress_buffers(
                buffers, cfg.payload_compression, cfg.compression_level
            )
            if packed is not None:  # incompressible payloads ship raw
                blob, raw_len = packed
                header["comp"] = cfg.payload_compression
                header["rawlen"] = raw_len
                buffers = [blob]
                payload_len = len(blob)
        return header, buffers, payload_len, None

    def _send_half_duplex(self, header, buffers) -> bool:
        # TLS path, on the unified retry engine. First attempt gets the
        # full connect budget (peer may still be starting — the reference
        # rides gRPC's in-channel retry policy for this), a reconnect
        # after a stale connection gets one try, so the total budget
        # stays ~2x the policy rather than attempts^2. An optional
        # send_deadline_in_ms bounds dial + stream + backoffs together.
        cfg = self._cfg
        policy = cfg.get_retry_policy()
        deadline = Deadline.from_ms(cfg.send_deadline_in_ms)
        self._stamp_crc(header, buffers)
        # Adaptive backoff ceiling: on a link whose RTT we know, there is
        # no point sleeping seconds between retries of a millisecond
        # round-trip; the policy cap stands for never-measured peers.
        backoff_ceiling = None
        if self._adaptive:
            backoff_ceiling = linkhealth.get_health().backoff_ceiling_s(
                self._dest, policy.max_backoff_ms / 1000
            )

        def attempt_stream(attempt: int):
            try:
                sock = self._get_sock(
                    max_attempts=None if attempt == 1 else 1,
                    deadline=deadline,
                )
            except ConnectionError as e:
                # The dial already exhausted its own retry budget —
                # re-dialing per stream attempt would square it.
                raise _ConnectExhausted() from e
            wire_bufs = buffers
            taint = fault_inject.take_wire_taint(
                self._dest, header.get("up"), header.get("down")
            )
            if taint is not None:
                wire_bufs = fault_inject.corrupt_wire_buffers(
                    buffers, self._dest, header.get("up"),
                    header.get("down"), taint,
                )
            try:
                t0 = time.monotonic()
                sockio.send_frame(sock, wire.FTYPE_DATA, header, wire_bufs)
                result = sockio.recv_frame(
                    sock, max_payload=wire.MAX_RESP_FRAME
                )
                linkhealth.observe_rtt(self._dest, time.monotonic() - t0)
                return result
            except socket.timeout:
                # The peer accepted the connection but stalled past the
                # per-op timeout: the caller's timeout contract says fail
                # now, a fresh socket would just stall again.
                self._drop_sock()
                raise
            except OSError as e:  # covers ConnectionError, ssl.SSLError
                self._drop_sock()
                logger.debug(
                    "send to %s failed on stale connection "
                    "(attempt %d/%d): %s",
                    self._dest, attempt, policy.max_attempts, e,
                )
                raise

        # Frame-integrity NACKs requeue the clean buffers for resend,
        # bounded by the policy's attempt budget — same contract as the
        # pipelined lanes' CODE_DATA_CORRUPT requeue.
        attempts = max(1, policy.max_attempts)
        for crc_attempt in range(1, attempts + 1):
            try:
                ftype, resp, _ = run_with_retry(
                    attempt_stream,
                    policy,
                    retry_on=(OSError,),
                    give_up_on=(_ConnectExhausted, socket.timeout),
                    deadline=deadline,
                    describe=f"send to {self._dest}",
                    backoff_ceiling_s=backoff_ceiling,
                )
            except _ConnectExhausted as e:
                raise e.__cause__ from None
            if ftype != wire.FTYPE_RESP:
                raise wire.WireError(
                    f"expected RESP frame, got ftype={ftype}"
                )
            if (
                resp.get("code") == CODE_DATA_CORRUPT
                and crc_attempt < attempts
            ):
                _m_crc_resends.inc()
                logger.warning(
                    "peer %s NACKed frame as corrupt; retransmitting "
                    "(attempt %d/%d)",
                    self._dest, crc_attempt, attempts,
                )
                continue
            break

        self._proxy._bump_stat("send_op_count")
        code = resp.get("code")
        if code == CODE_OK:
            return True
        # Request errors are sending failures even though bytes moved
        # (ref grpc_proxy.py:179-190).
        logger.warning(
            "peer rejected send: code=%s message=%s", code, resp.get("msg")
        )
        raise RuntimeError(f"send rejected: code={code} {resp.get('msg')}")


class TcpSenderProxy(SenderProxy):
    # Registry label for this transport's send counter; the TPU and
    # gRPC proxies override it (docs/observability.md).
    _TRANSPORT = "tcp"

    def __init__(self, addresses, party, job_name, tls_config, proxy_config=None):
        super().__init__(addresses, party, job_name, tls_config, proxy_config)
        self._config = TcpCrossSiloMessageConfig.from_dict(self._proxy_config)
        self._workers: Dict[str, _DestWorker] = {}
        self._lock = threading.Lock()
        # Send ops mirror into the process-global registry; get_stats()
        # counts from the local dict so co-located proxies sharing the
        # series stay per-instance (rayfed_tpu_torch/telemetry/metrics.py).
        self._m_send_ops = telemetry_metrics.get_registry().counter(
            "fed_transport_send_ops_total",
            "Data frames handed to the wire, by transport.",
            labels=("transport",),
        ).labels(transport=self._TRANSPORT)
        self._stats_lock = threading.Lock()
        self._stats = {"send_op_count": 0}
        self._reactors = None  # lazily acquired pool refs (reactor mode)
        self._reactor_lock = threading.Lock()

    def _reactor_for(self, dest_party: str, lane_index: int = 0):
        """A reactor from the shared pool for this destination's lane —
        peers are spread across the pool by stable hash so N parties load
        ``num_reactors`` loops evenly. Striped destinations ask once per
        lane (``lane_index``) so their K connections land on K distinct
        reactor threads when the pool is that deep."""
        with self._reactor_lock:
            if self._reactors is None:
                self._reactors = reactor_mod.acquire_reactors(
                    max(1, getattr(self._config, "num_reactors", 1))
                )
            rs = self._reactors
        return rs[(hash(dest_party) + lane_index) % len(rs)]

    def _try_encode_special(self, value, is_error: bool, cfg,
                            dest_party: Optional[str] = None):
        """Subclass hook: divert a payload to an alternate lane. Returns
        (pkind, payload_bytes, on_done) — ``on_done(ok: bool)`` is called
        when the send future resolves, for lane-side accounting — or None
        for the standard encode path (the TPU transport's device-DMA and
        same-mesh reference frames plug in here)."""
        return None

    def _bump_stat(self, key: str) -> None:
        assert key == "send_op_count", key
        with self._stats_lock:
            self._stats[key] += 1
        self._m_send_ops.inc()

    def start(self) -> None:
        pass  # workers spin up lazily per destination

    def send(self, dest_party, data, upstream_seq_id, downstream_seq_id,
             is_error: bool = False) -> Future:
        out: Future = Future()
        with self._lock:
            worker = self._workers.get(dest_party)
            if worker is None or worker._closed:
                worker = _DestWorker(self, dest_party)
                self._workers[dest_party] = worker
        if worker.try_fast_send(
            out, data, upstream_seq_id, downstream_seq_id, is_error
        ):
            return out
        worker.submit((out, data, upstream_seq_id, downstream_seq_id, is_error))
        return out

    def get_stats(self) -> Dict:
        with self._stats_lock:
            stats = dict(self._stats)
        # Per-peer link estimator mirror (srtt/rttvar/loss) — the same
        # numbers exported as fed_link_rtt_ms / fed_link_loss_ratio.
        health = linkhealth.get_health().get_stats()
        if health:
            stats["link_health"] = health
        return stats

    def get_proxy_config(self, dest_party: Optional[str] = None):
        """The effective messaging config — per-destination overrides
        applied when ``dest_party`` is given (ref grpc_proxy.py:156-177)."""
        return self._config.for_dest(dest_party)

    def stop(self) -> None:
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            w.close()
        with self._reactor_lock:
            had_ref, self._reactors = self._reactors is not None, None
        if had_ref:
            reactor_mod.release_reactors()


#: bind address -> the receiver that owns the live listener socket there.
#: Concurrent jobs in one process share one listen address: the first
#: receiver to bind becomes the owner, later ones piggyback by
#: registering their offer chain under their job name and the owner's
#: frame dispatch routes by the FTP1 header job id (unknown jobs still
#: earn 417 from the owner's own rendezvous store).
_shared_listeners: Dict[str, "TcpReceiverProxy"] = {}  # fedlint: disable=global-mutable-singleton (cross-job by design; reset_shared_listeners() clears it)
_shared_listeners_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the cross-job listener registry)


def reset_shared_listeners() -> None:
    """Reset hook (last-job shutdown): drop stale listener ownership
    records. Live receivers deregister themselves in ``stop``; anything
    left here belongs to a job that never shut down cleanly."""
    with _shared_listeners_lock:
        _shared_listeners.clear()


def _register_piggyback(addr: str, receiver: "TcpReceiverProxy"):
    """Attach ``receiver`` to the live listener owner at ``addr``.
    Returns the owner, or None when nobody owns the address (the bind
    failure was a real error, not multi-tenancy)."""
    with _shared_listeners_lock:
        owner = _shared_listeners.get(addr)
        if owner is None or owner._stopping:
            return None
        owner._add_tenant(receiver)
        return owner


class TcpReceiverProxy(ReceiverProxy):
    def __init__(self, listen_addr, party, job_name, tls_config, proxy_config=None):
        super().__init__(listen_addr, party, job_name, tls_config, proxy_config)
        self._config = TcpCrossSiloMessageConfig.from_dict(self._proxy_config)
        recv_timeout = self._config.recv_timeout_in_ms
        self._store = RendezvousStore(
            job_name,
            self._make_decode_fn(),
            max_payload_bytes=self._config.effective_max_message_bytes(),
            recv_timeout_s=None if recv_timeout is None else recv_timeout / 1000,
            allow_pickle=self._config.allow_pickle_payloads,
        )
        # Offer chain, outermost first: the shm adopter resolves
        # same-host descriptor frames into ring bytes (zero-copy with
        # the native ring) — adoption runs pre-ack, so a failure NACKs
        # 424 and the sender falls back to the socket lane mid-job
        # (proxy/lanes.py). Then the stripe assembler re-assembles bulk
        # payloads that multi-stream senders split across K connections.
        # Everything else passes through untouched.
        self._shm_adopter = lanes.ShmAdopter(
            rendezvous.StripeAssembler(
                self._store.offer,
                max_payload_bytes=self._config.effective_max_message_bytes(),
            ).offer
        )
        # Frame integrity wraps the whole chain: the crc is verified over
        # the wire payload BEFORE any adoption/assembly/decode touches
        # it, and a mismatch NACKs CODE_DATA_CORRUPT — the sender
        # requeues the frame for retransmit (proxy/tcp/checksum.py).
        self._crc_failures = 0
        # Frames reach this receiver through the tenant router: when this
        # receiver owns a shared listener, co-tenant jobs' frames are
        # forwarded to THEIR verified chains by header job id; everything
        # else (including unknown jobs -> 417) runs the own-job chain.
        self._offer = self._route_offer
        self._tenant_lock = threading.Lock()
        self._tenants: Dict[str, "TcpReceiverProxy"] = {}
        self._job_stores: Dict[str, object] = {}
        self._piggyback_host: Optional["TcpReceiverProxy"] = None
        self._listener: Optional[socket.socket] = None
        self._ready_result = None
        self._open_conns: set = set()
        self._conn_lock = threading.Lock()
        self._stopping = False
        # Reactor mode: ONE supervised accept thread remains (accept is
        # cheap and blocking-friendly); the per-connection serve threads
        # are replaced by ServerConnection handlers on the shared loops.
        self._reactors = None
        self._next_reactor = 0

    def _route_offer(self, header, payload) -> Tuple[int, str]:
        """Shared-listener tenant dispatch: a frame whose header job id
        names a piggybacked co-tenant runs that tenant's verified chain
        (its own crc counter, shm adopter and rendezvous store). The
        common single-job case short-circuits on the job compare; a frame
        for a job nobody here serves falls through and earns the 417 from
        this receiver's own store."""
        job = header.get("job")
        if job is not None and job != self._job_name:
            with self._tenant_lock:
                tenant_offer = self._job_stores.get(job)
            if tenant_offer is not None:
                return tenant_offer(header, payload)
        return self._verified_offer(header, payload)

    def _add_tenant(self, receiver: "TcpReceiverProxy") -> None:
        with self._tenant_lock:
            self._tenants[receiver._job_name] = receiver
            self._job_stores[receiver._job_name] = receiver._verified_offer

    def _remove_tenant(self, job_name: str) -> None:
        with self._tenant_lock:
            self._tenants.pop(job_name, None)
            self._job_stores.pop(job_name, None)

    def _verified_offer(self, header, payload) -> Tuple[int, str]:
        ok = checksum.verify(header, payload)
        if ok is False:
            self._crc_failures += 1
            _m_crc_failures.inc()
            key = (header.get("src"), header.get("up"), header.get("down"))
            logger.warning(
                "frame from %s (up=%s down=%s fseq=%s) failed crc "
                "verification; NACKing for retransmit",
                key[0], key[1], key[2], header.get("fseq"),
            )
            if sanitize.enabled():
                sanitize.probe_crc_retransmit(key)
            return (CODE_DATA_CORRUPT, "frame crc mismatch")
        return self._shm_adopter.offer(header, payload)

    def _make_decode_fn(self):
        """Hook: the TPU receiver overrides this to add device placement."""
        return rendezvous.default_decode(
            self._config.serializing_allowed_list,
            allow_pickle=self._config.allow_pickle_payloads,
            max_decompressed_bytes=self._config.effective_max_message_bytes(),
        )

    # -- lifecycle ------------------------------------------------------------

    def _bind_listener(self) -> None:
        host, port = _parse_addr(self._listen_addr)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(64)
        self._listener = listener

    def start(self) -> None:
        try:
            self._bind_listener()
        except OSError as e:
            # Multiplexing path: another job's receiver in THIS process
            # already listens on the address — piggyback on its listener
            # instead of failing. The owner routes inbound frames here by
            # the FTP1 header job id.
            host = _register_piggyback(self._listen_addr, self)
            if host is not None:
                self._piggyback_host = host
                self._ready_result = (True, None)
                logger.info(
                    "receiver for job %r shares the listener at %s owned "
                    "by job %r (multi-tenant transport multiplexing)",
                    self._job_name, self._listen_addr, host._job_name,
                )
                return
            self._ready_result = (
                False, f"failed to bind {self._listen_addr}: {e}"
            )
            return
        self._ready_result = (True, None)
        with _shared_listeners_lock:
            _shared_listeners[self._listen_addr] = self
        if _reactor_mode(self._config, self._tls_config):
            self._reactors = reactor_mod.acquire_reactors(
                max(1, getattr(self._config, "num_reactors", 1))
            )
        threading.Thread(
            target=self._accept_loop,
            name=f"fedtpu-recv-accept-{self._party}",
            daemon=True,
        ).start()

    def is_ready(self, timeout: Optional[float] = None):
        return self._ready_result

    def get_data(self, src_party, upstream_seq_id, curr_seq_id) -> Future:
        return self._store.take(upstream_seq_id, curr_seq_id)

    def get_stats(self) -> Dict:
        stats = self._store.get_stats()
        stats["frame_crc_failures"] = self._crc_failures
        return stats

    def ping_sources(self):
        return self._store.ping_sources()

    def stop(self) -> None:
        self._stopping = True
        host = self._piggyback_host
        if host is not None:
            # Piggybacked tenant: just leave the owner's routing table;
            # the listener belongs to the owner.
            self._piggyback_host = None
            host._remove_tenant(self._job_name)
        if self._listener is not None:
            try:
                # shutdown() wakes the thread blocked in accept(); a bare
                # close() would leave it holding the kernel file description
                # and the port in LISTEN state (breaks repeat fed.init on
                # the same address).
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with _shared_listeners_lock:
            if _shared_listeners.get(self._listen_addr) is self:
                _shared_listeners.pop(self._listen_addr, None)
        with self._tenant_lock:
            tenants = [t for t in self._tenants.values() if not t._stopping]
            self._tenants.clear()
            self._job_stores.clear()
        with self._conn_lock:
            conns = list(self._open_conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._reactors is not None:
            self._reactors = None
            reactor_mod.release_reactors()
        self._shm_adopter.close()
        self._store.shutdown()
        # A burst of large frames must not pin pool memory past the job.
        sockio.trim_recv_pool()
        # Listener handoff: the owner of a shared address is leaving while
        # co-tenant jobs still serve — the first survivor re-binds the now
        # free port and absorbs the rest (their chains re-register with
        # the new owner). Senders ride their retry policy across the gap.
        for tenant in tenants:
            tenant._adopt_listener()

    def _adopt_listener(self) -> None:
        """Take over a shared listen address after its owner stopped:
        bind it ourselves, or re-piggyback on whichever surviving tenant
        won the race to bind first."""
        if self._stopping:
            return
        self._piggyback_host = None
        try:
            self._bind_listener()
        except OSError as e:
            host = _register_piggyback(self._listen_addr, self)
            if host is not None:
                self._piggyback_host = host
                return
            logger.warning(
                "job %r could not take over the shared listener at %s "
                "after its owner stopped: %s", self._job_name,
                self._listen_addr, e,
            )
            return
        with _shared_listeners_lock:
            _shared_listeners[self._listen_addr] = self
        if (
            _reactor_mode(self._config, self._tls_config)
            and self._reactors is None
        ):
            self._reactors = reactor_mod.acquire_reactors(
                max(1, getattr(self._config, "num_reactors", 1))
            )
        threading.Thread(
            target=self._accept_loop,
            name=f"fedtpu-recv-accept-{self._party}",
            daemon=True,
        ).start()

    # -- data path -------------------------------------------------------------

    def _accept_loop(self) -> None:
        """Accept loop with crash supervision: an unexpected failure
        restarts the listener up to ``proxy_max_restarts`` times (the
        reference delegates this to Ray actor restarts,
        ref ``barriers.py:301-307``)."""
        restarts_left = max(0, self._config.proxy_max_restarts)
        while not self._stopping:
            try:
                self._accept_once()
                return  # listener closed deliberately
            except Exception as e:  # noqa: BLE001 - supervised
                if self._stopping or restarts_left <= 0:
                    if not self._stopping:
                        logger.error(
                            "receiver accept loop died (restarts "
                            "exhausted): %s", e,
                        )
                    return
                restarts_left -= 1
                logger.warning(
                    "receiver accept loop crashed (%s); restarting "
                    "listener (%d restarts left)", e, restarts_left,
                )
                try:
                    self._listener.close()
                except OSError:
                    pass
                try:
                    self._bind_listener()
                except OSError as bind_err:
                    logger.error(
                        "could not rebind receiver listener: %s", bind_err
                    )
                    return

    def _accept_once(self) -> None:
        ssl_ctx = (
            wire.make_server_ssl_context(self._tls_config)
            if wire.tls_enabled(self._tls_config)
            else None
        )
        while not self._stopping:
            try:
                conn, peer = self._listener.accept()
            except OSError:
                if self._stopping:
                    return  # listener closed deliberately
                # Unexpected accept failure (EMFILE/ENOBUFS/...): let the
                # supervisor restart the listener instead of going deaf.
                raise
            if ssl_ctx is None and self._reactors is not None:
                self._serve_conn_reactor(conn, peer)
                continue
            threading.Thread(
                target=self._serve_conn,
                args=(conn, peer, ssl_ctx),
                name=f"fedtpu-recv-conn-{peer}",
                daemon=True,
            ).start()

    def _serve_conn_reactor(self, conn: socket.socket, peer) -> None:
        """Hand one plaintext inbound connection to a reactor loop
        (round-robin across the pool). RESP acks ride the connection's
        send ring and flush once per poll batch — same piggybacking
        contract as the threaded path's _ACK_FLUSH_MAX batching."""
        def on_close(handler) -> None:
            with self._conn_lock:
                self._open_conns.discard(handler)

        try:
            sockio.tune_socket(conn)
            r = self._reactors[self._next_reactor % len(self._reactors)]
            self._next_reactor += 1
            handler = reactor_mod.ServerConnection(
                r, conn, peer, self._offer, on_close=on_close,
                max_payload=self._config.effective_max_message_bytes(),
            )
        except OSError as e:
            logger.warning("receiver connection from %s failed: %s", peer, e)
            try:
                conn.close()
            except OSError:
                pass
            return
        with self._conn_lock:
            self._open_conns.add(handler)

    # Hard flush bound for batched acks. Deliberately above the default
    # send window (8): a sender stalls only when its window fills, which
    # happens well before 32 deferred acks — so batching can never
    # livelock the pipe, while a burst of small frames gets its acks in
    # one write instead of one syscall each.
    _ACK_FLUSH_MAX = 32

    @staticmethod
    def _data_ready(conn) -> bool:
        """True when another frame can be read without blocking (buffered
        TLS bytes count). Used to defer ack writes while a burst is still
        arriving."""
        if isinstance(conn, ssl.SSLSocket) and conn.pending():
            return True
        import select

        try:
            ready, _, _ = select.select([conn], [], [], 0)
        except (OSError, ValueError):
            return False
        return bool(ready)

    def _serve_conn(self, conn: socket.socket, peer, ssl_ctx) -> None:
        # RESP frames are fully encoded on queue (plen is always 0) and
        # flushed in one write when the inbound burst pauses — ack
        # piggybacking: N small frames cost one ack syscall, not N.
        pending_acks: list = []

        def queue_resp(resp_header: Dict) -> None:
            pending_acks.append(
                wire.encode_prefix_and_header(wire.FTYPE_RESP, resp_header, 0)
            )

        def flush_acks() -> None:
            if pending_acks:
                blob = b"".join(pending_acks)
                pending_acks.clear()
                conn.sendall(blob)

        try:
            sockio.tune_socket(conn)
            peer_ids = None
            if ssl_ctx is not None:
                conn = ssl_ctx.wrap_socket(conn, server_side=True)
                if self._config.verify_peer_identity:
                    # Fail closed: a cert attesting no identities (or
                    # unreadable cert info) rejects every src claim.
                    peer_ids = wire.peer_party_identities(conn) or set()
            with self._conn_lock:
                self._open_conns.add(conn)
            while not self._stopping:
                if pending_acks and (
                    len(pending_acks) >= self._ACK_FLUSH_MAX
                    or not self._data_ready(conn)
                ):
                    flush_acks()
                try:
                    ftype, header, payload = sockio.recv_frame(
                        conn,
                        max_payload=self._config.effective_max_message_bytes(),
                    )
                except (ConnectionError, OSError):
                    return
                except wire.WireError as e:
                    # Oversized/bad frame: tear the connection down before
                    # buffering anything (memory protection).
                    logger.warning("dropping connection from %s: %s", peer, e)
                    return
                if ftype != wire.FTYPE_DATA:
                    queue_resp(
                        {"code": CODE_INTERNAL_ERROR,
                         "msg": "expected DATA frame"},
                    )
                    continue
                if peer_ids is not None and header.get("src") not in peer_ids:
                    # mTLS party binding: a CA-signed peer must not be able
                    # to impersonate another party's sends.
                    logger.warning(
                        "rejecting frame from %s: claimed src=%r not attested "
                        "by peer certificate identities %s",
                        peer, header.get("src"), sorted(peer_ids),
                    )
                    queue_resp(
                        {"code": CODE_FORBIDDEN,
                         "msg": "peer certificate does not attest claimed "
                                "src party",
                         "fseq": header.get("fseq")},
                    )
                    continue
                code, msg = self._offer(header, payload)
                # Echo the sender's frame sequence number: pipelined acks
                # are matched by fseq, never by position.
                queue_resp(
                    {"code": code, "msg": msg, "fseq": header.get("fseq")},
                )
        except ssl.SSLError as e:
            logger.warning("TLS handshake with %s failed: %s", peer, e)
        except Exception as e:  # noqa: BLE001 - connection-scoped failures
            if not self._stopping:
                logger.warning("receiver connection from %s failed: %s", peer, e)
        finally:
            try:
                flush_acks()  # best-effort: acks owed before teardown
            except (OSError, ValueError):
                pass
            with self._conn_lock:
                self._open_conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass


class TcpSenderReceiverProxy(SenderReceiverProxy):
    """Both directions behind one object and one inbound port (ref
    ``fed/proxy/base_proxy.py:77-106`` / ``barriers.py:415-459``): the
    receiver half serves ``addresses[party]``; the sender half dials the
    peers. Outbound connections use ephemeral ports as usual — "one port"
    is the party's single advertised endpoint."""

    def __init__(self, addresses, party, job_name, tls_config,
                 proxy_config=None):
        super().__init__(addresses, party, job_name, tls_config, proxy_config)
        self._receiver = TcpReceiverProxy(
            addresses[party], party, job_name, tls_config, proxy_config
        )
        self._sender = TcpSenderProxy(
            addresses, party, job_name, tls_config, proxy_config
        )

    def start(self) -> None:
        self._receiver.start()
        self._sender.start()

    def is_ready(self, timeout=None):
        return self._receiver.is_ready(timeout)

    def send(self, dest_party, data, upstream_seq_id, downstream_seq_id,
             is_error: bool = False) -> Future:
        return self._sender.send(
            dest_party, data, upstream_seq_id, downstream_seq_id, is_error
        )

    def get_data(self, src_party, upstream_seq_id, curr_seq_id) -> Future:
        return self._receiver.get_data(src_party, upstream_seq_id, curr_seq_id)

    def get_proxy_config(self, dest_party=None):
        return self._sender.get_proxy_config(dest_party)

    def get_stats(self) -> Dict:
        return {**self._sender.get_stats(), **self._receiver.get_stats()}

    def ping_sources(self):
        return self._receiver.ping_sources()

    def stop(self) -> None:
        self._sender.stop()
        self._receiver.stop()
