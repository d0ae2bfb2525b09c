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

"""Asynchronous send-drain + failure-propagation manager.

Capability parity: reference ``fed/cleanup.py:29-203``. Cross-party pushes
are fire-and-forget at the call site; their completion futures are drained
here by daemon threads. A failed data send substitutes a
:class:`FedRemoteError` envelope *under the same (upstream, downstream) seq
ids* the peer is already waiting on (ref ``cleanup.py:160-172``) so the peer
fails fast instead of hanging, then optionally SIGINTs this process
(``exit_on_sending_failure``, ref ``cleanup.py:112-128,176-183``).

Differences from the reference: the drained handle is a
``concurrent.futures.Future`` from our sender proxy (no Ray ObjectRefs), and
a producer-task failure is distinguished from a transport failure by the
:class:`FedLocalError` wrapper instead of ``ray.exceptions.RayError``.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import signal
import threading
from typing import Callable, Optional

from rayfed_tpu_torch._private.message_queue import MessageQueueManager
from rayfed_tpu_torch.exceptions import FedLocalError, FedRemoteError

logger = logging.getLogger(__name__)


class CleanupManager:
    def __init__(self, current_party: str, acquire_shutdown_flag: Callable[[], bool]):
        self._sending_data_q = MessageQueueManager(
            self._process_data_send, thread_name="fedtpu-data-send-drain"
        )
        self._sending_error_q = MessageQueueManager(
            self._process_error_send, thread_name="fedtpu-error-send-drain"
        )
        self._current_party = current_party
        self._acquire_shutdown_flag = acquire_shutdown_flag
        self._last_sending_error: Optional[Exception] = None
        # Data sends not yet discharged (future -> queued message). Happy
        # paths never touch the drain thread; see push_to_sending.
        self._inflight: dict = {}
        self._inflight_lock = threading.Lock()
        self._exit_on_sending_failure = False
        self._expose_error_trace = False
        # Fast-fail drain (entered by stop(wait_for_sending=False)): pending
        # sends get a short bounded wait instead of blocking forever, and
        # ones that cannot complete are substituted by error envelopes so
        # peers parked on their rendezvous keys unblock instead of hanging
        # (liveness the reference lacks: its non-graceful stop just drops
        # queued sends, ref message_queue.py:84-99).
        self._fast_fail = False

    def start(self, exit_on_sending_failure: bool = False,
              expose_error_trace: bool = False) -> None:
        self._exit_on_sending_failure = exit_on_sending_failure
        self._expose_error_trace = expose_error_trace
        self._sending_data_q.start()
        self._sending_error_q.start()

    def stop(self, wait_for_sending: bool = False) -> None:
        if not wait_for_sending:
            self._fast_fail = True
        # In-flight data sends first: wait for each to resolve (bounded in
        # fast-fail mode) and discharge it — failures land in the data
        # queue as envelope jobs before the stop symbol does.
        timeout_each = 2.0 if self._fast_fail else None
        while True:
            with self._inflight_lock:
                item = next(iter(self._inflight.items()), None)
            if item is None:
                break
            f, msg = item
            try:
                f.result(timeout=timeout_each)
            except BaseException:  # noqa: BLE001 - discharge decides
                pass
            self._discharge_data_send(f, msg)
        # Data queue first: its failure handling may enqueue error sends
        # (same ordering constraint as ref cleanup.py:71-76). Both queues
        # always drain gracefully — in fast-fail mode each item's wait is
        # bounded, so "graceful" stays prompt while guaranteeing that every
        # queued edge either completes or gets an error envelope.
        self._sending_data_q.stop(graceful=True)
        self._sending_error_q.stop(graceful=True)

    def push_to_sending(
        self,
        send_future,
        dest_party: Optional[str] = None,
        upstream_seq_id: int = -1,
        downstream_seq_id: int = -1,
        is_error: bool = False,
    ) -> None:
        """Track a pending cross-party send. ``send_future`` resolves when the
        peer acknowledged the payload (or raises)."""
        msg = (send_future, dest_party, upstream_seq_id, downstream_seq_id)
        if is_error:
            self._sending_error_q.append(msg)
            return
        # Successful sends must not wake the drain thread (one context
        # switch per ack adds up on small-message rounds): the discharge
        # runs as a done-callback on whichever thread resolves the ack,
        # and only *failed* sends become drain-queue jobs (for error
        # enveloping). stop() sweeps whatever is still in flight.
        with self._inflight_lock:
            self._inflight[send_future] = msg
        send_future.add_done_callback(
            lambda f, _msg=msg: self._discharge_data_send(f, _msg)
        )

    def wait_for_inflight(self, timeout: Optional[float] = None) -> bool:
        """Block until every data send tracked now has resolved
        (acknowledged or failed), at most ``timeout`` seconds. Counters a
        send moves on its way, such as a crc resend after the peer's
        NACK, are final once it resolved. False if some were still
        pending at the timeout."""
        with self._inflight_lock:
            pending = list(self._inflight)
        _, not_done = concurrent.futures.wait(pending, timeout=timeout)
        return not not_done

    def _discharge_data_send(self, f, msg) -> None:
        """At-most-once per send (callback and stop() both call this; the
        inflight map arbitrates): drop a successful send, queue an
        error-envelope job for a failed or still-pending one."""
        with self._inflight_lock:
            if self._inflight.pop(f, None) is None:
                return
        if f.done() and not f.cancelled():
            try:
                failed = f.exception() is not None
            except BaseException:  # noqa: BLE001
                failed = True
        else:
            failed = True  # cancelled, or stop() gave up waiting
        if failed:
            self._sending_data_q.append(msg)

    def get_last_sending_error(self) -> Optional[Exception]:
        return self._last_sending_error

    def _signal_exit(self) -> None:
        """SIGINT ourselves so the main thread runs the unintended-shutdown
        path. The shutdown flag must be won *before* signalling to avoid the
        signal-handler deadlock documented at ref cleanup.py:117-128."""
        if self._acquire_shutdown_flag():
            logger.warning("Signaling SIGINT to exit on sending failure.")
            os.kill(os.getpid(), signal.SIGINT)

    def _process_data_send(self, message) -> bool:
        send_future, dest_party, upstream_seq_id, downstream_seq_id = message
        try:
            timeout = 2.0 if self._fast_fail else None
            res = send_future.result(timeout=timeout)
        except Exception as e:  # noqa: BLE001 - every failure must be handled
            logger.warning(
                "Failed to send to %s (upstream_seq_id=%s downstream_seq_id=%s): %s",
                dest_party, upstream_seq_id, downstream_seq_id, e,
            )
            self._last_sending_error = e
            # Substitute an error envelope under the same seq ids the
            # peer's recv is parked on, for EVERY failure mode (the
            # reference does the same for any RayError, cleanup.py:160-172):
            # producer raised (FedLocalError), payload rejected (strict
            # mode / size caps), or transport down — in the last case the
            # envelope send fails too and is just logged by the error
            # queue, but in the first two the transport is healthy and the
            # envelope is what keeps the peer from hanging.
            from rayfed_tpu_torch.proxy.barriers import send

            error_trace = None
            if self._expose_error_trace:
                # Producer exceptions cross as objects (reference parity;
                # whitelist them on the receiver). Transport/validation
                # exceptions cross as strings — their classes (ssl.SSLError,
                # wire errors) would just fail the peer's whitelist.
                error_trace = (
                    e.cause if isinstance(e, FedLocalError) else repr(e)
                )
            send(
                dest_party,
                FedRemoteError(self._current_party, error_trace),
                upstream_seq_id,
                downstream_seq_id,
                is_error=True,
            )
            res = False

        if not res and self._exit_on_sending_failure and not self._fast_fail:
            self._signal_exit()
            return False  # stop this drain thread; main thread cleans up
        # In fast-fail teardown keep draining so every queued edge gets its
        # envelope before the process exits.
        return True

    def _process_error_send(self, message) -> bool:
        send_future, dest_party, upstream_seq_id, downstream_seq_id = message
        try:
            # Bounded even in normal mode: an unreachable peer must not
            # wedge shutdown behind the full transport retry budget.
            res = send_future.result(timeout=10.0 if self._fast_fail else 120.0)
        except Exception:  # noqa: BLE001
            res = False
        if not res:
            logger.warning(
                "Failed to send error to %s (upstream_seq_id=%s "
                "downstream_seq_id=%s); the peer may not sense this error.",
                dest_party, upstream_seq_id, downstream_seq_id,
            )
        return True  # keep draining remaining error sends (ref cleanup.py:202)
