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

"""Per-party telemetry agent: periodic delta pushes to the collector.

Every party (including the collector itself) runs one agent thread.
Each tick it builds a push payload — the changed subset of the local
metrics registry snapshot plus any tracing spans recorded since the
last acknowledged push — and ships it to the collector party under the
reserved ``tel:`` seq-id namespace.  Payloads are small msgpack-clean
dicts, so they ride the inline small-message fast path of the wire.

Fail-open by design: the agent goes straight through the sender proxy
(``barriers.sender_proxy().send``) rather than ``barriers.send``, so a
dead or flaky collector never lands telemetry futures in the job's
cleanup drain (where their failures would surface as send errors).  At
most one push is in flight; an unacknowledged push is abandoned after
``2x push_interval`` and its delta is simply re-sent — values are
cumulative, so a re-applied delta is idempotent at the collector.  On
the collector party the agent short-circuits to a direct local ingest.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from rayfed_tpu_torch import tracing
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics
from rayfed_tpu_torch.telemetry.config import TelemetryConfig

logger = logging.getLogger(__name__)

#: Upstream seq id of a push frame: ``tel:push:<source party>``.  The
#: prefix matches rendezvous.TELEMETRY_SEQ_PREFIX so the collector's
#: registered control handler consumes the frame (verdict in the ack);
#: non-collector parties refuse it instead of parking it.
PUSH_SEQ_PREFIX = "tel:push:"

_CLEAN_TYPES = (str, int, float, bool, type(None))


def _clean_extra(extra: Dict) -> Dict:
    """Msgpack/json-safe subset of a span's extra dict (str() fallback
    keeps membership rosters and round tags, drops nothing silently)."""
    out = {}
    for k, v in extra.items():
        if isinstance(v, _CLEAN_TYPES):
            out[str(k)] = v
        elif isinstance(v, (list, tuple)) and all(
            isinstance(x, _CLEAN_TYPES) for x in v
        ):
            out[str(k)] = list(v)
        else:
            out[str(k)] = str(v)
    return out


def span_to_dict(s: "tracing.Span") -> Dict:
    return {
        "idx": s.idx,
        "kind": s.kind,
        "peer": s.peer,
        "up": s.upstream_seq_id,
        "down": s.downstream_seq_id,
        "nbytes": s.nbytes,
        "t_s": s.start_s,
        "dur_s": s.duration_s,
        "ok": s.ok,
        "extra": _clean_extra(s.extra),
    }


class TelemetryAgent:
    """Pushes this party's registry deltas + new spans to the collector."""

    def __init__(
        self,
        party: str,
        job_name: str,
        collector_party: str,
        cfg: TelemetryConfig,
        send_fn: Optional[Callable[[dict, int], Future]] = None,
        local_collector=None,
        registry: Optional[telemetry_metrics.MetricsRegistry] = None,
    ) -> None:
        self._party = party
        self._job = job_name
        self._collector_party = collector_party
        self._cfg = cfg
        self._send_fn = send_fn or self._default_send
        self._local = local_collector
        self._registry = registry or telemetry_metrics.get_registry()
        self._interval_s = cfg.push_interval_ms / 1000.0
        self._push_timeout_s = 2.0 * self._interval_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        # Last snapshot the collector has ACKED — deltas diff against
        # this, so a lost push's series simply ride the next delta.
        self._acked_snapshot: Optional[dict] = None
        self._acked_span_idx = tracing.last_span_index()
        # (future, snapshot, span watermark, submit time) of the single
        # in-flight push.
        self._pending = None
        reg = self._registry
        self._m_pushes = reg.counter(
            "fed_telemetry_pushes_total",
            "Telemetry pushes handed to the wire (or ingested locally).",
        )
        self._m_errors = reg.counter(
            "fed_telemetry_push_errors_total",
            "Telemetry pushes that failed, were refused, or timed out.",
        )
        self._m_spans = reg.counter(
            "fed_telemetry_spans_shipped_total",
            "Tracing spans shipped to the collector.",
        )

    # -- wiring --------------------------------------------------------------

    def _default_send(self, payload: dict, seq: int) -> Future:
        from rayfed_tpu_torch.proxy import barriers

        proxy = barriers.sender_proxy()
        if proxy is None:
            raise RuntimeError("sender proxy not running")
        return proxy.send(
            self._collector_party, payload,
            f"{PUSH_SEQ_PREFIX}{self._party}", str(seq),
        )

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fedtpu-telemetry-agent", daemon=True
        )
        self._thread.start()

    def stop(self, flush: bool = True, timeout_s: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(timeout_s, 2 * self._interval_s))
            self._thread = None
        if flush:
            self.flush(timeout_s=timeout_s)

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - telemetry must never raise
                self._m_errors.inc()
                logger.debug("telemetry tick failed", exc_info=True)

    # -- push machinery ------------------------------------------------------

    def _build_payload(self):
        snap = self._registry.snapshot()
        delta = telemetry_metrics.diff_snapshots(self._acked_snapshot, snap)
        spans: List[dict] = []
        watermark = self._acked_span_idx
        if self._cfg.span_batch > 0:
            harvested = tracing.spans_since(
                self._acked_span_idx, limit=self._cfg.span_batch
            )
            if harvested:
                watermark = harvested[-1].idx
            # The telemetry lane stays out of its own trace: the agent's
            # push sends are spans too (the sender proxy traces every
            # seq), and shipping them would grow each delta by the last
            # delta's plumbing. The watermark still advances past them.
            spans = [
                span_to_dict(s)
                for s in harvested
                if not str(s.upstream_seq_id).startswith(PUSH_SEQ_PREFIX)
            ]
        epoch = None
        try:
            from rayfed_tpu_torch.membership.manager import current_epoch_or_none

            epoch = current_epoch_or_none()
        except Exception:  # noqa: BLE001 - membership not installed
            pass
        payload = {
            "v": 1,
            "party": self._party,
            "job": self._job,
            "seq": self._seq,
            "epoch": epoch,
            # Wall/perf pair: the collector converts this party's
            # perf_counter span timestamps onto the shared wall clock
            # (perf_counter is NOT comparable across processes).
            "wall_s": time.time(),
            "perf_s": time.perf_counter(),
            "metrics": delta,
            "spans": spans,
        }
        return payload, snap, watermark

    def _commit(self, snap: dict, watermark: int, n_spans: int) -> None:
        self._acked_snapshot = snap
        self._acked_span_idx = max(self._acked_span_idx, watermark)
        if n_spans:
            self._m_spans.inc(n_spans)

    def _resolve_pending_locked(self) -> bool:
        """Handle the in-flight push. True = a push is still pending
        (skip this tick), False = the slot is free."""
        if self._pending is None:
            return False
        fut, snap, watermark, t0, n_spans = self._pending
        if fut.done():
            self._pending = None
            err = fut.exception()
            if err is None and fut.result():
                self._commit(snap, watermark, n_spans)
            else:
                self._m_errors.inc()
            return False
        if time.perf_counter() - t0 > self._push_timeout_s:
            # Abandon: never block behind a wedged peer. The unacked
            # delta re-rides the next payload.
            self._pending = None
            self._m_errors.inc()
            return False
        return True

    def tick(self) -> None:
        with self._lock:
            if self._resolve_pending_locked():
                return
            payload, snap, watermark = self._build_payload()
            self._seq += 1
            if self._local is not None:
                self._m_pushes.inc()
                try:
                    self._local.ingest(payload)
                    self._commit(snap, watermark, len(payload["spans"]))
                except Exception:  # noqa: BLE001 - fail-open
                    self._m_errors.inc()
                    logger.debug("local telemetry ingest failed",
                                 exc_info=True)
                return
            try:
                fut = self._send_fn(payload, payload["seq"])
            except Exception:  # noqa: BLE001 - fail-open
                self._m_errors.inc()
                logger.debug("telemetry push failed to submit", exc_info=True)
                return
            self._m_pushes.inc()
            self._pending = (
                fut, snap, watermark, time.perf_counter(),
                len(payload["spans"]),
            )

    def flush(self, timeout_s: float = 2.0) -> bool:
        """One synchronous final push (shutdown / test determinism)."""
        with self._lock:
            self._pending = None
            payload, snap, watermark = self._build_payload()
            self._seq += 1
            if self._local is not None:
                try:
                    self._local.ingest(payload)
                    self._commit(snap, watermark, len(payload["spans"]))
                    self._m_pushes.inc()
                    return True
                except Exception:  # noqa: BLE001 - fail-open
                    self._m_errors.inc()
                    return False
            try:
                fut = self._send_fn(payload, payload["seq"])
                self._m_pushes.inc()
                ok = bool(fut.result(timeout=timeout_s))
            except Exception:  # noqa: BLE001 - fail-open
                self._m_errors.inc()
                return False
            if ok:
                self._commit(snap, watermark, len(payload["spans"]))
            return ok
