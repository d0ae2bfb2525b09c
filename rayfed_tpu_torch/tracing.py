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

"""Lightweight tracing/profiling for cross-party transfers and tasks.

The reference has NO tracing (SURVEY.md §5.1 — only per-proxy op counters).
This module adds per-transfer spans: every send and receive records
(kind, peer, seq ids, bytes, duration) into a bounded in-process ring,
queryable via :func:`get_spans` / :func:`summary`, plus optional forwarding
into ``torch.profiler.record_function`` so transfers line up with device
timelines in a profiler capture.

Zero overhead when disabled (module-level flag checked before any work).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

_enabled = False  # fedlint: disable=global-mutable-singleton (trace buffer is process-global by contract; drained via snapshot())
_use_profiler_annotations = False  # fedlint: disable=global-mutable-singleton (trace buffer is process-global by contract; drained via snapshot())
_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (trace buffer is process-global by contract; drained via snapshot())
_MAX_SPANS = 10000
_spans: Deque["Span"] = deque(maxlen=_MAX_SPANS)  # fedlint: disable=global-mutable-singleton (trace buffer is process-global by contract; drained via snapshot())
# Monotonic append counter: every span gets the next index so the
# telemetry agent can harvest "spans since my last push" even though
# the ring drops old entries (rayfed_tpu_torch/telemetry/agent.py).
_span_seq = 0  # fedlint: disable=global-mutable-singleton (trace buffer is process-global by contract; drained via snapshot())
_MAX_REQUEST_EVENTS = 20000
_request_events: Deque["RequestEvent"] = deque(maxlen=_MAX_REQUEST_EVENTS)  # fedlint: disable=global-mutable-singleton (trace buffer is process-global by contract; drained via snapshot())


@dataclass
class Span:
    kind: str                 # "send" | "recv" | "decode" | "place" | "task" | "stage" | "pull"
    peer: str                 # destination or source party ("" if n/a)
    upstream_seq_id: str
    downstream_seq_id: str
    nbytes: int
    start_s: float
    duration_s: float
    ok: bool = True
    extra: Dict = field(default_factory=dict)
    idx: int = -1             # ring-append index (monotonic per process)


def enable(profiler_annotations: Optional[bool] = None, *,
           jax_annotations: Optional[bool] = None) -> None:
    """Turn span recording on. ``profiler_annotations=True`` additionally
    wraps spans in ``torch.profiler.record_function``. ``jax_annotations``
    is the JAX package's name for the same switch (its spans go to
    ``jax.profiler``), accepted so that code written for it runs here;
    passing both raises TypeError."""
    global _enabled, _use_profiler_annotations
    if profiler_annotations is not None and jax_annotations is not None:
        raise TypeError("pass profiler_annotations or its JAX package name "
                        "jax_annotations, not both")
    _enabled = True
    _use_profiler_annotations = bool(profiler_annotations or jax_annotations)


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def clear() -> None:
    with _lock:
        _spans.clear()
        _request_events.clear()


def get_spans(kind: Optional[str] = None) -> List[Span]:
    with _lock:
        spans = list(_spans)
    if kind is not None:
        spans = [s for s in spans if s.kind == kind]
    return spans


def spans_since(idx: int, limit: Optional[int] = None) -> List[Span]:
    """Spans with ring index > ``idx``, oldest first (optionally the
    newest ``limit`` of them). The ring is append-ordered, so walk it
    from the right and stop at the watermark instead of scanning all
    10k entries on every telemetry push."""
    out: List[Span] = []
    with _lock:
        for s in reversed(_spans):
            if s.idx <= idx:
                break
            out.append(s)
            if limit is not None and len(out) >= limit:
                break
    out.reverse()
    return out


def last_span_index() -> int:
    return _span_seq - 1


# Kinds whose spans bracket the full operation (duration is meaningful);
# "recv" spans are arrival events with no duration — no throughput for them.
# "fold"/"publish" are the async aggregation buffer's K-publish spans
# (rayfed_tpu_torch/async_rounds.py; docs/async_rounds.md).
_TIMED_KINDS = {"send", "decode", "place", "task", "fold", "publish"}


def summary() -> Dict[str, Dict]:
    """Aggregate per kind: count, bytes, total duration, GB/s (timed kinds
    only — event kinds like 'recv' have no meaningful duration)."""
    out: Dict[str, Dict] = {}
    for s in get_spans():
        agg = out.setdefault(
            s.kind,
            {"count": 0, "bytes": 0, "seconds": 0.0, "errors": 0},
        )
        agg["count"] += 1
        agg["bytes"] += s.nbytes
        agg["seconds"] += s.duration_s
        if not s.ok:
            agg["errors"] += 1
    for kind, agg in out.items():
        if kind in _TIMED_KINDS and agg["seconds"] > 1e-9:
            agg["gbps"] = agg["bytes"] / (1 << 30) / agg["seconds"]
    return out


def export_chrome_trace(path: str, party: str = "") -> int:
    """Write recorded spans as a Chrome/Perfetto trace-event JSON file
    (open in ``chrome://tracing`` or ``ui.perfetto.dev``). Timed kinds
    become complete ("X") events on a per-kind track; event kinds (e.g.
    "recv" arrivals) become instant ("i") events. Returns the number of
    events written. Complements ``torch.profiler`` captures: this is the
    engine-side wire timeline, device timelines come from the profiler.
    """
    import json

    events = []
    pid = party or "rayfed_tpu_torch"
    for s in get_spans():
        base = {
            "name": f"{s.kind} {s.peer}".strip(),
            "cat": s.kind,
            "pid": pid,
            "tid": s.kind,
            "ts": s.start_s * 1e6,  # microseconds
            "args": {
                "up": s.upstream_seq_id,
                "down": s.downstream_seq_id,
                "nbytes": s.nbytes,
                "ok": s.ok,
                **s.extra,
            },
        }
        if s.kind in _TIMED_KINDS:
            base["ph"] = "X"
            base["dur"] = max(s.duration_s, 1e-7) * 1e6
        else:
            base["ph"] = "i"
            base["s"] = "t"
        events.append(base)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def export_timeline(path: str, party: str = "") -> int:
    """Write a plain-text per-seq-id send/recv/ack timeline — the hang
    forensics artifact (ISSUE 7 satellite): when a bench party wedges,
    the watchdog's signal triggers this next to the faulthandler stack
    dump, so the last wire event per rendezvous edge is visible without
    a debugger. Grouped by (upstream_seq_id, downstream_seq_id), events
    time-ordered within each edge. Returns the number of events written.

    Signal-handler safe: the span ring is snapshotted with a
    non-blocking lock attempt (a handler interrupting the recording
    thread mid-append must not deadlock on the tracing lock; deques are
    safe to iterate without it at worst losing the in-flight span)."""
    acquired = _lock.acquire(blocking=False)
    try:
        spans = list(_spans)
    finally:
        if acquired:
            _lock.release()
    edges: Dict[tuple, List[Span]] = {}
    for s in spans:
        edges.setdefault((s.upstream_seq_id, s.downstream_seq_id), []).append(s)
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"# rayfed_tpu_torch wire timeline party={party or '?'} "
                f"spans={len(spans)}\n")
        for (up, down), group in sorted(edges.items()):
            f.write(f"\n[{up} -> {down}]\n")
            for s in sorted(group, key=lambda s: s.start_s):
                f.write(
                    f"  {s.start_s:16.6f} +{s.duration_s * 1e3:9.3f}ms "
                    f"{s.kind:<6} peer={s.peer or '?':<10} "
                    f"nbytes={s.nbytes:<12} ok={s.ok}\n"
                )
                n += 1
    return n


def export_seq_timeline(path: str, party: str = "") -> int:
    """Write the per-seq-id timeline as machine-readable JSON — the
    structured twin of :func:`export_timeline`'s text artifact, and the
    input format of ``tools/trace_view.py``'s text flamegraph.

    Shape::

        {"party": ..., "t0_s": <earliest span start>,
         "edges": [{"up": ..., "down": ..., "events": [
             {"kind", "peer", "t_s", "dur_s", "nbytes", "ok", ...extra},
             ...]},   # time-ordered within each edge
          ...]}       # edges ordered by first event

    Every send/recv/decode/task span plus the async aggregator's
    fold/publish spans lands here keyed by its (upstream, downstream)
    seq-id edge, so a straggling round is traceable from the driver's
    offer through the wire to the fold that consumed it. Returns the
    number of events written. Same snapshot discipline as
    :func:`export_timeline` — safe from a watchdog signal handler
    (non-blocking lock attempt; deque iteration without the lock at
    worst loses the in-flight span)."""
    import json

    acquired = _lock.acquire(blocking=False)
    try:
        spans = list(_spans)
    finally:
        if acquired:
            _lock.release()
    edges: Dict[tuple, List[Span]] = {}
    for s in spans:
        edges.setdefault((s.upstream_seq_id, s.downstream_seq_id), []).append(s)
    edge_list = []
    n = 0
    for (up, down), group in sorted(
        edges.items(), key=lambda kv: min(s.start_s for s in kv[1])
    ):
        events = []
        for s in sorted(group, key=lambda s: s.start_s):
            events.append({
                "kind": s.kind,
                "peer": s.peer,
                "t_s": s.start_s,
                "dur_s": s.duration_s if s.kind in _TIMED_KINDS else 0.0,
                "nbytes": s.nbytes,
                "ok": s.ok,
                **s.extra,
            })
            n += 1
        edge_list.append({"up": up, "down": down, "events": events})
    doc = {
        "party": party or "?",
        "t0_s": min((s.start_s for s in spans), default=0.0),
        "edges": edge_list,
    }
    with open(path, "w", encoding="utf-8") as f:
        # default=str: extras are caller-provided and must never be able
        # to fail the artifact (it is written from watchdog handlers).
        json.dump(doc, f, default=str)
    return n


def record(kind: str, peer: str, upstream_seq_id: str, downstream_seq_id: str,
           nbytes: int, start_s: float, ok: bool = True, **extra) -> None:
    """Directly append a span (for async paths where a context manager
    cannot bracket the operation — e.g. pipelined sends resolved by ack).
    Extra keywords land in the span's ``extra`` dict (and therefore in
    every exporter's per-event args) — the async aggregator stamps fold
    spans with the buffered round tags this way."""
    if not _enabled:
        return
    global _span_seq
    with _lock:
        _spans.append(
            Span(
                kind=kind,
                peer=peer,
                upstream_seq_id=str(upstream_seq_id),
                downstream_seq_id=str(downstream_seq_id),
                nbytes=nbytes,
                start_s=start_s,
                duration_s=time.perf_counter() - start_s,
                ok=ok,
                extra=extra,
                idx=_span_seq,
            )
        )
        _span_seq += 1


# -- per-request serving timeline (docs/serving.md) -------------------------
#
# The serving plane's observability slice (ROADMAP "production
# observability"): each request leaves a breadcrumb trail of lifecycle
# events — enqueue / admit / prefill / first_token / step / finish — in a
# second bounded ring, exportable as JSON next to the per-seq-id wire
# timeline so a slow request is diagnosable from artifacts alone (which
# phase ate the time, which model version served it, whether it waited in
# admission or in the decode batch).


@dataclass
class RequestEvent:
    request_id: str
    event: str                # "enqueue" | "prefill" | "first_token" | ...
    t_s: float                # perf_counter timestamp
    extra: Dict = field(default_factory=dict)


def record_request(request_id: str, event: str,
                   t_s: Optional[float] = None, **extra) -> None:
    """Append one lifecycle event for ``request_id`` (no-op when tracing
    is off, like every recorder in this module)."""
    if not _enabled:
        return
    if t_s is None:
        t_s = time.perf_counter()
    with _lock:
        _request_events.append(
            RequestEvent(str(request_id), event, t_s, dict(extra))
        )


def get_request_events(
    request_id: Optional[str] = None,
) -> List[RequestEvent]:
    with _lock:
        events = list(_request_events)
    if request_id is not None:
        events = [e for e in events if e.request_id == str(request_id)]
    return events


def request_timelines() -> Dict[str, List[RequestEvent]]:
    """Events grouped per request id, time-ordered within each."""
    out: Dict[str, List[RequestEvent]] = {}
    for e in get_request_events():
        out.setdefault(e.request_id, []).append(e)
    for events in out.values():
        events.sort(key=lambda e: e.t_s)
    return out


def export_request_timeline(path: str, party: str = "") -> int:
    """Write the per-request serving timeline as JSON:
    ``{"party", "requests": {id: [{"event", "t_s", ...extra}]}}`` with
    per-request events time-ordered. Returns the number of events
    written. Lives alongside :func:`export_timeline` (the per-seq-id wire
    artifact); same snapshot discipline — safe to call from a watchdog
    signal handler (non-blocking lock attempt, ring iterated without it
    at worst losing the in-flight event)."""
    import json

    acquired = _lock.acquire(blocking=False)
    try:
        events = list(_request_events)
    finally:
        if acquired:
            _lock.release()
    requests: Dict[str, List[Dict]] = {}
    n = 0
    for e in sorted(events, key=lambda e: (e.request_id, e.t_s)):
        requests.setdefault(e.request_id, []).append(
            {"event": e.event, "t_s": e.t_s, **e.extra}
        )
        n += 1
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"party": party or "?", "requests": requests}, f)
    return n


class span:
    """Context manager recording one span (no-op when tracing is off)."""

    __slots__ = ("_kind", "_peer", "_up", "_down", "_nbytes", "_t0",
                 "_prof_ctx", "_active", "_extra")

    def __init__(self, kind: str, peer: str = "", upstream_seq_id: str = "",
                 downstream_seq_id: str = "", nbytes: int = 0):
        self._kind = kind
        self._peer = peer
        self._up = upstream_seq_id
        self._down = downstream_seq_id
        self._nbytes = nbytes
        self._prof_ctx = None
        self._extra = None
        # Latched at __enter__: a toggle of the global flag mid-span must
        # not make __exit__ disagree with __enter__.
        self._active = False

    def __enter__(self):
        if not _enabled:
            return self
        self._active = True
        self._t0 = time.perf_counter()
        if _use_profiler_annotations:
            try:
                import torch.profiler

                self._prof_ctx = torch.profiler.record_function(
                    f"fed:{self._kind}:{self._peer}:{self._up}->{self._down}"
                )
                self._prof_ctx.__enter__()
            except Exception:  # pragma: no cover - profiler unavailable
                self._prof_ctx = None
        return self

    def set_nbytes(self, n: int) -> None:
        self._nbytes = n

    def set_extra(self, **kv) -> None:
        """Annotate the span (its record's ``extra``), e.g. the engine
        that served a device-DMA pull."""
        self._extra = {**(self._extra or {}), **kv}

    def __exit__(self, exc_type, exc, tb):
        if not self._active:
            return False
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(exc_type, exc, tb)
        global _span_seq
        record = Span(
            kind=self._kind,
            peer=self._peer,
            upstream_seq_id=self._up,
            downstream_seq_id=self._down,
            nbytes=self._nbytes,
            start_s=self._t0,
            duration_s=time.perf_counter() - self._t0,
            ok=exc_type is None,
            extra=dict(self._extra or {}),
        )
        with _lock:
            record.idx = _span_seq
            _span_seq += 1
            _spans.append(record)
        return False
