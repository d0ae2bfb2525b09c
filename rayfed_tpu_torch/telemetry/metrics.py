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

"""Process-wide metrics registry for the federation telemetry plane.

One registry per process holds every series any subsystem exposes.
Series names follow ``fed_<plane>_<name>`` (plane: transport, async,
serving, resilience, liveness, membership, driver, telemetry) and are
validated at registration time.  Producers register their metrics once
at subsystem init and keep direct references to the returned child
objects, so the hot path is a single lock-protected float add — no
dict lookups, no allocation.

Three metric kinds:

- ``Counter`` — monotonically increasing float (``.inc(n)``)
- ``Gauge``   — point-in-time float (``.set(v)`` / ``.inc(n)``)
- ``Histogram`` — fixed bucket boundaries chosen at registration;
  ``.observe(v)`` bumps the first bucket with ``v <= le`` plus
  ``sum``/``count``.

Labels: ``metric.labels(k=v, ...)`` returns (and caches) a child
series.  Per-metric label cardinality is capped (default 64 distinct
label sets); further combinations collapse into a single overflow
child whose label values are ``"_other_"`` so unbounded peer names
can never grow the registry without bound.

Snapshots (``registry.snapshot()``) are plain msgpack-clean dicts
with deterministically sorted series, suitable for pushing over the
inline small-message lane.  ``diff_snapshots`` yields the
changed-series subset used for the agent's delta pushes, and
``merge_snapshot``/``render_prometheus`` let the collector fold
per-party snapshots back into one scrapeable view.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^fed_[a-z0-9]+(_[a-z0-9]+)*$")

# Default histogram boundaries (milliseconds-ish scale); +Inf implicit.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)

DEFAULT_LABEL_CARDINALITY = 64
OVERFLOW_LABEL_VALUE = "_other_"


def _label_key(label_names: Sequence[str], kv: Dict[str, str]) -> Tuple[str, ...]:
    return tuple(str(kv[n]) for n in label_names)


class _Child:
    """One labelled series of a Counter or Gauge."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    """Counter series: monotone by contract, so a negative increment is
    a caller bug worth failing loudly on (use a Gauge for levels)."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter increment must be >= 0, got {n!r}"
            )
        _Child.inc(self, n)


class _HistChild:
    """One labelled series of a Histogram."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, lock: threading.Lock, bounds: Tuple[float, ...]) -> None:
        self._lock = lock
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        bounds = self._bounds
        i = 0
        n = len(bounds)
        while i < n and v > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def value(self) -> Dict[str, object]:
        with self._lock:
            return {
                "buckets": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class _Metric:
    """Base: name, help, label names, child cache, cardinality cap."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Sequence[str],
        max_cardinality: int,
        registry: "MetricsRegistry",
    ) -> None:
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(label_names)
        self._max_cardinality = max_cardinality
        self._registry = registry
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self._overflow_child: Optional[object] = None
        self.overflowed = 0
        # Label-less metrics get their default child eagerly so the
        # hot path never touches the cache.
        self._default = self._make_child() if not self.label_names else None
        if self._default is not None:
            self._children[()] = self._default

    # subclass hook
    def _make_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **kv: str):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}"
            )
        key = _label_key(self.label_names, kv)
        with self._lock:
            child = self._children.get(key)
            if child is not None:
                return child
            if len(self._children) >= self._max_cardinality:
                self.overflowed += 1
                if self._overflow_child is None:
                    self._overflow_child = self._make_child()
                    okey = tuple(
                        OVERFLOW_LABEL_VALUE for _ in self.label_names
                    )
                    self._children[okey] = self._overflow_child
                return self._overflow_child
            child = self._make_child()
            self._children[key] = child
            return child

    def remove(self, **kv: str) -> bool:
        """Drop one labelled series (e.g. a departed peer's gauge)."""
        key = _label_key(self.label_names, kv)
        with self._lock:
            return self._children.pop(key, None) is not None

    def _series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            items = list(self._children.items())
        items.sort(key=lambda it: it[0])
        return items


class Counter(_Metric):
    kind = "counter"

    def _make_child(self) -> _Child:
        return _CounterChild(threading.Lock())

    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    def value(self) -> float:
        return self._default.value() if self._default is not None else 0.0


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self) -> _Child:
        return _Child(threading.Lock())

    def set(self, v: float) -> None:
        self._default.set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    def value(self) -> float:
        return self._default.value() if self._default is not None else 0.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, *args, buckets: Optional[Sequence[float]] = None) -> None:
        bounds = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets: Tuple[float, ...] = bounds
        super().__init__(*args)

    def _make_child(self) -> _HistChild:
        return _HistChild(threading.Lock(), self.buckets)

    def observe(self, v: float) -> None:
        self._default.observe(v)


class MetricsRegistry:
    """Named home for every metric in the process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name, help, labels, max_cardinality, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match fed_<plane>_<name> "
                "(lowercase, underscore-separated)"
            )
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.label_names}"
                    )
                return existing
            metric = cls(name, help, labels, max_cardinality, self, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labels: Sequence[str] = (),
        max_cardinality: int = DEFAULT_LABEL_CARDINALITY,
    ) -> Counter:
        return self._register(Counter, name, help, labels, max_cardinality)

    def gauge(
        self, name: str, help: str = "", labels: Sequence[str] = (),
        max_cardinality: int = DEFAULT_LABEL_CARDINALITY,
    ) -> Gauge:
        return self._register(Gauge, name, help, labels, max_cardinality)

    def histogram(
        self, name: str, help: str = "", labels: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
        max_cardinality: int = DEFAULT_LABEL_CARDINALITY,
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labels, max_cardinality, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def zero(self) -> None:
        """Zero every series in place, keeping every metric and child
        registration — producers that captured child references at
        import time stay wired (unlike a registry swap, which detaches
        them)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                children = list(m._children.values())
            for child in children:
                with child._lock:
                    if isinstance(child, _HistChild):
                        child._counts = [0] * len(child._counts)
                        child._sum = 0.0
                        child._count = 0
                    else:
                        child._value = 0.0

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """Deterministic msgpack-clean dump of every series."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: Dict[str, dict] = {}
        for name, m in metrics:
            series = []
            for key, child in m._series():
                entry: Dict[str, object] = {
                    "labels": dict(zip(m.label_names, key)),
                    "value": child.value(),
                }
                series.append(entry)
            md: Dict[str, object] = {
                "type": m.kind,
                "help": m.help,
                "label_names": list(m.label_names),
                "series": series,
            }
            if isinstance(m, Histogram):
                md["buckets"] = list(m.buckets)
            out[name] = md
        return out


# ---------------------------------------------------------------------------
# Snapshot algebra (used by the agent's delta pushes and the collector).
# ---------------------------------------------------------------------------

def _series_map(metric_dict: dict) -> Dict[Tuple[Tuple[str, str], ...], dict]:
    out = {}
    for s in metric_dict.get("series", []):
        out[tuple(sorted(s.get("labels", {}).items()))] = s
    return out


def diff_snapshots(prev: Optional[dict], curr: dict) -> dict:
    """Subset of ``curr`` whose series changed since ``prev``.

    Values stay cumulative (not arithmetic deltas), so a re-sent diff
    is idempotent on merge — a lost push costs latency, never data.
    """
    if not prev:
        return curr
    out: Dict[str, dict] = {}
    for name, md in curr.items():
        pmd = prev.get(name)
        if pmd is None:
            out[name] = md
            continue
        pmap = _series_map(pmd)
        changed = [
            s for s in md.get("series", [])
            if pmap.get(tuple(sorted(s.get("labels", {}).items())), {}).get("value")
            != s.get("value")
        ]
        if changed:
            out[name] = dict(md, series=changed)
    return out


def merge_snapshot(base: dict, delta: dict) -> dict:
    """Fold a (possibly partial) delta into ``base`` in place."""
    for name, md in delta.items():
        bmd = base.get(name)
        if bmd is None:
            base[name] = {
                "type": md.get("type", "untyped"),
                "help": md.get("help", ""),
                "label_names": list(md.get("label_names", [])),
                "series": [dict(s) for s in md.get("series", [])],
            }
            if "buckets" in md:
                base[name]["buckets"] = list(md["buckets"])
            continue
        bmap = _series_map(bmd)
        for s in md.get("series", []):
            key = tuple(sorted(s.get("labels", {}).items()))
            if key in bmap:
                bmap[key]["value"] = s.get("value")
            else:
                bmd["series"].append(dict(s))
        bmd["series"].sort(key=lambda e: sorted(e.get("labels", {}).items()))
    return base


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and (math.isinf(v) or math.isnan(v)):
        return "+Inf" if v > 0 else ("-Inf" if v < 0 else "NaN")
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _fmt_labels(labels: Dict[str, str], extra: Dict[str, str]) -> str:
    merged = dict(labels)
    merged.update(extra)
    if not merged:
        return ""
    parts = []
    for k in sorted(merged):
        v = str(merged[k]).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def render_prometheus(
    snapshots: Iterable[Tuple[Dict[str, str], dict]],
) -> str:
    """Render ``(extra_labels, snapshot)`` pairs as Prometheus text.

    The collector passes one pair per party with
    ``extra_labels={"party": name}`` so the scrape is fleet-wide.
    """
    # Group series by metric name across all snapshots.
    names: Dict[str, dict] = {}
    rows: Dict[str, List[str]] = {}
    for extra, snap in snapshots:
        for name, md in sorted(snap.items()):
            names.setdefault(name, md)
            out = rows.setdefault(name, [])
            for s in md.get("series", []):
                labels = s.get("labels", {})
                val = s.get("value")
                if md.get("type") == "histogram":
                    bounds = list(md.get("buckets", [])) + [float("inf")]
                    counts = val.get("buckets", [])
                    cum = 0
                    for le, c in zip(bounds, counts):
                        cum += c
                        lab = _fmt_labels(labels, dict(extra, le=_fmt_value(le)))
                        out.append(f"{name}_bucket{lab} {cum}")
                    lab = _fmt_labels(labels, extra)
                    out.append(f"{name}_sum{lab} {_fmt_value(val.get('sum', 0.0))}")
                    out.append(f"{name}_count{lab} {val.get('count', 0)}")
                else:
                    lab = _fmt_labels(labels, extra)
                    out.append(f"{name}{lab} {_fmt_value(val)}")
    lines: List[str] = []
    for name in sorted(rows):
        md = names[name]
        if md.get("help"):
            lines.append(f"# HELP {name} {md['help']}")
        lines.append(f"# TYPE {name} {md.get('type', 'untyped')}")
        lines.extend(rows[name])
    return "\n".join(lines) + "\n" if lines else ""


# ---------------------------------------------------------------------------
# Process-global registry.
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()  # fedlint: disable=global-mutable-singleton (metrics registry is process-global by contract (docs/observability.md))
_registry_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (metrics registry is process-global by contract (docs/observability.md))


def get_registry() -> MetricsRegistry:
    return _registry


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh registry (tests only).

    Producers that captured child references keep writing to their
    old (now detached) children; live subsystems re-register on next
    construction. Job teardown must use :func:`zero_registry` instead.
    """
    global _registry
    with _registry_lock:
        _registry = MetricsRegistry()
        return _registry


def zero_registry() -> None:
    """In-place reset for last-job teardown: every series drops to zero
    but every registration — and every import-time child reference held
    across the codebase — stays wired into the live registry."""
    with _registry_lock:
        _registry.zero()
