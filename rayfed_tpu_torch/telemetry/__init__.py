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

"""Federation-wide telemetry plane (docs/observability.md).

- :mod:`rayfed_tpu_torch.telemetry.metrics` — process-wide metrics registry
  every subsystem's ``get_stats()`` delegates to (``fed_<plane>_<name>``
  naming).
- :mod:`rayfed_tpu_torch.telemetry.agent` — per-party agent pushing delta
  snapshots + tracing spans to the collector over the inline
  small-message lane (reserved ``tel:`` seq ids).
- :mod:`rayfed_tpu_torch.telemetry.collector` — collector-party fleet view,
  cross-party trace stitching, Prometheus/JSON HTTP endpoint.

Wired from ``fed.init(config={"telemetry": {...}})``; see
:class:`rayfed_tpu_torch.telemetry.config.TelemetryConfig` for the knobs.
This module stays import-light (rendezvous imports ``.metrics`` at
module scope); the agent/collector machinery loads on :func:`start`.

Tenancy: each job gets its own agent/collector/HTTP slot (JobScoped),
so two concurrent ``fed.init`` jobs in one process run independent
telemetry planes; cross-tenant series separation inside the shared
metrics registry rides the ``fed_tenant_*{job=...}`` label dimension.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Dict, Optional

from rayfed_tpu_torch.telemetry import metrics  # noqa: F401 - re-export
from rayfed_tpu_torch.telemetry.config import TelemetryConfig
from rayfed_tpu_torch.tenancy.context import JobScoped

logger = logging.getLogger(__name__)

_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the per-job plane slots)
_planes: JobScoped = JobScoped("telemetry.plane")


class _Plane:
    """One job's telemetry machinery (agent + optional collector/HTTP)."""

    __slots__ = (
        "agent", "collector", "http", "job_name", "party",
        "we_enabled_tracing",
    )

    def __init__(self, job_name: str, party: str) -> None:
        self.agent = None
        self.collector = None
        self.http = None
        self.job_name = job_name
        self.party = party
        self.we_enabled_tracing = False


def resolve_collector(cfg: TelemetryConfig, parties) -> str:
    """Configured collector party, else the lexicographically first
    party (same default as the membership coordinator)."""
    if cfg.collector:
        return cfg.collector
    return sorted(parties)[0]


def start(
    job_name: str,
    party: str,
    addresses: Dict[str, str],
    cfg: TelemetryConfig,
) -> None:
    """Start this party's telemetry plane: the push agent everywhere,
    plus the collector (and optional HTTP endpoint) when ``party`` is
    the collector party. Idempotent per init; re-entrant after stop()."""
    from rayfed_tpu_torch import tracing
    from rayfed_tpu_torch.telemetry.agent import TelemetryAgent
    from rayfed_tpu_torch.telemetry.collector import (
        CollectorHTTPServer,
        FleetCollector,
    )

    with _lock:
        _stop_locked()
        plane = _Plane(job_name, party)
        if cfg.enable_tracing and not tracing.is_enabled():
            tracing.enable()
            plane.we_enabled_tracing = True
        collector_party = resolve_collector(cfg, addresses or [party])
        if party == collector_party:
            plane.collector = FleetCollector(job_name, party, cfg, addresses)
            plane.collector.register()
            if cfg.http_port is not None:
                try:
                    plane.http = CollectorHTTPServer(
                        plane.collector, cfg.http_host, cfg.http_port
                    )
                    logger.info("telemetry endpoint at %s", plane.http.url)
                except Exception:  # noqa: BLE001 - endpoint is optional
                    logger.warning(
                        "telemetry HTTP endpoint failed to start",
                        exc_info=True,
                    )
                    plane.http = None
        plane.agent = TelemetryAgent(
            party, job_name, collector_party, cfg,
            local_collector=plane.collector,
        )
        _planes.set(plane)
        plane.agent.start()


def _stop_locked(flush: bool = False) -> None:
    plane = _planes.pop()
    if plane is None:
        return
    if plane.agent is not None:
        try:
            plane.agent.stop(flush=flush)
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass
    if plane.http is not None:
        try:
            plane.http.stop()
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass
    if plane.collector is not None:
        try:
            plane.collector.unregister()
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass
    if plane.we_enabled_tracing:
        from rayfed_tpu_torch import tracing

        tracing.disable()


def stop(flush: bool = True) -> None:
    with _lock:
        _stop_locked(flush=flush)


def is_running() -> bool:
    plane = _planes.peek()
    return plane is not None and plane.agent is not None


def get_agent():
    plane = _planes.peek()
    return None if plane is None else plane.agent


def get_collector():
    plane = _planes.peek()
    return None if plane is None else plane.collector


def http_url() -> Optional[str]:
    plane = _planes.peek()
    if plane is None or plane.http is None:
        return None
    return plane.http.url


def telemetry_snapshot() -> dict:
    """The fleet view on the collector party; this party's local
    registry snapshot elsewhere (``fleet`` key tells which you got)."""
    plane = _planes.peek()
    col = None if plane is None else plane.collector
    if col is not None:
        view = col.fleet_view()
        url = http_url()
        if url:
            view["endpoint"] = url
        return view
    return {
        "fleet": False,
        "job": None if plane is None else plane.job_name,
        "party": None if plane is None else plane.party,
        "metrics": metrics.get_registry().snapshot(),
    }


def export_fleet_trace(path: Optional[str] = None) -> dict:
    """The collector's stitched cross-party trace. With ``path``, also
    written as JSON (``tools/trace_view.py --fleet`` input format)."""
    plane = _planes.peek()
    col = None if plane is None else plane.collector
    if col is None:
        raise RuntimeError(
            "export_fleet_trace() must run on the collector party "
            "(no fleet collector here)"
        )
    doc = col.fleet_trace()
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, default=str)
    return doc
