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

"""Fleet collector: merges per-party telemetry pushes into one view.

Runs at the configured collector party.  Agent pushes (``tel:push:*``
control frames) land in :meth:`FleetCollector.ingest`, which folds the
delta metrics snapshot into the party's merged cumulative snapshot,
stores the shipped tracing spans keyed by their (up, down) seq-id
edge, and remembers the push's wall/perf clock pair so span timestamps
from different processes can be aligned on one wall-clock timeline.

Outputs:

- :meth:`fleet_view` — epoch/roster-aware JSON fleet state (roster and
  epoch from the membership manager when installed, cluster addresses
  otherwise; parties with no recent accepted push — or a DEAD liveness
  verdict — are marked stale, never blocked on).
- :meth:`fleet_trace` — cross-party stitched timelines: every span any
  party recorded for one seq-id edge (sender ``send``, receiver
  ``recv``/``decode``, aggregator ``fold``/``publish``, membership
  ``M`` events) merged into a single wall-clock-ordered event list.
- :meth:`render_prometheus` — Prometheus text format, every series
  labelled with its source ``party``, plus collector-synthesized
  ``fed_telemetry_party_stale`` / ``fed_telemetry_push_age_seconds``.
- :class:`CollectorHTTPServer` — localhost HTTP endpoint serving
  ``/metrics`` (Prometheus text), ``/metrics.json``, ``/fleet``,
  ``/trace``, ``/healthz``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from rayfed_tpu_torch._private.constants import CODE_INTERNAL_ERROR, CODE_OK
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics
from rayfed_tpu_torch.telemetry.config import TelemetryConfig

logger = logging.getLogger(__name__)

_MAX_EDGES = 4096          # distinct (up, down) seq-id edges kept (LRU)
_MAX_EVENTS_PER_EDGE = 512


class _PartyState:
    __slots__ = (
        "snapshot", "last_push_s", "seq", "epoch", "wall_offset_s",
        "max_span_idx", "pushes",
    )

    def __init__(self) -> None:
        self.snapshot: dict = {}
        self.last_push_s = 0.0
        self.seq = -1
        self.epoch: Optional[int] = None
        self.wall_offset_s = 0.0
        self.max_span_idx = -1
        self.pushes = 0


class FleetCollector:
    def __init__(
        self,
        job_name: str,
        party: str,
        cfg: TelemetryConfig,
        addresses: Optional[Dict[str, str]] = None,
    ) -> None:
        self._job = job_name
        self._party = party
        self._cfg = cfg
        self._addresses = dict(addresses or {})
        self._lock = threading.Lock()
        self._parties: Dict[str, _PartyState] = {}
        # (up, down) -> list of event dicts (wall-clock t_s, "party"
        # stamped), LRU-bounded so a long job cannot grow without bound.
        self._edges: "OrderedDict[Tuple[str, str], List[dict]]" = OrderedDict()
        self._registered = False

    # -- ingest --------------------------------------------------------------

    def handle_push(self, header: Dict, value) -> Tuple[int, str]:
        """rendezvous control-handler signature; verdict rides the ack."""
        code, msg = self.ingest(value)
        return code, msg

    def ingest(self, payload) -> Tuple[int, str]:
        if not isinstance(payload, dict) or not payload.get("party"):
            return CODE_INTERNAL_ERROR, "malformed telemetry push"
        party = str(payload["party"])
        try:
            with self._lock:
                st = self._parties.get(party)
                if st is None:
                    st = self._parties[party] = _PartyState()
                st.last_push_s = time.time()
                st.pushes += 1
                seq = payload.get("seq")
                if isinstance(seq, int):
                    st.seq = max(st.seq, seq)
                epoch = payload.get("epoch")
                if isinstance(epoch, int):
                    st.epoch = epoch
                wall = payload.get("wall_s")
                perf = payload.get("perf_s")
                if isinstance(wall, (int, float)) and isinstance(
                    perf, (int, float)
                ):
                    st.wall_offset_s = float(wall) - float(perf)
                delta = payload.get("metrics")
                if isinstance(delta, dict) and delta:
                    telemetry_metrics.merge_snapshot(st.snapshot, delta)
                spans = payload.get("spans")
                if isinstance(spans, list) and spans:
                    self._ingest_spans_locked(party, st, spans)
        except Exception as e:  # noqa: BLE001 - verdict rides the ack
            logger.warning("telemetry ingest failed", exc_info=True)
            return CODE_INTERNAL_ERROR, f"telemetry ingest error: {e!r}"
        return CODE_OK, "ok"

    def _ingest_spans_locked(
        self, party: str, st: _PartyState, spans: List[dict]
    ) -> None:
        for s in spans:
            if not isinstance(s, dict):
                continue
            idx = s.get("idx", -1)
            if isinstance(idx, int) and idx <= st.max_span_idx:
                continue  # duplicate from a re-sent (unacked) push
            if isinstance(idx, int):
                st.max_span_idx = idx
            key = (str(s.get("up", "")), str(s.get("down", "")))
            events = self._edges.get(key)
            if events is None:
                while len(self._edges) >= _MAX_EDGES:
                    self._edges.popitem(last=False)
                events = self._edges[key] = []
            else:
                self._edges.move_to_end(key)
            if len(events) >= _MAX_EVENTS_PER_EDGE:
                continue
            ev = {
                "kind": s.get("kind", "?"),
                "party": party,
                "peer": s.get("peer", ""),
                # perf_counter -> shared wall clock via the push's
                # wall/perf pair (cross-process comparable).
                "t_s": float(s.get("t_s", 0.0)) + st.wall_offset_s,
                "dur_s": float(s.get("dur_s", 0.0)),
                "nbytes": s.get("nbytes", 0),
                "ok": bool(s.get("ok", True)),
            }
            extra = s.get("extra")
            if isinstance(extra, dict):
                for k, v in extra.items():
                    ev.setdefault(k, v)
            if "epoch" not in ev and st.epoch is not None:
                ev["epoch"] = st.epoch
            events.append(ev)

    # -- roster / staleness --------------------------------------------------

    def _membership_view(self):
        try:
            from rayfed_tpu_torch.membership.manager import get_membership_manager

            mgr = get_membership_manager()
            if mgr is not None:
                return mgr.view()
        except Exception:  # noqa: BLE001 - membership not installed
            pass
        return None

    def _liveness(self, party: str) -> str:
        try:
            from rayfed_tpu_torch.resilience import liveness

            return liveness.party_state(party)
        except Exception:  # noqa: BLE001 - monitor not running
            return "ALIVE"

    def fleet_view(self) -> dict:
        now = time.time()
        view = self._membership_view()
        if view is not None:
            roster = sorted(view.roster)
            epoch: Optional[int] = view.epoch
        else:
            roster = sorted(self._addresses) or None
            epoch = None
        with self._lock:
            known = sorted(set(self._parties) | set(roster or []))
            parties = {}
            for p in known:
                st = self._parties.get(p)
                liveness_state = self._liveness(p)
                if st is None:
                    parties[p] = {
                        "stale": True,
                        "age_s": None,
                        "seq": -1,
                        "epoch": None,
                        "pushes": 0,
                        "liveness": liveness_state,
                        "in_roster": roster is None or p in roster,
                        "metrics": {},
                    }
                    continue
                age = now - st.last_push_s
                parties[p] = {
                    "stale": (
                        age > self._cfg.stale_after_s
                        or liveness_state == "DEAD"
                    ),
                    "age_s": age,
                    "seq": st.seq,
                    "epoch": st.epoch,
                    "pushes": st.pushes,
                    "liveness": liveness_state,
                    "in_roster": roster is None or p in roster,
                    "metrics": st.snapshot,
                }
                if epoch is None and st.epoch is not None:
                    epoch = st.epoch
        return {
            "fleet": True,
            "job": self._job,
            "collector": self._party,
            "t_s": now,
            "epoch": epoch,
            "roster": roster,
            "stale_after_s": self._cfg.stale_after_s,
            "parties": parties,
        }

    # -- trace stitching -----------------------------------------------------

    def fleet_trace(self) -> dict:
        """Cross-party stitched timelines, one entry per seq-id edge."""
        with self._lock:
            edges = [
                {"up": up, "down": down,
                 "events": sorted(events, key=lambda e: e["t_s"])}
                for (up, down), events in self._edges.items()
                if events
            ]
            parties = sorted(self._parties)
        edges.sort(key=lambda e: e["events"][0]["t_s"])
        t0 = edges[0]["events"][0]["t_s"] if edges else 0.0
        return {
            "fleet": True,
            "job": self._job,
            "collector": self._party,
            "parties": parties,
            "t0_s": t0,
            "edges": edges,
        }

    # -- render --------------------------------------------------------------

    def _meta_snapshot(self, view: dict) -> dict:
        """Collector-synthesized staleness series (schema-compatible
        with registry snapshots so one renderer serves both)."""
        stale_series = []
        age_series = []
        for p, info in sorted(view["parties"].items()):
            stale_series.append(
                {"labels": {"party": p}, "value": 1.0 if info["stale"] else 0.0}
            )
            if info["age_s"] is not None:
                age_series.append(
                    {"labels": {"party": p}, "value": info["age_s"]}
                )
        meta = {
            "fed_telemetry_party_stale": {
                "type": "gauge",
                "help": "1 when the party has no recent accepted push "
                        "(or is DEAD per liveness).",
                "label_names": ["party"],
                "series": stale_series,
            },
            "fed_telemetry_push_age_seconds": {
                "type": "gauge",
                "help": "Seconds since the party's last accepted push.",
                "label_names": ["party"],
                "series": age_series,
            },
        }
        # Epoch 0 when membership is off: the series is part of the
        # core roll call (tools/obs_check.py) either way.
        epoch = view.get("epoch") or 0
        meta["fed_telemetry_fleet_epoch"] = {
            "type": "gauge",
            "help": "Highest membership epoch seen fleet-wide "
                    "(0 when elastic membership is off).",
            "label_names": [],
            "series": [{"labels": {}, "value": float(epoch)}],
        }
        return meta

    def render_prometheus(self) -> str:
        view = self.fleet_view()
        pairs = [({}, self._meta_snapshot(view))]
        for p, info in sorted(view["parties"].items()):
            if info["metrics"]:
                pairs.append(({"party": p}, info["metrics"]))
        return telemetry_metrics.render_prometheus(pairs)

    # -- wire registration ---------------------------------------------------

    def register(self) -> None:
        from rayfed_tpu_torch.proxy import rendezvous

        rendezvous.register_control_prefix(
            self._job, rendezvous.TELEMETRY_SEQ_PREFIX, self.handle_push
        )
        self._registered = True

    def unregister(self) -> None:
        if not self._registered:
            return
        from rayfed_tpu_torch.proxy import rendezvous

        rendezvous.unregister_control_prefix(
            self._job, rendezvous.TELEMETRY_SEQ_PREFIX
        )
        self._registered = False


class CollectorHTTPServer:
    """Localhost HTTP endpoint over a :class:`FleetCollector`."""

    def __init__(
        self, collector: FleetCollector, host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        import http.server

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
                logger.debug("telemetry http: " + fmt, *args)

            def do_GET(self):  # noqa: N802 - stdlib name
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = collector.render_prometheus().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/metrics.json":
                        body = json.dumps(
                            {p: i["metrics"] for p, i in
                             collector.fleet_view()["parties"].items()}
                        ).encode()
                        ctype = "application/json"
                    elif path == "/fleet":
                        body = json.dumps(
                            collector.fleet_view(), default=str
                        ).encode()
                        ctype = "application/json"
                    elif path == "/trace":
                        body = json.dumps(
                            collector.fleet_trace(), default=str
                        ).encode()
                        ctype = "application/json"
                    elif path == "/healthz":
                        body, ctype = b"ok\n", "text/plain"
                    else:
                        self.send_error(404)
                        return
                except Exception:  # noqa: BLE001 - scrape must not kill serve
                    logger.warning("telemetry http render failed",
                                   exc_info=True)
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        # Threading so a slow scraper cannot serialize /metrics behind
        # /trace; daemon threads so shutdown never waits on a client.
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="fedtpu-telemetry-http",
            daemon=True,
        )
        self._thread.start()
        self._collector = collector

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass
        self._thread.join(timeout=2.0)
