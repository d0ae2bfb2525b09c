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

"""The port's telemetry plane, mirroring ``test_telemetry.py`` with the
same assertions (docs/observability.md): metrics registry semantics,
agent delta pushes against a flaky collector, cross-party trace
stitching, the collector's HTTP endpoints, and the hot-path overhead
contract. Unit tests run against FRESH ``MetricsRegistry`` instances so
they never disturb the process-global registry the instrumented
subsystems registered into. Snapshots round-trip through the port's own
msgpack codec, the one its wire uses. The two-party FedAvg pushes torch
trees; beyond the mirror, it runs with one party on the JAX package in
each direction, so a JAX agent feeds the port's collector and the port's
agent feeds a JAX collector."""

import json
import statistics
import time
import urllib.request
from concurrent.futures import Future

import pytest

from rayfed_tpu_torch import tracing
from rayfed_tpu_torch._private import msgpack_codec as msgpack
from rayfed_tpu_torch._private.constants import CODE_FORBIDDEN, CODE_OK
from rayfed_tpu_torch.proxy import rendezvous
from rayfed_tpu_torch.telemetry import metrics as tm
from rayfed_tpu_torch.telemetry.agent import TelemetryAgent
from rayfed_tpu_torch.telemetry.collector import CollectorHTTPServer, FleetCollector
from rayfed_tpu_torch.telemetry.config import TelemetryConfig


# ---------------------------------------------------------------------------
# Registry semantics
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    reg = tm.MetricsRegistry()
    c = reg.counter("fed_test_ops_total", "ops")
    c.inc()
    c.inc(3)
    g = reg.gauge("fed_test_depth", "depth")
    g.set(7)
    g.inc(-2)
    h = reg.histogram("fed_test_lat_ms", "latency", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 50.0, 5000.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["fed_test_ops_total"]["series"][0]["value"] == 4
    assert snap["fed_test_depth"]["series"][0]["value"] == 5
    hs = snap["fed_test_lat_ms"]["series"][0]["value"]
    # Per-slot bucket counts (cumulation happens only at Prometheus
    # render time): 0.5 -> le=1 slot, 50 -> le=100 slot, 5000 -> +Inf.
    assert hs["buckets"] == [1, 0, 1, 1]
    assert hs["count"] == 3 and hs["sum"] == pytest.approx(5050.5)


def test_counter_rejects_negative_and_gauge_allows_it():
    reg = tm.MetricsRegistry()
    c = reg.counter("fed_test_ops_total", "ops")
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("fed_test_level", "level")
    g.set(-3)
    assert reg.snapshot()["fed_test_level"]["series"][0]["value"] == -3


def test_metric_naming_scheme_enforced():
    reg = tm.MetricsRegistry()
    for bad in ("ops_total", "fed_Ops", "fed_", "fed__x", "fed-x"):
        with pytest.raises(ValueError):
            reg.counter(bad, "bad name")


def test_reregistration_idempotent_but_mismatch_raises():
    reg = tm.MetricsRegistry()
    a = reg.counter("fed_test_ops_total", "ops", labels=("lane",))
    b = reg.counter("fed_test_ops_total", "ops", labels=("lane",))
    assert a is b
    with pytest.raises(ValueError):
        reg.gauge("fed_test_ops_total", "now a gauge")
    with pytest.raises(ValueError):
        reg.counter("fed_test_ops_total", "ops", labels=("other",))


def test_label_cardinality_cap_collapses_to_other():
    reg = tm.MetricsRegistry()
    c = reg.counter(
        "fed_test_ops_total", "ops", labels=("peer",), max_cardinality=3
    )
    for i in range(10):
        c.labels(peer=f"p{i}").inc()
    snap = reg.snapshot()["fed_test_ops_total"]
    values = {
        s["labels"]["peer"]: s["value"] for s in snap["series"]
    }
    # 3 real children survive; the 7 overflow combos share one child.
    assert values[tm.OVERFLOW_LABEL_VALUE] == 7
    assert sum(values.values()) == 10 and len(values) == 4


def test_snapshot_deterministic_and_msgpack_clean():
    def build():
        reg = tm.MetricsRegistry()
        c = reg.counter("fed_test_ops_total", "ops", labels=("lane",))
        # Registration/bump order must not leak into the snapshot.
        for lane in ("b", "a", "c"):
            c.labels(lane=lane).inc()
        reg.histogram("fed_test_lat_ms", "lat").observe(3.0)
        return reg.snapshot()

    s1, s2 = build(), build()
    assert s1 == s2
    assert json.dumps(s1, sort_keys=True) == json.dumps(s2, sort_keys=True)
    # The agent ships snapshots over the msgpack wire: a roundtrip must
    # be lossless (no tuples, numpy scalars, or other non-msgpack types).
    assert msgpack.unpackb(msgpack.packb(s1), raw=False, strict_map_key=False) == s1


def test_diff_snapshots_ships_only_changes_and_merge_is_idempotent():
    reg = tm.MetricsRegistry()
    c = reg.counter("fed_test_ops_total", "ops", labels=("lane",))
    g = reg.gauge("fed_test_depth", "depth")
    c.labels(lane="a").inc()
    g.set(1)
    base = reg.snapshot()
    c.labels(lane="a").inc(2)
    curr = reg.snapshot()
    delta = tm.diff_snapshots(base, curr)
    # Only the changed metric rides the delta — with its FULL cumulative
    # value, so a re-delivered delta cannot double-count.
    assert list(delta) == ["fed_test_ops_total"]
    assert delta["fed_test_ops_total"]["series"][0]["value"] == 3
    merged = tm.merge_snapshot(base, delta)
    assert merged == curr
    assert tm.merge_snapshot(merged, delta) == curr  # idempotent
    assert tm.diff_snapshots(curr, curr) == {}


def test_render_prometheus_text_format():
    reg = tm.MetricsRegistry()
    c = reg.counter("fed_test_ops_total", "op \"count\"", labels=("lane",))
    c.labels(lane='we"ird\\').inc(2)
    reg.histogram(
        "fed_test_lat_ms", "lat", buckets=(1.0, 10.0)
    ).observe(5.0)
    text = tm.render_prometheus([({"party": "alice"}, reg.snapshot())])
    assert "# TYPE fed_test_ops_total counter" in text
    # HELP text rides verbatim; only label VALUES get escaped.
    assert '# HELP fed_test_ops_total op "count"' in text
    assert 'fed_test_ops_total{lane="we\\"ird\\\\",party="alice"} 2' in text
    # Histogram explodes into cumulative buckets + sum + count, with
    # label keys sorted (le sorts before party).
    assert 'fed_test_lat_ms_bucket{le="1",party="alice"} 0' in text
    assert 'fed_test_lat_ms_bucket{le="10",party="alice"} 1' in text
    assert 'fed_test_lat_ms_bucket{le="+Inf",party="alice"} 1' in text
    assert 'fed_test_lat_ms_count{party="alice"} 1' in text


def test_metrics_overhead_microbench():
    """The hot path is the contract: a child increment must stay a
    lock-cheap constant-time bump (no allocation, no label hashing), so
    a tight loop prices at single-digit microseconds per op even on a
    noisy CI host."""
    reg = tm.MetricsRegistry()
    plain = reg.counter("fed_test_plain_total", "no labels")
    child = reg.counter(
        "fed_test_labeled_total", "labeled", labels=("lane",)
    ).labels(lane="tcp")
    n = 20_000
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            plain.inc()
            child.inc()
        reps.append((time.perf_counter() - t0) / (2 * n) * 1e6)
    per_op_us = statistics.median(reps)
    assert per_op_us < 10.0, f"hot-path inc costs {per_op_us:.2f}us/op"


# ---------------------------------------------------------------------------
# Agent -> collector protocol
# ---------------------------------------------------------------------------

_CFG = TelemetryConfig(collector="alice", push_interval_ms=20)


def _ok_send(collector):
    def send(payload, seq):
        fut = Future()
        code, msg = collector.ingest(payload)
        fut.set_result(code == CODE_OK)
        return fut

    return send


def test_agent_pushes_deltas_and_collector_merges():
    reg = tm.MetricsRegistry()
    c = reg.counter("fed_test_ops_total", "ops")
    collector = FleetCollector("job", "alice", _CFG)
    agent = TelemetryAgent(
        "bob", "job", "alice", _CFG,
        send_fn=_ok_send(collector), registry=reg,
    )
    c.inc(5)
    agent.tick()   # submit push #1 (full snapshot)
    agent.tick()   # resolve ack, nothing new to ship
    view = collector.fleet_view()
    assert view["parties"]["bob"]["metrics"][
        "fed_test_ops_total"]["series"][0]["value"] == 5
    assert not view["parties"]["bob"]["stale"]
    c.inc(2)
    agent.tick()
    agent.tick()
    view = collector.fleet_view()
    # Deltas carry full cumulative values: merged state equals source.
    assert view["parties"]["bob"]["metrics"][
        "fed_test_ops_total"]["series"][0]["value"] == 7


def test_agent_never_blocks_on_flaky_peer_and_collector_marks_stale():
    cfg = TelemetryConfig(
        collector="alice", push_interval_ms=20, stale_after_ms=80
    )
    reg = tm.MetricsRegistry()
    reg.counter("fed_test_ops_total", "ops").inc()
    collector = FleetCollector("job", "alice", cfg)
    # One good push so bob exists in the fleet view...
    agent = TelemetryAgent(
        "bob", "job", "alice", cfg,
        send_fn=_ok_send(collector), registry=reg,
    )
    agent.tick()
    assert not collector.fleet_view()["parties"]["bob"]["stale"]

    # ...then the peer wedges: futures never resolve. Ticks must return
    # immediately (the agent abandons the in-flight push after its
    # timeout and counts an error) — telemetry fails open, it never
    # backpressures the party it observes.
    def wedged(payload, seq):
        return Future()

    agent._send_fn = wedged
    for _ in range(4):
        t0 = time.perf_counter()
        agent.tick()
        assert time.perf_counter() - t0 < 0.5
        time.sleep(0.05)  # past the 2x-interval push timeout
    errors = reg.snapshot()["fed_telemetry_push_errors_total"]
    assert errors["series"][0]["value"] >= 1
    # The collector meanwhile ages bob out instead of blocking anything.
    view = collector.fleet_view()
    assert view["parties"]["bob"]["stale"]
    meta = json.loads(json.dumps(collector.fleet_view()))  # stays serializable
    assert meta["parties"]["bob"]["age_s"] > 0


def test_collector_stitches_spans_across_party_clocks():
    collector = FleetCollector("job", "alice", _CFG)
    # Two parties with WILDLY different perf_counter origins push spans
    # for the same seq edge; the collector must align them on the wall
    # clock (wall_s/perf_s pair), not trust raw perf timestamps.
    wall = 1_000_000.0

    def payload(party, perf_origin, spans, seq):
        return {
            "v": 1, "party": party, "job": "job", "seq": seq,
            "epoch": None, "wall_s": wall, "perf_s": perf_origin,
            "metrics": {}, "spans": spans,
        }

    send_span = {
        "idx": 0, "kind": "send", "peer": "bob", "up": "7#0", "down": "8",
        "nbytes": 64, "t_s": 500.0 + 0.010, "dur_s": 0.001, "ok": True,
        "extra": {},
    }
    recv_span = {
        "idx": 0, "kind": "recv", "peer": "alice", "up": "7#0", "down": "8",
        "nbytes": 64, "t_s": 9_000.0 + 0.025, "dur_s": 0.0, "ok": True,
        "extra": {},
    }
    assert collector.ingest(payload("alice", 500.0, [send_span], 0))[0] == CODE_OK
    assert collector.ingest(payload("bob", 9_000.0, [recv_span], 0))[0] == CODE_OK
    trace = collector.fleet_trace()
    assert trace["fleet"] is True
    (edge,) = trace["edges"]
    assert (edge["up"], edge["down"]) == ("7#0", "8")
    events = edge["events"]
    assert [e["party"] for e in events] == ["alice", "bob"]
    assert [e["kind"] for e in events] == ["send", "recv"]
    # Wall-aligned: 10ms and 25ms after the shared wall origin.
    assert events[1]["t_s"] - events[0]["t_s"] == pytest.approx(0.015)


def test_collector_dedups_respawned_span_indices():
    collector = FleetCollector("job", "alice", _CFG)
    span = {
        "idx": 3, "kind": "send", "peer": "bob", "up": "1#0", "down": "2",
        "nbytes": 1, "t_s": 1.0, "dur_s": 0.0, "ok": True, "extra": {},
    }
    base = {
        "v": 1, "party": "alice", "job": "job", "epoch": None,
        "wall_s": 100.0, "perf_s": 1.0, "metrics": {},
    }
    collector.ingest({**base, "seq": 0, "spans": [span]})
    # A re-delivered (or duplicate) push must not double the event.
    collector.ingest({**base, "seq": 1, "spans": [span]})
    (edge,) = collector.fleet_trace()["edges"]
    assert len(edge["events"]) == 1


def test_http_endpoint_serves_all_routes():
    reg = tm.MetricsRegistry()
    reg.counter("fed_test_ops_total", "ops").inc(3)
    collector = FleetCollector("job", "alice", _CFG)
    agent = TelemetryAgent(
        "alice", "job", "alice", _CFG,
        local_collector=collector, registry=reg,
    )
    agent.tick()
    server = CollectorHTTPServer(collector, "127.0.0.1", 0)
    try:
        url = server.url

        def get(path):
            with urllib.request.urlopen(url + path, timeout=5) as r:
                return r.read().decode("utf-8")

        text = get("/metrics")
        assert 'fed_test_ops_total{party="alice"} 3' in text
        assert "fed_telemetry_fleet_epoch 0" in text
        parsed = json.loads(get("/metrics.json"))
        assert parsed["alice"][
            "fed_test_ops_total"]["series"][0]["value"] == 3
        fleet = json.loads(get("/fleet"))
        assert fleet["fleet"] and "alice" in fleet["parties"]
        trace = json.loads(get("/trace"))
        assert trace["fleet"] and "edges" in trace
        assert get("/healthz").strip() == "ok"
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        server.stop()


def test_rendezvous_refuses_telemetry_frames_without_collector():
    store = rendezvous.RendezvousStore(
        "job", lambda header, payload: payload
    )
    try:
        hdr = {"job": "job", "src": "bob", "up": "tel:push:bob", "down": "0"}
        code, msg = store.offer(hdr, b"x")
        assert code == CODE_FORBIDDEN and "collector" in msg
        # Reserved-namespace frames are never parked for a consumer.
        assert not store._arrived
    finally:
        store.shutdown()


def test_get_stats_stays_per_instance_for_colocated_stores():
    # Registry series are process-global cumulative and co-located
    # instances (combined proxies, tests) share one series — get_stats()
    # must count from the instance's own mirror, so one store's traffic
    # never bleeds into another's stats.
    s1 = rendezvous.RendezvousStore("job", lambda h, p: p)
    try:
        s2 = rendezvous.RendezvousStore("job", lambda h, p: p)
        try:
            s1.offer(
                {"job": "job", "src": "b", "up": "e0:1", "down": "e0:1"},
                b"x",
            )
            assert s1.get_stats()["receive_op_count"] == 1
            assert s2.get_stats()["receive_op_count"] == 0
        finally:
            s2.shutdown()
    finally:
        s1.shutdown()


# ---------------------------------------------------------------------------
# 2-party FedAvg end-to-end: one seq id -> one stitched timeline
# ---------------------------------------------------------------------------


def _fleet_party(party, addresses, pkgs=None):
    import numpy as np

    if (pkgs or {}).get(party) == "jax":
        import rayfed_tpu as fed
        from rayfed_tpu import telemetry

        def as_leaf(x):
            return x
    else:
        import torch

        import rayfed_tpu_torch as fed
        from rayfed_tpu_torch import telemetry

        def as_leaf(x):
            return torch.from_numpy(x)

    fed.init(
        addresses=addresses,
        party=party,
        config={
            "cross_silo_comm": {
                "retry_policy": {
                    "max_attempts": 20,
                    "initial_backoff_ms": 100,
                    "max_backoff_ms": 1000,
                    "backoff_multiplier": 1.5,
                }
            },
            "telemetry": {
                "collector": "alice",
                "push_interval_ms": 100,
                "http_port": 0,
            },
        },
        logging_level="error",
    )

    @fed.remote
    def local_update(seed):
        rng = np.random.default_rng(seed)
        return {"w": as_leaf(rng.standard_normal(64).astype(np.float32))}

    @fed.remote
    def fedavg(a, b):
        return {"w": (a["w"] + b["w"]) / 2.0}

    for r in range(3):
        a = local_update.party("alice").remote(r)
        b = local_update.party("bob").remote(r + 100)
        fed.get(fedavg.party("alice").remote(a, b))
    time.sleep(0.5)  # a few push intervals so bob's spans land

    snap = fed.telemetry_snapshot()
    if party == "alice":
        assert snap["fleet"] is True
        assert not snap["parties"]["bob"]["stale"]
        # Unified naming: both parties report the same series names.
        for p in ("alice", "bob"):
            assert "fed_transport_send_ops_total" in snap["parties"][p]["metrics"]
        url = telemetry.http_url()
        with urllib.request.urlopen(url + "/trace", timeout=5) as resp:
            trace = json.loads(resp.read().decode("utf-8"))
        # THE correlation contract: bob's push of his update and alice's
        # receive of it stitched under one seq id, scraped off the wire.
        stitched = [
            e for e in trace["edges"]
            if len({ev["party"] for ev in e["events"]}) >= 2
        ]
        assert stitched, trace["edges"]
        kinds = {ev["kind"] for e in stitched for ev in e["events"]}
        assert "send" in kinds and kinds & {"recv", "decode"}
        with urllib.request.urlopen(url + "/metrics", timeout=5) as resp:
            text = resp.read().decode("utf-8")
        for p in ("alice", "bob"):
            assert f'party="{p}"' in text, p
    else:
        assert snap["fleet"] is False
        assert "fed_transport_send_ops_total" in snap["metrics"]
    fed.shutdown()


def test_two_party_fedavg_trace_stitched_end_to_end():
    from tests.utils import run_parties

    run_parties(_fleet_party, ["alice", "bob"])


@pytest.mark.parametrize("pkgs", [{"alice": "jax"}, {"bob": "jax"}],
                         ids=["jax_collector", "torch_collector"])
def test_fleet_view_crosses_packages(pkgs):
    """The same round with one party on the JAX package: its agent feeds
    the port's collector (torch_collector), or the port's agent feeds
    the JAX package's collector (jax_collector); the collector's merged
    snapshot holds the other party's series and stitches its spans."""
    from tests.utils import run_parties

    run_parties(_fleet_party, ["alice", "bob"], extra_args=(pkgs,))


# ---------------------------------------------------------------------------
# Tracing span index plumbing
# ---------------------------------------------------------------------------


def test_spans_since_walks_only_new_spans():
    tracing.enable(1024)
    try:
        start = tracing.last_span_index()
        tracing.record("send", "bob", "1", "1", 0, time.perf_counter())
        tracing.record("send", "bob", "2", "2", 0, time.perf_counter())
        new = tracing.spans_since(start)
        assert [s.upstream_seq_id for s in new] == ["1", "2"]
        assert new[-1].idx == tracing.last_span_index()
        assert tracing.spans_since(new[-1].idx) == []
        # limit keeps the MOST RECENT spans (reverse walk): under a
        # burst the agent drops the oldest tail, never the fresh edge.
        capped = tracing.spans_since(start, limit=1)
        assert [s.upstream_seq_id for s in capped] == ["2"]
    finally:
        tracing.disable()
