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

"""The port's tenancy plane, mirroring ``test_tenancy.py`` with the same
assertions and torch task results (docs/multitenancy.md): per-job FedContext
resolution, the singleton-inventory reset contract, sequential and
concurrent job isolation, tenant quotas, and the weighted-fair QoS
scheduler."""

import json
import threading

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch.tenancy import context as tenancy
from rayfed_tpu_torch.tenancy import qos as tenancy_qos
from rayfed_tpu_torch.tenancy import reset as tenancy_reset
from rayfed_tpu_torch.tenancy.context import (
    JobScoped,
    TenancyConfig,
    TenantQuotaExceeded,
)
from tests.utils import FAST_COMM_CONFIG, get_addresses

CONFIG = {"cross_silo_comm": dict(FAST_COMM_CONFIG)}


@pytest.fixture(autouse=True)
def _clean_tenancy_state():
    yield
    tenancy_qos.reset_qos()
    tenancy.reset_tenancy()


# -- inventory/reset contract (satellite: fed.shutdown resets everything) ----


def test_inventory_every_singleton_has_reset_hook():
    """THE leak tripwire: every singleton fedlint's inventory finds in
    the tree resolves to a reset hook (or a justified process-wide
    exemption). A new module-global cache without one fails here."""
    gaps = tenancy_reset.verify_inventory_coverage()
    assert gaps == [], "\n".join(gaps)


def test_inventory_gap_is_detected(tmp_path):
    """The coverage check actually fails when a singleton lacks a hook —
    guard against the guard rotting into a tautology. The inventory
    names the JAX package's modules; the port checks those it has
    ported (a module it lacks is a plane still to port), so the fake
    singleton sits in a ported module with no hook."""
    fake = {
        "version": 1,
        "singletons": [{
            "module": "rayfed_tpu.utils",
            "name": "_sneaky_cache",
            "kind": "cache",
            "line": 1,
            "mutators": [],
        }],
    }
    path = tmp_path / "inv.json"
    path.write_text(json.dumps(fake))
    gaps = tenancy_reset.verify_inventory_coverage(str(path))
    assert len(gaps) == 1
    assert "_sneaky_cache" in gaps[0]


def test_locks_and_exemptions_are_skipped(tmp_path):
    fake = {
        "version": 1,
        "singletons": [
            {"module": "rayfed_tpu.utils", "name": "_lock", "kind": "lock",
             "line": 1, "mutators": []},
            {"module": "rayfed_tpu.proxy.tcp.checksum",
             "name": "_warned_algs", "kind": "container", "line": 1,
             "mutators": []},
        ],
    }
    path = tmp_path / "inv.json"
    path.write_text(json.dumps(fake))
    assert tenancy_reset.verify_inventory_coverage(str(path)) == []


def test_run_all_reset_hooks_never_raises(monkeypatch):
    """A failing hook is reported, not raised — shutdown must finish."""
    def boom():
        raise RuntimeError("injected hook failure")

    monkeypatch.setitem(
        tenancy_reset.RESET_HOOKS, "tests.fake_module",
        [(boom, tenancy_reset.JOB)],
    )
    failures = tenancy_reset.run_all_reset_hooks(None, last=True)
    assert any("boom" in f for f in failures)


def test_global_hooks_skipped_while_other_tenants_live(monkeypatch):
    calls = []
    monkeypatch.setitem(
        tenancy_reset.RESET_HOOKS, "tests.fake_module",
        [(lambda: calls.append("job"), tenancy_reset.JOB),
         (lambda: calls.append("global"), tenancy_reset.GLOBAL)],
    )
    tenancy_reset.run_all_reset_hooks(None, last=False)
    assert "job" in calls and "global" not in calls
    calls.clear()
    tenancy_reset.run_all_reset_hooks(None, last=True)
    assert "job" in calls and "global" in calls


def test_shutdown_clears_every_jobscoped_slot():
    """fed.shutdown leaves no per-job residue in ANY JobScoped slot and
    unregisters the FedContext — the sequential-isolation invariant at
    the state level."""
    addrs = get_addresses(["alice"])
    fed.init(addresses=addrs, party="alice", job_name="slate_job",
             config=CONFIG)
    assert tenancy.get_context("slate_job") is not None

    @fed.remote
    def echo(v):
        return v

    assert fed.get(echo.party("alice").remote(7)) == 7
    fed.shutdown()
    assert tenancy.get_context("slate_job") is None
    leftovers = [
        f"{inst.name}: {inst.jobs()}"
        for inst in JobScoped._instances
        if "slate_job" in inst.jobs()
    ]
    assert leftovers == [], leftovers


# -- context resolution ------------------------------------------------------


def test_use_context_isolates_jobscoped_state():
    slot = JobScoped("test.slot")
    a = tenancy.create_context("ctx_job_a", "alice")
    b = tenancy.create_context("ctx_job_b", "alice")
    try:
        with tenancy.use_context(a):
            slot.set("A")
        with tenancy.use_context(b):
            slot.set("B")
            assert slot.peek() == "B"
        with tenancy.use_context(a):
            assert slot.peek() == "A"
    finally:
        slot.clear_all()
        tenancy.remove_context("ctx_job_a")
        tenancy.remove_context("ctx_job_b")


def test_single_job_resolves_without_binding():
    """Threads never inherit contextvars; the sole-registered-job
    fallback is what keeps single-job processes working unchanged."""
    ctx = tenancy.create_context("solo_job", "alice")
    try:
        seen = []
        t = threading.Thread(
            target=lambda: seen.append(tenancy.current_job())
        )
        t.start()
        t.join()
        assert seen == ["solo_job"]
    finally:
        tenancy.remove_context("solo_job")
        del ctx


def test_tenancy_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown tenancy config keys"):
        TenancyConfig.from_dict({"wieght": 4})


def test_tenancy_config_validates_ranges():
    with pytest.raises(ValueError, match="weight"):
        TenancyConfig(weight=0)
    with pytest.raises(ValueError, match="executor_quota"):
        TenancyConfig(executor_quota=-1)


# -- sequential isolation ----------------------------------------------------


def _run_job_once(job_name, addrs):
    fed.init(addresses=addrs, party="alice", job_name=job_name,
             config=CONFIG)

    @fed.remote
    def produce():
        rng = np.random.default_rng(1234)
        return torch.from_numpy(rng.standard_normal(257).astype(np.float32))

    @fed.remote
    def transform(x):
        return torch.cumsum(x, 0) * 0.5

    out = fed.get(transform.party("alice").remote(
        produce.party("alice").remote()
    ))
    fed.shutdown()
    assert isinstance(out, torch.Tensor)
    return out.numpy().tobytes()


def test_sequential_jobs_byte_identical():
    """Job N+1 in a warm process == job N+1 in a fresh process: nothing
    a previous job cached may leak forward (the satellite's back-to-back
    leg; the state-level leg is test_shutdown_clears_every_jobscoped_slot)."""
    first = _run_job_once("seq_job_1", get_addresses(["alice"]))
    second = _run_job_once("seq_job_2", get_addresses(["alice"]))
    third = _run_job_once("seq_job_3", get_addresses(["alice"]))
    assert first == second == third


# -- concurrent twin ---------------------------------------------------------


def test_concurrent_jobs_byte_identical_to_isolated():
    """Two fed.init jobs running CONCURRENTLY in one process produce
    results byte-identical to their isolated sequential runs — the
    tentpole's zero-cross-talk acceptance at the API level."""
    isolated = {
        "twin_a": _run_job_once("twin_iso_a", get_addresses(["alice"])),
        "twin_b": _run_job_once("twin_iso_b", get_addresses(["alice"])),
    }
    results = {}
    errors = []
    barrier = threading.Barrier(2)

    def worker(job_name):
        try:
            barrier.wait(timeout=30)
            results[job_name] = _run_job_once(
                job_name, get_addresses(["alice"])
            )
        except Exception as e:  # noqa: BLE001 - surfaced via errors
            errors.append((job_name, repr(e)))

    threads = [
        threading.Thread(target=worker, args=(name,))
        for name in ("twin_a", "twin_b")
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert results["twin_a"] == isolated["twin_a"]
    assert results["twin_b"] == isolated["twin_b"]


def test_two_jobs_share_one_listener_port():
    """Shared-transport multiplexing: a second job whose receiver wants
    an already-bound port piggybacks on the owning job's listener, and
    frames route to each tenant's own store by header job id."""
    from rayfed_tpu_torch.proxy.tcp import tcp_proxy as mod

    FAST = {"retry_policy": {"max_attempts": 5, "initial_backoff_ms": 100}}
    addrs = get_addresses(["bob"])
    r1 = mod.TcpReceiverProxy(addrs["bob"], "bob", "share_a", None,
                              dict(FAST))
    r2 = mod.TcpReceiverProxy(addrs["bob"], "bob", "share_b", None,
                              dict(FAST))
    r1.start()
    r2.start()  # same port: piggybacks, does not fail
    try:
        assert r1.is_ready()[0] and r2.is_ready()[0]
        assert r2._piggyback_host is r1
        s1 = mod.TcpSenderProxy(addrs, "alice", "share_a", None, dict(FAST))
        s2 = mod.TcpSenderProxy(addrs, "alice", "share_b", None, dict(FAST))
        s1.start()
        s2.start()
        f1 = r1.get_data("alice", "1#0", 2)
        f2 = r2.get_data("alice", "1#0", 2)
        assert s1.send("bob", "for-A", "1#0", 2).result(30)
        assert s2.send("bob", "for-B", "1#0", 2).result(30)
        assert f1.result(30) == "for-A"
        assert f2.result(30) == "for-B"
        s1.stop()
        s2.stop()
    finally:
        r2.stop()
        r1.stop()


def test_listener_handoff_when_owner_job_exits():
    """When the owning job stops, a surviving tenant adopts the freed
    port — the second job keeps receiving without re-init."""
    import time

    from rayfed_tpu_torch.proxy.tcp import tcp_proxy as mod

    FAST = {"retry_policy": {"max_attempts": 10, "initial_backoff_ms": 100}}
    addrs = get_addresses(["bob"])
    r1 = mod.TcpReceiverProxy(addrs["bob"], "bob", "hand_a", None,
                              dict(FAST))
    r2 = mod.TcpReceiverProxy(addrs["bob"], "bob", "hand_b", None,
                              dict(FAST))
    r1.start()
    r2.start()
    try:
        assert r2._piggyback_host is r1
        r1.stop()  # owner exits; r2 must adopt the listener
        deadline = time.monotonic() + 10
        while r2._piggyback_host is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        s2 = mod.TcpSenderProxy(addrs, "alice", "hand_b", None, dict(FAST))
        s2.start()
        f2 = r2.get_data("alice", "1#0", 2)
        assert s2.send("bob", "post-handoff", "1#0", 2).result(30)
        assert f2.result(30) == "post-handoff"
        s2.stop()
    finally:
        r2.stop()


# -- tenant quotas -----------------------------------------------------------


def test_executor_quota_exceeded_is_loud():
    from rayfed_tpu_torch._private.executor import LocalExecutor

    ctx = tenancy.create_context(
        "quota_exec", "alice",
        tenancy=TenancyConfig(executor_quota=1),
    )
    pool = LocalExecutor(max_workers=2)
    release = threading.Event()
    try:
        with tenancy.use_context(ctx):
            holder = pool.submit(release.wait, (), eager=False)
            with pytest.raises(TenantQuotaExceeded) as exc:
                pool.submit(lambda: None, (), eager=False)
        assert exc.value.resource == "executor_tasks"
        release.set()
        assert holder.result(10) is True
        # The slot frees on completion: a new submit is admitted.
        with tenancy.use_context(ctx):
            assert pool.submit(lambda: 3, (), eager=False).result(10) == 3
    finally:
        release.set()
        pool.shutdown()
        tenancy.remove_context("quota_exec")


def test_eager_inline_tasks_bypass_executor_quota():
    """The quota caps SHARED pool occupancy; a task running inline on
    the caller's own thread costs the pool nothing."""
    from rayfed_tpu_torch._private.executor import LocalExecutor

    ctx = tenancy.create_context(
        "quota_inline", "alice",
        tenancy=TenancyConfig(executor_quota=0),
    )
    pool = LocalExecutor(max_workers=1)
    try:
        with tenancy.use_context(ctx):
            assert pool.submit(lambda: 5, ()).result(10) == 5
    finally:
        pool.shutdown()
        tenancy.remove_context("quota_inline")


def test_shm_ring_quota_on_ledger():
    ctx = tenancy.create_context(
        "quota_shm", "alice",
        tenancy=TenancyConfig(shm_ring_quota_mb=1),
    )
    ledger = tenancy_qos.get_ledger()
    try:
        ledger.charge("quota_shm", "shm_ring_bytes", 1 << 19)
        with pytest.raises(TenantQuotaExceeded) as exc:
            ledger.charge("quota_shm", "shm_ring_bytes", (1 << 19) + 1)
        assert exc.value.resource == "shm_ring_bytes"
        assert exc.value.limit == 1 << 20
        # Failed charge charged nothing; a fitting one still lands.
        ledger.charge("quota_shm", "shm_ring_bytes", 1 << 19)
        ledger.release("quota_shm", "shm_ring_bytes", 1 << 20)
        assert ledger.in_use("quota_shm", "shm_ring_bytes") == 0
        del ctx
    finally:
        tenancy.remove_context("quota_shm")


def test_kv_block_quota_enforced_at_server_registration():
    from rayfed_tpu_torch.serving import server as serving_server

    ctx = tenancy.create_context(
        "quota_kv", "alice",
        tenancy=TenancyConfig(kv_block_quota=4),
    )

    class _StubPool:
        max_slots = 8

    class _StubServer:
        name = "stub"
        pool = _StubPool()

        def stop(self, timeout=10.0):
            pass

    try:
        with tenancy.use_context(ctx):
            with pytest.raises(TenantQuotaExceeded) as exc:
                serving_server.register_server(_StubServer())
            assert exc.value.resource == "kv_blocks"
            # Under quota: registers, and unregister releases the charge.
            _StubPool.max_slots = 4
            srv = _StubServer()
            serving_server.register_server(srv)
            assert tenancy_qos.get_ledger().in_use(
                "quota_kv", "kv_blocks"
            ) == 4
            serving_server.unregister_server("stub")
            assert tenancy_qos.get_ledger().in_use(
                "quota_kv", "kv_blocks"
            ) == 0
    finally:
        tenancy.remove_context("quota_kv")


def test_quota_rejections_land_in_telemetry():
    from rayfed_tpu_torch.telemetry import metrics

    ctx = tenancy.create_context(
        "quota_tel", "alice",
        tenancy=TenancyConfig(executor_quota=0),
    )
    try:
        with pytest.raises(TenantQuotaExceeded):
            tenancy_qos.get_ledger().charge(
                "quota_tel", "executor_tasks", 1
            )
        snap = metrics.get_registry().snapshot()
        series = snap.get("fed_tenant_quota_rejections_total", {})
        assert any("quota_tel" in key for key in _series_keys(series)), snap
        del ctx
    finally:
        tenancy.remove_context("quota_tel")


def _series_keys(metric):
    """Label values present in one metric's registry snapshot entry
    (shape: {'series': [{'labels': {...}, 'value': ...}, ...], ...})."""
    keys = []
    for point in (metric or {}).get("series", []):
        keys.extend(str(v) for v in point.get("labels", {}).values())
    return keys


# -- weighted-fair QoS -------------------------------------------------------


def test_wfq_single_tenant_never_waits():
    sched = tenancy_qos.get_scheduler()
    sched.register("wfq_solo", TenancyConfig(weight=1))
    waited = sched.admit("wfq_solo", 64 << 20, tenancy_qos.TC_BULK)
    assert waited == 0.0
    assert sched.bytes_sent("wfq_solo") == 64 << 20


def test_wfq_inline_never_gated():
    sched = tenancy_qos.get_scheduler()
    sched.register("wfq_in_a", TenancyConfig(weight=1, max_wait_ms=5000))
    sched.register("wfq_in_b", TenancyConfig(weight=1, max_wait_ms=5000))
    # Bury tenant a in bulk debt…
    for _ in range(64):
        sched.admit("wfq_in_a", 1 << 20, tenancy_qos.TC_BULK)
    # …its inline traffic still passes instantly.
    waited = sched.admit("wfq_in_a", 4096, tenancy_qos.TC_INLINE)
    assert waited == 0.0


def test_wfq_converges_to_weights():
    """Two backlogged tenants at weights 1:4 end up with bulk bytes in
    ~1:4 — fairness_ratio ≥ the CI gate's floor."""
    sched = tenancy_qos.get_scheduler()
    sched.register("wfq_small", TenancyConfig(
        weight=1, fair_window_mb=1, max_wait_ms=200))
    sched.register("wfq_big", TenancyConfig(
        weight=4, fair_window_mb=1, max_wait_ms=200))
    stop = threading.Event()

    def pusher(job):
        while not stop.is_set():
            sched.admit(job, 1 << 18, tenancy_qos.TC_BULK)

    threads = [threading.Thread(target=pusher, args=(j,))
               for j in ("wfq_small", "wfq_big")]
    for t in threads:
        t.start()
    import time

    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    ratio = sched.fairness_ratio("wfq_small", "wfq_big")
    assert ratio is not None
    # Perfect fairness is 1.0; anything >= 0.25 clears the CI floor with
    # a wide margin — the point is the 1-weight tenant is NOT starved.
    assert ratio >= 0.25, sched.snapshot()
    # Debt = bytes/weight, so the 1-weight tenant runs ahead fastest and
    # is the one the gate throttles.
    assert sched.snapshot()["waits"].get("wfq_small", 0) > 0


def test_wfq_max_wait_bounds_the_gate():
    """The gate throttles, it never wedges: an over-budget tenant's push
    is released within ~max_wait_ms even while a competitor is starved."""
    import time

    sched = tenancy_qos.get_scheduler()
    sched.register("wfq_cap_a", TenancyConfig(
        weight=1, fair_window_mb=1, max_wait_ms=300))
    sched.register("wfq_cap_b", TenancyConfig(
        weight=1, fair_window_mb=1, max_wait_ms=300))
    with sched._cond:
        sched._pending["wfq_cap_b"] = 1  # competitor with backlog
    try:
        sched.admit("wfq_cap_a", 8 << 20, tenancy_qos.TC_BULK)  # build debt
        t0 = time.monotonic()
        sched.admit("wfq_cap_a", 8 << 20, tenancy_qos.TC_BULK)
        elapsed = time.monotonic() - t0
        assert elapsed < 2.0, f"gate held the push {elapsed:.2f}s"
    finally:
        with sched._cond:
            sched._pending.pop("wfq_cap_b", None)
            sched._cond.notify_all()


def test_tenant_bytes_series_labeled_per_job():
    from rayfed_tpu_torch.telemetry import metrics

    sched = tenancy_qos.get_scheduler()
    sched.register("tel_job_a", TenancyConfig(weight=2))
    sched.admit("tel_job_a", 1024, tenancy_qos.TC_BULK)
    snap = metrics.get_registry().snapshot()
    byte_series = snap.get("fed_tenant_bytes_total", {})
    weight_series = snap.get("fed_tenant_weight", {})
    assert any("tel_job_a" in k for k in _series_keys(byte_series)), snap
    assert any("tel_job_a" in k for k in _series_keys(weight_series)), snap


def test_fed_init_rejects_typoed_tenancy_key():
    addrs = get_addresses(["alice"])
    with pytest.raises(ValueError, match="unknown tenancy config keys"):
        fed.init(
            addresses=addrs, party="alice", job_name="typo_job",
            config=dict(CONFIG, tenancy={"wieght": 2}),
        )
    # A rejected init leaves no half-registered job behind.
    assert tenancy.get_context("typo_job") is None
