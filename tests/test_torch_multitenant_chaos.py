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

"""The port's ``multitenant_isolation`` chaos test, mirroring
``test_multitenant_chaos.py`` with torch payloads (docs/multitenancy.md): a
noisy-neighbor bulk job hammering 100MB of pushes through the SHARED
listener beside a victim job doing inline serving-class traffic. The
victim's p99 must stay bounded (the weighted-fair gate + ungated inline
class is what bounds it), every frame must land in its own job's store,
and the FedSanitizer's tenant-bleed probe must stay silent."""

import os
import threading
import time

import numpy as np
import torch

from rayfed_tpu_torch import sanitize
from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy, TcpSenderProxy
from rayfed_tpu_torch.tenancy import context as tenancy
from rayfed_tpu_torch.tenancy import qos as tenancy_qos
from rayfed_tpu_torch.tenancy.context import TenancyConfig
from tests.utils import get_addresses

FAST = {"retry_policy": {"max_attempts": 10, "initial_backoff_ms": 100}}

#: noisy neighbor: ~100MB of bulk in 10MB pushes.
NOISY_PUSH_BYTES = 10 << 20
NOISY_PUSHES = 10
#: victim: serving-class inline messages (well under the 64KB threshold).
VICTIM_MSG_BYTES = 4096
VICTIM_MSGS = 200


def test_multitenant_isolation():
    p99_budget_ms = float(os.environ.get("FEDTPU_TENANT_P99_MS", 250.0))
    sanitize.enable()
    sanitize.reset()
    sched = tenancy_qos.get_scheduler()
    sched.register("victim", TenancyConfig(weight=4, fair_window_mb=2))
    sched.register("noisy", TenancyConfig(weight=1, fair_window_mb=2))

    cfg = dict(FAST, shm_enabled=True, shm_ring_mb=64)
    addrs = get_addresses(["bob"])
    r_victim = TcpReceiverProxy(addrs["bob"], "bob", "victim", None,
                                dict(cfg))
    r_noisy = TcpReceiverProxy(addrs["bob"], "bob", "noisy", None,
                               dict(cfg))
    r_victim.start()
    r_noisy.start()  # same port: piggybacks on the victim's listener
    s_victim = TcpSenderProxy(addrs, "alice", "victim", None, dict(cfg))
    s_noisy = TcpSenderProxy(addrs, "alice", "noisy", None, dict(cfg))
    s_victim.start()
    s_noisy.start()

    noisy_payload = torch.arange(NOISY_PUSH_BYTES // 4, dtype=torch.int32)
    errors = []
    noisy_done = threading.Event()

    def noisy_job():
        try:
            for i in range(NOISY_PUSHES):
                fut = r_noisy.get_data("alice", f"{i}#0", i + 1)
                assert s_noisy.send(
                    "bob", noisy_payload, f"{i}#0", i + 1
                ).result(120)
                got = fut.result(120)
                assert isinstance(got, torch.Tensor)
                assert torch.equal(got, noisy_payload)
        except Exception as e:  # noqa: BLE001 - surfaced via errors
            errors.append(f"noisy: {e!r}")
        finally:
            noisy_done.set()

    latencies_ms = []

    def victim_job():
        try:
            rng = np.random.default_rng(7)
            for i in range(VICTIM_MSGS):
                payload = torch.from_numpy(rng.integers(
                    0, 255, VICTIM_MSG_BYTES, dtype=np.uint8
                ))
                fut = r_victim.get_data("alice", f"{i}#0", i + 1)
                t0 = time.monotonic()
                s_victim.send("bob", payload, f"{i}#0", i + 1)
                got = fut.result(60)
                latencies_ms.append((time.monotonic() - t0) * 1e3)
                assert isinstance(got, torch.Tensor)
                assert torch.equal(got, payload)
        except Exception as e:  # noqa: BLE001 - surfaced via errors
            errors.append(f"victim: {e!r}")

    threads = [threading.Thread(target=noisy_job, name="noisy"),
               threading.Thread(target=victim_job, name="victim")]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads), "chaos run wedged"
        assert not errors, errors

        # 1. Zero cross-job deliveries: the tenant-bleed probe (armed
        # via FEDTPU_SANITIZE) never tripped, on top of every payload
        # byte-comparing clean above.
        trips = sanitize.trips()
        assert trips.get("tenant-bleed", 0) == 0, trips

        # 2. The victim's p99 stays bounded while ~100MB of neighbor
        # bulk crossed the same listener: inline class is never gated.
        lat = sorted(latencies_ms)
        assert len(lat) == VICTIM_MSGS
        p99 = lat[int(0.99 * (len(lat) - 1))]
        assert p99 <= p99_budget_ms, (
            f"victim p99 {p99:.1f}ms over the {p99_budget_ms:.0f}ms "
            f"budget (FEDTPU_TENANT_P99_MS); median {lat[len(lat)//2]:.1f}ms"
        )

        # 3. The noisy job's traffic really was bulk-classed and metered
        # per tenant (the fairness data the bench gate consumes).
        assert sched.bytes_sent("noisy", tenancy_qos.TC_BULK) >= (
            NOISY_PUSHES * NOISY_PUSH_BYTES
        )
        assert sched.bytes_sent(
            "victim", tenancy_qos.TC_INLINE
        ) >= VICTIM_MSGS * VICTIM_MSG_BYTES
    finally:
        sanitize.disable()
        sanitize.reset()
        for p in (s_victim, s_noisy):
            try:
                p.stop()
            except Exception:  # noqa: BLE001
                pass
        for p in (r_noisy, r_victim):
            try:
                p.stop()
            except Exception:  # noqa: BLE001
                pass
        tenancy_qos.reset_qos()
        tenancy.reset_tenancy()


def test_noisy_neighbor_hits_quota_not_victim():
    """A noisy tenant over its shm quota fails loudly in ITS OWN job —
    the victim's sends are untouched (chaos-side view of the ledger)."""
    ledger = tenancy_qos.get_ledger()
    ctx = tenancy.create_context(
        "chaos_noisy", "alice",
        tenancy=TenancyConfig(shm_ring_quota_mb=8),
    )
    try:
        from rayfed_tpu_torch.tenancy.context import TenantQuotaExceeded

        ledger.charge("chaos_noisy", "shm_ring_bytes", 8 << 20)
        try:
            ledger.charge("chaos_noisy", "shm_ring_bytes", 1)
            raise AssertionError("quota did not trip")
        except TenantQuotaExceeded as e:
            assert e.job == "chaos_noisy"
        # The other tenant's accounting is independent.
        ledger.charge("chaos_victim", "shm_ring_bytes", 64 << 20)
        assert ledger.in_use("chaos_victim", "shm_ring_bytes") == 64 << 20
    finally:
        tenancy.remove_context("chaos_noisy")
        tenancy_qos.reset_qos()
        tenancy.reset_tenancy()
        del ctx
