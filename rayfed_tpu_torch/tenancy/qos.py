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

"""Per-tenant QoS over the shared transport: the weighted-fair bulk
scheduler and the tenant resource ledger (docs/multitenancy.md).

Traffic classes
---------------
``inline``  — small frames, error envelopes, control traffic: never
gated (this is what keeps a victim serving job's p99 bounded while a
noisy neighbor streams checkpoints).
``bulk``    — everything at/above the sender's small-message threshold:
passes the weighted-fair admission gate before touching a shared lane.

Scheduling model (debt-based WFQ)
---------------------------------
Each tenant accumulates *debt* = bytes sent / weight. A bulk push is
admitted when the tenant's debt runs no more than one fairness window
ahead of the most-starved tenant that currently has backlog; otherwise
it waits (bounded by ``max_wait_ms`` — the gate throttles, it never
wedges, and it is work-conserving: a sole tenant is never delayed).
Over any busy interval this converges to bytes proportional to weights,
which is exactly the ``tenant_fairness_ratio`` the bench gate measures.

The scheduler and ledger are process-wide **by design**: they arbitrate
*across* tenants, so a per-job handle cannot host them. Their reset
hooks are :func:`reset_qos`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from rayfed_tpu_torch.tenancy.context import (
    TenancyConfig,
    TenantQuotaExceeded,
    current_job,
    get_context,
)

#: traffic classes
TC_INLINE = "inline"
TC_BULK = "bulk"

#: how long after its last bulk push a tenant still counts as backlogged
#: for the fairness gate (a streaming flow between two pushes).
_ACTIVITY_HORIZON_S = 0.25


def _tenant_bytes_counter():
    from rayfed_tpu_torch.telemetry import metrics

    return metrics.get_registry().counter(
        "fed_tenant_bytes_total",
        "Bytes admitted to shared transport lanes, by tenant and class.",
        labels=("job", "tc"),
    )


def _tenant_waits_counter():
    from rayfed_tpu_torch.telemetry import metrics

    return metrics.get_registry().counter(
        "fed_tenant_qos_waits_total",
        "Bulk pushes the weighted-fair gate made wait, by tenant.",
        labels=("job",),
    )


def _tenant_weight_gauge():
    from rayfed_tpu_torch.telemetry import metrics

    return metrics.get_registry().gauge(
        "fed_tenant_weight",
        "Configured weighted-fair share, by tenant.",
        labels=("job",),
    )


def _tenant_quota_counter():
    from rayfed_tpu_torch.telemetry import metrics

    return metrics.get_registry().counter(
        "fed_tenant_quota_rejections_total",
        "Sends/submits rejected by a tenant quota, by tenant and resource.",
        labels=("job", "resource"),
    )


class WeightedFairScheduler:
    """Debt-based weighted-fair admission for bulk transport traffic."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._weights: Dict[str, float] = {}
        self._debt: Dict[str, float] = {}
        self._pending: Dict[str, int] = {}
        # Last bulk-push time per tenant: a competitor counts as
        # backlogged while inside admit() OR within the activity horizon
        # of its last push — a tenant streaming back-to-back pushes is
        # never *instantaneously* pending, yet it is exactly the flow
        # fairness must weigh against.
        self._last_push: Dict[str, float] = {}
        self._bytes: Dict[Tuple[str, str], int] = {}
        self._waits: Dict[str, int] = {}
        self._window: Dict[str, float] = {}
        self._max_wait: Dict[str, float] = {}

    # -- registration -------------------------------------------------------

    def register(self, job: str, cfg: Optional[TenancyConfig] = None) -> None:
        cfg = cfg or TenancyConfig()
        with self._cond:
            self._weights[job] = float(cfg.weight)
            self._debt.setdefault(job, self._min_debt_locked())
            self._pending.setdefault(job, 0)
            self._window[job] = float(cfg.fair_window_mb) * (1 << 20)
            self._max_wait[job] = float(cfg.max_wait_ms) / 1000.0
            self._cond.notify_all()
        try:
            _tenant_weight_gauge().labels(job=job).set(float(cfg.weight))
        except Exception:  # noqa: BLE001 - telemetry only
            pass

    def unregister(self, job: str) -> None:
        with self._cond:
            self._weights.pop(job, None)
            self._debt.pop(job, None)
            self._pending.pop(job, None)
            self._last_push.pop(job, None)
            self._window.pop(job, None)
            self._max_wait.pop(job, None)
            for key in [k for k in self._bytes if k[0] == job]:
                self._bytes.pop(key, None)
            self._waits.pop(job, None)
            # A departing tenant can be the one everyone was waiting on.
            self._cond.notify_all()

    def _min_debt_locked(self) -> float:
        return min(self._debt.values()) if self._debt else 0.0

    def _params(self, job: Optional[str]):
        weight = self._weights.get(job, 1.0) if job is not None else 1.0
        window = self._window.get(job, 8.0 * (1 << 20))
        max_wait = self._max_wait.get(job, 2.0)
        return weight, window, max_wait

    # -- admission ----------------------------------------------------------

    def admit(self, job: Optional[str], nbytes: int,
              tc: str = TC_BULK) -> float:
        """Admit one push of ``nbytes`` for ``job``; returns seconds
        waited. Inline traffic and single-tenant processes pass straight
        through; bulk traffic waits (bounded) while this tenant is more
        than a fairness window ahead of a backlogged competitor."""
        if job is None:
            job = current_job()
        waited = 0.0
        charge_job = job
        if tc == TC_BULK and job is not None:
            weight, window, max_wait = self._params(job)
            cost = float(nbytes) / max(weight, 1e-9)
            deadline = time.monotonic() + max_wait
            waited_flag = False
            with self._cond:
                if job in self._weights and len(self._weights) > 1:
                    self._pending[job] = self._pending.get(job, 0) + 1
                    try:
                        while True:
                            now = time.monotonic()
                            others = [
                                j for j in self._weights
                                if j != job and (
                                    self._pending.get(j, 0) > 0
                                    or now - self._last_push.get(j, -1e9)
                                    < _ACTIVITY_HORIZON_S
                                )
                            ]
                            if not others:
                                break  # work-conserving: no competitor
                            min_other = min(
                                self._debt.get(j, 0.0) for j in others
                            )
                            my_debt = self._debt.get(job, 0.0)
                            if my_debt + cost - min_other <= window / max(
                                self._weights.get(job, 1.0), 1e-9
                            ):
                                break
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break  # bounded: throttle, never wedge
                            waited_flag = True
                            t0 = time.monotonic()
                            self._cond.wait(min(remaining, 0.05))
                            waited += time.monotonic() - t0
                    finally:
                        self._pending[job] = max(
                            0, self._pending.get(job, 1) - 1
                        )
                    self._debt[job] = self._debt.get(job, 0.0) + cost
                    self._last_push[job] = time.monotonic()
                    # Renormalize so debts don't grow without bound.
                    floor = self._min_debt_locked()
                    if floor > 0:
                        for j in self._debt:
                            self._debt[j] -= floor
                    self._cond.notify_all()
            if waited_flag:
                with self._lock:
                    self._waits[job] = self._waits.get(job, 0) + 1
                try:
                    _tenant_waits_counter().labels(job=job).inc()
                except Exception:  # noqa: BLE001 - telemetry only
                    pass
        key = (charge_job or "<no-job>", tc)
        with self._lock:
            self._bytes[key] = self._bytes.get(key, 0) + int(nbytes)
        try:
            _tenant_bytes_counter().labels(job=key[0], tc=tc).inc(int(nbytes))
        except Exception:  # noqa: BLE001 - telemetry only
            pass
        return waited

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "weights": dict(self._weights),
                "debt": dict(self._debt),
                "bytes": {f"{j}/{tc}": n for (j, tc), n in
                          self._bytes.items()},
                "waits": dict(self._waits),
            }

    def bytes_sent(self, job: str, tc: str = TC_BULK) -> int:
        with self._lock:
            return self._bytes.get((job, tc), 0)

    def fairness_ratio(self, job_a: str, job_b: str) -> Optional[float]:
        """Observed bulk-bytes ratio a:b normalized by the configured
        weight ratio — 1.0 is perfectly fair, the bench gates on a
        configured floor (FEDTPU_TENANT_FAIRNESS)."""
        with self._lock:
            a = self._bytes.get((job_a, TC_BULK), 0)
            b = self._bytes.get((job_b, TC_BULK), 0)
            wa = self._weights.get(job_a, 1.0)
            wb = self._weights.get(job_b, 1.0)
        if b == 0 or wa <= 0:
            return None
        return (a / wa) / (b / wb)


class TenantResourceLedger:
    """Per-tenant usage accounting for pooled resources, with loud quota
    enforcement. Resources: ``shm_ring_bytes``, ``kv_blocks``,
    ``executor_tasks``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._usage: Dict[Tuple[str, str], int] = {}

    def _quota_for(self, job: Optional[str], resource: str) -> Optional[int]:
        if job is None:
            return None
        ctx = get_context(job)
        if ctx is None:
            return None
        cfg = ctx.tenancy
        if resource == "shm_ring_bytes":
            q = cfg.shm_ring_quota_mb
            return None if q is None else int(q) << 20
        if resource == "kv_blocks":
            return cfg.kv_block_quota
        if resource == "executor_tasks":
            return cfg.executor_quota
        return None

    def charge(self, job: Optional[str], resource: str, n: int) -> None:
        """Account ``n`` units; raises :class:`TenantQuotaExceeded` (and
        charges nothing) when the tenant's configured quota would be
        exceeded."""
        if job is None:
            job = current_job()
        key = (job or "<no-job>", resource)
        limit = self._quota_for(job, resource)
        with self._lock:
            in_use = self._usage.get(key, 0)
            if limit is not None and in_use + n > limit:
                try:
                    _tenant_quota_counter().labels(
                        job=key[0], resource=resource
                    ).inc()
                except Exception:  # noqa: BLE001 - telemetry only
                    pass
                raise TenantQuotaExceeded(job, resource, n, in_use, limit)
            self._usage[key] = in_use + n

    def release(self, job: Optional[str], resource: str, n: int) -> None:
        if job is None:
            job = current_job()
        key = (job or "<no-job>", resource)
        with self._lock:
            self._usage[key] = max(0, self._usage.get(key, 0) - n)

    def in_use(self, job: Optional[str], resource: str) -> int:
        key = (job or "<no-job>", resource)
        with self._lock:
            return self._usage.get(key, 0)

    def clear_job(self, job: Optional[str]) -> None:
        key0 = job or "<no-job>"
        with self._lock:
            for key in [k for k in self._usage if k[0] == key0]:
                self._usage.pop(key, None)


_scheduler = WeightedFairScheduler()  # fedlint: disable=global-mutable-singleton (cross-tenant arbiter, process-wide by design; reset hook: reset_qos)
_ledger = TenantResourceLedger()  # fedlint: disable=global-mutable-singleton (cross-tenant arbiter, process-wide by design; reset hook: reset_qos)


def get_scheduler() -> WeightedFairScheduler:
    return _scheduler


def get_ledger() -> TenantResourceLedger:
    return _ledger


def reset_qos() -> None:
    """Reset hook: fresh scheduler + ledger (drops all tenant debt,
    byte counters and usage accounting)."""
    global _scheduler, _ledger
    _scheduler = WeightedFairScheduler()
    _ledger = TenantResourceLedger()
