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

"""The tenancy plane's core: per-job :class:`FedContext` handles and the
resolution machinery that lets two or more ``fed.init`` jobs coexist in
one process with zero cross-talk (docs/multitenancy.md).

Design:

- ``fed.init`` creates one :class:`FedContext` per job and *activates*
  it on the calling thread via a :mod:`contextvars` variable. Driver
  code — and everything it transitively calls on the same thread — then
  resolves its job through :func:`current_job`.
- Python threads do **not** inherit contextvars, so background threads
  (reactor loops, cleanup drains, executor workers) resolve through the
  fallback chain: contextvar -> the only registered context (the
  single-job common case) -> the *ambient* context (the most recently
  activated one). A process running two concurrent jobs must therefore
  bind worker threads explicitly (:func:`use_context`, or
  ``contextvars.copy_context()`` at submit time — the executor does this
  automatically) for state that is resolved per-thread; the data plane
  itself routes by the frame-header job id and needs no thread binding.
- :class:`JobScoped` is the mechanical replacement for a module-global
  singleton: one slot per job (plus a slot for context-free processes),
  every instance registered so ``fed.shutdown`` can sweep a job's slots
  across all planes at once.

This module is deliberately dependency-free (stdlib only): every plane
imports it, including ``_private.global_context`` at the bottom of the
stack.
"""

from __future__ import annotations

import contextvars
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional


class TenantQuotaExceeded(RuntimeError):
    """A tenant asked for more of a pooled resource than its configured
    quota allows (``config["tenancy"]`` — docs/multitenancy.md). Loud by
    design: silently degrading a tenant hides the misconfiguration."""

    def __init__(self, job: Optional[str], resource: str, requested: int,
                 in_use: int, limit: int) -> None:
        self.job = job
        self.resource = resource
        self.requested = int(requested)
        self.in_use = int(in_use)
        self.limit = int(limit)
        super().__init__(
            f"tenant {job!r} exceeded its {resource} quota: "
            f"requested {requested} with {in_use} in use, limit {limit} "
            f"(raise config['tenancy'] quotas or reduce concurrency)"
        )


@dataclasses.dataclass
class TenancyConfig:
    """Per-job tenancy knobs (``config["tenancy"]``, validated strictly
    at ``fed.init`` — a typo'd key rejects init, docs/multitenancy.md).

    Attributes:
        weight: this job's weighted-fair share of shared transport
            bandwidth relative to other jobs in the process (QoS). A job
            with weight 4 gets ~4x the bulk bytes of a weight-1 job when
            both have backlog; inline (small/serving) traffic is never
            gated.
        fair_window_mb: the scheduler's fairness granularity — how many
            weight-normalized megabytes a tenant may run ahead of the
            most-starved backlogged tenant before its bulk pushes wait.
        max_wait_ms: hard bound on how long one bulk push may be held by
            the fairness gate (the gate throttles, it never wedges).
        shm_ring_quota_mb: cap on this tenant's in-flight shm ring bytes
            across all peers (None = unlimited). Exceeding it raises
            :class:`TenantQuotaExceeded` on the offending send.
        kv_block_quota: cap on serving KV-cache slots (decode rows)
            across this tenant's inference servers (None = unlimited).
        executor_quota: cap on concurrently in-flight tasks in this
            tenant's executor pool (None = unlimited).
    """

    weight: float = 1.0
    fair_window_mb: int = 8
    max_wait_ms: int = 2000
    shm_ring_quota_mb: Optional[int] = None
    kv_block_quota: Optional[int] = None
    executor_quota: Optional[int] = None

    def __post_init__(self):
        if not (float(self.weight) > 0):
            raise ValueError(
                f"tenancy.weight must be > 0, got {self.weight}"
            )
        if int(self.fair_window_mb) < 1:
            raise ValueError(
                f"tenancy.fair_window_mb must be >= 1, "
                f"got {self.fair_window_mb}"
            )
        if int(self.max_wait_ms) < 0:
            raise ValueError(
                f"tenancy.max_wait_ms must be >= 0, got {self.max_wait_ms}"
            )
        for field in ("shm_ring_quota_mb", "kv_block_quota",
                      "executor_quota"):
            v = getattr(self, field)
            if v is not None and int(v) < 0:
                raise ValueError(
                    f"tenancy.{field} must be >= 0 or None, got {v}"
                )

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "TenancyConfig":
        """STRICT construction: an unknown key rejects init — a typo'd
        quota must not silently leave the tenant unbounded (same contract
        as the privacy plane's config)."""
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - field_names)
        if unknown:
            raise ValueError(
                f"unknown tenancy config keys {unknown}; "
                f"known keys: {sorted(field_names)}"
            )
        return cls(**data)


class FedContext:
    """Everything one ``fed.init`` job owns in this process.

    The planes' per-job state lives in :class:`JobScoped` slots keyed by
    this context's ``job_name``; the context object itself carries the
    identity (job, party), the tenancy config, and an open slot table
    (``slot``) for plane handles that want an explicit home instead of a
    module-level ``JobScoped``."""

    def __init__(self, job_name: str, party: str,
                 tenancy: Optional[TenancyConfig] = None) -> None:
        self.job_name = job_name
        self.party = party
        self.tenancy = tenancy or TenancyConfig()
        self._slots: Dict[str, Any] = {}
        self._slots_lock = threading.Lock()
        self._closed = False

    def slot(self, key: str, factory: Optional[Callable[[], Any]] = None):
        """Get (or lazily create) a named per-job slot."""
        with self._slots_lock:
            if key in self._slots:
                return self._slots[key]
            if factory is None:
                return None
            value = factory()
            self._slots[key] = value
            return value

    def set_slot(self, key: str, value: Any) -> None:
        with self._slots_lock:
            self._slots[key] = value

    def pop_slot(self, key: str, default: Any = None) -> Any:
        with self._slots_lock:
            return self._slots.pop(key, default)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        with self._slots_lock:
            self._slots.clear()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"FedContext(job={self.job_name!r}, party={self.party!r}, "
            f"weight={self.tenancy.weight})"
        )


# -- registry + resolution ---------------------------------------------------

_registry: Dict[str, FedContext] = {}  # fedlint: disable=global-mutable-singleton (THE tenancy registry itself; remove_context/reset_tenancy() clear it at shutdown)
_registry_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the tenancy registry; reset_tenancy() is the reset hook)
_current: "contextvars.ContextVar[Optional[FedContext]]" = (
    contextvars.ContextVar("fedtpu_context", default=None)
)
# Most recently activated context (ambient fallback for threads created
# before/outside any contextvar binding). A weakref so a forgotten
# deactivate cannot keep a closed job's state alive.
_ambient: "Optional[weakref.ReferenceType[FedContext]]" = None  # fedlint: disable=global-mutable-singleton (ambient-context fallback pointer; cleared by remove_context/reset_tenancy at shutdown)


def create_context(job_name: str, party: str,
                   tenancy: Optional[TenancyConfig] = None) -> FedContext:
    """Create + register the job's context. Re-initializing a live job
    returns the existing context (idempotent ``fed.init``, matching the
    global-context contract)."""
    with _registry_lock:
        ctx = _registry.get(job_name)
        if ctx is not None:
            return ctx
        ctx = FedContext(job_name, party, tenancy)
        _registry[job_name] = ctx
        return ctx


def get_context(job_name: str) -> Optional[FedContext]:
    with _registry_lock:
        return _registry.get(job_name)


def contexts() -> List[FedContext]:
    with _registry_lock:
        return list(_registry.values())


def remove_context(job_name: str) -> Optional[FedContext]:
    """Unregister + close the job's context (``fed.shutdown``'s final
    step). Clears the contextvar/ambient pointers when they referenced
    the removed job."""
    global _ambient
    with _registry_lock:
        ctx = _registry.pop(job_name, None)
    if ctx is None:
        return None
    if _current.get() is ctx:
        _current.set(None)
    with _registry_lock:
        if _ambient is not None and _ambient() is ctx:
            _ambient = None
    ctx.close()
    return ctx


def activate(ctx: FedContext) -> None:
    """Bind ``ctx`` to the calling thread (contextvar) and install it as
    the process's ambient fallback."""
    global _ambient
    _current.set(ctx)
    with _registry_lock:
        _ambient = weakref.ref(ctx)


def current_context(required: bool = False) -> Optional[FedContext]:
    """Resolve the calling thread's FedContext.

    Order: the thread's contextvar binding; else, when exactly one job is
    registered, that job (threads never inherit contextvars, so this is
    what makes the single-job process work unchanged); else the ambient
    (most recently activated) context. With several concurrent jobs an
    unbound thread resolving through the ambient fallback is a
    *programming* smell — bind explicitly via :func:`use_context` — but
    the data plane never depends on it (frames route by header job id).
    """
    ctx = _current.get()
    if ctx is not None and not ctx.closed:
        return ctx
    with _registry_lock:
        if len(_registry) == 1:
            return next(iter(_registry.values()))
        amb = _ambient() if _ambient is not None else None
    if amb is not None and not amb.closed and get_context(amb.job_name) is amb:
        return amb
    if required:
        raise RuntimeError(
            "no FedContext is active on this thread and the process has "
            f"{len(_registry)} registered jobs — call fed.init(), or bind "
            "one explicitly with rayfed_tpu_torch.tenancy.use_context(job)"
        )
    return None


def current_job() -> Optional[str]:
    ctx = current_context()
    return None if ctx is None else ctx.job_name


class use_context:
    """Context manager binding a job's FedContext to the current thread:

        with tenancy.use_context("job_b"):
            fed.get(handle)   # resolves job_b's runtime

    Accepts a job name or a FedContext. Restores the previous binding on
    exit."""

    def __init__(self, job_or_ctx) -> None:
        if isinstance(job_or_ctx, FedContext):
            self._ctx = job_or_ctx
        else:
            ctx = get_context(str(job_or_ctx))
            if ctx is None:
                raise KeyError(
                    f"no registered FedContext for job {job_or_ctx!r} "
                    f"(registered: {sorted(_registry)})"
                )
            self._ctx = ctx
        self._token = None

    def __enter__(self) -> FedContext:
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None


# -- JobScoped: the module-global replacement --------------------------------

#: sentinel slot for processes that never called fed.init (plane unit
#: tests, tooling) — context-free callers share one stable slot.
_NO_JOB = "<no-job>"


class JobScoped:
    """One slot per job, replacing a module-global mutable singleton.

    ``get()/set()/pop()`` key by the resolved current job (or an explicit
    ``job=``); context-free processes fall back to a stable default slot,
    which keeps plane code working unchanged outside ``fed.init``. Every
    instance self-registers so :func:`clear_job_everywhere` can sweep a
    job's slots across all planes at ``fed.shutdown`` — the structural
    fix for the "forgot a reset hook" leak class FED008 polices."""

    _instances: "weakref.WeakSet[JobScoped]" = weakref.WeakSet()
    _instances_lock = threading.Lock()

    def __init__(self, name: str,
                 default_factory: Optional[Callable[[], Any]] = None) -> None:
        self._name = name
        self._default_factory = default_factory
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()
        with JobScoped._instances_lock:
            JobScoped._instances.add(self)

    def _key(self, job: Optional[str]) -> str:
        if job is not None:
            return job
        resolved = current_job()
        return _NO_JOB if resolved is None else resolved

    def get(self, job: Optional[str] = None, default: Any = None) -> Any:
        key = self._key(job)
        with self._lock:
            if key in self._values:
                return self._values[key]
            if self._default_factory is not None:
                value = self._default_factory()
                self._values[key] = value
                return value
            return default

    def peek(self, job: Optional[str] = None, default: Any = None) -> Any:
        """get() without materializing the default factory."""
        with self._lock:
            return self._values.get(self._key(job), default)

    def set(self, value: Any, job: Optional[str] = None) -> None:
        with self._lock:
            self._values[self._key(job)] = value

    def pop(self, job: Optional[str] = None, default: Any = None) -> Any:
        with self._lock:
            return self._values.pop(self._key(job), default)

    def setdefault(self, value_factory: Callable[[], Any],
                   job: Optional[str] = None) -> Any:
        key = self._key(job)
        with self._lock:
            if key not in self._values:
                self._values[key] = value_factory()
            return self._values[key]

    def clear_job(self, job: Optional[str] = None) -> Any:
        """Drop the job's slot (returns it for ordered teardown)."""
        return self.pop(job=job)

    def clear_all(self) -> None:
        with self._lock:
            self._values.clear()

    def jobs(self) -> List[str]:
        with self._lock:
            return list(self._values)

    def items(self) -> List:
        with self._lock:
            return list(self._values.items())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"JobScoped({self._name!r}, jobs={self.jobs()})"


def clear_job_everywhere(job: Optional[str]) -> int:
    """Sweep ``job``'s slot out of every JobScoped in the process (the
    shutdown backstop behind the ordered plane teardowns). Also sweeps
    the context-free default slot when ``job`` is None. Returns slots
    cleared."""
    n = 0
    with JobScoped._instances_lock:
        instances = list(JobScoped._instances)
    sentinel = object()
    for inst in instances:
        if inst.pop(job=job, default=sentinel) is not sentinel:
            n += 1
    return n


def reset_tenancy() -> None:
    """Test/teardown hook: drop every context and every JobScoped slot
    (the whole tenancy plane back to import-time state)."""
    global _ambient
    with _registry_lock:
        ctxs = list(_registry.values())
        _registry.clear()
        _ambient = None
    _current.set(None)
    for ctx in ctxs:
        ctx.close()
    with JobScoped._instances_lock:
        instances = list(JobScoped._instances)
    for inst in instances:
        inst.clear_all()
