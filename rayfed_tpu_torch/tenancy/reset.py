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

"""The reset-hook registry: every singleton in
``tools/singleton_inventory.json`` whose module this package has ported
maps to a working reset hook here (or to an explicit process-wide
exemption with a reason). ``fed.shutdown`` drives
:func:`run_all_reset_hooks`, which imports every module the table names,
so the table lists ported modules only — the planes still to port bring
their hooks with them.

Scopes
------
``job``     — the hook clears state belonging to the job being shut
down (run inside that job's context, so ``JobScoped`` lookups resolve).
``global``  — the hook tears down genuinely process-wide machinery
(tracing buffers, the shared listeners, the cross-tenant QoS arbiter)
and therefore only runs when the *last* job exits.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: scope markers
JOB = "job"
GLOBAL = "global"


def _hook_global_context() -> None:
    from rayfed_tpu_torch._private.global_context import clear_global_context

    clear_global_context(wait_for_sending=False)


def _hook_async_sessions() -> None:
    from rayfed_tpu_torch.async_rounds import reset_sessions

    reset_sessions()


def _hook_async_default() -> None:
    from rayfed_tpu_torch.async_rounds import reset_default_async_config

    reset_default_async_config()


def _hook_checkpoint() -> None:
    from rayfed_tpu_torch.checkpoint import reset_default_checkpoint_config

    reset_default_checkpoint_config()


def _hook_membership() -> None:
    from rayfed_tpu_torch.membership.manager import clear_membership_manager

    clear_membership_manager()


def _hook_privacy() -> None:
    from rayfed_tpu_torch.privacy.manager import uninstall_privacy

    uninstall_privacy()


def _hook_federated() -> None:
    from rayfed_tpu_torch.federated import _reset_secure_rounds

    _reset_secure_rounds()


def _hook_kv() -> None:
    from rayfed_tpu_torch._private.kv import kv_reset

    kv_reset()


def _hook_config() -> None:
    from rayfed_tpu_torch.config import reset_config_cache

    reset_config_cache()


def _hook_barriers() -> None:
    from rayfed_tpu_torch.proxy import barriers
    from rayfed_tpu_torch.tenancy.context import current_job

    barriers.stop_proxies(current_job())
    barriers.clear_seq_epoch_fn()


def _hook_rendezvous() -> None:
    from rayfed_tpu_torch.proxy.rendezvous import (
        clear_control_handler,
        clear_evicted_fn,
    )
    from rayfed_tpu_torch.tenancy.context import current_job

    job = current_job()
    if job is not None:
        clear_control_handler(job)
        clear_evicted_fn(job)


def _hook_dma() -> None:
    from rayfed_tpu_torch.proxy.cuda import dma

    dma.reset()


def _hook_inject() -> None:
    from rayfed_tpu_torch.resilience.inject import reset_wire_taints, uninstall

    uninstall()
    reset_wire_taints()


def _hook_liveness() -> None:
    from rayfed_tpu_torch.resilience.liveness import stop_monitor

    stop_monitor()


def _hook_linkhealth() -> None:
    from rayfed_tpu_torch.resilience.linkhealth import reset_health

    reset_health()


def _hook_sanitize() -> None:
    from rayfed_tpu_torch import sanitize

    sanitize.reset()


def _hook_metrics() -> None:
    # Zero in place rather than swapping the registry object: counters
    # registered at import time across the codebase hold direct child
    # references, and a swap would silently detach every one of them
    # for the rest of the process.
    from rayfed_tpu_torch.telemetry.metrics import zero_registry

    zero_registry()


def _hook_topology() -> None:
    from rayfed_tpu_torch.topology import reset_default

    reset_default()


def _hook_mesh() -> None:
    from rayfed_tpu_torch.mesh import clear_party_device

    clear_party_device()


def _hook_tracing() -> None:
    from rayfed_tpu_torch import tracing

    tracing.clear()


def _hook_tcp_listeners() -> None:
    from rayfed_tpu_torch.proxy.tcp.tcp_proxy import reset_shared_listeners

    reset_shared_listeners()


def _hook_qos() -> None:
    from rayfed_tpu_torch.tenancy.context import current_job
    from rayfed_tpu_torch.tenancy.qos import get_ledger, get_scheduler

    job = current_job()
    if job is not None:
        get_scheduler().unregister(job)
        get_ledger().clear_job(job)


def _hook_telemetry() -> None:
    from rayfed_tpu_torch import telemetry

    telemetry.stop(flush=False)


def _hook_serving_client() -> None:
    from rayfed_tpu_torch.serving.client import set_default_serving_config

    set_default_serving_config(None)


def _hook_serving_server() -> None:
    from rayfed_tpu_torch.serving.server import stop_all_servers

    stop_all_servers()


def _hook_qos_global() -> None:
    from rayfed_tpu_torch.tenancy.qos import reset_qos

    reset_qos()


def _hook_tenancy_registry() -> None:
    from rayfed_tpu_torch.tenancy.context import clear_job_everywhere, current_job

    clear_job_everywhere(current_job())


#: module -> list of (hook, scope). Every non-lock singleton in the
#: inventory must resolve through this table (or PROCESS_WIDE below).
#: Order within the table is the shutdown order: transport first, then
#: planes, then caches, then process-wide machinery.
RESET_HOOKS: Dict[str, List[Tuple[Callable[[], None], str]]] = {
    "rayfed_tpu_torch.resilience.liveness": [(_hook_liveness, JOB)],
    "rayfed_tpu_torch.resilience.inject": [(_hook_inject, JOB)],
    "rayfed_tpu_torch.resilience.linkhealth": [(_hook_linkhealth, JOB)],
    "rayfed_tpu_torch.membership.manager": [(_hook_membership, JOB)],
    "rayfed_tpu_torch.privacy.manager": [(_hook_privacy, JOB)],
    "rayfed_tpu_torch.serving.server": [(_hook_serving_server, JOB)],
    "rayfed_tpu_torch.serving.client": [(_hook_serving_client, JOB)],
    "rayfed_tpu_torch.telemetry": [(_hook_telemetry, JOB)],
    "rayfed_tpu_torch.topology": [(_hook_topology, JOB)],
    "rayfed_tpu_torch.async_rounds": [
        (_hook_async_sessions, JOB),
        (_hook_async_default, JOB),
    ],
    "rayfed_tpu_torch.checkpoint": [(_hook_checkpoint, JOB)],
    "rayfed_tpu_torch.federated": [(_hook_federated, JOB)],
    "rayfed_tpu_torch.proxy.barriers": [(_hook_barriers, JOB)],
    "rayfed_tpu_torch.proxy.rendezvous": [(_hook_rendezvous, JOB)],
    "rayfed_tpu_torch._private.kv": [(_hook_kv, JOB)],
    "rayfed_tpu_torch._private.global_context": [(_hook_global_context, JOB)],
    "rayfed_tpu_torch.config": [(_hook_config, JOB)],
    "rayfed_tpu_torch.sanitize": [(_hook_sanitize, JOB)],
    # The metrics registry is process-wide by contract: import-time
    # counters across the codebase hold direct child references, and
    # tenant separation rides the fed_tenant_*{job=...} label dimension.
    # Swapping it per-job would silently orphan a live co-tenant's
    # series, so it only resets with the last job.
    "rayfed_tpu_torch.telemetry.metrics": [(_hook_metrics, GLOBAL)],
    "rayfed_tpu_torch.tenancy.qos": [
        (_hook_qos, JOB),
        (_hook_qos_global, GLOBAL),
    ],
    "rayfed_tpu_torch.tenancy.context": [(_hook_tenancy_registry, JOB)],
    "rayfed_tpu_torch.proxy.tcp.tcp_proxy": [(_hook_tcp_listeners, GLOBAL)],
    "rayfed_tpu_torch.mesh": [(_hook_mesh, GLOBAL)],
    "rayfed_tpu_torch.proxy.cuda.dma": [(_hook_dma, GLOBAL)],
    "rayfed_tpu_torch.tracing": [(_hook_tracing, GLOBAL)],
}

#: (module, name) -> reason. Singletons that deliberately survive job
#: shutdown; every entry must justify itself.
PROCESS_WIDE: Dict[Tuple[str, str], str] = {
    ("rayfed_tpu_torch.proxy.tcp.checksum", "_warned_algs"): (
        "log-once latch for unsupported checksum algorithms; carries no "
        "job state, resetting would only re-spam the log"
    ),
    ("rayfed_tpu_torch.proxy.tcp.reactor", "_pool"): (
        "refcounted shared reactor pool; drained when the last "
        "sender/receiver proxy releases it via stop_proxies"
    ),
    ("rayfed_tpu_torch.proxy.tcp.reactor", "_pool_refs"): (
        "refcount for the shared reactor pool (see _pool)"
    ),
}


def inventory_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
    return os.path.join(here, "tools", "singleton_inventory.json")


def load_inventory(path: Optional[str] = None) -> List[Dict]:
    with open(path or inventory_path(), "r", encoding="utf-8") as f:
        return json.load(f)["singletons"]


def _ported(module: str) -> Optional[str]:
    """This package's name for an inventory module of the JAX package, or
    None when this package has no such module yet. The TPU transport's
    modules (``proxy/tpu``) are the CUDA transport's (``proxy/cuda``)."""
    import importlib.util

    name = "rayfed_tpu_torch" + module[len("rayfed_tpu"):]
    name = name.replace(".proxy.tpu.", ".proxy.cuda.", 1)
    try:
        return name if importlib.util.find_spec(name) is not None else None
    except ImportError:
        return None


def verify_inventory_coverage(
    path: Optional[str] = None,
) -> List[str]:
    """Return a list of human-readable gaps: inventory singletons of a
    ported module with neither a reset hook nor a process-wide
    exemption. Empty == green."""
    gaps: List[str] = []
    for entry in load_inventory(path):
        kind, name = entry["kind"], entry["name"]
        module = _ported(entry["module"])
        if kind == "lock" or module is None:
            continue  # locks guard state; unported planes bring hooks later
        if (module, name) in PROCESS_WIDE:
            continue
        hooks = RESET_HOOKS.get(module)
        if not hooks:
            gaps.append(
                f"{module}.{name} ({kind}): no reset hook registered in "
                "rayfed_tpu_torch.tenancy.reset.RESET_HOOKS and no PROCESS_WIDE "
                "exemption"
            )
            continue
        for hook, _scope in hooks:
            if not callable(hook):
                gaps.append(f"{module}.{name}: hook {hook!r} not callable")
    return gaps


def run_all_reset_hooks(
    job: Optional[str] = None, *, last: bool = True
) -> List[str]:
    """Run every registered reset hook for ``job`` (inside its context,
    so JobScoped state resolves); ``global``-scope hooks only run when
    ``last`` (no other live tenants — tearing down shared machinery
    under a live neighbor is exactly the cross-talk this plane exists
    to prevent). Hooks never raise out; failures are returned (and
    logged) so shutdown always completes."""
    from rayfed_tpu_torch.tenancy.context import get_context, use_context

    failures: List[str] = []

    def _run_table() -> None:
        for module, hooks in RESET_HOOKS.items():
            for hook, scope in hooks:
                if scope == GLOBAL and not last:
                    continue
                try:
                    hook()
                except Exception as e:  # noqa: BLE001 - shutdown must finish
                    failures.append(f"{module}: {hook.__name__}: {e!r}")
                    logger.warning(
                        "reset hook %s for %s failed: %s",
                        hook.__name__, module, e,
                    )

    ctx = get_context(job) if job is not None else None
    if ctx is not None:
        with use_context(ctx):
            _run_table()
    else:
        _run_table()
    return failures
