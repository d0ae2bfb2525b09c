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

"""Tenancy plane: per-job :class:`FedContext`, ``JobScoped`` module
state, weighted-fair QoS and tenant quotas over shared transport.
See docs/multitenancy.md."""

from rayfed_tpu_torch.tenancy.context import (
    FedContext,
    JobScoped,
    TenancyConfig,
    TenantQuotaExceeded,
    activate,
    clear_job_everywhere,
    contexts,
    create_context,
    current_context,
    current_job,
    get_context,
    remove_context,
    reset_tenancy,
    use_context,
)
from rayfed_tpu_torch.tenancy.qos import (
    TC_BULK,
    TC_INLINE,
    TenantResourceLedger,
    WeightedFairScheduler,
    get_ledger,
    get_scheduler,
    reset_qos,
)
from rayfed_tpu_torch.tenancy.reset import (
    run_all_reset_hooks,
    verify_inventory_coverage,
)

__all__ = [
    "FedContext",
    "JobScoped",
    "TenancyConfig",
    "TenantQuotaExceeded",
    "TC_BULK",
    "TC_INLINE",
    "TenantResourceLedger",
    "WeightedFairScheduler",
    "activate",
    "clear_job_everywhere",
    "contexts",
    "create_context",
    "current_context",
    "current_job",
    "get_context",
    "get_ledger",
    "get_scheduler",
    "remove_context",
    "reset_qos",
    "reset_tenancy",
    "run_all_reset_hooks",
    "use_context",
    "verify_inventory_coverage",
]
