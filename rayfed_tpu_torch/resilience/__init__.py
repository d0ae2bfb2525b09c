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

"""Fault-tolerance subsystem: the pieces that make federated rounds
degrade instead of deadlock under partial failure (docs/resilience.md).

The reference engine fails *open* under partial failure — a dead peer
hangs every consumer waiting on its pushes. This package closes that gap
with four cooperating parts:

- :mod:`~rayfed_tpu_torch.resilience.retry` — the ONE retry engine
  (exponential backoff + jitter + per-send deadline budgets) that every
  transport's connect/send path runs through, replacing the three
  divergent per-transport retry loops the repo grew historically.
- :mod:`~rayfed_tpu_torch.resilience.inject` — deterministic fault injection:
  a seeded, replayable schedule of drop / delay / duplicate / corrupt /
  one-way-partition / crash faults applied at the sender-proxy seam,
  keyed by (src, dst, seq ids) so chaos runs reproduce bit-for-bit.
- :mod:`~rayfed_tpu_torch.resilience.liveness` — heartbeats multiplexed over
  the existing proxy channel (the readiness-ping frame) producing a
  per-party ALIVE / SUSPECT / DEAD membership view for the driver.
- :mod:`~rayfed_tpu_torch.resilience.degraded` — the missing-value policy
  behind ``fed.get(..., timeout=, on_missing=)``; pairs with
  :func:`rayfed_tpu_torch.ops.aggregate.elastic_weighted_mean` to re-weight
  FedAvg over surviving parties.

Driver-facing conveniences re-exported here; everything is importable
without jax (the aggregation helper lives in ``ops``).
"""

from rayfed_tpu_torch.resilience.degraded import MISSING  # noqa: F401
from rayfed_tpu_torch.resilience.inject import (  # noqa: F401
    FaultSchedule,
    InjectedFault,
    fault_trace,
)
from rayfed_tpu_torch.resilience.liveness import (  # noqa: F401
    ALIVE,
    DEAD,
    SUSPECT,
    LivenessConfig,
    get_monitor,
    liveness_view,
    party_state,
)
from rayfed_tpu_torch.resilience.retry import Deadline, RetryPolicy  # noqa: F401

__all__ = [
    "ALIVE",
    "SUSPECT",
    "DEAD",
    "Deadline",
    "FaultSchedule",
    "InjectedFault",
    "LivenessConfig",
    "MISSING",
    "RetryPolicy",
    "fault_trace",
    "get_monitor",
    "liveness_view",
    "party_state",
]
