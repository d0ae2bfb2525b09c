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

"""rayfed_tpu_torch: the PyTorch/CUDA port of rayfed_tpu.

The federated engine — ``init``, ``remote``, ``get``, ``kill``,
``shutdown``, ``send``, ``recv``, ``FedObject``, ``FedRemoteError`` — over
the native TCP wire, whose frames are the JAX package's, so parties of
the two packages run one job, or over the CUDA lane
(``transport="cuda"``), which places received tensors on the party's
card; FedAvg over planned topologies (federated.py: ``fed_aggregate``,
``FedAvgTrainer``; topology.py); and the accelerator half, mirroring the
JAX package's module paths (models/transformer.py, models/mlp.py,
models/cnn.py, ops/flash_attention.py, ops/aggregate.py,
parallel/train.py, data.py), with the JAX package's example programs in
examples/; and the serving plane (``serve``, ``submit_request``,
``ServeHandle``; serving/, models/decode.py, models/speculative.py):
continuous-batching inference over a slab or paged KV pool with hot model
swap, fed by ``fed_aggregate(publish_to=)``; FedBuff-style async rounds
(``async_round``, ``fed_aggregate(mode="async")``), elastic membership
with coordinator failover (``join``, ``leave``, ``membership_sync``) and
job checkpoints (``save_job_state``, ``restore_job_state``); and the
privacy plane (``config["privacy"]``, privacy/): secure aggregation
(``fed_aggregate(secure=True)`` in either mode), DP clipping and noise
with the epsilon ledger (``privacy_ledger``) and the int8 wire tier,
whose random streams are ``jax.random``'s words.
It never imports jax or rayfed_tpu. Entry points run on CUDA unless the
caller passes device="cpu"; the attention kernels are hand-written for
Hopper (csrc/) and built at first use. Planes not ported yet are absent,
and ``init`` refuses their config blocks (ROADMAP Queue 1).
"""

from rayfed_tpu_torch import tree_util  # noqa: F401  (must precede api import)
from rayfed_tpu_torch.api import (  # noqa: F401
    get,
    init,
    is_party_leader,
    join,
    kill,
    leave,
    membership_stats,
    membership_sync,
    membership_view,
    privacy_ledger,
    remote,
    shutdown,
)
from rayfed_tpu_torch.exceptions import (  # noqa: F401
    FedRemoteError,
    StaleCoordinatorError,
)
from rayfed_tpu_torch.fed_object import FedObject  # noqa: F401
from rayfed_tpu_torch.proxy.barriers import recv, send  # noqa: F401
from rayfed_tpu_torch.resilience import (  # noqa: F401
    MISSING,
    fault_trace,
    liveness_view,
    party_state,
)
from rayfed_tpu_torch.serving import (  # noqa: F401
    ServeHandle,
    serve,
    submit_request,
)
from rayfed_tpu_torch.async_rounds import (  # noqa: F401  (after api import)
    AsyncRoundHandle,
    async_handoff,
    async_rebuild,
    async_round,
)
from rayfed_tpu_torch.checkpoint import (  # noqa: F401
    restore_job_state,
    save_job_state,
)

__version__ = "0.1.0"

__all__ = [
    "init",
    "remote",
    "get",
    "kill",
    "shutdown",
    "send",
    "is_party_leader",
    "recv",
    "FedObject",
    "FedRemoteError",
    "MISSING",
    "fault_trace",
    "liveness_view",
    "party_state",
    "join",
    "leave",
    "membership_stats",
    "membership_sync",
    "membership_view",
    "privacy_ledger",
    "StaleCoordinatorError",
    "serve",
    "submit_request",
    "ServeHandle",
    "async_round",
    "async_handoff",
    "async_rebuild",
    "AsyncRoundHandle",
    "save_job_state",
    "restore_job_state",
    "__version__",
]
