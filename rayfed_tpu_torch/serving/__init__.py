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

"""Federated inference serving plane (port of ``rayfed_tpu/serving``,
docs/serving.md), on the party's card unless the caller asks for the CPU.

One party hosts the freshest aggregate and serves generate / beam /
speculative-decode requests under concurrent load while training rounds
keep landing new aggregates:

 - :mod:`rayfed_tpu_torch.serving.server` — admission control (batched paged
   prefill, chunked prefill with a per-step token budget) + continuous
   (iteration-level) batching over the KV pool;
 - :mod:`rayfed_tpu_torch.serving.kv_pool` — the KV store, two layouts:
   the contiguous slab and the block-granular paged pool (block tables,
   on-demand grants, prefix reuse by table sharing);
 - :mod:`rayfed_tpu_torch.serving.publish` — versioned atomic hot model swap,
   shm zero-copy snapshot adoption;
 - :mod:`rayfed_tpu_torch.serving.stream` — incremental token streaming over
   the inline lane;
 - :mod:`rayfed_tpu_torch.serving.client` — ``fed.serve()`` /
   ``fed.submit_request()``: requests ride the small-message inline lane,
   model swaps ride the bulk/striped lane (and replicate to standbys).
"""

from rayfed_tpu_torch.serving.client import (  # noqa: F401
    ServeHandle,
    serve,
    submit_request,
)
from rayfed_tpu_torch.serving.kv_pool import KVPool, PagedKVPool  # noqa: F401
from rayfed_tpu_torch.serving.publish import ModelBank  # noqa: F401
from rayfed_tpu_torch.serving.server import (  # noqa: F401
    InferenceServer,
    ServerOverloadedError,
    ServerStoppedError,
)
from rayfed_tpu_torch.serving.stream import (  # noqa: F401
    LocalTokenStream,
    StreamConsumerError,
    TokenStream,
)

__all__ = [
    "serve",
    "submit_request",
    "ServeHandle",
    "InferenceServer",
    "KVPool",
    "PagedKVPool",
    "ModelBank",
    "LocalTokenStream",
    "TokenStream",
    "StreamConsumerError",
    "ServerOverloadedError",
    "ServerStoppedError",
]
