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

"""Telemetry: the process-wide metrics registry (``metrics``).

The per-party agent and the collector of the JAX package's telemetry
plane are not ported yet (ROADMAP Queue 1 item 18); ``fed.init`` refuses
a ``config["telemetry"]`` block until they are.
"""

from rayfed_tpu_torch.telemetry import metrics  # noqa: F401 - re-export

__all__ = ["metrics"]
