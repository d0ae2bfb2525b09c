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

"""The privacy plane: only its config is ported so far (``config.py``
and the wire-dtype gate read it); secure aggregation, DP and quantized
pushes are ROADMAP Queue 1 item 11, and ``fed.init`` refuses a
``config["privacy"]`` block until they land.
"""

from rayfed_tpu_torch.privacy.config import (  # noqa: F401
    QUANTIZE_TIERS,
    PrivacyConfig,
    validate_wire_dtype_gate,
)

__all__ = ["PrivacyConfig", "QUANTIZE_TIERS", "validate_wire_dtype_gate"]
