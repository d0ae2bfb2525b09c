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

"""The privacy plane (port of ``rayfed_tpu/privacy``), its secure
aggregation half, enabled through a validated ``config["privacy"]`` block
at ``fed.init``:

- ``threefry.py``: the threefry-2x32 words of ``jax.random``, so a torch
  party's mask streams are a JAX party's;
- ``secagg.py`` + ``manager.py``: pairwise additive masks over the
  ``Z_{2^32}`` fixed-point ring, seeds exchanged over authenticated
  ``prv:`` control frames (``protocol.py``), dropout recovery driven by
  the liveness view and membership eviction. ``fed_aggregate(...,
  secure=True)`` lowers through it on the stepwise and async buffered
  paths; the same-mesh lane is ROADMAP Queue 1 item 12.

Differential privacy (clipping, noise, the ledger, ``fed.privacy_ledger``)
and the int8 quantized pushes are ROADMAP Queue 1 item 11b:
``PrivacyConfig`` refuses their keys.
"""

from rayfed_tpu_torch.privacy.config import (  # noqa: F401
    QUANTIZE_TIERS,
    PrivacyConfig,
    validate_wire_dtype_gate,
)
from rayfed_tpu_torch.privacy.manager import (  # noqa: F401
    PrivacyManager,
    get_privacy_manager,
    install_privacy,
    require_privacy_manager,
    uninstall_privacy,
)
from rayfed_tpu_torch.privacy.protocol import (  # noqa: F401
    PRIVACY_SEQ_PREFIX,
    RECOVER_SEQ,
    SEED_SEQ,
    is_privacy_seq_id,
)
from rayfed_tpu_torch.privacy.secagg import SecAggError  # noqa: F401

__all__ = [
    "PrivacyConfig",
    "QUANTIZE_TIERS",
    "validate_wire_dtype_gate",
    "PrivacyManager",
    "get_privacy_manager",
    "install_privacy",
    "require_privacy_manager",
    "uninstall_privacy",
    "PRIVACY_SEQ_PREFIX",
    "RECOVER_SEQ",
    "SEED_SEQ",
    "is_privacy_seq_id",
    "SecAggError",
]
