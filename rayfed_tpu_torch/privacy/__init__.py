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

"""The privacy plane (port of ``rayfed_tpu/privacy``), enabled through
a validated ``config["privacy"]`` block at ``fed.init``:

- ``threefry.py``: the threefry-2x32 words of ``jax.random`` and its
  float draws (``uniform``, ``normal``, ``gumbel``, ``categorical``), so
  a torch party's mask streams, noise and samples are a JAX party's;
- ``secagg.py`` + ``manager.py``: pairwise additive masks over the
  ``Z_{2^32}`` fixed-point ring, seeds exchanged over authenticated
  ``prv:`` control frames (``protocol.py``), dropout recovery driven by
  the liveness view and membership eviction. ``fed_aggregate(...,
  secure=True)`` lowers through it on the stepwise and async buffered
  paths; the same-mesh lane is ROADMAP Queue 1 item 12b.
- **Differential privacy** (``dp.py``): per-party clipping before a
  contribution leaves the party, aggregator-side Gaussian noise, and the
  per-party epsilon ledger ``fed.privacy_ledger()`` exposes.
- **Quantized pushes** (``quantize.py``): the int8 wire tier
  (``payload_wire_dtype="int8"``) and the driver-tier error-feedback
  quantizer.
"""

from rayfed_tpu_torch.privacy.config import (  # noqa: F401
    QUANTIZE_TIERS,
    PrivacyConfig,
    validate_wire_dtype_gate,
)
from rayfed_tpu_torch.privacy.dp import (  # noqa: F401
    PrivacyLedger,
    clip_tree,
    gaussian_epsilon,
    gaussian_noise_tree,
    tree_l2_norm,
)
from rayfed_tpu_torch.privacy.manager import (  # noqa: F401
    PrivacyManager,
    get_privacy_manager,
    install_privacy,
    record_quantized_bytes_saved,
    require_privacy_manager,
    uninstall_privacy,
)
from rayfed_tpu_torch.privacy.protocol import (  # noqa: F401
    PRIVACY_SEQ_PREFIX,
    RECOVER_SEQ,
    SEED_SEQ,
    is_privacy_seq_id,
)
from rayfed_tpu_torch.privacy.quantize import (  # noqa: F401
    ErrorFeedbackQuantizer,
    dequantize_leaf,
    dequantize_tree,
    quantize_leaf,
    quantize_tree,
)
from rayfed_tpu_torch.privacy.secagg import SecAggError  # noqa: F401

__all__ = [
    "PrivacyConfig",
    "QUANTIZE_TIERS",
    "validate_wire_dtype_gate",
    "PrivacyLedger",
    "clip_tree",
    "gaussian_epsilon",
    "gaussian_noise_tree",
    "tree_l2_norm",
    "PrivacyManager",
    "get_privacy_manager",
    "install_privacy",
    "record_quantized_bytes_saved",
    "require_privacy_manager",
    "uninstall_privacy",
    "PRIVACY_SEQ_PREFIX",
    "RECOVER_SEQ",
    "SEED_SEQ",
    "is_privacy_seq_id",
    "SecAggError",
    "ErrorFeedbackQuantizer",
    "dequantize_leaf",
    "dequantize_tree",
    "quantize_leaf",
    "quantize_tree",
]
