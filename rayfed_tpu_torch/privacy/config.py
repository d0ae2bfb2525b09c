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

"""Privacy-plane job configuration (``config["privacy"]``; port of
``rayfed_tpu/privacy/config.py``).

Validated EAGERLY at ``fed.init`` with STRICT key checking — an unknown
``privacy.*`` key rejects init with the known-key list, matching the
``aggregation.async_*`` / membership precedent (a typo'd knob must fail
the job at startup, not silently run without its protection).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

#: Quantization tiers the privacy plane understands.
QUANTIZE_TIERS = ("int8",)


@dataclasses.dataclass
class PrivacyConfig:
    """Knobs for the privacy plane (docs/privacy.md).

    Attributes:
        secure_aggregation: enable pairwise-mask secure aggregation;
            ``fed_aggregate(secure=True)`` requires it (and fedlint
            FED006 flags insecure aggregates once it is on).
        mask_seed: deterministic base for pairwise seed generation
            (tests / reproducible runs). None (default) draws pairwise
            seeds from the OS entropy pool.
        fixedpoint_bits: fractional bits of the Z_2^32 fixed-point
            encoding secure aggregation masks in (higher = finer grain,
            less headroom; see secagg.encode_tree's overflow bound).
        handshake_timeout_s: how long a masking party waits for a
            partner's ``prv:seed`` frame before failing the round.
        clip_norm: per-party L2 clipping bound applied before a secure
            contribution leaves the party (required when
            ``noise_multiplier`` is set — it is the DP sensitivity).
        noise_multiplier: Gaussian noise stddev as a multiple of
            ``clip_norm / n`` added to the aggregate at the root
            (None/0 = no noise, ledger stays empty).
        delta: the DP delta the ledger accounts epsilon at.
        noise_seed: PRNG seed for the root's noise stream.
        quantize: int8 wire/driver quantization tier (None = off). Must
            be enabled for ``payload_wire_dtype="int8"``.
        error_feedback: carry per-party quantization residuals into the
            next round (driver tier; see privacy/quantize.py).
    """

    secure_aggregation: bool = False
    mask_seed: Optional[int] = None
    fixedpoint_bits: int = 16
    handshake_timeout_s: float = 20.0
    clip_norm: Optional[float] = None
    noise_multiplier: Optional[float] = None
    delta: float = 1e-5
    noise_seed: int = 0
    quantize: Optional[str] = None
    error_feedback: bool = True

    def __post_init__(self):
        if not (1 <= int(self.fixedpoint_bits) <= 30):
            raise ValueError(
                f"privacy.fixedpoint_bits must be in [1, 30], "
                f"got {self.fixedpoint_bits}"
            )
        self.fixedpoint_bits = int(self.fixedpoint_bits)
        if float(self.handshake_timeout_s) <= 0:
            raise ValueError(
                f"privacy.handshake_timeout_s must be > 0, "
                f"got {self.handshake_timeout_s}"
            )
        if self.clip_norm is not None and float(self.clip_norm) <= 0:
            raise ValueError(
                f"privacy.clip_norm must be > 0 or None, "
                f"got {self.clip_norm}"
            )
        if self.noise_multiplier is not None:
            if float(self.noise_multiplier) < 0:
                raise ValueError(
                    f"privacy.noise_multiplier must be >= 0, "
                    f"got {self.noise_multiplier}"
                )
            if float(self.noise_multiplier) > 0 and self.clip_norm is None:
                raise ValueError(
                    "privacy.noise_multiplier needs privacy.clip_norm: "
                    "the clipping bound IS the DP sensitivity the noise "
                    "is calibrated against"
                )
        if not (0.0 < float(self.delta) < 1.0):
            raise ValueError(
                f"privacy.delta must be in (0, 1), got {self.delta}"
            )
        if self.quantize is not None and self.quantize not in QUANTIZE_TIERS:
            raise ValueError(
                f"privacy.quantize must be one of {QUANTIZE_TIERS} or "
                f"None, got {self.quantize!r}"
            )

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "PrivacyConfig":
        """STRICT build from ``config['privacy']``: unknown keys raise
        with the known-key list (typo rejects init)."""
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        for key in data:
            if key not in field_names:
                raise ValueError(
                    f"unknown privacy config key {key!r}; known keys: "
                    f"{sorted(field_names)}"
                )
        return cls(**data)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def validate_wire_dtype_gate(
    payload_wire_dtype: Optional[str], privacy_dict: Optional[Dict[str, Any]]
) -> None:
    """The int8 wire tier is privacy-plane machinery: reject
    ``payload_wire_dtype="int8"`` unless ``privacy.quantize = "int8"``
    is enabled, naming the knob (satellite contract; the bf16/fp16
    tiers stay privacy-free)."""
    if payload_wire_dtype not in ("int8",):
        return
    quantize = (privacy_dict or {}).get("quantize")
    if quantize != "int8":
        raise ValueError(
            'payload_wire_dtype="int8" requires the privacy plane\'s '
            'quantization tier: set config["privacy"]["quantize"] = '
            '"int8" (the int8 wire cast ships per-leaf scale metadata '
            "and is part of the quantized-push contract, "
            "docs/privacy.md)"
        )
