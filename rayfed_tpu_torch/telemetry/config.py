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

"""Validated configuration for the telemetry plane.

Wired from ``fed.init(config={"telemetry": {...}})``.  Unknown keys
raise at init time, matching the membership/resilience config style.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class TelemetryConfig:
    # Party that hosts the collector; None = lexicographically first
    # party in the cluster (same convention as the membership
    # coordinator default).
    collector: Optional[str] = None
    # Agent push cadence.  Small intervals are fine: a push is a
    # sub-64KB delta riding the inline small-message lane.
    push_interval_ms: int = 1000
    # A party with no accepted push for this long is marked stale in
    # the fleet view.  None = 3x push_interval_ms.
    stale_after_ms: Optional[int] = None
    # Localhost HTTP endpoint on the collector party. None disables;
    # 0 binds an ephemeral port (reported in fed.telemetry_snapshot()).
    http_port: Optional[int] = None
    http_host: str = "127.0.0.1"
    # Max tracing spans shipped per push (newest win; the rest wait
    # for the next tick).
    span_batch: int = 256
    # Turn the tracing span ring on so cross-party trace correlation
    # has data. Set False to push metrics only.
    enable_tracing: bool = True

    def __post_init__(self) -> None:
        if self.push_interval_ms < 10:
            raise ValueError("telemetry.push_interval_ms must be >= 10")
        if self.stale_after_ms is not None and self.stale_after_ms <= 0:
            raise ValueError("telemetry.stale_after_ms must be positive")
        if self.span_batch < 0:
            raise ValueError("telemetry.span_batch must be >= 0")
        if self.http_port is not None and not (0 <= int(self.http_port) <= 65535):
            raise ValueError("telemetry.http_port out of range")

    @property
    def stale_after_s(self) -> float:
        ms = self.stale_after_ms
        if ms is None:
            ms = 3 * self.push_interval_ms
        return ms / 1000.0

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetryConfig":
        if not isinstance(d, dict):
            raise TypeError(
                f"config['telemetry'] must be a dict, got {type(d).__name__}"
            )
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown telemetry config keys: {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(**d)
