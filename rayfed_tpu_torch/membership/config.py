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

"""Membership-plane configuration (``config['membership']``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class FailoverConfig:
    """Coordinator-failover knobs (``config['membership']['failover']``,
    strict like the parent section; docs/ha.md).

    Attributes:
        enabled: let a non-coordinator party take over the coordinator
            role when liveness declares the current coordinator DEAD
            mid-sync. Requires a running liveness monitor — without one
            every party reads ALIVE and failover never fires.
        takeover_timeout_s: how long a member waits on the current
            coordinator's sync broadcast before consulting liveness for
            a DEAD verdict. Lower = faster failover, higher = fewer
            spurious depositions on a slow-but-alive coordinator. The
            overall ``sync_timeout_s`` still bounds the whole wait.
        resync_window: how many recent agreed sync views each party
            retains for takeover re-broadcast. A new coordinator re-sends
            these VERBATIM under its term for members trailing at older
            indices, so every sync index maps to exactly one view on
            every party even across a failover.
    """

    enabled: bool = True
    takeover_timeout_s: float = 5.0
    resync_window: int = 2

    def __post_init__(self) -> None:
        if float(self.takeover_timeout_s) <= 0:
            raise ValueError(
                f"membership.failover.takeover_timeout_s must be > 0, got "
                f"{self.takeover_timeout_s}"
            )
        if int(self.resync_window) < 1:
            raise ValueError(
                f"membership.failover.resync_window must be >= 1, got "
                f"{self.resync_window}"
            )

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "FailoverConfig":
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - field_names)
        if unknown:
            raise ValueError(
                f"unknown membership.failover config key(s) {unknown}; "
                f"known keys: {sorted(field_names)}"
            )
        return cls(**data)


@dataclasses.dataclass
class MembershipConfig:
    """Elastic-membership knobs (``config['membership']``, validated at
    ``fed.init`` so a typo'd key rejects init, not the first sync;
    docs/membership.md).

    Attributes:
        coordinator: the party owning the membership view (the
            coordinator role). None = the root party by the planner's
            convention: the lexicographically first party of the initial
            roster — identical on every driver, so every party elects
            the same coordinator without a message.
        auth_token: shared join credential. When set, a ``fed.join``
            handshake must present the identical token or the
            coordinator rejects it with code 403 — the same trust bar
            the ``cross_silo_comm`` identity config applies to data
            frames (mutual-TLS deployments get transport-level identity
            on top: a join request rides the data lane, so
            ``verify_peer_identity`` already attests its ``src``).
            None = any party that can reach the lane may join.
        evict_dead: escalate a liveness DEAD verdict at the coordinator
            to eviction at the next sync point (epoch bump, roster
            removal, rendezvous ghost purge).
        join_timeout_s: how long ``fed.join`` waits for the coordinator
            to admit it at a sync point before giving up.
        sync_timeout_s: how long a non-coordinator party waits for the
            coordinator's view broadcast at each ``fed.membership_sync``.
        bootstrap_dir: optional ``checkpoint.py`` base directory the
            coordinator serves join bootstrap state from (the latest
            ``step_<N>`` snapshot) when the driver registered no
            bootstrap provider.
        failover: nested :class:`FailoverConfig` (coordinator takeover
            on a liveness DEAD verdict; docs/ha.md).
    """

    coordinator: Optional[str] = None
    auth_token: Optional[str] = None
    evict_dead: bool = True
    join_timeout_s: float = 60.0
    sync_timeout_s: float = 60.0
    bootstrap_dir: Optional[str] = None
    failover: FailoverConfig = dataclasses.field(default_factory=FailoverConfig)

    def __post_init__(self) -> None:
        if float(self.join_timeout_s) <= 0:
            raise ValueError(
                f"membership.join_timeout_s must be > 0, got "
                f"{self.join_timeout_s}"
            )
        if float(self.sync_timeout_s) <= 0:
            raise ValueError(
                f"membership.sync_timeout_s must be > 0, got "
                f"{self.sync_timeout_s}"
            )

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "MembershipConfig":
        """Strict construction: unknown keys raise (this section is new —
        there are no reference-written dicts to stay lenient for, and a
        silently dropped ``auth_token`` typo would be an open door)."""
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - field_names)
        if unknown:
            raise ValueError(
                f"unknown membership config key(s) {unknown}; known keys: "
                f"{sorted(field_names)}"
            )
        kwargs = dict(data)
        failover = kwargs.pop("failover", None)
        if isinstance(failover, FailoverConfig):
            kwargs["failover"] = failover
        elif failover is not None:
            if not isinstance(failover, dict):
                raise ValueError(
                    "membership.failover must be a dict, got "
                    f"{type(failover).__name__}"
                )
            kwargs["failover"] = FailoverConfig.from_dict(failover)
        return cls(**kwargs)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
