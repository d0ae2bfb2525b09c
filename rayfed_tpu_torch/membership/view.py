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

"""The membership view: ``(epoch, roster, addresses)``.

The view is the one piece of state every party must agree on for the
multi-controller contract to survive churn: the roster decides which
parties a ``fed.get`` broadcast fans out to and which contributions an
aggregation plan folds, and the epoch namespaces the seq-id space so
traffic from a pre-bump incarnation of a party can never collide with
its post-rejoin self. Views are immutable; an epoch bump produces a new
one (``with_changes``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class MembershipView:
    """One agreed membership state.

    Attributes:
        epoch: monotonically increasing; bumped exactly when the roster
            changes (join, leave, eviction — possibly several folded
            into one bump at a sync point).
        roster: sorted party names currently in the job.
        addresses: ``{party: "host:port"}`` for every roster party.
    """

    epoch: int
    roster: Tuple[str, ...]
    addresses: Dict[str, str]

    def __post_init__(self) -> None:
        object.__setattr__(self, "roster", tuple(sorted(self.roster)))
        missing = [p for p in self.roster if p not in self.addresses]
        if missing:
            raise ValueError(
                f"membership view has roster parties without addresses: "
                f"{missing}"
            )

    def with_changes(
        self,
        add: Mapping[str, str] = (),
        remove: Iterable[str] = (),
        *,
        force_bump: bool = False,
    ) -> "MembershipView":
        """The successor view: ``add`` maps joining parties to their
        addresses, ``remove`` names leaving/evicted parties. Returns
        ``self`` unchanged (same epoch) when nothing actually changes —
        unless ``force_bump``, which bumps the epoch even for an
        identical roster (a crashed party rejoining under its own name
        at its old address must still re-key the seq-id space and purge
        its pre-crash ghosts)."""
        add = dict(add)
        remove = set(remove)
        roster = (set(self.roster) - remove) | set(add)
        addresses = {
            p: a for p, a in self.addresses.items() if p not in remove
        }
        addresses.update(add)
        if (
            not force_bump
            and tuple(sorted(roster)) == self.roster
            and addresses == dict(self.addresses)
        ):
            return self
        return MembershipView(
            epoch=self.epoch + 1,
            roster=tuple(sorted(roster)),
            addresses=addresses,
        )

    # -- wire form (msgpack-clean plain dict) --------------------------
    def to_wire(self) -> Dict:
        return {
            "epoch": int(self.epoch),
            "roster": list(self.roster),
            "addresses": dict(self.addresses),
        }

    @classmethod
    def from_wire(cls, data: Mapping) -> "MembershipView":
        return cls(
            epoch=int(data["epoch"]),
            roster=tuple(data["roster"]),
            addresses=dict(data["addresses"]),
        )
