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

"""Elastic membership: parties join, leave, and get replaced mid-training.

No reference equivalent — RayFed fixes the party set at ``fed.init`` for
the life of the job. This subsystem adds an epoch-based membership plane
on top of the existing inline lane (docs/membership.md):

- a membership view ``(epoch, roster, addresses)`` owned by a
  coordinator role at the root party (:mod:`.coordinator`);
- ``fed.join()`` / ``fed.leave()`` handshakes and per-party view state
  (:mod:`.manager`);
- wire frame shapes and the reserved ``mbr:*`` seq-id namespace
  (:mod:`.protocol`).

Every epoch bump re-keys the seq-id space (epoch-prefixed seq ids so a
rejoining party cannot collide with its pre-crash ghosts parked in
``rendezvous.RendezvousStore``), purges rendezvous entries from evicted
sources, updates the liveness monitor's peer set, and flows into the
async plane (``BufferedAggregator`` drops offers stamped with
evicted-epoch ghosts).
"""

from rayfed_tpu_torch.membership.config import FailoverConfig, MembershipConfig
from rayfed_tpu_torch.membership.coordinator import MembershipCoordinator
from rayfed_tpu_torch.membership.manager import (
    MembershipManager,
    clear_membership_manager,
    get_membership_manager,
    set_membership_manager,
)
from rayfed_tpu_torch.membership.view import MembershipView

__all__ = [
    "FailoverConfig",
    "MembershipConfig",
    "MembershipCoordinator",
    "MembershipManager",
    "MembershipView",
    "clear_membership_manager",
    "get_membership_manager",
    "set_membership_manager",
]
