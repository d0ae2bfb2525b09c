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

"""Privacy-plane wire protocol: the reserved ``prv:`` seq-id namespace.

Secure-aggregation control messages ride the ordinary data lane — the
same send/recv path, retry engine, TLS identity and job isolation as
every data frame — addressed by STRING seq ids in the reserved ``prv:``
namespace (mirroring ``mbr:`` for membership and ``tel:`` for
telemetry; see ``membership/protocol.py`` for the namespace rationale):

- ``("prv:seed", <nonce>)``: a pairwise-seed offer from the
  lexicographically smaller party of a pair to the larger one. The
  receiver's rendezvous store never parks it — it dispatches to the
  privacy manager's registered control handler, and the handler's
  verdict rides back in the frame's ack.
- ``("prv:recover", <nonce>)``: a survivor's re-offer of its pairwise
  seed with a DEAD party, sent to the aggregation root so the root can
  regenerate the dead party's orphaned mask streams and subtract them
  from a pending masked sum (dropout recovery, docs/privacy.md).

A ``prv:`` frame arriving at a party without an installed privacy
manager is refused with an explicit 403 naming the missing role, not
parked (the same contract as a join request sent to a non-coordinator).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Optional

#: Reserved control namespace for privacy-plane frames (registered in
#: ``proxy.rendezvous.CONTROL_NAMESPACES``).
PRIVACY_SEQ_PREFIX = "prv:"

SEED_SEQ = "prv:seed"
RECOVER_SEQ = "prv:recover"


def is_privacy_seq_id(seq_id: Any) -> bool:
    return isinstance(seq_id, str) and seq_id.startswith(PRIVACY_SEQ_PREFIX)


def new_nonce() -> str:
    return uuid.uuid4().hex


def make_seed_offer(
    from_party: str, to_party: str, seed: int, nonce: str
) -> Dict:
    return {
        "kind": "seed-offer",
        "from": from_party,
        "to": to_party,
        "seed": int(seed),
        "nonce": nonce,
    }


def make_recover_offer(
    from_party: str,
    dead_party: str,
    seed: int,
    nonce: str,
    round_index: Optional[int] = None,
) -> Dict:
    """A survivor's re-offer of its pairwise seed with ``dead_party`` so
    the root can reconstruct and subtract the dead party's orphaned mask
    streams. ``round_index`` scopes the recovery when given (None =
    usable for any pending round)."""
    return {
        "kind": "recover-offer",
        "from": from_party,
        "dead": dead_party,
        "seed": int(seed),
        "nonce": nonce,
        "round": None if round_index is None else int(round_index),
    }
