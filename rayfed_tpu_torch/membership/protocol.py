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

"""Membership wire protocol: reserved seq-id namespace and frame shapes.

Membership messages ride the ordinary data lane — the same send/recv
path, retry engine, TLS identity and job isolation as every data frame —
addressed by STRING seq ids in the reserved ``mbr:`` namespace (internal
data seq ids are monotonic integers, optionally epoch-prefixed
``e<epoch>:<n>``, so the namespaces can never collide):

- ``("mbr:req:join", <nonce>)`` / ``("mbr:req:leave", <nonce>)``:
  requests TO the coordinator. The receiver's rendezvous store does not
  park these — it dispatches them to the registered control handler and
  the handler's verdict rides back in the frame's ack (a 403 ack fails
  the sender's future, which is how a rejected join surfaces).
- ``("mbr:rsp", <nonce>)``: the coordinator's JoinAccept, a normal
  stored frame the joiner is parked on.
- ``("mbr:sync", <sync_index>)``: the coordinator's view broadcast at
  sync point ``sync_index``, a normal stored frame each member party
  recvs at its own ``fed.membership_sync()`` call.

Epoch-prefixed seq ids: while a membership manager is installed, every
INTEGER seq id is stamped ``e<epoch>:<n>`` at the barrier layer on both
send and recv. Send and its matching recv sit at the same program point
of the same driver program, so both sides stamp the same epoch; a frame
from a pre-bump incarnation parks under its old-epoch key and can never
be taken by post-bump code — the re-key that makes rejoin safe.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Optional

#: Prefix of request seq ids dispatched to the coordinator's control
#: handler instead of being parked in the rendezvous store.
CONTROL_PREFIX = "mbr:req:"

JOIN_REQ_SEQ = "mbr:req:join"
LEAVE_REQ_SEQ = "mbr:req:leave"
RESPONSE_SEQ = "mbr:rsp"
SYNC_SEQ = "mbr:sync"


def is_control_seq_id(seq_id: Any) -> bool:
    return isinstance(seq_id, str) and seq_id.startswith(CONTROL_PREFIX)


def new_nonce() -> str:
    return uuid.uuid4().hex


def sync_down_key(sync_index: int, term: int) -> str:
    """Rendezvous down-key for the sync broadcast at ``sync_index`` under
    coordinator ``term``. Term 0 (the configured coordinator, no failover
    yet) keeps the bare index so pre-HA peers interoperate; any later
    term qualifies the key. The qualification is what fences a deposed
    coordinator at the STORE: rendezvous keys are ``(up, down)`` only and
    delivered keys are tombstoned against duplicates, so a stale term-T
    sync parked (or expired) at its own key can never consume the slot
    the term-T+1 broadcast must land in."""
    return str(int(sync_index)) if int(term) <= 0 else (
        f"{int(sync_index)}t{int(term)}"
    )


def make_join_request(
    party: str, address: str, nonce: str, token: Optional[str],
    term: int = 0,
) -> Dict:
    return {
        "kind": "join",
        "party": party,
        "address": address,
        "nonce": nonce,
        "token": token,
        "term": int(term),
    }


def make_leave_request(party: str, nonce: str, term: int = 0) -> Dict:
    return {"kind": "leave", "party": party, "nonce": nonce, "term": int(term)}


def make_join_accept(
    view_wire: Dict,
    sync_index: int,
    admissions: Dict[str, int],
    evictions: Dict[str, int],
    bootstrap: Any,
    term: int = 0,
) -> Dict:
    return {
        "kind": "join-accept",
        "view": view_wire,
        "sync_index": int(sync_index),
        "admissions": dict(admissions),
        "evictions": dict(evictions),
        "bootstrap": bootstrap,
        "term": int(term),
    }


def make_sync(
    view_wire: Dict,
    sync_index: int,
    admitted: Dict[str, str],
    evicted: Dict[str, int],
    admissions: Optional[Dict[str, int]] = None,
    evictions: Optional[Dict[str, int]] = None,
    term: int = 0,
    coordinator: Optional[str] = None,
) -> Dict:
    """The per-sync view broadcast. ``admitted`` maps parties admitted at
    THIS bump to their addresses; ``evicted`` maps parties removed at
    this bump to the epoch as of which they are out (ghost stamp).
    ``admissions``/``evictions`` are the coordinator's FULL ghost tables
    after the bump — they make every sync self-contained, so a member
    that missed an intermediate sync (recv timed out, frame lost) still
    reconciles to the complete state instead of just this bump's delta.
    ``term`` is the sender's coordinator term; receivers reject any sync
    whose term is below their own (a deposed coordinator's stale view)."""
    return {
        "kind": "sync",
        "view": view_wire,
        "sync_index": int(sync_index),
        "admitted": dict(admitted),
        "evicted": dict(evicted),
        "admissions": dict(admissions) if admissions is not None else None,
        "evictions": dict(evictions) if evictions is not None else None,
        "term": int(term),
        "coordinator": coordinator,
    }
