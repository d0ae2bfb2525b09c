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

"""Seq-id validation in the port's barrier layer, mirroring
``test_seq_id_validation.py`` with the same assertions.

The pair ``(PING_SEQ_ID, PING_SEQ_ID)`` — ``("ping", "ping")`` — is the
readiness-probe address: proxies exchange it before any data flows, and a
user payload stored under it would be swallowed by (or collide with) the
probe. ``barriers.send``/``barriers.recv`` must reject it eagerly with a
clear ``ValueError`` instead of deadlocking or corrupting the handshake.
The check runs before any global-context lookup, so no ``fed.init`` is
needed here.
"""

import pytest

from rayfed_tpu_torch._private.constants import PING_SEQ_ID
from rayfed_tpu_torch.proxy import barriers


def test_send_rejects_reserved_pair():
    with pytest.raises(ValueError, match="reserved for the readiness probe"):
        barriers.send("bob", object(), PING_SEQ_ID, PING_SEQ_ID)


def test_recv_rejects_reserved_pair():
    with pytest.raises(ValueError, match="reserved for the readiness probe"):
        barriers.recv("alice", "bob", PING_SEQ_ID, PING_SEQ_ID)


def test_reserved_pair_error_names_lint_rule():
    """The error message points at the fedlint rule so drivers hitting it
    at runtime can find the static check (and its docs) by id."""
    with pytest.raises(ValueError, match=barriers.FEDLINT_RESERVED_SEQ_RULE):
        barriers.send("bob", object(), PING_SEQ_ID, PING_SEQ_ID)


def test_partial_ping_ids_pass_validation():
    """Only the exact reserved PAIR is rejected — a single 'ping' on one
    side is a legal (if odd) user seq id. Without an initialized runtime
    the calls fail later with the standard usage error, not ValueError."""
    for up, down in [(PING_SEQ_ID, 7), (3, PING_SEQ_ID), (1, 2)]:
        with pytest.raises(AssertionError):
            barriers.send("bob", object(), up, down)
