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

"""FedObject: the party-tagged lazy handle for a fed task output.

Capability parity: reference ``fed/fed_object.py:41-81``. A ``FedObject``
produced in *this* party wraps a live value future from the local executor;
one produced in another party is a pure placeholder (``future=None``) until
a ``recv`` future is cached on first resolution (ref
``fed/utils.py:70-76``, ``fed/api.py:580-594``). The sending context
deduplicates pushes per target party (ref ``fed_object.py:18-32``,
exercised by ``fed/tests/test_cache_fed_objects.py``).

TPU note: the resolved value of a FedObject is whatever the task returned —
for the TPU data plane that is typically a (sharded) ``jax.Array`` already
living on the party's mesh; the handle itself stays backend-agnostic.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Optional


class FedObjectSendingContext:
    """Tracks which parties this object is being / has been pushed to."""

    def __init__(self) -> None:
        self._is_sending_or_sent = set()

    def mark_is_sending_to_party(self, target_party: str) -> None:
        self._is_sending_or_sent.add(target_party)

    def was_sending_or_sent_to_party(self, target_party: str) -> bool:
        return target_party in self._is_sending_or_sent


class FedObject:
    def __init__(
        self,
        node_party: str,
        fed_task_id: int,
        future: Optional[Future],
        idx_in_task: int = 0,
    ) -> None:
        self._node_party = node_party
        self._future = future
        self._fed_task_id = fed_task_id
        self._idx_in_task = idx_in_task
        self._sending_context = FedObjectSendingContext()

    def get_value_future(self) -> Optional[Future]:
        """The local value future (own party), the cached recv future
        (foreign party, after first resolution), or None."""
        return self._future

    def get_fed_task_id(self) -> str:
        # Wire-visible id: "<seq>#<output index>" (ref fed_object.py:64-65).
        return f"{self._fed_task_id}#{self._idx_in_task}"

    def get_party(self) -> str:
        return self._node_party

    def _mark_is_sending_to_party(self, target_party: str) -> None:
        self._sending_context.mark_is_sending_to_party(target_party)

    def _was_sending_or_sent_to_party(self, target_party: str) -> bool:
        return self._sending_context.was_sending_or_sent_to_party(target_party)

    def _cache_value_future(self, future: Future) -> None:
        self._future = future

    def __repr__(self) -> str:
        state = "bound" if self._future is not None else "placeholder"
        return (
            f"FedObject(party={self._node_party}, "
            f"task_id={self.get_fed_task_id()}, {state})"
        )
