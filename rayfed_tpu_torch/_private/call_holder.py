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

"""FedCallHolder: the per-call-site dispatch node.

Capability parity: reference ``fed/_private/fed_call_holder.py:31-110`` —
the single place where the local-vs-remote decision is made:

 - my party == node party: resolve dependency FedObjects into value futures
   (issuing ``recv`` for foreign ones), submit the task to the local
   executor, wrap outputs in bound FedObjects.
 - otherwise: for every *own-party* FedObject argument not yet pushed to the
   node party, fire an owner-initiated push addressed by
   (producer task id, this call's task id); return placeholder FedObject(s).

The owner-push branch is the data perimeter: data leaves a party only
because its owner's driver reached the same call site (ref README.md:28-30).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch._private.global_context import get_global_context
from rayfed_tpu_torch.fed_object import FedObject
from rayfed_tpu_torch.proxy.barriers import send
from rayfed_tpu_torch.utils import resolve_dependencies

logger = logging.getLogger(__name__)


class FedCallHolder:
    def __init__(
        self,
        node_party: str,
        submit_task_func: Callable,
        options: Optional[Dict[str, Any]] = None,
    ) -> None:
        ctx = get_global_context()
        if ctx is None:
            raise RuntimeError(
                "rayfed_tpu_torch is not initialized; call fed.init() first."
            )
        self._party = ctx.get_current_party()
        self._node_party = node_party
        self._options = options or {}
        self._submit_task_func = submit_task_func

    def options(self, **options):
        self._options = options
        return self

    def internal_remote(self, *args, **kwargs):
        if not self._node_party:
            raise ValueError("You should specify a party name on the fed task/actor.")

        fed_task_id = get_global_context().next_seq_id()
        if self._party == self._node_party:
            resolved_args, resolved_kwargs = resolve_dependencies(
                self._party, fed_task_id, *args, **kwargs
            )
            out = self._submit_task_func(resolved_args, resolved_kwargs)
            if isinstance(out, list):
                return [
                    FedObject(self._node_party, fed_task_id, fut, i)
                    for i, fut in enumerate(out)
                ]
            return FedObject(self._node_party, fed_task_id, out)

        # Consumer side of a push (or an unrelated party): push own data.
        flattened_args, _ = tree_util.tree_flatten((args, kwargs))
        for arg in flattened_args:
            if isinstance(arg, FedObject) and arg.get_party() == self._party:
                if arg._was_sending_or_sent_to_party(self._node_party):
                    # Deduplicated: already pushed for an earlier edge
                    # (ref fed_call_holder.py:87-90).
                    continue
                arg._mark_is_sending_to_party(self._node_party)
                send(
                    dest_party=self._node_party,
                    data=arg.get_value_future(),
                    upstream_seq_id=arg.get_fed_task_id(),
                    downstream_seq_id=fed_task_id,
                )
        num_returns = self._options.get("num_returns", 1)
        if num_returns > 1:
            return [
                FedObject(self._node_party, fed_task_id, None, i)
                for i in range(num_returns)
            ]
        return FedObject(self._node_party, fed_task_id, None)
