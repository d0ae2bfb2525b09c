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

"""Party-local stateful actors.

Capability parity: reference ``fed/_private/fed_actor.py`` — a
``FedActorHandle`` mirrors the actor API; the real object is instantiated
only in its own party (ref ``fed_actor.py:78-91``); method access resolves
through ``__getattr__`` (ref ``fed_actor.py:44-76``) and every method call
goes through a FedCallHolder (ref ``fed_actor.py:115-145``).

TPU-native substrate: instead of a Ray actor process, the instance lives on
a :class:`~rayfed_tpu_torch._private.executor.SerialLane` — a dedicated thread
that executes constructor + methods one-at-a-time in submission order (the
actor ordering guarantee). For model actors this is exactly right: state is
a pytree of device arrays on the party mesh; methods are jit calls whose
device work overlaps via XLA's async dispatch even though Python-side entry
is serialized.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from rayfed_tpu_torch._private.call_holder import FedCallHolder
from rayfed_tpu_torch._private.global_context import get_global_context

logger = logging.getLogger(__name__)


class FedActorHandle:
    def __init__(
        self,
        fed_class_task_id: int,
        addresses: Dict[str, str],
        cls,
        party: str,
        node_party: str,
        options: Dict[str, Any],
    ) -> None:
        self._fed_class_task_id = fed_class_task_id
        self._addresses = addresses
        self._body = cls
        self._party = party
        self._node_party = node_party
        self._options = options
        self._lane = None
        self._instance_future = None

    def __getattr__(self, method_name: str):
        # `__getattr__` is only invoked for *missing* attributes, so actor
        # internals resolve normally (ref fed_actor.py:44-54).
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        if self._node_party == self._party and self._instance_future is None:
            raise AttributeError(
                f"actor {self._body} is not instantiated in party {self._party}"
            )
        return FedActorMethod(
            self._addresses, self._party, self._node_party, self, method_name
        )

    def _execute_impl(self, cls_args, cls_kwargs):
        """Instantiate the real object — own party only (routed by the
        creation FedCallHolder, ref fed_actor.py:78-91)."""
        executor = get_global_context().get_executor()
        self._lane = executor.new_lane(
            name=f"fedtpu-actor-{getattr(self._body, '__name__', 'actor')}"
        )
        self._instance_future = executor.submit(
            self._body, cls_args, cls_kwargs, lane=self._lane
        )
        return self._instance_future

    def _execute_remote_method(self, method_name, options, args, kwargs):
        """Run a method on the actor's serial lane — own party only."""
        num_returns = (options or {}).get("num_returns", 1)
        executor = get_global_context().get_executor()
        instance_future = self._instance_future

        def call(*a, **k):
            instance = instance_future.result()
            return getattr(instance, method_name)(*a, **k)

        return executor.submit(call, args, kwargs, num_returns=num_returns,
                               lane=self._lane)

    def _kill(self) -> None:
        """Forcefully drop the instance (fed.kill, ref ``fed/api.py:611-623``).
        Pending method futures fail fast with FedActorKilledError rather than
        hanging their consumers."""
        if self._lane is not None:
            self._lane.kill()


class FedActorMethod:
    def __init__(self, addresses, party, node_party, fed_actor_handle,
                 method_name) -> None:
        self._addresses = addresses
        self._party = party
        self._node_party = node_party
        self._fed_actor_handle = fed_actor_handle
        self._method_name = method_name
        self._options: Dict[str, Any] = {}
        self._fed_call_holder = FedCallHolder(node_party, self._execute_impl)

    def remote(self, *args, **kwargs):
        return self._fed_call_holder.internal_remote(*args, **kwargs)

    def options(self, **options):
        self._options = options
        self._fed_call_holder.options(**options)
        return self

    def _execute_impl(self, args, kwargs):
        return self._fed_actor_handle._execute_remote_method(
            self._method_name, self._options, args, kwargs
        )
