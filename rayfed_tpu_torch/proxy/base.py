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

"""Abstract transport interfaces.

Capability parity: reference ``fed/proxy/base_proxy.py:21-106`` — the
pluggable seam that lets ``fed.init(sender_proxy_cls=..., receiver_proxy_cls
=...)`` swap transports (ref ``fed/api.py:73-75,239-292``). Our proxies are
thread-owned objects in the party process (the reference wraps them in
singleton Ray actors, ``fed/proxy/barriers.py:113-240``); the contract is
future-based rather than coroutine-based so callers never touch the
transport's event loop.
"""

from __future__ import annotations

import abc
from concurrent.futures import Future
from typing import Dict, Optional


class SenderProxy(abc.ABC):
    def __init__(
        self,
        addresses: Dict[str, str],
        party: str,
        job_name: str,
        tls_config: Optional[Dict],
        proxy_config: Optional[Dict] = None,
    ) -> None:
        self._addresses = addresses
        self._party = party
        self._job_name = job_name
        self._tls_config = tls_config or {}
        self._proxy_config = proxy_config or {}

    @abc.abstractmethod
    def start(self) -> None:
        """Spin up whatever background machinery sending needs."""

    @abc.abstractmethod
    def send(
        self,
        dest_party: str,
        data,
        upstream_seq_id,
        downstream_seq_id,
        is_error: bool = False,
    ) -> Future:
        """Push ``data`` (a value or a value Future) to ``dest_party`` under
        the (upstream, downstream) rendezvous key. The returned Future
        resolves True once the peer acknowledged, or raises."""

    def get_stats(self) -> Dict:
        return {}

    def stop(self) -> None:  # pragma: no cover - trivial default
        pass


class SenderReceiverProxy(abc.ABC):
    """One object serving both directions on one inbound port (ref
    ``fed/proxy/base_proxy.py:77-106``) — the seam transports with a
    single bidirectional link (e.g. secretflow's brpc link) plug into.
    Injected via ``fed.init(receiver_sender_proxy_cls=...)``."""

    def __init__(
        self,
        addresses: Dict[str, str],
        party: str,
        job_name: str,
        tls_config: Optional[Dict],
        proxy_config: Optional[Dict] = None,
    ) -> None:
        self._addresses = addresses
        self._party = party
        self._job_name = job_name
        self._tls_config = tls_config or {}
        self._proxy_config = proxy_config or {}

    @abc.abstractmethod
    def start(self) -> None:
        """Bind the inbound port and spin up sending machinery."""

    @abc.abstractmethod
    def is_ready(self, timeout: Optional[float] = None):
        """(ok, error_message_or_None) once the inbound port is bound."""

    @abc.abstractmethod
    def send(
        self,
        dest_party: str,
        data,
        upstream_seq_id,
        downstream_seq_id,
        is_error: bool = False,
    ) -> Future:
        """Same contract as :meth:`SenderProxy.send`."""

    @abc.abstractmethod
    def get_data(self, src_party: str, upstream_seq_id, curr_seq_id) -> Future:
        """Same contract as :meth:`ReceiverProxy.get_data`."""

    def get_stats(self) -> Dict:
        return {}

    def ping_sources(self):
        """(attributed ping sources, anonymous ping count) seen by this
        receiver, or None when this backend's wire can never attribute
        pings — the readiness barrier then skips its mutual wait instead
        of burning the grace period on every init."""
        return None

    def stop(self) -> None:  # pragma: no cover - trivial default
        pass


class ReceiverProxy(abc.ABC):
    def __init__(
        self,
        listen_addr: str,
        party: str,
        job_name: str,
        tls_config: Optional[Dict],
        proxy_config: Optional[Dict] = None,
    ) -> None:
        self._listen_addr = listen_addr
        self._party = party
        self._job_name = job_name
        self._tls_config = tls_config or {}
        self._proxy_config = proxy_config or {}

    @abc.abstractmethod
    def start(self) -> None:
        """Bind and serve. Must make :meth:`is_ready` answerable."""

    @abc.abstractmethod
    def is_ready(self, timeout: Optional[float] = None):
        """Return (ok, error_message_or_None) — reference
        ``barriers.py:277-280`` blocks init on this."""

    @abc.abstractmethod
    def get_data(self, src_party: str, upstream_seq_id, curr_seq_id) -> Future:
        """Future for the payload addressed (upstream_seq_id, curr_seq_id).
        Resolves whenever the data arrives — before or after this call
        (either-side-first rendezvous, ref ``grpc_proxy.py:276-283,332-340``)."""

    def get_stats(self) -> Dict:
        return {}

    def ping_sources(self):
        """(attributed ping sources, anonymous ping count) seen by this
        receiver, or None when this backend's wire can never attribute
        pings — the readiness barrier then skips its mutual wait instead
        of burning the grace period on every init."""
        return None

    def stop(self) -> None:  # pragma: no cover - trivial default
        pass
