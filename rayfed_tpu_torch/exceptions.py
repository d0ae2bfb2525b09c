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

"""Cross-party error envelopes.

Capability parity: the reference's ``FedRemoteError`` is the single typed
envelope in which one party's task/actor failure travels to every other party
(reference: ``fed/exceptions.py:16-25``; produced by the cleanup drain at
``fed/cleanup.py:160-172`` and re-raised out of the receiver at
``fed/proxy/barriers.py:227-234``).
"""

from __future__ import annotations


class FedRemoteError(Exception):
    """An error raised in one party, delivered to a peer under the same
    (upstream_seq_id, downstream_seq_id) rendezvous the peer is waiting on.

    ``cause`` is the original exception if the sending party exposed the
    trace (``expose_error_trace=True``), otherwise a string summary — the
    same privacy knob as the reference (``fed/cleanup.py:160-167``).
    """

    def __init__(self, src_party: str, cause):
        self._src_party = src_party
        self._cause = cause

    @property
    def src_party(self) -> str:
        return self._src_party

    @property
    def cause(self):
        return self._cause

    def __str__(self) -> str:
        return (
            f"FedRemoteError occurred at party {self._src_party}."
            f" Caused by {self._cause!r}."
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.__str__()


class FedLocalError(Exception):
    """Wrapper distinguishing a *local* task failure from a remote envelope
    when both flow through the same send lane (our design; the reference
    conflates these inside the cleanup thread)."""

    def __init__(self, cause: BaseException):
        self._cause = cause

    @property
    def cause(self) -> BaseException:
        return self._cause

    def __str__(self) -> str:
        return f"FedLocalError caused by {self._cause!r}"


class FedActorKilledError(Exception):
    """Raised by method futures of an actor that was ``fed.kill``-ed before
    they could run (the analogue of Ray's RayActorError fail-fast semantics,
    ref ``fed/api.py:611-623``)."""


class StaleCoordinatorError(Exception):
    """A membership sync arrived from a deposed coordinator: its term is
    below the term this party already adopted at a failover. The view it
    carries was folded without the failover's evictions, so applying it
    would fork the roster — every party rejects it instead (docs/ha.md).
    """

    def __init__(self, received_term: int, current_term: int,
                 coordinator=None):
        self.received_term = int(received_term)
        self.current_term = int(current_term)
        self.coordinator = coordinator
        super().__init__(
            f"stale membership sync from deposed coordinator "
            f"{coordinator!r}: term {received_term} < adopted term "
            f"{current_term}"
        )
