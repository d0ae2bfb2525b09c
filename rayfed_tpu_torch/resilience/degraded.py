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

"""Degraded-mode result resolution: the policy behind
``fed.get(..., timeout=, on_missing=)``.

A federated round degrades when some contributor's value never arrives —
the peer died, the link partitioned, retries exhausted. The question is
what the driver sees then. ``on_missing`` answers it:

- ``"raise"`` (default): today's behavior — the transport failure
  (TimeoutError / ConnectionError) propagates.
- ``"drop"``: missing entries are removed from a list result — the
  round continues over survivors (pair with
  :func:`rayfed_tpu_torch.ops.aggregate.elastic_weighted_mean`).
- ``"default"``: missing entries are replaced by a caller-supplied
  substitute (or the :data:`MISSING` sentinel, which the elastic
  aggregator also skips).

Only *absence* failures qualify: a ``FedRemoteError`` envelope means the
peer is alive and its task RAISED — masking a real application error as
a missing value would silently train on garbage, so envelopes always
re-raise regardless of policy.

No jax, no transport imports: this module is pure waiting policy, usable
from any process.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, List, Optional, Sequence, Tuple

ON_MISSING_CHOICES = ("raise", "drop", "default")


class _Missing:
    """Singleton sentinel for a value that never arrived (pickles to the
    same identity, so it survives a spawn boundary)."""

    _instance: Optional["_Missing"] = None

    def __new__(cls) -> "_Missing":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "fed.MISSING"

    def __reduce__(self):
        return (_Missing, ())

    def __bool__(self) -> bool:
        return False


MISSING = _Missing()


def is_missing_error(err: BaseException) -> bool:
    """True when ``err`` means "the value never arrived" (degradable),
    False when it is a real application error (never maskable).

    ConnectionError covers retry exhaustion and injected faults
    (InjectedFault subclasses it); TimeoutError covers recv deadlines
    and expired ``fed.get`` timeouts (both the builtin and the
    ``concurrent.futures`` flavor — distinct types until py3.11+ unified
    only the asyncio one). FedRemoteError is checked first: it rides the
    same wire but proves the peer was alive enough to fail loudly."""
    from rayfed_tpu_torch.exceptions import FedRemoteError

    if isinstance(err, FedRemoteError):
        return False
    return isinstance(
        err,
        (TimeoutError, ConnectionError, OSError,
         concurrent.futures.TimeoutError),
    )


def validate_on_missing(on_missing: str) -> None:
    if on_missing not in ON_MISSING_CHOICES:
        raise ValueError(
            f"on_missing must be one of {ON_MISSING_CHOICES}, "
            f"got {on_missing!r}"
        )


def resolve_with_policy(
    futures: Sequence["concurrent.futures.Future"],
    timeout_s: Optional[float],
    on_missing: str,
    default: Any = MISSING,
) -> Tuple[List[Any], List[int]]:
    """Resolve ``futures`` under one shared ``timeout_s`` budget and the
    ``on_missing`` policy.

    Returns ``(values, missing_indices)`` where ``values`` is positional
    with ``default`` substituted at missing slots (callers applying
    "drop" filter by ``missing_indices``). Under "raise", the first
    failure propagates. Non-missing errors (FedRemoteError, arbitrary
    application exceptions) always propagate."""
    validate_on_missing(on_missing)
    # One wall-clock budget across ALL futures, not per-future: a round
    # with 10 missing contributors must cost one timeout, not ten.
    import time

    t_end = None if timeout_s is None else time.monotonic() + timeout_s
    values: List[Any] = []
    missing: List[int] = []
    for i, f in enumerate(futures):
        budget = None if t_end is None else max(0.0, t_end - time.monotonic())
        try:
            from rayfed_tpu_torch._private.executor import result_stealing

            values.append(result_stealing(f, timeout=budget))
            continue
        except BaseException as e:  # noqa: BLE001 - classified below
            if on_missing == "raise" or not is_missing_error(e):
                raise
        values.append(default)
        missing.append(i)
    return values, missing
