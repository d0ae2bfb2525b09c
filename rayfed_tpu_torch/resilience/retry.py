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

"""The unified retry engine.

Historically each transport grew its own retry loop: the TCP proxy's
``_connect_retry`` (exponential backoff, no jitter), its
``_send_half_duplex`` reconnect loop (one bounded re-dial, no backoff),
and the gRPC lane's service-config JSON rendered straight from
``RetryPolicy`` (which gRPC core then clamps with stderr spam when
``maxAttempts > 5``). This module is the single replacement all of them
call:

- :class:`RetryPolicy` — the one policy dataclass (moved here from
  ``config.py``; ``rayfed_tpu_torch.config.RetryPolicy`` remains a re-export).
- :func:`run_with_retry` — exponential backoff with optional
  decorrelated jitter and a per-call :class:`Deadline` budget.
- :func:`grpc_retry_policy` — the gRPC service-config rendering, with
  ``maxAttempts`` clamped to gRPC core's hard cap of 5 *before* the JSON
  leaves us, so gRPC never has to complain.

Stdlib-only on purpose: ``config.py`` imports this module, so anything
heavier would create an import cycle (and retry logic has no business
depending on jax anyway).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

logger = logging.getLogger(__name__)

# gRPC core hard-clamps retryPolicy.maxAttempts at 5 and logs
# "retry_service_config.cc: Clamped retryPolicy.maxAttempts at 5" to
# stderr every time a channel is built with more. Render at most this.
GRPC_MAX_ATTEMPTS = 5


@dataclasses.dataclass
class RetryPolicy:
    """Connection/send retry policy, mirroring the reference's gRPC service
    config defaults (ref ``grpc_options.py:19-25``): 5 attempts, 5s initial
    backoff, 30s cap, x2 multiplier.

    ``jitter=True`` (default) multiplies each backoff by a uniform factor
    in [0.5, 1.0] so parties retrying against the same recovering peer
    don't synchronize their reconnect storms. Tests that assert exact
    sleep sequences can disable it.
    """

    max_attempts: int = 5
    initial_backoff_ms: int = 5000
    max_backoff_ms: int = 30000
    backoff_multiplier: float = 2.0
    jitter: bool = True

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "RetryPolicy":
        data = data or {}
        # Accept the reference's camelCase gRPC retry keys too.
        alias = {
            "maxAttempts": "max_attempts",
            "initialBackoff": "initial_backoff_ms",
            "maxBackoff": "max_backoff_ms",
            "backoffMultiplier": "backoff_multiplier",
        }

        def conv(k: str, v: Any) -> Any:
            if k in ("initialBackoff", "maxBackoff") and isinstance(v, str):
                return int(float(v.rstrip("s")) * 1000)
            return v

        norm = {alias.get(k, k): conv(k, v) for k, v in data.items()}
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in norm.items() if k in field_names})

    def backoff_s(self, attempt: int) -> float:
        """Backoff to sleep after failed attempt ``attempt`` (1-based),
        before jitter: initial * multiplier^(attempt-1), capped."""
        ms = self.initial_backoff_ms * (self.backoff_multiplier ** (attempt - 1))
        return min(ms, self.max_backoff_ms) / 1000.0


def grpc_retry_policy(policy: RetryPolicy) -> Dict[str, Any]:
    """Render ``policy`` as a gRPC service-config ``retryPolicy`` dict,
    clamped to what gRPC core actually accepts (maxAttempts in [2, 5])."""
    attempts = max(2, min(policy.max_attempts, GRPC_MAX_ATTEMPTS))
    if policy.max_attempts > GRPC_MAX_ATTEMPTS:
        logger.debug(
            "retry_policy max_attempts=%d exceeds gRPC cap; rendering %d "
            "(the engine-level retry loop still honors the full count)",
            policy.max_attempts,
            attempts,
        )
    return {
        "maxAttempts": attempts,
        "initialBackoff": f"{policy.initial_backoff_ms / 1000}s",
        "maxBackoff": f"{policy.max_backoff_ms / 1000}s",
        "backoffMultiplier": policy.backoff_multiplier,
        "retryableStatusCodes": ["UNAVAILABLE"],
    }


class Deadline:
    """A wall-clock budget shared across the attempts of one operation
    (and across the sub-operations of one send: dial, then stream).

    ``None`` budget = no deadline; ``remaining()`` then returns None and
    ``expired`` is always False.
    """

    __slots__ = ("_t_end",)

    def __init__(self, budget_s: Optional[float]) -> None:
        self._t_end = None if budget_s is None else time.monotonic() + budget_s

    @classmethod
    def from_ms(cls, budget_ms: Optional[int]) -> "Deadline":
        return cls(None if budget_ms is None else budget_ms / 1000.0)

    def remaining(self) -> Optional[float]:
        if self._t_end is None:
            return None
        return max(0.0, self._t_end - time.monotonic())

    @property
    def expired(self) -> bool:
        return self._t_end is not None and time.monotonic() >= self._t_end

    def clip(self, timeout_s: float) -> float:
        """``timeout_s`` reduced to what the deadline still allows."""
        rem = self.remaining()
        return timeout_s if rem is None else min(timeout_s, rem)


def run_with_retry(
    fn: Callable[[int], Any],
    policy: RetryPolicy,
    *,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    give_up_on: Tuple[Type[BaseException], ...] = (),
    deadline: Optional[Deadline] = None,
    describe: str = "operation",
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    backoff_ceiling_s: Optional[float] = None,
) -> Any:
    """Run ``fn(attempt)`` (attempt is 1-based) under ``policy``.

    Retries on ``retry_on`` exceptions with exponential backoff; an
    exception matching ``give_up_on`` is re-raised immediately even if it
    also matches ``retry_on`` (e.g. ``socket.timeout`` on a send that
    already consumed its per-op budget — re-dialing won't help and the
    caller's timeout contract says fail now). A ``deadline``, when given,
    bounds the whole loop: backoffs are clipped to the remaining budget
    and no new attempt starts once it expires. ``backoff_ceiling_s``
    additionally caps every pause below the policy's own ``max_backoff_ms``
    — the link-health layer passes an RTT-derived ceiling here so a 5ms
    link never sleeps a WAN-tuned 30s between attempts.

    The backoff clamp is deadline-aware in BOTH directions: a pause is
    never allowed to swallow the whole remaining budget. The loop tracks
    the cost of the slowest attempt so far and shortens the pause so the
    next (possibly final) attempt starts with at least that much budget
    left — without this, a WAN-scale backoff (5s initial) against a 6s
    deadline burns the budget sleeping and the "final attempt" is a
    0ms-budget formality that can only fail.

    On exhaustion raises a plain ``ConnectionError`` — callers (and the
    sending-failure handler contract, see
    ``tests/test_failure_paths.py::test_send_failure_when_peer_never_starts``)
    rely on that exact type — with the last underlying error in the
    message. ``on_retry(attempt, exc)`` is called before each backoff
    sleep, for logging/tracing hooks.
    """
    attempts = max(1, policy.max_attempts)
    last_err: Optional[BaseException] = None
    attempt_cost = 0.0  # slowest observed attempt, the final-fit reserve
    for attempt in range(1, attempts + 1):
        t_start = time.monotonic()
        try:
            return fn(attempt)
        except give_up_on:
            raise
        except retry_on as e:
            attempt_cost = max(attempt_cost, time.monotonic() - t_start)
            last_err = e
            if attempt >= attempts:
                break
            if deadline is not None and deadline.expired:
                break
            if on_retry is not None:
                on_retry(attempt, e)
            pause = policy.backoff_s(attempt)
            if backoff_ceiling_s is not None:
                pause = min(pause, max(0.0, backoff_ceiling_s))
            if policy.jitter:
                pause *= 0.5 + 0.5 * random.random()
            if deadline is not None:
                # Reserve room for the attempt that follows the pause:
                # sleep at most (remaining - one attempt's cost), so the
                # final attempt always FITS the deadline instead of
                # starting exactly as it expires.
                rem = deadline.remaining()
                if rem is not None:
                    pause = min(
                        pause, max(0.0, rem - max(attempt_cost, 0.001))
                    )
            if pause > 0:
                time.sleep(pause)
    raise ConnectionError(
        f"{describe} failed after {attempt} attempt(s): {last_err!r}"
    )
