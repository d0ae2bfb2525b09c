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

"""Per-peer link-health estimation: the brain behind adaptive deadlines.

Every timeout in the transport was historically a fixed config number
tuned for one link class (loopback): `timeout_in_ms` ack timeouts,
`recv_timeout_in_ms` rendezvous deadlines, `RetryPolicy.max_backoff_ms`
reconnect ceilings, liveness probe budgets. On a 50ms WAN those numbers
false-positive (a healthy ack takes 10x the LAN-tuned timeout → resend
storms, DEAD verdicts); on a 5ms LAN the WAN-safe numbers waste 250ms
waits on events that complete in 1ms.

:class:`LinkHealth` closes the loop. It ingests the RTT samples the
transport already produces for free — reactor ack round-trips
(``now - inflight.sent_at`` per acked fseq) and liveness ping
completions — and maintains RFC 6298-style estimators per peer:

- ``srtt``   — EWMA smoothed RTT, gain ``RTT_ALPHA`` (1/8)
- ``rttvar`` — EWMA mean deviation, gain ``RTT_BETA`` (1/4)
- ``loss``   — EWMA loss ratio over {ack timeout, lane break, probe
  miss} events vs successes, gain ``LOSS_GAMMA``

and derives the three adaptive quantities the ISSUE names (formulas
documented in docs/resilience.md, "WAN emulation & link health"):

- ``ack_timeout_s(peer, base)``  = clamp(mult·srtt + 4·rttvar,
  floor, base) — never ABOVE the configured timeout (that stays the
  operator's hard ceiling), never below the floor, and exactly ``base``
  until the first sample arrives.
- ``recv_slack_s(peer)`` = mult·(srtt + 4·rttvar) — ADDITIVE slack for
  the rendezvous recv deadline, so WAN jitter extends the parking
  budget instead of tombstoning a frame that is merely in flight.
- ``backoff_ceiling_s(peer, base)`` = clamp(BACKOFF_RTT_MULT·srtt,
  BACKOFF_FLOOR_S, base) — retry pauses scale with the measured link
  instead of sleeping a WAN-tuned 30s on a 5ms link.

Telemetry: ``fed_link_rtt_ms{peer}`` and ``fed_link_loss_ratio{peer}``
gauges are updated on every observation, mirrored by
:func:`get_stats` for test/tooling access without a scrape.

Stdlib-only (telemetry import is lazy) so the resilience package stays
import-light; thread-safe — the reactor thread, liveness monitor
thread, and sender pool threads all feed one estimator.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# RFC 6298 gains for the smoothed-RTT / mean-deviation estimators.
RTT_ALPHA = 0.125
RTT_BETA = 0.25
# Loss-ratio EWMA gain: ~20 observations of memory, fast enough to see
# a degrading link inside one round, slow enough that a single timeout
# doesn't read as 100% loss.
LOSS_GAMMA = 0.05

# Adaptive ack timeout = clamp(RTT_TIMEOUT_MULT*srtt + 4*rttvar, floor,
# configured timeout). The default multiple is deliberately generous:
# shrinking a timeout below what the link needs is strictly worse than
# leaving it long.
RTT_TIMEOUT_MULT = 8.0
# Retry backoff ceiling = clamp(BACKOFF_RTT_MULT*srtt, floor, policy cap).
BACKOFF_RTT_MULT = 16.0
BACKOFF_FLOOR_S = 0.05


class _PeerEstimator:
    __slots__ = ("srtt", "rttvar", "loss", "samples", "losses")

    def __init__(self) -> None:
        self.srtt: Optional[float] = None
        self.rttvar: float = 0.0
        self.loss: float = 0.0
        self.samples: int = 0
        self.losses: int = 0


class LinkHealth:
    """Per-peer EWMA RTT/loss estimators plus the adaptive-deadline
    derivations. One instance per process (module singleton below);
    peers are keyed by party name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: Dict[str, _PeerEstimator] = {}

    # -- ingestion ---------------------------------------------------

    def observe_rtt(self, peer: str, rtt_s: float) -> None:
        """Record one successful round-trip (ack or liveness ping)."""
        if rtt_s < 0:
            return
        with self._lock:
            est = self._peers.setdefault(peer, _PeerEstimator())
            if est.srtt is None:
                est.srtt = rtt_s
                est.rttvar = rtt_s / 2.0
            else:
                est.rttvar = (1.0 - RTT_BETA) * est.rttvar + RTT_BETA * abs(
                    est.srtt - rtt_s
                )
                est.srtt = (1.0 - RTT_ALPHA) * est.srtt + RTT_ALPHA * rtt_s
            est.loss = (1.0 - LOSS_GAMMA) * est.loss  # success → decay
            est.samples += 1
            srtt_ms = est.srtt * 1000.0
            loss = est.loss
        self._export(peer, srtt_ms, loss)

    def observe_loss(self, peer: str) -> None:
        """Record one loss-shaped event: ack timeout, lane break, or
        liveness probe miss."""
        with self._lock:
            est = self._peers.setdefault(peer, _PeerEstimator())
            est.loss = (1.0 - LOSS_GAMMA) * est.loss + LOSS_GAMMA
            est.losses += 1
            srtt_ms = (est.srtt or 0.0) * 1000.0
            loss = est.loss
        self._export(peer, srtt_ms, loss)

    # -- derivations -------------------------------------------------

    def rtt_ms(self, peer: str) -> Optional[float]:
        with self._lock:
            est = self._peers.get(peer)
            if est is None or est.srtt is None:
                return None
            return est.srtt * 1000.0

    def loss_ratio(self, peer: str) -> float:
        with self._lock:
            est = self._peers.get(peer)
            return est.loss if est is not None else 0.0

    def _rto_s(self, peer: str, mult: float) -> Optional[float]:
        with self._lock:
            est = self._peers.get(peer)
            if est is None or est.srtt is None:
                return None
            return mult * est.srtt + 4.0 * est.rttvar

    def ack_timeout_s(
        self,
        peer: str,
        base_s: float,
        *,
        mult: float = RTT_TIMEOUT_MULT,
        floor_s: float = 0.25,
    ) -> float:
        """Adaptive ack timeout: RTT-multiple, clamped to
        [floor_s, base_s]. ``base_s`` (the configured timeout) stays the
        hard ceiling; with no samples yet it is returned unchanged."""
        rto = self._rto_s(peer, mult)
        if rto is None:
            return base_s
        return max(min(floor_s, base_s), min(rto, base_s))

    def recv_slack_s(self, peer: str, *, mult: float = RTT_TIMEOUT_MULT) -> float:
        """Additive slack for recv deadlines: mult*(srtt + 4*rttvar).
        Zero with no samples — adaptive recv deadlines only ever EXTEND
        the configured budget, never shrink it."""
        rto = self._rto_s(peer, mult)
        return 0.0 if rto is None else rto

    def max_recv_slack_s(self, *, mult: float = RTT_TIMEOUT_MULT) -> float:
        """Worst-case recv slack across every tracked peer — for
        consumers (rendezvous ``take``) that park a deadline before
        knowing which peer will complete it. Zero with no samples."""
        worst = 0.0
        with self._lock:
            for est in self._peers.values():
                if est.srtt is None:
                    continue
                worst = max(worst, mult * est.srtt + 4.0 * est.rttvar)
        return worst

    def backoff_ceiling_s(self, peer: str, base_ceiling_s: float) -> float:
        """RTT-derived retry backoff cap: clamp(16*srtt, 50ms, policy
        cap). With no samples, the policy's own cap stands."""
        with self._lock:
            est = self._peers.get(peer)
            if est is None or est.srtt is None:
                return base_ceiling_s
            srtt = est.srtt
        return max(BACKOFF_FLOOR_S, min(BACKOFF_RTT_MULT * srtt, base_ceiling_s))

    # -- export ------------------------------------------------------

    def _export(self, peer: str, srtt_ms: float, loss: float) -> None:
        try:
            from rayfed_tpu_torch.telemetry import metrics as _metrics

            reg = _metrics.get_registry()
            reg.gauge(
                "fed_link_rtt_ms",
                "EWMA smoothed round-trip time per peer (ms)",
                labels=("peer",),
            ).labels(peer=peer).set(srtt_ms)
            reg.gauge(
                "fed_link_loss_ratio",
                "EWMA loss ratio per peer (ack timeouts, breaks, probe misses)",
                labels=("peer",),
            ).labels(peer=peer).set(loss)
        except Exception:  # pragma: no cover - telemetry is best-effort
            pass

    def get_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-peer snapshot: srtt_ms, rttvar_ms, loss_ratio, samples,
        losses. The get_stats() mirror of the two link gauges."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for peer, est in self._peers.items():
                out[peer] = {
                    "srtt_ms": (est.srtt or 0.0) * 1000.0,
                    "rttvar_ms": est.rttvar * 1000.0,
                    "loss_ratio": est.loss,
                    "samples": float(est.samples),
                    "losses": float(est.losses),
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._peers.clear()


# Process-wide estimator. All transports feed the same instance so a
# peer's health is judged from every signal source at once (reactor
# acks + liveness pings), and every consumer (ack timeouts, recv
# deadlines, backoff ceilings) sees one consistent view.
# fedlint: disable=global-mutable-singleton (process-wide link estimator; reset hook: reset_health)
_health = LinkHealth()


def get_health() -> LinkHealth:
    return _health


def observe_rtt(peer: str, rtt_s: float) -> None:
    _health.observe_rtt(peer, rtt_s)


def observe_loss(peer: str) -> None:
    _health.observe_loss(peer)


def reset_health() -> None:
    """Test hook: drop all estimator state."""
    _health.reset()
