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

"""Party liveness: heartbeats multiplexed over the existing proxy channel.

There is no separate heartbeat port or protocol. Probes are the same
``(PING_SEQ_ID, PING_SEQ_ID)`` frames the readiness barrier uses — the
receiver's rendezvous store acks them without delivering anything — sent
through the CURRENT sender proxy, which matters twice over: a probe
exercises the very lane data rides on (a liveness view from a side
channel can lie about the data path), and under fault injection the
injector sees probes too, so a one-way partition takes the heartbeats
down with the data exactly like a real network cut.

The monitor mirrors ``ping_others``' one-probe-in-flight model: each
peer has at most one outstanding probe; every ``interval_ms`` tick the
monitor checks it — acked ⇒ consecutive-miss counter resets to ALIVE;
failed, or still pending past ``timeout_ms`` ⇒ one miss. Misses map to
states monotonically: ``suspect_after`` consecutive misses ⇒ SUSPECT,
``dead_after`` ⇒ DEAD; any later ack resurrects the peer to ALIVE (a
DEAD verdict is a local view, not a tombstone).

Missed probes are recorded as ``ok=False`` spans of kind ``"hb"`` in
:mod:`rayfed_tpu_torch.tracing`.

Driver API: ``fed.init(config={"resilience": {"liveness": {...}}})``
starts a monitor; :func:`liveness_view` / :func:`party_state` query it.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Iterable, Optional

from rayfed_tpu_torch import tracing
from rayfed_tpu_torch.resilience import linkhealth
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

ALIVE = "ALIVE"
SUSPECT = "SUSPECT"
DEAD = "DEAD"

_m_peer_state = telemetry_metrics.get_registry().gauge(
    "fed_liveness_peer_state",
    "Local liveness verdict per monitored peer (0=ALIVE 1=SUSPECT 2=DEAD).",
    labels=("peer",),
)
_STATE_CODE = {ALIVE: 0, SUSPECT: 1, DEAD: 2}


@dataclasses.dataclass
class LivenessConfig:
    """Heartbeat cadence and verdict thresholds.

    Attributes:
        interval_ms: tick period — how often probe futures are checked
            and reissued.
        suspect_after: consecutive misses before SUSPECT.
        dead_after: consecutive misses before DEAD.
        timeout_ms: how long an unanswered probe may stay in flight
            before each further tick counts a miss; None = one interval.
    """

    interval_ms: int = 1000
    suspect_after: int = 2
    dead_after: int = 5
    timeout_ms: Optional[int] = None

    def __post_init__(self) -> None:
        if self.suspect_after < 1 or self.dead_after < self.suspect_after:
            raise ValueError(
                "need 1 <= suspect_after <= dead_after, got "
                f"suspect_after={self.suspect_after} "
                f"dead_after={self.dead_after}"
            )

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "LivenessConfig":
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in field_names})


def _default_probe(dest_party: str) -> Future:
    from rayfed_tpu_torch.proxy import barriers

    return barriers.send_ping(dest_party)


class LivenessMonitor:
    """Background heartbeat thread producing a per-peer membership view.

    ``probe_fn(dest_party) -> Future`` defaults to pushing a readiness
    ping through the current sender proxy; tests inject a fake to drive
    the state machine without a transport.
    """

    def __init__(
        self,
        peers: Iterable[str],
        config: Optional[LivenessConfig] = None,
        probe_fn: Optional[Callable[[str], Future]] = None,
    ) -> None:
        self._peers = sorted(set(peers))
        self._config = config or LivenessConfig()
        self._probe_fn = probe_fn or _default_probe
        self._lock = threading.Lock()
        self._misses: Dict[str, int] = {p: 0 for p in self._peers}
        self._pending: Dict[str, Future] = {}
        self._issued_at: Dict[str, float] = {}
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Fired exactly once per DEAD transition (the n == dead_after
        # edge), from the tick thread. Elastic membership registers the
        # coordinator's eviction intake here (replaceable single slot);
        # additional subscribers — shm in-flight reclamation, tests —
        # stack via add_on_dead without displacing it.
        self._on_dead: Optional[Callable[[str], None]] = None
        self._on_dead_extra: list = []

    # -- peer set mutation (elastic membership) ------------------------
    def set_on_dead(self, callback: Optional[Callable[[str], None]]) -> None:
        self._on_dead = callback

    def add_on_dead(self, callback: Callable[[str], None]) -> None:
        """Subscribe an ADDITIONAL DEAD-edge callback. Unlike
        :meth:`set_on_dead` (a single slot membership owns), additive
        subscribers accumulate — every one fires, in registration order,
        after the slot callback."""
        self._on_dead_extra.append(callback)

    def add_peer(self, party: str) -> None:
        """Start monitoring ``party`` (admitted mid-run). The monitored
        set is NOT frozen at start: parties added after ``start_monitor``
        show up in ``view()`` and are probed from the next tick."""
        with self._lock:
            if party in self._misses:
                return
            self._misses[party] = 0
            self._peers = sorted(set(self._peers) | {party})
        _m_peer_state.labels(peer=party).set(0)

    def remove_peer(self, party: str) -> None:
        """Stop monitoring ``party`` (left or evicted): its outstanding
        probe is dropped and it vanishes from ``view()``."""
        with self._lock:
            self._misses.pop(party, None)
            self._pending.pop(party, None)
            self._issued_at.pop(party, None)
            self._peers = [p for p in self._peers if p != party]
        _m_peer_state.remove(peer=party)

    # -- state machine (also driven directly by tests via tick()) ------
    def tick(self) -> None:
        """One monitor cycle: settle finished probes, age out stuck ones,
        reissue."""
        timeout_s = (
            self._config.timeout_ms
            if self._config.timeout_ms is not None
            else self._config.interval_ms
        ) / 1000.0
        now = time.monotonic()
        for p in list(self._peers):
            if p not in self._misses:  # removed since the snapshot
                continue
            fut = self._pending.get(p)
            if fut is None:
                self._issue(p)
                continue
            if fut.done():
                del self._pending[p]
                issued = self._issued_at.get(p)
                try:
                    ok = bool(fut.result())
                except BaseException:  # noqa: BLE001 - any failure = miss
                    ok = False
                if ok:
                    # Feed the link-health estimator. The sample is
                    # settle-time minus issue-time, so it overshoots the
                    # true RTT by up to one tick interval — a generous
                    # bias, which is the safe direction for the adaptive
                    # timeouts derived from it. Under link emulation the
                    # shaped delay IS in this sample (probe futures
                    # resolve after the emulated latency), making ping
                    # RTT the emulation-visible health signal.
                    if issued is not None:
                        linkhealth.observe_rtt(p, now - issued)
                    self._hit(p)
                else:
                    linkhealth.observe_loss(p)
                    self._miss(p)
                self._issue(p)
            elif now - self._issued_at[p] > timeout_s:
                # Probe stuck in the transport's own retry loop: each
                # further tick past the budget is a miss, but the probe
                # stays out (one in flight per peer — no pile-up).
                linkhealth.observe_loss(p)
                self._miss(p)

    def _issue(self, p: str) -> None:
        if p not in self._misses:  # removed mid-tick
            return
        try:
            self._pending[p] = self._probe_fn(p)
            self._issued_at[p] = time.monotonic()
        except BaseException as e:  # noqa: BLE001 - sync failure = miss
            logger.debug("liveness probe to %s failed to issue: %r", p, e)
            self._miss(p)

    def _hit(self, p: str) -> None:
        with self._lock:
            if p not in self._misses:
                return
            prev = self._misses[p]
            self._misses[p] = 0
        _m_peer_state.labels(peer=p).set(0)
        if prev >= self._config.suspect_after:
            logger.info("party %s is ALIVE again (was %s)",
                        p, self._state_for(prev))

    def _miss(self, p: str) -> None:
        with self._lock:
            if p not in self._misses:
                return
            self._misses[p] += 1
            n = self._misses[p]
        _m_peer_state.labels(peer=p).set(_STATE_CODE[self._state_for(n)])
        tracing.record("hb", p, "", "", 0, time.perf_counter(), ok=False)
        if n == self._config.suspect_after or n == self._config.dead_after:
            logger.warning(
                "party %s missed %d consecutive heartbeat(s): %s",
                p, n, self._state_for(n),
            )
        if n == self._config.dead_after:
            callbacks = (
                [self._on_dead] if self._on_dead is not None else []
            ) + list(self._on_dead_extra)
            for cb in callbacks:
                try:
                    cb(p)
                except Exception:  # noqa: BLE001 - must not kill ticks
                    logger.warning("liveness on-dead callback failed",
                                   exc_info=True)

    def _state_for(self, misses: int) -> str:
        if misses >= self._config.dead_after:
            return DEAD
        if misses >= self._config.suspect_after:
            return SUSPECT
        return ALIVE

    # -- queries -------------------------------------------------------
    def state(self, party: str) -> str:
        with self._lock:
            return self._state_for(self._misses.get(party, 0))

    def view(self) -> Dict[str, str]:
        with self._lock:
            return {p: self._state_for(n) for p, n in self._misses.items()}

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="fedtpu-liveness", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        interval_s = self._config.interval_ms / 1000.0
        while not self._stop_evt.wait(interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - monitor must not die
                logger.warning("liveness tick failed", exc_info=True)

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None


# -- per-job monitor slot wired by fed.init ---------------------------

from rayfed_tpu_torch.tenancy.context import JobScoped

_monitors: "JobScoped[LivenessMonitor]" = JobScoped("liveness.monitor")


def start_monitor(
    peers: Iterable[str],
    config: Optional[LivenessConfig] = None,
    probe_fn: Optional[Callable[[str], Future]] = None,
) -> LivenessMonitor:
    old = _monitors.peek()
    if old is not None:
        old.stop()
    monitor = LivenessMonitor(peers, config, probe_fn)
    _monitors.set(monitor)
    monitor.start()
    return monitor


def stop_monitor() -> None:
    monitor = _monitors.pop()
    if monitor is not None:
        monitor.stop()


def get_monitor() -> Optional[LivenessMonitor]:
    return _monitors.peek()


def liveness_view() -> Dict[str, str]:
    """Current job's membership view, or {} when no monitor runs."""
    monitor = _monitors.peek()
    return {} if monitor is None else monitor.view()


def party_state(party: str) -> str:
    """A party's liveness state; ALIVE when no monitor is running (no
    evidence of death = optimistic default, matching the engine's
    behavior before this subsystem existed)."""
    monitor = _monitors.peek()
    return ALIVE if monitor is None else monitor.state(party)


def state_weight(state: Optional[str], suspect_factor: float = 1.0) -> float:
    """Multiplicative aggregation weight for a liveness verdict: ALIVE
    (or no verdict) 1.0, SUSPECT ``suspect_factor``, DEAD 0.0. The async
    buffered aggregator applies this on every offer — a SUSPECT party's
    contribution is down-weighted rather than dropped (its heartbeats
    may just be delayed with its data), while DEAD contributions carry
    zero weight and are excluded from the buffer outright."""
    if state == DEAD:
        return 0.0
    if state == SUSPECT:
        return float(suspect_factor)
    return 1.0
