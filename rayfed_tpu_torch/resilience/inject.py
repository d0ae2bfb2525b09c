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

"""Deterministic fault injection at the sender-proxy seam.

A :class:`FaultSchedule` is a seed plus a list of rules; an
:class:`InjectingSenderProxy` wraps ANY transport's sender (tcp/grpc/tpu
— the seam is :class:`~rayfed_tpu_torch.proxy.base.SenderProxy`) and applies
the schedule to each outbound frame. Every per-frame decision is a pure
function of ``sha256(seed, rule_index, src, dst, upstream_seq_id,
downstream_seq_id)`` — and, in the multi-controller model, seq ids are
monotonic integers generated in identical program order on every party —
so a chaos run replays bit-for-bit: same seed, same faults, same trace.

Fault kinds (rule ``fault`` key):

- ``drop``       — the send future fails with :class:`InjectedFault`;
  the frame never reaches the wire.
- ``delay``      — the frame is forwarded after a deterministic pause in
  ``[0, max_delay_ms]``.
- ``duplicate``  — the frame is forwarded twice (the receiver's
  rendezvous dedup must absorb it).
- ``corrupt``    — numpy-array and torch-tensor leaves get one
  deterministically chosen bit flipped before forwarding.
- ``partition``  — one-way src→dst blackhole: every send (pings
  included, by default) fails while the dst's data-send index is inside
  ``[after, after + for)``.
- ``crash``      — the party stops transmitting: after ``after`` total
  data sends, every outbound send fails forever.

Probabilistic rules (drop/delay/duplicate/corrupt) skip readiness/
liveness pings by default — faulting the handshake probabilistically
makes startup timing-dependent; structural rules (partition/crash)
include pings by default, because a partitioned link drops heartbeats
too (that is exactly how the liveness monitor is meant to find out).
Either default is overridable per-rule with ``"pings": true/false``.

Window positions (``after``/``for``) are counted on the per-destination
DATA-send index, never on pings: ping counts depend on barrier timing
and would make replays diverge. The telemetry agent's pushes (``tel:``
seq ids) are timed the same way and follow the ping rules throughout
(the JAX package counts them as data frames, so a job with telemetry on
replays its trace only by chance there). Probabilistic rules honor the same
window: ``{"fault": "corrupt", "prob": 1.0, "after": 8, "for": 2}`` is
a mid-job corrupt burst hitting exactly data sends 8 and 9.

**Link emulation** (netem-style, PR 17): a schedule may also carry
``links`` — a list of :class:`LinkProfile` shaping rules (per-edge
``latency_ms`` ± ``jitter_ms``, token-bucket ``rate_mbit`` pacing,
probabilistic ``loss`` and ``reorder``). Shaping composes with the
discrete rules: EVERY matching profile contributes delay (it's a pipe,
not a lottery), applied on top of whatever discrete fault fired. Unlike
``drop``, ``loss`` never destroys a frame — a lossy link under TCP
retransmits, so loss manifests as a deterministic RTO-shaped extra
delay; likewise ``reorder`` is extra delay on the chosen frame so later
frames overtake it. Shaping changes *timing only*, never payload bytes
or the fault trace, so the bit-for-bit replay contract of the discrete
schedule is untouched — a 50ms/100Mbit WAN is just a config key::

    "fault_schedule": {"seed": 7, "links": [
        {"latency_ms": 50, "jitter_ms": 20, "rate_mbit": 100, "loss": 0.01}
    ]}

Injected faults are recorded as ``ok=False`` spans of kind ``"fault"``
in :mod:`rayfed_tpu_torch.tracing` and appended to an in-order trace queryable
via :func:`fault_trace` (data frames only — ping faults are counted but
not traced, again for determinism).

Stdlib at module scope (numpy and torch load where a leaf is walked);
no transport imports at module scope.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from rayfed_tpu_torch import tracing
from rayfed_tpu_torch._private.constants import PING_SEQ_ID
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

#: The seq-id prefix of the telemetry agent's pushes
#: (``proxy/rendezvous.TELEMETRY_SEQ_PREFIX``).
_TELEMETRY_SEQ_PREFIX = "tel:"

_m_injected = telemetry_metrics.get_registry().counter(
    "fed_resilience_injected_faults_total",
    "Faults injected by the active schedule, by fault kind.",
    labels=("fault",),
)

_m_shaping = telemetry_metrics.get_registry().counter(
    "fed_resilience_link_shaping_total",
    "Link-shaping events applied by the active schedule, by kind.",
    labels=("kind",),
)

FAULT_KINDS = ("drop", "delay", "duplicate", "corrupt", "partition", "crash")

# Probabilistic faults default to data frames only; structural faults
# (a cut link, a dead process) hit pings too.
_PING_DEFAULT = {"partition": True, "crash": True}


class InjectedFault(ConnectionError):
    """A send failure manufactured by the fault-injection layer.

    Subclasses ``ConnectionError`` so every existing failure path —
    retry exhaustion handling, sending-failure handlers, degraded-mode
    ``on_missing`` classification — treats it exactly like a real
    transport failure."""


@dataclasses.dataclass
class FaultRule:
    """One line of a fault schedule. Unknown dict keys are rejected
    loudly — a typo'd ``"porb"`` silently matching nothing would make a
    chaos suite vacuously green."""

    fault: str
    src: Optional[str] = None        # match sender party; None = any
    dst: Optional[str] = None        # match destination; None = any
    prob: float = 1.0                # drop/delay/duplicate/corrupt
    max_delay_ms: int = 100          # delay
    after: int = 0                   # window start (all kinds)
    duration: Optional[int] = None   # window length; None = forever
    pings: Optional[bool] = None     # None = per-fault default
    _ALIASES = {"for": "duration"}

    def __post_init__(self) -> None:
        if self.fault not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.fault!r}; expected one of "
                f"{FAULT_KINDS}"
            )
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FaultRule":
        norm = {cls._ALIASES.get(k, k): v for k, v in data.items()}
        field_names = {
            f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")
        }
        unknown = set(norm) - field_names
        if unknown:
            raise ValueError(
                f"unknown fault-rule key(s) {sorted(unknown)}; valid keys: "
                f"{sorted(field_names | set(cls._ALIASES))}"
            )
        return cls(**norm)

    def applies_to_pings(self) -> bool:
        if self.pings is not None:
            return self.pings
        return _PING_DEFAULT.get(self.fault, False)


@dataclasses.dataclass
class LinkProfile:
    """One netem-style link-shaping rule (see module docstring). All
    matching profiles compose additively — serial pipes, not
    first-match. Shaping affects timing only; payload bytes and the
    fault trace are untouched.

    - ``latency_ms`` ± ``jitter_ms`` — one-way propagation delay per
      frame; jitter is a seeded uniform offset in [-jitter, +jitter].
    - ``rate_mbit`` — token-bucket pacing: each data frame occupies the
      link for payload_bytes/rate, queueing behind earlier frames.
    - ``loss`` — probability a frame "needs a TCP retransmit": adds a
      deterministic RTO-shaped delay max(3*latency, 200ms). Never drops.
    - ``reorder`` — probability a frame is overtaken: adds
      max(2*latency, 20ms) so later frames land first.
    - ``src``/``dst`` — edge match, None = any (same as FaultRule).
    - ``pings`` — shaping applies to liveness/readiness pings too by
      default: latency is a property of the link, and the ping RTTs are
      exactly how the LinkHealth estimator learns it.
    """

    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    rate_mbit: Optional[float] = None
    loss: float = 0.0
    reorder: float = 0.0
    src: Optional[str] = None
    dst: Optional[str] = None
    pings: bool = True

    def __post_init__(self) -> None:
        if not 0.0 <= self.loss <= 1.0:
            raise ValueError(f"loss must be in [0, 1], got {self.loss}")
        if not 0.0 <= self.reorder <= 1.0:
            raise ValueError(f"reorder must be in [0, 1], got {self.reorder}")
        if self.rate_mbit is not None and self.rate_mbit <= 0:
            raise ValueError(f"rate_mbit must be > 0, got {self.rate_mbit}")
        if self.latency_ms < 0 or self.jitter_ms < 0:
            raise ValueError("latency_ms/jitter_ms must be >= 0")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "LinkProfile":
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - field_names
        if unknown:
            raise ValueError(
                f"unknown link-profile key(s) {sorted(unknown)}; valid "
                f"keys: {sorted(field_names)}"
            )
        return cls(**data)


@dataclasses.dataclass
class FaultSchedule:
    """A seed plus an ordered rule list. The first matching rule that
    fires wins for a given frame (drop beats delay beats duplicate only
    by list order — put the severe ones first). ``links`` shaping
    profiles are evaluated separately and ALL matching profiles apply
    (see :class:`LinkProfile`)."""

    seed: int = 0
    rules: List[FaultRule] = dataclasses.field(default_factory=list)
    links: List[LinkProfile] = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "FaultSchedule":
        data = data or {}
        rules = [
            r if isinstance(r, FaultRule) else FaultRule.from_dict(r)
            for r in data.get("rules", [])
        ]
        links = [
            l if isinstance(l, LinkProfile) else LinkProfile.from_dict(l)
            for l in data.get("links", [])
        ]
        return cls(seed=int(data.get("seed", 0)), rules=rules, links=links)


def _u01(seed: int, rule_idx: int, src: str, dst: str, up, down) -> float:
    """Uniform [0, 1) decision value, a pure function of the frame key."""
    h = hashlib.sha256(
        f"{seed}|{rule_idx}|{src}|{dst}|{up}|{down}".encode()
    ).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def _flip_bit_index(nbytes: int, seed: int, src: str, dst: str, up, down,
                    path: str) -> int:
    """The bit a ``corrupt`` fault flips in a leaf of ``nbytes`` bytes: a
    pure function of the frame key and the leaf's path."""
    h = hashlib.sha256(
        f"corrupt|{seed}|{src}|{dst}|{up}|{down}|{path}".encode()
    ).digest()
    return int.from_bytes(h[:8], "big") % (nbytes * 8)


def _corrupt_value(value, seed: int, src: str, dst: str, up, down):
    """Flip one deterministically chosen bit in each numpy-array or torch
    tensor leaf of ``value`` (containers walked structurally; non-array
    leaves pass through — pickle-lane corruption would just be a decode
    error, the interesting case is a silently wrong tensor). A tensor
    and an ndarray with the same bytes at the same path get the same
    bit; a tensor's corrupted copy stays on its device. The JAX package
    flips numpy leaves only (ROADMAP Queue 3's divergence)."""
    import numpy as np
    import torch

    def walk(x, path: str):
        if isinstance(x, np.ndarray) and x.size and x.dtype != object:
            flat = bytearray(np.ascontiguousarray(x).tobytes())
            bit = _flip_bit_index(len(flat), seed, src, dst, up, down, path)
            flat[bit // 8] ^= 1 << (bit % 8)
            return np.frombuffer(bytes(flat), dtype=x.dtype).reshape(x.shape)
        if isinstance(x, torch.Tensor) and x.numel():
            flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
            flat = flat.clone()
            bit = _flip_bit_index(flat.numel(), seed, src, dst, up, down,
                                  path)
            flat[bit // 8:bit // 8 + 1].bitwise_xor_(1 << (bit % 8))
            return flat.view(x.dtype).reshape(x.shape)
        if isinstance(x, dict):
            return {k: walk(v, f"{path}.{k}") for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = [walk(v, f"{path}[{i}]") for i, v in enumerate(x)]
            return type(x)(out) if isinstance(x, tuple) else out
        return x

    return walk(value, "$")


def _estimate_nbytes(value) -> int:
    """Rough wire size of ``value`` for token-bucket pacing: the
    injector sits upstream of serialization, so sum ndarray and tensor
    payloads (the dominant bytes) with a small constant per non-array
    leaf."""
    import numpy as np
    import torch

    total = 0

    def walk(x) -> None:
        nonlocal total
        if isinstance(x, (np.ndarray, torch.Tensor)):
            total += int(x.nbytes)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            total += 64

    if isinstance(value, Future):
        return 1024
    walk(value)
    return max(total, 256)


# -- wire-taint registry (corrupt fault × frame CRC) -------------------
#
# The injector corrupts VALUES (pre-serialization). With frame CRC
# enabled that would be useless for testing integrity: the checksum is
# computed over the already-corrupted wire bytes and verifies cleanly.
# So when the destination lane has frame_crc on, the corrupt fault
# instead registers a "wire taint" for the frame's key and forwards the
# value CLEAN; the transport consumes the taint at wire-write time and
# flips one bit in a COPY of the payload of the FIRST transmission
# only. The receiver's CRC check NACKs it, and the resend machinery
# retransmits the pristine buffers — turning corrupt from a poisoned
# cloudpickle into a recovered retransmit.

_taint_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the taint registry below)
_wire_taints: Dict[Tuple[str, str, str], int] = {}  # fedlint: disable=global-mutable-singleton (pending wire taints; reset hook: reset_wire_taints)


def register_wire_taint(dst: str, up, down, seed: int) -> None:
    with _taint_lock:
        _wire_taints[(dst, str(up), str(down))] = seed


def take_wire_taint(dst: str, up, down) -> Optional[int]:
    """Pop the taint for this frame key, or None. Popping (not peeking)
    is what makes the retransmit clean."""
    if not _wire_taints:  # hot-path fast exit: no chaos run active
        return None
    with _taint_lock:
        return _wire_taints.pop((dst, str(up), str(down)), None)


def reset_wire_taints() -> None:
    with _taint_lock:
        _wire_taints.clear()


def corrupt_wire_buffers(buffers, dst: str, up, down, seed: int):
    """Return ``buffers`` with one deterministically chosen bit flipped
    in a COPY of the buffer that holds it; the originals (which the
    lane keeps for resend) are never modified."""
    sizes = [memoryview(b).nbytes for b in buffers]
    total_bits = sum(sizes) * 8
    if total_bits == 0:
        return buffers
    h = hashlib.sha256(
        f"wiretaint|{seed}|{dst}|{up}|{down}".encode()
    ).digest()
    bit = int.from_bytes(h[:8], "big") % total_bits
    byte_off = bit // 8
    out = list(buffers)
    for i, size in enumerate(sizes):
        if byte_off < size:
            flipped = bytearray(out[i])
            flipped[byte_off] ^= 1 << (bit % 8)
            out[i] = bytes(flipped)
            break
        byte_off -= size
    return out


class InjectingSenderProxy:
    """Wraps an inner :class:`~rayfed_tpu_torch.proxy.base.SenderProxy` (or the
    sender half of a SenderReceiverProxy) and applies a
    :class:`FaultSchedule` to every outbound frame. Transparent for
    everything else: attribute access falls through to the inner proxy,
    so per-dest config lookups (``get_proxy_config``), stats, and
    ``stop`` keep working."""

    def __init__(self, inner, schedule: FaultSchedule, party: str) -> None:
        self._inner = inner
        self._schedule = schedule
        self._party = party
        self._lock = threading.Lock()
        self._data_idx: Dict[str, int] = {}   # per-dest data-send index
        self._total_data_sends = 0
        self._trace: List[Dict[str, Any]] = []
        self._ping_faults = 0
        self._crashed = False
        # Link-shaping state: per-edge token bucket (when each pipe
        # drains), per-dest ping counter (jitter salt for pings), and
        # event counters mirrored into get_stats().
        self._shape_lock = threading.Lock()
        self._link_free_at: Dict[str, float] = {}
        self._ping_idx: Dict[str, int] = {}
        self._shape_events: Dict[str, int] = {
            "latency": 0, "loss": 0, "reorder": 0, "paced_bytes": 0,
        }

    # -- delegation ---------------------------------------------------
    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    @property
    def inner(self):
        return self._inner

    def start(self) -> None:
        self._inner.start()

    def stop(self) -> None:
        self._inner.stop()

    def get_stats(self) -> Dict:
        stats = dict(self._inner.get_stats())
        with self._lock:
            stats["injected_faults"] = len(self._trace) + self._ping_faults
        stats["link_shaping"] = self.link_stats()
        return stats

    def link_stats(self) -> Dict[str, int]:
        """Shaping event counters: latency/loss/reorder events applied
        and total token-bucket paced bytes. Timing-only — absent from
        :func:`fault_trace` by design."""
        with self._shape_lock:
            return dict(self._shape_events)

    # -- the interesting part -----------------------------------------
    def send(
        self,
        dest_party: str,
        data,
        upstream_seq_id,
        downstream_seq_id,
        is_error: bool = False,
    ) -> Future:
        # Telemetry pushes follow the ping rules: like heartbeats they go
        # out on the agent's clock, not in program order, so counting them
        # as data frames would make same-seed fault traces diverge.
        is_ping = (
            upstream_seq_id == PING_SEQ_ID
            and downstream_seq_id == PING_SEQ_ID
        ) or str(upstream_seq_id).startswith(_TELEMETRY_SEQ_PREFIX)
        with self._lock:
            idx = self._data_idx.get(dest_party, 0)
            if is_ping:
                ping_idx = self._ping_idx.get(dest_party, 0)
                self._ping_idx[dest_party] = ping_idx + 1
            else:
                ping_idx = 0
                self._data_idx[dest_party] = idx + 1
                self._total_data_sends += 1
            total = self._total_data_sends
        decision = self._decide(
            dest_party, upstream_seq_id, downstream_seq_id, is_ping, idx, total
        )
        rule: Optional[FaultRule] = None
        delay_s = 0.0
        if decision is not None:
            rule_idx, rule, delay_s = decision
            self._record(
                rule, rule_idx, dest_party, upstream_seq_id,
                downstream_seq_id, is_ping,
            )
            if rule.fault in ("drop", "partition", "crash"):
                fut: Future = Future()
                fut.set_exception(InjectedFault(
                    f"injected {rule.fault}: {self._party}->{dest_party} "
                    f"({upstream_seq_id}, {downstream_seq_id})"
                ))
                return fut
            if rule.fault == "corrupt":
                if self._frame_crc_enabled(dest_party):
                    # CRC lane: taint the wire bytes of the FIRST
                    # transmission instead of the value, so the NACKed
                    # frame retransmits clean (see wire-taint registry).
                    register_wire_taint(
                        dest_party, upstream_seq_id, downstream_seq_id,
                        self._schedule.seed,
                    )
                else:
                    data = self._corrupt(
                        data, dest_party, upstream_seq_id, downstream_seq_id
                    )
        # Link shaping composes with whatever discrete fault survived.
        shape_s = self._shape_delay(
            dest_party, upstream_seq_id, downstream_seq_id, is_ping,
            ping_idx, _estimate_nbytes(data),
        )

        def forward() -> Future:
            if rule is not None and rule.fault == "duplicate":
                self._inner.send(
                    dest_party, data, upstream_seq_id, downstream_seq_id,
                    is_error=is_error,
                )
            return self._inner.send(
                dest_party, data, upstream_seq_id, downstream_seq_id,
                is_error=is_error,
            )

        total_delay_s = delay_s + shape_s
        if total_delay_s <= 0.0:
            return forward()
        # Forward from a timer thread; chain the real send's completion
        # into the future the caller already holds.
        out: Future = Future()

        def fire() -> None:
            try:
                real = forward()
            except BaseException as e:  # noqa: BLE001 - surfaced to drain
                out.set_exception(e)
                return

            def chain(f: Future) -> None:
                err = f.exception()
                if err is not None:
                    out.set_exception(err)
                else:
                    out.set_result(f.result())

            real.add_done_callback(chain)

        timer = threading.Timer(total_delay_s, fire)
        timer.daemon = True
        timer.start()
        return out

    def _frame_crc_enabled(self, dest: str) -> bool:
        get_cfg = getattr(self._inner, "get_proxy_config", None)
        if get_cfg is None:
            return False
        try:
            cfg = get_cfg(dest)
        except TypeError:
            try:
                cfg = get_cfg()
            except Exception:  # noqa: BLE001
                return False
        except Exception:  # noqa: BLE001
            return False
        return bool(getattr(cfg, "frame_crc", False))

    def _shape_delay(
        self, dst: str, up, down, is_ping: bool, ping_idx: int, nbytes: int
    ) -> float:
        """Total shaping delay (seconds) from ALL matching LinkProfiles.
        Deterministic per frame key for data frames; pings salt their
        jitter with a per-dest ping counter (ping shaping is untraced,
        so replay fidelity is unaffected)."""
        links = self._schedule.links
        if not links:
            return 0.0
        seed = self._schedule.seed
        s_up = f"ping{ping_idx}" if is_ping else up
        total = 0.0
        lat_n = loss_n = reorder_n = 0
        paced = 0
        for i, lp in enumerate(links):
            if lp.src is not None and lp.src != self._party:
                continue
            if lp.dst is not None and lp.dst != dst:
                continue
            if is_ping and not lp.pings:
                continue
            d_ms = lp.latency_ms
            if lp.jitter_ms:
                frac = _u01(seed, 0x20000 + i, self._party, dst, s_up, down)
                d_ms += lp.jitter_ms * (2.0 * frac - 1.0)
            d_ms = max(0.0, d_ms)
            if d_ms > 0.0:
                lat_n += 1
                _m_shaping.labels(kind="latency").inc()
            if lp.loss:
                u = _u01(seed, 0x30000 + i, self._party, dst, s_up, down)
                if u < lp.loss:
                    # A lossy link under TCP retransmits: RTO-shaped
                    # extra delay, never a destroyed frame.
                    d_ms += max(3.0 * lp.latency_ms, 200.0)
                    loss_n += 1
                    _m_shaping.labels(kind="loss").inc()
            if lp.reorder:
                u = _u01(seed, 0x40000 + i, self._party, dst, s_up, down)
                if u < lp.reorder:
                    d_ms += max(2.0 * lp.latency_ms, 20.0)
                    reorder_n += 1
                    _m_shaping.labels(kind="reorder").inc()
            total += d_ms / 1000.0
            if lp.rate_mbit and not is_ping:
                # Token bucket: this frame occupies the pipe for
                # nbytes/rate, queued behind whatever is still draining.
                tx = nbytes / (lp.rate_mbit * 1e6 / 8.0)
                with self._shape_lock:
                    now = time.monotonic()
                    start = max(self._link_free_at.get(dst, 0.0), now)
                    self._link_free_at[dst] = start + tx
                total += (start - now) + tx
                paced += nbytes
        if lat_n or loss_n or reorder_n or paced:
            with self._shape_lock:
                self._shape_events["latency"] += lat_n
                self._shape_events["loss"] += loss_n
                self._shape_events["reorder"] += reorder_n
                self._shape_events["paced_bytes"] += paced
        return total

    def _decide(
        self, dst: str, up, down, is_ping: bool, idx: int, total: int
    ) -> Optional[Tuple[int, FaultRule, float]]:
        """First firing rule for this frame, or None. Returns
        (rule_index, rule, delay_seconds)."""
        for i, rule in enumerate(self._schedule.rules):
            if rule.src is not None and rule.src != self._party:
                continue
            if rule.dst is not None and rule.dst != dst:
                continue
            if is_ping and not rule.applies_to_pings():
                continue
            if rule.fault == "partition":
                end = (
                    None if rule.duration is None
                    else rule.after + rule.duration
                )
                if idx >= rule.after and (end is None or idx < end):
                    return i, rule, 0.0
                continue
            if rule.fault == "crash":
                if self._crashed or total > rule.after:
                    self._crashed = True
                    return i, rule, 0.0
                continue
            # Probabilistic kinds honor the same after/for window as
            # partition, gated on the per-dest data index — that's what
            # makes a mid-job corrupt BURST expressible.
            end = (
                None if rule.duration is None else rule.after + rule.duration
            )
            if idx < rule.after or (end is not None and idx >= end):
                continue
            u = _u01(self._schedule.seed, i, self._party, dst, up, down)
            if u >= rule.prob:
                continue
            if rule.fault == "delay":
                frac = _u01(
                    self._schedule.seed, i + 0x10000, self._party, dst, up,
                    down,
                )
                return i, rule, (rule.max_delay_ms / 1000.0) * frac
            return i, rule, 0.0
        return None

    def _corrupt(self, data, dst: str, up, down):
        seed = self._schedule.seed
        if isinstance(data, Future):
            out: Future = Future()

            def chain(f: Future, o=out) -> None:
                err = f.exception()
                if err is not None:
                    o.set_exception(err)
                    return
                try:
                    o.set_result(
                        _corrupt_value(f.result(), seed, self._party, dst,
                                       up, down)
                    )
                except BaseException as e:  # noqa: BLE001
                    o.set_exception(e)

            data.add_done_callback(chain)
            return out
        return _corrupt_value(data, seed, self._party, dst, up, down)

    def _record(
        self, rule: FaultRule, rule_idx: int, dst: str, up, down,
        is_ping: bool,
    ) -> None:
        tracing.record(
            "fault", dst, str(up), str(down), 0, time.perf_counter(),
            ok=False,
        )
        _m_injected.labels(fault=rule.fault).inc()
        if is_ping:
            # Ping cadence is timing-dependent; tracing ping faults would
            # make same-seed traces diverge between runs.
            with self._lock:
                self._ping_faults += 1
            return
        with self._lock:
            self._trace.append({
                "fault": rule.fault,
                "rule": rule_idx,
                "src": self._party,
                "dst": dst,
                "up": str(up),
                "down": str(down),
            })

    def fault_trace(self) -> List[Dict[str, Any]]:
        """Injected data-frame faults, in send order. Deterministic for a
        fixed (seed, driver program): same seed ⇒ identical list."""
        with self._lock:
            return list(self._trace)


# -- install / uninstall at the barriers seam -------------------------

from rayfed_tpu_torch.tenancy.context import JobScoped

_installed_injectors: "JobScoped[InjectingSenderProxy]" = JobScoped(
    "inject.installed"
)


def install(schedule: FaultSchedule, party: str) -> InjectingSenderProxy:
    """Wrap the current sender proxy (post-``fed.init`` proxy startup)
    in an injector. Idempotent per init: installing twice replaces the
    previous schedule rather than double-wrapping."""
    from rayfed_tpu_torch.proxy import barriers

    inner = barriers.sender_proxy()
    assert inner is not None, "sender proxy not started; call fed.init() first"
    if isinstance(inner, InjectingSenderProxy):
        inner = inner.inner
    injector = InjectingSenderProxy(inner, schedule, party)
    barriers.swap_sender_proxy(injector)
    _installed_injectors.set(injector)
    logger.info(
        "fault injection installed: seed=%d, %d rule(s)",
        schedule.seed, len(schedule.rules),
    )
    return injector


def uninstall() -> None:
    """Unwrap the injector, restoring the real sender proxy. The last
    trace stays readable via :func:`fault_trace` until the next install."""
    from rayfed_tpu_torch.proxy import barriers

    current = barriers.sender_proxy()
    if isinstance(current, InjectingSenderProxy):
        barriers.swap_sender_proxy(current.inner)


def get_injector() -> Optional[InjectingSenderProxy]:
    return _installed_injectors.peek()


def fault_trace() -> List[Dict[str, Any]]:
    """The installed (or most recently installed) injector's data-frame
    fault trace, in send order; [] when injection was never enabled."""
    injector = _installed_injectors.peek()
    return [] if injector is None else injector.fault_trace()
