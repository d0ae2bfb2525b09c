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

"""FedSanitizer: opt-in runtime invariant probes (``FEDTPU_SANITIZE=1``).

The TSan/ASan shape applied to the federation planes: cheap checks
compiled out by a single flag test, installed at seams that already
exist, each trip raising :class:`SanitizerError` naming the violated
invariant and incrementing ``fed_sanitizer_trips_total{check}``. The
probe catalog (see ``docs/sanitizer.md`` for the contract):

``seq-monotonicity``
    ``barriers.send`` must issue non-decreasing downstream seq ids per
    (dest party, epoch) within one process — a regression means two
    in-flight values race for one rendezvous key.
``rendezvous-reoccupation``
    a parked rendezvous key may only be overwritten by a frame from the
    same source party (the error-envelope substitution path); a
    different source re-occupying a live key is corruption.
``shm-use-after-release`` / ``shm-double-release``
    ring chunks must be adopted exactly once while INFLIGHT and
    released exactly once.
``reactor-thread-affinity``
    handler state (``_pump``/``on_flushed``) is loop-thread-only.
``inline-busy-ownership``
    the lane's ``_inline_busy`` gate must be cleared by the same thread
    that set it.
``crc-retransmit-idempotence``
    a frame NACKed for a crc mismatch must be retransmitted from the
    sender's clean stored buffers — the same frame key failing
    verification repeatedly means the retransmit path re-sends
    corrupted bytes.
``tenant-bleed``
    an shm chunk's in-payload job tag, its descriptor's job field and
    the carrying frame's header job id must all agree at adoption — a
    disagreement means one tenant's bytes were about to be delivered
    into another tenant's rendezvous namespace.

The JAX package's ``donation-aliasing`` probe (deleted jax buffers in a
``fed.get`` result) has no torch meaning and is left out: the capture at
resolution (``proxy/barriers._host_snapshot``) guards the same hazard.

Every probe body begins with the enabled test, so the disabled cost is
one module-global read per seam (the overhead contract in
``tools/sanitize_check.py`` gates the *enabled* cost at
``FEDTPU_SANITIZE_BUDGET_PCT``, default 10%, over baseline).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

__all__ = [
    "SanitizerError",
    "enabled",
    "enable",
    "disable",
    "reset",
    "trips",
]


class SanitizerError(RuntimeError):
    """A FedSanitizer invariant tripped; the message names the check."""

    def __init__(self, check: str, detail: str):
        super().__init__(f"FedSanitizer [{check}]: {detail}")
        self.check = check


_enabled = os.environ.get("FEDTPU_SANITIZE") == "1"  # fedlint: disable=global-mutable-singleton (sanitizer's own switch; per-process by definition)

_state_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the sanitizer's own per-process probe state)
#: (dest party, epoch) -> last downstream seq id sent.
_send_seq: Dict[Tuple[str, Optional[int]], int] = {}  # fedlint: disable=global-mutable-singleton (sanitizer probe state, reset() clears)
#: lane id -> thread ident that set _inline_busy.
_inline_owner: Dict[int, int] = {}  # fedlint: disable=global-mutable-singleton (sanitizer probe state, reset() clears)
#: frame key -> crc verification failure count.
_crc_nacks: Dict[Tuple, int] = {}  # fedlint: disable=global-mutable-singleton (sanitizer probe state, reset() clears)
#: check name -> trip count (mirrors the telemetry counter for tests).
_trips: Dict[str, int] = {}  # fedlint: disable=global-mutable-singleton (sanitizer probe state, reset() clears)


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Test hook: turn probes on for this process."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Test hook: turn probes off (state is kept; see :func:`reset`)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear all probe state and trip counts (between tests, and by
    ``fed.shutdown`` so one job's tail can't trip the next job)."""
    with _state_lock:
        _send_seq.clear()
        _inline_owner.clear()
        _crc_nacks.clear()
        _trips.clear()


def trips() -> Dict[str, int]:
    """Trip counts by check name (empty when nothing tripped)."""
    with _state_lock:
        return dict(_trips)


def _trip(check: str, detail: str) -> None:
    with _state_lock:
        _trips[check] = _trips.get(check, 0) + 1
    try:
        from rayfed_tpu_torch.telemetry.metrics import get_registry

        get_registry().counter(
            "fed_sanitizer_trips_total",
            "FedSanitizer invariant trips by check name.",
            labels=("check",),
        ).labels(check=check).inc()
    except Exception:  # noqa: BLE001 - telemetry must never mask the trip
        pass
    raise SanitizerError(check, detail)


# ----------------------------------------------------------------------
# probes (each one: cheap, enabled-gated, raises on violation)
# ----------------------------------------------------------------------

def probe_send_seq(
    dest_party: str, downstream_seq_id: int, epoch: Optional[int]
) -> None:
    """``seq-monotonicity``: barriers.send's downstream ids per (dest,
    epoch) never regress within a process (equal is legal — one consumer
    task pulls several args)."""
    if not _enabled:
        return
    key = (dest_party, epoch)
    with _state_lock:
        last = _send_seq.get(key)
        if last is not None and downstream_seq_id < last:
            pass  # fall through to trip outside the lock
        else:
            _send_seq[key] = downstream_seq_id
            return
    _trip(
        "seq-monotonicity",
        f"send to {dest_party!r} (epoch {epoch}) carries downstream seq "
        f"{downstream_seq_id} after {last} was already sent: two "
        f"in-flight values race for one rendezvous key",
    )


def probe_rendezvous_reoccupation(
    key: Tuple[str, str], parked_src: object, new_src: object
) -> None:
    """``rendezvous-reoccupation``: a parked key may only be replaced by
    a frame from the same source party (error-envelope substitution)."""
    if not _enabled:
        return
    if parked_src == new_src:
        return
    _trip(
        "rendezvous-reoccupation",
        f"rendezvous key {key} parked by src {parked_src!r} re-occupied "
        f"by src {new_src!r}: two senders collided on one edge",
    )


def probe_shm_adopt(state: int, inflight_state: int, off: int) -> None:
    """``shm-use-after-release``: adopting a chunk that is not INFLIGHT
    is a double-adopt or use-after-release."""
    if not _enabled:
        return
    if state == inflight_state:
        return
    _trip(
        "shm-use-after-release",
        f"shm chunk at offset {off} adopted while in state {state} "
        f"(not INFLIGHT): double-adopt or use-after-release",
    )


def probe_shm_cancel(state: int, inflight_state: int, off: int) -> None:
    """``shm-double-release``: cancelling an already-released chunk."""
    if not _enabled:
        return
    if state == inflight_state:
        return
    _trip(
        "shm-double-release",
        f"shm chunk at offset {off} cancelled while in state {state} "
        f"(not INFLIGHT): double release",
    )


def probe_reactor_affinity(loop_thread: threading.Thread, what: str) -> None:
    """``reactor-thread-affinity``: handler state is loop-thread-only."""
    if not _enabled:
        return
    current = threading.current_thread()
    if current is loop_thread:
        return
    _trip(
        "reactor-thread-affinity",
        f"{what} executed on thread {current.name!r}; handler state "
        f"belongs to reactor loop thread "
        f"{getattr(loop_thread, 'name', loop_thread)!r}",
    )


def probe_inline_busy_set(lane_id: int) -> None:
    """``inline-busy-ownership`` (set half): record the gate owner."""
    if not _enabled:
        return
    ident = threading.get_ident()
    with _state_lock:
        prev = _inline_owner.get(lane_id)
        if prev is None:
            _inline_owner[lane_id] = ident
            return
    _trip(
        "inline-busy-ownership",
        f"lane {lane_id:#x} _inline_busy set by thread {ident} while "
        f"already owned by thread {prev}: two inline sends overlapped",
    )


def probe_inline_busy_clear(lane_id: int) -> None:
    """``inline-busy-ownership`` (clear half): the setter must clear."""
    if not _enabled:
        return
    ident = threading.get_ident()
    with _state_lock:
        prev = _inline_owner.pop(lane_id, None)
        if prev is None or prev == ident:
            return
    _trip(
        "inline-busy-ownership",
        f"lane {lane_id:#x} _inline_busy cleared by thread {ident} but "
        f"was set by thread {prev}: cross-thread gate handoff",
    )


def probe_crc_retransmit(key: Tuple, limit: int = 2) -> None:
    """``crc-retransmit-idempotence``: called on every crc verification
    failure with the frame's (src, up, down) key. A NACKed frame is
    retransmitted from the sender's CLEAN stored buffers, so under the
    single-bit chaos taint one key fails at most once; ``limit`` leaves
    headroom for a genuinely noisy link. More failures than that for the
    SAME key means the retransmit path is re-sending corrupted bytes —
    the stored buffers themselves were mutated."""
    if not _enabled:
        return
    with _state_lock:
        n = _crc_nacks.get(key, 0) + 1
        _crc_nacks[key] = n
        if n <= limit:
            return
    _trip(
        "crc-retransmit-idempotence",
        f"frame {key} failed crc verification {n} times: retransmits "
        f"must carry the sender's clean stored buffers, so repeated "
        f"mismatches on one key mean the stored payload itself is "
        f"corrupted",
    )


def probe_tenant_bleed(
    ring: object, tag: Optional[str], desc_job: Optional[str],
    header_job: Optional[str],
) -> None:
    """``tenant-bleed``: the three job ids riding one shm delivery —
    in-chunk tag, descriptor field, frame header — must agree. Called by
    the adopter just before it NACKs the mismatched chunk (417); with
    the sanitizer on, the NACK becomes a loud trip naming both
    tenants."""
    if not _enabled:
        return
    _trip(
        "tenant-bleed",
        f"shm ring {ring!r} chunk tagged for job {tag!r} offered with "
        f"descriptor job {desc_job!r} and frame-header job {header_job!r}:"
        f" a cross-tenant delivery was blocked at adoption",
    )

