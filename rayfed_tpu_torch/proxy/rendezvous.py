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

"""Transport-independent (upstream_seq_id, downstream_seq_id) rendezvous.

The core receiver-side data structure shared by every transport backend
(TCP, gRPC, TPU): data may arrive before or after the consumer asks for it,
and whichever side is first parks the state the other completes — the
event-either-side-first pattern of the reference
(``fed/proxy/grpc/grpc_proxy.py:276-283,332-340``), generalized so that the
decode step (and, for the TPU backend, device placement) runs on a worker
pool off the transport's event loop.
"""

from __future__ import annotations

import logging
import threading
import weakref
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

from rayfed_tpu_torch import sanitize, tracing
from rayfed_tpu_torch._private import serialization
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics
from rayfed_tpu_torch._private.constants import (
    CODE_FORBIDDEN,
    CODE_INTERNAL_ERROR,
    CODE_JOB_MISMATCH,
    CODE_OK,
    CODE_PICKLE_FORBIDDEN,
    PING_SEQ_ID,
)

logger = logging.getLogger(__name__)

# decode_fn(header, payload) -> value
DecodeFn = Callable[[Dict, memoryview], object]

#: Reserved control seq-id namespaces. A string upstream seq id starting
#: with one of these is NEVER parked for a consumer: it is dispatched to
#: the handler registered for its (job, prefix), or rejected with
#: ``CODE_FORBIDDEN`` when this party has none — a join request sent to
#: a non-coordinator and a telemetry push sent to a non-collector both
#: earn the same explicit refusal instead of wedging in ``_arrived``.
CONTROL_SEQ_PREFIX = "mbr:req:"    # membership control (membership/protocol.py)
MEMBERSHIP_SEQ_PREFIX = "mbr:"     # stored membership frames (sync, rsp)
TELEMETRY_SEQ_PREFIX = "tel:"      # telemetry agent pushes (telemetry/agent.py)
PRIVACY_SEQ_PREFIX = "prv:"        # privacy plane (privacy/protocol.py)
CONTROL_NAMESPACES: Tuple[str, ...] = (
    CONTROL_SEQ_PREFIX, TELEMETRY_SEQ_PREFIX, PRIVACY_SEQ_PREFIX,
)

# Per-job control/membership hooks. Control handlers are keyed by
# (job_name, seq-id prefix) — membership registers CONTROL_SEQ_PREFIX
# (via the legacy set_control_handler wrapper), the telemetry collector
# registers TELEMETRY_SEQ_PREFIX, and tests may register ad-hoc
# prefixes. handler(header, decoded_value) -> (code, message); the
# verdict rides back in the frame's ack. evicted_fn() -> the membership
# eviction ghost table {party: eviction_epoch} lets the expire loop reap
# parked frames from KNOWN-evicted sources. The sweep is deliberately
# keyed off the eviction table rather than "not in the roster": a fresh
# joiner may legitimately send before a slow member has applied the
# admitting sync, and a roster-complement sweep would reap (and
# tombstone) those frames, wedging the eventual recv.
_control_handlers: Dict[Tuple[str, str], Callable] = {}  # fedlint: disable=global-mutable-singleton (store/hook registries scoped to the proxy lifecycle; stopped with the proxies)
_evicted_fns: Dict[str, Callable[[], Dict[str, int]]] = {}  # fedlint: disable=global-mutable-singleton (store/hook registries scoped to the proxy lifecycle; stopped with the proxies)
_hooks_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (store/hook registries scoped to the proxy lifecycle; stopped with the proxies)

# Every live store, so an epoch bump can purge an evicted party's
# parked frames across all transports/jobs in this process.
_stores: "weakref.WeakSet[RendezvousStore]" = weakref.WeakSet()  # fedlint: disable=global-mutable-singleton (store/hook registries scoped to the proxy lifecycle; stopped with the proxies)


def register_control_prefix(
    job_name: str, prefix: str, handler: Callable
) -> None:
    """Route string seq ids starting with ``prefix`` on ``job_name`` to
    ``handler(header, decoded_value) -> (code, message)`` instead of
    parking them for a consumer."""
    if not prefix or not isinstance(prefix, str):
        raise ValueError("control prefix must be a non-empty string")
    with _hooks_lock:
        _control_handlers[(job_name, prefix)] = handler


def unregister_control_prefix(job_name: str, prefix: str) -> None:
    with _hooks_lock:
        _control_handlers.pop((job_name, prefix), None)


def set_control_handler(job_name: str, handler: Callable) -> None:
    """Back-compat wrapper: membership's ``mbr:req:*`` handler."""
    register_control_prefix(job_name, CONTROL_SEQ_PREFIX, handler)


def clear_control_handler(job_name: str) -> None:
    unregister_control_prefix(job_name, CONTROL_SEQ_PREFIX)


def set_evicted_fn(job_name: str, fn: Callable[[], Dict[str, int]]) -> None:
    with _hooks_lock:
        _evicted_fns[job_name] = fn


def clear_evicted_fn(job_name: str) -> None:
    with _hooks_lock:
        _evicted_fns.pop(job_name, None)


def _seq_epoch_of(seq_id) -> Optional[int]:
    """The epoch stamp of an ``"e<epoch>:<n>"`` seq id, or None for
    unstamped ids (pre-membership integers, string control keys)."""
    if isinstance(seq_id, str) and seq_id.startswith("e"):
        head, sep, _ = seq_id.partition(":")
        if sep and head[1:].isdigit():
            return int(head[1:])
    return None


def evict_source_everywhere(job_name: str, party: str) -> int:
    """Purge ``party``'s parked frames from every live store serving
    ``job_name`` (the membership manager calls this when an epoch bump
    evicts the party). Returns the number of entries evicted."""
    n = 0
    for store in list(_stores):
        if store._job_name == job_name:
            n += store.evict_source(party)
    return n


def default_decode(allowed_list, allow_pickle: bool = True, sharded_fn=None,
                   max_decompressed_bytes: Optional[int] = None):
    def decode(header: Dict, payload) -> object:
        comp = header.get("comp")
        if comp:
            # Bomb-guarded inflate: bounded by the configured payload cap
            # and the header's declared rawlen before any full-size
            # allocation.
            payload = serialization.decompress_payload(
                payload, comp, int(header.get("rawlen", -1)),
                max_decompressed_bytes,
            )
        effective = allowed_list
        if not allow_pickle and header.get("pkind") == "pickle":
            # Strict mode: the only pickle frames that reach decode are
            # error envelopes (offer() 415s the rest) — and an attacker
            # could stamp is_error on anything, so they decode under the
            # empty whitelist (FedRemoteError + builtin exception types
            # only), never the unrestricted loader.
            effective = {}
        return serialization.decode_payload(
            header["pkind"], header.get("pmeta", b""), payload, effective,
            sharded_fn=sharded_fn,
        )

    return decode


class StripeAssembler:
    """Reassembles striped bulk frames in front of a rendezvous offer.

    The multi-stream sender splits one large ``tree`` payload into K
    ``stripe`` frames shipped over K parallel connections (possibly
    serviced by different reactor threads, in any order). This wrapper
    buffers stripes per (job, src, up, down) edge and, when the last one
    lands, re-offers the reassembled payload — as a
    :class:`serialization.SegmentedPayload` whose segments stay
    leaf/shard-aligned — under the original pkind/pmeta. Non-stripe
    frames pass straight through.

    Ack semantics: every non-completing stripe is acked OK on arrival
    (its bytes are safely buffered); the COMPLETING stripe's ack carries
    the store's real verdict, so a store-side rejection fails exactly
    one sender-side stripe future and with it the send. Duplicate
    stripes (PR 6 ack-lost resends) are acked OK and dropped, matching
    the store's consumed-dedup behavior.
    """

    # Bounds concurrent half-assembled groups (and with them the bytes a
    # misbehaving peer can park here): the sender stripes one payload per
    # edge at a time, so double digits is already generous.
    _MAX_GROUPS = 256

    def __init__(self, offer, max_payload_bytes: Optional[int] = None):
        self._offer = offer
        self._max_payload_bytes = max_payload_bytes
        self._lock = threading.Lock()
        self._groups: Dict[tuple, Dict] = {}
        self._done: "OrderedDict[tuple, None]" = OrderedDict()
        self._done_cap = 4096

    @staticmethod
    def _validate_sd(sd) -> Optional[str]:
        if not isinstance(sd, dict):
            return "stripe frame missing its descriptor"
        for field in ("i", "n", "off", "tot"):
            if not isinstance(sd.get(field), int):
                return f"stripe descriptor field {field!r} missing/not int"
        if not 2 <= sd["n"] <= 64:
            return f"stripe count {sd['n']} out of range [2, 64]"
        if not 0 <= sd["i"] < sd["n"]:
            return f"stripe index {sd['i']} out of range"
        if sd["off"] < 0 or sd["tot"] <= 0 or sd["off"] >= sd["tot"]:
            return "stripe offsets inconsistent"
        return None

    def offer(self, header: Dict, payload) -> Tuple[int, str]:
        if header.get("pkind") != "stripe":
            return self._offer(header, payload)
        sd = header.get("sd")
        err = self._validate_sd(sd)
        if err is not None:
            return CODE_INTERNAL_ERROR, err
        nbytes = serialization.payload_nbytes(payload)
        if sd["off"] + nbytes > sd["tot"]:
            return CODE_INTERNAL_ERROR, "stripe overruns its declared total"
        if (
            self._max_payload_bytes is not None
            and sd["tot"] > self._max_payload_bytes
        ):
            return (
                CODE_INTERNAL_ERROR,
                f"striped payload declares {sd['tot']} bytes, exceeding "
                f"limit {self._max_payload_bytes}",
            )
        key = (
            header.get("job"), header.get("src"),
            header.get("up"), header.get("down"),
        )
        with self._lock:
            if key in self._done:
                return CODE_OK, "duplicate stripe group"
            st = self._groups.get(key)
            if st is None:
                if len(self._groups) >= self._MAX_GROUPS:
                    return (
                        CODE_INTERNAL_ERROR,
                        "too many half-assembled stripe groups",
                    )
                st = self._groups[key] = {
                    "n": sd["n"], "tot": sd["tot"], "have": {},
                    "pk": None, "pm": b"",
                }
            if sd["n"] != st["n"] or sd["tot"] != st["tot"]:
                return (
                    CODE_INTERNAL_ERROR,
                    "stripe descriptor disagrees within its group",
                )
            if sd["i"] in st["have"]:
                return CODE_OK, "duplicate stripe"
            st["have"][sd["i"]] = (sd["off"], payload)
            if sd["i"] == 0:
                st["pk"] = header.get("pk")
                st["pm"] = header.get("pmeta", b"")
            if len(st["have"]) < st["n"]:
                return CODE_OK, "stripe buffered"
            # Complete: retire the group under the lock, assemble outside.
            self._groups.pop(key, None)
            self._done[key] = None
            while len(self._done) > self._done_cap:
                self._done.popitem(last=False)
        segments = []
        for i in sorted(st["have"]):
            soff, p = st["have"][i]
            if isinstance(p, serialization.SegmentedPayload):
                # Re-base the stripe's local scatter segments into the
                # payload's global address space.
                for off, view in p.segments():
                    segments.append((soff + off, view))
            else:
                segments.append((soff, memoryview(p)))
        segments.sort(key=lambda e: e[0])
        pos = 0
        for off, view in segments:
            if off != pos:
                return (
                    CODE_INTERNAL_ERROR,
                    f"stripes do not tile the payload (gap at byte {pos})",
                )
            pos += memoryview(view).nbytes
        if pos != st["tot"]:
            return (
                CODE_INTERNAL_ERROR,
                f"assembled {pos} bytes != declared total {st['tot']}",
            )
        inner = {k: v for k, v in header.items() if k not in ("sd", "pk")}
        inner["pkind"] = st["pk"] or "tree"
        inner["pmeta"] = st["pm"] or b""
        return self._offer(inner, serialization.SegmentedPayload(segments))


class RendezvousStore:
    def __init__(
        self,
        job_name: str,
        decode_fn: DecodeFn,
        max_payload_bytes: Optional[int] = None,
        decode_workers: int = 2,
        recv_timeout_s: Optional[float] = None,
        allow_pickle: bool = True,
    ) -> None:
        self._job_name = job_name
        self._decode_fn = decode_fn
        self._max_payload_bytes = max_payload_bytes
        # <=0 means "no deadline" (common config convention); guards the
        # expire thread against a zero-sleep busy spin too.
        if recv_timeout_s is not None and recv_timeout_s <= 0:
            recv_timeout_s = None
        self._recv_timeout_s = recv_timeout_s
        self._allow_pickle = allow_pickle
        self._lock = threading.Lock()
        self._arrived: Dict[Tuple[str, str], Tuple[Dict, memoryview]] = {}
        self._waiters: Dict[Tuple[str, str], Future] = {}
        # Recently-delivered keys: a sender that lost an ack resends the
        # same frame after reconnect; without this, the duplicate would
        # park in _arrived forever (each (up, down) edge is consumed once).
        self._consumed: "OrderedDict[Tuple[str, str], None]" = OrderedDict()
        self._consumed_cap = 65536
        self._pool = ThreadPoolExecutor(
            max_workers=decode_workers, thread_name_prefix="fedtpu-recv-decode"
        )
        # Payloads at/below this decode inline on the offering/taking
        # thread instead of hopping to the pool: for small frames the
        # cross-thread handoff costs more than the decode itself, and the
        # common case (consumer already parked in take()) resolves the
        # waiter one hop sooner.
        self._inline_decode_max = 64 * 1024
        # Per-instance stats mirror the process-global registry series:
        # co-located stores (combined proxies, tests) share one series,
        # so get_stats() must count from a local dict, not the registry
        # (docs/observability.md).
        _reg = telemetry_metrics.get_registry()
        self._m_recv_ops = _reg.counter(
            "fed_transport_recv_ops_total",
            "Frames offered to the rendezvous store (data, ping, control).",
        )
        self._m_ghost = _reg.counter(
            "fed_transport_ghost_evicted_total",
            "Parked frames purged because their source party was evicted.",
        )
        self._m_dup = _reg.counter(
            "fed_transport_duplicate_offers_total",
            "Duplicate frames dropped by the consumed-key done-ring "
            "(ack-lost or ack-late resends).",
        )
        self._stats_lock = threading.Lock()
        self._stats = {
            "receive_op_count": 0,
            "ghost_evicted": 0,
            "duplicate_offers": 0,
        }
        # Readiness-ping bookkeeping (barrier mutuality): which peers
        # have pinged this receiver, by the header's src when the lane
        # carries one; pings on the reference-compatible gRPC wire have
        # no src field and are counted anonymously.
        self._ping_srcs: set = set()
        self._anon_pings = 0
        self._stopped = False
        self._deadlines: Dict[Tuple[str, str], float] = {}
        _stores.add(self)
        if recv_timeout_s is not None:
            threading.Thread(
                target=self._expire_loop,
                name="fedtpu-recv-deadline",
                daemon=True,
            ).start()

    def _expire_loop(self) -> None:
        """Fail waiters whose deadline passed — a vanished peer cannot send
        an error envelope, so without this a pure receiver waits forever
        (the reference behavior; opt-in via recv_timeout_in_ms). On
        membership-enabled jobs, additionally reap parked frames from
        KNOWN-evicted sources (epoch-stamped eviction): the eager purge
        at the epoch bump catches frames already parked, this sweep
        catches stragglers that land afterwards from a not-quite-dead
        ghost process. Only frames stamped with an epoch predating the
        eviction (or unstamped) are reaped — a same-named replacement's
        frames carry the newer admission epoch and survive."""
        import time

        interval = max(0.05, min(1.0, self._recv_timeout_s / 4))
        while not self._stopped:
            time.sleep(interval)
            now = time.monotonic()
            expired = []
            with self._lock:
                for key, deadline in list(self._deadlines.items()):
                    if now >= deadline:
                        self._deadlines.pop(key, None)
                        waiter = self._waiters.pop(key, None)
                        if waiter is not None:
                            # Tombstone: a slow (not dead) peer's frame
                            # arriving after expiry must be acked-and-
                            # dropped like a duplicate, not parked forever
                            # (data seq ids are monotonic — no consumer
                            # ever re-takes an expired one). Membership
                            # keys are EXEMPT: a member re-takes the SAME
                            # sync key after an expiry (sync-index
                            # rollback, takeover re-broadcast), so the
                            # late frame must still park and match the
                            # re-parked waiter — a tombstone here wedges
                            # coordinator failover. Lingering mbr frames
                            # are bounded (resync_window per takeover)
                            # and reaped by the eviction sweep below.
                            if not str(key[0]).startswith(
                                MEMBERSHIP_SEQ_PREFIX
                            ):
                                self._mark_consumed(key)
                            expired.append((key, waiter))
            for key, waiter in expired:
                waiter.set_exception(
                    TimeoutError(
                        f"no data arrived for rendezvous {key} within "
                        f"{self._recv_timeout_s}s (recv_timeout_in_ms)"
                    )
                )
            with _hooks_lock:
                evicted_fn = _evicted_fns.get(self._job_name)
            if evicted_fn is not None:
                try:
                    evicted = evicted_fn()
                except Exception:  # noqa: BLE001 - sweep is best-effort
                    continue
                if not evicted:
                    continue
                with self._lock:
                    ghosts = {
                        h.get("src")
                        for h, _ in self._arrived.values()
                        if h.get("src") in evicted
                    }
                for src in ghosts:
                    self.evict_source(src, before_epoch=evicted[src])

    # -- transport side ----------------------------------------------------

    def offer(self, header: Dict, payload) -> Tuple[int, str]:
        """Accept one DATA frame; returns (code, message) for the response.
        Large payloads never block the transport thread on decode —
        decoding runs on the worker pool; small payloads (within
        ``_inline_decode_max``) decode inline, where the handoff would
        cost more than the decode."""
        job = header.get("job")
        if job != self._job_name:
            # Job-name isolation (ref grpc_proxy.py:311-320).
            logger.warning(
                "rejecting data for job %r (this receiver serves %r)",
                job, self._job_name,
            )
            return (
                CODE_JOB_MISMATCH,
                f"job name mismatch: got {job!r}, expected {self._job_name!r}",
            )
        key = (header["up"], header["down"])
        if key == (PING_SEQ_ID, PING_SEQ_ID):
            # Readiness pings are acked and recorded, never stored or
            # decoded: no consumer ever takes them (so size/pickle policy
            # is moot), and the barrier needs to know WHO pinged
            # (ping_others mutuality — a party must not pass its barrier
            # and tear down while a peer has not reached it yet).
            self._bump_recv()
            with self._lock:
                src = header.get("src") or ""
                if src:
                    self._ping_srcs.add(src)
                else:
                    self._anon_pings += 1
            return CODE_OK, "ping"
        nbytes = serialization.payload_nbytes(payload)
        if self._max_payload_bytes is not None and nbytes > self._max_payload_bytes:
            return (
                CODE_INTERNAL_ERROR,
                f"payload {nbytes} bytes exceeds limit {self._max_payload_bytes}",
            )
        if (
            not self._allow_pickle
            and header.get("pkind") == "pickle"
            and not header.get("is_error")
        ):
            # Strict arrays-only mode: the unpickler never runs on data
            # frames (error envelopes stay allowed — they carry our own
            # whitelisted exception types).
            return (
                CODE_PICKLE_FORBIDDEN,
                "pickle payloads are disabled (allow_pickle_payloads=False)",
            )
        if isinstance(key[0], str):
            # Control frame (membership request, telemetry push, ...):
            # dispatched to the prefix's registered handler, never parked
            # — the handler's verdict rides back in this frame's ack, so
            # a rejected join fails the sender's future with the 403 it
            # earned. A reserved-namespace frame with no handler at this
            # party (join to a non-coordinator, push to a non-collector)
            # is refused rather than parked.
            handler = prefix = None
            with _hooks_lock:
                for (j, p), h in _control_handlers.items():
                    if j == job and key[0].startswith(p):
                        handler, prefix = h, p
                        break
            if handler is not None or key[0].startswith(CONTROL_NAMESPACES):
                if handler is None:
                    role = (
                        "membership coordinator"
                        if key[0].startswith(CONTROL_SEQ_PREFIX)
                        else "telemetry collector"
                        if key[0].startswith(TELEMETRY_SEQ_PREFIX)
                        else "privacy peer"
                        if key[0].startswith(PRIVACY_SEQ_PREFIX)
                        else "control handler"
                    )
                    return (
                        CODE_FORBIDDEN,
                        f"no {role} at this party for {key[0]!r}",
                    )
                try:
                    value = self._decode_fn(header, payload)
                except BaseException:  # noqa: BLE001 - surfaced in the ack
                    logger.warning(
                        "failed to decode control frame %s", key,
                        exc_info=True,
                    )
                    return CODE_INTERNAL_ERROR, "undecodable control frame"
                self._bump_recv()
                try:
                    code, msg = handler(header, value)
                except Exception as e:  # noqa: BLE001 - surfaced in the ack
                    logger.warning(
                        "control handler failed for %s", key, exc_info=True,
                    )
                    return CODE_INTERNAL_ERROR, f"control handler error: {e!r}"
                # Telemetry pushes are not traced: a span per push would
                # feed back into the next push's span batch forever.
                if tracing.is_enabled() and not key[0].startswith(
                    TELEMETRY_SEQ_PREFIX
                ):
                    import time

                    tracing.record(
                        "membership" if prefix == CONTROL_SEQ_PREFIX
                        else "control",
                        header.get("src", ""), header["up"],
                        header["down"], nbytes, time.perf_counter(),
                        ok=code == CODE_OK, event="control",
                    )
                return code, msg
        self._bump_recv()
        with self._lock:
            if key in self._consumed:
                # Duplicate of an already-delivered frame (ack-lost or
                # ack-late resend): acknowledge and drop. Not traced — it
                # carried no new data. Counted, though: the delay-fault ×
                # ack-timeout chaos tests assert duplicates stay BOUNDED
                # (each resend attempt produces at most one dedup hit).
                with self._stats_lock:
                    self._stats["duplicate_offers"] += 1
                self._m_dup.inc()
                return CODE_OK, "duplicate"
            waiter = self._waiters.pop(key, None)
            self._deadlines.pop(key, None)
            if waiter is None:
                # An error envelope substituting already-arrived data
                # overwrites the slot (sender reuses the same seq ids).
                if sanitize.enabled() and key in self._arrived:
                    parked_header, _parked = self._arrived[key]
                    sanitize.probe_rendezvous_reoccupation(
                        key, parked_header.get("src"), header.get("src")
                    )
                self._arrived[key] = (header, payload)
            else:
                self._mark_consumed(key)
        if tracing.is_enabled():
            import time

            tracing.record(
                "recv", header.get("src", ""), header["up"], header["down"],
                serialization.payload_nbytes(payload),
                time.perf_counter(),
            )
        if waiter is not None:
            self._deliver(header, payload, waiter, nbytes)
        return CODE_OK, "ok"

    def _deliver(self, header: Dict, payload, out: Future,
                 nbytes: Optional[int] = None) -> None:
        if nbytes is None:
            nbytes = serialization.payload_nbytes(payload)
        if nbytes <= self._inline_decode_max:
            self._decode_into(header, payload, out)
        else:
            self._pool.submit(self._decode_into, header, payload, out)

    def _mark_consumed(self, key) -> None:
        # Caller holds self._lock.
        self._consumed[key] = None
        while len(self._consumed) > self._consumed_cap:
            self._consumed.popitem(last=False)

    # -- consumer side -----------------------------------------------------

    def take(self, upstream_seq_id, curr_seq_id) -> Future:
        key = (str(upstream_seq_id), str(curr_seq_id))
        out: Future = Future()
        with self._lock:
            if key in self._arrived:
                header, payload = self._arrived.pop(key)
                self._mark_consumed(key)
            else:
                self._waiters[key] = out
                if self._recv_timeout_s is not None:
                    import time

                    self._deadlines[key] = (
                        time.monotonic()
                        + self._recv_timeout_s
                        + self._recv_slack_s()
                    )
                return out
        self._deliver(header, payload, out)
        return out

    def _recv_slack_s(self) -> float:
        """Adaptive extension for a freshly-parked recv deadline: the
        worst measured link slack across all peers (``take`` cannot know
        which peer will complete the key, so it budgets for the slowest).
        Only ever EXTENDS the configured ``recv_timeout_in_ms`` — zero
        until link health has samples — and is capped at one extra
        budget, so a pathological estimate at most doubles the wait."""
        try:
            from rayfed_tpu_torch.resilience import linkhealth

            slack = linkhealth.get_health().max_recv_slack_s()
        except Exception:  # noqa: BLE001 - slack is best-effort
            return 0.0
        return min(slack, self._recv_timeout_s)

    def _decode_into(self, header: Dict, payload, out: Future) -> None:
        try:
            with tracing.span(
                "decode", header.get("src", ""), header["up"],
                header["down"],
                serialization.payload_nbytes(payload),
            ):
                value = self._decode_fn(header, payload)
        except BaseException as e:  # noqa: BLE001 - surfaced to consumer
            out.set_exception(e)
            return
        out.set_result(value)

    def evict_source(
        self, party: str, before_epoch: Optional[int] = None
    ) -> int:
        """Drop parked (not-yet-consumed) frames whose ``src`` is
        ``party`` — the ghost purge an epoch bump applies when a party is
        evicted, so a rejoining replacement can never collide with its
        pre-crash incarnation's frames. With ``before_epoch`` (the
        party's eviction epoch, used by the expire-loop sweep) only
        frames stamped with an OLDER epoch — or unstamped — are dropped;
        frames carrying a newer stamp belong to a post-rejoin incarnation
        and survive. Evicted keys are tombstoned like consumed ones (a
        straggling resend is acked-and-dropped), and the count lands in
        ``get_stats()['ghost_evicted']``."""
        with self._lock:
            victims = []
            for key, (header, _) in self._arrived.items():
                if header.get("src") != party:
                    continue
                if before_epoch is not None:
                    stamp = _seq_epoch_of(header.get("up"))
                    if stamp is not None and stamp >= before_epoch:
                        continue
                victims.append(key)
            for key in victims:
                self._arrived.pop(key, None)
                self._mark_consumed(key)
        if victims:
            with self._stats_lock:
                self._stats["ghost_evicted"] += len(victims)
            self._m_ghost.inc(len(victims))
        if victims:
            logger.info(
                "evicted %d parked frame(s) from departed party %r",
                len(victims), party,
            )
        return len(victims)

    def _bump_recv(self) -> None:
        with self._stats_lock:
            self._stats["receive_op_count"] += 1
        self._m_recv_ops.inc()

    def get_stats(self) -> Dict:
        with self._stats_lock:
            return dict(self._stats)

    def ping_sources(self) -> Tuple[set, int]:
        """(attributed ping sources, anonymous ping count) — consumed by
        the ``ping_others`` mutual-readiness barrier."""
        with self._lock:
            return set(self._ping_srcs), self._anon_pings

    def shutdown(self) -> None:
        self._stopped = True
        self._pool.shutdown(wait=False)
