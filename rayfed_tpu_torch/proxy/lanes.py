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

"""Lane-tier negotiation: the single transport-selection point.

Every question of the form "which wire does this peer get?" is answered
here, replacing the boolean gates that used to be scattered across
``tcp_proxy.py``, ``barriers.py`` and ad-hoc config checks. The tier
order (fastest first, ``config.LANE_TIERS``) is:

    meshref > shm > tcp > tls > grpc

``negotiate`` picks one tier per peer at connection setup from a
:class:`PeerCapabilities` snapshot; a deployment restricts or reorders
the permitted tiers with ``cross_silo_comm.lane_tiers``. The two bulk
tiers are *overlays* on the socket control lane — a ``meshref`` or
``shm`` decision moves payload bytes off the socket while control
frames, acks and the resend/peer-down machinery ride the underlying
reactor lane unchanged — so every shm failure demotes gracefully:
ring-full or create-failure falls back per push, and a receiver-side
attach/adopt failure NACKs with code 424, which resends that push on
the socket lane and stops offering shm frames to the peer. The
demotion heals: after ``shm_repromote_after_ms`` (exponential hold-off
on repeat breaks) one push probes the ring again and a descriptor ACK
re-promotes the peer — see :class:`ShmSender`. 0 keeps the legacy
sticky demotion.

The same-host shm data plane lives here too: :class:`ShmSender` (ring
ownership + push/fallback bookkeeping for one destination) and
:class:`ShmAdopter` (the receiver-side offer-chain wrapper that maps
descriptor frames back into payload buffers — zero-copy on the native
ring, so a live received value pins its chunk and ``shm_ring_mb`` is
the in-flight payload budget). Both prefer the native
``_fastwire`` ring and fall back to a pure-Python ``mmap`` twin with
the identical file format, so mixed native/non-native deployments
interoperate.

Telemetry (docs/observability.md): ``fed_transport_lane_send_ops_total
{lane=}``, ``fed_transport_lane_fallbacks_total{lane=,to=}``,
``fed_transport_shm_ring_occupancy_bytes``, and the per-peer tier gauge
``fed_transport_peer_tier{peer=}`` (value = tier rank, 0 fastest).
"""

from __future__ import annotations

import dataclasses
import logging
import mmap
import os
import struct
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from rayfed_tpu_torch._private import msgpack_codec as msgpack

from rayfed_tpu_torch import sanitize
from rayfed_tpu_torch._private import native_wire
from rayfed_tpu_torch._private.constants import (
    CODE_INTERNAL_ERROR,
    CODE_JOB_MISMATCH,
    CODE_SHM_UNAVAILABLE,
)
from rayfed_tpu_torch.config import LANE_TIERS
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

# The native shm ring (None without a C++ compiler: the mmap twin).
_fw = native_wire.load()


# --------------------------------------------------------------------------
# Tier policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PeerCapabilities:
    """What the connection to one peer can support, probed at setup.

    ``transport`` is the configured proxy family ("tcp", "cuda", or
    "grpc"); ``plaintext`` is False when TLS is configured; ``shm``
    means the shm lane is *permitted and implementable* on this side
    (config opt-in + a ring implementation); ``same_process`` reflects
    the colocated composed-mesh deployment (``same_mesh_push``)."""

    same_process: bool = False
    same_host: bool = False
    plaintext: bool = True
    shm: bool = False
    transport: str = "tcp"


@dataclasses.dataclass(frozen=True)
class LaneDecision:
    tier: str
    reason: str

    def rank(self) -> int:
        return tier_rank(self.tier)


def tier_rank(tier: str) -> int:
    """Position in the canonical order; 0 is fastest. Unknown tiers sort
    last (defensive: a newer peer's tier name must not crash us)."""
    try:
        return LANE_TIERS.index(tier)
    except ValueError:
        return len(LANE_TIERS)


def allowed_tiers(cfg) -> Tuple[str, ...]:
    """The tiers this config permits, in preference order."""
    tiers = getattr(cfg, "lane_tiers", None)
    return tuple(tiers) if tiers else LANE_TIERS


# The socket families: tiers tcp/tls describe the native FTP1 socket
# lanes regardless of whether the proxy is the plain TCP or the CUDA
# transport (the CUDA proxy places on the card behind the same sockets).
_SOCKET_TRANSPORTS = ("tcp", "cuda")


def negotiate(caps: PeerCapabilities,
              tiers: Optional[Tuple[str, ...]] = None) -> LaneDecision:
    """Pick the best permitted tier whose predicate holds for the peer.

    Predicates (the lane-tier table in docs/architecture.md):
      meshref  same-process peer sharing a composed party mesh
      shm      same-host peer, plaintext wire, shm lane enabled+usable
      tcp      plaintext socket transport (reactor or pipelined)
      tls      TLS-configured socket transport
      grpc     the gRPC parity transport

    Never returns an unusable wire: when no permitted tier matches, the
    socket lane the connection actually needs (tls when TLS is
    configured, else tcp/grpc) is chosen with an explanatory reason —
    ``lane_tiers`` can deny the overlay tiers, not connectivity.
    """
    tiers = tuple(tiers) if tiers else LANE_TIERS
    for tier in tiers:
        if tier == "meshref" and caps.same_process:
            return LaneDecision(
                "meshref", "same-process peer shares a composed mesh"
            )
        if (
            tier == "shm"
            and caps.shm
            and caps.same_host
            and caps.plaintext
            and caps.transport in _SOCKET_TRANSPORTS
        ):
            return LaneDecision(
                "shm", "same-host plaintext peer with shm enabled"
            )
        if (
            tier == "tcp"
            and caps.plaintext
            and caps.transport in _SOCKET_TRANSPORTS
        ):
            return LaneDecision("tcp", "plaintext socket transport")
        if (
            tier == "tls"
            and not caps.plaintext
            and caps.transport in _SOCKET_TRANSPORTS
        ):
            return LaneDecision("tls", "TLS-configured socket transport")
        if tier == "grpc" and caps.transport == "grpc":
            return LaneDecision("grpc", "gRPC parity transport")
    if caps.transport == "grpc":
        base = "grpc"
    elif caps.plaintext:
        base = "tcp"
    else:
        base = "tls"
    return LaneDecision(
        base, f"no permitted tier matched; using base {base} lane"
    )


def same_host(self_addr: Optional[str], dest_addr: Optional[str]) -> bool:
    """Same-host heuristic for the shm predicate: the peer's host is
    loopback, or both parties advertise the same non-wildcard host. A
    wrong positive is safe — the receiver's attach fails and NACKs 424,
    demoting the peer to the socket lane."""
    if not dest_addr:
        return False
    dest_host = _host_of(dest_addr)
    if _is_loopback(dest_host):
        return True
    self_host = _host_of(self_addr) if self_addr else ""
    if not self_host or _is_wildcard(self_host) or _is_wildcard(dest_host):
        return False
    return self_host == dest_host


def _host_of(addr: str) -> str:
    host = addr.rsplit(":", 1)[0] if ":" in addr else addr
    return host.strip("[]").lower()


def _is_loopback(host: str) -> bool:
    return host == "localhost" or host == "::1" or host.startswith("127.")


def _is_wildcard(host: str) -> bool:
    return host in ("", "0.0.0.0", "::")


def peer_capabilities(cfg, tls_config, transport: str = "tcp",
                      self_addr: Optional[str] = None,
                      dest_addr: Optional[str] = None) -> PeerCapabilities:
    """Probe the capability snapshot for one peer from config + addresses."""
    return PeerCapabilities(
        # No meshref lane in this package (ROADMAP Queue 1 item 12b;
        # fed.init refuses same_mesh_push): never negotiate that tier.
        same_process=False,
        same_host=same_host(self_addr, dest_addr),
        plaintext=not bool(tls_config),
        shm=shm_enabled(cfg) and shm_available(),
        transport=transport,
    )


def negotiate_for_dest(cfg, tls_config, transport: str,
                       self_addr: Optional[str],
                       dest_addr: Optional[str]) -> LaneDecision:
    """Connection-setup entry point used by the sender proxies."""
    caps = peer_capabilities(
        cfg, tls_config, transport=transport,
        self_addr=self_addr, dest_addr=dest_addr,
    )
    return negotiate(caps, allowed_tiers(cfg))


# --------------------------------------------------------------------------
# Gate helpers (the formerly-scattered boolean checks)
# --------------------------------------------------------------------------


def dma_enabled(cfg) -> bool:
    """Device-DMA lane gate (cuda_proxy encode hook and decode, barriers
    capture, tcp_proxy threaded-worker/fast-send checks)."""
    return bool(getattr(cfg, "device_dma", False))


def shm_enabled(cfg) -> bool:
    return bool(getattr(cfg, "shm_enabled", False))


def reactor_mode(cfg, tls_config) -> bool:
    """Plaintext connections ride the shared epoll reactor when the
    platform has one; TLS keeps the threaded half-duplex path."""
    from rayfed_tpu_torch.proxy.tcp import reactor as reactor_mod
    from rayfed_tpu_torch.proxy.tcp import wire

    return (
        not wire.tls_enabled(tls_config)
        and getattr(cfg, "use_reactor", True)
        and reactor_mod.available()
    )


def transport_proxy_classes(transport: str):
    """(sender_cls, receiver_cls) for a transport family — the proxy
    class table, colocated with the tier policy so transport selection
    has one home. ``"cuda"`` is the counterpart of the JAX package's
    ``"tpu"`` (received tensors placed on the party's card), which raises
    an ImportError naming it, as ``"grpc"`` names the ROADMAP item that
    brings it."""
    if transport == "tcp":
        from rayfed_tpu_torch.proxy.tcp.tcp_proxy import (
            TcpReceiverProxy,
            TcpSenderProxy,
        )

        return TcpSenderProxy, TcpReceiverProxy
    if transport == "cuda":
        from rayfed_tpu_torch.proxy.cuda.cuda_proxy import (
            CudaReceiverProxy,
            CudaSenderProxy,
        )

        return CudaSenderProxy, CudaReceiverProxy
    if transport == "tpu":
        raise ImportError(
            "transport='tpu' is the JAX package's TPU placement lane; its "
            "counterpart in rayfed_tpu_torch is transport='cuda' (ROADMAP "
            "Queue 1 item 4)"
        )
    if transport == "grpc":
        raise ImportError(
            "transport='grpc' is not ported to rayfed_tpu_torch yet: the "
            "gRPC lane is ROADMAP Queue 1 item 15"
        )
    raise ValueError(
        f"unknown transport {transport!r}; expected 'tcp', 'cuda' or 'grpc'"
    )


# --------------------------------------------------------------------------
# Telemetry
# --------------------------------------------------------------------------

# Registered through accessor functions (not module-level children) so a
# test-side reset_registry() cannot strand cached series.


def _lane_counter():
    return telemetry_metrics.get_registry().counter(
        "fed_transport_lane_send_ops_total",
        "Bulk data frames delivered, by the wire lane that carried them.",
        labels=("lane",),
    )


def _fallback_counter():
    return telemetry_metrics.get_registry().counter(
        "fed_transport_lane_fallbacks_total",
        "Per-push lane demotions (e.g. shm ring full or peer NACK 424).",
        labels=("lane", "to"),
    )


def _peer_tier_gauge():
    return telemetry_metrics.get_registry().gauge(
        "fed_transport_peer_tier",
        "Negotiated lane tier per peer (rank in "
        "meshref>shm>tcp>tls>grpc; 0 is fastest).",
        labels=("peer",),
    )


def _ring_occupancy_gauge():
    return telemetry_metrics.get_registry().gauge(
        "fed_transport_shm_ring_occupancy_bytes",
        "Bytes parked in this process's shm send rings "
        "(pushed, not yet released by receivers).",
    )


def record_lane_send(lane: str) -> None:
    _lane_counter().labels(lane=lane).inc()


def _repromotion_counter():
    return telemetry_metrics.get_registry().counter(
        "fed_transport_lane_repromotions_total",
        "Successful lane re-promotions after a demotion (health probe "
        "ACKed), by the lane promoted back to.",
        labels=("lane",),
    )


def _tenant_bleed_counter():
    return telemetry_metrics.get_registry().counter(
        "fed_tenant_shm_bleed_rejections_total",
        "Shm adoptions rejected because the chunk's job tag disagreed "
        "with the descriptor/frame job (cross-tenant delivery blocked).",
    )


def record_fallback(lane: str, to: str) -> None:
    _fallback_counter().labels(lane=lane, to=to).inc()


def record_repromotion(lane: str) -> None:
    _repromotion_counter().labels(lane=lane).inc()


def set_peer_tier(peer: str, tier: str) -> None:
    _peer_tier_gauge().labels(peer=peer).set(float(tier_rank(tier)))


def clear_peer_tier(peer: str) -> None:
    _peer_tier_gauge().remove(peer=peer)


# --------------------------------------------------------------------------
# Shm ring implementations
# --------------------------------------------------------------------------

# File format shared by the native (_fastwire) and pure-Python rings —
# both sides of a connection may differ in which one they run, so the
# layout constants must match native/fastwire.cc exactly.
_SHM_DIR = "/dev/shm"
_FILE_HDR = 4096
_CHUNK_HDR = 64
_ALIGN = 64
_FILE_MAGIC = 0x4645445450534852  # "FEDTPSHR"
_CHUNK_MAGIC = 0x46435348  # "FCSH"
_ST_INFLIGHT = 0
_ST_RELEASED = 1
_FILE_HDR_FMT = "<QQ"  # magic, cap
_CHUNK_HDR_FMT = "<IIQ"  # magic, state, size


def _native_ok() -> bool:
    return _fw is not None and hasattr(_fw, "shm_ring_create")


def shm_available() -> bool:
    """An shm ring implementation exists on this platform. The
    pure-Python mmap ring keeps the lane working without the native
    build (correct, not zero-copy); FEDTPU_SHM_FORCE_PY=1 forces it
    for interop tests."""
    if _native_ok() and not os.environ.get("FEDTPU_SHM_FORCE_PY"):
        return True
    return os.path.isdir(_SHM_DIR)


class _PyShmRing:
    """mmap twin of the native ring (same file format). Adoption copies
    (Python cannot express release-on-dealloc buffer views safely), so
    chunks release immediately on adopt — slower, never wrong."""

    def __init__(self, path: str, creator: bool):
        self.path = path
        self.creator = creator
        self.closed = False
        self.head = 0
        self.tail = 0
        self._f = None
        self._mm = None

    @classmethod
    def create(cls, name: str, cap: int) -> "_PyShmRing":
        cap = max(_ALIGN, (int(cap) + _ALIGN - 1) & ~(_ALIGN - 1))
        r = cls(os.path.join(_SHM_DIR, name), creator=True)
        fd = os.open(r.path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, _FILE_HDR + cap)
            r._f = fd
            r._mm = mmap.mmap(fd, _FILE_HDR + cap)
        except BaseException:
            os.close(fd)
            os.unlink(r.path)
            raise
        r.cap = cap
        r._mm[0:16] = struct.pack(_FILE_HDR_FMT, _FILE_MAGIC, cap)
        return r

    @classmethod
    def attach(cls, name: str) -> "_PyShmRing":
        r = cls(os.path.join(_SHM_DIR, name), creator=False)
        fd = os.open(r.path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            if size < _FILE_HDR:
                raise ValueError(f"shm ring {name} truncated")
            r._f = fd
            r._mm = mmap.mmap(fd, size)
        except BaseException:
            os.close(fd)
            raise
        magic, cap = struct.unpack_from(_FILE_HDR_FMT, r._mm, 0)
        if magic != _FILE_MAGIC or cap == 0 or size < _FILE_HDR + cap:
            r.close()
            raise ValueError(f"shm ring {name} has bad header")
        r.cap = cap
        return r

    def _chunk(self, pos: int):
        return struct.unpack_from(_CHUNK_HDR_FMT, self._mm, _FILE_HDR + pos)

    def _set_state(self, pos: int, state: int) -> None:
        struct.pack_into("<I", self._mm, _FILE_HDR + pos + 4, state)

    def _reclaim(self) -> None:
        while self.head < self.tail:
            pos = self.head % self.cap
            magic, state, size = self._chunk(pos)
            if (
                magic != _CHUNK_MAGIC
                or state != _ST_RELEASED
                or size < _CHUNK_HDR
                or size % _ALIGN
                or self.head + size > self.tail
            ):
                break
            self.head += size

    def push(self, buffers) -> Optional[int]:
        if self.closed:
            raise ValueError("ring is closed")
        if not self.creator:
            raise ValueError("only the creating side may push")
        total = sum(memoryview(b).nbytes for b in buffers)
        need = (_CHUNK_HDR + total + _ALIGN - 1) & ~(_ALIGN - 1)
        if need > self.cap:
            return None
        self._reclaim()
        pos = self.tail % self.cap
        wrem = self.cap - pos if pos + need > self.cap else 0
        if self.cap - (self.tail - self.head) < wrem + need:
            return None
        if wrem:
            struct.pack_into(
                _CHUNK_HDR_FMT, self._mm, _FILE_HDR + pos,
                _CHUNK_MAGIC, _ST_RELEASED, wrem,
            )
            self.tail += wrem
            pos = 0
        off = _FILE_HDR + pos + _CHUNK_HDR
        for b in buffers:
            raw = bytes(memoryview(b).cast("B"))
            self._mm[off:off + len(raw)] = raw
            off += len(raw)
        struct.pack_into(
            _CHUNK_HDR_FMT, self._mm, _FILE_HDR + pos,
            _CHUNK_MAGIC, _ST_INFLIGHT, need,
        )
        self.tail += need
        return pos + _CHUNK_HDR

    def adopt(self, off: int, nbytes: int) -> bytearray:
        if self.closed:
            raise ValueError("ring is closed")
        if (
            off < _CHUNK_HDR
            or off % _ALIGN
            or off > self.cap
            or nbytes > self.cap - off
        ):
            raise ValueError("shm descriptor out of range")
        pos = off - _CHUNK_HDR
        magic, state, size = self._chunk(pos)
        if magic == _CHUNK_MAGIC:
            # Sanitizer sees the state word before the generic rejection:
            # a RELEASED chunk here is a double-adopt/use-after-release.
            sanitize.probe_shm_adopt(state, _ST_INFLIGHT, off)
        if (
            magic != _CHUNK_MAGIC
            or state != _ST_INFLIGHT
            or _CHUNK_HDR + nbytes > size
        ):
            raise ValueError("shm descriptor does not name a live chunk")
        # bytearray, not bytes: numpy leaves decoded from this buffer
        # inherit its writability (the receiver's writable-view promise).
        data = bytearray(self._mm[_FILE_HDR + off:_FILE_HDR + off + nbytes])
        # Copied out: release immediately so the sender reclaims.
        self._set_state(pos, _ST_RELEASED)
        return data

    def cancel(self, off: int) -> None:
        if self.closed:
            return
        pos = off - _CHUNK_HDR
        if pos < 0 or pos % _ALIGN or pos >= self.cap:
            raise ValueError("shm cancel offset out of range")
        magic, state, _size = self._chunk(pos)
        if magic != _CHUNK_MAGIC:
            raise ValueError("shm cancel offset not a chunk")
        sanitize.probe_shm_cancel(state, _ST_INFLIGHT, off)
        self._set_state(pos, _ST_RELEASED)

    def chunk_state(self, off: int) -> Optional[int]:
        """State word of the chunk at ``off`` (_ST_INFLIGHT/_ST_RELEASED)
        or None when the offset names no live chunk."""
        if self.closed:
            return None
        pos = off - _CHUNK_HDR
        if pos < 0 or pos % _ALIGN or pos >= self.cap:
            return None
        magic, state, _size = self._chunk(pos)
        return state if magic == _CHUNK_MAGIC else None

    def occupancy(self) -> Tuple[int, int]:
        if self.creator:
            self._reclaim()
        return (self.tail - self.head, self.cap)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.creator:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        if self._mm is not None:
            try:
                self._mm.close()
            except (BufferError, ValueError):
                pass  # live exported views; the mmap dies with them
        if self._f is not None:
            try:
                os.close(self._f)
            except OSError:
                pass
            self._f = None


class _NativeShmRing:
    """Thin wrapper giving the _fastwire ring the same method surface."""

    def __init__(self, ring, path: str, creator: bool):
        self._ring = ring
        self.path = path
        self.creator = creator

    @classmethod
    def create(cls, name: str, cap: int) -> "_NativeShmRing":
        return cls(
            _fw.shm_ring_create(name, cap),
            os.path.join(_SHM_DIR, name), True,
        )

    @classmethod
    def attach(cls, name: str) -> "_NativeShmRing":
        return cls(
            _fw.shm_ring_attach(name),
            os.path.join(_SHM_DIR, name), False,
        )

    def push(self, buffers) -> Optional[int]:
        return _fw.shm_ring_push(self._ring, buffers)

    def adopt(self, off: int, nbytes: int):
        # Returns a zero-copy ShmBuf view; its dealloc releases the chunk
        # back to the sender. Chunk lifetime therefore equals the decoded
        # value's lifetime (decode makes numpy views straight over shm),
        # which is the whole point — the receive side touches no bytes —
        # but it makes ring capacity a FLOW-CONTROL budget: every live
        # received value pins its chunk, so ``shm_ring_mb`` must cover
        # the peak in-flight payload volume (pipelined sends whose
        # FedObjects are still held). A full ring is not a deadlock:
        # push waits ``shm_push_timeout_ms`` then falls back to the
        # socket lane for that payload. Copying out here instead would
        # decouple the lifetimes but costs a full extra memory pass per
        # payload — measured on the CI host class it makes the lane
        # SLOWER than loopback TCP (fresh 100MB allocations fault at
        # ~1 GB/s), so the copy-free contract stays.
        return _fw.shm_ring_adopt(self._ring, off, nbytes)

    def cancel(self, off: int) -> None:
        _fw.shm_ring_cancel(self._ring, off)

    def chunk_state(self, off: int) -> Optional[int]:
        if not hasattr(_fw, "shm_ring_chunk_state"):
            return None  # older native build: caller cancels blindly
        try:
            return _fw.shm_ring_chunk_state(self._ring, off)
        except Exception:  # noqa: BLE001 - bad offset/closed ring
            return None

    def occupancy(self) -> Tuple[int, int]:
        return _fw.shm_ring_occupancy(self._ring)

    def close(self) -> None:
        _fw.shm_ring_close(self._ring)


def _ring_impl():
    if _native_ok() and not os.environ.get("FEDTPU_SHM_FORCE_PY"):
        return _NativeShmRing
    return _PyShmRing


def create_ring(name: str, cap: int):
    return _ring_impl().create(name, cap)


def attach_ring(name: str):
    return _ring_impl().attach(name)


def _sanitize(part: str, limit: int) -> str:
    out = "".join(
        c if (c.isalnum() or c in "-_") else "-" for c in str(part)
    )
    return (out or "x")[:limit]


def ring_name(job: str, src: str, dest: str) -> str:
    """Globally unique /dev/shm filename for one (job, src->dest) ring.
    pid + random suffix keep restarted parties from colliding with a
    stale file a crashed predecessor never unlinked."""
    return (
        f"fedtpu-{_sanitize(job, 24)}-{_sanitize(src, 16)}"
        f"-{_sanitize(dest, 16)}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    )


# --------------------------------------------------------------------------
# Sender side: ShmSender
# --------------------------------------------------------------------------

# Payload kinds the shm lane may carry: the ordinary host encodings.
# Alternate-lane descriptor frames (meshref/dma) and assembled stripe
# parts never enter the ring.
_SHM_KINDS = ("tree", "mp", "pickle")

# --------------------------------------------------------------------------
# Tenancy: per-chunk job tag + weighted-fair admission
# --------------------------------------------------------------------------

#: Every shm chunk carries a fixed-size job-tag block as its FIRST 64
#: payload bytes (the native ring owns the real chunk header, so the tag
#: rides inside the payload; 64 bytes keeps the true payload 64-byte
#: aligned for zero-copy decode). Layout: magic "FJT1", 1-byte tag
#: length, up to 56 job-name bytes, zero pad.
JOB_TAG_LEN = 64
_JOB_TAG_MAGIC = b"FJT1"
_JOB_TAG_MAX = 56


def encode_job_tag(job: Optional[str]) -> bytes:
    raw = (job or "").encode("utf-8")[:_JOB_TAG_MAX]
    block = _JOB_TAG_MAGIC + bytes([len(raw)]) + raw
    return block + b"\x00" * (JOB_TAG_LEN - len(block))


def decode_job_tag(block) -> Optional[str]:
    """The tagged job name, or None when the block is not a job tag."""
    block = bytes(memoryview(block)[:JOB_TAG_LEN])
    if len(block) < JOB_TAG_LEN or block[:4] != _JOB_TAG_MAGIC:
        return None
    n = block[4]
    if n > _JOB_TAG_MAX:
        return None
    return block[5:5 + n].decode("utf-8", "replace")


def job_tag_matches(tag: Optional[str], job: Optional[str]) -> bool:
    """Compare a decoded tag against a job name under the tag's
    truncation (job names longer than 56 UTF-8 bytes compare by
    prefix)."""
    if tag is None or job is None:
        return False
    return tag.encode("utf-8") == job.encode("utf-8")[:_JOB_TAG_MAX]


def qos_admit(job: Optional[str], payload_len: int,
              small_threshold: int) -> float:
    """Weighted-fair admission for one outbound frame (the lanes-level
    entry point into the tenancy scheduler). Frames below the sender's
    small-message threshold — serving requests, control traffic, error
    envelopes — are ``inline`` class and never wait; bulk frames wait
    (bounded) while this tenant is over its fair share. Returns seconds
    waited. MUST NOT be called on a reactor thread (it can block)."""
    from rayfed_tpu_torch.tenancy import qos

    tc = qos.TC_BULK if payload_len >= max(1, small_threshold) else (
        qos.TC_INLINE
    )
    return qos.get_scheduler().admit(job, payload_len, tc)


class ShmSender:
    """Owns the outbound shm ring for one destination.

    Lazy: the ring file is created on the first eligible push, so a peer
    that never sees bulk traffic costs no shm memory. Thread-safe: the
    ring is single-producer, so pushes serialize on a lock (submitters
    may run on arbitrary threads in reactor mode). Every failure path
    returns None — the caller falls back to the socket lane and the
    send can never be lost.

    Demotion and re-promotion: ``mark_broken`` (receiver NACK 424 or a
    local ring failure) demotes the peer to the socket lane. With
    ``shm_repromote_after_ms`` == 0 that is sticky for the life of the
    job (the pre-PR-17 behavior). Otherwise the sender re-probes the
    ring after an exponential hold-off — base x 2^(demotions-1), capped
    at 16x — by letting exactly ONE push through (``eligible`` opens the
    probe); the ack outcome decides: descriptor ACK => ``mark_recovered``
    (the caller records the re-promotion), another 424 => re-demoted
    with a doubled hold-off. The demotion count is never reset, so a
    flapping link backs off harder each cycle instead of oscillating.

    In-flight accounting (the peer-death leak fix): every pushed offset
    stays in ``_outstanding`` until its descriptor frame is ACKed
    (``on_delivered``) or cancelled; ``cancel_peer_inflight`` reclaims
    every still-INFLIGHT outstanding chunk when liveness declares the
    peer DEAD — without it, chunks pinned for a receiver that died
    before adopting are leaked for the life of the ring."""

    def __init__(self, job: str, src: str, dest: str, cfg):
        self._cap = max(1, int(getattr(cfg, "shm_ring_mb", 256) or 256)) << 20
        self._min = max(0, int(getattr(cfg, "shm_min_bytes", 65536) or 0))
        self._timeout_s = (
            max(0, int(getattr(cfg, "shm_push_timeout_ms", 250) or 0))
            / 1000.0
        )
        self._repromote_base_s = (
            max(0, int(getattr(cfg, "shm_repromote_after_ms", 0) or 0))
            / 1000.0
        )
        self._name = ring_name(job, src, dest)
        self._job = job
        self._dest = dest
        self._ring = None
        self._broken = False
        self._demotions = 0
        self._retry_at: Optional[float] = None
        self._probing = False
        self._outstanding: set = set()
        # Tenancy: bytes charged against the job's shm_ring_quota_mb per
        # outstanding offset, released when the chunk leaves our hands.
        self._charges: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _release_charge_locked(self, off: int) -> None:
        charged = self._charges.pop(off, 0)
        if charged:
            from rayfed_tpu_torch.tenancy import qos

            qos.get_ledger().release(self._job, "shm_ring_bytes", charged)

    @property
    def broken(self) -> bool:
        return self._broken

    @property
    def probing(self) -> bool:
        return self._probing

    @property
    def demotions(self) -> int:
        return self._demotions

    def outstanding_count(self) -> int:
        with self._lock:
            return len(self._outstanding)

    def eligible(self, header: Dict, payload_len: int) -> bool:
        """May this frame ride the ring? Errors stay on the ordered
        socket lane; sub-threshold frames aren't worth a descriptor
        round-trip; a payload bigger than the whole ring can never fit.
        On a demoted peer this is also the re-promotion gate: once the
        hold-off expires, exactly one push is let through as the health
        probe."""
        if (
            header.get("is_error")
            or header.get("pkind") not in _SHM_KINDS
            or payload_len < self._min
            or payload_len + 2 * _CHUNK_HDR > self._cap
        ):
            return False
        if not self._broken:
            return True
        if self._repromote_base_s <= 0:
            return False  # legacy sticky demotion
        with self._lock:
            if not self._broken:
                return True
            if self._probing:
                return False  # one probe in flight at a time
            if self._retry_at is None or time.monotonic() < self._retry_at:
                return False
            self._probing = True
            return True

    def push(self, buffers, payload_len: int) -> Optional[Tuple[str, int, int]]:
        """Copy the frame's buffers into the ring, job-tagged. Returns
        (ring_name, offset, stored_len) for the descriptor frame — where
        stored_len = payload_len + the 64-byte job tag the receiver
        validates and strips — or None to fall back. Waits up to
        shm_push_timeout_ms for receivers to release space — the ring
        throttles, the socket lane is the pressure valve. Raises
        :class:`TenantQuotaExceeded` when the push would take the job
        over its shm_ring_quota_mb (loud, never a silent fallback)."""
        from rayfed_tpu_torch.tenancy import qos

        stored_len = payload_len + JOB_TAG_LEN
        with self._lock:
            if self._broken and not self._probing:
                return None
            if self._ring is None:
                try:
                    self._ring = create_ring(self._name, self._cap)
                except Exception as e:
                    logger.warning(
                        "shm ring create for %s failed (%s); peer demoted "
                        "to the socket lane", self._dest, e,
                    )
                    self._mark_broken_locked()
                    return None
            # Quota check-and-charge BEFORE the bytes land; a breach
            # raises through to the caller (TenantQuotaExceeded).
            qos.get_ledger().charge(
                self._job, "shm_ring_bytes", stored_len
            )
            tagged = [encode_job_tag(self._job)] + list(buffers)
            deadline = time.monotonic() + self._timeout_s
            while True:
                try:
                    off = self._ring.push(tagged)
                except Exception as e:
                    logger.warning(
                        "shm push to %s failed (%s); falling back",
                        self._dest, e,
                    )
                    off = None
                    break
                if off is not None:
                    break
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.001)
            if off is None:
                qos.get_ledger().release(
                    self._job, "shm_ring_bytes", stored_len
                )
                return None
            self._outstanding.add(off)
            self._charges[off] = stored_len
            try:
                used, _cap = self._ring.occupancy()
                _ring_occupancy_gauge().set(float(used))
            except Exception:  # noqa: BLE001 - telemetry only
                pass
            return (self._name, off, stored_len)

    def cancel(self, off: int) -> None:
        """Release a pushed chunk whose descriptor was never delivered."""
        with self._lock:
            self._outstanding.discard(off)
            self._release_charge_locked(off)
            if self._ring is not None:
                try:
                    self._ring.cancel(off)
                except Exception:  # noqa: BLE001 - space leak bounded by ring
                    logger.debug("shm cancel failed", exc_info=True)

    def on_delivered(self, off: int) -> None:
        """The descriptor frame was ACKed: chunk ownership is with the
        receiver now (its adopt/release governs the lifetime)."""
        with self._lock:
            self._outstanding.discard(off)
            self._release_charge_locked(off)

    def cancel_peer_inflight(self) -> int:
        """Reclaim every outstanding chunk that is still INFLIGHT —
        called when liveness declares the peer DEAD. Chunks the receiver
        already released (adopted-then-died, or the py-ring's
        copy-on-adopt) are skipped: cancelling those again would be a
        double release. Returns the number of chunks reclaimed."""
        with self._lock:
            if self._ring is None:
                for off in list(self._outstanding):
                    self._release_charge_locked(off)
                self._outstanding.clear()
                return 0
            reclaimed = 0
            for off in list(self._outstanding):
                self._outstanding.discard(off)
                self._release_charge_locked(off)
                state = None
                chunk_state = getattr(self._ring, "chunk_state", None)
                if chunk_state is not None:
                    state = chunk_state(off)
                if state is not None and state != _ST_INFLIGHT:
                    continue
                try:
                    self._ring.cancel(off)
                    reclaimed += 1
                except Exception:  # noqa: BLE001 - already-dead chunk
                    logger.debug(
                        "shm peer-death cancel failed", exc_info=True
                    )
            try:
                used, _cap = self._ring.occupancy()
                _ring_occupancy_gauge().set(float(used))
            except Exception:  # noqa: BLE001 - telemetry only
                pass
            if reclaimed:
                logger.info(
                    "reclaimed %d in-flight shm chunk(s) for dead peer %s",
                    reclaimed, self._dest,
                )
            return reclaimed

    def _mark_broken_locked(self) -> None:
        self._probing = False
        self._broken = True
        self._demotions += 1
        if self._repromote_base_s > 0:
            holdoff = self._repromote_base_s * min(
                2.0 ** (self._demotions - 1), 16.0
            )
            self._retry_at = time.monotonic() + holdoff

    def mark_broken(self) -> None:
        with self._lock:
            self._mark_broken_locked()

    def mark_recovered(self) -> bool:
        """A probe push was descriptor-ACKed: the peer adopts shm frames
        again. Returns True when this actually transitioned the sender
        out of the demoted state (the caller's cue to record the
        re-promotion). The demotion count is deliberately kept — the
        hysteresis memory that makes a flapping link back off harder
        each cycle."""
        with self._lock:
            was_broken = self._broken
            self._broken = False
            self._probing = False
            self._retry_at = None
            return was_broken

    def close(self) -> None:
        with self._lock:
            if self._ring is not None:
                self._ring.close()
                self._ring = None
            self._broken = True
            self._probing = False
            for off in list(self._charges):
                self._release_charge_locked(off)
            self._outstanding.clear()


def encode_shm_descriptor(name: str, off: int, length: int,
                          orig_header: Dict,
                          job: Optional[str] = None) -> bytes:
    """The descriptor payload for an shm push: where the bytes live, how
    to restore the original frame header on the receiver, and which
    tenant owns the chunk (``j`` — cross-checked against the in-chunk
    job tag and the frame header's job id at adoption)."""
    desc = {
        "n": name,
        "o": int(off),
        "l": int(length),
        "pk": orig_header.get("pkind"),
        "pm": bytes(orig_header.get("pmeta", b"") or b""),
    }
    if job is not None:
        desc["j"] = job
    return msgpack.packb(desc, use_bin_type=True)


# --------------------------------------------------------------------------
# Receiver side: ShmAdopter
# --------------------------------------------------------------------------


class ShmAdopter:
    """Offer-chain wrapper that resolves ``pkind == "shm"`` descriptor
    frames into ring bytes before the rendezvous store sees them.

    Runs pre-ack: a failure here NACKs the descriptor frame with code
    424 synchronously, which the sender maps to resend-on-socket plus
    sticky demotion — mid-job fallback with no payload loss. Attached
    rings are cached by name (bounded LRU) and closed with the proxy."""

    _MAX_RINGS = 64

    def __init__(self, offer):
        self._offer = offer
        self._rings: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()
        # Adoptions already failed under FEDTPU_SHM_FORCE_ATTACH_FAIL=<N>.
        self._forced_failed = 0

    def _forced_attach_fail(self) -> bool:
        """Test hook: ``FEDTPU_SHM_FORCE_ATTACH_FAIL=<N>`` fails the
        next N shm adoptions, then succeeds — the knob the
        demotion→re-promotion chaos tests turn (fail enough adoptions to
        demote the lane, then let the sender's health probe land). A
        non-integer truthy value fails every adoption while set."""
        raw = os.environ.get("FEDTPU_SHM_FORCE_ATTACH_FAIL")
        if not raw:
            return False
        try:
            n = int(raw)
        except ValueError:
            return True
        with self._lock:
            if self._forced_failed < n:
                self._forced_failed += 1
                return True
        return False

    def _get_ring(self, name: str):
        with self._lock:
            ring = self._rings.get(name)
            if ring is not None:
                self._rings.move_to_end(name)
                return ring
        ring = attach_ring(name)
        with self._lock:
            have = self._rings.get(name)
            if have is not None:
                ring.close()
                return have
            self._rings[name] = ring
            while len(self._rings) > self._MAX_RINGS:
                _stale_name, stale = self._rings.popitem(last=False)
                try:
                    stale.close()
                except Exception:  # noqa: BLE001
                    pass
        return ring

    @staticmethod
    def _validate(desc) -> Optional[str]:
        if not isinstance(desc, dict):
            return "shm descriptor is not a map"
        if not isinstance(desc.get("n"), str) or not desc["n"]:
            return "shm descriptor missing ring name"
        for field in ("o", "l"):
            if not isinstance(desc.get(field), int) or desc[field] < 0:
                return f"shm descriptor field {field!r} missing/not int"
        if not isinstance(desc.get("pk"), str):
            return "shm descriptor missing original payload kind"
        if "j" in desc and not isinstance(desc["j"], str):
            return "shm descriptor job tag is not a string"
        return None

    def offer(self, header: Dict, payload) -> Tuple[int, str]:
        if header.get("pkind") != "shm":
            return self._offer(header, payload)
        if self._forced_attach_fail():
            return (
                CODE_SHM_UNAVAILABLE,
                "forced attach failure (FEDTPU_SHM_FORCE_ATTACH_FAIL)",
            )
        try:
            desc = msgpack.unpackb(bytes(payload), raw=False)
        except Exception as e:  # noqa: BLE001 - wire input
            return CODE_INTERNAL_ERROR, f"bad shm descriptor: {e}"
        err = self._validate(desc)
        if err is not None:
            return CODE_INTERNAL_ERROR, err
        try:
            ring = self._get_ring(desc["n"])
            buf = ring.adopt(desc["o"], desc["l"])
        except Exception as e:  # noqa: BLE001 - any attach/map failure
            logger.warning(
                "shm adopt failed for ring %s (%s); NACKing 424 so the "
                "sender falls back to the socket lane", desc.get("n"), e,
            )
            return CODE_SHM_UNAVAILABLE, f"cannot adopt shm chunk: {e}"
        desc_job = desc.get("j")
        if desc_job is not None:
            # Tenancy: the chunk's first 64 bytes are the sender's job
            # tag. All three ids — in-chunk tag, descriptor, frame
            # header — must agree, or the chunk is another tenant's and
            # adopting it would be a cross-job delivery.
            tag = decode_job_tag(memoryview(buf)[:JOB_TAG_LEN])
            header_job = header.get("job")
            if not job_tag_matches(tag, desc_job) or (
                header_job is not None and header_job != desc_job
            ):
                sanitize.probe_tenant_bleed(
                    desc.get("n"), tag, desc_job, header_job
                )
                _tenant_bleed_counter().inc()
                return (
                    CODE_JOB_MISMATCH,
                    f"shm chunk job tag {tag!r} does not match descriptor "
                    f"job {desc_job!r} / frame job {header_job!r}",
                )
            buf = memoryview(buf)[JOB_TAG_LEN:]
        inner = dict(header)
        inner["pkind"] = desc["pk"]
        inner["pmeta"] = desc.get("pm", b"") or b""
        return self._offer(inner, buf)

    def close(self) -> None:
        with self._lock:
            rings = list(self._rings.values())
            self._rings.clear()
        for ring in rings:
            try:
                ring.close()
            except Exception:  # noqa: BLE001
                pass
