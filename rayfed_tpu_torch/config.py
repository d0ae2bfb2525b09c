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

"""Configuration system.

Capability parity: reference ``fed/config.py`` — cluster config (addresses /
current party / TLS) and job config stored in the job-scoped KV so that
transport proxies re-read them from the store rather than from driver
globals (ref ``fed/proxy/barriers.py:137-140,209-212``), plus dataclasses
for cross-silo messaging knobs with ``from_dict`` filtering unknown keys
(ref ``fed/config.py:147-161``).

Device extension: ``PartyMeshConfig`` names the party's device
(``config["party_mesh"]``), the card the CUDA lane places received
tensors on (``mesh.py``).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, List, Optional

import rayfed_tpu_torch._private.constants as constants
from rayfed_tpu_torch._private import kv as internal_kv


class ClusterConfig:
    """Wire-stored cluster-level config (ref ``fed/config.py:15-31``)."""

    def __init__(self, raw_bytes: bytes) -> None:
        self._data = pickle.loads(raw_bytes)

    @property
    def cluster_addresses(self) -> Dict[str, str]:
        return self._data[constants.KEY_OF_CLUSTER_ADDRESSES]

    @property
    def current_party(self) -> str:
        return self._data[constants.KEY_OF_CURRENT_PARTY_NAME]

    @property
    def tls_config(self) -> Dict:
        return self._data[constants.KEY_OF_TLS_CONFIG]


class JobConfig:
    def __init__(self, raw_bytes: Optional[bytes]) -> None:
        self._data = {} if raw_bytes is None else pickle.loads(raw_bytes)

    @property
    def cross_silo_comm_config_dict(self) -> Dict:
        return self._data.get(constants.KEY_OF_CROSS_SILO_COMM_CONFIG_DICT, {})


# Lazy caches keyed per job (ref fed/config.py:46-75 held one slot; two
# concurrent fed.init jobs must each cache their own wire-stored config).
_cluster_configs: Dict[str, ClusterConfig] = {}  # fedlint: disable=global-mutable-singleton (per-job config cache; reset_config_cache() at shutdown)
_job_configs: Dict[str, JobConfig] = {}  # fedlint: disable=global-mutable-singleton (per-job config cache; reset_config_cache() at shutdown)


def get_cluster_config(job_name: str) -> Optional[ClusterConfig]:
    cached = _cluster_configs.get(job_name)
    if cached is None:
        raw = internal_kv.kv_get(job_name, constants.KEY_OF_CLUSTER_CONFIG)
        if raw is None:
            return None
        cached = ClusterConfig(raw)
        _cluster_configs[job_name] = cached
    return cached


def get_job_config(job_name: str) -> JobConfig:
    cached = _job_configs.get(job_name)
    if cached is None:
        cached = JobConfig(
            internal_kv.kv_get(job_name, constants.KEY_OF_JOB_CONFIG)
        )
        _job_configs[job_name] = cached
    return cached


def reset_config_cache(job_name: Optional[str] = None) -> None:
    """Drop cached config — the current job's entries (resolved through
    the tenancy plane) or, with no resolvable job, everything."""
    if job_name is None:
        from rayfed_tpu_torch.tenancy.context import current_job

        job_name = current_job()
    if job_name is None:
        _cluster_configs.clear()
        _job_configs.clear()
    else:
        _cluster_configs.pop(job_name, None)
        _job_configs.pop(job_name, None)


# Receive-path payload cap applied when messages_max_size_in_bytes is
# unset — parity with the reference's gRPC default (grpc_options.py:28-29).
DEFAULT_MAX_MESSAGE_BYTES = 500 * 1024 * 1024

# Canonical transport lane tiers, fastest first. The per-peer tier is
# negotiated at connection setup by ``rayfed_tpu_torch/proxy/lanes.py`` (the
# single transport-selection point); ``cross_silo_comm.lane_tiers``
# restricts/orders the tiers a deployment permits. Kept here (not in
# lanes.py) so config validation needs no proxy import.
LANE_TIERS = ("meshref", "shm", "tcp", "tls", "grpc")


@dataclasses.dataclass
class CrossSiloMessageConfig:
    """Transport-independent cross-party messaging knobs
    (ref ``fed/config.py:78-161``).

    Ray-specific reference knobs that have no meaning for in-process
    thread proxies (``send_resource_label``, ``recv_resource_label`` —
    ref config.py:98-124) are silently dropped by ``from_dict``, so
    reference-written config dicts still load. ``proxy_max_restarts``
    (accept-loop supervision) and ``use_global_proxy`` (per-job proxy
    registry names, consumed by ``fed.init``) ARE honored.

    Attributes:
        timeout_in_ms: per-send timeout (ref default 60000, config.py:126).
        recv_timeout_in_ms: optional deadline for cross-party receives;
            None (default) waits forever like the reference. Set it so a
            pure-receiver party fails fast with TimeoutError when a peer
            vanishes before pushing (no error envelope can cross a dead
            transport — improvement over the reference, which can only
            hang in that case).
        messages_max_size_in_bytes: max payload size. None (default)
            applies the 500MB cap the reference uses for gRPC
            (grpc_options.py:28-29) — on every lane, so an unauthenticated
            peer cannot make the receiver allocate arbitrarily large
            buffers. A non-positive value disables the cap (the 1 TiB
            wire sanity cap still applies).
        serializing_allowed_list: {module: [class, ...]} whitelist for
            unpickling received non-array payloads.
        allow_pickle_payloads: False = strict arrays-only mode — the
            receiver rejects every pickle-kind data frame (error envelopes
            excepted), removing the unpickling attack surface entirely for
            deployments where peers are not fully trusted. Senders fail
            fast on payloads that would need pickling.
        exit_on_sending_failure: SIGINT self when a push ultimately fails.
        expose_error_trace: include the real exception in the
            FedRemoteError envelope sent to peers.
        continue_waiting_for_data_sending_on_error: keep draining queued
            sends during shutdown even after an error was seen.
    """

    timeout_in_ms: int = 60000
    recv_timeout_in_ms: Optional[int] = None
    # Wall-clock budget for one outbound push, shared across ALL of its
    # retry attempts (dial + stream + backoffs). None (default) keeps the
    # legacy shape where only per-attempt timeouts bound a send; set it
    # so a send against a dead peer fails after a predictable total
    # rather than attempts x timeout. Enforced by the unified retry
    # engine (resilience/retry.py) on the native TCP/CUDA lanes.
    send_deadline_in_ms: Optional[int] = None
    messages_max_size_in_bytes: Optional[int] = None
    serializing_allowed_list: Optional[Dict[str, List[str]]] = None
    allow_pickle_payloads: bool = True
    # Optional payload compression on the native TCP/CUDA lanes ("zstd"
    # or "zlib"; None = off). Worth its CPU on bandwidth-constrained DCN
    # links, not on loopback/ICI; zstd (level 1-3) is several times
    # faster than zlib at similar ratios on gradient data.
    # Incompressible payloads ship raw automatically; the gRPC parity
    # lane ignores it (the reference wire has no such field).
    payload_compression: Optional[str] = None
    compression_level: int = 1
    # LOSSY wire precision on the native TCP/CUDA lanes (None = off):
    # "bf16" or "fp16" ships wide-float dense array leaves downcast,
    # halving bytes for fp32 gradient pushes — the standard federated
    # gradient-compression trade (bf16 keeps fp32's exponent range and
    # is the safe choice for gradients; fp16 overflows past 65504).
    # The receiver restores the original dtype, values carry the wire
    # rounding (~2^-8 relative for bf16). Sharded-array leaves, the gRPC
    # parity lane, and the device-DMA lane (device-resident pulls never
    # pass through the host codec) are unaffected — all-jax-Array
    # payloads under ``device_dma: true`` ship native precision.
    # Wire-format note: the downcast rides a tree-meta extension
    # (``odt``); enable only once EVERY party runs a release that
    # understands it — an older receiver would deliver raw bf16/fp16
    # arrays to consumers instead of restored fp32 (deliberately not a
    # WIRE_VERSION bump: that would reject all cross-version traffic,
    # including deployments that never enable this opt-in knob).
    payload_wire_dtype: Optional[str] = None
    # Device-DMA push lane on the CUDA transport (opt-in;
    # proxy/cuda/dma.py): a tree whose every leaf is a tensor on the
    # party's device is snapshotted on it when it resolves and parked on
    # a per-process transfer server; the ordinary socket frame carries
    # only a descriptor (uuid, server address, tree spec, shapes and
    # dtypes, the sender's identity) and the receiver pulls the bytes
    # once: CUDA IPC for a process on the same host and card, a direct
    # copy in the same process, the socket engine otherwise. Any other
    # value rides the socket lane unchanged. ``dma_listen_addr`` is the
    # server's bind address ("host:0" picks a free port), advertised as
    # bound, so cross-host deployments must bind a peer-reachable
    # interface, not loopback. A JAX party cannot pull this lane's
    # descriptors, nor this package the JAX lane's: mixed jobs keep it off.
    device_dma: bool = False
    dma_listen_addr: str = "127.0.0.1:0"
    # Not ported (ROADMAP Queue 1 item 12b): fed.init refuses it; the
    # field stays so a JAX party's comm config parses unchanged.
    # Same-mesh push fast path (opt-in; colocated deployments only):
    # when sender and receiver parties live in ONE process sharing a
    # composed party mesh (mesh.compose_party_mesh — the CPU simulator,
    # single-host test rigs, in-process benches), an all-array payload is
    # lowered to jax.device_put onto the destination party's sub-mesh and
    # only a tiny reference frame crosses the socket. Never enable it for
    # parties in separate processes: the reference cannot resolve there
    # and the send fails loudly at decode.
    same_mesh_push: bool = False
    # Transport lane-tier policy (docs/architecture.md "Lane tiers").
    # ``lane_tiers`` restricts/orders the tiers this party may pick per
    # peer; None (default) permits every tier in the canonical order
    # ``LANE_TIERS`` = meshref > shm > tcp > tls > grpc. Negotiation
    # (proxy/lanes.py) walks the list and picks the first tier whose
    # predicate holds for the peer; failures demote one tier per push.
    lane_tiers: Optional[List[str]] = None
    # Same-host zero-copy shm lane (opt-in, like device_dma): bulk
    # payloads to a peer on this host are written once into a /dev/shm
    # ring and adopted zero-copy by the receiver; only a tiny descriptor
    # frame (plus the ack) crosses the socket. Requires a plaintext
    # same-host peer; every shm failure falls back to the socket lane
    # per push, so enabling it can never lose a send.
    shm_enabled: bool = False
    # Per-peer ring capacity — the in-flight payload BUDGET, not just a
    # buffer: adoption is zero-copy, so every received value the peer
    # still holds pins its chunk. Size it to the peak pipelined payload
    # volume (e.g. 5 concurrent 100MB pushes need >500MB). Bounds
    # sender-side shm memory at ring_mb x peers; pushes that cannot fit
    # wait up to ``shm_push_timeout_ms`` for the receiver to release
    # space, then ride the socket lane.
    shm_ring_mb: int = 256
    # Payloads below this many bytes skip the shm lane: a descriptor
    # frame + ring round-trip cannot beat the inline small-frame path.
    shm_min_bytes: int = 64 * 1024
    # How long a push may wait for ring space before falling back to
    # the socket lane. Short on purpose: a full ring usually means the
    # receiver is HOLDING earlier values (chunks pinned by live decoded
    # views), and the socket delivers a 100MB payload in well under a
    # second — stalling multiple seconds per push to avoid that is the
    # pathological trade.
    shm_push_timeout_ms: int = 250
    # Small-message fast path: payloads at or below this many bytes skip
    # the per-message fixed costs that dominate latency-bound rounds —
    # they ride the compact msgpack encoding (no tree walk for plain
    # scalars/containers), are never compressed or chunked, are sent
    # inline (and coalesced with other queued small frames into one
    # syscall) instead of hopping through the sender worker queue, and
    # are decoded inline on the receiver instead of on the decode pool.
    # 0 disables the fast path entirely. Large-payload behavior is
    # unchanged at any setting.
    small_message_threshold: int = 64 * 1024
    # Frame integrity (opt-in): checksum every DATA payload (crc32c via
    # the native fastwire fast path, zlib.crc32 otherwise) in the frame
    # header; receivers NACK mismatches with CODE_DATA_CORRUPT and the
    # sender retransmits through the normal resend machinery — an
    # in-flight bit flip becomes a recovered retransmit instead of a
    # poisoned decode. CRC-less peers interoperate (header field, not a
    # wire-version bump).
    frame_crc: bool = False
    # Adaptive deadlines from the per-peer LinkHealth estimator
    # (resilience/linkhealth.py; docs/resilience.md "WAN emulation &
    # link health"). When on: ack timeouts become
    # clamp(rtt_timeout_multiple*srtt + 4*rttvar, min_timeout_in_ms,
    # timeout_in_ms) plus a transfer-time allowance for the in-flight
    # payload; recv deadlines gain RTT-multiple slack (only ever
    # EXTENDED, never shrunk); retry backoff is ceilinged at an
    # RTT-multiple once the link is measured. The configured
    # timeout_in_ms stays the hard ceiling in every formula — adaptive
    # can only tighten within [min_timeout_in_ms, timeout_in_ms].
    adaptive_timeouts: bool = True
    rtt_timeout_multiple: float = 8.0
    min_timeout_in_ms: int = 1000
    # Lane re-promotion (docs/architecture.md lane-tier table): after a
    # shm demotion, probe the shm lane again once this many ms have
    # passed without shm traffic, doubling the hold-off on each re-break
    # (hysteresis, capped at 16x) so a flapping link settles on tcp
    # instead of oscillating. 0 = legacy sticky demotion for the life of
    # the job.
    shm_repromote_after_ms: int = 2000
    exit_on_sending_failure: Optional[bool] = False
    expose_error_trace: Optional[bool] = False
    continue_waiting_for_data_sending_on_error: Optional[bool] = False

    def __post_init__(self):
        if self.lane_tiers is not None:
            tiers = tuple(self.lane_tiers)
            unknown = [t for t in tiers if t not in LANE_TIERS]
            if unknown:
                raise ValueError(
                    f"cross_silo_comm.lane_tiers contains unknown tiers "
                    f"{unknown}; known tiers: {list(LANE_TIERS)}"
                )
            if len(set(tiers)) != len(tiers):
                raise ValueError(
                    f"cross_silo_comm.lane_tiers has duplicates: "
                    f"{list(tiers)}"
                )
            if not tiers:
                raise ValueError(
                    "cross_silo_comm.lane_tiers must not be empty "
                    "(omit it to permit every tier)"
                )
            self.lane_tiers = list(tiers)
        if int(self.shm_ring_mb) < 1:
            raise ValueError(
                f"cross_silo_comm.shm_ring_mb must be >= 1, "
                f"got {self.shm_ring_mb}"
            )
        if int(self.shm_min_bytes) < 0:
            raise ValueError(
                f"cross_silo_comm.shm_min_bytes must be >= 0, "
                f"got {self.shm_min_bytes}"
            )
        if int(self.shm_push_timeout_ms) < 0:
            raise ValueError(
                f"cross_silo_comm.shm_push_timeout_ms must be >= 0, "
                f"got {self.shm_push_timeout_ms}"
            )
        if float(self.rtt_timeout_multiple) <= 0:
            raise ValueError(
                f"cross_silo_comm.rtt_timeout_multiple must be > 0, "
                f"got {self.rtt_timeout_multiple}"
            )
        if int(self.min_timeout_in_ms) < 0:
            raise ValueError(
                f"cross_silo_comm.min_timeout_in_ms must be >= 0, "
                f"got {self.min_timeout_in_ms}"
            )
        if int(self.shm_repromote_after_ms) < 0:
            raise ValueError(
                f"cross_silo_comm.shm_repromote_after_ms must be >= 0, "
                f"got {self.shm_repromote_after_ms}"
            )

    def effective_max_message_bytes(self) -> Optional[int]:
        """The payload cap actually enforced on send and receive paths:
        configured value, or 500MB when unset; None (no cap) only when the
        user explicitly configures a non-positive value."""
        v = self.messages_max_size_in_bytes
        if v is None:
            return DEFAULT_MAX_MESSAGE_BYTES
        return None if v <= 0 else v

    def __json__(self) -> str:
        import json

        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, json_str: str) -> "CrossSiloMessageConfig":
        import json

        return cls.from_dict(json.loads(json_str))

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "CrossSiloMessageConfig":
        """Construct from a dict, silently dropping unknown keys
        (ref ``fed/config.py:147-161``)."""
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in field_names})


# RetryPolicy moved to the unified retry engine (resilience/retry.py) so
# every transport shares one backoff implementation; re-exported here
# because config dicts and call sites historically spell it
# ``rayfed_tpu_torch.config.RetryPolicy``.
from rayfed_tpu_torch.resilience.retry import RetryPolicy  # noqa: E402,F401


@dataclasses.dataclass
class TcpCrossSiloMessageConfig(CrossSiloMessageConfig):
    """Knobs specific to the native TCP transport (our default data plane,
    replacing the reference's gRPC channel options,
    ref ``fed/config.py:164-195``).

    Attributes:
        verify_peer_identity: under mutual TLS, require the sender's
            certificate (subject CN or a DNS SAN) to attest the ``src``
            party it claims in each frame; mismatches are rejected with
            code 403. Party certs from ``tools/generate_tls_certs.py``
            carry the party name as CN. Set False for deployments whose
            certs are host-named rather than party-named (those fall back
            to plain shared-CA trust).
        per_party_config: optional {dest_party: {field: value}} overrides
            applied on top of this config for sends to that party (the
            reference's per-destination messages config seam,
            ref ``grpc_proxy.py:156-177``).
        proxy_max_restarts: how many times the receiver's accept loop is
            restarted after an unexpected crash (the reference maps this
            to Ray actor ``max_restarts``, ref ``barriers.py:301-307``).
            0 disables supervision.
        send_window: max unacknowledged frames in flight on the pipelined
            (plaintext) sender lane; bounds resend memory at
            window x payload size. 1 degenerates to half-duplex
            request-response.
        use_reactor: drive plaintext connections from the shared epoll
            reactor loop(s) instead of per-peer reader/writer threads
            (default True where epoll exists). The wire protocol, ack
            semantics, and failure envelope are identical; only the
            threading model changes. TLS connections always use the
            threaded half-duplex path regardless.
        num_reactors: size of the process-wide reactor thread pool that
            connections are distributed over. One loop comfortably
            drives tens of peers; raise it only when a single reactor
            core saturates.
        num_streams: parallel wire lanes per destination for striped
            bulk payloads (reactor mode only). When a ``tree`` payload
            is at least ~1MB and has several buffers (a sharded array's
            per-shard views, a many-leaf gradient pytree), its buffers
            are striped across this many connections concurrently and
            reassembled shard-aligned on the receiver — the sharded
            data plane's host-staging tax killer. 1 (default) keeps the
            single-lane wire byte-for-byte unchanged; K>1 changes only
            framing for payloads that meet the striping gate (both ends
            must run a stripe-aware build). Small frames, compressed
            payloads, error envelopes, and the TLS/device-DMA threaded
            paths never stripe.
    """

    retry_policy: Optional[Dict[str, Any]] = None
    connect_timeout_in_ms: int = 10000
    verify_peer_identity: bool = True
    per_party_config: Optional[Dict[str, Dict[str, Any]]] = None
    proxy_max_restarts: int = 3
    send_window: int = 8
    use_reactor: bool = True
    num_reactors: int = 1
    num_streams: int = 1

    def get_retry_policy(self) -> RetryPolicy:
        return RetryPolicy.from_dict(self.retry_policy)

    def for_dest(self, dest_party: Optional[str]) -> "TcpCrossSiloMessageConfig":
        """The effective config for sends to ``dest_party``: this config
        with any ``per_party_config[dest_party]`` overrides applied."""
        overrides = (self.per_party_config or {}).get(dest_party)
        if not overrides:
            return self
        merged = dataclasses.asdict(self)
        merged.pop("per_party_config", None)
        field_names = {f.name for f in dataclasses.fields(type(self))}
        merged.update(
            {k: v for k, v in overrides.items() if k in field_names}
        )
        return type(self)(**{
            k: v for k, v in merged.items() if k in field_names
        })


# Back-compat alias: the reference spells this GrpcCrossSiloMessageConfig.
GrpcCrossSiloMessageConfig = TcpCrossSiloMessageConfig


@dataclasses.dataclass
class PartyMeshConfig:
    """Device topology for one party (no reference equivalent). A
    one-process party runs on one card (``mesh.resolve_party_device``);
    in torch a mesh over several devices takes one process per device, a
    multi-process party (``config["jax_distributed"]``), whose mesh is a
    DeviceMesh over its process group's ranks (``mesh.init_party_mesh``).

    Attributes:
        device_ids: one process: the CUDA device index (``cuda:<i>``) of
            the party's card, one entry (None = all local devices, which
            must be one). Several processes: the group ranks forming the
            mesh (None = all).
        mesh_shape: logical mesh shape over those devices or ranks.
        axis_names: logical axis names, e.g. ("data",).
        device_type: "cpu" asks for the CPU (the JAX package ignores the
            key); None or "cuda", the party's card.
    """

    device_ids: Optional[List[int]] = None
    mesh_shape: Optional[List[int]] = None
    axis_names: Optional[List[str]] = None
    device_type: Optional[str] = None

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "PartyMeshConfig":
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in field_names})


@dataclasses.dataclass
class AsyncAggregationConfig:
    """Buffered-async aggregation knobs (``config['aggregation']`` keys
    prefixed ``async_``, validated at ``fed.init``; docs/async_rounds.md).

    Attributes:
        buffer_k: accepted contributions per K-publish — FedBuff's buffer
            size. 1 degenerates to pure FedAsync (publish every arrival).
        staleness: decay family applied to a contribution ``s`` rounds
            stale: "poly" ``(1+s)**-exp`` (FedBuff's default), "constant"
            (no decay), or "exp" ``exp**s``.
        staleness_exp: the decay family's parameter.
        server_lr: server learning rate mixing each K-publish into the
            running global model, ``new = old + lr * (mean - old)``.
            1.0 (default) replaces the model with the buffered mean
            exactly (bitwise — no mix arithmetic runs).
        suspect_factor: multiplicative down-weight for contributions from
            SUSPECT parties (liveness view); DEAD parties are dropped
            outright regardless.
        max_staleness: drop contributions more than this many rounds
            stale (None = keep all, decay-weighted).
    """

    buffer_k: int = 2
    staleness: str = "poly"
    staleness_exp: float = 0.5
    server_lr: float = 1.0
    suspect_factor: float = 1.0
    max_staleness: Optional[int] = None

    def __post_init__(self):
        if int(self.buffer_k) < 1:
            raise ValueError(
                f"aggregation.async_buffer_k must be >= 1, "
                f"got {self.buffer_k}"
            )
        self.buffer_k = int(self.buffer_k)
        if self.staleness not in ("poly", "constant", "exp"):
            raise ValueError(
                "aggregation.async_staleness must be 'poly', 'constant' "
                f"or 'exp', got {self.staleness!r}"
            )
        if not (0.0 < float(self.server_lr) <= 1.0):
            raise ValueError(
                f"aggregation.async_server_lr must be in (0, 1], "
                f"got {self.server_lr}"
            )
        if not (0.0 <= float(self.suspect_factor) <= 1.0):
            raise ValueError(
                f"aggregation.async_suspect_factor must be in [0, 1], "
                f"got {self.suspect_factor}"
            )
        if self.max_staleness is not None and int(self.max_staleness) < 0:
            raise ValueError(
                f"aggregation.async_max_staleness must be >= 0 or None, "
                f"got {self.max_staleness}"
            )

    _KEY_PREFIX = "async_"

    @classmethod
    def from_aggregation_dict(
        cls, data: Optional[Dict[str, Any]]
    ) -> "AsyncAggregationConfig":
        """Build from the ``aggregation`` config section's ``async_*``
        keys. Unknown ``async_*`` keys raise (the sync keys — topology,
        group_size — are validated by ``topology.set_default``)."""
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if not key.startswith(cls._KEY_PREFIX):
                continue
            name = key[len(cls._KEY_PREFIX):]
            if name not in field_names:
                known = sorted(cls._KEY_PREFIX + f for f in field_names)
                raise ValueError(
                    f"unknown aggregation config key {key!r}; "
                    f"known async keys: {known}"
                )
            kwargs[name] = value
        return cls(**kwargs)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServingConfig:
    """Inference serving plane knobs (``config['serving']``, docs/serving.md).

    Attributes:
        max_slots: decode rows in the pooled KV cache — the iteration-level
            batch width. Admitted requests beyond this wait in the pending
            queue at token granularity (continuous batching).
        max_len: total positions (prompt + generated) a request may span;
            sizes the pooled cache (one extra sacrificial position is
            allocated internally).
        max_new_tokens: default generation length when a request does not
            specify one.
        max_pending: admission-control bound on the waiting queue; submits
            beyond it fail fast with ``ServerOverloadedError`` instead of
            building unbounded latency.
        temperature: default sampling temperature (0 = greedy).
        eos_id: stop token (None = always decode the full length).
        prefix_reuse: clone a live identical-(version, prompt) donor row
            instead of re-running prefill.
        mode: "continuous" (iteration-level batching, the serving plane) or
            "sequential" (one request at a time — the naive baseline the
            bench compares against).
        prompt_buckets: prefill compiles once per bucket length; prompts
            are right-padded up to the next bucket (padding is causally
            invisible). None = powers of two up to ``max_len``.
        kv_layout: "paged" (block-granular KV pool with on-demand block
            grant — the serving-v2 data path) or "slab" (one contiguous
            ``max_len+1`` row per slot, the PR 8 layout). Bitwise-identical
            outputs on identical traffic; paged admits mixed-length
            traffic without stranding whole rows.
        kv_block_size: positions per KV block (paged layout only).
        kv_blocks: physical blocks in the paged pool (one extra
            sacrificial block is allocated internally). None = slab-
            equivalent capacity: ``max_slots * ceil((max_len+1)/block)``.
        prefill_chunk: prompts longer than this prefill in chunks merged
            into the running decode iteration (chunked prefill) instead of
            one monolithic forward that stalls the live batch.
        prefill_token_budget: max prefill tokens processed per engine
            iteration — the prefill:decode budget that bounds how long a
            long admission can delay the next decode step.
        stream_window: max coalesced token frames in flight per streamed
            request (client streaming backpressure window).
    """

    max_slots: int = 8
    max_len: int = 128
    max_new_tokens: int = 16
    max_pending: int = 64
    temperature: float = 0.0
    eos_id: Optional[int] = None
    prefix_reuse: bool = True
    mode: str = "continuous"
    prompt_buckets: Optional[List[int]] = None
    kv_layout: str = "paged"
    kv_block_size: int = 16
    kv_blocks: Optional[int] = None
    prefill_chunk: int = 32
    prefill_token_budget: int = 64
    stream_window: int = 4

    def __post_init__(self):
        if self.mode not in ("continuous", "sequential"):
            raise ValueError(
                f"serving.mode must be 'continuous' or 'sequential', "
                f"got {self.mode!r}"
            )
        if self.kv_layout not in ("paged", "slab"):
            raise ValueError(
                f"serving.kv_layout must be 'paged' or 'slab', "
                f"got {self.kv_layout!r}"
            )
        if self.max_new_tokens < 1:
            raise ValueError("serving.max_new_tokens must be >= 1")
        if self.max_new_tokens >= self.max_len:
            raise ValueError(
                "serving.max_new_tokens must leave room for a prompt "
                f"(max_new_tokens={self.max_new_tokens} >= "
                f"max_len={self.max_len})"
            )
        if self.kv_block_size < 1:
            raise ValueError("serving.kv_block_size must be >= 1")
        if self.kv_blocks is not None and self.kv_blocks < 1:
            raise ValueError("serving.kv_blocks must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("serving.prefill_chunk must be >= 1")
        if self.prefill_token_budget < self.prefill_chunk:
            raise ValueError(
                "serving.prefill_token_budget must be >= prefill_chunk "
                f"({self.prefill_token_budget} < {self.prefill_chunk})"
            )
        if self.stream_window < 1:
            raise ValueError("serving.stream_window must be >= 1")

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "ServingConfig":
        """STRICT build from ``config['serving']``: unknown keys raise
        with the known-key list (a typo'd knob rejects ``fed.init``
        instead of silently never taking effect)."""
        data = data or {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        for key in data:
            if key not in field_names:
                raise ValueError(
                    f"unknown serving config key {key!r}; known keys: "
                    f"{sorted(field_names)}"
                )
        return cls(**data)


# MembershipConfig lives with the elastic-membership subsystem
# (membership/config.py); re-exported here because job config classes are
# historically spelled ``rayfed_tpu_torch.config.<Name>`` (same pattern as
# RetryPolicy above).
from rayfed_tpu_torch.membership.config import MembershipConfig  # noqa: E402,F401

# PrivacyConfig lives with the privacy plane (privacy/config.py);
# re-exported for the same reason.
from rayfed_tpu_torch.privacy.config import PrivacyConfig  # noqa: E402,F401
