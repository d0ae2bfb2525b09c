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

"""The serving-party request scheduler: admission control + continuous
(iteration-level) batching with hot model swap (port of
``rayfed_tpu/serving/server.py``).

Orca-style continuous batching over the KV pool
(:mod:`rayfed_tpu_torch.serving.kv_pool`): the engine thread alternates
*admission* (pop pending requests into free slots — prefill-then-merge at
a token boundary) with *decode iterations* (ONE batched step over the
whole pool per live model version). A finishing sequence releases its
slot without draining the batch; a newly admitted one joins at the next
iteration.

The host scheduler is the JAX package's: admission, chunked prefill with
a per-step token budget, block grants at token boundaries and the
preemption that breaks a block-pool deadlock, the numpy sampler (so a
seeded request draws the same numbers in both packages), streaming, hot
swap and the registry. What the JAX package compiles with ``jit`` and
``vmap`` are plain PyTorch functions here (:func:`decode_step`,
:func:`prefill_row`, :func:`chunk_row`) on the server's device.

Rows never mix: the pool's batch is a true batch dimension of every op,
and each row attends at its own position (a ``(B,)`` offset), so a
request's output is independent of what shares its batch. Matrix
products give bits that depend on the operand shapes (cuBLAS and oneDNN
pick their kernels by shape), so every program runs at a shape fixed by
the pool and the prompt alone: the decode step always runs all
``max_slots`` rows; a prompt up to ``serving.prefill_chunk`` long
prefills as one batch-1 forward at its bucket length, and a longer one
as the same sequence of chunk forwards (ragged remainder first) in both
layouts — the paged layout merges the chunks into decode iterations, the
slab layout runs them back to back at admission. So the slab and paged
layouts give bitwise-identical outputs on identical traffic, and a
request gives the same tokens alone or under load.

Hot swap: :meth:`InferenceServer.publish` installs a new version in the
:class:`~rayfed_tpu_torch.serving.publish.ModelBank`; requests pin the
version current at their admission and decode against it to completion.
During the handover window the engine runs one batched step per live
version.

Thread model: callers enqueue under the server lock; ONE engine thread
owns the cache tensors and all device work (it binds the server's card
first). A failed step fails every admitted request's future and stops
the engine; later submits raise :class:`ServerStoppedError`.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rayfed_tpu_torch import tracing
from rayfed_tpu_torch.config import ServingConfig
from rayfed_tpu_torch.models import decode
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.serving.kv_pool import KVPool, PagedKVPool
from rayfed_tpu_torch.serving.publish import ModelBank
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics
from rayfed_tpu_torch.utils import DeviceLike

logger = logging.getLogger(__name__)


# -- the device programs (engine thread only) --------------------------------


def decode_step(params, cfg: tfm.TransformerConfig, k, v,
                tokens: np.ndarray, positions: np.ndarray) -> torch.Tensor:
    """ONE batched decode iteration over every pool row: row r feeds
    ``tokens[r]`` at position ``positions[r]`` against cache row r of
    ``k``/``v`` (L, R, T, H, Dh), written in place. Junk rows (free slots,
    other versions' requests) sit at the sacrificial position. Returns the
    rows' logits (R, vocab) f32 on the device."""
    toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(k.device)
    logits, _ = decode.forward_with_cache(
        params, toks[:, None], {"k": k, "v": v},
        np.asarray(positions, np.int64), cfg)
    return logits[:, 0]


def prefill_row(params, cfg: tfm.TransformerConfig, k_row, v_row,
                prompt: np.ndarray, bucket: int) -> torch.Tensor:
    """Prefill one (L, 1, T, H, Dh) cache row from ``prompt`` right-padded
    to ``bucket`` (padding is causally invisible and overwritten by decode
    before any query reaches it). Returns the last real position's logits
    (vocab,) f32."""
    plen = int(prompt.size)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :plen] = prompt
    logits, _ = decode.forward_with_cache(
        params, torch.from_numpy(padded).to(k_row.device),
        {"k": k_row, "v": v_row}, 0, cfg)
    return logits[0, plen - 1]


def chunk_row(params, cfg: tfm.TransformerConfig, k_row, v_row,
              toks: np.ndarray, offset: int) -> torch.Tensor:
    """One prompt chunk against one (L, 1, T, H, Dh) cache row at
    ``offset``; returns the chunk's logits (clen, vocab) f32."""
    logits, _ = decode.forward_with_cache(
        params,
        torch.from_numpy(np.asarray(toks, np.int64)[None]).to(k_row.device),
        {"k": k_row, "v": v_row}, offset, cfg)
    return logits[0]


def chunk_plan(plen: int, chunk: int, chunk_buckets: List[int]):
    """The chunks a prompt longer than ``chunk`` prefills in: (offset,
    real length, padded length) each. The ragged remainder runs FIRST,
    padded to a chunk bucket (its padded writes land inside the prompt and
    are overwritten by the next chunk), so every later chunk is exactly
    ``chunk`` long and the last ends exactly at ``plen``."""
    plan = []
    off = 0
    if plen % chunk:
        real = plen % chunk
        plan.append((0, real, next(b for b in chunk_buckets if b >= real)))
        off = real
    while off < plen:
        plan.append((off, chunk, chunk))
        off += chunk
    return plan


def _to_host(logits: torch.Tensor) -> np.ndarray:
    return logits.detach().to("cpu", torch.float32).numpy()


class ServerOverloadedError(RuntimeError):
    """Admission control rejected the request: the pending queue is at
    ``serving.max_pending``. Back off and resubmit."""


class ServerStoppedError(RuntimeError):
    """The server was stopped before this request was admitted."""


def _default_buckets(max_len: int) -> List[int]:
    """Powers of two up to max_len (always including max_len)."""
    buckets = []
    b = 8
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


@dataclass
class _Request:
    rid: str
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    temperature: float
    seed: int
    mode: str                     # "generate" | "beam" | "speculative"
    n_beams: int
    future: Future
    enqueue_s: float
    version: int = 0
    slot: int = -1
    pos: int = 0                  # next cache write position (= seq length)
    out: List[int] = field(default_factory=list)
    prefix_reuse: bool = False
    rng: Optional[np.random.Generator] = None
    timing: Dict[str, float] = field(default_factory=dict)
    extra_resp: Dict[str, Any] = field(default_factory=dict)
    stream: Any = None            # optional token sink (serving.stream)
    chunk_done: int = 0           # prompt positions chunked-prefilled so far
    stalled: bool = False         # waiting on a KV block grant


class InferenceServer:
    """One party's serving engine. See module docstring for the model.

    Args:
        model_cfg: the served transformer's config (all versions published
            into this server must share it).
        config: :class:`~rayfed_tpu_torch.config.ServingConfig` (or dict).
        params: optional initial params (published as version 1).
        draft_cfg: optional draft-model config enabling
            ``mode="speculative"`` requests (the draft params ride each
            ``publish(..., draft_params=...)``).
        cache_dtype: pooled-cache dtype override.
        device: the server's device: the pool, every published version
            and all decode work live there. None is the party's card
            (``mesh.party_device``); the CPU only when asked for
            (``device="cpu"``).
    """

    def __init__(
        self,
        model_cfg: tfm.TransformerConfig,
        config: Optional[ServingConfig] = None,
        *,
        params: Any = None,
        draft_cfg: Optional[tfm.TransformerConfig] = None,
        cache_dtype=None,
        name: str = "default",
        device: DeviceLike = None,
    ):
        from rayfed_tpu_torch import mesh

        decode.check_decodable(model_cfg)
        if draft_cfg is not None:
            decode.check_decodable(draft_cfg)
        self.device = mesh.party_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.cfg = model_cfg
        self.scfg = config or ServingConfig()
        self.draft_cfg = draft_cfg
        self.name = name
        self.bank = ModelBank(self.device)
        self.layout = self.scfg.kv_layout
        self._cache_dtype = cache_dtype
        if self.layout == "paged":
            self.pool: Any = PagedKVPool(
                model_cfg,
                self.scfg.max_slots,
                self.scfg.max_len,
                cache_dtype,
                block_size=self.scfg.kv_block_size,
                num_blocks=self.scfg.kv_blocks,
                device=self.device,
            )
        else:
            self.pool = KVPool(
                model_cfg, self.scfg.max_slots, self.scfg.max_len,
                cache_dtype, device=self.device,
            )
        self._buckets = sorted(
            self.scfg.prompt_buckets or _default_buckets(self.scfg.max_len)
        )
        self._chunk_buckets = sorted(
            {min(b, self.scfg.prefill_chunk) for b in _default_buckets(
                self.scfg.prefill_chunk)}
        )
        self._special_fns: Dict[tuple, Any] = {}
        self._cast: Dict[int, Any] = {}    # version -> compute-dtype params
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: "deque[_Request]" = deque()
        self._active: Dict[int, _Request] = {}     # slot -> request
        self._prefilling: List[_Request] = []      # chunked prefills
        self._rid_counter = itertools.count()
        self._stopping = False
        self._fatal: Optional[BaseException] = None
        self._last_zerocopy = 0
        self._stats = {
            "submitted": 0,
            "completed": 0,
            "rejected": 0,
            "prefix_hits": 0,
            "tokens_out": 0,
            "steps": 0,
            "prefill_chunks": 0,
            "streamed_tokens": 0,
            "preempted": 0,
            "publish_zerocopy": 0,
        }
        self._latencies_ms: "deque[float]" = deque(maxlen=4096)
        # Telemetry mirrors of the stats dict (docs/observability.md);
        # stats() stays the per-instance source of truth.
        _reg = telemetry_metrics.get_registry()
        _events = _reg.counter(
            "fed_serving_requests_total",
            "Serving requests by lifecycle event.",
            labels=("server", "event"),
        )
        self._m_events = {
            k: _events.labels(server=name, event=k)
            for k in ("submitted", "completed", "rejected")
        }
        self._m_prefix_hits = _reg.counter(
            "fed_serving_prefix_hits_total", "Prefill prefix-cache hits.",
            labels=("server",),
        ).labels(server=name)
        self._m_tokens = _reg.counter(
            "fed_serving_tokens_total", "Tokens generated.",
            labels=("server",),
        ).labels(server=name)
        self._m_steps = _reg.counter(
            "fed_serving_steps_total", "Batched decode iterations.",
            labels=("server",),
        ).labels(server=name)
        self._m_pending = _reg.gauge(
            "fed_serving_pending", "Requests awaiting admission.",
            labels=("server",),
        ).labels(server=name)
        self._m_active = _reg.gauge(
            "fed_serving_active", "Requests in the decode batch.",
            labels=("server",),
        ).labels(server=name)
        self._m_latency = _reg.histogram(
            "fed_serving_latency_ms",
            "End-to-end request latency (enqueue to finish).",
            labels=("server",),
        ).labels(server=name)
        self._m_kv_in_use = _reg.gauge(
            "fed_serving_kv_blocks_in_use",
            "KV blocks resident for live requests (slots, slab layout).",
            labels=("server",),
        ).labels(server=name)
        self._m_kv_free = _reg.gauge(
            "fed_serving_kv_blocks_free",
            "KV blocks on the free list (slots, slab layout).",
            labels=("server",),
        ).labels(server=name)
        self._m_chunks = _reg.counter(
            "fed_serving_prefill_chunks_total",
            "Prompt chunks merged into decode iterations.",
            labels=("server",),
        ).labels(server=name)
        self._m_streamed = _reg.counter(
            "fed_serving_streamed_tokens_total",
            "Tokens pushed to streaming sinks.",
            labels=("server",),
        ).labels(server=name)
        self._m_preempted = _reg.counter(
            "fed_serving_preemptions_total",
            "Requests preempted to break a KV block-pool deadlock.",
            labels=("server",),
        ).labels(server=name)
        self._m_zerocopy = _reg.counter(
            "fed_serving_publish_zerocopy_total",
            "Published leaves adopted as zero-copy shm views.",
            labels=("server",),
        ).labels(server=name)
        self._update_kv_gauges()
        if params is not None:
            self.bank.publish(params)
        self._engine = threading.Thread(
            target=self._engine_loop,
            name=f"fedtpu-serve-{name}",
            daemon=True,
        )
        self._engine.start()


    # -- client surface --------------------------------------------------

    def publish(self, params: Any, *, draft_params: Any = None) -> int:
        """Atomically install a new model version; in-flight requests
        finish on the version they pinned at admission. Leaves that
        arrived as shm-ring views are adopted zero-copy (the bank's
        reference keeps the receiver-owned chunk alive — no adoption
        copy); the saved copies show up in
        ``fed_serving_publish_zerocopy_total``."""
        version = self.bank.publish(params, draft_params=draft_params)
        adopted = self.bank.zerocopy_adopted()
        if adopted > self._last_zerocopy:
            delta = adopted - self._last_zerocopy
            self._last_zerocopy = adopted
            self._m_zerocopy.inc(delta)
            with self._lock:
                self._stats["publish_zerocopy"] += delta
        tracing.record_request(
            f"publish-v{version}", "publish", version=version
        )
        logger.info("serving[%s]: published model version %d",
                    self.name, version)
        return version

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
        mode: str = "generate",
        n_beams: int = 4,
        stream: Any = None,
    ) -> Future:
        """Enqueue one request; returns a Future of the response dict.

        ``stream`` optionally attaches a token sink (an object with
        ``push``/``reset``/``fail`` — see :mod:`serving.stream`); the
        engine pushes every sampled token into it without ever blocking
        on the consumer.

        Admission control is synchronous: a full pending queue raises
        :class:`ServerOverloadedError` here, on the submitter, rather
        than growing unbounded latency inside the engine.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if mode not in ("generate", "beam", "speculative"):
            raise ValueError(f"unknown request mode {mode!r}")
        if mode == "speculative" and self.draft_cfg is None:
            raise ValueError(
                "mode='speculative' needs a server started with draft_cfg"
            )
        max_new = int(max_new_tokens or self.scfg.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new > self.scfg.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds serving.max_len ({self.scfg.max_len})"
            )
        if self.layout == "paged" and mode == "generate":
            # Worst-case resident blocks for this request (highest
            # written position is prompt + generation - 2). A request
            # that could never fit the whole pool must fail HERE, not
            # livelock admission.
            hi = prompt.size + max(0, max_new - 2)
            need = hi // self.pool.block_size + 1
            if need > self.pool.num_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks at worst but the "
                    f"pool has {self.pool.num_blocks} "
                    "(serving.kv_blocks)"
                )
        temp = self.scfg.temperature if temperature is None else temperature
        fut: Future = Future()
        now = time.perf_counter()
        with self._cond:
            if self._fatal is not None:
                raise ServerStoppedError(
                    f"serving engine died: {self._fatal!r}"
                )
            if self._stopping:
                raise ServerStoppedError("server is stopped")
            if len(self._pending) >= self.scfg.max_pending:
                self._stats["rejected"] += 1
                self._m_events["rejected"].inc()
                raise ServerOverloadedError(
                    f"pending queue full ({self.scfg.max_pending}); "
                    "back off and resubmit"
                )
            rid = f"{self.name}-{next(self._rid_counter)}"
            req = _Request(
                rid=rid,
                prompt=prompt,
                max_new_tokens=max_new,
                temperature=float(temp),
                seed=int(seed),
                mode=mode,
                n_beams=int(n_beams),
                future=fut,
                enqueue_s=now,
                stream=stream,
            )
            req.timing["enqueue"] = now
            self._stats["submitted"] += 1
            self._m_events["submitted"].inc()
            self._pending.append(req)
            self._m_pending.set(len(self._pending))
            self._cond.notify_all()
        tracing.record_request(rid, "enqueue", t_s=now,
                               prompt_len=int(prompt.size), mode=mode)
        return fut

    def submit_and_wait(self, prompt, **opts) -> Dict[str, Any]:
        return self.submit(prompt, **opts).result()

    def submit_stream(self, prompt, **opts):
        """Submit with an in-process token stream attached; returns
        ``(future, stream)``. Iterate the stream for tokens as they are
        sampled; the future resolves to the usual response dict."""
        from rayfed_tpu_torch.serving.stream import LocalTokenStream

        stream = LocalTokenStream()
        fut = self.submit(prompt, stream=stream, **opts)
        return fut, stream

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            out["pending"] = len(self._pending)
            out["active"] = len(self._active) + len(self._prefilling)
            lats = list(self._latencies_ms)
        out["kv_layout"] = self.layout
        if self.layout == "paged":
            out["kv_blocks_in_use"] = self.pool.blocks_in_use
            out["kv_blocks_free"] = self.pool.blocks_free
            out["kv_block_size"] = self.pool.block_size
        else:
            out["kv_blocks_in_use"] = (
                self.pool.max_slots - self.pool.free_count
            )
            out["kv_blocks_free"] = self.pool.free_count
        out["current_version"] = self.bank.current_version()
        out["swaps"] = self.bank.swap_count()
        out["live_versions"] = self.bank.live_versions()
        if lats:
            out["p50_ms"] = float(np.percentile(lats, 50))
            out["p99_ms"] = float(np.percentile(lats, 99))
        return out

    def stop(self, timeout: float = 30.0) -> None:
        """Stop admission, finish ACTIVE requests, fail still-pending
        ones with :class:`ServerStoppedError`, and join the engine."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._engine.join(timeout)


    def _engine_loop(self) -> None:
        try:
            if self.device.type == "cuda":
                # The engine owns all device work; bind the server's card
                # in this thread (a new thread starts on the default one).
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                self._engine_iterations()
        except BaseException as e:  # noqa: BLE001 - fail loud, never hang
            logger.exception("serving[%s]: engine died", self.name)
            self._fail_all(e)

    def _engine_iterations(self) -> None:
        while True:
            with self._cond:
                while (
                    not self._stopping
                    and not self._pending
                    and not self._active
                    and not self._prefilling
                ):
                    self._cond.wait(0.05)
                if self._stopping:
                    # Drain policy: admitted requests (active OR
                    # mid-chunked-prefill) complete, queued ones fail
                    # fast (they were never admitted, the no-abort
                    # guarantee starts at admission).
                    pending, self._pending = self._pending, deque()
                    if (
                        not self._active
                        and not self._prefilling
                        and not pending
                    ):
                        return
                else:
                    pending = None
            if pending:
                for req in pending:
                    exc = ServerStoppedError(
                        "server stopped before admission"
                    )
                    if req.stream is not None:
                        req.stream.fail(exc)
                    req.future.set_exception(exc)
            # Decode steps before prefill chunks: freed blocks go to
            # the oldest (already-decoding) requests first, so a
            # preemption's memory cannot be stolen by new work
            # (which would livelock the batch under block pressure).
            progressed = self._admit()
            progressed = self._step_groups() or progressed
            progressed = self._prefill_tick() or progressed
            self._update_kv_gauges()
            if not progressed and not self._maybe_preempt():
                # Blocked on something external (another tenant's
                # quota, a consumer): bounded backoff, not a hot spin.
                with self._cond:
                    self._cond.wait(0.005)

    def _update_kv_gauges(self) -> None:
        if self.layout == "paged":
            self._m_kv_in_use.set(self.pool.blocks_in_use)
            self._m_kv_free.set(self.pool.blocks_free)
        else:
            free = self.pool.free_count
            self._m_kv_in_use.set(self.pool.max_slots - free)
            self._m_kv_free.set(free)

    def _fail_all(self, exc: BaseException) -> None:
        with self._cond:
            self._fatal = exc
            doomed = (
                list(self._pending)
                + list(self._active.values())
                + list(self._prefilling)
            )
            self._pending.clear()
            self._active.clear()
            self._prefilling.clear()
            self._m_pending.set(0)
            self._m_active.set(0)
        for req in doomed:
            if req.stream is not None:
                req.stream.fail(exc)
            if not req.future.done():
                req.future.set_exception(exc)

    def _admit(self) -> bool:
        """Prefill-then-merge: move pending requests into free slots.
        Runs between decode iterations — a token boundary for every
        in-flight sequence. Returns True when anything was admitted."""
        admitted = 0
        batch: List[_Request] = []
        while True:
            with self._lock:
                if not self._pending:
                    break
                if any(r.stalled for r in self._active.values()) or any(
                    r.stalled for r in self._prefilling
                ):
                    # Someone admitted is starved for KV blocks: every
                    # free (or about-to-be-freed) block is spoken for.
                    # Admitting more would steal it and livelock.
                    break
                if self.scfg.mode == "sequential" and (
                    self._active or self._prefilling or batch
                ):
                    # Naive baseline: strictly one request end-to-end at
                    # a time (specials already serialize on the engine).
                    break
                req = self._pending[0]
                if req.mode == "generate":
                    slot = self.pool.acquire()
                    if slot is None:
                        break
                else:
                    slot = -1
                self._pending.popleft()
                self._m_pending.set(len(self._pending))
            try:
                if self.layout == "paged" and req.mode == "generate":
                    outcome = self._admit_paged(req, slot, batch)
                    if outcome == "flush":
                        self._batched_prefill(batch)
                        batch = []
                        outcome = self._admit_paged(req, slot, batch)
                    if outcome == "blocked":
                        # Slot handed back, request re-queued at the
                        # front: nothing later in the queue can be
                        # smaller-than-FIFO-fair, stop admitting.
                        break
                    admitted += 1
                else:
                    self._admit_one(req, slot)
                    admitted += 1
            except BaseException as e:  # noqa: BLE001 - per-request fault
                # A bad request (or a bug in its path) fails ITS future;
                # the batch and the engine keep serving everyone else.
                if slot >= 0:
                    self.pool.release(slot)
                if req.version:
                    self.bank.release(req.version)
                    req.version = 0
                if req.stream is not None:
                    req.stream.fail(e)
                if not req.future.done():
                    req.future.set_exception(e)
        self._batched_prefill(batch)
        return admitted > 0


    def _admit_one(self, req: _Request, slot: int) -> None:
        req.version, _ = self.bank.acquire()
        params = self._compute_params(req.version)
        now = time.perf_counter()
        req.timing["admit"] = now
        tracing.record_request(req.rid, "admit", t_s=now,
                               version=req.version, slot=slot)
        if req.mode != "generate":
            self._run_special(req, params)
            return
        req.slot = slot
        req.rng = np.random.default_rng(req.seed)
        plen = int(req.prompt.size)
        prompt_key = req.prompt.tobytes()

        donor = None
        if self.scfg.prefix_reuse:
            donor = self.pool.lookup_prefix(req.version, prompt_key)
        if donor is not None and donor != slot:
            # Clone the donor's row (its prompt region is exactly what
            # prefill wrote — decode never touches positions < plen),
            # then one single-row step re-derives the last-position
            # logits; the full prompt forward is skipped.
            self.pool.copy_row(donor, slot)
            last = self._single_row_step(
                params, slot, int(req.prompt[-1]), plen - 1
            )
            req.prefix_reuse = True
            self._stats["prefix_hits"] += 1
            self._m_prefix_hits.inc()
        else:
            k_row, v_row = self.pool.row(slot)
            chunk = self.scfg.prefill_chunk
            if plen <= chunk:
                last = _to_host(prefill_row(
                    params, self.cfg, k_row, v_row, req.prompt,
                    self._bucket(plen)))
            else:
                # The paged layout's chunk sequence, run back to back in
                # the pool row: the same programs at the same shapes, so
                # both layouts give the same bits.
                for off, real, clen in chunk_plan(
                        plen, chunk, self._chunk_buckets):
                    toks = np.zeros(clen, np.int64)
                    toks[:real] = req.prompt[off:off + real]
                    logits = chunk_row(params, self.cfg, k_row, v_row,
                                       toks, off)
                last = _to_host(logits[real - 1])
        self._post_prefill(req, last)

    def _bucket(self, plen: int) -> int:
        bucket = next(
            (b for b in self._buckets if b >= plen), self._buckets[-1]
        )
        return max(bucket, plen)

    def _post_prefill(self, req: _Request, last_logits: np.ndarray) -> None:
        """Shared admission tail (both layouts, batched/chunked/donor
        paths): record the prefix donor, sample the first token, and
        either finish or join the decode batch."""
        plen = int(req.prompt.size)
        self.pool.note_prefix(req.slot, req.version, req.prompt.tobytes())
        now = time.perf_counter()
        req.timing["prefill"] = now
        tracing.record_request(req.rid, "prefill", t_s=now,
                               reused=req.prefix_reuse)
        tok = self._sample(last_logits, req)
        req.out.append(tok)
        req.pos = plen
        now = time.perf_counter()
        req.timing["first_token"] = now
        tracing.record_request(req.rid, "first_token", t_s=now)
        self._emit_token(req, tok)
        if len(req.out) >= req.max_new_tokens or tok == self.scfg.eos_id:
            self._finish(req)
        else:
            with self._lock:
                self._active[req.slot] = req
                self._m_active.set(len(self._active))

    # -- paged admission / chunked prefill -------------------------------

    def _acquire_version(self, req: _Request):
        """Pin the current version — or, for a preempted request, reuse
        the pin it kept (the deterministic re-run must see the SAME
        params, and the pin stops the bank retiring them)."""
        if not req.version:
            req.version, _ = self.bank.acquire()
        return self._compute_params(req.version)

    def _compute_params(self, version: int):
        """``version``'s params in the compute dtype, cast once per version
        (:func:`decode.cast_params`: the same bits as casting at every
        use). Engine thread only; retired versions are dropped here."""
        params = self._cast.get(version)
        if params is None:
            live = set(self.bank.live_versions())
            for v in [v for v in self._cast if v not in live]:
                del self._cast[v]
            params = self._cast[version] = decode.cast_params(
                self.bank.get(version), self.cfg)
        return params

    def _admit_paged(self, req: _Request, slot: int, batch: List[_Request]) -> str:
        """Admit one generate request under the paged layout. Returns
        "ok" (admitted: into ``batch``, ``self._prefilling``, or already
        running via a prefix donor) or "blocked" (no KV blocks for even
        its first chunk — slot returned, request re-queued at the
        front)."""
        params = self._acquire_version(req)
        now = time.perf_counter()
        req.timing["admit"] = now
        tracing.record_request(req.rid, "admit", t_s=now,
                               version=req.version, slot=slot)
        req.slot = slot
        req.rng = np.random.default_rng(req.seed)
        plen = int(req.prompt.size)
        prompt_key = req.prompt.tobytes()
        if self.scfg.prefix_reuse:
            donor = self.pool.lookup_prefix(req.version, prompt_key)
            if donor is None and any(
                r.version == req.version
                and r.prompt.tobytes() == prompt_key
                for r in batch
            ):
                # Our donor-to-be is sitting in the un-prefilled batch:
                # flush it first (the caller re-tries us), so identical
                # prompts admitted in one round still share blocks.
                return "flush"
            if donor is not None and donor != slot:
                # Prefix reuse is a block-table copy: share the donor's
                # fully-prompt blocks, clone only the boundary block,
                # then one single-row step re-derives the last-position
                # logits.
                status = self.pool.adopt_prefix(donor, slot, plen)
                if status == "ok":
                    last = self._single_row_step_paged(
                        params, slot, int(req.prompt[-1]), plen - 1
                    )
                    req.prefix_reuse = True
                    self._stats["prefix_hits"] += 1
                    self._m_prefix_hits.inc()
                    self._post_prefill(req, last)
                    return "ok"
                # fall through: no blocks for the boundary clone — the
                # plain grant below will hit the same wall and re-queue.
        chunk = self.scfg.prefill_chunk
        if plen <= chunk:
            status = self.pool.ensure_blocks(slot, plen - 1)
            if status != "ok":
                return self._admission_blocked(req, status)
            batch.append(req)
            return "ok"
        # Chunked prefill: the ragged remainder runs FIRST so every
        # later chunk is exactly `chunk` long and ends exactly at plen.
        first = plen % chunk or chunk
        status = self.pool.ensure_blocks(slot, first - 1)
        if status != "ok":
            return self._admission_blocked(req, status)
        req.chunk_done = 0
        with self._lock:
            self._prefilling.append(req)
        return "ok"

    def _quota_hopeless(self, req: _Request) -> bool:
        """True when a "quota" grant failure can never clear: every
        kv_block charged to this tenant is already ours (``req``'s own
        grants included), so no future release can make room."""
        from rayfed_tpu_torch.tenancy.qos import get_ledger

        own = self.pool.granted(req.slot) if req.slot >= 0 else 0
        in_use = get_ledger().in_use(self.pool._job, "kv_blocks")
        return in_use - own <= 0

    def _fail_admitted(self, req: _Request, exc: BaseException) -> None:
        """Hard-fail an already-admitted request (engine thread only)."""
        with self._lock:
            if self._active.get(req.slot) is req:
                del self._active[req.slot]
                self._m_active.set(len(self._active))
            if req in self._prefilling:
                self._prefilling.remove(req)
        if req.slot >= 0:
            self.pool.release(req.slot)
            req.slot = -1
        if req.version:
            self.bank.release(req.version)
            req.version = 0
        if req.stream is not None:
            req.stream.fail(exc)
        if not req.future.done():
            req.future.set_exception(exc)

    def _quota_exc(self, req: _Request) -> BaseException:
        from rayfed_tpu_torch.tenancy.qos import TenantQuotaExceeded, get_ledger

        from rayfed_tpu_torch.tenancy.context import get_context

        job = self.pool._job
        ctx = get_context(job) if job else None
        limit = ctx.tenancy.kv_block_quota if ctx else 0
        return TenantQuotaExceeded(
            job, "kv_blocks", 1,
            get_ledger().in_use(job, "kv_blocks"), limit or 0,
        )

    def _admission_blocked(self, req: _Request, status: str) -> str:
        """No KV blocks at admission: hand the slot back and re-queue at
        the front — unless the quota can NEVER be satisfied (nothing
        else of ours is charged against it), which is a loud per-request
        failure, not a wait."""
        if status == "quota" and self._quota_hopeless(req):
            self._fail_admitted(req, self._quota_exc(req))
            return "failed"
        self.pool.release(req.slot)
        req.slot = -1
        # Keep the version pin across the wait (determinism on re-run).
        with self._cond:
            self._pending.appendleft(req)
            self._m_pending.set(len(self._pending))
        return "blocked"


    def _batched_prefill(self, batch: List[_Request]) -> None:
        """Prefill every short-prompt request admitted this round, grouped
        per (version, bucket) as in the JAX package. Each row runs as its
        own batch-1 forward on a fresh zero row (the slab layout's
        prefill program at the slab layout's shape; masked positions
        cannot contribute, so fresh or recycled rows give the same bits)
        and is scattered through its block table."""
        if not batch:
            return
        groups: Dict[tuple, List[_Request]] = {}
        for req in batch:
            bucket = self._bucket(int(req.prompt.size))
            groups.setdefault((req.version, bucket), []).append(req)
        T = self.pool.row_len
        for version, bucket in sorted(groups):
            reqs = groups[(version, bucket)]
            try:
                params = self._compute_params(version)
                lasts = []
                for req in reqs:
                    row = decode.init_cache(
                        self.cfg, 1, T, self._cache_dtype, self.device)
                    lasts.append(prefill_row(
                        params, self.cfg, row["k"], row["v"], req.prompt,
                        bucket))
                    self.pool.scatter_slot(req.slot, row["k"], row["v"])
                last_np = _to_host(torch.stack(lasts))
                for req, last in zip(reqs, last_np):
                    self._post_prefill(req, last)
            except BaseException as e:  # noqa: BLE001 - per-group fault
                for req in reqs:
                    if req.slot >= 0:
                        self.pool.release(req.slot)
                        req.slot = -1
                    if req.version:
                        self.bank.release(req.version)
                        req.version = 0
                    if req.stream is not None:
                        req.stream.fail(e)
                    if not req.future.done():
                        req.future.set_exception(e)

    def _prefill_tick(self) -> bool:
        """Advance chunked prefills by at most ``prefill_token_budget``
        prompt tokens, merged between decode iterations so long prompts
        never stall the live batch. Returns True if any chunk ran."""
        with self._lock:
            work = list(self._prefilling)
            if any(r.stalled for r in self._active.values()):
                # A decode row is starved: leave every free block to it
                # (decode-first priority; see _engine_loop).
                return False
        if not work:
            return False
        budget = self.scfg.prefill_token_budget
        chunk = self.scfg.prefill_chunk
        ran = False
        for req in work:
            if budget < chunk:
                break
            try:
                plen = int(req.prompt.size)
                off = req.chunk_done
                plan = chunk_plan(plen, chunk, self._chunk_buckets)
                _, real, clen = next(c for c in plan if c[0] == off)
                status = self.pool.ensure_blocks(req.slot, off + real - 1)
                if status != "ok":
                    if status == "quota" and self._quota_hopeless(req):
                        self._fail_admitted(req, self._quota_exc(req))
                    else:
                        req.stalled = True
                    continue
                req.stalled = False
                toks = np.zeros(clen, np.int64)
                toks[:real] = req.prompt[off:off + real]
                params = self._compute_params(req.version)
                k_row, v_row = self.pool.gather_slot(req.slot)
                logits = chunk_row(params, self.cfg, k_row, v_row, toks, off)
                self.pool.scatter_slot(req.slot, k_row, v_row)
                req.chunk_done = off + real
                budget -= clen
                ran = True
                with self._lock:
                    self._stats["prefill_chunks"] += 1
                self._m_chunks.inc()
                if req.chunk_done >= plen:
                    with self._lock:
                        self._prefilling.remove(req)
                    self._post_prefill(req, _to_host(logits[real - 1]))
            except BaseException as e:  # noqa: BLE001 - per-request fault
                with self._lock:
                    if req in self._prefilling:
                        self._prefilling.remove(req)
                if req.slot >= 0:
                    self.pool.release(req.slot)
                    req.slot = -1
                if req.version:
                    self.bank.release(req.version)
                    req.version = 0
                if req.stream is not None:
                    req.stream.fail(e)
                if not req.future.done():
                    req.future.set_exception(e)
        return ran

    def _single_row_step_paged(
        self, params, slot: int, token: int, pos: int
    ) -> np.ndarray:
        """Paged twin of :meth:`_single_row_step`: gather -> the SAME
        step program -> scatter the one written position."""
        R = self.pool.max_slots
        tables = np.zeros((R, self.pool.blocks_per_row), np.int32)
        tables[slot] = self.pool.table(slot)
        tokens = np.zeros(R, np.int64)
        positions = np.full(R, self.pool.junk_pos, np.int64)
        tokens[slot] = token
        positions[slot] = pos
        wblocks = np.zeros(R, np.int64)
        woffs = np.zeros(R, np.int64)
        wblocks[slot], woffs[slot] = self.pool.write_target(slot, pos)
        k_g, v_g = self.pool.gather(tables)
        logits = decode_step(params, self.cfg, k_g, v_g, tokens, positions)
        self.pool.scatter_step(k_g, v_g, positions, wblocks, woffs)
        return _to_host(logits[slot])

    def _emit_token(self, req: _Request, tok: int) -> None:
        if req.stream is None:
            return
        req.stream.push(len(req.out) - 1, [tok], False)
        with self._lock:
            self._stats["streamed_tokens"] += 1
        self._m_streamed.inc()

    def _maybe_preempt(self) -> bool:
        """Deadlock breaker: when an iteration made no progress and
        someone is stalled on a block grant, preempt the youngest
        admitted request — release its blocks, re-queue it, and let it
        deterministically re-run later (same version pin, same rng seed
        => bit-identical tokens, so streams just skip the replay).
        Returns True when a victim was taken (the loop should retry
        immediately rather than back off)."""
        with self._lock:
            victims = list(self._active.values()) + list(self._prefilling)
            stalled = [r for r in victims if r.stalled]
        if len(victims) < 2 or not stalled:
            # A lone stalled request has nobody to yield to it; its
            # grant can only be waiting on another tenant's release.
            return False
        victim = max(victims, key=lambda r: r.enqueue_s)
        self._preempt(victim)
        return True

    def _preempt(self, req: _Request) -> None:
        with self._lock:
            if self._active.get(req.slot) is req:
                del self._active[req.slot]
                self._m_active.set(len(self._active))
            if req in self._prefilling:
                self._prefilling.remove(req)
        self.pool.release(req.slot)
        req.slot = -1
        req.out = []
        req.pos = 0
        req.chunk_done = 0
        req.stalled = False
        req.prefix_reuse = False
        if req.stream is not None:
            req.stream.reset()
        with self._cond:
            self._stats["preempted"] += 1
            self._pending.appendleft(req)
            self._m_pending.set(len(self._pending))
            self._cond.notify_all()
        self._m_preempted.inc()
        tracing.record_request(req.rid, "preempt")
        logger.info("serving[%s]: preempted %s to free KV blocks",
                    self.name, req.rid)


    def _single_row_step(self, params, slot: int, token: int, pos: int):
        """One pool iteration with only ``slot`` live (all other rows are
        junk regardless of their state — their write goes to the
        sacrificial position, their real cache is untouched)."""
        b = self.pool.max_slots
        tokens = np.zeros(b, np.int64)
        positions = np.full(b, self.pool.junk_pos, np.int64)
        tokens[slot] = token
        positions[slot] = pos
        k, v = self.pool.kv
        logits = decode_step(params, self.cfg, k, v, tokens, positions)
        return _to_host(logits[slot])

    def _step_groups(self) -> bool:
        """One decode iteration: a batched pool step per live version
        group. Params differ across groups but shapes do not. Returns True
        when any request advanced a token."""
        with self._lock:
            groups: Dict[int, List[_Request]] = {}
            for req in self._active.values():
                groups.setdefault(req.version, []).append(req)
        if not groups:
            return False
        b = self.pool.max_slots
        progressed = False
        for version in sorted(groups):
            reqs = groups[version]
            params = self._compute_params(version)
            if self.layout == "paged":
                # Grant each live row's next block at this token
                # boundary; a row that cannot get one sits out the
                # iteration as junk (and flags itself for the preemption
                # check) — decode never stalls the whole batch.
                live = []
                for req in reqs:
                    status = self.pool.ensure_blocks(req.slot, req.pos)
                    if status == "ok":
                        req.stalled = False
                        live.append(req)
                    elif status == "quota" and self._quota_hopeless(req):
                        self._fail_admitted(req, self._quota_exc(req))
                    else:
                        req.stalled = True
                if not live:
                    continue
                tables = np.zeros(
                    (b, self.pool.blocks_per_row), np.int32
                )
                tokens = np.zeros(b, np.int64)
                positions = np.full(b, self.pool.junk_pos, np.int64)
                wblocks = np.zeros(b, np.int64)
                woffs = np.zeros(b, np.int64)
                for req in live:
                    tables[req.slot] = self.pool.table(req.slot)
                    tokens[req.slot] = req.out[-1]
                    positions[req.slot] = req.pos
                    wblocks[req.slot], woffs[req.slot] = (
                        self.pool.write_target(req.slot, req.pos)
                    )
                k_g, v_g = self.pool.gather(tables)
                logits = decode_step(params, self.cfg, k_g, v_g, tokens,
                                     positions)
                self.pool.scatter_step(k_g, v_g, positions, wblocks, woffs)
                reqs = live
            else:
                tokens = np.zeros(b, np.int64)
                positions = np.full(b, self.pool.junk_pos, np.int64)
                for req in reqs:
                    tokens[req.slot] = req.out[-1]
                    positions[req.slot] = req.pos
                k, v = self.pool.kv
                logits = decode_step(params, self.cfg, k, v, tokens,
                                     positions)
            self._stats["steps"] += 1
            self._m_steps.inc()
            logits_np = _to_host(logits)
            for req in reqs:
                tok = self._sample(logits_np[req.slot], req)
                req.out.append(tok)
                req.pos += 1
                progressed = True
                self._emit_token(req, tok)
                if (
                    len(req.out) >= req.max_new_tokens
                    or tok == self.scfg.eos_id
                ):
                    with self._lock:
                        self._active.pop(req.slot, None)
                        self._m_active.set(len(self._active))
                    self._finish(req)
        return progressed

    def _sample(self, logits: np.ndarray, req: _Request) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / req.temperature
        z -= z.max()
        p = np.exp(z)
        # Inverse-CDF draw: one uniform from the request's own rng, one
        # searchsorted. Semantically Generator.choice(p=...), but ~20x
        # cheaper — at 8 samples per batched iteration, choice() was the
        # single largest per-token cost in the engine.
        cdf = np.cumsum(p)
        u = req.rng.random() * cdf[-1]
        return int(min(np.searchsorted(cdf, u, side="right"),
                       logits.shape[0] - 1))

    def _finish(self, req: _Request) -> None:
        if req.stream is not None:
            req.stream.push(len(req.out), [], True)
        if req.slot >= 0:
            self.pool.release(req.slot)
            req.slot = -1
        self.bank.release(req.version)
        now = time.perf_counter()
        req.timing["finish"] = now
        latency_ms = (now - req.enqueue_s) * 1e3
        with self._lock:
            self._stats["completed"] += 1
            self._m_events["completed"].inc()
            self._stats["tokens_out"] += len(req.out)
            self._m_tokens.inc(len(req.out))
            self._m_latency.observe(latency_ms)
            self._latencies_ms.append(latency_ms)
        tracing.record_request(req.rid, "finish", t_s=now,
                               n_new=len(req.out), version=req.version)
        resp: Dict[str, Any] = {
            "request_id": req.rid,
            "tokens": [int(t) for t in req.out],
            "prompt_len": int(req.prompt.size),
            "version": int(req.version),
            "mode": req.mode,
            "prefix_reuse": bool(req.prefix_reuse),
            "timing": {k: float(v) for k, v in req.timing.items()},
            "latency_ms": float(latency_ms),
        }
        resp.update(req.extra_resp)
        req.future.set_result(resp)


    # -- beam / speculative (whole-request paths) ------------------------

    def _run_special(self, req: _Request, params) -> None:
        """Beam/speculative requests run as one whole-generation call on
        the engine thread (they have their own internal batching and do
        not join the iteration-level batch; admission still pins a
        version, so swap semantics are identical)."""
        plen = int(req.prompt.size)
        prompt = torch.from_numpy(req.prompt.astype(np.int64)[None]).to(
            self.device)
        if req.mode == "beam":
            key = ("beam", req.max_new_tokens, req.n_beams, plen)
            fn = self._special_fns.get(key)
            if fn is None:
                fn = decode.make_beam_search_fn(
                    self.cfg,
                    max_new_tokens=req.max_new_tokens,
                    n_beams=req.n_beams,
                    eos_id=self.scfg.eos_id,
                )
                self._special_fns[key] = fn
            seqs, scores = fn(params, prompt)
            seqs = seqs.cpu().numpy()
            req.out = [int(t) for t in seqs[0, 0, plen:]]
            req.extra_resp["scores"] = [
                float(s) for s in scores.cpu().numpy()[0]
            ]
        else:
            draft_params = self.bank.get_extra(req.version, "draft_params")
            if draft_params is None:
                raise ValueError(
                    "mode='speculative' needs publish(..., draft_params=...)"
                )
            from rayfed_tpu_torch.models import speculative

            key = ("spec", req.max_new_tokens, plen)
            fn = self._special_fns.get(key)
            if fn is None:
                fn = speculative.make_speculative_generate_fn(
                    self.cfg,
                    self.draft_cfg,
                    max_new_tokens=req.max_new_tokens,
                    eos_id=self.scfg.eos_id,
                )
                self._special_fns[key] = fn
            out = fn(params, draft_params, prompt)
            req.out = [int(t) for t in out.cpu().numpy()[0, plen:]]
        now = time.perf_counter()
        req.timing["prefill"] = now
        req.timing["first_token"] = now
        tracing.record_request(req.rid, "first_token", t_s=now)
        if req.stream is not None and req.out:
            # Whole-request paths produce everything at once; one frame.
            req.stream.push(0, list(req.out), False)
            with self._lock:
                self._stats["streamed_tokens"] += len(req.out)
            self._m_streamed.inc(len(req.out))
        self._finish(req)


# -- per-job server registry (one per serve() name) --------------------------

from rayfed_tpu_torch.tenancy.context import JobScoped

_registry_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards the per-job server registries)
_servers: JobScoped = JobScoped("serving.servers", default_factory=dict)


def register_server(server: InferenceServer) -> None:
    from rayfed_tpu_torch.tenancy.context import current_job
    from rayfed_tpu_torch.tenancy.qos import get_ledger

    with _registry_lock:
        registry = _servers.get()
        old = registry.get(server.name)
        if old is not None and old is not server:
            raise ValueError(
                f"a server named {server.name!r} is already registered; "
                "stop it first or pick another name"
            )
        if old is not server and not isinstance(server.pool, PagedKVPool):
            # Slab KV decode rows come out of a pooled accelerator
            # budget: charge this tenant for the slots its engine pins
            # up front. Raises TenantQuotaExceeded before the engine is
            # registered. (A paged pool instead self-charges per block
            # grant — the whole point of block granularity.)
            job = current_job()
            get_ledger().charge(job, "kv_blocks", server.pool.max_slots)
            server._kv_ledger_charge = (job, server.pool.max_slots)
        registry[server.name] = server


def get_server(name: str = "default") -> InferenceServer:
    with _registry_lock:
        server = _servers.get().get(name)
    if server is None:
        raise RuntimeError(
            f"no serving engine named {name!r} on this party — "
            "fed.serve() must run (with this party as the host) first"
        )
    return server


def _release_kv_charge(server: Optional[InferenceServer]) -> None:
    charge = getattr(server, "_kv_ledger_charge", None)
    if charge is None:
        return
    from rayfed_tpu_torch.tenancy.qos import get_ledger

    server._kv_ledger_charge = None
    get_ledger().release(charge[0], "kv_blocks", charge[1])


def unregister_server(name: str) -> None:
    with _registry_lock:
        server = _servers.get().pop(name, None)
    _release_kv_charge(server)


# -- standby replicas (ModelBank replication / promotion) --------------------
#
# A standby holds everything needed to become the serving engine for a
# name — the model/serving configs plus a ModelBank replica that tracks
# the primary's publishes — WITHOUT pinning slots or compiling anything.
# Promotion builds a real InferenceServer around the replica bank.

_standbys: JobScoped = JobScoped("serving.standbys", default_factory=dict)


def register_standby(name: str, spec: Dict[str, Any]) -> None:
    with _registry_lock:
        _standbys.get()[name] = spec


def get_standby(name: str) -> Optional[Dict[str, Any]]:
    with _registry_lock:
        return _standbys.get().get(name)


def pop_standby(name: str) -> Optional[Dict[str, Any]]:
    with _registry_lock:
        return _standbys.get().pop(name, None)


def stop_all_servers(timeout: float = 10.0) -> None:
    """Teardown hook for fed.shutdown(): stop the current job's engines."""
    with _registry_lock:
        registry = _servers.pop() or {}
        servers = list(registry.values())
    for server in servers:
        try:
            server.stop(timeout)
        except Exception:  # noqa: BLE001 - teardown best-effort
            logger.exception("serving[%s]: stop failed", server.name)
        _release_kv_charge(server)
