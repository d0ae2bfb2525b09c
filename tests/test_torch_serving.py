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

"""The port's serving plane (``rayfed_tpu_torch/serving``) on the CPU.

The 34 cases of ``test_serving.py`` with torch trees and the port's
engine (``device="cpu"``), the two-party, streaming and bank-crash
promotion cases in spawned parties; then the port against the JAX
package: greedy responses equal to the JAX package's ``InferenceServer``
on the same params and requests in both KV layouts, a seeded
temperature > 0 request drawing the same tokens through the shared numpy
sampler, and a mixed-package job (a JAX party submitting to a port
server); the serving programs against a full forward; ``fed.init``'s
``serving`` block and ``fed_aggregate(publish_to=)``; and the zero-copy
adoption of leaves the wire decoded over the native shm ring.

The load-bearing guarantees are the JAX package's: a hot swap never
aborts an in-flight request; every response is produced by exactly one
version (each matches the single-version reference bit for bit); fixed
seeds give bitwise-stable output; rows never mix; and the paged layout
gives the slab layout's bits. The module imports the JAX package only
inside the tests that compare with it, so the party processes load only
the port.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import tracing
from rayfed_tpu_torch.config import ServingConfig
from rayfed_tpu_torch.models import decode
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.serving.kv_pool import KVPool, PagedKVPool
from rayfed_tpu_torch.serving.publish import ModelBank
from rayfed_tpu_torch.serving.server import (
    InferenceServer,
    ServerOverloadedError,
    ServerStoppedError,
)
from tests.utils import FAST_COMM_CONFIG, get_addresses, run_parties

CFG = tfm.tiny_config(compute_dtype=torch.float32)
PARAMS_A = tfm.init_params(0, CFG, device="cpu")
PARAMS_B = tfm.init_params(1, CFG, device="cpu")


def _server(**overrides):
    kwargs = dict(max_slots=4, max_len=32, max_new_tokens=8)
    kwargs.update(overrides)
    return InferenceServer(CFG, ServingConfig(**kwargs), params=PARAMS_A,
                           device="cpu")


def _reference(params, prompt, max_new):
    gen = decode.make_generate_fn(CFG, max_new_tokens=max_new)
    out = gen(params, torch.tensor([list(prompt)]))
    return [int(t) for t in out[0, len(prompt):]]


# ---------------------------------------------------------------------------
# KV pool


def test_pool_acquire_release_cycle():
    pool = KVPool(CFG, max_slots=2, max_len=8, device="cpu")
    a, b = pool.acquire(), pool.acquire()
    assert {a, b} == {0, 1}
    assert pool.acquire() is None
    pool.release(a)
    assert pool.acquire() == a
    with pytest.raises(ValueError):
        pool.release(b) or pool.release(b)


def test_pool_prefix_index_dropped_on_release():
    pool = KVPool(CFG, max_slots=2, max_len=8, device="cpu")
    slot = pool.acquire()
    pool.note_prefix(slot, 1, b"abc")
    assert pool.lookup_prefix(1, b"abc") == slot
    assert pool.lookup_prefix(2, b"abc") is None  # version-scoped
    pool.release(slot)
    assert pool.lookup_prefix(1, b"abc") is None


def test_pool_allocates_sacrificial_position():
    pool = KVPool(CFG, max_slots=2, max_len=8, device="cpu")
    k, _ = pool.kv
    assert k.shape[2] == 9
    assert pool.junk_pos == 8


# ---------------------------------------------------------------------------
# Model bank


def test_bank_swap_is_atomic_and_refcounted():
    bank = ModelBank("cpu")
    with pytest.raises(RuntimeError):
        bank.acquire()
    v1 = bank.publish(PARAMS_A)
    ver, params = bank.acquire()
    assert (v1, ver) == (1, 1)
    v2 = bank.publish(PARAMS_B)
    assert v2 == 2
    # v1 pinned by the in-flight request: still resolvable.
    assert bank.live_versions() == [1, 2]
    assert torch.equal(bank.get(1)["embed"], params["embed"])
    bank.release(1)
    assert bank.live_versions() == [2]


def test_bank_snapshot_survives_caller_donation():
    bank = ModelBank("cpu")
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    bank.publish(tree)
    # The trainer immediately steps the same tensor in place; the bank's
    # snapshot must not alias it.
    tree["w"].mul_(0)
    _, snap = bank.acquire()
    assert torch.equal(snap["w"], torch.arange(8, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Engine: correctness of continuous batching


def test_single_request_matches_generate_fn():
    srv = _server()
    try:
        prompt = list(range(5, 15))
        resp = srv.submit_and_wait(prompt, max_new_tokens=6)
        assert resp["tokens"] == _reference(PARAMS_A, prompt, 6)
        assert resp["version"] == 1
        assert resp["prompt_len"] == 10
    finally:
        srv.stop()


def test_batched_rows_do_not_mix():
    srv = _server()
    try:
        prompts = [list(range(i, i + 6)) for i in range(1, 9)]
        futs = [srv.submit(p, max_new_tokens=5) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(timeout=120)["tokens"] == _reference(
                PARAMS_A, p, 5)
        assert srv.stats()["completed"] == 8
    finally:
        srv.stop()


def test_eos_exits_early_without_draining_batch():
    prompt = list(range(5, 15))
    ref = _reference(PARAMS_A, prompt, 8)
    eos = ref[2]  # greedy path is deterministic, so this token WILL appear
    srv = _server(eos_id=eos)
    try:
        resp = srv.submit_and_wait(prompt, max_new_tokens=8)
        first_eos = ref.index(eos)
        assert resp["tokens"] == ref[: first_eos + 1]
        assert len(resp["tokens"]) < 8
    finally:
        srv.stop()


def test_fixed_seed_output_bitwise_stable_without_swap():
    prompts = [list(range(i, i + 8)) for i in range(1, 7)]

    def run_once():
        srv = _server(temperature=0.7)
        try:
            futs = [srv.submit(p, max_new_tokens=6, seed=17 + i)
                    for i, p in enumerate(prompts)]
            return [f.result(timeout=120)["tokens"] for f in futs]
        finally:
            srv.stop()

    assert run_once() == run_once()


def test_prefix_reuse_hits_and_matches_full_prefill():
    srv = _server()
    try:
        prompt = list(range(7, 17))
        futs = [srv.submit(prompt, max_new_tokens=6) for _ in range(4)]
        outs = [f.result(timeout=120) for f in futs]
        ref = _reference(PARAMS_A, prompt, 6)
        for resp in outs:
            assert resp["tokens"] == ref
        assert srv.stats()["prefix_hits"] >= 1
        assert any(r["prefix_reuse"] for r in outs)
    finally:
        srv.stop()


def test_admission_control_rejects_when_full():
    srv = _server(max_slots=1, max_pending=2)
    try:
        futs, rejected = [], 0
        for _ in range(30):
            try:
                futs.append(srv.submit([1, 2, 3, 4], max_new_tokens=8))
            except ServerOverloadedError:
                rejected += 1
        assert rejected >= 1
        for f in futs:
            f.result(timeout=120)
        assert srv.stats()["rejected"] == rejected
    finally:
        srv.stop()


def test_submit_after_stop_raises():
    srv = _server()
    srv.stop()
    with pytest.raises(ServerStoppedError):
        srv.submit([1, 2, 3])


def test_bad_request_fails_its_future_not_the_engine():
    srv = _server()
    try:
        with pytest.raises(ValueError):
            srv.submit([], max_new_tokens=4)
        with pytest.raises(ValueError):
            srv.submit(list(range(30)), max_new_tokens=8)
        resp = srv.submit_and_wait([1, 2, 3], max_new_tokens=3)
        assert len(resp["tokens"]) == 3
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Hot swap under load


def test_swap_mid_decode_never_aborts_and_never_mixes_versions():
    srv = _server(max_slots=4, max_len=48, max_new_tokens=16)

    def wait_admitted(n, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            s = srv.stats()
            if s["active"] + s["completed"] >= n:
                return
            time.sleep(0.002)
        raise AssertionError("engine never admitted the load")

    try:
        prompt = list(range(3, 13))
        futs = [srv.submit(prompt, max_new_tokens=12, seed=i)
                for i in range(8)]
        wait_admitted(1)  # someone pinned v1
        v2 = srv.publish(PARAMS_B)
        futs += [srv.submit(prompt, max_new_tokens=12, seed=50 + i)
                 for i in range(8)]
        wait_admitted(9)  # someone from the second wave pinned v2
        v3 = srv.publish(PARAMS_A)
        futs += [srv.submit(prompt, max_new_tokens=12, seed=99)]
        assert (v2, v3) == (2, 3)

        resps = [f.result(timeout=240) for f in futs]  # zero aborts
        assert len(resps) == 17
        refs = {
            1: _reference(PARAMS_A, prompt, 12),
            2: _reference(PARAMS_B, prompt, 12),
            3: _reference(PARAMS_A, prompt, 12),
        }
        seen = set()
        for resp in resps:
            assert resp["tokens"] == refs[resp["version"]], resp["version"]
            seen.add(resp["version"])
        assert len(seen) >= 2, "swap window never overlapped the load"
        assert srv.bank.live_versions() == [3]
        assert srv.stats()["swaps"] == 3
    finally:
        srv.stop()


def test_concurrent_publishers_and_clients():
    srv = _server(max_slots=4, max_len=48, max_new_tokens=16,
                  max_pending=256)
    try:
        prompt = list(range(4, 12))
        refs = {
            1: _reference(PARAMS_A, prompt, 8),
            2: _reference(PARAMS_B, prompt, 8),
            3: _reference(PARAMS_A, prompt, 8),
        }
        results, errors = [], []

        def client(n):
            try:
                for _ in range(n):
                    results.append(srv.submit_and_wait(prompt,
                                                       max_new_tokens=8))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(4,))
                   for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        srv.publish(PARAMS_B)
        time.sleep(0.3)
        srv.publish(PARAMS_A)
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 32
        for resp in results:
            assert resp["tokens"] == refs[resp["version"]]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Whole-request modes ride the same swap semantics


def test_beam_request_matches_beam_search_fn():
    srv = _server(max_len=48)
    try:
        prompt = list(range(5, 15))
        resp = srv.submit_and_wait(prompt, max_new_tokens=4, mode="beam",
                                   n_beams=3)
        seqs, scores = decode.make_beam_search_fn(
            CFG, max_new_tokens=4, n_beams=3)(PARAMS_A, torch.tensor([prompt]))
        assert resp["tokens"] == [int(t) for t in seqs[0, 0, len(prompt):]]
        assert resp["scores"] == pytest.approx(
            [float(s) for s in scores[0]])
    finally:
        srv.stop()


def test_speculative_request_served():
    draft_cfg = tfm.tiny_config(compute_dtype=torch.float32, d_model=32,
                                n_heads=2, n_layers=1, d_ff=64)
    draft_params = tfm.init_params(7, draft_cfg, device="cpu")
    srv = InferenceServer(
        CFG, ServingConfig(max_slots=2, max_len=48, max_new_tokens=8),
        draft_cfg=draft_cfg, device="cpu",
    )
    try:
        srv.publish(PARAMS_A, draft_params=draft_params)
        prompt = list(range(5, 15))
        resp = srv.submit_and_wait(prompt, max_new_tokens=6,
                                   mode="speculative")
        assert resp["tokens"] == _reference(PARAMS_A, prompt, 6)
    finally:
        srv.stop()


def test_speculative_without_draft_rejected_at_submit():
    srv = _server()
    try:
        with pytest.raises(ValueError, match="draft_cfg"):
            srv.submit([1, 2, 3], mode="speculative")
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Request timeline tracing


def test_request_timeline_export(tmp_path):
    tracing.clear()
    tracing.enable()
    try:
        srv = _server()
        try:
            resp = srv.submit_and_wait(list(range(5, 12)), max_new_tokens=4)
        finally:
            srv.stop()
        rid = resp["request_id"]
        events = [e.event for e in tracing.get_request_events(rid)]
        for needed in ("enqueue", "admit", "prefill", "first_token",
                       "finish"):
            assert needed in events, (needed, events)
        times = [e.t_s for e in tracing.request_timelines()[rid]]
        assert times == sorted(times)
        path = str(tmp_path / "requests.json")
        assert tracing.export_request_timeline(path, party="alice") >= 5
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        assert doc["party"] == "alice"
        assert [e["event"] for e in doc["requests"][rid]] == events
    finally:
        tracing.disable()
        tracing.clear()


def test_request_timeline_noop_when_disabled():
    tracing.clear()
    srv = _server()
    try:
        srv.submit_and_wait([1, 2, 3], max_new_tokens=2)
        assert tracing.get_request_events() == []
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Sequential (naive) mode


def test_sequential_mode_serves_one_at_a_time():
    srv = _server(mode="sequential")
    try:
        prompts = [list(range(i, i + 6)) for i in range(1, 5)]
        futs = [srv.submit(p, max_new_tokens=4) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(timeout=120)["tokens"] == _reference(
                PARAMS_A, p, 4)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Executor opt-out (the serving submit path depends on it)


def test_executor_eager_false_goes_to_pool():
    from rayfed_tpu_torch._private.executor import LocalExecutor

    ex = LocalExecutor(max_workers=2)
    try:
        started = threading.Event()
        release = threading.Event()

        def blocker():
            started.set()
            release.wait(30)
            return "done"

        fut = ex.submit(blocker, (), {}, eager=False)
        assert started.wait(10)
        assert not fut.done()
        release.set()
        assert fut.result(10) == "done"
    finally:
        ex.shutdown()


# ---------------------------------------------------------------------------
# Two-party e2e: fed.serve on alice, submits from both drivers, a hot
# swap whose params arrive as an owner-push over the wire from bob.

CONFIG = {
    "cross_silo_comm": dict(FAST_COMM_CONFIG),
    "serving": {"max_slots": 4, "max_len": 48, "max_new_tokens": 8},
}


@fed.remote
def _fresh_params(seed):
    return tfm.init_params(seed, CFG, device="cpu")


def run_serve_two_party(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)
    handle = fed.serve("alice", CFG, params=PARAMS_A, device="cpu")
    prompt = list(range(5, 13))
    futs = [handle.submit(prompt, max_new_tokens=6, seed=i)
            for i in range(4)]
    v2 = handle.publish(_fresh_params.party("bob").remote(1))
    futs += [handle.submit(prompt, max_new_tokens=6, seed=10 + i)
             for i in range(2)]
    resps = [fed.get(f) for f in futs]
    assert fed.get(v2) == 2
    refs = {1: _reference(PARAMS_A, prompt, 6),
            2: _reference(PARAMS_B, prompt, 6)}
    for resp in resps:
        assert resp["tokens"] == refs[resp["version"]], resp["version"]
    stats = fed.get(handle.stats())
    assert stats["completed"] >= 6
    assert stats["current_version"] == 2
    assert fed.get(handle.shutdown()) is True
    fed.shutdown()


def test_serve_two_party_e2e():
    run_parties(run_serve_two_party, ["alice", "bob"])


# ---------------------------------------------------------------------------
# Paged KV layout: bitwise equal to the slab layout


def test_paged_matches_slab_bitwise_mixed_lengths():
    rng = np.random.default_rng(7)
    # Lengths across the chunk size (8 here): short prompts prefill whole,
    # long ones in chunks, in both layouts.
    prompts = [[int(t) for t in rng.integers(1, 255, size=n)]
               for n in (3, 9, 14, 5, 12, 7)]
    outs = {}
    for layout in ("slab", "paged"):
        srv = _server(kv_layout=layout, temperature=0.8, prefill_chunk=8,
                      prefill_token_budget=16)
        try:
            futs = [srv.submit(p, max_new_tokens=8, seed=i)
                    for i, p in enumerate(prompts)]
            outs[layout] = [f.result(timeout=120)["tokens"] for f in futs]
        finally:
            srv.stop()
    assert outs["paged"] == outs["slab"]


def test_chunked_prefill_matches_reference():
    srv = _server(max_len=48, prefill_chunk=8, prefill_token_budget=16)
    try:
        rng = np.random.default_rng(3)
        prompt = [int(t) for t in rng.integers(1, 255, size=21)]
        resp = srv.submit_and_wait(prompt, max_new_tokens=6)
        assert resp["tokens"] == _reference(PARAMS_A, prompt, 6)
        # 21 tokens at chunk 8: ragged 5 first, then 8 + 8.
        assert srv.stats()["prefill_chunks"] >= 3
    finally:
        srv.stop()


def test_preemption_under_block_pressure_matches_unconstrained():
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 255, size=8)]
               for _ in range(6)]

    def run(**kw):
        srv = _server(max_slots=4, kv_block_size=4, **kw)
        try:
            futs = [srv.submit(p, max_new_tokens=8, seed=i)
                    for i, p in enumerate(prompts)]
            out = [f.result(timeout=120)["tokens"] for f in futs]
            return out, srv.stats()
        finally:
            srv.stop()

    base, _ = run()
    # 4 rows x 3 blocks by position 8 fill the 12 grantable blocks; at
    # position 12 all four need a 4th: a deadlock only preemption breaks.
    tight, st = run(kv_blocks=12)
    assert tight == base
    assert st["preempted"] >= 1
    assert st["completed"] == len(prompts)
    assert st["kv_blocks_in_use"] == 0


def test_mixed_length_fragmentation_shorts_overtake_long_prompt():
    long_len = 1024
    srv = _server(max_slots=8, max_len=long_len + 16, max_new_tokens=16,
                  max_pending=64, prompt_buckets=[16, long_len])
    try:
        rng = np.random.default_rng(42)
        long_prompt = np.asarray(rng.integers(1, 255, size=long_len),
                                 np.int32)
        done_at = {}
        lock = threading.Lock()
        t0 = time.perf_counter()

        def short_client(ci):
            r = np.random.default_rng(100 + ci)
            p = [int(t) for t in
                 r.integers(1, 255, size=int(r.integers(4, 13)))]
            srv.submit_and_wait(p, max_new_tokens=8)
            with lock:
                done_at[ci] = time.perf_counter() - t0

        long_fut = srv.submit(long_prompt, max_new_tokens=8)
        threads = [threading.Thread(target=short_client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        long_resp = long_fut.result(timeout=300)
        long_done = time.perf_counter() - t0
        assert len(long_resp["tokens"]) == 8
        assert srv.stats()["prefill_chunks"] >= long_len // 32
        assert sum(1 for dt in done_at.values() if dt < long_done) >= 8
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Token streaming (in-process; the wire path is covered by the e2e below)


def test_stream_matches_complete_response():
    srv = _server()
    try:
        prompt = list(range(5, 15))
        fut, stream = srv.submit_stream(prompt, max_new_tokens=8)
        streamed = list(stream)
        resp = fut.result(timeout=120)
        assert streamed == resp["tokens"] == _reference(PARAMS_A, prompt, 8)
        assert stream.first_token_s is not None
        assert srv.stats()["streamed_tokens"] >= len(streamed)
    finally:
        srv.stop()


def test_slow_stream_consumer_never_blocks_engine():
    srv = _server()
    try:
        prompt = list(range(5, 15))
        fut, stream = srv.submit_stream(prompt, max_new_tokens=8)
        resp = fut.result(timeout=120)
        others = [srv.submit(list(range(2, 10)), max_new_tokens=6, seed=i)
                  for i in range(4)]
        for f in others:
            f.result(timeout=120)
        assert srv.stats()["kv_blocks_in_use"] == 0
        assert stream.tokens() == resp["tokens"]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Per-block-grant tenancy accounting


def test_paged_kv_quota_trip_fails_request_and_cleans_ledger():
    from rayfed_tpu_torch.tenancy import context as tenancy
    from rayfed_tpu_torch.tenancy import qos as tenancy_qos
    from rayfed_tpu_torch.tenancy.context import (
        TenancyConfig,
        TenantQuotaExceeded,
    )

    ctx = tenancy.create_context(
        "quota_paged", "alice", tenancy=TenancyConfig(kv_block_quota=2))
    try:
        with tenancy.use_context(ctx):
            srv = _server(kv_block_size=4)
            try:
                # 8-token prompt + 8 new needs 4 blocks; the quota of 2
                # covers the prefill grant but no decode-step grant can
                # ever succeed: the engine fails fast instead of stalling.
                fut = srv.submit(list(range(1, 9)), max_new_tokens=8)
                with pytest.raises(TenantQuotaExceeded) as exc:
                    fut.result(timeout=120)
                assert exc.value.resource == "kv_blocks"
                resp = srv.submit_and_wait([1, 2, 3], max_new_tokens=2)
                assert len(resp["tokens"]) == 2
            finally:
                srv.stop()
            assert tenancy_qos.get_ledger().in_use(
                "quota_paged", "kv_blocks") == 0
    finally:
        tenancy.remove_context("quota_paged")


# ---------------------------------------------------------------------------
# Zero-copy publish + ModelBank replication


def _native_wire():
    from rayfed_tpu_torch._private import native_wire

    fw = native_wire.load()
    if fw is None or not hasattr(fw, "shm_ring_create"):
        pytest.skip("the native wire module needs a C++ compiler")
    return fw


def test_publish_adopts_shm_backed_leaves_zero_copy():
    fw = _native_wire()
    ring = fw.shm_ring_create(f"t_tserving_zcopy_{os.getpid()}", 1 << 20)
    try:
        arr = np.arange(1024, dtype=np.float32)
        payload = arr.tobytes()
        off = fw.shm_ring_push(ring, [payload])
        assert off is not None
        view = np.frombuffer(
            fw.shm_ring_adopt(ring, off, len(payload)), dtype=np.float32)
        bank = ModelBank("cpu")
        bank.publish({"w": view, "b": np.ones(4, np.float32)})
        # The shm-backed leaf is adopted by reference, the plain one
        # copied: exactly one zero-copy adoption.
        assert bank.zerocopy_adopted() == 1
        _, snap = bank.acquire()
        assert torch.equal(snap["w"], torch.from_numpy(arr))
        assert snap["w"].data_ptr() == view.ctypes.data
    finally:
        fw.shm_ring_close(ring)


def test_torch_tree_decodes_zero_copy_over_an_adopted_chunk():
    """A tensor tree pushed through the native shm ring decodes as CPU
    tensors over the chunk itself (no copy), tagged with it; a CPU bank
    adopts those leaves, a tensor made from one (a cast) is copied, and
    a bank on another device would copy too."""
    from rayfed_tpu_torch._private import serialization as ser

    fw = _native_wire()
    tree = {"w": torch.arange(4096, dtype=torch.float32),
            "h": torch.ones(64, dtype=torch.bfloat16), "n": 3}
    meta, buffers = ser.try_encode_tree(tree)
    ring = fw.shm_ring_create(f"t_tserving_tree_{os.getpid()}", 1 << 20)
    try:
        off = fw.shm_ring_push(
            ring, [b"".join(bytes(memoryview(b)) for b in buffers)])
        assert off is not None
        nbytes = sum(ser.buffer_nbytes(b) for b in buffers)
        chunk = fw.shm_ring_adopt(ring, off, nbytes)
        got = ser.decode_payload("tree", meta, memoryview(chunk))
        base = np.frombuffer(chunk, np.uint8).ctypes.data
        for name in ("w", "h"):
            t = got[name]
            assert torch.equal(t, tree[name])
            assert base <= t.data_ptr() < base + nbytes  # over the chunk
            assert ser.shm_chunk(t) is chunk
        assert got["n"] == 3
        assert ser.shm_chunk(got["w"].float().mul(1)) is None
        bank = ModelBank("cpu")
        bank.publish(got)
        assert bank.zerocopy_adopted() == 2
        _, snap = bank.acquire()
        assert snap["w"].data_ptr() == got["w"].data_ptr()
    finally:
        fw.shm_ring_close(ring)


def test_bank_export_restore_preserves_version_and_monotonicity():
    bank = ModelBank("cpu")
    bank.publish(PARAMS_A)
    bank.publish(PARAMS_B)
    replica = ModelBank("cpu")
    replica.restore_state(bank.export_state())
    ver, params = replica.acquire()
    assert ver == 2
    assert torch.equal(params["embed"], PARAMS_B["embed"])
    replica.release(ver)
    assert replica.publish(PARAMS_A) == 3


# ---------------------------------------------------------------------------
# Two-party e2e: token streaming over the wire


def run_serve_stream_two_party(party, addresses):
    fed.init(addresses=addresses, party=party, config=CONFIG)
    handle = fed.serve("alice", CFG, params=PARAMS_A, device="cpu")
    prompt = list(range(5, 13))
    resp, stream = handle.submit(prompt, max_new_tokens=6, stream_to="bob")
    streamed = None
    if party == "bob":
        streamed = []
        for tok in stream:
            streamed.append(tok)
            assert stream.first_token_s is not None
    tokens = fed.get(resp)["tokens"]
    assert tokens == _reference(PARAMS_A, prompt, 6)
    if party == "bob":
        assert streamed == tokens
    assert fed.get(handle.shutdown()) is True
    fed.shutdown()


def test_serve_streaming_two_party_e2e():
    run_parties(run_serve_stream_two_party, ["alice", "bob"])


# ---------------------------------------------------------------------------
# Three-party chaos: the ModelBank holder crashes mid-window; the
# standby's replica is promoted and every orphaned request re-served.

BC_PARTIES = ["alice", "bob", "carol"]
BC_PROMPT = list(range(5, 13))
BC_N = 8


def _bc_comm(extra=None):
    cfg = {
        "retry_policy": {
            "max_attempts": 2,
            "initial_backoff_ms": 50,
            "max_backoff_ms": 100,
        },
        "timeout_in_ms": 2000,
        "recv_timeout_in_ms": 60000,
        "send_deadline_in_ms": 4000,
    }
    cfg.update(extra or {})
    return cfg


def _run_bank_crash_party(party, addresses, workdir):
    config = {
        "cross_silo_comm": _bc_comm(
            {"exit_on_sending_failure": True} if party == "alice" else None),
        "serving": {"max_slots": 4, "max_len": 48, "max_new_tokens": 8},
    }
    if party == "alice":
        config["resilience"] = {"fault_schedule": {
            "seed": 7,
            "rules": [{"fault": "crash", "src": "alice", "after": 6}],
        }}
    fed.init(
        addresses=addresses, party=party, config=config,
        sending_failure_handler=(
            (lambda e: os._exit(0)) if party == "alice" else None),
    )
    try:
        handle = fed.serve("alice", CFG, params=PARAMS_A,
                           standby=("carol",), device="cpu")
        handle.publish(PARAMS_B)  # v2, replicated to carol's bank
        futs = [handle.submit(BC_PROMPT, max_new_tokens=6, seed=i)
                for i in range(BC_N)]
        got = [fed.get(f, timeout=3.0, on_missing="default") for f in futs]
    except BaseException:
        if party == "alice":
            os._exit(0)  # expected death throes past the crash point
        raise
    if party == "alice":
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            time.sleep(0.1)
        os._exit(1)  # crash never fired: fail the test
    missing = [i for i, r in enumerate(got) if r is fed.MISSING]
    assert missing, "crash landed after the window drained"
    promoted = fed.get(handle.promote("carol"), timeout=60.0)
    assert promoted == 2
    redo = [handle.submit(BC_PROMPT, max_new_tokens=6, seed=i)
            for i in range(BC_N)]
    redo_got = [fed.get(f, timeout=60.0, on_missing="default") for f in redo]
    refs = {1: _reference(PARAMS_A, BC_PROMPT, 6),
            2: _reference(PARAMS_B, BC_PROMPT, 6)}
    aborted, versions = 0, {}
    for i, r in enumerate(got):
        if r is fed.MISSING:
            r = redo_got[i]
        if r is fed.MISSING:
            aborted += 1
            continue
        assert r["tokens"] == refs[r["version"]]
        versions[str(i)] = r["version"]
    assert aborted == 0
    with open(os.path.join(workdir, f"{party}.json"), "w") as f:
        json.dump({"missing": missing, "promoted": promoted,
                   "versions": versions}, f, sort_keys=True)
    fed.shutdown()


def test_modelbank_crash_promote_serves_all_requests(tmp_path):
    run_parties(
        _run_bank_crash_party, BC_PARTIES, timeout=200,
        extra_args=(str(tmp_path),), addresses=get_addresses(BC_PARTIES),
    )
    for p in ("bob", "carol"):
        doc = json.loads((tmp_path / f"{p}.json").read_text())
        assert doc["promoted"] == 2
        assert doc["missing"]
        assert len(doc["versions"]) == BC_N


# ---------------------------------------------------------------------------
# The serving programs against a full forward


def test_server_programs_match_full_forward():
    """The engine's prefill (whole and chunked) and its batched decode
    step, on a slab pool row, against a full forward of the prompt and of
    prompt + token (f32, 1e-5)."""
    from rayfed_tpu_torch.serving import server as srv_mod

    pool = KVPool(CFG, max_slots=3, max_len=40, device="cpu")
    prompt = np.random.default_rng(5).integers(1, 255, 21)
    full = tfm.forward(PARAMS_A, torch.tensor([prompt.tolist()]), CFG)[0]
    k, v = pool.row(1)
    last = srv_mod.prefill_row(PARAMS_A, CFG, k, v, prompt, 32)
    np.testing.assert_allclose(last.numpy(), full[-1].numpy(), atol=1e-5,
                               rtol=1e-5)
    k2, v2 = pool.row(2)
    for off, real, clen in srv_mod.chunk_plan(21, 8, [8]):
        toks = np.zeros(clen, np.int64)
        toks[:real] = prompt[off:off + real]
        logits = srv_mod.chunk_row(PARAMS_A, CFG, k2, v2, toks, off)
    np.testing.assert_allclose(logits[real - 1].numpy(), full[-1].numpy(),
                               atol=1e-5, rtol=1e-5)
    tok = int(torch.argmax(last))
    kk, vv = pool.kv
    step = srv_mod.decode_step(PARAMS_A, CFG, kk, vv,
                               np.array([0, tok, tok]),
                               np.array([pool.junk_pos, 21, 21]))
    ext = tfm.forward(PARAMS_A, torch.tensor([prompt.tolist() + [tok]]),
                      CFG)[0, -1]
    for row in (1, 2):
        np.testing.assert_allclose(step[row].numpy(), ext.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_chunk_plan_runs_the_ragged_remainder_first():
    from rayfed_tpu_torch.serving.server import chunk_plan

    assert chunk_plan(21, 8, [8]) == [(0, 5, 8), (5, 8, 8), (13, 8, 8)]
    assert chunk_plan(16, 8, [8]) == [(0, 8, 8), (8, 8, 8)]
    assert chunk_plan(40, 32, [8, 16, 32]) == [(0, 8, 8), (8, 32, 32)]


def test_paged_pool_gather_scatter_round_trip():
    """A row scattered through a block table gathers back bit for bit;
    the step scatter writes exactly each live row's one position."""
    pool = PagedKVPool(CFG, max_slots=2, max_len=10, block_size=4,
                       device="cpu")
    slot = pool.acquire()
    assert pool.ensure_blocks(slot, 9) == "ok"
    row_k = torch.randn(CFG.n_layers, 1, 11, CFG.n_heads, CFG.head_dim)
    row_v = torch.randn_like(row_k)
    pool.scatter_slot(slot, row_k, row_v)
    gk, gv = pool.gather_slot(slot)
    assert torch.equal(gk[:, :, :10], row_k[:, :, :10])
    assert torch.equal(gv[:, :, :10], row_v[:, :, :10])
    tables = np.zeros((2, pool.blocks_per_row), np.int32)
    tables[slot] = pool.table(slot)
    k_s, v_s = pool.gather(tables)
    k_s[:, slot, 6] = 7.0
    blk, off = pool.write_target(slot, 6)
    pos = np.full(2, pool.junk_pos)
    pos[slot] = 6
    wb, wo = np.zeros(2, np.int64), np.zeros(2, np.int64)
    wb[slot], wo[slot] = blk, off
    pool.scatter_step(k_s, v_s, pos, wb, wo)
    gk2, _ = pool.gather_slot(slot)
    assert (gk2[:, 0, 6] == 7.0).all()
    assert torch.equal(gk2[:, :, :6], row_k[:, :, :6])
    assert torch.equal(gk2[:, :, 7:10], row_k[:, :, 7:10])


# ---------------------------------------------------------------------------
# The port against the JAX package's server


def _jax_pair(**cfg_kw):
    """The JAX package's tiny f32 config (with ``cfg_kw``) and params, and
    the same params carried over to the port."""
    import jax
    import jax.numpy as jnp

    from rayfed_tpu.models import transformer as jtfm

    jcfg = jtfm.tiny_config(compute_dtype=jnp.float32, **cfg_kw)
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    tp = tfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, jp, tp


def _serve_both(requests, cfg_kw=None, **scfg):
    """Run ``requests`` ([(prompt, opts)]) through the JAX package's
    server and the port's on the same params (``CFG``, or a tiny config
    with ``cfg_kw``); returns both token lists."""
    from rayfed_tpu.config import ServingConfig as JServingConfig
    from rayfed_tpu.serving.server import InferenceServer as JServer

    jcfg, jp, tp = _jax_pair(**(cfg_kw or {}))
    cfg = tfm.tiny_config(compute_dtype=torch.float32, **(cfg_kw or {}))
    out = {}
    for pkg in ("jax", "torch"):
        srv = (JServer(jcfg, JServingConfig(**scfg), params=jp)
               if pkg == "jax" else
               InferenceServer(cfg, ServingConfig(**scfg), params=tp,
                               device="cpu"))
        try:
            futs = [srv.submit(p, **o) for p, o in requests]
            out[pkg] = [f.result(timeout=240)["tokens"] for f in futs]
        finally:
            srv.stop()
    return out


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_greedy_responses_match_the_jax_server(layout):
    rng = np.random.default_rng(21)
    requests = [([int(t) for t in rng.integers(1, 255, size=n)],
                 dict(max_new_tokens=8)) for n in (3, 9, 14, 5, 12, 7, 20)]
    requests.append((requests[1][0], dict(max_new_tokens=8)))  # a donor
    out = _serve_both(requests, max_slots=4, max_len=32, max_new_tokens=8,
                      kv_layout=layout, prefill_chunk=8,
                      prefill_token_budget=16)
    assert out["torch"] == out["jax"]


def test_greedy_moe_responses_match_the_jax_server():
    # An MoE config through the engine (cached decode reaches the MoE FFN
    # through ffn_apply): the same tokens as the JAX package's server.
    rng = np.random.default_rng(22)
    requests = [([int(t) for t in rng.integers(1, 255, size=n)],
                 dict(max_new_tokens=6)) for n in (4, 11, 7, 16)]
    out = _serve_both(requests, cfg_kw=dict(n_experts=4), max_slots=4,
                      max_len=32, max_new_tokens=6, prefill_chunk=8,
                      prefill_token_budget=16)
    assert out["torch"] == out["jax"]


def test_seeded_sampled_request_draws_the_jax_servers_tokens():
    """The server's sampler is the JAX package's numpy sampler with a
    per-request rng: at temperature > 0 a seeded request draws the same
    tokens in both packages."""
    prompt = list(range(9, 19))
    requests = [(prompt, dict(max_new_tokens=10, temperature=0.9, seed=s))
                for s in (1, 2, 3)]
    out = _serve_both(requests, max_slots=4, max_len=32, max_new_tokens=8)
    assert out["torch"] == out["jax"]
    assert len({tuple(t) for t in out["torch"]}) > 1  # seeds matter


def _numpy_params(seed):
    """A tiny f32 param tree as numpy, the same in both packages."""
    rng = np.random.default_rng(seed)
    cfg = CFG
    d, h, dh, f, n = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.n_layers)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "embed": normal((cfg.vocab, d), 0.02),
        "layers": {
            "ln1": np.ones((n, d), np.float32),
            "wq": normal((n, d, h, dh), d ** -0.5),
            "wk": normal((n, d, h, dh), d ** -0.5),
            "wv": normal((n, d, h, dh), d ** -0.5),
            "wo": normal((n, h, dh, d), (h * dh) ** -0.5),
            "ln2": np.ones((n, d), np.float32),
            "w_gate": normal((n, d, f), d ** -0.5),
            "w_up": normal((n, d, f), d ** -0.5),
            "w_down": normal((n, f, d), f ** -0.5),
        },
        "ln_f": np.ones((d,), np.float32),
        "lm_head": normal((d, cfg.vocab), d ** -0.5),
    }


def _bob_tree(seed):
    return _numpy_params(seed)


def run_mixed_serving(party, addresses):
    """alice (the port) hosts the server; bob (the JAX package) submits
    and publishes. Each side checks the responses against its own
    package's greedy generation on the same numpy params."""
    prompt = list(range(4, 14))
    config = {"cross_silo_comm": dict(FAST_COMM_CONFIG),
              "serving": {"max_slots": 4, "max_len": 48,
                          "max_new_tokens": 8}}
    pa, pb = _numpy_params(30), _numpy_params(31)  # pb: _bob_tree(31)
    if party == "alice":
        params = {1: tfm.params_from_numpy(pa, device="cpu"),
                  2: tfm.params_from_numpy(pb, device="cpu")}
        refs = {v: _reference(p, prompt, 6) for v, p in params.items()}
        fed.init(addresses=addresses, party=party, config=config)
        handle = fed.serve("alice", CFG, params=params[1], device="cpu")
    else:
        import jax.numpy as jnp

        import rayfed_tpu as jfed
        from rayfed_tpu.models import decode as jdecode
        from rayfed_tpu.models import transformer as jtfm

        jcfg = jtfm.tiny_config(compute_dtype=jnp.float32)
        gen = jdecode.make_generate_fn(jcfg, max_new_tokens=6)
        refs = {}
        for v, p in ((1, pa), (2, pb)):
            out = np.asarray(gen(p, jnp.asarray([prompt], jnp.int32)))
            refs[v] = [int(t) for t in out[0, len(prompt):]]
        jfed.init(addresses=addresses, party=party, config=config)
        handle = jfed.serve("alice", jcfg)
    api = fed if party == "alice" else jfed
    futs = [handle.submit(prompt, max_new_tokens=6, seed=i) for i in range(3)]
    # bob's numpy tree, made at bob and pushed to alice's port server.
    v2 = handle.publish(api.remote(_bob_tree).party("bob").remote(31))
    # The version resolves once alice installed it: later submits pin it.
    assert api.get(v2) == 2
    futs += [handle.submit(prompt, max_new_tokens=6, seed=9)]
    resps = [api.get(f) for f in futs]
    assert resps[-1]["version"] == 2
    for resp in resps:
        assert resp["tokens"] == refs[resp["version"]], resp
    assert api.get(handle.shutdown()) is True
    api.shutdown()


def test_mixed_package_serving_job():
    run_parties(run_mixed_serving, ["alice", "bob"])


# ---------------------------------------------------------------------------
# fed.init's serving block and fed_aggregate(publish_to=)


def test_init_accepts_the_serving_block_and_serve_reads_it():
    from rayfed_tpu_torch.serving import client
    from rayfed_tpu_torch.serving.server import get_server

    addresses = get_addresses(["alice"])
    fed.init(addresses=addresses, party="alice",
             config={"serving": {"max_slots": 2, "max_len": 24,
                                 "kv_layout": "slab"}})
    try:
        assert client.get_default_serving_config()["max_slots"] == 2
        handle = fed.serve("alice", CFG, params=PARAMS_A, device="cpu")
        srv = get_server("default")
        assert (srv.scfg.max_slots, srv.layout) == (2, "slab")
        resp = fed.get(handle.submit([3, 4, 5], max_new_tokens=4))
        assert resp["tokens"] == _reference(PARAMS_A, [3, 4, 5], 4)
    finally:
        fed.shutdown()
    # fed.shutdown stopped the engine and dropped the job default.
    with pytest.raises(ServerStoppedError):
        srv.submit([1, 2])
    assert client.get_default_serving_config() is None


@pytest.mark.parametrize("serving, match", [
    ({"max_slot": 4}, "unknown serving config key"),
    ({"kv_layout": "ring"}, "kv_layout"),
], ids=["unknown_key", "bad_layout"])
def test_init_refuses_a_bad_serving_block(serving, match):
    from rayfed_tpu_torch._private.global_context import get_global_context
    from rayfed_tpu_torch.tenancy import context as tenancy_context

    with pytest.raises(ValueError, match=match):
        fed.init(addresses={"alice": "127.0.0.1:1"}, party="alice",
                 config={"serving": serving})
    assert get_global_context() is None and not tenancy_context.contexts()


@fed.remote
def _party_params(seed):
    return tfm.init_params(seed, CFG, device="cpu")


def run_aggregate_publish(party, addresses):
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.federated import fed_aggregate
    from rayfed_tpu_torch.ops.aggregate import tree_divide, tree_sum
    from rayfed_tpu_torch.serving.server import get_server

    fed.init(addresses=addresses, party=party, config=CONFIG)
    handle = fed.serve("alice", CFG, params=PARAMS_A, device="cpu")
    prompt = list(range(6, 16))
    # fed_aggregate's mean: the fold, then a true division by the count.
    mean = tree_divide(tree_sum(tfm.init_params(2, CFG, device="cpu"),
                                tfm.init_params(3, CFG, device="cpu")), 2.0)
    refs = {1: _reference(PARAMS_A, prompt, 5), 2: _reference(mean, prompt, 5)}
    first = handle.submit(prompt, max_new_tokens=5)
    objs = {"alice": _party_params.party("alice").remote(2),
            "bob": _party_params.party("bob").remote(3)}
    agg = fed_aggregate(objs, op="mean", publish_to=handle)
    got = fed.get(agg)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_util.tree_flatten(got)[0], tree_util.tree_flatten(mean)[0]))
    if party == "alice":
        # The publish task runs once the aggregate resolves; the next
        # submit executes here, after this driver issues it.
        bank = get_server("default").bank
        deadline = time.monotonic() + 60
        while bank.current_version() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert bank.current_version() == 2
    after = handle.submit(prompt, max_new_tokens=5)
    r1, r2 = fed.get(first), fed.get(after)
    assert r1["tokens"] == refs[r1["version"]]
    assert r2["version"] == 2 and r2["tokens"] == refs[2]
    assert fed.get(handle.stats())["swaps"] == 2
    assert fed.get(handle.shutdown()) is True
    fed.shutdown()


def test_fed_aggregate_publishes_to_a_serving_handle():
    run_parties(run_aggregate_publish, ["alice", "bob"])


@fed.remote
def _shm_tags(tree):
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch._private.serialization import shm_chunk

    return [shm_chunk(x) is not None for x in tree_util.tree_flatten(tree)[0]]


def run_shm_publish(party, addresses):
    comm = dict(FAST_COMM_CONFIG, shm_enabled=True, shm_min_bytes=0)
    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": comm})
    handle = fed.serve("alice", CFG, params=PARAMS_A, device="cpu")
    tree = _party_params.party("bob").remote(1)
    # bob's tree crosses the same-host shm lane: alice decodes every leaf
    # over its ring chunk, and the CPU bank adopts them all.
    assert all(fed.get(_shm_tags.party("alice").remote(tree)))
    assert fed.get(handle.publish(tree)) == 2
    n_leaves = len(torch.utils._pytree.tree_leaves(PARAMS_B))
    assert fed.get(handle.stats())["publish_zerocopy"] == n_leaves
    prompt = list(range(3, 11))
    resp = fed.get(handle.submit(prompt, max_new_tokens=4))
    assert resp["version"] == 2
    assert resp["tokens"] == _reference(PARAMS_B, prompt, 4)
    assert fed.get(handle.shutdown()) is True
    fed.shutdown()


def test_publish_over_the_shm_lane_adopts_leaves_zero_copy():
    _native_wire()
    run_parties(run_shm_publish, ["alice", "bob"])


def test_a_failed_step_fails_every_admitted_request_and_stops_the_engine(
        monkeypatch):
    """A device fault in the batched step (here a raising step) fails the
    futures of every admitted request, and the engine stops: later
    submits raise instead of queueing behind a dead engine."""
    from rayfed_tpu_torch.serving import server as srv_mod

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    srv = _server()
    try:
        monkeypatch.setattr(srv_mod, "decode_step", broken)
        futs = [srv.submit(list(range(3, 9 + i)), max_new_tokens=4)
                for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="illegal memory"):
                f.result(timeout=60)
        srv._engine.join(10)
        assert not srv._engine.is_alive()
        with pytest.raises(ServerStoppedError, match="engine died"):
            srv.submit([1, 2, 3])
    finally:
        srv.stop()
