#!/usr/bin/env python3
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

"""Smoke run of the PyTorch/CUDA port (``rayfed_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases:

1. device: the card's name, count, power limit; TF32 off.
2. build: the Hopper kernels from ``rayfed_tpu_torch/csrc`` (nvcc); each
   kernel's registers, spills, shared memory and resident blocks per SM
   at the flagship head dim (no kernel may spill).
3. kernels: each flash kernel against its plain PyTorch version on the
   card, in bf16, at the flagship attention shape and at small shapes
   (``q_offset > 0``, ``Sq < Sk``, ragged tiles, every head dim); times of
   kernel, plain version and ``scaled_dot_product_attention`` (a yardstick
   only) with CUDA events; FLOPs, bytes and the roofline bound.
4. slice: one federated transformer round loop at the flagship width —
   two parties ("alice", "bob") each take local AdamW steps through
   ``make_fed_train_step(attn="flash")``, ``tree_mean`` folds their params
   on the card, both load the aggregate, for a few rounds. Checks: every
   round starts from bitwise-identical trees, losses are finite, the
   aggregate's loss falls, flash and dense attention agree on it, and
   the train steps launched every kernel (the evaluations' launches are
   counted apart).

It needs a CUDA card and exits non-zero without one. The last two lines
are the kernel table and ``{"ok": true, "device": {...}}`` as JSON.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The flagship width: benchmarks/transformer_train_benchmark.py FLAGSHIP
# (d_model 2048, 12 layers, seq 2048, vocab 32768; its batch 12) with that
# script's rules n_heads = d_model // 128 and d_ff = int(2.75 d) // 16 * 16.
FLAGSHIP = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=12,
                d_ff=5632, seq=2048, batch=12)
# What this run cuts to stay well inside its time limit: depth only.
SMOKE_LAYERS = 4

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# Tolerances, kernel vs plain version on the same bf16 inputs. A bf16
# output (O, dq, dk, dv) is cut along the sequence into TILE-row tiles;
# in each tile the error's norm over (batch, rows, heads, dim) must stay
# within BF16_TILE_REL_TOL of the plain version's norm there. The two
# differ where the online softmax rounds P and dS to bf16 (64-wide tiles
# in the kernel, the plain version's blocks), about one bf16 ulp; a tile
# of keys or queries skipped for some rows moves those rows' tiles by
# far more (PERF.md holds both readings). A max-norm limit would not do:
# the first rows and keys hold the largest values, most entries are
# small. lse and delta (f32) are held by absolute error.
TILE = 64
BF16_TILE_REL_TOL = 1e-2
F32_STAT_TOL = 1e-3
# Loss of the aggregate with flash vs dense attention (bf16 compute).
ATTN_LOSS_TOL = 2e-2
# The federation of phase 4: each party's name and data seed.
PARTIES = (("alice", 1), ("bob", 2))

KERNELS = [
    dict(name="flash_fwd", route="cuda",
         source="rayfed_tpu_torch/csrc/flash_attention.cu",
         replaces="rayfed_tpu/ops/flash_attention.py:51"),
    dict(name="flash_bwd_dq", route="cuda",
         source="rayfed_tpu_torch/csrc/flash_attention.cu",
         replaces="rayfed_tpu/ops/flash_attention.py:151"),
    dict(name="flash_bwd_dkv", route="cuda",
         source="rayfed_tpu_torch/csrc/flash_attention.cu",
         replaces="rayfed_tpu/ops/flash_attention.py:200"),
]


class SmokeError(RuntimeError):
    """A phase's check failed."""


def require(cond, what):
    if not cond:
        raise SmokeError(what)


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: chip_smoke.py runs the port on a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} x{torch.cuda.device_count()} torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(smi)
    return name, smi


# ---------------------------------------------------------------------------
# Phase 2: build
# ---------------------------------------------------------------------------


def phase_build(head_dim):
    """Build the kernels; print the compiler's report and, for each kernel
    at ``head_dim``, the resources the card gives it. Fails if any kernel
    spills registers there."""
    from rayfed_tpu_torch.ops import _native

    t0 = time.perf_counter()
    path = _native.build()
    _native.lib()
    secs = time.perf_counter() - t0
    print(f"[build] {os.path.relpath(path, REPO)} in {secs:.1f}s")
    with open(path + ".log") as f:
        log = f.read()
    for line in ptxas_report(log):
        print(f"[build] {line}")
    resources = kernel_resources(log, head_dim)
    for name, res in resources.items():
        print(f"[build] {name}<{head_dim}>: {res['registers']} registers, "
              f"{res['spill_bytes']} spill bytes, {res['smem_bytes']} B "
              f"dynamic shared memory, {res['threads']} threads, "
              f"{res['blocks_per_sm']} resident blocks per SM")
    print(json.dumps({"resources": {"head_dim": head_dim, **resources}}))
    for name in _native.KERNEL_NAMES:
        require(resources[name]["spill_bytes"] == 0,
                f"{name}<{head_dim}> spills: {resources[name]}")
    return secs


def kernel_resources(log, head_dim):
    """{kernel: resources at ``head_dim``}: what the card gives it
    (``_native.kernel_resources``) and its spill bytes from the compiler's
    report ``log``."""
    from rayfed_tpu_torch.ops import _native

    spills = ptxas_spills(log)
    return {name: dict(_native.kernel_resources(name, head_dim),
                       spill_bytes=spills.get(f"{name}<{head_dim}>"))
            for name in _native.KERNEL_NAMES}


def ptxas_report(log):
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``."""
    out, kernel = [], "?"
    for line in log.splitlines():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d+)E", line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "registers" in line or "spill" in line:
            out.append(f"{kernel}: " + line.split(":", 1)[-1].strip())
    return out


def ptxas_spills(log):
    """{"kernel<D>": spill store + load bytes} from ``nvcc -Xptxas -v``."""
    out = {}
    for line in ptxas_report(log):
        kernel, _, rest = line.partition(": ")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      rest)
        if m:
            out[kernel] = int(m.group(1)) + int(m.group(2))
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def causal_pairs(b, sq, sk, h, q_offset):
    """(query, key) pairs the causal mask keeps, over batch and heads."""
    return b * h * sum(min(q_offset + i + 1, sk) for i in range(sq))


def kernel_work(b, sq, sk, h, d, q_offset):
    """FLOPs and bytes each kernel needs on these shapes: 2*D FLOPs per
    kept (q, k) pair per matmul (K1 2 matmuls, K2 3, K3 4); bytes count
    each input read once and each output written once."""
    pairs = causal_pairs(b, sq, sk, h, q_offset)
    rq, rk, st = b * sq * h * d * 2, b * sk * h * d * 2, b * sq * h * 4
    return {
        "flash_fwd": (4 * d * pairs, rq + 2 * rk + rq + st),
        "flash_bwd_dq": (6 * d * pairs, 3 * rq + 2 * rk + rq + 2 * st),
        "flash_bwd_dkv": (8 * d * pairs, 2 * rq + 2 * rk + 2 * rk + 2 * st),
    }


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(device, b, sq, sk, h, d, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g, device=device).to(
            torch.bfloat16)

    return rnd(sq), rnd(sk), rnd(sk), rnd(sq)


def tile_rel_err(got, want):
    """Largest over the TILE-row tiles of the sequence (dim 1) of
    ||got - want|| / ||want||, each norm over the whole tile."""
    import torch

    errs = []
    for g, w in zip(torch.split(got.float(), TILE, dim=1),
                    torch.split(want.float(), TILE, dim=1)):
        errs.append(float(torch.linalg.vector_norm(g - w)
                          / torch.linalg.vector_norm(w).clamp(min=1e-30)))
    return max(errs)


def kernel_errors(device, b, sq, sk, h, d, q_offset, seed=0):
    """Each kernel's outputs against its plain version's on the same
    inputs (K2 and K3 fed the plain version's o, lse and delta). Returns
    ({output: (reading, limit)}, {kernel: max abs err}, inputs); a
    reading of NaN is a failure."""
    import torch

    from rayfed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(device, b, sq, sk, h, d, seed)
    bq, bk = fa._pow2_block(sq, 512), fa._pow2_block(sk, 512)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, bq, bk, q_offset)
    dq_ref, delta_ref = fa._flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do,
                                               bq, bk, q_offset)
    dk_ref, dv_ref = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta_ref,
                                             bq, bk, q_offset)
    o, lse = fa._flash_fwd_cuda(q, k, v, q_offset)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, o_ref, lse_ref, do, q_offset)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta_ref, q_offset)
    torch.cuda.synchronize()

    def abs_err(got, want):
        return float((got - want).abs().max())

    readings = {
        "K1 O": (tile_rel_err(o, o_ref), BF16_TILE_REL_TOL),
        "K1 lse": (abs_err(lse, lse_ref), F32_STAT_TOL),
        "K2 dq": (tile_rel_err(dq, dq_ref), BF16_TILE_REL_TOL),
        "K2 delta": (abs_err(delta, delta_ref), F32_STAT_TOL),
        "K3 dk": (tile_rel_err(dk, dk_ref), BF16_TILE_REL_TOL),
        "K3 dv": (tile_rel_err(dv, dv_ref), BF16_TILE_REL_TOL),
    }
    errs = {
        "flash_fwd": abs_err(o.float(), o_ref.float()),
        "flash_bwd_dq": abs_err(dq.float(), dq_ref.float()),
        "flash_bwd_dkv": max(abs_err(dk.float(), dk_ref.float()),
                             abs_err(dv.float(), dv_ref.float())),
    }
    return readings, errs, (q, k, v, do, o_ref, lse_ref, delta_ref, bq, bk)


def check_kernels(device, b, sq, sk, h, d, q_offset, seed=0):
    """:func:`kernel_errors`, printed, raising past any limit. Returns
    ({kernel: max abs err}, inputs)."""
    readings, errs, inputs = kernel_errors(device, b, sq, sk, h, d, q_offset,
                                           seed)
    shape = f"B={b} Sq={sq} Sk={sk} H={h} D={d} q_offset={q_offset}"
    bad = [f"{n} {r:.3g} > {lim:.3g}" for n, (r, lim) in readings.items()
           if not r <= lim]
    print(f"[kernels] {shape}: " + " ".join(
        f"{n}={r:.3g}" for n, (r, _) in readings.items())
        + " (O/dq/dk/dv: tile norm rel err; lse/delta: max abs err)"
        + (f"  FAILED: {bad}" if bad else "  ok"))
    require(not bad, f"kernel vs plain at {shape}: {bad}")
    return errs, inputs


def phase_kernels(device, batch, seq, heads, head_dim, smi):
    import torch
    import torch.nn.functional as F

    from rayfed_tpu_torch.ops import flash_attention as fa

    for shape in [(2, 96, 160, 3, 32, 64), (1, 192, 320, 4, 64, 128),
                  (2, 128, 128, 2, 16, 0), (1, 200, 200, 2, 128, 0),
                  (1, 256, 512, 4, 128, 256), (1, 136, 328, 3, 128, 150),
                  (2, 64, 64, 2, 128, 0), (1, 72, 200, 3, 128, 128)]:
        check_kernels(device, *shape, seed=1)

    b, s, h, d = batch, seq, heads, head_dim
    errs, (q, k, v, do, o, lse, delta, bq, bk) = check_kernels(
        device, b, s, s, h, d, 0)
    iters = 10
    ms = {
        "flash_fwd": cuda_ms(lambda: fa._flash_fwd_cuda(q, k, v, 0), iters),
        "flash_bwd_dq": cuda_ms(
            lambda: fa._flash_bwd_dq_cuda(q, k, v, o, lse, do, 0), iters),
        "flash_bwd_dkv": cuda_ms(
            lambda: fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, 0), iters),
    }
    plain_ms = {
        "flash_fwd": cuda_ms(
            lambda: fa._flash_fwd_plain(q, k, v, bq, bk, 0), 3, 1),
        "flash_bwd_dq": cuda_ms(
            lambda: fa._flash_bwd_dq_plain(q, k, v, o, lse, do, bq, bk, 0), 3, 1),
        "flash_bwd_dkv": cuda_ms(
            lambda: fa._flash_bwd_dkv_plain(q, k, v, do, lse, delta, bq, bk, 0),
            3, 1),
    }
    # Yardstick: one PyTorch call for the same function. The forward for
    # K1; the whole backward (dq, dk, dv at once) for K2 and K3.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters)
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                  "flash_bwd_dkv": sdpa_bwd}

    work = kernel_work(b, s, s, h, d, 0)
    results = {}
    for kern in KERNELS:
        n = kern["name"]
        flops, nbytes = work[n]
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        results[n] = dict(
            max_abs_err=errs[n], ms=ms[n], plain_ms=plain_ms[n],
            library_ms=library_ms[n], bound_ms=bound_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        )
        print(f"[kernels] {n} B={b} S={s} H={h} D={d}: {ms[n]:.3f} ms "
              f"(plain {plain_ms[n]:.3f}, sdpa {library_ms[n]:.3f}); "
              f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB; bound "
              f"{bound_ms:.3f} ms by {results[n]['bound_by']} "
              f"({100 * bound_ms / ms[n]:.1f}% of roofline, "
              f"{flops / ms[n] / 1e9:.1f} TFLOP/s) on {smi}")
    return results


# ---------------------------------------------------------------------------
# Phase 4: the federated round loop
# ---------------------------------------------------------------------------


def _trees_equal(a, b):
    import torch

    from rayfed_tpu_torch import tree_util

    la, sa = tree_util.tree_flatten(a)
    lb, sb = tree_util.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def fedavg_rounds(cfg, device, *, batch, seq, rounds, local_steps, lr,
                  init=0):
    """Two-party FedAvg (``PARTIES``) with flash attention: each round
    every party takes ``local_steps`` AdamW steps on its own data from the
    shared params, ``tree_mean`` folds the parties' params, and each party
    loads the aggregate in place (its optimizer moments carry on, as in
    ``examples/federated_transformer.py``). ``init`` is a seed or a numpy
    params tree. Returns the per-party losses, the aggregate's eval loss
    before and after each round, whether each round started from
    bitwise-identical trees, the step times, the kernel launches of the
    evaluations (the rest of the run's launches are the train steps') and
    the final aggregate."""
    import numpy as np
    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import tree_mean
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    on_cuda = torch.device(device).type == "cuda"
    init_fn, step_fn = make_fed_train_step(cfg, device, lr=lr, attn="flash")
    data = {name: synthetic_lm_dataset(cfg.vocab, batch * local_steps * (seq + 1),
                                       seq, seed=seed)
            for name, seed in PARTIES}
    state = {name: init_fn(init) for name in data}
    # One window from each party's data: the aggregate's eval block.
    eval_blk = torch.as_tensor(np.stack(
        [next(data[name].batches(batch, epoch=0))[0] for name in data]),
        device=device).long()
    eval_attn = fa.make_flash_attn_fn()
    eval_launches = dict.fromkeys(fa.LAUNCHES, 0)

    def eval_loss(params):
        before = dict(fa.LAUNCHES)
        with torch.no_grad():
            loss = float(tfm.lm_loss_pair(
                params, eval_blk[:, :-1], eval_blk[:, 1:], cfg, eval_attn,
                loss_chunk=512))
        for k in eval_launches:
            eval_launches[k] += fa.LAUNCHES[k] - before[k]
        return loss

    names = list(data)
    out = {"losses": {n: [] for n in names}, "step_ms": [],
           "starts_identical": [], "eval": [], "eval_launches": eval_launches}
    out["eval"].append(eval_loss(state[names[0]][0]))
    for r in range(rounds):
        first = state[names[0]][0]
        out["starts_identical"].append(
            all(_trees_equal(first, state[n][0]) for n in names[1:]))
        for name in names:
            params, opt = state[name]
            for blk in data[name].batches(batch, epoch=r):
                t0 = time.perf_counter()
                params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
                if on_cuda:
                    torch.cuda.synchronize()
                out["step_ms"].append(1e3 * (time.perf_counter() - t0))
                out["losses"][name].append(float(loss))
            state[name] = (params, opt)
        with torch.no_grad():
            agg = tree_mean(*[state[n][0] for n in names])
            for name in names:
                for p, a in zip(tree_util.tree_flatten(state[name][0])[0],
                                tree_util.tree_flatten(agg)[0]):
                    p.copy_(a)
        out["eval"].append(eval_loss(state[names[0]][0]))
    out["aggregate"] = state[names[0]][0]
    out["eval_block"] = eval_blk
    blk = next(data[names[0]].batches(batch, epoch=rounds))
    out["profile_step"] = lambda: step_fn(*state[names[0]], blk[:, :-1],
                                          blk[:, 1:])
    return out


def device_breakdown(fn):
    """Run ``fn`` once under ``torch.profiler`` and split the device time
    of the kernels it launched: flash kernels, matrix products (cuBLAS /
    CUTLASS names), everything else; plus the device's busy share of the
    host's wall time around the call. Returns None when the profiler
    recorded no device kernel (a CPU run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=acts) as prof:
        if on_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if on_cuda:
            torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    return kernel_split(kernels, wall_us) if kernels else None


def kernel_split(kernels, wall_us):
    """Device ms by kind and the idle share of ``wall_us``, from chrome
    trace kernel events (``name``, ``ts`` and ``dur`` in microseconds);
    overlapping kernels count once toward busy time."""
    split = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e["name"].lower()
        if "flash_" in name and "_kernel" in name:
            split["flash"] += e["dur"]
        elif any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass")):
            split["matmul"] += e["dur"]
        else:
            split["other"] += e["dur"]
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return dict({k: v / 1e3 for k, v in split.items()},
                busy_ms=busy / 1e3, wall_ms=wall_us / 1e3,
                idle_share=1.0 - busy / wall_us, n_kernels=len(kernels))


def phase_slice(device, cfg, *, batch, seq, rounds=3, local_steps=2,
                lr=1e-3, label=""):
    """Phase 4: run :func:`fedavg_rounds` and check it; returns a summary
    with the kernel launches counted during the run, the train steps'
    (``launches``) apart from the evaluations' (``eval_launches``)."""
    import torch

    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa

    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    run = fedavg_rounds(cfg, device, batch=batch, seq=seq, rounds=rounds,
                        local_steps=local_steps, lr=lr)
    wall = time.perf_counter() - t0
    eval_launches = run["eval_launches"]
    launches = {k: n - eval_launches[k] for k, n in fa.LAUNCHES.items()}

    require(all(run["starts_identical"]),
            f"parties started a round from different trees: "
            f"{run['starts_identical']}")
    flat = [x for v in run["losses"].values() for x in v] + run["eval"]
    require(all(x == x and abs(x) < 1e30 for x in flat),
            f"non-finite loss: {run['losses']} {run['eval']}")
    require(run["eval"][-1] < run["eval"][0],
            f"aggregate loss did not fall: {run['eval']}")
    # Flash and dense attention agree on the final aggregate's loss.
    blk = run["eval_block"]
    with torch.no_grad():
        dense = float(tfm.lm_loss_pair(run["aggregate"], blk[:, :-1],
                                       blk[:, 1:], cfg, None, loss_chunk=512))
    require(abs(dense - run["eval"][-1]) <= ATTN_LOSS_TOL,
            f"flash loss {run['eval'][-1]} vs dense {dense}")
    # One more local step of the first party, profiled after the checks
    # (it updates the aggregate's tensors in place) and the launch count.
    breakdown = device_breakdown(run["profile_step"])

    # The window: every step after the first (which warms the allocator
    # and the kernels' first launches up).
    steps = run["step_ms"][1:] or run["step_ms"]
    step_ms = statistics.median(steps)
    summary = dict(
        wall_s=wall, step_ms=step_ms,
        tokens_per_s=len(steps) * batch * seq / sum(steps) * 1e3,
        eval=run["eval"], dense_eval=dense, losses=run["losses"],
        launches=launches, eval_launches=eval_launches, breakdown=breakdown,
        max_memory_allocated=(torch.cuda.max_memory_allocated()
                              if on_cuda else None),
    )
    print(f"[slice] {label} eval loss per round {run['eval']} "
          f"(dense attention {dense:.5f})")
    print(f"[slice] {label} losses {run['losses']}")
    print(f"[slice] {label} {len(steps)} steps in {sum(steps):.1f} ms, "
          f"{summary['tokens_per_s']:.1f} tokens/s (step median "
          f"{step_ms:.1f} ms), max_memory_allocated "
          f"{summary['max_memory_allocated']}, wall {wall:.1f}s")
    print(f"[slice] {label} launches: train steps {launches}, "
          f"evaluations {eval_launches}")
    if breakdown is None:
        print(f"[slice] {label} device breakdown: not measured (no device "
              "kernels in the profile)")
    else:
        print(f"[slice] {label} one profiled step, device ms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in breakdown.items()
                          if k not in ("idle_share", "n_kernels"))
              + f"; idle share {breakdown['idle_share']:.3f}, "
              f"{breakdown['n_kernels']} kernels")
    return summary


def main():
    import torch

    name, smi = phase_device()
    phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])

    from rayfed_tpu_torch.models import transformer as tfm

    kern = phase_kernels("cuda", FLAGSHIP["batch"], FLAGSHIP["seq"],
                         FLAGSHIP["n_heads"],
                         FLAGSHIP["d_model"] // FLAGSHIP["n_heads"], smi)

    cfg = tfm.TransformerConfig(
        vocab=FLAGSHIP["vocab"], d_model=FLAGSHIP["d_model"],
        n_heads=FLAGSHIP["n_heads"], n_layers=SMOKE_LAYERS,
        d_ff=FLAGSHIP["d_ff"],
    )
    reduced = {"n_layers": [FLAGSHIP["n_layers"], SMOKE_LAYERS]}
    print("[slice] reduced " + json.dumps(reduced))
    summary = phase_slice("cuda", cfg, batch=FLAGSHIP["batch"],
                          seq=FLAGSHIP["seq"], label=f"on {smi}:")
    for k in KERNELS:
        require(summary["launches"][k["name"]] > 0,
                f"{k['name']} was not launched by the train steps: "
                f"{summary['launches']}")

    line = []
    for k in KERNELS:
        r = kern[k["name"]]
        line.append(dict(k, launches=summary["launches"][k["name"]],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
