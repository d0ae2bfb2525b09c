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
2. build: the Hopper kernels from ``rayfed_tpu_torch/csrc`` (nvcc, one
   process per source); each kernel's registers, spills, shared memory
   and resident blocks per SM at the flagship head dim (no kernel may
   spill), and, where the toolkit's ``cuobjdump`` runs, the tensor-core
   (HMMA, HGMMA) and FFMA instructions in each kernel's SASS.
3. kernels: each flash kernel against its plain PyTorch version on the
   card, the bf16 ones and the f32 ones, at the flagship attention shape
   and at small shapes (``q_offset > 0``, ``Sq < Sk``, ragged tiles, every
   head dim); at the flagship shape each f32 output (O, lse, dq, dk, dv)
   is also held to a tenth of the error of one TF32 product (the plain
   version run again with ``allow_tf32``), which an f32 kernel computing
   in TF32 fails; times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only; its backend named)
   with CUDA events; FLOPs, bytes and the roofline bound.
4. slice: one federated transformer round loop at the flagship width —
   two parties ("alice", "bob") each take local AdamW steps through
   ``make_fed_train_step(attn="flash")``, ``tree_mean`` folds their params
   on the card, both load the aggregate, for a few rounds. Checks: every
   round starts from bitwise-identical trees, losses are finite, the
   aggregate's loss falls, flash and dense attention agree on it, and
   the train steps launched every bf16 kernel (the evaluations' launches
   are counted apart).
4b. f32: the same model in f32 (``compute_dtype=torch.float32``,
   ``attn="auto"``) at the same width and depth: a few AdamW steps, which
   must launch every f32 kernel, and one more profiled (device ms by
   kind, idle share); then, at batch 1, one step's loss and gradients
   against the dense attention's (``attn="xla"``).
5. fed: the same FedAvg round through the port's own engine, at the same
   width and depth: ``alice`` and ``bob`` are spawned processes that
   ``fed.init`` over localhost TCP; a party-pinned ``LocalTrainer`` actor
   holds each party's params and AdamW state on the card, an
   ``aggregate`` task pinned to ``alice`` folds the trees with
   ``tree_mean``, ``fed.get`` brings the aggregate to both and each actor
   loads it in place, for two rounds. Checks: (a) every pushed tree
   arrives bitwise as its owner hashed it, (b) every round starts from
   identical params, (c) the receiver gets the pre-step bytes although
   the owner steps in place right after its push, (d) the aggregate's
   loss falls, (e) each party's train steps launch every bf16 kernel, (f)
   a bf16 tree crosses bitwise, (g) both parties ran the native IO path
   (``rayfed_tpu_torch._fastwire``). Prints each push's ms, GB/s and
   split, the IO path and each party's peak memory; then runs the phase
   once more with the parties on sockio's Python IO path and prints both
   splits side by side.
6. programs: the JAX package's FedAvg programs as the port's examples
   (``rayfed_tpu_torch/examples``), two spawned party processes each,
   with ``transport="cuda"``: ``federated_transformer.py`` at the same
   width and depth (``fed_aggregate`` mean, received trees placed on
   the party's card by the lane), then ``fedavg_cnn.py``
   (``FedAvgTrainer``, wmean over 640/384 shards), 2 rounds each.
   Checks: (a) every received tree is on the party's card in the
   consuming task, with no ``.to()`` there, (b) the root's aggregate on the
   card is bitwise the port's CPU fold of the two pushed trees, (c) both
   parties' final aggregates hash the same, (d) the aggregate's loss
   falls, (e) each party's steps launch every bf16 kernel, (f) both
   parties ran the native IO path; the CNN program's two digests agree.
   Prints each push's ms, GB/s and split (host staging, send, decode and
   the placement inside it), each round's wall and each party's peak
   memory.

It needs a CUDA card and exits non-zero without one. The last two lines
are the kernel table and ``{"ok": true, "device": {...}}`` as JSON.
"""

from __future__ import annotations

import json
import os
import re
import shutil
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
# Exact f32 has two routes (H100 SXM data sheet): FFMA on the CUDA cores,
# or each product split into three TF32 products on the tensor cores; an
# f32 kernel's bound takes the faster.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

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
# The f32 kernels are held as the JAX package's tests hold its f32
# kernels (tests/test_flash_attention.py): O to 2e-5 and the gradients to
# 3e-4, absolute; they round nothing between products, so only the order
# of f32 sums differs from the plain version's. lse and delta, f32 in both
# paths, are held tighter than the bf16 path's.
F32_OUT_TOL = 2e-5
F32_GRAD_TOL = 3e-4
F32_KERNEL_STAT_TOL = 1e-4
# Exact f32: at the main path's shape each f32 output's error is held to
# this fraction of the error of one TF32 product per f32 product (the
# plain version with ``allow_tf32``, on the same inputs). The f32 K1-K3
# multiply on the tensor cores as three TF32 products each; a kernel
# that issued one fails this limit whatever the size of its error against
# the limits above (at the main path's shape it also fails 3e-4, on small
# inputs it can pass it).
EXACT_F32_FRACTION = 0.1
# Phase 4b, batch 1: the f32 model with the f32 kernels against the dense
# attention, one step's loss (relative) and each gradient leaf (its
# difference's norm over its norm).
F32_LOSS_RTOL = 1e-4
F32_GRAD_RTOL = 1e-3
# Loss of the aggregate with flash vs dense attention (bf16 compute).
ATTN_LOSS_TOL = 2e-2
# The federation of phase 4: each party's name and data seed.
PARTIES = (("alice", 1), ("bob", 2))

# Each TPU kernel (rayfed_tpu/ops/flash_attention.py) takes bf16 or f32;
# the port has a Hopper kernel for each dtype.
KERNELS = [
    dict(name=name + sfx, route="cuda",
         source=f"rayfed_tpu_torch/csrc/flash_attention{sfx}.cu",
         replaces=f"rayfed_tpu/ops/flash_attention.py:{line}")
    for sfx in ("", "_f32")
    for name, line in (("flash_fwd", 51), ("flash_bwd_dq", 151),
                       ("flash_bwd_dkv", 200))
]
BF16_KERNELS = [k["name"] for k in KERNELS if not k["name"].endswith("_f32")]
F32_KERNELS = [k["name"] for k in KERNELS if k["name"].endswith("_f32")]


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
    counts = sass_counts(path)
    if counts is None:
        print("[build] SASS instruction counts: no cuobjdump in the toolkit")
    else:
        for name in _native.KERNEL_NAMES:
            c = counts.get(f"{name}<{head_dim}>", {})
            print(f"[build] {name}<{head_dim}> SASS: " + ", ".join(
                f"{c.get(op, 0)} {op}" for op in SASS_OPS))
    return secs


KERNEL_RE = r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_f32)?_kernel)ILi(\d+)E"
# Tensor-core products (mma.sync, wgmma) and CUDA-core f32 multiply-adds.
SASS_OPS = ("HMMA", "HGMMA", "FFMA")


def sass_counts(path):
    """{"kernel<D>": {op: instructions}} for ``SASS_OPS`` in the SASS of
    the library at ``path`` (``cuobjdump -sass``); None where the toolkit
    has no ``cuobjdump`` or it fails."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if not tool:
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None
    return parse_sass_counts(out.stdout)


def parse_sass_counts(sass):
    """:func:`sass_counts` from the text of ``cuobjdump -sass``."""
    counts, kernel = {}, None
    ops = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(KERNEL_RE, line)
            kernel = f"{m.group(1)}<{m.group(2)}>" if m else None
            if kernel:
                counts.setdefault(kernel, dict.fromkeys(SASS_OPS, 0))
        elif kernel:
            m = ops.search(line)
            if m:
                counts[kernel][m.group(1)] += 1
    return counts


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
        m = re.search(KERNEL_RE, line)
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


def kernel_work(b, sq, sk, h, d, q_offset, elem=2):
    """FLOPs and bytes each kernel needs on these shapes: 2*D FLOPs per
    kept (q, k) pair per matmul (K1 2 matmuls, K2 3, K3 4); bytes count
    each input read once and each output written once, q/k/v/o/do and
    their gradients ``elem`` bytes an element (2 in bf16, 4 in f32)."""
    pairs = causal_pairs(b, sq, sk, h, q_offset)
    rq, rk, st = b * sq * h * d * elem, b * sk * h * d * elem, b * sq * h * 4
    return {
        "flash_fwd": (4 * d * pairs, rq + 2 * rk + rq + st),
        "flash_bwd_dq": (6 * d * pairs, 3 * rq + 2 * rk + rq + 2 * st),
        "flash_bwd_dkv": (8 * d * pairs, 2 * rq + 2 * rk + 2 * rk + 2 * st),
    }


def bound(flops, nbytes, dtype):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the card's rate for ``dtype``
    (bf16 on the tensor cores; f32 exactly, by the faster of FFMA and
    three TF32 products)."""
    if dtype == "bfloat16":
        t_ops = flops / PEAK_BF16_FLOPS
    else:
        t_ops = min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


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


def _inputs(device, b, sq, sk, h, d, seed, dtype="bfloat16"):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g, device=device).to(
            getattr(torch, dtype))

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


def abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def kernel_errors(device, b, sq, sk, h, d, q_offset, seed=0,
                  dtype="bfloat16", exact_f32=False):
    """Each kernel of ``dtype`` ("bfloat16" or "float32") against its
    plain version on the same inputs (K2 and K3 fed the plain version's o,
    lse and delta). The plain version runs its f32 products in full f32
    (TF32 off). Returns ({output: (reading, limit)}, {kernel: max abs
    err}, inputs); a reading of NaN is a failure. bf16 outputs are read
    by :func:`tile_rel_err`, f32 ones by their largest absolute error.
    With ``exact_f32`` (f32 only) the plain version runs once more with
    TF32 on, and each output's reading "<kernel> f32 <output> exact" is
    its error against a limit of ``EXACT_F32_FRACTION`` times that TF32
    run's error; TF32 is off again before anything else runs."""
    import torch

    from rayfed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _inputs(device, b, sq, sk, h, d, seed, dtype)
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

    if dtype == "bfloat16":
        tag, sfx = "", ""
        out = grad = (tile_rel_err, BF16_TILE_REL_TOL)
        stat_tol = F32_STAT_TOL
    else:
        tag, sfx = " f32", "_f32"
        out, grad = (abs_err, F32_OUT_TOL), (abs_err, F32_GRAD_TOL)
        stat_tol = F32_KERNEL_STAT_TOL

    def reading(measure, got, want):
        return measure[0](got, want), measure[1]

    readings = {
        f"K1{tag} O": reading(out, o, o_ref),
        f"K1{tag} lse": (abs_err(lse, lse_ref), stat_tol),
        f"K2{tag} dq": reading(grad, dq, dq_ref),
        f"K2{tag} delta": (abs_err(delta, delta_ref), stat_tol),
        f"K3{tag} dk": reading(grad, dk, dk_ref),
        f"K3{tag} dv": reading(grad, dv, dv_ref),
    }
    if exact_f32:
        require(dtype == "float32", "the exact-f32 reading is for f32")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            o_tf, lse_tf = fa._flash_fwd_plain(q, k, v, bq, bk, q_offset)
            dq_tf = fa._flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do, bq,
                                           bk, q_offset)[0]
            dk_tf, dv_tf = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref,
                                                   delta_ref, bq, bk,
                                                   q_offset)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for name, got, tf, want in (("K1 f32 O", o, o_tf, o_ref),
                                    ("K1 f32 lse", lse, lse_tf, lse_ref),
                                    ("K2 f32 dq", dq, dq_tf, dq_ref),
                                    ("K3 f32 dk", dk, dk_tf, dk_ref),
                                    ("K3 f32 dv", dv, dv_tf, dv_ref)):
            readings[name + " exact"] = (
                abs_err(got, want), EXACT_F32_FRACTION * abs_err(tf, want))
    errs = {
        "flash_fwd" + sfx: abs_err(o, o_ref),
        "flash_bwd_dq" + sfx: abs_err(dq, dq_ref),
        "flash_bwd_dkv" + sfx: max(abs_err(dk, dk_ref), abs_err(dv, dv_ref)),
    }
    return readings, errs, (q, k, v, do, o_ref, lse_ref, delta_ref, bq, bk)


def check_kernels(device, b, sq, sk, h, d, q_offset, seed=0,
                  dtype="bfloat16", exact_f32=False):
    """:func:`kernel_errors`, printed, raising past any limit. Returns
    ({kernel: max abs err}, inputs)."""
    readings, errs, inputs = kernel_errors(device, b, sq, sk, h, d, q_offset,
                                           seed, dtype, exact_f32)
    shape = f"{dtype} B={b} Sq={sq} Sk={sk} H={h} D={d} q_offset={q_offset}"
    how = ("O/dq/dk/dv: tile norm rel err" if dtype == "bfloat16"
           else "O/dq/dk/dv: max abs err")
    bad = [f"{n} {r:.3g} > {lim:.3g}" for n, (r, lim) in readings.items()
           if not r <= lim]
    exact = {n: rl for n, rl in readings.items() if n.endswith(" exact")}
    print(f"[kernels] {shape}: " + " ".join(
        f"{n}={r:.3g}" for n, (r, _) in readings.items() if n not in exact)
        + f" ({how}; lse/delta: max abs err)"
        + ("; exact f32, kernel err vs one TF32 product's err: " + ", ".join(
            f"{n.split()[-2]} {r:.3g} vs {lim / EXACT_F32_FRACTION:.3g}"
            for n, (r, lim) in exact.items())
           + f" (limit {EXACT_F32_FRACTION:g}x)" if exact else "")
        + (f"  FAILED: {bad}" if bad else "  ok"))
    require(not bad, f"kernel vs plain at {shape}: {bad}")
    return errs, inputs


def profiled_kernels(fn):
    """Run ``fn`` once under ``torch.profiler``; the device kernels it
    launched (chrome trace events: ``name``, ``ts``, ``dur`` in
    microseconds) and the host's wall time around it in microseconds."""
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
    return ([e for e in events if e.get("cat") == "kernel" and "dur" in e],
            wall_us)


def sdpa_backend(kernel_names):
    """Which ``scaled_dot_product_attention`` backend launched these
    device kernels."""
    names = " ".join(kernel_names).lower()
    # cuDNN's kernel names contain "flash" too: it is matched first.
    for backend, marks in (("cudnn", ("cudnn",)),
                           ("efficient", ("fmha", "efficient", "mem_eff")),
                           ("flash", ("flash",))):
        if any(m in names for m in marks):
            return backend
    return "math"


def phase_kernels(device, batch, seq, heads, head_dim, smi):
    """Phase 3: every kernel, bf16 and f32, against its plain version at
    small shapes and at the main path's; then each kernel's time there
    beside its plain version's, SDPA's on the same inputs and its bound.
    Returns {kernel: results}."""
    results = {}
    for dtype in ("bfloat16", "float32"):
        for shape in [(2, 96, 160, 3, 32, 64), (1, 192, 320, 4, 64, 128),
                      (2, 128, 128, 2, 16, 0), (1, 200, 200, 2, 128, 0),
                      (1, 256, 512, 4, 128, 256), (1, 136, 328, 3, 128, 150),
                      (2, 64, 64, 2, 128, 0), (1, 72, 200, 3, 128, 128),
                      (1, 100, 90, 2, 64, 20)]:
            check_kernels(device, *shape, seed=1, dtype=dtype)
        results.update(time_kernels(device, batch, seq, heads, head_dim,
                                    dtype, smi))
    return results


def time_kernels(device, b, s, h, d, dtype, smi):
    """The kernels of ``dtype`` at the main path's shape: checked, then
    timed with CUDA events beside their plain versions and SDPA."""
    import torch
    import torch.nn.functional as F

    from rayfed_tpu_torch.ops import flash_attention as fa

    sfx = "" if dtype == "bfloat16" else "_f32"
    errs, (q, k, v, do, o, lse, delta, bq, bk) = check_kernels(
        device, b, s, s, h, d, 0, dtype=dtype,
        exact_f32=dtype == "float32")
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

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    sdpa_fwd = cuda_ms(sdpa, iters)
    out = sdpa()
    dot = do.transpose(1, 2)

    def sdpa_grad():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    sdpa_bwd = cuda_ms(sdpa_grad, iters)
    names = sorted({e["name"] for fn in (sdpa, sdpa_grad)
                    for e in profiled_kernels(fn)[0]})
    print(f"[kernels] {dtype} sdpa backend {sdpa_backend(names)}: "
          f"{names[:6]}")
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                  "flash_bwd_dkv": sdpa_bwd}

    work = kernel_work(b, s, s, h, d, 0, elem=2 if dtype == "bfloat16" else 4)
    results = {}
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        flops, nbytes = work[n]
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        results[n + sfx] = dict(
            max_abs_err=errs[n + sfx], ms=ms[n], plain_ms=plain_ms[n],
            library_ms=library_ms[n], bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernels] {n + sfx} {dtype} B={b} S={s} H={h} D={d}: "
              f"{ms[n]:.3f} ms (plain {plain_ms[n]:.3f}, sdpa "
              f"{library_ms[n]:.3f}); {flops / 1e12:.3f} TFLOP, "
              f"{nbytes / 1e6:.1f} MB; bound {bound_ms:.3f} ms by {bound_by} "
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
    kernels, wall_us = profiled_kernels(fn)
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
    print_breakdown("[slice]", label, breakdown)
    return summary


def print_breakdown(tag, label, breakdown):
    """Print :func:`device_breakdown`'s split of one profiled step."""
    if breakdown is None:
        print(f"{tag} {label} device breakdown: not measured (no device "
              "kernels in the profile)")
    else:
        print(f"{tag} {label} one profiled step, device ms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in breakdown.items()
                          if k not in ("idle_share", "n_kernels"))
              + f"; idle share {breakdown['idle_share']:.3f}, "
              f"{breakdown['n_kernels']} kernels")


# ---------------------------------------------------------------------------
# Phase 4b: the f32 model through the f32 kernels
# ---------------------------------------------------------------------------

F32_STEPS = 4  # timed, after one that warms the allocator and kernels up


def phase_f32(device, cfg, *, batch, seq, steps=F32_STEPS, lr=1e-3,
              label=""):
    """Phase 4b: ``cfg`` in f32 (``compute_dtype=torch.float32``) through
    ``make_fed_train_step(attn="auto")``, which takes the f32 flash
    kernels on a card: ``steps`` + 1 AdamW steps at ``batch``, then one
    batch-1 step's loss and gradients (the train step's loss function,
    ``lm_loss_pair``) with the flash kernels against the same with the
    dense attention (``attn="xla"``). One more step at ``batch``, after
    the launches are taken, is profiled by :func:`device_breakdown`.
    Returns a summary with the kernel launches of the steps."""
    import dataclasses
    import gc

    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    on_cuda = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    data = synthetic_lm_dataset(cfg.vocab, batch * (steps + 1) * (seq + 1),
                                seq, seed=PARTIES[0][1])
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    init_fn, step_fn = make_fed_train_step(cfg, device, lr=lr, attn="auto")
    params, opt = init_fn(0)
    step_ms, losses = [], []
    for blk in data.batches(batch, epoch=0):
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        if on_cuda:
            torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    require(len(losses) == steps + 1 and
            all(x == x and abs(x) < 1e30 for x in losses),
            f"f32 steps: losses {losses}")
    # One more step, profiled: how the step's device time divides.
    breakdown = device_breakdown(
        lambda: step_fn(params, opt, blk[:, :-1], blk[:, 1:]))
    del params, opt
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    # Batch 1: one step's loss and gradients, flash kernels vs dense.
    params = tree_util.tree_map(lambda p: p.requires_grad_(True),
                                tfm.init_params(0, cfg, device))
    leaves = tree_util.tree_flatten(params)[0]
    blk = torch.as_tensor(next(data.batches(1, epoch=1)), device=device).long()
    got = {}
    for attn, attn_fn in (("flash", fa.make_flash_attn_fn()), ("xla", None)):
        loss = tfm.lm_loss_pair(params, blk[:, :-1], blk[:, 1:], cfg, attn_fn,
                                loss_chunk=512)
        got[attn] = (float(loss.detach()),
                     torch.autograd.grad(loss, leaves))
    loss_rel = abs(got["flash"][0] - got["xla"][0]) / abs(got["xla"][0])
    grad_rel = max(
        float(torch.linalg.vector_norm(g - w)
              / torch.linalg.vector_norm(w).clamp(min=1e-30))
        for g, w in zip(got["flash"][1], got["xla"][1]))
    timed = step_ms[1:]
    summary = dict(
        step_ms=statistics.median(timed),
        tokens_per_s=len(timed) * batch * seq / sum(timed) * 1e3,
        losses=losses, launches=launches, max_memory_allocated=peak,
        loss_rel=loss_rel, grad_rel=grad_rel, breakdown=breakdown)
    print(f"[f32] {label} {len(timed)} steps after the first: step median "
          f"{summary['step_ms']:.1f} ms, {summary['tokens_per_s']:.1f} "
          f"tokens/s, max_memory_allocated {peak}; losses {losses}")
    print(f"[f32] {label} launches {launches}")
    print_breakdown("[f32]", label, breakdown)
    print(f"[f32] {label} batch 1, flash vs attn='xla': loss "
          f"{got['flash'][0]:.6f} vs {got['xla'][0]:.6f} (rel {loss_rel:.3g} "
          f"<= {F32_LOSS_RTOL}), largest gradient leaf rel err "
          f"{grad_rel:.3g} (<= {F32_GRAD_RTOL})")
    require(loss_rel <= F32_LOSS_RTOL,
            f"f32 loss with flash vs dense: rel {loss_rel}")
    require(grad_rel <= F32_GRAD_RTOL,
            f"f32 gradients with flash vs dense: rel {grad_rel}")
    return summary


# ---------------------------------------------------------------------------
# Phase 5: the same round through the port's engine, two processes
# ---------------------------------------------------------------------------

FED_ROUNDS = 2
FED_JOIN_TIMEOUT_S = 480
# Retry fast while the peer comes up; no payload cap (a params push is
# 1.36 GB at the flagship width, past the 500 MB default).
FED_COMM = {"retry_policy": {"max_attempts": 30, "initial_backoff_ms": 100,
                             "max_backoff_ms": 1000},
            "messages_max_size_in_bytes": 0}


def _tree_digest(tree):
    """sha256 of each tensor leaf's bytes (bf16 through its int16 view);
    a CUDA leaf is copied to host first."""
    import hashlib

    import torch

    from rayfed_tpu_torch import tree_util

    out = []
    for x in tree_util.tree_flatten(tree)[0]:
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        out.append(hashlib.sha256(x.numpy().tobytes()).hexdigest())
    return out


def _tree_nbytes(tree):
    from rayfed_tpu_torch import tree_util

    return sum(x.nbytes for x in tree_util.tree_flatten(tree)[0])


def _last_span(kind, min_bytes):
    """This process's latest tracing span of ``kind`` moving at least
    ``min_bytes``: the one of the push just made or received."""
    from rayfed_tpu_torch import tracing

    spans = [sp for sp in tracing.get_spans(kind) if sp.nbytes >= min_bytes]
    return spans[-1] if spans else None


def _span_ms(sp):
    return None if sp is None else 1e3 * sp.duration_s


def _arrive(tree, device, t_sent=None):
    """The receiving end of a push: the tree's leaves on ``device`` and
    what the push took. ``push_ms`` runs from ``t_sent`` (the owner's wall
    clock when its value resolved) to the leaves on the device: until the
    frame finished decoding (its ``decode`` span), plus the timed copy to
    the device. Also the digest of the bytes that arrived."""
    import torch

    from rayfed_tpu_torch import tree_util

    nbytes = _tree_nbytes(tree)
    dec = _last_span("decode", nbytes)
    leaves, spec = tree_util.tree_flatten(tree)
    t = time.perf_counter()
    on_dev = [x.to(device) for x in leaves]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    h2d_ms = 1e3 * (time.perf_counter() - t)
    push_ms = None
    if dec is not None and t_sent is not None:
        decoded_at = dec.start_s + dec.duration_s + time.time() \
            - time.perf_counter()
        push_ms = 1e3 * (decoded_at - t_sent) + h2d_ms
    info = dict(nbytes=nbytes, push_ms=push_ms, h2d_ms=h2d_ms,
                decode_ms=_span_ms(dec), digest=_tree_digest(tree))
    return tree_util.tree_unflatten(on_dev, spec), info


def _sender_spans(nbytes):
    """This process's host staging (``stage``) and socket send (``send``)
    ms of its latest push of ``nbytes`` or more."""
    return dict(stage_ms=_span_ms(_last_span("stage", nbytes)),
                send_ms=_span_ms(_last_span("send", nbytes)))


def _fed_program(party, addresses, device, cfg_kw, batch, seq, rounds,
                 local_steps, lr):
    """Phase 5's driver: the same program runs in every party. Returns
    what the parent checks and prints; every value in it reached this
    party through ``fed.get``, so both parties return the same."""
    import numpy as np
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import tracing, tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import tree_mean
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from rayfed_tpu_torch.proxy.tcp import sockio

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    seeds = dict(PARTIES)
    names = [n for n, _ in PARTIES]
    root, other = names

    def party_data(name):
        return synthetic_lm_dataset(cfg.vocab, batch * local_steps * (seq + 1),
                                    seq, seed=seeds[name])

    tracing.enable()
    fed.init(addresses=addresses, party=party, logging_level="warning",
             config={"cross_silo_comm": FED_COMM})

    @fed.remote
    class LocalTrainer:
        """One party's params and AdamW state on its device."""

        def __init__(self, name):
            self.name = name
            init_fn, self.step_fn = make_fed_train_step(
                cfg, device, lr=lr, attn="flash")
            self.params, self.opt = init_fn(0)
            self.data = party_data(name)
            self.losses = []
            self.eval_launches = dict.fromkeys(fa.LAUNCHES, 0)
            self.sent = None

        def _step(self, blk):
            self.params, self.opt, loss = self.step_fn(
                self.params, self.opt, blk[:, :-1], blk[:, 1:])
            self.losses.append(float(loss))

        def digest(self):
            return _tree_digest(self.params)

        def train(self, r):
            for blk in self.data.batches(batch, epoch=r):
                self._step(blk)
            # The owner's digest of what it pushes, then the push.
            self.sent = _tree_digest(self.params)
            return {"params": self.params, "t": time.time()}

        def step_after_push(self, r):
            # The next opt.step() rewrites the pushed tensors in place
            # while the push may still be in flight.
            self._step(next(self.data.batches(batch, epoch=rounds + r)))
            return self.losses[-1]

        def sent_digest(self):
            return self.sent

        def load(self, agg):
            info = None
            params = agg["params"]
            if self.name != root:
                params, info = _arrive(params, device, agg["t"])
            with torch.no_grad():
                for p, a in zip(tree_util.tree_flatten(self.params)[0],
                                tree_util.tree_flatten(params)[0]):
                    p.copy_(a)
            return info

        def bf16_params(self):
            tree = tree_util.tree_map(lambda x: x.to(torch.bfloat16),
                                      self.params)
            self.sent = _tree_digest(tree)
            return tree

        def eval_loss(self):
            blk = torch.as_tensor(np.stack(
                [next(party_data(n).batches(batch, epoch=0))[0]
                 for n in names]), device=device).long()
            before = dict(fa.LAUNCHES)
            with torch.no_grad():
                loss = float(tfm.lm_loss_pair(
                    self.params, blk[:, :-1], blk[:, 1:], cfg,
                    fa.make_flash_attn_fn(), loss_chunk=512))
            for k in self.eval_launches:
                self.eval_launches[k] += fa.LAUNCHES[k] - before[k]
            return loss

        def report(self):
            return dict(
                launches={k: n - self.eval_launches[k]
                          for k, n in fa.LAUNCHES.items()},
                eval_launches=self.eval_launches,
                max_memory_allocated=(torch.cuda.max_memory_allocated()
                                      if on_cuda else None),
                io_path=sockio.io_path(),
            )

    @fed.remote
    def aggregate(mine, theirs):
        params, info = _arrive(theirs["params"], device, theirs["t"])
        with torch.no_grad():
            agg = tree_mean(mine["params"], params)
        # The owner's digest of what it pushes, then the push.
        info["owner_digest_next"] = _tree_digest(agg)
        return {"params": agg, "t": time.time()}, info

    @fed.remote
    def sender_spans(nbytes):
        return _sender_spans(nbytes)

    @fed.remote
    def received_digest(tree):
        return _arrive(tree, device)[1]["digest"]

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    trainers = {n: LocalTrainer.party(n).remote(n) for n in names}
    evals = [fed.get(trainers[root].eval_loss.remote())]
    rounds_out = []
    for r in range(rounds):
        t0 = time.perf_counter()
        starts = fed.get([trainers[n].digest.remote() for n in names])
        pushed = {n: trainers[n].train.remote(r) for n in names}
        agg, agg_info = aggregate.party(root).options(num_returns=2).remote(
            pushed[root], pushed[other])
        # Submitted after the push is registered, so the push captures
        # the trained tree as it resolves; the step then rewrites those
        # tensors in place while the push is in flight.
        after = trainers[other].step_after_push.remote(r)
        sent = trainers[other].sent_digest.remote()
        fed.get(agg)
        loaded = [trainers[n].load.remote(agg) for n in names]
        sent, params_push, aggregate_push, _ = fed.get(
            [sent, agg_info, loaded[1], after])
        spans = fed.get([sender_spans.party(n).remote(push["nbytes"])
                         for n, push in ((root, aggregate_push),
                                         (other, params_push))])
        params_push.update(spans[1], owner_digest=sent)
        aggregate_push.update(spans[0],
                              owner_digest=params_push.pop("owner_digest_next"))
        evals.append(fed.get(trainers[root].eval_loss.remote()))
        rounds_out.append(dict(
            wall_s=time.perf_counter() - t0,
            starts_identical=all(d == starts[0] for d in starts[1:]),
            params_push=params_push, aggregate_push=aggregate_push))
    bf = trainers[other].bf16_params.remote()
    bf16 = fed.get([trainers[other].sent_digest.remote(),
                    received_digest.party(root).remote(bf)])
    reports = fed.get([trainers[n].report.remote() for n in names])
    fed.shutdown()
    return dict(party=party, evals=evals, rounds=rounds_out,
                bf16_digests=bf16, reports=dict(zip(names, reports)))


def _fed_program_python_io(party, addresses, *args):
    """:func:`_fed_program` with this party's wire on sockio's Python IO
    path: the port's references to its native module are taken away
    before ``fed.init`` (the comparison run of phase 5)."""
    from rayfed_tpu_torch.proxy import lanes
    from rayfed_tpu_torch.proxy.tcp import checksum, sockio

    sockio._fastwire = checksum._fw = lanes._fw = None
    return _fed_program(party, addresses, *args)


def fed_party(program, party, addresses, out_path, *args):
    """A party process of phases 5 and 6 (spawned): runs ``program(party,
    addresses, *args)`` and writes its result, or the error, as JSON to
    ``out_path``."""
    import traceback

    try:
        result = dict(ok=True, **program(party, addresses, *args))
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = dict(ok=False, error=traceback.format_exc())
    with open(out_path, "w") as f:
        json.dump(result, f)
    sys.exit(0 if result["ok"] else 1)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_fed(device, cfg, *, batch, seq, rounds=FED_ROUNDS, local_steps=2,
              lr=1e-3, label="", timeout_s=FED_JOIN_TIMEOUT_S,
              io_path="native"):
    """Phase 5: :func:`fedavg_rounds`'s FedAvg round driven through the
    port's own engine, one spawned process per party over localhost TCP,
    and checked: (a) every tree that crossed arrived bitwise as its
    owner hashed it, (b) every round started from identical params, (c)
    the receiver got the pre-step bytes although the owner stepped in
    place right after its push, (d) the aggregate's loss fell, (e) each
    party's train steps launched every bf16 kernel, (f) a bf16 tree
    crossed bitwise, (g) both parties ran ``io_path`` ("native", or
    "python" for the comparison run, whose parties drop the native
    module). Returns both parties' results."""
    import dataclasses

    import torch

    if torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info()
        print(f"[fed] {label} at the spawn: {free} of {total} bytes free")
    program = _fed_program if io_path == "native" else _fed_program_python_io
    results, wall = spawn_parties(
        program, (device, dataclasses.asdict(cfg), batch, seq, rounds,
                  local_steps, lr), timeout_s)
    return check_fed(results, device, wall, label, io_path)


def spawn_parties(program, args, timeout_s):
    """Run ``program(party, addresses, *args)`` in one spawned process per
    party over localhost TCP; returns each party's result and the wall
    time from spawn to exit. Fails on a party's error, a missing result
    or the join timeout (every process is stopped first)."""
    import multiprocessing

    mp = multiprocessing.get_context("spawn")
    addresses = {n: f"127.0.0.1:{_free_port()}" for n, _ in PARTIES}
    with tempfile.TemporaryDirectory() as tmp:
        outs = {n: os.path.join(tmp, f"{n}.json") for n, _ in PARTIES}
        procs = {n: mp.Process(target=fed_party, name=f"party-{n}", args=(
            program, n, addresses, outs[n]) + tuple(args))
            for n, _ in PARTIES}
        t0 = time.perf_counter()
        for p in procs.values():
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs.values():
            p.join(max(0.0, deadline - time.monotonic()))
        late = [n for n, p in procs.items() if p.is_alive()]
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
        wall = time.perf_counter() - t0
        require(not late, f"party processes {late} did not finish within "
                          f"{timeout_s} s")
        results = {}
        for n, p in procs.items():
            require(os.path.exists(outs[n]),
                    f"party {n} exited with code {p.exitcode} and no result")
            with open(outs[n]) as f:
                results[n] = json.load(f)
            require(results[n]["ok"] and p.exitcode == 0,
                    f"party {n} failed (exit code {p.exitcode}):\n"
                    f"{results[n].get('error')}")
    return results, wall


def check_fed(results, device, wall, label="", io_path="native"):
    """Phase 5's checks (a)-(g) over both parties' results, and its
    report: per round the wall time and each push's ms, GB/s and split."""
    import torch

    root, other = (n for n, _ in PARTIES)
    res = results[root]
    require(all(results[other][k] == res[k]
                for k in ("evals", "bf16_digests", "reports")),
            "the parties disagree on values both fetched through fed.get")
    for r, rnd in enumerate(res["rounds"]):
        require(rnd["starts_identical"],
                f"(b) round {r} started from different params")
        for push in ("params_push", "aggregate_push"):
            require(rnd[push]["digest"] == rnd[push]["owner_digest"],
                    f"(a)/(c) round {r}: the {push} arrived with other bytes "
                    f"than its owner pushed")
    require(res["evals"][-1] < res["evals"][0],
            f"(d) the aggregate's loss did not fall: {res['evals']}")
    bf_sent, bf_got = res["bf16_digests"]
    require(bf_sent == bf_got, "(f) the bf16 tree did not cross bitwise")
    if torch.device(device).type == "cuda":
        for n, rep in res["reports"].items():
            require(all(rep["launches"][k] > 0 for k in BF16_KERNELS),
                    f"(e) party {n}'s train steps did not launch every "
                    f"kernel: {rep['launches']}")
    paths = {n: rep["io_path"] for n, rep in res["reports"].items()}
    require(set(paths.values()) == {io_path},
            f"(g) the parties ran IO paths {paths}, not {io_path!r}")

    def ms(v):
        return "not measured" if v is None else f"{v:.1f} ms"

    print(f"[fed] {label} two party processes, {len(res['rounds'])} rounds "
          f"in {wall:.1f} s from spawn to exit; IO path {paths}")
    print(f"[fed] {label} aggregate eval loss per round {res['evals']}")
    for r, rnd in enumerate(res["rounds"]):
        parts = [f"round {r}: wall {rnd['wall_s']:.2f} s"]
        for push in ("params_push", "aggregate_push"):
            got = rnd[push]
            total = got["push_ms"]
            rate = ("" if total is None else
                    f", {got['nbytes'] / total / 1e6:.3f} GB/s")
            share = ("" if total is None or got["stage_ms"] is None else
                     f" ({100 * got['stage_ms'] / total:.1f}%)")
            parts.append(
                f"{push} {got['nbytes']} B: {ms(total)}{rate}; host staging "
                f"{ms(got['stage_ms'])}{share}, send {ms(got['send_ms'])}, "
                f"decode {ms(got['decode_ms'])}, to the card "
                f"{ms(got['h2d_ms'])}")
        print(f"[fed] {label} " + "; ".join(parts))
    for n, rep in res["reports"].items():
        print(f"[fed] {label} party {n}: train launches {rep['launches']}, "
              f"evaluations {rep['eval_launches']}, max_memory_allocated "
              f"{rep['max_memory_allocated']}")
    return results


def compare_io_paths(runs):
    """Print phase 5's pushes of the native and the Python IO path's runs
    side by side: total, host staging, send and decode."""
    root = PARTIES[0][0]
    rows = {io: [(r, push, rnd[push]) for r, rnd in
                 enumerate(res[root]["rounds"])
                 for push in ("params_push", "aggregate_push")]
            for io, res in runs.items()}

    def ms(v):
        return "n/m" if v is None else f"{v:.1f}"

    for (r, push, nat), (_, _, py) in zip(rows["native"], rows["python"]):
        print(f"[fed] IO paths, round {r} {push} {nat['nbytes']} B, ms "
              f"native / python: total {ms(nat['push_ms'])} / "
              f"{ms(py['push_ms'])}, host staging {ms(nat['stage_ms'])} / "
              f"{ms(py['stage_ms'])}, send {ms(nat['send_ms'])} / "
              f"{ms(py['send_ms'])}, decode {ms(nat['decode_ms'])} / "
              f"{ms(py['decode_ms'])}")


# ---------------------------------------------------------------------------
# Phase 6: the JAX package's FedAvg programs on the port
# ---------------------------------------------------------------------------

PROGRAM_ROUNDS = 2
# Check (b)'s three-party weights: inexact in bf16, their total in f32.
W3 = (0.37, 1.7, 1000.5)
PUSH_KINDS = ("stage", "send", "decode", "place")


def _push_spans():
    """This process's spans of ``PUSH_KINDS``, start on the wall clock:
    ``[kind, up, down, start_s, duration_s, nbytes]``."""
    from rayfed_tpu_torch import tracing

    offset = time.time() - time.perf_counter()
    return [[sp.kind, str(sp.upstream_seq_id), str(sp.downstream_seq_id),
             sp.start_s + offset, sp.duration_s, sp.nbytes]
            for sp in tracing.get_spans() if sp.kind in PUSH_KINDS]


def _int_view(x):
    """``x``'s bits as integers of its width (NaNs compare as bits)."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()])


def _lm_program(party, addresses, device, cfg_kw, batch, seq, rounds,
                local_steps, lr):
    """Phase 6's transformer program: the rounds of
    ``rayfed_tpu_torch/examples/federated_transformer.py`` (its
    ``LmWorker`` and ``run``) at ``cfg_kw``'s width, with
    ``transport="cuda"`` on a card ("tcp" on the CPU), plus what the
    parent checks: where the pushed tree landed and the root's aggregate
    against the CPU fold each round, the aggregate's eval loss before and
    after, the final aggregate's digest, each party's kernel launches,
    peak memory and push spans."""
    import numpy as np
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh, topology, tracing, tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.examples import federated_transformer as example
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import reduce_by_plan
    from rayfed_tpu_torch.proxy.tcp import sockio

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    names = [n for n, _ in PARTIES]
    root, other = names
    tracing.enable()
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if on_cuda else "tcp",
             config={"cross_silo_comm": FED_COMM})
    party_dev = mesh.get_party_device() if on_cuda else torch.device("cpu")
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    eval_launches = dict.fromkeys(fa.LAUNCHES, 0)

    @fed.remote
    def evaluate(params):
        """The loss of ``params`` (the workers' initial params when None)
        on one window of each party's data."""
        if params is None:
            params = tfm.init_params(0, cfg, party_dev)
        blk = torch.as_tensor(np.stack([next(synthetic_lm_dataset(
            cfg.vocab, batch * local_steps * (seq + 1), seq, seed=s
        ).batches(batch, epoch=0))[0] for _, s in PARTIES]),
            device=party_dev).long()
        before = dict(fa.LAUNCHES)
        with torch.no_grad():
            loss = float(tfm.lm_loss_pair(
                params, blk[:, :-1], blk[:, 1:], cfg, fa.make_flash_attn_fn(),
                loss_chunk=512))
        for k in eval_launches:
            eval_launches[k] += fa.LAUNCHES[k] - before[k]
        return loss

    @fed.remote
    def check_round(mine, theirs, agg):
        """At the root, once the round's aggregate is ready: (a) where
        the other party's pushed tree landed, (b) the aggregate, computed
        on the party's device, against the CPU fold of both pushed trees
        taken to host (``reduce_by_plan``: the same sum and divide as
        ``fed_aggregate``); and, since dividing two parties' sum by 2 is
        exact, ``reduce_by_plan`` over three parties (the two pushed
        trees and the aggregate) on the device against the CPU, in f32
        and bf16, as a mean (divide by 3) and weighted by ``W3`` (a
        total inexact in f32, weights inexact in bf16)."""
        started = time.time()

        def host(t):
            return tree_util.tree_map(lambda x: x.detach().cpu(), t)

        def mismatches(xs, ys):
            return sum(int((_int_view(a) != _int_view(b)).sum())
                       for a, b in zip(xs, ys))

        want = reduce_by_plan(topology.plan(names, "flat"),
                              {root: host(mine), other: host(theirs)})
        got = tree_util.tree_flatten(host(agg))[0]
        mismatched = mismatches(got, tree_util.tree_flatten(want)[0])
        # Leaf by leaf, so the device holds one leaf's folds at a time.
        three = [f"p{i}" for i in range(3)]
        plan3 = topology.plan(three, "flat")
        spec = tree_util.tree_flatten(mine)[1]
        mismatched3 = elements3 = 0
        for leaves in zip(tree_util.tree_flatten(mine)[0],
                          tree_util.leaves_like(theirs, spec),
                          tree_util.leaves_like(agg, spec)):
            for dtype in (torch.float32, torch.bfloat16):
                on_dev = dict(zip(three, (x.to(dtype) for x in leaves)))
                on_cpu = {p: x.cpu() for p, x in on_dev.items()}
                for w in (None, dict(zip(three, W3))):
                    mismatched3 += mismatches(
                        [reduce_by_plan(plan3, on_dev, w).cpu()],
                        [reduce_by_plan(plan3, on_cpu, w)])
                    elements3 += leaves[0].numel()
        return dict(
            started=started, mismatched=mismatched,
            elements=sum(x.numel() for x in got),
            mismatched3=mismatched3, elements3=elements3,
            landed=sorted({str(x.device)
                           for x in tree_util.tree_flatten(theirs)[0]}),
            folded_on=sorted({str(x.device)
                              for x in tree_util.tree_flatten(agg)[0]}))

    @fed.remote
    def report():
        return dict(
            launches={k: n - eval_launches[k] for k, n in fa.LAUNCHES.items()},
            eval_launches=dict(eval_launches),
            max_memory_allocated=(torch.cuda.max_memory_allocated()
                                  if on_cuda else None),
            io_path=sockio.io_path(), spans=_push_spans())

    workers = {n: example.LmWorker.party(n).remote(
        seed, cfg, batch=batch, seq=seq, local_steps=local_steps, lr=lr,
        device=None if on_cuda else "cpu") for n, seed in PARTIES}
    evals = [fed.get(evaluate.party(root).remote(None))]
    checks, starts, last = [], [time.time()], {}

    def on_round(r, locals_, global_params):
        checks.append(fed.get(check_round.party(root).remote(
            locals_[root], locals_[other], global_params)))
        last["aggregate"] = global_params
        starts.append(time.time())

    final = example.run(party, workers, rounds=rounds, on_round=on_round)
    evals.append(fed.get(evaluate.party(root).remote(last["aggregate"])))
    received = fed.get([workers[n].received_devices.remote() for n in names])
    reports = fed.get([report.party(n).remote() for n in names])
    digest = _tree_digest(final)
    fed.shutdown()
    # A round: from its first submit to its aggregate ready at the root
    # (the check task starts then), the checks left out.
    walls = [c["started"] - t for c, t in zip(checks, starts)]
    return dict(party=party, party_device=str(party_dev), evals=evals,
                checks=checks, round_walls=walls, digest=digest,
                received=dict(zip(names, received)),
                reports=dict(zip(names, reports)))


def _cnn_program(party, addresses, device, rounds):
    """Phase 6's CNN program: ``rayfed_tpu_torch/examples/fedavg_cnn.py``
    (wmean over the 640/384 shards) for ``rounds`` rounds."""
    import torch

    from rayfed_tpu_torch.examples import fedavg_cnn

    on_cuda = torch.device(device).type == "cuda"
    out = fedavg_cnn.run(party, addresses, rounds=rounds,
                         device=None if on_cuda else "cpu",
                         transport="cuda" if on_cuda else "tcp",
                         comm=FED_COMM)
    return dict(digest=out["digest"], loss=out["loss"])


def pushes(reports):
    """Each push of a tensor tree, from both parties' spans: the sender's
    host staging (``stage``) and socket send, the receiver's decode and,
    on the CUDA lane, the placement on its card inside the decode. The
    total runs from the staging's start (the pushed value resolved) to
    the receiver's placement's end (its decode's on the TCP lane)."""
    spans = {}
    for party, rep in reports.items():
        for kind, up, down, start, dur, nbytes in rep["spans"]:
            spans.setdefault((up, down), {})[kind] = (party, start, dur,
                                                      nbytes)
    out = []
    for key, got in spans.items():
        if "stage" not in got or "decode" not in got or got["stage"][3] == 0:
            continue
        sender, t0 = got["stage"][:2]
        receiver, start, dur, nbytes = got.get("place", got["decode"])
        out.append(dict(
            src=sender, dst=receiver, nbytes=nbytes, t0=t0,
            total_ms=1e3 * (start + dur - t0),
            **{f"{k}_ms": 1e3 * got[k][2] if k in got else None
               for k in PUSH_KINDS}))
    return sorted(out, key=lambda p: p["t0"])


def phase_programs(device, cfg, *, batch, seq, rounds=PROGRAM_ROUNDS,
                   local_steps=2, lr=1e-3, label="",
                   timeout_s=FED_JOIN_TIMEOUT_S):
    """Phase 6: the JAX package's FedAvg programs on the port, each in
    two spawned party processes: the transformer program (``fed_aggregate``
    mean) at ``cfg``'s width, checked: (a) every received tree is on the
    receiving party's device in the consuming task, (b) the root's
    aggregate on its device is bitwise the CPU fold of the two pushed
    trees, (c) both parties' ``fed.get`` of the final aggregate hash the
    same, (d) the aggregate's loss falls, (e) each party's steps launched
    every bf16 kernel, (f) both parties ran the native IO path; then the
    CNN program (``FedAvgTrainer``, wmean), whose two digests must agree.
    Returns the transformer program's results."""
    import dataclasses

    import torch

    on_cuda = torch.device(device).type == "cuda"
    root, other = (n for n, _ in PARTIES)
    results, wall = spawn_parties(
        _lm_program, (device, dataclasses.asdict(cfg), batch, seq, rounds,
                      local_steps, lr), timeout_s)
    res = results[root]
    require(all(results[other][k] == res[k]
                for k in ("evals", "checks", "received", "reports")),
            "the parties disagree on values both fetched through fed.get")
    devices = {n: results[n]["party_device"] for n in results}
    for r, chk in enumerate(res["checks"]):
        require(chk["landed"] == [devices[root]],
                f"(a) round {r}: {other}'s tree reached the root's task on "
                f"{chk['landed']}, not {devices[root]}")
        require(chk["folded_on"] == [devices[root]] and chk["mismatched"] == 0,
                f"(b) round {r}: the aggregate on {chk['folded_on']} differs "
                f"from the CPU fold in {chk['mismatched']} of "
                f"{chk['elements']} elements")
        require(chk["mismatched3"] == 0,
                f"(b) round {r}: the three-party folds on "
                f"{chk['folded_on']} differ from the CPU's in "
                f"{chk['mismatched3']} of {chk['elements3']} elements")
    require(res["received"][other] == [devices[other]],
            f"(a) {other}'s worker got the global tree on "
            f"{res['received'][other]}, not {devices[other]}")
    require(results[other]["digest"] == res["digest"],
            "(c) the parties' final aggregates hash differently")
    require(res["evals"][-1] < res["evals"][0],
            f"(d) the aggregate's loss did not fall: {res['evals']}")
    if on_cuda:
        for n, rep in res["reports"].items():
            require(all(rep["launches"][k] > 0 for k in BF16_KERNELS),
                    f"(e) party {n}'s train steps did not launch every "
                    f"kernel: {rep['launches']}")
    paths = {n: rep["io_path"] for n, rep in res["reports"].items()}
    require(set(paths.values()) == {"native"},
            f"(f) the parties ran IO paths {paths}, not the native one")
    cnn, cnn_wall = spawn_parties(_cnn_program, (device, rounds), timeout_s)
    require(cnn[root]["digest"] == cnn[other]["digest"],
            "the CNN program's parties hold different final aggregates")

    def ms(v):
        return "not measured" if v is None else f"{v:.1f} ms"

    push_list = pushes(res["reports"])
    print(f"[programs] {label} federated_transformer: two party processes "
          f"({devices}, IO path {paths}), {rounds} rounds in {wall:.1f} s "
          f"from spawn to exit; round walls "
          + ", ".join(f"{w:.2f} s" for w in res["round_walls"]))
    print(f"[programs] {label} aggregate eval loss {res['evals']}; fold "
          f"bitwise each round ({res['checks'][0]['elements']} elements; "
          f"three-party folds {res['checks'][0]['elements3']} elements); "
          f"final digests equal")
    for p in push_list:
        place = p["place_ms"]
        print(f"[programs] {label} push {p['src']} -> {p['dst']} "
              f"{p['nbytes']} B: {p['total_ms']:.1f} ms, "
              f"{p['nbytes'] / p['total_ms'] / 1e6:.3f} GB/s; host staging "
              f"{ms(p['stage_ms'])}, send {ms(p['send_ms'])}, decode "
              f"{ms(p['decode_ms'])}, of which placement on the card "
              f"{ms(place)}")
    for n, rep in res["reports"].items():
        print(f"[programs] {label} party {n}: train launches "
              f"{rep['launches']}, evaluations {rep['eval_launches']}, "
              f"max_memory_allocated {rep['max_memory_allocated']}")
    print(f"[programs] {label} fedavg_cnn: {rounds} rounds (wmean) in "
          f"{cnn_wall:.1f} s from spawn to exit, digests equal, local "
          f"losses {cnn[root]['loss']:.4f} / {cnn[other]['loss']:.4f}")
    return dict(results=results, pushes=push_list, wall_s=wall,
                cnn_wall_s=cnn_wall)


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
    for kern_name in BF16_KERNELS:
        require(summary["launches"][kern_name] > 0,
                f"{kern_name} was not launched by the train steps: "
                f"{summary['launches']}")

    # Phase 4b, then phase 5 (two party processes on the same card): the
    # last phase's tensors are gone, and the allocator hands its cache
    # back first.
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print("[f32] reduced " + json.dumps(reduced))
    f32 = phase_f32("cuda", cfg, batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                    label=f"on {smi}:")
    for kern_name in F32_KERNELS:
        require(f32["launches"][kern_name] > 0,
                f"{kern_name} was not launched by the f32 steps: "
                f"{f32['launches']}")
    launches = {n: summary["launches"][n] for n in BF16_KERNELS}
    launches.update({n: f32["launches"][n] for n in F32_KERNELS})
    gc.collect()
    torch.cuda.empty_cache()
    print("[fed] reduced " + json.dumps(reduced))
    fed = {io: phase_fed("cuda", cfg, batch=FLAGSHIP["batch"],
                         seq=FLAGSHIP["seq"], label=f"on {smi} ({io} IO):",
                         io_path=io)
           for io in ("native", "python")}
    compare_io_paths(fed)
    print("[programs] reduced " + json.dumps(reduced))
    phase_programs("cuda", cfg, batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                   label=f"on {smi}:")

    line = []
    for k in KERNELS:
        r = kern[k["name"]]
        line.append(dict(k, launches=launches[k["name"]],
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
