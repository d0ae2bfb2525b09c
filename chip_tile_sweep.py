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

"""Times K1, K2 and K3, bf16 and f32, under other tilings against each
other, on one card:

    python3 chip_tile_sweep.py base kFwdN=64 kDqWG=1 kDkvWG=1,kDkvM=32 base
    python3 chip_tile_sweep.py base kDqF32W=4,kDqF32N=64 base
    python3 chip_tile_sweep.py base kFwdF32N=64 kFwdF32W=4,kFwdF32N=64 base
    python3 chip_tile_sweep.py base kFwd256N=64 kFwd256PingPong=0 base
    python3 chip_tile_sweep.py base kFwdF32W256=4,kFwdF32C256=2 base
    python3 chip_tile_sweep.py mma

Each argument sets tile constants (``TILE_CONSTANTS``; comma-separated
``name=value``) of ``rayfed_tpu_torch/csrc/flash_attention.cu`` (bf16),
of ``flash_attention_d256.cu`` for the warp-specialised bf16 K1 and K3
at D=256 (``D256_TILE_CONSTANTS``: K1's keys a ring stage, its ring
stages and ping-pong on or off; K3's ring stages) or, for the f32 K1-K3
(``F32_TILE_CONSTANTS``: row groups a block, rows a ring stage and, for
K1 at D=256, warps a row group), ``flash_attention_f32.cu``; or is
``base``, the sources as committed (the warp-specialised f32 K2 and K3
at D=256 in ``flash_attention_f32_d256.cu`` have no constant to sweep).
The constants with 256 in their names are the D=256 plans'. Per
argument, in that order, it copies the port into
``build/tile_sweep/<i>/``, sets the constants, and in a fresh process
builds the copy, prints each kernel's resources at the flagship head dim
and at D=256, holds the kernels of both dtypes to ``chip_smoke.py``'s
limits at the main-path shape and the D=256 ones at phase 12's
(``WIDE``; the f32 ones with the exact-f32 reading), and times the
twelve kernels there (CUDA events, 20 launches after 2 warm-ups,
twice). Put ``base`` first and last to read the spread.

The argument ``mma`` times instead the product the exact-f32 kernels
are made of, ``mma.sync.m16n8k8`` TF32 into f32 (``csrc/tf32.cuh``),
alone: a kernel of nothing but such products from registers, into 1, 2,
4 or 8 independent accumulators a warp, 4, 8 or 16 warps a block, a
block an SM. Its highest rate is the ceiling of every kernel built on
these products; an exact-f32 product is three of them.

The first line names the card and its power limit; the last is the card
and every argument's results as JSON.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import ctypes

import chip_fault_check as fc

ROOT = os.path.join(fc.REPO, "build", "tile_sweep")
F32_TILE_CONSTANTS = ("kFwdF32W", "kFwdF32N", "kDqF32W", "kDqF32N",
                      "kDkvF32W", "kDkvF32N", "kFwdF32W256", "kFwdF32N256",
                      "kFwdF32C256")
D256_TILE_CONSTANTS = ("kFwd256N", "kFwd256Stages", "kFwd256PingPong",
                       "kDkv256Stages")
TILE_CONSTANTS = ("kFwdWG", "kFwdN", "kDqWG", "kDqN", "kDkvWG",
                  "kDkvM", "kDqWG256", "kDqN256") + D256_TILE_CONSTANTS \
    + F32_TILE_CONSTANTS

RUN = """
import json, chip_smoke as cs
from rayfed_tpu_torch.ops import _native, flash_attention as fa
f, w = cs.FLAGSHIP, cs.WIDE
d = f["d_model"] // f["n_heads"]
with open(_native.build() + ".log") as log:
    text = log.read()
res = cs.kernel_resources(text, d)
res.update({n + "<256>": r for n, r in cs.kernel_resources(
    text, cs.WIDE_HEAD_DIM).items()})
readings, ms = {}, {}
for dtype, sfx, s in (("bfloat16", "", f), ("bfloat16", "_d256", w),
                      ("float32", "_f32", f), ("float32", "_f32_d256", w)):
    got, _, (q, k, v, do, o, lse, delta, _, _) = cs.kernel_errors(
        "cuda", s["batch"], s["seq"], s["seq"], s["n_heads"],
        s["d_model"] // s["n_heads"], 0,
        dtype=dtype, exact_f32=dtype == "float32")
    readings.update(got)
    fns = {
        "flash_fwd": lambda: fa._flash_fwd_cuda(q, k, v, 0),
        "flash_bwd_dq": lambda: fa._flash_bwd_dq_cuda(q, k, v, o, lse, do, 0),
        "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_cuda(q, k, v, do, lse,
                                                        delta, 0),
    }
    for name, fn in fns.items():
        ms[name + sfx] = [cs.cuda_ms(fn, 20) for _ in range(2)]
    del q, k, v, do, o, lse, delta, fns
bad = [n for n, (r, lim) in readings.items() if not r <= lim]
print(json.dumps(dict(resources=res, readings=readings, over_limit=bad, ms=ms)))
"""


MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int C>
__global__ void mma_rate(float* out, int iters) {
  const uint32_t x = threadIdx.x;
  const uint32_t a[4] = {x, x + 1, x + 2, x + 3}, b[2] = {x + 4, x + 5};
  float d[C][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int rf_mma_rate(int chains, int blocks, int threads, int iters,
                           float* out, void* stream) {
  const void* fn = chains == 1 ? (const void*)mma_rate<1>
                 : chains == 2 ? (const void*)mma_rate<2>
                 : chains == 4 ? (const void*)mma_rate<4>
                 : (const void*)mma_rate<8>;
  void* args[] = {(void*)&out, (void*)&iters};
  int err = (int)cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, 0,
                                  (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}
"""
MMA_CHAINS = (1, 2, 4, 8)
MMA_WARPS = (4, 8, 16)
MMA_ITERS = 4096


def mma_tflops(chains, warps, blocks, iters, seconds):
    """TF32 TFLOP/s of ``blocks`` blocks of ``warps`` warps each issuing
    ``iters`` x ``chains`` products of 2 x 16 x 8 x 8 operations."""
    return blocks * warps * iters * chains * 2 * 16 * 8 * 8 / seconds / 1e12


def mma_rates(torch):
    """Build ``MMA_SOURCE`` into ``build/tile_sweep/mma/`` and time it
    (CUDA events, 5 launches after one) at each of ``MMA_WARPS`` x
    ``MMA_CHAINS``: {"tflops": {setting: rate}, "ceiling": highest}."""
    build = os.path.join(ROOT, "mma")
    os.makedirs(build, exist_ok=True)
    src, lib = (os.path.join(build, n) for n in ("mma_rate.cu",
                                                 "libmma_rate.so"))
    with open(src, "w") as f:
        f.write(MMA_SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True)
    fn = ctypes.CDLL(lib).rf_mma_rate
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    stream = torch.cuda.current_stream().cuda_stream
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for warps in MMA_WARPS:
        out = torch.empty(blocks * 32 * warps, device="cuda")
        for chains in MMA_CHAINS:
            def run():
                code = fn(chains, blocks, 32 * warps, MMA_ITERS,
                          out.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"mma_rate launch failed: {code}")
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            end.synchronize()
            rates[f"{warps} warps x {chains} chains"] = mma_tflops(
                chains, warps, blocks, MMA_ITERS,
                start.elapsed_time(end) / 5 / 1e3)
    return dict(tflops=rates, ceiling=max(rates.values()))


def parse_setting(arg):
    """``"base"`` -> {}; ``"kFwdN=64,kDkvM=32"`` -> {"kFwdN": 64, ...}."""
    if arg == "base":
        return {}
    out = {}
    for item in arg.split(","):
        name, _, value = item.partition("=")
        if name not in TILE_CONSTANTS or not value.isdigit():
            raise ValueError(f"not a tile setting: {item!r} (constants "
                             f"{TILE_CONSTANTS}, integer values)")
        out[name] = int(value)
    return out


def source_of(name):
    """The kernel source that defines tile constant ``name``."""
    if name in F32_TILE_CONSTANTS:
        return "flash_attention_f32.cu"
    if name in D256_TILE_CONSTANTS:
        return "flash_attention_d256.cu"
    return "flash_attention.cu"


def tiled_source(text, setting):
    """``text`` with each constant of ``setting`` set; raises ValueError
    unless each is defined exactly once."""
    for name, value in setting.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} defined {n} times, not once")
    return text


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep times the kernels on a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    settings = [a if a == "mma" else parse_setting(a)
                for a in sys.argv[1:]] or [{}]
    results = []
    for i, setting in enumerate(settings):
        if setting == "mma":
            out = mma_rates(torch)
            print(f"mma: TF32 TFLOP/s {out['tflops']}; ceiling "
                  f"{out['ceiling']}", flush=True)
            results.append(dict(setting="mma", **out))
            continue
        root = os.path.join(ROOT, str(i))
        fc.copy_port(root, lambda name, text: tiled_source(
            text, {c: n for c, n in setting.items() if source_of(c) == name}))
        out = json.loads(fc.run_code(root, RUN).strip().splitlines()[-1])
        print(f"{setting or 'base'}: ms " + ", ".join(
            f"{n} {t}" for n, t in out["ms"].items())
            + f"; over limit {out['over_limit']}; {out['resources']}",
            flush=True)
        results.append(dict(setting=setting, **out))
    shutil.rmtree(ROOT, ignore_errors=True)
    print(json.dumps(dict(card=card, results=results)))
    sys.exit(0 if all(not r.get("over_limit") for r in results) else 1)


if __name__ == "__main__":
    main()
