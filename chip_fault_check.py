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

"""Shows that ``chip_smoke.py``'s kernel-vs-plain limits catch a wrong
kernel, on one card:

    python3 chip_fault_check.py

It copies the port into ``build/fault_check/`` twice, each time with
one kind of planted fault (``planted_source`` does the patching), builds
the copy, and reads ``chip_smoke.kernel_errors`` for the sound and the
faulted kernels on the same inputs at the main-path shape and at phase
12's (``WIDE``, the D = 256 tile plans), in both dtypes, the f32 ones
with the exact-f32 reading:

- "skip", one fault in each flash kernel, bf16 and f32 (each loop of
  ``flash_attention.cu`` and ``flash_attention_f32.cu`` serves both of
  its dtype's tile plans but the warp-specialised kernels at D = 256:
  bf16 K1 and K3, ``flash_attention_d256.cu``'s, and f32 K2 and K3,
  ``flash_attention_f32_d256.cu``'s): K1 and K2 skip the keys of 64-row
  tile SKIP_KT, K3 the queries of 64-row tile SKIP_QT (a mid-sequence
  tile dropped for the late rows or the early keys). Every output (O, dq,
  dk, dv) of every kernel at both head dims must be past its limit.
- "split", one fault in the f32 split helper (``tf32.cuh``): ``lo`` is
  zeroed, so each product of the f32 K1, K2 and K3 is one TF32 product.
  Their exact-f32
  readings (O, lse, dq, dk, dv against a tenth of the TF32 plain
  version's error), at both head dims, must be past their limits; the
  script also prints whether the plain limits alone (2e-5 on O, 1e-4 on
  lse, 3e-4 on the gradients) would have caught it.

It exits 0 when every sound reading is within its limit and every
faulted reading named above is past it. The last line is the readings as
JSON.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(REPO, "build", "fault_check")

SKIP_KT = 16  # keys 1024..1087 at a 64-row tile
SKIP_QT = 24  # queries 1536..1599 at a 64-row tile
# {kernel source: [(anchor in it, line inserted after it, occurrences,
# kind)]}. Every kernel has a copy ring: the skip goes after the barrier
# at which a tile has landed and keeps the barrier that frees its stage,
# so the ring runs on. K1 and K2 skip the key steps within SKIP_KT (bf16
# K1 steps 128 keys, so keys 1024..1151, 64 at D = 256; bf16 K2 steps 64,
# exactly SKIP_KT, 32 at D = 256; f32 K1 and K2 step kN = 32, two steps,
# K1 16 at D = 256, four); K3 the query steps within SKIP_QT. The
# warp-specialised kernels at D = 256 run no block-wide barrier: there
# the fault masks the skipped tile's scores (bf16 K1, every key of the
# tile starting in SKIP_KT's 64 keys), zeroes its P^T (bf16 K3, which
# both of its consumers read) or zeroes its P (f32 K2, keys in SKIP_KT's
# 64; f32 K3, queries in SKIP_QT's 64), which zeroes dS with it. The
# split fault zeroes the low TF32 part of every split value.
FAULTS = {
    "flash_attention.cu": [
        # K1: the key-tile loop, once tile kt is in shared memory.
        ("    __syncthreads();  // key tile kt has landed in stage st\n",
         f"    if (kt == {SKIP_KT} * 64 / C::kN) {{ __syncthreads(); continue; }}\n",
         1, "skip"),
        # K2: the key-tile loop, once tile kt is in shared memory.
        ("    __syncthreads();  // keys and values of step kt have landed in stage st\n",
         f"    if (kt == {SKIP_KT} * 64 / C::kN) {{ __syncthreads(); continue; }}\n",
         1, "skip"),
        # K3: the query-tile loop, once tile qt is in shared memory.
        ("    __syncthreads();  // query tile qt has landed in stage st\n",
         f"    if (q0 / 64 == {SKIP_QT}) {{ __syncthreads(); continue; }}\n",
         1, "skip"),
    ],
    "flash_attention_d256.cu": [
        # K1 at D = 256: the softmax of a key tile, score by score.
        ("      float x = s[4 * i + e] * scale_log2;\n",
         f"      if (k0 / 64 == {SKIP_KT}) x = kNegBig;\n", 1, "skip"),
        # K3 at D = 256: consumer V's P^T, before consumer K reads it.
        ("          x[4 * j + e] = v;\n",
         f"          if (q0 / 64 == {SKIP_QT}) x[4 * j + e] = 0.0f;\n", 1,
         "skip"),
    ],
    "flash_attention_f32.cu": [
        # K1 f32: the key-step loop, once step kt is in its ring stage.
        ("    __syncthreads();  // key step kt has landed in stage st\n",
         f"    if (k0 / 64 == {SKIP_KT}) {{ __syncthreads(); continue; }}\n",
         1, "skip"),
        # K2 f32: the key-step loop, once step kt is in its ring stage.
        ("    __syncthreads();  // keys and values of step kt have landed in stage st\n",
         f"    if (k0 / 64 == {SKIP_KT}) {{ __syncthreads(); continue; }}\n",
         1, "skip"),
        # K3 f32: the query-step loop, once step qt is in its ring stage.
        ("    __syncthreads();  // query tile qt has landed in stage st\n",
         f"    if (q0 / 64 == {SKIP_QT}) {{ __syncthreads(); continue; }}\n",
         1, "skip"),
    ],
    "flash_attention_f32_d256.cu": [
        # K2 f32 at D = 256: P of a key step, score by score.
        ("          float pr = expf(s[j][e] * p.scale - lse[e >> 1]);\n",
         f"          if (k0 / 64 == {SKIP_KT}) pr = 0.f;\n", 1, "skip"),
        # K3 f32 at D = 256: P^T of a query step, score by score.
        ("          float pr = expf(s[j][e] * p.scale - lse[c]);\n",
         f"          if (q0 / 64 == {SKIP_QT}) pr = 0.f;\n", 1, "skip"),
    ],
    "tf32.cuh": [
        # The splits of the f32 kernels (to nearest: K1, and K2 and K3 at D
        # <= 128; hi = x itself: K2 and K3 at D = 256): one TF32 product
        # per f32 product.
        ("  lo = __float_as_uint(x - __uint_as_float(hi));\n", "  lo = 0u;\n",
         1, "split"),
        ("  uint32_t lo = __float_as_uint(x - __uint_as_float(__float_as_uint(x) &\n"
         "                                                    0xffffe000u));\n",
         "  lo = 0u;\n", 1, "split"),
    ],
}
FAULT_KINDS = ("skip", "split")
# The readings the split fault must push past their limits.
SPLIT_CAUGHT_BY = tuple(
    f"{k} f32{tag} {out} exact" for tag in ("", " d256")
    for k, out in (("K1", "O"), ("K1", "lse"), ("K2", "dq"), ("K3", "dk"),
                   ("K3", "dv")))

READ = """
import json, chip_smoke as cs
readings = {}
for s in (cs.FLAGSHIP, cs.WIDE):
    for dtype in ("bfloat16", "float32"):
        readings.update(cs.kernel_errors(
            "cuda", s["batch"], s["seq"], s["seq"], s["n_heads"],
            s["d_model"] // s["n_heads"], 0, dtype=dtype,
            exact_f32=dtype == "float32")[0])
print(json.dumps(readings))
"""


def planted_source(name, text, kind="skip"):
    """``text`` (the kernel source file ``name``) with every fault of
    ``FAULTS`` of ``kind`` for it inserted; raises ValueError when any of
    its anchors is not found exactly its stated number of times, so a
    changed kernel cannot disarm the check."""
    if kind not in FAULT_KINDS:
        raise ValueError(f"no fault kind {kind!r}; kinds {FAULT_KINDS}")
    faults = FAULTS.get(name, ())
    for anchor, _, count, _ in faults:
        if text.count(anchor) != count:
            raise ValueError(f"fault anchor found {text.count(anchor)} "
                             f"times, not {count}: {anchor!r}")
    for anchor, line, _, fault_kind in faults:
        if fault_kind == kind:
            text = text.replace(anchor, anchor + line)
    return text


def copy_port(dest, edit):
    """Copy ``chip_smoke.py`` and the port into ``dest`` (emptied first)
    with each kernel source and header passed through ``edit(file name,
    text) -> text``."""
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    shutil.copytree(os.path.join(REPO, "rayfed_tpu_torch"),
                    os.path.join(dest, "rayfed_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dest, "rayfed_tpu_torch", "csrc")
    for name in sorted(os.listdir(csrc)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, name)) as f:
                text = edit(name, f.read())
            with open(os.path.join(csrc, name), "w") as f:
                f.write(text)


def run_code(root, code):
    """Run ``code`` in a fresh interpreter in ``root``; its stdout."""
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"run in {root} failed:\n{out.stderr[-4000:]}")
    return out.stdout


def read(root):
    return json.loads(run_code(root, READ).strip().splitlines()[-1])


def read_planted(kind):
    copy_port(COPY, lambda name, text: planted_source(name, text, kind))
    return read(COPY)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the check runs the kernels on a card")
    sound = read(REPO)
    faulted, split = read_planted("skip"), read_planted("split")
    ok = True
    for name, (r, lim) in sound.items():
        fr, sr = faulted[name][0], split[name][0]
        output = name.split()[-1] in ("O", "dq", "dk", "dv")
        good = (r <= lim and (fr > lim if output else True)
                and (sr > lim if name in SPLIT_CAUGHT_BY else True))
        ok &= good
        print(f"{name}: sound {r:.4g}, skip-faulted {fr:.4g}, split-faulted "
              f"{sr:.4g}, limit {lim:.3g}{'' if good else '  WRONG SIDE'}")
    for name in SPLIT_CAUGHT_BY:
        plain = name[:-len(" exact")]
        r, lim = split[plain]
        print(f"split fault, {plain}: {r:.4g} against the {lim:.3g} limit "
              f"alone: {'caught' if r > lim else 'NOT caught'}")
    print(json.dumps({"skip_kt": SKIP_KT, "skip_qt": SKIP_QT,
                      "sound": sound, "faulted": faulted, "split": split}))
    shutil.rmtree(COPY, ignore_errors=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
