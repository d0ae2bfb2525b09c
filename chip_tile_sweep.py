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
    python3 chip_tile_sweep.py base kFwdF32W256=4,kFwdF32C256=2 kDqF32C256=1 base

Each argument sets tile constants (``TILE_CONSTANTS``; comma-separated
``name=value``) of ``rayfed_tpu_torch/csrc/flash_attention.cu`` (bf16),
of ``flash_attention_d256.cu`` for the warp-specialised bf16 K1 and K3
at D=256 (``D256_TILE_CONSTANTS``: K1's keys a ring stage, its ring
stages and ping-pong on or off; K3's ring stages) or, for the f32 K1-K3
(``F32_TILE_CONSTANTS``: row groups a block, rows a ring stage and, at
D=256, warps a row group), ``flash_attention_f32.cu``; or is ``base``,
the sources as committed. The constants with 256 in their names are the
D=256 plans'. Per argument, in that order, it copies the port
into ``build/tile_sweep/<i>/``, sets the constants, and in a fresh
process builds the copy, prints each kernel's resources at the flagship
head dim and at D=256, holds the kernels of both dtypes to
``chip_smoke.py``'s limits at the main-path shape and the D=256 ones at
phase 12's (``WIDE``; the f32 ones with the exact-f32 reading), and
times the twelve kernels there (CUDA events, 20 launches after 2
warm-ups, twice). Put ``base`` first and last to read the spread. The
last line is every setting's readings and times as JSON.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import chip_fault_check as fc

ROOT = os.path.join(fc.REPO, "build", "tile_sweep")
F32_TILE_CONSTANTS = ("kFwdF32W", "kFwdF32N", "kDqF32W", "kDqF32N",
                      "kDkvF32W", "kDkvF32N", "kFwdF32W256", "kFwdF32N256",
                      "kFwdF32C256", "kDqF32W256", "kDqF32N256",
                      "kDqF32C256", "kDkvF32W256", "kDkvF32N256",
                      "kDkvF32C256")
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
    settings = [parse_setting(a) for a in sys.argv[1:]] or [{}]
    results = []
    for i, setting in enumerate(settings):
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
    print(json.dumps(results))
    sys.exit(0 if all(not r["over_limit"] for r in results) else 1)


if __name__ == "__main__":
    main()
