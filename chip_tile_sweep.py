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

"""Times K1, K2 and K3 under other tilings against each other, on one card:

    python3 chip_tile_sweep.py base kFwdN=64 kDqWG=1 kDkvWG=1,kDkvM=32 base

Each argument sets tile constants of ``rayfed_tpu_torch/csrc/
flash_attention.cu`` (``TILE_CONSTANTS``; comma-separated ``name=value``),
or is ``base``, the source as committed. Per argument, in that order, it
copies the port into ``build/tile_sweep/<i>/``, sets the constants, and
in a fresh process builds the copy, prints each kernel's resources at the
flagship head dim, holds the kernels to ``chip_smoke.py``'s limits at the
main-path shape and times K1, K2 and K3 there (CUDA events, 20 launches
after 2 warm-ups, twice). Put ``base`` first and last to read the spread. The
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
TILE_CONSTANTS = ("kFwdWG", "kFwdN", "kDqWG", "kDqN", "kDkvWG", "kDkvM")

RUN = """
import json, chip_smoke as cs
from rayfed_tpu_torch.ops import _native, flash_attention as fa
f = cs.FLAGSHIP
d = f["d_model"] // f["n_heads"]
with open(_native.build() + ".log") as log:
    res = cs.kernel_resources(log.read(), d)
readings, _, (q, k, v, do, o, lse, delta, _, _) = cs.kernel_errors(
    "cuda", f["batch"], f["seq"], f["seq"], f["n_heads"], d, 0)
bad = [n for n, (r, lim) in readings.items() if not r <= lim]
ms = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
for _ in range(2):
    ms["flash_fwd"].append(cs.cuda_ms(lambda: fa._flash_fwd_cuda(q, k, v, 0), 20))
    ms["flash_bwd_dq"].append(cs.cuda_ms(
        lambda: fa._flash_bwd_dq_cuda(q, k, v, o, lse, do, 0), 20))
    ms["flash_bwd_dkv"].append(cs.cuda_ms(
        lambda: fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, 0), 20))
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
        fc.copy_port(root, lambda name, text: tiled_source(text, setting)
                     if name == "flash_attention.cu" else text)
        out = json.loads(fc.run_code(root, RUN).strip().splitlines()[-1])
        print(f"{setting or 'base'}: K1 ms {out['ms']['flash_fwd']}, K2 ms "
              f"{out['ms']['flash_bwd_dq']}, K3 ms "
              f"{out['ms']['flash_bwd_dkv']}, over limit {out['over_limit']}; "
              f"{out['resources']}", flush=True)
        results.append(dict(setting=setting, **out))
    shutil.rmtree(ROOT, ignore_errors=True)
    print(json.dumps(results))
    sys.exit(0 if all(not r["over_limit"] for r in results) else 1)


if __name__ == "__main__":
    main()
