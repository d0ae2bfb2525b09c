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

It copies the port into ``build/fault_check/``, plants one fault in each
flash kernel there, bf16 and f32 (K1 and K2 skip the key step holding key
tile SKIP_KT, K3 skips query tile SKIP_QT, both of 64 rows: a
mid-sequence tile dropped for the late rows or the early keys;
``planted_source`` does the patching), builds the copy,
and reads ``chip_smoke.kernel_errors`` for the sound and the faulted
kernels on the same inputs at the main-path shape, in both dtypes.
It exits 0 when every sound reading is within its limit and every output
(O, dq, dk, dv) of every faulted kernel is past it. The last line is the
readings as JSON.
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
# {kernel source: [(anchor in it, line inserted after it, occurrences)]}.
# The bf16 kernels run a copy ring: the skip goes after the barrier at
# which a tile has landed and keeps the barrier that frees its stage, so
# the ring runs on. K1 and K2 skip the key step that holds SKIP_KT (K1
# steps 128 keys, so keys 1024..1151; K2 steps 64, exactly SKIP_KT); K3
# steps 64 query rows, exactly SKIP_QT. The f32 kernels step 64 rows in
# every loop, and each step begins at a barrier, so the skip is a
# ``continue`` once the tile has landed.
FAULTS = {
    "flash_attention.cu": [
        # K1: the key-tile loop, once tile kt is in shared memory.
        ("    __syncthreads();  // key tile kt has landed in stage st\n",
         f"    if (kt == {SKIP_KT} * 64 / C::kN) {{ __syncthreads(); continue; }}\n",
         1),
        # K2: the key-tile loop, once tile kt is in shared memory.
        ("    __syncthreads();  // keys and values of step kt have landed in stage st\n",
         f"    if (kt == {SKIP_KT} * 64 / C::kN) {{ __syncthreads(); continue; }}\n",
         1),
        # K3: the query-tile loop, once tile qt is in shared memory.
        ("    __syncthreads();  // query tile qt has landed in stage st\n",
         f"    if (q0 / 64 == {SKIP_QT}) {{ __syncthreads(); continue; }}\n", 1),
    ],
    "flash_attention_f32.cu": [
        # K1 f32: the key-tile loop.
        ("    __syncthreads();  // key tile kt has landed\n",
         f"    if (kt == {SKIP_KT}) continue;\n", 1),
        # K2 f32: the key-tile loop.
        ("    __syncthreads();  // keys and values of step kt have landed\n",
         f"    if (kt == {SKIP_KT}) continue;\n", 1),
        # K3 f32: the query-tile loop.
        ("    __syncthreads();  // query tile qt has landed\n",
         f"    if (q0 / 64 == {SKIP_QT}) continue;\n", 1),
    ],
}

READ = """
import json, chip_smoke as cs
f = cs.FLAGSHIP
readings = {}
for dtype in ("bfloat16", "float32"):
    readings.update(cs.kernel_errors(
        "cuda", f["batch"], f["seq"], f["seq"], f["n_heads"],
        f["d_model"] // f["n_heads"], 0, dtype=dtype)[0])
print(json.dumps(readings))
"""


def planted_source(name, text):
    """``text`` (the kernel source file ``name``) with every fault of
    ``FAULTS`` for it inserted; raises ValueError when an anchor is not
    found exactly its stated number of times, so a changed kernel cannot
    disarm the check."""
    for anchor, line, count in FAULTS.get(name, ()):
        if text.count(anchor) != count:
            raise ValueError(f"fault anchor found {text.count(anchor)} "
                             f"times, not {count}: {anchor!r}")
        text = text.replace(anchor, anchor + line)
    return text


def copy_port(dest, edit):
    """Copy ``chip_smoke.py`` and the port into ``dest`` (emptied first)
    with each kernel source passed through ``edit(file name, text) ->
    text``."""
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    shutil.copytree(os.path.join(REPO, "rayfed_tpu_torch"),
                    os.path.join(dest, "rayfed_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dest, "rayfed_tpu_torch", "csrc")
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the check runs the kernels on a card")
    copy_port(COPY, planted_source)
    sound, faulted = read(REPO), read(COPY)
    ok = True
    for name, (r, lim) in sound.items():
        fr = faulted[name][0]
        output = name.split()[-1] in ("O", "dq", "dk", "dv")
        good = r <= lim and (fr > lim if output else True)
        ok &= good
        print(f"{name}: sound {r:.4g}, faulted {fr:.4g}, limit {lim:.3g}"
              f"{'' if good else '  WRONG SIDE'}")
    print(json.dumps({"skip_kt": SKIP_KT, "skip_qt": SKIP_QT,
                      "sound": sound, "faulted": faulted}))
    shutil.rmtree(COPY, ignore_errors=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
