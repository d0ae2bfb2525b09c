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

"""Build and load the port's CUDA kernels (``rayfed_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds). The build runs at first use, never at import, into
``build/rayfed_tpu_torch/`` beside the package, keyed on a hash of the
sources and flags: a changed source rebuilds, an unchanged one loads the
library already there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "rayfed_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # q, k, v, o, lse, dims, scale, stream
    "rf_flash_fwd": [_P, _P, _P, _P, _P, _P, ctypes.c_float, _P],
    # q, k, v, o, dout, lse, dq, delta, dims, scale, stream
    "rf_flash_bwd_dq": [_P] * 9 + [ctypes.c_float, _P],
    # q, k, v, dout, lse, delta, dk, dv, dims, scale, stream
    "rf_flash_bwd_dkv": [_P] * 9 + [ctypes.c_float, _P],
    # kernel (0 = K1, 1 = K2, 2 = K3), head dim, int[4] out
    "rf_kernel_resources": [ctypes.c_int, ctypes.c_int, _P],
}
#: The kernels in the order the C entry ``rf_kernel_resources`` numbers them.
KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's kernels are built "
        "from rayfed_tpu_torch/csrc at first use on a CUDA machine"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librf_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns its path. The compiler's report (registers, shared memory,
    spills) is kept beside it as ``<library>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
        capture_output=True, text=True,
    )
    with open(path + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, path)  # atomic: no loader sees a partial file
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.rf_error_string.argtypes = [ctypes.c_int]
            handle.rf_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def kernel_resources(name: str, head_dim: int) -> dict:
    """What the card gives one kernel instantiation: registers per thread,
    dynamic shared memory, threads per block and resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 4)()
    code = lib().rf_kernel_resources(KERNEL_NAMES.index(name), head_dim,
                                     ctypes.addressof(out))
    check(code, f"resources of {name}<{head_dim}>")
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"),
                    out))


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned an error code."""
    if code != 0:
        msg = lib().rf_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} (code {code})")
