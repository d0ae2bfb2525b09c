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

"""Build and load the port's CUDA kernels (``rayfed_tpu_torch/csrc``), with
the device-DMA lane's CUDA IPC calls (``csrc/dma_ipc.cu``).

``nvcc`` compiles every ``csrc/*.cu`` (one compiler process per source, all
started together) and links them into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds). The build runs at first use, never at import, into
``build/rayfed_tpu_torch/`` beside the package, keyed on a hash of the
sources and flags: a changed source rebuilds, an unchanged one loads the
library already there.
"""

from __future__ import annotations

import ctypes
import functools
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
    # kernel, head dim, int* rows out
    "rf_kernel_rows": [ctypes.c_int, ctypes.c_int, _P],
}
# The f32 kernels (csrc/flash_attention_f32.cu, K2 and K3 at D = 256 in
# csrc/flash_attention_f32_d256.cu) take the same arguments.
_SIGNATURES.update({name + "_f32": argtypes
                    for name, argtypes in list(_SIGNATURES.items())})
# The D = 256 kernels' tile check (csrc/flash_attention_d256.cu): x, dims,
# b, h, row0, rows, out_tma, out_cp, stream.
_SIGNATURES["rf_tma_tile_check"] = [_P, _P] + [ctypes.c_int] * 4 + [_P] * 3
# The device-DMA lane's CUDA IPC calls (csrc/dma_ipc.cu).
_SIGNATURES.update({
    "rf_dma_handle_size": [],
    # device, bytes, void** out
    "rf_dma_alloc": [ctypes.c_int, ctypes.c_ulonglong, _P],
    "rf_dma_free": [ctypes.c_int, _P],
    # pointer, 64-byte handle out
    "rf_dma_ipc_handle": [_P, _P],
    # device, handle, void** out
    "rf_dma_ipc_open": [ctypes.c_int, _P, _P],
    "rf_dma_ipc_close": [ctypes.c_int, _P],
    # dst, src, bytes, stream
    "rf_dma_copy": [_P, _P, ctypes.c_ulonglong, _P],
})
#: The kernels: the bf16 ones in the order the C entry
#: ``rf_kernel_resources`` numbers them, then the f32 ones in the order of
#: ``rf_kernel_resources_f32``.
KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel", "flash_fwd_f32_kernel",
                "flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel")

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
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *(f for f in NVCC_FLAGS if f != "-shared"), "-c", "-o",
             obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [(p, p.communicate()[0]) for p in procs]
    failed = [out for p, out in logs if p.returncode != 0]
    link = None
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(link.stdout + link.stderr)
    with open(path + ".log", "w") as f:
        f.write("".join(out for _, out in logs))
        if link is not None:
            f.write(link.stdout + link.stderr)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
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
    which = KERNEL_NAMES.index(name)
    entry = lib().rf_kernel_resources if which < 3 \
        else lib().rf_kernel_resources_f32
    code = entry(which % 3, head_dim, ctypes.addressof(out))
    check(code, f"resources of {name}<{head_dim}>")
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"),
                    out))


@functools.lru_cache(maxsize=None)
def kernel_rows(name: str, head_dim: int) -> int:
    """Rows of the tiled sequence (Sq for K1 and K2, Sk for K3) one block
    of kernel ``name`` owns at ``head_dim``: its tile plan's, as the
    launch grid counts them."""
    out = ctypes.c_int()
    which = KERNEL_NAMES.index(name)
    entry = lib().rf_kernel_rows if which < 3 else lib().rf_kernel_rows_f32
    check(entry(which % 3, head_dim, ctypes.addressof(out)),
          f"rows of {name}<{head_dim}>")
    return out.value


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned an error code."""
    if code != 0:
        msg = lib().rf_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} (code {code})")
