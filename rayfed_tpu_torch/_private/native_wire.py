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

"""Build and load the native wire module ``rayfed_tpu_torch._fastwire``.

The source is the port's own copy of the JAX package's native engine
(``csrc/fastwire.cc``, a CPython extension with a plain C++ body: vectored
sends, validated prefix/header receives, pooled scatter receives, the
reactor's batched flush, crc32c and the shm ring). At first use the C++
compiler builds it with the flags of the JAX package's ``setup.py`` entry
into ``build/rayfed_tpu_torch/`` beside the package, keyed on a hash of the
source, the flags and the Python headers: a changed source rebuilds, an
unchanged one loads the module already there. The build holds a file
lock and writes through a temporary file renamed into place, so processes
that start together (test workers, spawned parties) build it once and
never load a partial file.

:func:`load` is the one entry: the wire modules (``proxy/tcp/sockio``,
``proxy/tcp/checksum``, ``proxy/lanes`` and, through ``sockio``, the
reactor) take their module reference from it. It returns None only when
the machine has no C++ compiler; then the wire runs its Python IO path
(``sockio.io_path()`` says which path is live). A build that fails raises
with the compiler's output.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from types import ModuleType
from typing import Optional

MODULE_NAME = "rayfed_tpu_torch._fastwire"
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fastwire.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "rayfed_tpu_torch")
# The flags of the JAX package's setup.py entry, plus what a shared
# extension needs.
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_loaded = False
_module: Optional[ModuleType] = None


def compiler() -> Optional[str]:
    """The C++ compiler on this machine, or None."""
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    return None


def _include_dir() -> str:
    return sysconfig.get_paths()["include"]


def library_path(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Where the module built from ``source`` lives: its name carries a
    hash of the source, the flags and the Python headers' directory."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + [_include_dir()]).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    return os.path.join(build_dir, f"_fastwire_{h.hexdigest()[:16]}{suffix}")


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile ``source`` unless a module for it exists; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    path = library_path(source, build_dir)
    if os.path.exists(path):
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on this machine")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "fastwire.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # built while this process waited
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, f"-I{_include_dir()}", "-o", tmp, source],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"building {source} failed ({proc.returncode}):\n"
                f"{(proc.stdout + proc.stderr)[-4000:]}"
            )
        os.replace(tmp, path)  # atomic: no loader sees a partial file
    return path


def load_from(path: str) -> ModuleType:
    """Import the extension at ``path`` as ``rayfed_tpu_torch._fastwire``
    (its init symbol is ``PyInit__fastwire``) and register it there."""
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, path)
    spec = importlib.util.spec_from_file_location(MODULE_NAME, path,
                                                  loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    sys.modules[MODULE_NAME] = module
    return module


def load() -> Optional[ModuleType]:
    """The native wire module, built on first call; None when the machine
    has no C++ compiler (the wire then runs its Python IO path)."""
    global _loaded, _module
    with _lock:
        if not _loaded:
            if compiler() is not None:
                _module = load_from(build())
            _loaded = True
        return _module
