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

"""Versioned model snapshots with atomic hot swap (port of
``rayfed_tpu/serving/publish.py``).

The param tree is snapshotted INTO the bank at publish time — a tensor
leaf is cloned onto the bank's device — so a trainer that keeps stepping
the same tensors in place cannot tear a generation that is still
decoding against them. A publish is one reference assignment under the
bank lock: a reader sees the complete old tree or the complete new tree.

In-flight requests pin the version they were admitted under
(refcounted); a retired version's snapshot is dropped only after its last
request finishes, so a swap never aborts or re-bases running decodes.

Zero-copy adoption: a CPU leaf that the wire's decode built over a chunk
of the native shm ring (the decode tags such tensors with the chunk,
``serialization.shm_chunk``) is adopted by reference when the bank lives
on the CPU: the chunk is receiver-owned and released only when the last
reference dies, so holding it is a stable snapshot. A bank on the card
copies every leaf there; that copy is never counted as an adoption.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.utils import DeviceLike, resolve_device


def _shm_backed(x: Any) -> bool:
    """True when a leaf's bytes are a chunk of the native shm ring: a
    tensor the wire's decode tagged with its chunk, or a numpy array whose
    ``.base`` chain bottoms out in a ``_fastwire.ShmBuf``."""
    from rayfed_tpu_torch._private.serialization import shm_buf_type, shm_chunk

    if isinstance(x, torch.Tensor):
        return shm_chunk(x) is not None
    shm_buf = shm_buf_type()
    if shm_buf is None:
        return False
    seen = 0
    base = getattr(x, "base", None)
    while base is not None and seen < 8:
        if isinstance(base, shm_buf):
            return True
        if isinstance(base, memoryview):
            base = base.obj
        else:
            base = getattr(base, "base", None)
        seen += 1
    return isinstance(base, shm_buf)


def snapshot_tree(params: Any, device: DeviceLike = None) -> Tuple[Any, int]:
    """Capture a param tree as tensors on ``device`` (None: the card);
    returns ``(snapshot, zero_copy_leaves)``.

    Tensor leaves are cloned onto ``device`` and numpy leaves copied into
    new tensors there, with one exception on a CPU ``device``: a leaf
    whose storage is a native shm-ring chunk (:func:`_shm_backed`) is
    adopted by reference (a numpy one through ``torch.from_numpy``, which
    shares its memory). The tree structure is preserved leaf for leaf."""
    dev = resolve_device(device)
    adopted = 0

    def leaf(x):
        nonlocal adopted
        if isinstance(x, torch.Tensor):
            if dev.type == "cpu" and x.device.type == "cpu" and _shm_backed(x):
                adopted += 1
                return x
            return x.detach().to(dev, copy=True)
        if isinstance(x, np.ndarray):
            if x.dtype.name == "bfloat16":
                return torch.from_numpy(x.view(np.int16).copy()).view(
                    torch.bfloat16).to(dev)
            if dev.type == "cpu" and x.flags.writeable and _shm_backed(x):
                adopted += 1
                return torch.from_numpy(x)
            return torch.from_numpy(np.array(x, copy=True)).to(dev)
        return x

    leaves, spec = tree_util.tree_flatten(params)
    out = tree_util.tree_unflatten([leaf(x) for x in leaves], spec)
    return out, adopted


class ModelBank:
    """The serving party's versioned snapshot store, on ``device``.

    ``publish`` assigns monotonically increasing versions starting at 1.
    ``acquire``/``release`` bracket a request's use of a version; a
    version with zero in-flight requests that is no longer current is
    retired (its snapshot dropped) so memory stays bounded at
    (current + versions still decoding).
    """

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._current: int = 0
        self._snapshots: Dict[int, Any] = {}
        self._extras: Dict[int, Dict[str, Any]] = {}
        self._refs: Dict[int, int] = {}
        self._swap_log: List[Tuple[int, float]] = []
        self._zerocopy_adopted = 0

    def _snapshot(self, params: Any, extras: Dict[str, Any]):
        snap, adopted = snapshot_tree(params, self.device)
        extra_snap = {}
        for k, v in extras.items():
            if v is None:
                continue
            extra_snap[k], n = snapshot_tree(v, self.device)
            adopted += n
        return snap, extra_snap, adopted

    def publish(self, params: Any, *, copy: bool = True, **extras) -> int:
        """Install ``params`` as the next version; returns its number.

        The snapshot is taken OUTSIDE the lock (it may copy a big tree)
        and the swap itself is a single assignment under it. ``extras``
        (e.g. ``draft_params`` for speculative serving) are snapshotted
        and retired together with the version. ``copy=False`` installs
        the caller's tree as is.
        """
        adopted = 0
        if copy:
            snap, extra_snap, adopted = self._snapshot(params, extras)
        else:
            snap = params
            extra_snap = {k: v for k, v in extras.items() if v is not None}
        with self._lock:
            self._zerocopy_adopted += adopted
            version = self._current + 1
            self._install_locked(version, snap, extra_snap)
        return version

    def _install_locked(self, version: int, snap, extra_snap) -> None:
        self._snapshots[version] = snap
        self._extras[version] = extra_snap
        self._refs.setdefault(version, 0)
        self._current = version
        self._swap_log.append((version, time.perf_counter()))
        self._retire_locked()

    def current_version(self) -> int:
        """0 until the first publish."""
        with self._lock:
            return self._current

    def acquire(self) -> Tuple[int, Any]:
        """Pin the current version for one request; returns (version,
        params). Raises if nothing was ever published."""
        with self._lock:
            if self._current == 0:
                raise RuntimeError(
                    "no model published yet — call publish() (or pass "
                    "params= to fed.serve) before submitting requests"
                )
            self._refs[self._current] += 1
            return self._current, self._snapshots[self._current]

    def get(self, version: int) -> Any:
        with self._lock:
            return self._snapshots[version]

    def get_extra(self, version: int, key: str) -> Optional[Any]:
        with self._lock:
            return self._extras.get(version, {}).get(key)

    def release(self, version: int) -> None:
        with self._lock:
            self._refs[version] -= 1
            if self._refs[version] < 0:
                raise ValueError(f"version {version} over-released")
            self._retire_locked()

    def _retire_locked(self) -> None:
        for v in list(self._snapshots):
            if v != self._current and self._refs.get(v, 0) == 0:
                del self._snapshots[v]
                self._extras.pop(v, None)
                self._refs.pop(v, None)

    def live_versions(self) -> List[int]:
        with self._lock:
            return sorted(self._snapshots)

    def swap_count(self) -> int:
        with self._lock:
            return len(self._swap_log)

    def zerocopy_adopted(self) -> int:
        """Total param-tree leaves this bank adopted by reference from
        the native shm ring instead of copying (publish + restore)."""
        with self._lock:
            return self._zerocopy_adopted

    # -- state handoff ---------------------------------------------------

    def export_state(self) -> Dict[str, Any]:
        """The current version + snapshot (and its extras), for handing
        the serving role to a successor party. In-flight pins and retired
        versions stay behind."""
        with self._lock:
            if self._current == 0:
                return {"version": 0, "params": None, "extras": {}}
            return {
                "version": self._current,
                "params": self._snapshots[self._current],
                "extras": dict(self._extras.get(self._current, {})),
            }

    def restore_state(self, state: Dict[str, Any]) -> int:
        """Adopt an :meth:`export_state` snapshot: install its params and
        CONTINUE its version numbering, so readers that pinned "version
        N" across the handoff observe a monotonically increasing
        sequence. No-op at version 0."""
        version = int(state.get("version") or 0)
        if version <= 0 or state.get("params") is None:
            return self.current_version()
        snap, extra_snap, adopted = self._snapshot(
            state["params"], state.get("extras") or {})
        with self._lock:
            self._zerocopy_adopted += adopted
            if version <= self._current:
                return self._current
            self._install_locked(version, snap, extra_snap)
        return version
