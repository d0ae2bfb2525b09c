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

"""Job-scoped internal key-value store.

Capability parity: the reference stores cluster/job config in Ray's GCS
internal KV under job-scoped keys ``RAYFED#{job_name}#{key}``
(ref ``fed/_private/compatible_utils.py:68-74,106-139``) so proxy actors in
other processes can read them. Our proxies are threads in the party process,
so the default store is an in-process dict with the same prefixed-key
contract and lifecycle (init once per job, ``reset`` on shutdown — behavior
pinned by ``fed/tests/test_internal_kv.py``).

A party spanning several host processes configures the **file backend**
(``fed.init(config={"kv_store": {"backend": "file", "path": ...}})``): keys
live as files in a shared directory, so every host of the party reads the
same cluster/job config, and only the party leader clears it on shutdown.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, Optional

_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (process KV backend; kv_reset() clears it at shutdown)
_initialized_jobs: set = set()  # fedlint: disable=global-mutable-singleton (process KV backend; kv_reset() clears it at shutdown)


class _MemoryBackend:
    def __init__(self) -> None:
        self._store: Dict[str, bytes] = {}

    def put(self, key: str, value: bytes) -> None:
        self._store[key] = value

    def get(self, key: str) -> Optional[bytes]:
        return self._store.get(key)

    def delete(self, key: str) -> None:
        self._store.pop(key, None)

    def clear(self, key_prefix: Optional[str] = None) -> None:
        if key_prefix is None:
            self._store.clear()
            return
        # Scope to one job's keys — several jobs share this process store.
        for key in [k for k in self._store if k.startswith(key_prefix)]:
            self._store.pop(key, None)


class _FileBackend:
    """One file per key in a shared directory; writes are atomic
    (tmp + rename) so concurrent host processes never read torn values.
    File names encode the full (job-prefixed) key so ``clear`` can scope
    itself to one job — several jobs may share the directory."""

    def __init__(self, root: str, clear_on_reset: bool = True) -> None:
        self._root = root
        self._clear_on_reset = clear_on_reset
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        import base64

        name = base64.urlsafe_b64encode(key.encode()).decode()
        if len(name) > 200:  # filesystem name cap; fall back to a digest
            name = hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self._root, name + ".kv")

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def clear(self, key_prefix: Optional[str] = None) -> None:
        if not self._clear_on_reset:
            return  # follower hosts leave the shared store to the leader
        import base64

        try:
            names = os.listdir(self._root)
        except FileNotFoundError:
            return
        for name in names:
            if not name.endswith(".kv"):
                continue
            if key_prefix is not None:
                try:
                    key = base64.urlsafe_b64decode(name[:-3]).decode()
                except Exception:  # noqa: BLE001 - digest-named file
                    key = None
                # Only delete THIS job's keys; other jobs may share the
                # directory. Digest-named (over-long) keys can't be
                # attributed, so they are left behind.
                if key is None or not key.startswith(key_prefix):
                    continue
            try:
                os.remove(os.path.join(self._root, name))
            except FileNotFoundError:
                pass


_backend = _MemoryBackend()  # fedlint: disable=global-mutable-singleton (process KV backend; kv_reset() clears it at shutdown)


def kv_configure(backend: str = "memory", path: Optional[str] = None,
                 clear_on_reset: bool = True) -> None:
    """Select the KV backend (call before/at ``fed.init``)."""
    global _backend
    with _lock:
        if backend == "memory":
            _backend = _MemoryBackend()
        elif backend == "file":
            assert path, "file KV backend needs a path"
            _backend = _FileBackend(path, clear_on_reset=clear_on_reset)
        else:
            raise ValueError(f"unknown kv backend {backend!r}")


def wrap_kv_key(job_name: str, key: str) -> str:
    """``FEDTPU#{job_name}#{key}`` (ref ``compatible_utils.py:68-74``)."""
    from rayfed_tpu_torch._private.constants import KV_NAMESPACE_PREFIX

    return f"{KV_NAMESPACE_PREFIX}#{job_name}#{key}"


def kv_initialize(job_name: str) -> bool:
    with _lock:
        _initialized_jobs.add(job_name)
        return True


def kv_initialized() -> bool:
    return bool(_initialized_jobs)


def kv_put(job_name: str, key: str, value: bytes) -> bool:
    with _lock:
        _backend.put(wrap_kv_key(job_name, key), value)
        return True


def kv_get(job_name: str, key: str) -> Optional[bytes]:
    with _lock:
        return _backend.get(wrap_kv_key(job_name, key))


def kv_delete(job_name: str, key: str) -> bool:
    with _lock:
        _backend.delete(wrap_kv_key(job_name, key))
        return True


def kv_reset() -> None:
    """Clear the current job's keys; revert to the in-process backend
    only once no initialized job remains (ref ``compatible_utils.py:
    179-186``) — rebinding the backend under a live co-tenant would nuke
    its keys."""
    from rayfed_tpu_torch.tenancy.context import current_job

    global _backend
    with _lock:
        job = current_job()
        if job is None and len(_initialized_jobs) == 1:
            job = next(iter(_initialized_jobs))
        if job is not None:
            # Scoped to the resolved job even when it is no longer
            # initialized (idempotent re-run) — falling back to "some
            # other job" here would nuke a live co-tenant's keys.
            _backend.clear(wrap_kv_key(job, ""))
            _initialized_jobs.discard(job)
        else:
            _backend.clear(None)
            _initialized_jobs.clear()
        if not _initialized_jobs:
            _backend = _MemoryBackend()
