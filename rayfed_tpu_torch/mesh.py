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

"""The party's device and device meshes: the port's counterpart of
``rayfed_tpu/mesh.py``'s party mesh (``init_party_mesh`` /
``get_party_mesh`` / ``clear_party_mesh``) and ``build_mesh``.

``fed.init`` binds the party to one CUDA device when the job asks for
``transport="cuda"`` or gives ``config["party_mesh"]``; the CUDA lane
(``proxy/cuda``) places received tensors on it. :func:`build_mesh` makes
a ``torch.distributed`` DeviceMesh with the JAX mesh's axis names, over
which the sharded train step and sharded decoding run. In torch a
DeviceMesh takes one process per device, so a party spanning several
cards is a multi-process party: its processes join a ``torch.distributed``
group of their own (:func:`init_distributed`, the counterpart of the JAX
package's ``jax.distributed`` join), and its party mesh
(:func:`init_party_mesh`) is a DeviceMesh over that group's ranks.
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional

import torch

from rayfed_tpu_torch.config import PartyMeshConfig
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

_ONE_PROCESS_A_DEVICE = (
    "in torch a device mesh takes one process per device: run the party "
    "as several processes (config['jax_distributed'] = {coordinator_address, "
    "num_processes, process_id}), each binding one card"
)

#: Seconds the party group's join and its collectives wait when the job
#: gives no ``cross_silo_comm.recv_timeout_in_ms`` (gloo's own default is
#: 30 minutes).
DEFAULT_PARTY_TIMEOUT_S = 300.0

# This process's party group (see ``party_group``; "owned" when
# init_distributed made it); None outside a multi-process party.
_party_group: Optional[dict] = None


def _store_barrier(store, name: str, rank: int, world: int,
                   timeout_s: float) -> None:
    """Every process of the group reaches ``name`` before any leaves it;
    the store's host (rank 0) leaves last, so no process polls a store
    that is gone."""
    import time

    deadline = time.monotonic() + timeout_s
    for phase in ("arrive", "leave"):
        key = f"{name}/{phase}"
        store.add(key, 1)
        if phase == "leave" and rank != 0:
            return
        while int(store.add(key, 0)) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"party group barrier {name!r}: not every one of "
                    f"{world} processes arrived within {timeout_s} s")
            time.sleep(0.005)


def _device_tag(device: torch.device) -> str:
    import socket

    if device.type != "cuda":
        return "cpu"
    return f"{socket.gethostname()}:cuda:{device.index}"


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, local_device_ids=None, *,
                     device: DeviceLike = None,
                     timeout_s: Optional[float] = None) -> str:
    """Join this party's process group: the counterpart of the JAX
    package's ``init_distributed`` (``jax.distributed.initialize``).
    Every process of the party calls it with the same
    ``coordinator_address`` ("host:port") and ``num_processes`` and its
    own ``process_id`` (0 is the leader, which hosts the group's
    ``TCPStore`` at that address). Cross-party traffic still goes through
    the fed transport; the group is the party's own.

    ``device`` is this process's device; by default its card:
    ``cuda:<local_device_ids[0]>`` or the current card (with no card it
    raises; ``"cpu"`` asks for the CPU). The backend is chosen from the
    processes' devices, exchanged on the store: NCCL when every process
    has a card of its own, gloo when two processes share a card or any
    runs on the CPU (NCCL refuses two ranks on one card). Every wait,
    the join included, ends after ``timeout_s`` (default
    :data:`DEFAULT_PARTY_TIMEOUT_S`). As ``jax.distributed``'s, the group
    outlives the job: ``fed.shutdown`` leaves it up, and a process whose
    group is up already (an earlier ``fed.init`` made it, or the caller
    did) reuses it, if its world size and rank are ``num_processes`` and
    ``process_id`` (else ``ValueError``). A group's ``TCPStore`` cannot be
    closed while anything refers to it (a received tree's mesh does), so
    a group made anew at the same address could not bind it.
    :func:`shutdown_distributed` destroys the group when the process is
    done with the party. Returns the backend."""
    global _party_group
    from datetime import timedelta

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                         process_id):
            raise ValueError(
                f"torch.distributed is already initialized as rank "
                f"{dist.get_rank()} of {dist.get_world_size()}, not as "
                f"process {process_id} of {num_processes}: the party's "
                f"group must span exactly its processes")
        if _party_group is None:
            from torch.distributed import distributed_c10d as c10d

            t = float(timeout_s or DEFAULT_PARTY_TIMEOUT_S)
            _party_group = dict(
                store=dist.PrefixStore("fedtpu", c10d._get_default_store()),
                backend=str(dist.get_backend()), rank=dist.get_rank(),
                world=dist.get_world_size(), owned=False, timeout_s=t,
                bulk=dist.new_group(backend="gloo",
                                    timeout=timedelta(seconds=t)))
        logger.info("torch.distributed already initialized; reusing the "
                    "%s group of %d", _party_group["backend"],
                    _party_group["world"])
        return _party_group["backend"]

    if device is None:
        resolve_device()  # raises when there is no card
        index = (int(local_device_ids[0]) if local_device_ids
                 else torch.cuda.current_device())
        device = torch.device("cuda", index)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout_s = float(timeout_s or DEFAULT_PARTY_TIMEOUT_S)
    timeout = timedelta(seconds=timeout_s)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    store.set(f"fedtpu_party_device/{process_id}", _device_tag(device))
    tags = [store.get(f"fedtpu_party_device/{r}").decode()
            for r in range(num_processes)]
    backend = ("nccl" if "cpu" not in tags and len(set(tags)) == len(tags)
               else "gloo")
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store),
                            rank=process_id, world_size=num_processes,
                            timeout=timeout)
    _party_group = dict(store=store, backend=backend, rank=process_id,
                        world=num_processes, timeout_s=timeout_s, owned=True,
                        bulk=dist.new_group(backend="gloo", timeout=timeout))
    logger.info(
        "Joined party group %s as process %d/%d on %s: backend %s (devices "
        "%s)", coordinator_address, process_id, num_processes, device,
        backend, tags)
    return backend


def party_group() -> Optional[dict]:
    """This process's party group (``store``, ``backend``, ``rank``,
    ``world``, ``timeout_s``; ``bulk``, a gloo group over the same ranks
    that carries the relay's large values point to point, whatever the
    main group's backend), or None outside a multi-process party."""
    return _party_group


def shutdown_distributed() -> None:
    """Destroy the party group :func:`init_distributed` made, when the
    process is done with the party (``fed.shutdown`` leaves the group up
    for a later ``fed.init``; a group the caller made is left as it is):
    every process waits for the others on the store, then the group is
    destroyed."""
    global _party_group
    group = _party_group
    _party_group = None
    if group is None or not group["owned"]:
        return
    import torch.distributed as dist

    try:
        _store_barrier(group["store"], "fedtpu_party_shutdown",
                       group["rank"], group["world"], group["timeout_s"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def build_mesh(device_ids: Optional[List[int]] = None,
               mesh_shape: Optional[List[int]] = None,
               axis_names: Optional[List[str]] = None,
               device_type: str = "cuda"):
    """A ``torch.distributed`` DeviceMesh with named dims, the counterpart
    of the JAX package's ``build_mesh``, over the default process group,
    which the caller has initialized (``init_process_group``, one process
    per device: NCCL for ``"cuda"``, gloo for ``"cpu"``).

    ``device_ids`` are the process-group ranks that form the mesh (default:
    every rank, in order); ``mesh_shape`` defaults to one dim over all of
    them, ``axis_names`` to the JAX package's ``data, model, seq,
    expert``. ``device_type`` is ``"cuda"`` (each rank on its current
    card; with no card it raises) unless ``"cpu"`` is asked. An
    ``expert`` dim of size > 1 raises (ROADMAP Queue 1 item 13b)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first")
    if device_type == "cuda":
        resolve_device("cuda")
    world = dist.get_world_size()
    ranks = list(range(world)) if device_ids is None else list(device_ids)
    n = len(ranks)
    if mesh_shape is None:
        mesh_shape = [n]
    if math.prod(mesh_shape) != n:
        raise ValueError(
            f"mesh_shape {mesh_shape} does not cover {n} devices"
        )
    if axis_names is None:
        default_names = ["data", "model", "seq", "expert"]
        axis_names = default_names[: len(mesh_shape)]
        if len(axis_names) < len(mesh_shape):
            axis_names += [f"ax{i}"
                           for i in range(len(axis_names), len(mesh_shape))]
    names = tuple(axis_names)
    if "expert" in names and mesh_shape[names.index("expert")] > 1:
        raise NotImplementedError(
            "an 'expert' mesh dim of size > 1 (expert parallelism) is "
            "ROADMAP Queue 1 item 13b")
    if ranks == list(range(world)):
        return init_device_mesh(device_type, tuple(mesh_shape),
                                mesh_dim_names=names)
    return DeviceMesh(device_type,
                      torch.tensor(ranks).reshape(tuple(mesh_shape)),
                      mesh_dim_names=names)


# The party's device in this process and, in a multi-process party, its
# mesh over the group's ranks; cleared with the last job.
_party_device: Optional[torch.device] = None
_party_mesh = None


def resolve_party_device(cfg: Optional[PartyMeshConfig] = None, *,
                         num_processes: int = 1,
                         local_device_ids=None) -> torch.device:
    """The device a party's process is bound to, without binding it.

    One process (``num_processes`` 1): no ``party_mesh`` (``cfg`` None),
    the current card; ``device_ids`` with one entry ``i``: ``cuda:i``;
    ``device_ids`` None: every local card, which must then be one. A mesh
    over more than one device raises ``ValueError``: in torch a device
    mesh takes one process per device. In a multi-process party the
    mesh covers the party group's ranks and this process's device is
    ``cuda:<local_device_ids[0]>``, or the current card. Either way
    ``cfg.device_type == "cpu"`` asks for the CPU; otherwise no card
    raises ``RuntimeError`` (nothing falls back to the CPU)."""
    if num_processes == 1 and cfg is not None:
        for what, v in (("mesh_shape", cfg.mesh_shape),
                        ("device_ids", cfg.device_ids)):
            if v is not None and (math.prod(v) if what == "mesh_shape"
                                  else len(v)) != 1:
                raise ValueError(f"party_mesh {what} {list(v)} in one "
                                 f"process: {_ONE_PROCESS_A_DEVICE}")
    if cfg is not None and cfg.device_type == "cpu":
        return torch.device("cpu")
    resolve_device()  # raises when there is no card
    n = torch.cuda.device_count()
    if num_processes > 1:
        i = (int(local_device_ids[0]) if local_device_ids
             else torch.cuda.current_device())
        if not 0 <= i < n:
            raise ValueError(
                f"jax_distributed local_device_ids {list(local_device_ids)}:"
                f" this host has {n} CUDA devices")
        return torch.device("cuda", i)
    if cfg is None:
        return torch.device("cuda", torch.cuda.current_device())
    ids = list(range(n)) if cfg.device_ids is None else list(cfg.device_ids)
    if len(ids) != 1:
        raise ValueError(
            f"party_mesh over all {n} local devices in one process: "
            f"{_ONE_PROCESS_A_DEVICE}"
        )
    if not 0 <= int(ids[0]) < n:
        raise ValueError(
            f"party_mesh device_ids {ids}: this host has {n} CUDA devices"
        )
    return torch.device("cuda", int(ids[0]))


def init_party_device(cfg: Optional[PartyMeshConfig] = None, *,
                      num_processes: int = 1,
                      local_device_ids=None) -> torch.device:
    """Bind this party's process to its device once, at ``fed.init``."""
    global _party_device
    _party_device = resolve_party_device(
        cfg, num_processes=num_processes, local_device_ids=local_device_ids)
    logger.info("Party device established: %s", _party_device)
    return _party_device


def get_party_device() -> Optional[torch.device]:
    return _party_device


def party_device(device: DeviceLike = None) -> torch.device:
    """The device a party's work runs on: ``device`` when given; else the
    device ``fed.init`` bound the party to; else the current card."""
    if device is not None:
        return resolve_device(device)
    return _party_device or resolve_party_device()


def init_party_mesh(cfg: Optional[PartyMeshConfig] = None):
    """This multi-process party's mesh, once, at ``fed.init``: a
    DeviceMesh (:func:`build_mesh`) over the party group's ranks
    (``device_ids``, default all), shaped ``mesh_shape`` with
    ``axis_names``, on the party's device type."""
    global _party_mesh
    # Imported here, on the thread that runs fed.init: the receive threads
    # that place trees on the mesh must not race each other's first import.
    import torch.distributed.tensor  # noqa: F401

    if _party_group is None:
        raise RuntimeError("init_party_mesh needs the party group: call "
                           "init_distributed first")
    cfg = cfg or PartyMeshConfig()
    device = _party_device or resolve_party_device(
        cfg, num_processes=_party_group["world"])
    _party_mesh = build_mesh(cfg.device_ids, cfg.mesh_shape, cfg.axis_names,
                             device_type=device.type)
    logger.info("Party mesh established: %s over %s",
                dict(zip(_party_mesh.mesh_dim_names, _party_mesh.shape)),
                device.type)
    return _party_mesh


def get_party_mesh():
    """The multi-process party's DeviceMesh, or None."""
    return _party_mesh


def place_received(value, mesh=None):
    """A received value with its tensor leaves placed on the party mesh
    (or ``mesh``) by the rules (``parallel/sharding.py``), the counterpart of the JAX
    package's ``place_sharded``: each process takes its own chunk of a
    sharded leaf and a replicated leaf whole, with no communication. A
    leaf the mesh cannot shard evenly is replicated. Without a mesh over
    more than one rank, and for a leaf on another device type than the
    mesh's (the TCP lane's CPU tensors under a card's mesh), nothing
    moves."""
    mesh = mesh or _party_mesh
    if mesh is None or mesh.size() <= 1:
        return value
    from torch.distributed.tensor import DTensor, Replicate

    from rayfed_tpu_torch.parallel import sharding as shd

    replicate = [Replicate()] * mesh.ndim

    def one(path, x):
        if (not isinstance(x, torch.Tensor) or isinstance(x, DTensor)
                or x.device.type != mesh.device_type):
            return x
        try:
            return shd.place(x, mesh, shd._leaf_placements(
                path, x, mesh, shd.TRANSFORMER_RULES))
        except (ValueError, IndexError):
            return shd.place(x, mesh, replicate)

    return shd._map_with_path(one, value)


def clear_party_device() -> None:
    global _party_device, _party_mesh
    _party_device = None
    _party_mesh = None
