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
cards is a multi-process party: ROADMAP Queue 1 item 17, refused until
then.
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional

import torch

from rayfed_tpu_torch.config import PartyMeshConfig
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

_MULTI_DEVICE = (
    "a party mesh over more than one device is a multi-process party "
    "(one process per card), ROADMAP Queue 1 item 17; rayfed_tpu_torch "
    "binds a party to one card"
)

def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, local_device_ids=None) -> None:
    """The JAX package's multi-host join (``jax.distributed``): a party
    over several processes is ROADMAP Queue 1 item 17, refused until
    then."""
    raise NotImplementedError(
        "init_distributed (a party over several processes) is ROADMAP "
        "Queue 1 item 17; build a DeviceMesh over a process group of "
        "your own with build_mesh")


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


# The party's card in this process; cleared with the last job.
_party_device: Optional[torch.device] = None


def resolve_party_device(cfg: Optional[PartyMeshConfig] = None) -> torch.device:
    """The one CUDA device a party is bound to, without binding it.

    No ``party_mesh`` (``cfg`` None): the current card. ``device_ids``
    with one entry ``i``: ``cuda:i``; ``device_ids`` None: every local
    card, as the JAX package's mesh takes, which must then be one. More
    than one device, or a ``mesh_shape`` over more than one, raises
    ``NotImplementedError``; no card raises ``RuntimeError`` (nothing
    falls back to the CPU)."""
    if cfg is not None:
        if cfg.mesh_shape is not None and math.prod(cfg.mesh_shape) != 1:
            raise NotImplementedError(
                f"party_mesh mesh_shape {list(cfg.mesh_shape)}: "
                f"{_MULTI_DEVICE}"
            )
        if cfg.device_ids is not None and len(cfg.device_ids) != 1:
            raise NotImplementedError(
                f"party_mesh device_ids {list(cfg.device_ids)}: "
                f"{_MULTI_DEVICE}"
            )
    resolve_device()  # raises when there is no card
    n = torch.cuda.device_count()
    if cfg is None:
        return torch.device("cuda", torch.cuda.current_device())
    ids = list(range(n)) if cfg.device_ids is None else list(cfg.device_ids)
    if len(ids) != 1:
        raise NotImplementedError(
            f"party_mesh over all {n} local devices: {_MULTI_DEVICE}"
        )
    if not 0 <= int(ids[0]) < n:
        raise ValueError(
            f"party_mesh device_ids {ids}: this host has {n} CUDA devices"
        )
    return torch.device("cuda", int(ids[0]))


def init_party_device(cfg: Optional[PartyMeshConfig] = None) -> torch.device:
    """Bind this party to its device once, at ``fed.init`` time."""
    global _party_device
    _party_device = resolve_party_device(cfg)
    logger.info("Party device established: %s", _party_device)
    return _party_device


def get_party_device() -> Optional[torch.device]:
    return _party_device


def party_device(device: DeviceLike = None) -> torch.device:
    """The device a party's work runs on: ``device`` when given; else the
    card ``fed.init`` bound the party to; else the current card."""
    if device is not None:
        return resolve_device(device)
    return _party_device or resolve_party_device()


def clear_party_device() -> None:
    global _party_device
    _party_device = None
