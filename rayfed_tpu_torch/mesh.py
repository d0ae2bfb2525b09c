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

"""The party's device: the port's counterpart of ``rayfed_tpu/mesh.py``'s
party mesh (``init_party_mesh`` / ``get_party_mesh`` /
``clear_party_mesh``).

``fed.init`` binds the party to one CUDA device when the job asks for
``transport="cuda"`` or gives ``config["party_mesh"]``; the CUDA lane
(``proxy/cuda``) places received tensors on it. A party spanning several
devices — a mesh with a data or model axis — comes with the sharded train
step (ROADMAP Queue 1 item 8) and is refused until then.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch

from rayfed_tpu_torch.config import PartyMeshConfig
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

_MULTI_DEVICE = (
    "a party mesh over more than one device comes with the sharded train "
    "step, ROADMAP Queue 1 item 8; rayfed_tpu_torch binds a party to one "
    "card"
)

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
