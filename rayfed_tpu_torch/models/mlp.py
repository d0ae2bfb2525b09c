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

"""Logistic regression / MLP models (port of ``rayfed_tpu/models/mlp.py``).

Functional params trees of tensors with the JAX package's key paths,
shapes and layouts (``w`` is ``(d_in, d_out)``), so a tree from either
package loads into the other (``params_from_numpy`` /
``params_to_numpy``) and trees of both aggregate together. The draws of
``init_*`` differ from ``jax.random``'s; to match the JAX package
exactly, carry its params over.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from rayfed_tpu_torch.models.transformer import (  # noqa: F401
    params_from_numpy,
    params_to_numpy,
)
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

Params = Dict[str, Any]


def _generator(rng, device: torch.device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def init_logreg(rng, dim: int, classes: int, dtype=torch.float32,
                device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    gen = _generator(rng, dev)
    return {
        "w": (torch.randn((dim, classes), generator=gen, device=dev)
              * 0.01).to(dtype),
        "b": torch.zeros((classes,), dtype=dtype, device=dev),
    }


def logreg_logits(params: Params, x) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def softmax_xent(logits, labels) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[label]`` over the batch."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
    return (logz - gold).mean()


def logreg_loss(params: Params, x, y) -> torch.Tensor:
    return softmax_xent(logreg_logits(params, x), y)


def init_mlp(rng, sizes: Sequence[int], dtype=torch.float32,
             device: DeviceLike = None) -> Params:
    """MLP with ``len(sizes)-1`` dense layers, GELU between."""
    dev = resolve_device(device)
    gen = _generator(rng, dev)
    layers = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        scale = (2.0 / d_in) ** 0.5
        layers.append({
            "w": (torch.randn((d_in, d_out), generator=gen, device=dev)
                  * scale).to(dtype),
            "b": torch.zeros((d_out,), dtype=dtype, device=dev),
        })
    return {"layers": layers}


def mlp_apply(params: Params, x) -> torch.Tensor:
    *hidden, last = params["layers"]
    for layer in hidden:
        # jax.nn.gelu's default is the tanh approximation.
        x = F.gelu(x @ layer["w"] + layer["b"], approximate="tanh")
    return x @ last["w"] + last["b"]


def mlp_loss(params: Params, x, y) -> torch.Tensor:
    return softmax_xent(mlp_apply(params, x), y)
