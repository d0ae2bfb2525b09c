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

"""Small convnet for federated image classification (port of
``rayfed_tpu/models/cnn.py``, CIFAR-10 shapes).

The params keep the JAX package's NHWC/HWIO layout and key paths — conv
kernels ``(3, 3, c_in, c_out)``, the dense layer over the NHWC-flattened
features — so trees of both packages aggregate together. ``cnn_apply``
takes ``(B, H, W, C)`` images like the reference and permutes to
NCHW/OIHW for ``F.conv2d`` (cuDNN on a card; the reference's convolution
is XLA's, not a hand kernel).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from rayfed_tpu_torch.models.mlp import _generator, softmax_xent
from rayfed_tpu_torch.models.transformer import (  # noqa: F401
    params_from_numpy,
    params_to_numpy,
)
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

Params = Dict[str, Any]


def init_cnn(
    rng,
    num_classes: int = 10,
    channels: Sequence[int] = (32, 64),
    input_hw: int = 32,
    in_channels: int = 3,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Params:
    dev = resolve_device(device)
    gen = _generator(rng, dev)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    convs = []
    c_in = in_channels
    for c_out in channels:
        convs.append({
            "w": normal((3, 3, c_in, c_out), (2.0 / (9 * c_in)) ** 0.5),
            "b": torch.zeros((c_out,), dtype=dtype, device=dev),
        })
        c_in = c_out
    # Two 2x2 pools per conv stage halve H/W each time.
    hw = input_hw // (2 ** len(channels))
    flat = hw * hw * c_in
    return {
        "convs": convs,
        "dense": {
            "w": normal((flat, 128), (2.0 / flat) ** 0.5),
            "b": torch.zeros((128,), dtype=dtype, device=dev),
        },
        "head": {
            "w": normal((128, num_classes), 0.1),
            "b": torch.zeros((num_classes,), dtype=dtype, device=dev),
        },
    }


def cnn_apply(params: Params, x) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
    for conv in params["convs"]:
        w = conv["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        x = F.relu(F.conv2d(x, w, conv["b"], padding="same"))
        x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten order
    x = F.relu(x @ params["dense"]["w"] + params["dense"]["b"])
    return x @ params["head"]["w"] + params["head"]["b"]


def cnn_loss(params: Params, x, y) -> torch.Tensor:
    return softmax_xent(cnn_apply(params, x), y)
