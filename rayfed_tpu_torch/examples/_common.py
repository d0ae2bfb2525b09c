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

"""What the example programs share: a plain SGD step over a params tree
(the JAX examples' ``jax.value_and_grad`` and
``tree_map(lambda p, g: p - lr * g)``) and a digest of a tree."""

from __future__ import annotations

import hashlib

import torch

from rayfed_tpu_torch import tree_util


def sgd_step(loss_fn, params, x, y, lr: float):
    """One step ``p - lr * grad`` of ``loss_fn(params, x, y)``; returns the
    new params tree and the loss (detached)."""
    leaves, spec = tree_util.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_util.tree_unflatten(leaves, spec), x, y)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves, grads)]
    return tree_util.tree_unflatten(new, spec), loss.detach()


def digest(tree) -> str:
    """sha256 over every leaf's bytes, in tree order."""
    h = hashlib.sha256()
    for x in tree_util.tree_flatten(tree)[0]:
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        h.update(x.numpy().tobytes())
    return h.hexdigest()
