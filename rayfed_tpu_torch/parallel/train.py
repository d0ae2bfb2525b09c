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

"""A party's local train step on one device (port of
``rayfed_tpu/parallel/train.py``).

``make_fed_train_step`` builds ``(init_fn, step_fn)`` with the reference's
meaning: ``init_fn`` makes params and optimizer state, ``step_fn`` takes one
AdamW step over a pre-shifted (B, S) batch. Federated averaging across
parties happens between rounds over whole parameter trees
(``ops/aggregate.tree_mean``). The reference's mesh-sharded variants —
sequence parallel, model-axis (tensor) sharding and ZeRO-1 optimizer state
— come with later slices and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.utils import DeviceLike, is_cuda_backend, resolve_device

_SHARDED_LATER = (
    "is ported with the sequence/tensor-parallel slices (ROADMAP.md "
    "Queue 1); the port's train step runs on one device"
)


def make_optimizer(params, lr: float = 3e-4, weight_decay: float = 0.01):
    """AdamW over every leaf of ``params`` with the reference's
    hyperparameters (``optax.adamw(lr, b1=0.9, b2=0.95,
    weight_decay=...)``: the same decoupled decay, on every leaf)."""
    leaves, _ = tree_util.tree_flatten(params)
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def _copy_state(params, opt: torch.optim.Optimizer):
    """Fresh leaves and a fresh optimizer with cloned moments, for a step
    that must leave its inputs untouched (``donate=False``)."""
    new = tree_util.tree_map(
        lambda p: p.detach().clone().requires_grad_(True), params
    )
    group = opt.param_groups[0]
    new_opt = torch.optim.AdamW(
        tree_util.tree_flatten(new)[0], lr=group["lr"], betas=group["betas"],
        eps=group["eps"], weight_decay=group["weight_decay"],
    )
    state = opt.state_dict()
    state["state"] = {
        i: {k: v.clone() for k, v in s.items()}
        for i, s in state["state"].items()
    }
    new_opt.load_state_dict(state)
    return new, new_opt


def make_fed_train_step(
    cfg: tfm.TransformerConfig,
    device: DeviceLike = None,
    *,
    seq_axis: Optional[str] = None,
    model_axis: Optional[str] = None,
    lr: float = 3e-4,
    remat: tfm.Remat = False,
    attn: str = "auto",
    accum_steps: int = 1,
    shard_opt_state: bool = False,
    donate: bool = True,
    loss_chunk: Optional[int] = 512,
):
    """Build ``(init_fn, step_fn)`` on ``device`` (CUDA unless
    ``device="cpu"``).

    ``init_fn(rng, sample_tokens=None) -> (params, opt_state)``: ``rng`` is
    an int seed or a ``torch.Generator`` for fresh params, or a tree of
    numpy arrays (for example the JAX package's params) carried over by
    ``params_from_numpy``. ``opt_state`` is the ``torch.optim.AdamW`` over
    the params' leaves. ``step_fn(params, opt_state, inputs, targets) ->
    (params, opt_state, loss)`` takes one step over pre-shifted (B, S)
    input/target blocks; ``loss`` is a 0-dim f32 tensor on the device.

    ``attn`` selects the attention: ``"flash"`` = the flash kernels
    (O(S) memory, differentiable; the plain versions on the CPU),
    ``"xla"`` = the dense reference attention, ``"auto"`` = flash on CUDA,
    dense elsewhere. ``remat=True`` checkpoints each layer;
    ``remat="attn"`` checkpoints each layer but keeps its attention output,
    so the backward does not run the flash forward again
    (``models.transformer.hidden_states``).
    ``accum_steps > 1`` splits the batch into that many strided
    microbatches (rows ``i::accum_steps``, as the reference) and averages
    their gradients. ``loss_chunk`` positions per checkpointed head+CE
    chunk (None for one pass).

    ``donate=True`` (default) is an in-place update: the step writes the
    new values into the params' and optimizer's own tensors and returns
    the same objects, so a caller that handed those tensors to another
    consumer must copy them first (the reference's donation contract).
    ``donate=False`` leaves the inputs untouched and returns new ones.
    """
    if seq_axis is not None:
        raise NotImplementedError(f"seq_axis (sequence parallel) {_SHARDED_LATER}")
    if model_axis is not None:
        raise NotImplementedError(f"model_axis (tensor sharding) {_SHARDED_LATER}")
    if shard_opt_state:
        raise NotImplementedError(f"shard_opt_state (ZeRO-1) {_SHARDED_LATER}")
    if attn not in ("auto", "flash", "xla"):
        raise ValueError(f"attn must be 'auto', 'flash', or 'xla'; got {attn!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    tfm.check_remat(remat)
    dev = resolve_device(device)
    if attn == "auto":
        attn = "flash" if is_cuda_backend(dev) else "xla"
    if attn == "flash":
        from rayfed_tpu_torch.ops.flash_attention import make_flash_attn_fn

        attn_fn = make_flash_attn_fn()
    else:
        attn_fn = None

    def loss_fn(params, inputs, targets):
        return tfm.lm_loss_pair(params, inputs, targets, cfg, attn_fn,
                                remat=remat, loss_chunk=loss_chunk)

    def grad_step(params, inputs, targets):
        """Loss, with the gradient left in each leaf's ``.grad``."""
        if accum_steps == 1:
            loss = loss_fn(params, inputs, targets)
            loss.backward()
            return loss.detach()
        b = inputs.shape[0]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} not divisible by accum_steps={accum_steps}"
            )
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(accum_steps):
            loss = loss_fn(params, inputs[i::accum_steps],
                           targets[i::accum_steps])
            loss.backward()
            total = total + loss.detach()
        inv = 1.0 / accum_steps
        for p in tree_util.tree_flatten(params)[0]:
            p.grad.mul_(inv)
        return total * inv

    def init_fn(rng, sample_tokens=None):
        if isinstance(rng, dict):
            params = tfm.params_from_numpy(rng, dev)
        else:
            params = tfm.init_params(rng, cfg, dev)
        params = tree_util.tree_map(lambda p: p.requires_grad_(True), params)
        return params, make_optimizer(params, lr)

    def as_tokens(x):
        return torch.as_tensor(x, device=dev).long()

    def step_fn(params, opt_state, inputs, targets):
        if not donate:
            params, opt_state = _copy_state(params, opt_state)
        loss = grad_step(params, as_tokens(inputs), as_tokens(targets))
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return init_fn, step_fn
