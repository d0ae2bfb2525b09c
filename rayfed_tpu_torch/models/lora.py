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

"""LoRA adapters for the flagship transformer (port of
``rayfed_tpu/models/lora.py``): parameter-efficient federated finetuning.

Parties train low-rank deltas locally and push and aggregate only the
adapter tree, orders of magnitude smaller than the base weights. Adapters
are stacked over layers like the base parameters (one (L, ..., r) leaf per
target, under the JAX package's key paths, so adapter trees of the two
packages aggregate together); merging is one einsum per target, in the
param dtype. ``b`` starts at zero, so step 0 reproduces the base model
exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.utils import DeviceLike, is_cuda_backend, resolve_device

Params = Dict[str, Any]

# target -> (einsum for delta, a-shape builder, b-shape builder); shapes
# carry the stacked leading n_layers dim.
_TARGETS = {
    "wq": ("ldr,lrhk->ldhk", lambda d, h, dh, f, r: ((d, r), (r, h, dh))),
    "wk": ("ldr,lrhk->ldhk", lambda d, h, dh, f, r: ((d, r), (r, h, dh))),
    "wv": ("ldr,lrhk->ldhk", lambda d, h, dh, f, r: ((d, r), (r, h, dh))),
    "wo": ("lhkr,lrd->lhkd", lambda d, h, dh, f, r: ((h, dh, r), (r, d))),
    "w_gate": ("ldr,lrf->ldf", lambda d, h, dh, f, r: ((d, r), (r, f))),
    "w_up": ("ldr,lrf->ldf", lambda d, h, dh, f, r: ((d, r), (r, f))),
    "w_down": ("lfr,lrd->lfd", lambda d, h, dh, f, r: ((f, r), (r, d))),
}

ATTN_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(
    rng,
    cfg: tfm.TransformerConfig,
    rank: int = 8,
    targets: Sequence[str] = ATTN_TARGETS,
    alpha: float | None = None,
    dtype=None,
    device: DeviceLike = None,
) -> Params:
    """A LoRA tree ``{"layers": {target: {"a": ..., "b": ...}}, "alpha",
    "rank"}``: ``a`` is N(0, 1/rank), ``b`` zero, so the initial delta is
    exactly zero. ``alpha`` defaults to ``rank`` (scale 1.0). ``rng`` is a
    ``torch.Generator`` or an int seed; the draws differ from
    ``jax.random``'s (carry the JAX package's adapters over through numpy
    to match it). On ``device``, CUDA unless the caller asks for the
    CPU."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    unknown = set(targets) - set(_TARGETS)
    if unknown:
        raise ValueError(f"unknown LoRA targets: {sorted(unknown)}")
    if cfg.n_experts > 0 and set(targets) & {"w_gate", "w_up", "w_down"}:
        raise ValueError(
            "MoE configs have no dense FFN weights; LoRA targets must be "
            f"attention-only ({ATTN_TARGETS})"
        )
    if alpha is not None and alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    dtype = dtype or cfg.param_dtype
    dev = resolve_device(device)
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(device=dev).manual_seed(int(rng))
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    layers = {}
    for t in targets:
        a_shape, b_shape = _TARGETS[t][1](d, h, dh, f, rank)
        a = torch.randn((cfg.n_layers,) + a_shape, generator=rng,
                        device=rng.device) * (rank**-0.5)
        layers[t] = {
            "a": a.to(device=dev, dtype=dtype),
            "b": torch.zeros((cfg.n_layers,) + b_shape, dtype=dtype,
                             device=dev),
        }
    return {"layers": layers,
            "alpha": float(alpha if alpha is not None else rank),
            "rank": rank}


def merge_lora(params: Params, lora: Params) -> Params:
    """Base params with every adapter folded in:
    ``W' = W + (alpha / rank) * a @ b``, in the base leaf's dtype.
    Gradients through the merge reach only the adapter leaves when only
    they require them; the base tree is shared, untouched, and never
    copied except for the targeted leaves."""
    scale = lora["alpha"] / lora["rank"]
    new_layers = dict(params["layers"])
    for t, ab in lora["layers"].items():
        eq = _TARGETS[t][0]
        w = params["layers"][t]
        delta = torch.einsum(eq, ab["a"], ab["b"]) * scale
        new_layers[t] = w + delta.to(w.dtype)
    out = dict(params)
    out["layers"] = new_layers
    return out


def lora_loss(params: Params, lora: Params, inputs, targets,
              cfg: tfm.TransformerConfig, **kw) -> torch.Tensor:
    """LM loss of the merged model; differentiate with respect to the
    adapters only for parameter-efficient training."""
    return tfm.lm_loss_pair(merge_lora(params, lora), inputs, targets,
                            cfg, **kw)


class LoraOptimizer:
    """The counterpart of the ``optax.adam(lr)`` the reference returns:
    ``init(lora["layers"])`` builds the optimizer state, a
    ``torch.optim.Adam`` at optax's defaults (b1 0.9, b2 0.999, eps 1e-8)
    over its own copies of the adapter leaves."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, layers) -> torch.optim.Adam:
        leaves, spec = tree_util.tree_flatten(layers)
        opt = torch.optim.Adam(
            [x.detach().clone().requires_grad_(True) for x in leaves],
            lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        opt.lora_spec = spec  # the adapter tree's key paths, in its order
        return opt


def make_lora_train_step(cfg: tfm.TransformerConfig, lr: float = 1e-3, *,
                         loss_chunk: Optional[int] = 512):
    """``(step, optimizer)``: ``step(params, lora, opt_state, inputs,
    targets) -> (lora, opt_state, loss)`` takes one Adam step of the
    adapters; the base params are frozen (no gradient, no optimizer
    state). Build the initial state with ``optimizer.init(lora["layers"])``.

    The state holds the adapter tensors it updates: ``step`` first loads
    the values of ``lora["layers"]`` into them, leaf by key path (a new
    tree, for example a received aggregate with the JAX package's sorted
    keys, carries on from the same moments, as an optax state does), and
    returns copies of them after the update as the new
    ``lora["layers"]``, so no tree given or returned changes later, as
    with the reference's functional step. The attention is the train
    step's ``attn="auto"``: the flash kernels on CUDA tensors, the dense
    attention elsewhere. ``loss_chunk`` goes to
    :func:`~rayfed_tpu_torch.models.transformer.lm_loss_pair`, with the
    train step's default."""
    optimizer = LoraOptimizer(lr)

    def step(params, lora, opt_state, inputs, targets):
        live = opt_state.param_groups[0]["params"]
        spec = opt_state.lora_spec
        given = tree_util.leaves_like(lora["layers"], spec)
        with torch.no_grad():
            for p, g in zip(live, given):
                p.copy_(g)
        new = dict(lora)
        new["layers"] = tree_util.tree_unflatten(list(live), spec)
        dev = live[0].device
        attn_fn = None
        if is_cuda_backend(dev):
            from rayfed_tpu_torch.ops.flash_attention import make_flash_attn_fn

            attn_fn = make_flash_attn_fn()
        inputs = torch.as_tensor(inputs, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        loss = lora_loss(params, new, inputs, targets, cfg, attn_fn=attn_fn,
                         loss_chunk=loss_chunk)
        loss.backward()
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        new["layers"] = tree_util.tree_unflatten(
            [p.detach().clone() for p in live], spec)
        return new, opt_state, loss.detach()

    return step, optimizer


def lora_nbytes(lora: Params) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_util.tree_flatten(lora["layers"])[0])
