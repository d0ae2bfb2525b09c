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

"""Mixture-of-experts FFN on one device (port of the single-device half of
``rayfed_tpu/models/moe.py``).

The dense-gating lane of the JAX package: every expert runs on every
token, scaled by the router's top-1 (or renormalized top-k) gate, so the
computation is static-shaped; a gate of zero keeps an expert's output out
of the sum, so the numerics are switch-style routing's. The expert-mesh
lanes (``make_ep_moe_apply``, ``make_a2a_moe_apply``) raise until the
expert-parallel slice (ROADMAP Queue 1 item 13b).

Where the numerics differ from a line-by-line copy:

- The experts' FFN uses the tanh GELU (``jax.nn.gelu``'s default) with
  each op rounded to the compute dtype as XLA rounds it, constants
  included, which gives the JAX package's bf16 values bit for bit; its
  backward keeps only the GELU's input and computes the derivative in f32
  (:class:`_TanhGelu`), where autodiff would keep every intermediate of
  the formula for each (N, E, f) activation.
- The tokens are not broadcast to (E, N, d): all experts' up-projections
  are one (N, d) x (d, E*f) product that reads the tokens as they are.
- Top-k takes the k largest router probabilities by a stable descending
  sort, so ties go to the lower expert index, as ``lax.top_k`` does
  (``torch.topk`` promises no order among ties; the router logits are
  bf16, so ties occur).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from rayfed_tpu_torch.utils import DeviceLike, resolve_device

Params = Dict[str, Any]

_EXPERT_MESH_LATER = (
    "needs an expert mesh: the expert-parallel MoE lanes are ported with "
    "ROADMAP Queue 1 item 13b; the single-device lane is moe_ffn_apply"
)


def init_moe_ffn(rng, d_model: int, d_ff: int, n_experts: int,
                 dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Router and expert weights with the reference's shapes and scales,
    drawn from ``rng`` (a ``torch.Generator`` or an int seed) on ``device``
    (CUDA unless the caller asks for the CPU). The draws differ from
    ``jax.random``'s; carry the JAX package's weights over through numpy
    to match it exactly."""
    dev = resolve_device(device)
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(device=dev).manual_seed(int(rng))

    def normal(shape, std):
        x = torch.randn(shape, generator=rng, device=rng.device) * std
        return x.to(device=dev, dtype=dtype)

    return {
        "router": normal((d_model, n_experts), 0.02),
        "w_up": normal((n_experts, d_model, d_ff), (2.0 / d_model) ** 0.5),
        "w_down": normal((n_experts, d_ff, d_model), (2.0 / d_ff) ** 0.5),
    }


def _router_probs(params: Params, x):
    """Router probabilities in float32 — the routing numerics, shared by
    every gating variant (top-1, top-k, the aux loss)."""
    logits = x @ params["router"]  # (..., E)
    return torch.softmax(logits.float(), dim=-1)


_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi))
_GELU_CUBIC = 0.044715


class _TanhGelu(torch.autograd.Function):
    """``jax.nn.gelu(x)`` (the tanh form): ``x * 0.5 * (1 + tanh(c * (x +
    0.044715 x^3)))``, each op and constant in ``x``'s dtype as XLA
    evaluates it. The backward saves ``x`` alone."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)

        def const(v):
            # The constant rounded to x's dtype (a Python float, so no copy
            # to the device): XLA rounds weakly typed constants so.
            return torch.tensor(v, dtype=x.dtype).item()

        inner = const(_SQRT_2_OVER_PI) * (x + const(_GELU_CUBIC) * (x * x * x))
        return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        xf = x.float()
        t = torch.tanh(_SQRT_2_OVER_PI * (xf + _GELU_CUBIC * xf * xf * xf))
        deriv = 0.5 * (1.0 + t) + 0.5 * xf * (1.0 - t * t) * _SQRT_2_OVER_PI * (
            1.0 + 3.0 * _GELU_CUBIC * xf * xf)
        return (grad.float() * deriv).to(x.dtype)


def gelu(x):
    return _TanhGelu.apply(x)


def _one_hot(idx, n, dtype):
    return F.one_hot(idx, n).to(dtype)


def _gates(params: Params, x, top1: bool):
    probs = _router_probs(params, x)
    if top1:
        # argmax, not probs == max: a max comparison can select two experts
        # on low-precision ties. torch.argmax returns the first maximal
        # index, as jnp.argmax does.
        probs = probs * _one_hot(torch.argmax(probs, dim=-1),
                                 probs.shape[-1], probs.dtype)
    return probs.to(x.dtype)


def _topk_indices(probs, k: int):
    """Indices of the ``k`` largest entries along the last axis, ties to
    the lower index (``lax.top_k``'s order)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]


def _expert_ffn(w_up, w_down, toks):
    """The per-expert FFN core, the one every lane goes through: toks
    (E, T, d), each expert's own tokens, or (T, d), the same tokens for
    every expert, -> (E, T, d). Shared tokens are read as they lie: all
    experts' up-projections are one (T, d) x (d, E*f) product, with no
    (E, T, d) broadcast; the down-projections are one batched product
    over a strided (E, T, f) view of its output."""
    e, d, f = w_up.shape
    if toks.dim() == 2:
        up = toks @ w_up.permute(1, 0, 2).reshape(d, e * f)   # (T, E*f)
        up = up.view(-1, e, f).transpose(0, 1)                 # (E, T, f)
    else:
        up = torch.bmm(toks, w_up)
    return torch.bmm(gelu(up), w_down)


def _expert_ffn_combine(w_up, w_down, x, gates):
    """Run all experts on all tokens and gate-combine: x (..., d) and
    gates (..., E) -> (..., d)."""
    e, d, _ = w_up.shape
    out = _expert_ffn(w_up, w_down, x.reshape(-1, d))         # (E, N, d)
    flat_gates = gates.reshape(-1, e).t()                     # (E, N)
    combined = (out * flat_gates[..., None]).sum(dim=0)
    return combined.reshape(x.shape)


def moe_ffn_apply(params: Params, x, top1: bool = True):
    """Reference (single-device) forward: x (..., d) -> (..., d)."""
    gates = _gates(params, x, top1)  # (..., E)
    return _expert_ffn_combine(params["w_up"], params["w_down"], x, gates)


def make_ep_moe_apply(mesh=None, expert_axis: str = "expert"):
    """The expert-parallel forward over an ``expert`` mesh axis."""
    raise NotImplementedError(f"make_ep_moe_apply {_EXPERT_MESH_LATER}")


def make_a2a_moe_apply(mesh=None, expert_axis: str = "expert",
                       capacity_factor: float = 1.25, k: int = 1):
    """The capacity-based all-to-all expert dispatch."""
    raise NotImplementedError(f"make_a2a_moe_apply {_EXPERT_MESH_LATER}")


def topk_gates(params: Params, x, k: int = 2):
    """Top-k routing: per token, the k best experts with their softmax
    probabilities renormalized to sum to 1. Returns (..., E) gates."""
    probs = _router_probs(params, x)
    mask = _one_hot(_topk_indices(probs, k), probs.shape[-1],
                    probs.dtype).sum(dim=-2)
    kept = probs * mask
    kept = kept / torch.clamp(kept.sum(dim=-1, keepdim=True), min=1e-9)
    return kept.to(x.dtype)


def load_balance_loss(params: Params, x, k: int = 1):
    """Switch-transformer auxiliary load-balancing loss,
    E * sum_e f_e * P_e: f_e the fraction of the top-k assignments that
    land on expert e, P_e the mean router probability. 1.0 under a uniform
    router; pass the same ``k`` as the gating in use."""
    probs = _router_probs(params, x.reshape(-1, x.shape[-1]))
    n_experts = probs.shape[-1]
    chosen = _one_hot(_topk_indices(probs, k), n_experts,
                      torch.float32).sum(dim=-2)
    f = chosen.mean(dim=0) / k   # fraction of assignments per expert
    p = probs.mean(dim=0)        # mean router probability per expert
    return n_experts * torch.sum(f * p)


def moe_ffn_apply_topk(params: Params, x, k: int = 2):
    """Dense-compute forward with top-k routing (k experts per token)."""
    gates = topk_gates(params, x, k)
    return _expert_ffn_combine(params["w_up"], params["w_down"], x, gates)
