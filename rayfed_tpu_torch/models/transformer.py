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

"""Decoder-only transformer LM in PyTorch (port of
``rayfed_tpu/models/transformer.py``).

Parameters are a plain dict tree of tensors with the JAX package's key
paths and layouts: layer leaves stay **stacked** along a leading
``(n_layers, ...)`` axis and ``wq`` stays ``(L, d, h, dh)``, so a tree moves
between the packages unchanged (:func:`params_from_numpy`,
:func:`params_to_numpy`) and trees from either side aggregate together.
Compute dtype is configurable (bf16 by default) with params and
softmax/logsumexp accumulation in f32; attention is pluggable through
``attn_fn`` (the flash kernels: ``ops/flash_attention.make_flash_attn_fn``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.ops import flash_attention  # noqa: F401 - registers flash_fwd
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

Params = Dict[str, Any]
Remat = Union[bool, str]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1408  # SwiGLU (or per-expert MoE) hidden width
    rope_theta: float = 10000.0
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # 0 = dense SwiGLU FFN; >0 = top-1 MoE FFN with this many experts
    # (the dense-gating lane of models/moe.py, on one device).
    n_experts: int = 0

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def tiny_config(**overrides) -> TransformerConfig:
    """A config small enough to run in seconds on the CPU."""
    base = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=176)
    base.update(overrides)
    return TransformerConfig(**base)


# ---------------------------------------------------------------------------
# Init and the weight carrier
# ---------------------------------------------------------------------------


def init_params(rng, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    """Random params from ``rng`` (a ``torch.Generator`` or an int seed),
    with the reference's shapes and scales. The draws differ from
    ``jax.random``'s; to match the JAX package exactly, carry its params
    over with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(device=dev).manual_seed(int(rng))
    gen_dev = rng.device
    d, h, dh, f, n = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=rng, device=gen_dev) * std
        return x.to(device=dev, dtype=cfg.param_dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=cfg.param_dtype)

    layers = {
        "ln1": ones((n, d)),
        "wq": normal((n, d, h, dh), d**-0.5),
        "wk": normal((n, d, h, dh), d**-0.5),
        "wv": normal((n, d, h, dh), d**-0.5),
        "wo": normal((n, h, dh, d), (h * dh) ** -0.5),
        "ln2": ones((n, d)),
    }
    if cfg.n_experts > 0:
        from rayfed_tpu_torch.models.moe import init_moe_ffn

        # One expert block per layer, stacked along the leading axis.
        per_layer = [init_moe_ffn(rng, d, f, cfg.n_experts,
                                  dtype=cfg.param_dtype, device=dev)
                     for _ in range(n)]
        layers["moe"] = {name: torch.stack([m[name] for m in per_layer])
                         for name in per_layer[0]}
    else:
        layers.update(
            w_gate=normal((n, d, f), d**-0.5),
            w_up=normal((n, d, f), d**-0.5),
            w_down=normal((n, f, d), f**-0.5),
        )
    return {
        "embed": normal((cfg.vocab, d), 0.02),
        "layers": layers,
        "ln_f": ones((d,)),
        # Untied output head, as in the reference.
        "lm_head": normal((d, cfg.vocab), d**-0.5),
    }


def _leaf_to_tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """A parameter tree of numpy arrays (for example the JAX package's
    params through ``np.asarray``) as the port's tensors, with identical
    key paths, shapes, layouts and dtypes."""
    dev = resolve_device(device)
    return tree_util.tree_map(lambda x: _leaf_to_tensor(x, dev), tree)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as the JAX package uses

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Params):
    """The inverse of :func:`params_from_numpy`: host numpy arrays with the
    same key paths and layouts."""
    return tree_util.tree_map(_leaf_to_numpy, params)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(dtype) * scale.to(dtype)


def rope(q, k, positions, theta: float):
    """Rotary position embedding on (B, S, H, Dh) q/k."""
    dh = q.shape[-1]
    half = dh // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=q.device) / half
    )
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


def causal_attention(q, k, v, q_offset=None):
    """Standard causal attention on (B, S, H, Dh); softmax in f32.

    ``q_offset`` shifts query positions (used by sequence-parallel callers
    where this shard's queries start at a global offset). A ``(B,)``
    tensor gives each batch row its own offset (the serving pool's cached
    decode, where every row sits at its own position); the mask is then
    (B, 1, Sq, Sk).
    """
    sq, sk, dh = q.shape[1], k.shape[1], q.shape[-1]
    scale = dh**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
        q_pos = (q_offset[:, None, None, None]
                 + torch.arange(sq, device=q.device)[:, None])
    else:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (q_offset or 0)
    mask = q_pos >= torch.arange(sk, device=q.device)[None, :]
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


AttnFn = Callable[..., torch.Tensor]


def _proj_heads(h, w, cdt):
    """einsum('bsd,dhk->bshk') as one (B*S, d) x (d, h*k) matmul; the
    result is a contiguous (B, S, h, k) view."""
    b, s, _ = h.shape
    d, nh, dk = w.shape
    return (h @ w.to(cdt).reshape(d, nh * dk)).view(b, s, nh, dk)


def qkv_proj(x, layer: Params, positions, cfg: TransformerConfig):
    """Pre-norm + Q/K/V projections + RoPE for one block."""
    cdt = cfg.compute_dtype
    h = rms_norm(x, layer["ln1"])
    q = _proj_heads(h, layer["wq"], cdt)
    k = _proj_heads(h, layer["wk"], cdt)
    v = _proj_heads(h, layer["wv"], cdt)
    q, k = rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def ffn_apply(hmlp, layer: Params, cfg: TransformerConfig):
    """The block's FFN half on a pre-normed input: SwiGLU, or the top-1 MoE
    FFN (every leaf of ``layer["moe"]`` in the compute dtype) when
    ``cfg.n_experts > 0``."""
    cdt = cfg.compute_dtype
    if cfg.n_experts > 0:
        from rayfed_tpu_torch.models.moe import moe_ffn_apply

        return moe_ffn_apply({name: p.to(cdt)
                              for name, p in layer["moe"].items()}, hmlp)
    pre = hmlp @ layer["w_gate"].to(cdt)
    # jax.nn.silu as XLA lowers it: x * 1 / (1 + exp(-x)), each op rounded
    # to the compute dtype (torch.sigmoid would round once).
    gate = pre * (1 / (1 + torch.exp(-pre)))
    up = hmlp @ layer["w_up"].to(cdt)
    return (gate * up) @ layer["w_down"].to(cdt)


def layer_fn(x, layer: Params, positions, cfg: TransformerConfig,
             attn_fn: Optional[AttnFn] = None):
    """One pre-norm decoder block; ``attn_fn(q, k, v)`` is pluggable."""
    attn_fn = attn_fn or causal_attention
    cdt = cfg.compute_dtype
    b, s, d = x.shape
    q, k, v = qkv_proj(x, layer, positions, cfg)
    o = attn_fn(q, k, v)
    wo = layer["wo"].to(cdt)
    x = x + o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    hmlp = rms_norm(x, layer["ln2"])
    return x + ffn_apply(hmlp, layer, cfg)


@torch.library.custom_op("rayfed_tpu_torch::attn_out", mutates_args=())
def attn_out(o: torch.Tensor) -> torch.Tensor:
    """A copy of an attention output that the ``remat="attn"`` policy can
    name: the reference's ``checkpoint_name(o, "attn_out")``."""
    return o.clone()


attn_out.register_autograd(lambda ctx, grad: grad)


def _named_attention(attn_fn: AttnFn) -> AttnFn:
    def attn(q, k, v):
        return attn_out(attn_fn(q, k, v))

    return attn


def _attn_remat_contexts():
    """The ``remat="attn"`` policy for one layer's checkpoint: keep the
    attention output, recompute everything else. The flash forward's
    outputs (O and its lse) are kept whole, so K1 never runs again in the
    backward, and the ``attn_out`` copy of O is recomputed from them; the
    dense attention has no lse, and its ``attn_out`` copy is kept."""
    flash = [False]

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.rayfed_tpu_torch.flash_fwd.default:
            flash[0] = True
            return CheckpointPolicy.MUST_SAVE
        if op is torch.ops.rayfed_tpu_torch.attn_out.default and not flash[0]:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def check_remat(remat: Remat) -> None:
    if remat not in (True, False, "attn"):
        raise ValueError(f"remat must be True, False or 'attn'; got {remat!r}")


def stacked_layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked layer tree, nested subtrees (``moe``)
    included. A plain dict walk: the serving engine's decode step calls it
    for every layer and is bound by the host."""
    return {name: stacked_layer(leaf, i) if isinstance(leaf, dict)
            else leaf[i] for name, leaf in stacked.items()}


def n_stacked_layers(stacked: Params) -> int:
    leaf = next(iter(stacked.values()))
    return n_stacked_layers(leaf) if isinstance(leaf, dict) else leaf.shape[0]


def hidden_states(params: Params, tokens, cfg: TransformerConfig,
                  attn_fn: Optional[AttnFn] = None,
                  positions=None, remat: Remat = False) -> torch.Tensor:
    """tokens (B, S) int -> final hidden states (B, S, d_model), post
    final-norm, in compute dtype.

    Layers run one by one over the stacked parameters. ``remat=True``
    checkpoints each layer (``torch.utils.checkpoint``, non-reentrant): the
    backward recomputes its activations, device memory for FLOPs.
    ``remat="attn"`` checkpoints each layer too but keeps the attention
    output, under any ``attn_fn``, as the reference's ``attn_out`` name
    does (a selective checkpoint): the backward recomputes the
    projections, norms and FFN. With the flash attention it keeps the
    forward's O and lse and never runs the forward kernel again; the JAX
    package's policy saves ``attn_out`` but not the kernel's lse
    residual, so its backward does run the forward kernel again.
    """
    check_remat(remat)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(cfg.compute_dtype)
    stacked = params["layers"]
    context_fn = noop_context_fn
    if remat == "attn":
        attn_fn = _named_attention(attn_fn or causal_attention)
        context_fn = _attn_remat_contexts
    for i in range(n_stacked_layers(stacked)):
        layer = stacked_layer(stacked, i)
        if remat:
            x = checkpoint(layer_fn, x, layer, positions, cfg, attn_fn,
                           use_reentrant=False, context_fn=context_fn)
        else:
            x = layer_fn(x, layer, positions, cfg, attn_fn)
    return rms_norm(x, params["ln_f"])


def forward(params: Params, tokens, cfg: TransformerConfig,
            attn_fn: Optional[AttnFn] = None,
            positions=None, remat: Remat = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) float32."""
    x = hidden_states(params, tokens, cfg, attn_fn, positions, remat)
    return (x @ params["lm_head"].to(cfg.compute_dtype)).float()


def _ce_sum(x, w, targets):
    logits = (x @ w).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (logz - gold).sum()


def lm_loss_pair(params: Params, inputs, targets, cfg: TransformerConfig,
                 attn_fn: Optional[AttnFn] = None,
                 remat: Remat = False,
                 loss_chunk: Optional[int] = None) -> torch.Tensor:
    """Next-token cross entropy over pre-shifted (inputs, targets) pairs,
    both (B, S). f32 accumulation.

    ``loss_chunk`` evaluates the vocab head + CE in checkpointed chunks of
    that many sequence positions, so the full (B, S, vocab) f32 logits
    never materialize — at 32k vocab they dominate step memory.
    """
    x = hidden_states(params, inputs, cfg, attn_fn, remat=remat)
    w = params["lm_head"].to(cfg.compute_dtype)
    b, s, _ = x.shape
    if not loss_chunk or s % loss_chunk:
        return _ce_sum(x, w, targets) / (b * s)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, loss_chunk):
        total = total + checkpoint(
            _ce_sum, x[:, c:c + loss_chunk], w, targets[:, c:c + loss_chunk],
            use_reentrant=False,
        )
    return total / (b * s)


def lm_loss(params: Params, tokens, cfg: TransformerConfig,
            attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Next-token cross entropy over a (B, S+1) token block."""
    return lm_loss_pair(params, tokens[:, :-1], tokens[:, 1:], cfg, attn_fn)
