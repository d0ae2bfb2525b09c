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

"""KV-cache autoregressive decoding for the flagship transformer (port of
``rayfed_tpu/models/decode.py``).

The K/V cache is stacked over layers, ``(n_layers, B, T, H, Dh)``, like
the stacked layer parameters. The JAX package threads it through a
``lax.scan`` carry and updates it with ``dynamic_update_slice`` on
donated buffers; here the layers run in a Python loop and each one writes
its K/V slice **in place** into the cache tensors, so the cache a caller
passes in is the cache it gets back. Prefill and decode share one cached
block (prefill is the S>1 case at offset 0), and the projections and FFN
are :mod:`rayfed_tpu_torch.models.transformer`'s, so the numerics are the
training forward's at equal dtypes.

``offset`` is an int (every row at the same position) or a ``(B,)``
integer tensor (each row at its own position: the serving pool's batched
step, where the JAX package ``vmap``s a one-row forward). Sampling draws
from an explicit ``torch.Generator``; its draws differ from
``jax.random``'s (threefry is not ported), so sampled tokens match the
JAX package's in their properties, not their values. Greedy decoding,
beam search and all logits match it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

Cache = dict

_MESH_LATER = (
    "sharded decoding (mesh=) comes with the sharded train step, ROADMAP "
    "Queue 1 item 8; rayfed_tpu_torch decodes on one device"
)


def check_decodable(cfg: tfm.TransformerConfig, mesh=None) -> None:
    """Raise for what cached decoding does not support yet: a ``mesh``
    (item 8). An MoE config decodes through ``ffn_apply``'s MoE lane."""
    if mesh is not None:
        raise NotImplementedError(_MESH_LATER)


def init_cache(cfg: tfm.TransformerConfig, batch: int, max_len: int,
               dtype=None, device: DeviceLike = None) -> Cache:
    """Zero-filled K/V cache covering ``max_len`` total positions, in the
    compute dtype unless ``dtype`` says otherwise, on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    dtype = dtype or cfg.compute_dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cast_params(params, cfg: tfm.TransformerConfig):
    """``params`` with every floating-point leaf in the compute dtype. The
    forward casts each weight to the compute dtype where it uses it, so a
    cast tree gives the same bits; a caller that runs many forwards on one
    tree (the serving engine) casts it once instead of at every use."""
    from rayfed_tpu_torch import tree_util

    cdt = cfg.compute_dtype
    return tree_util.tree_map(
        lambda x: x.to(cdt) if torch.is_floating_point(x) else x, params)


def forward_with_cache(params, tokens, cache: Cache, offset,
                       cfg: tfm.TransformerConfig):
    """Run ``tokens`` (B, S) starting at global position ``offset`` (S=1
    while decoding, S=prompt length during prefill), reading and updating
    ``cache`` in place. Returns (logits (B, S, vocab) f32, cache).

    ``offset`` is an int, or a ``(B,)`` integer array or tensor giving
    each row its own start; a tensor on the card is read back once for
    the overflow check, so the serving engine passes host arrays. Each
    layer writes only its (B, S, H, Dh) slice. Cache slots past each
    row's ``offset + S`` keep whatever they held; the causal mask
    (q_pos >= k_pos) never attends to them.
    """
    check_decodable(cfg)
    b, s = tokens.shape
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[2]
    dev = ck.device
    # An out-of-range write would land in another position (or raise deep
    # inside indexing): fail loudly here, as the JAX package does.
    if s > max_len:
        raise ValueError(f"token block ({s}) longer than cache ({max_len})")
    if isinstance(offset, torch.Tensor):
        offset = offset.detach().cpu().numpy()
    host = np.asarray(offset, np.int64)
    per_row = host.ndim == 1
    if per_row:
        if host.shape != (b,):
            raise ValueError(
                f"per-row offsets {host.shape} do not match batch {b}")
        top = int(host.max()) + s
        if top > max_len or int(host.min()) < 0:
            raise ValueError(
                f"cache overflow: offsets up to {int(host.max())} + block "
                f"{s} > {max_len}")
        off = torch.from_numpy(host).to(dev)
        positions = off[:, None] + torch.arange(s, device=dev)[None, :]
        rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    else:
        off = int(host)
        if off + s > max_len:
            raise ValueError(
                f"cache overflow: offset {off} + block {s} > {max_len}")
        positions = (off + torch.arange(s, device=dev)).expand(b, s)
    cdt = cfg.compute_dtype
    x = params["embed"][tokens].to(cdt)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        layer = tfm.stacked_layer(stacked, i)
        q, k, v = tfm.qkv_proj(x, layer, positions, cfg)
        if per_row:
            ck[i][rows, positions] = k.to(ck.dtype)
            cv[i][rows, positions] = v.to(cv.dtype)
        else:
            ck[i, :, off:off + s] = k.to(ck.dtype)
            cv[i, :, off:off + s] = v.to(cv.dtype)
        o = tfm.causal_attention(q, ck[i], cv[i], q_offset=off)
        wo = layer["wo"].to(cdt)
        x = x + o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
        hmlp = tfm.rms_norm(x, layer["ln2"])
        x = x + tfm.ffn_apply(hmlp, layer, cfg)
    x = tfm.rms_norm(x, params["ln_f"])
    logits = (x @ params["lm_head"].to(cdt)).float()
    return logits, cache


def prefill(params, prompt, cache: Cache, cfg: tfm.TransformerConfig):
    """Fill the cache from a (B, S) prompt; returns (last-position logits
    (B, vocab), cache)."""
    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg)
    return logits[:, -1], cache


def _as_tokens(prompt, device) -> torch.Tensor:
    if isinstance(prompt, torch.Tensor):
        return prompt.to(device)
    return torch.as_tensor(np.asarray(prompt), device=device)


def _generator(rng, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` from ``rng`` (a generator, an
    int seed, or None for seed 0)."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(
        0 if rng is None else int(rng))


def make_generate_fn(
    cfg: tfm.TransformerConfig,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    mesh=None,
):
    """Build ``generate(params, prompt, rng=None) -> (B, S+max_new)``.

    Greedy when ``temperature == 0`` (rng unused), otherwise softmax
    sampling at the given temperature, optionally truncated to the
    ``top_k`` highest-probability tokens and/or the ``top_p`` nucleus
    (smallest set of tokens whose probability mass reaches ``top_p``),
    drawn from ``rng`` (a ``torch.Generator`` on the prompt's device, or
    an int seed; None is seed 0). With ``eos_id``, a row that emits it
    keeps emitting EOS for the rest of the generation — the output still
    has shape (B, S+max_new), terminated rows are EOS-padded.

    ``mesh`` raises (ROADMAP Queue 1 item 8).
    """
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if top_k is not None and not 1 <= top_k <= cfg.vocab:
        raise ValueError(f"top_k must be in [1, {cfg.vocab}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id must be in [0, {cfg.vocab}), got {eos_id}")
    if temperature <= 0.0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p truncate the sampling distribution; with "
            "temperature<=0 decoding is greedy and they would be silently "
            "ignored — set temperature > 0"
        )
    check_decodable(cfg, mesh)

    def sample(logits, gen):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_k is not None and top_k < cfg.vocab:
            kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
            logits = torch.where(logits < kth, float("-inf"), logits)
        if top_p is not None and top_p < 1.0:
            desc = torch.sort(logits, dim=-1, descending=True).values
            sm = torch.softmax(desc, dim=-1)
            cum_excl = torch.cumsum(sm, dim=-1) - sm
            # Nucleus = tokens whose exclusive cumulative mass is still
            # under top_p (always contains the argmax); mask the rest.
            thresh = torch.where(cum_excl < top_p, desc,
                                 float("inf")).min(dim=-1, keepdim=True).values
            logits = torch.where(logits < thresh, float("-inf"), logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.no_grad()
    def generate(params, prompt, rng=None):
        dev = params["embed"].device
        prompt = _as_tokens(prompt, dev)
        b, s = prompt.shape
        gen = _generator(rng, dev) if temperature > 0.0 else None
        # The cache only ever holds tokens that later tokens attend to, so
        # the final sampled token needs no slot (and no forward pass).
        cache = init_cache(cfg, b, s + max_new_tokens - 1, device=dev)
        last_logits, cache = prefill(params, prompt, cache, cfg)
        tok = sample(last_logits, gen).to(prompt.dtype)
        done = (tok == eos_id) if eos_id is not None else None
        out = [tok]
        for pos in range(s, s + max_new_tokens - 1):
            logits, cache = forward_with_cache(
                params, tok[:, None], cache, pos, cfg)
            nxt = sample(logits[:, -1], gen).to(prompt.dtype)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            tok = nxt
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

    return generate


def make_beam_search_fn(
    cfg: tfm.TransformerConfig,
    *,
    max_new_tokens: int,
    n_beams: int,
    eos_id: Optional[int] = None,
    mesh=None,
):
    """Build ``beam_search(params, prompt) -> (seqs, scores)``.

    Beam search over ``max_new_tokens`` steps, returning ``seqs``
    (B, n_beams, S+max_new) and their total log-probabilities ``scores``
    (B, n_beams), best first. With ``eos_id`` set, a beam that emits it
    is FINISHED: its score freezes and its remaining slots pad with
    ``eos_id``. Without ``eos_id`` every beam decodes the full length.

    Prefill runs once at batch B and the cache is tiled to B*n_beams rows
    (row b*K + j = beam j of batch b); each step's candidate expansion is
    one (B, n_beams*vocab) ``topk`` and beam reordering is an
    ``index_select`` over the cache's batch dim. ``mesh`` raises (ROADMAP Queue 1 item 8).
    """
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if n_beams < 1:
        raise ValueError("n_beams must be >= 1")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id must be in [0, {cfg.vocab}), got {eos_id}")
    check_decodable(cfg, mesh)
    k_beams = n_beams
    vocab = cfg.vocab

    @torch.no_grad()
    def beam_search(params, prompt):
        dev = params["embed"].device
        prompt = _as_tokens(prompt, dev)
        b, s = prompt.shape
        cache = init_cache(cfg, b, s + max_new_tokens - 1, device=dev)
        last_logits, cache = prefill(params, prompt, cache, cfg)
        logp0 = torch.log_softmax(last_logits.float(), dim=-1)

        # First expansion: top-K tokens of the prompt's next-token
        # distribution seed the K beams. With K > vocab the surplus beams
        # are seeded dead (-inf) and repopulated by later expansions.
        k0 = min(k_beams, vocab)
        scores0, first0 = torch.topk(logp0, k0, dim=-1)
        pad = k_beams - k0
        scores = torch.cat(
            [scores0, torch.full((b, pad), float("-inf"), device=dev)], 1)
        first = torch.cat(
            [first0, torch.zeros((b, pad), dtype=first0.dtype, device=dev)],
            1).to(prompt.dtype)
        finished = (first == eos_id) if eos_id is not None else None

        cache = {n: c.repeat_interleave(k_beams, dim=1)
                 for n, c in cache.items()}
        seqs = torch.zeros((b, k_beams, max_new_tokens), dtype=prompt.dtype,
                           device=dev)
        seqs[:, :, 0] = first
        tok = first
        if eos_id is not None:
            freeze = torch.full((vocab,), float("-inf"), device=dev)
            freeze[eos_id] = 0.0
        for t in range(max_new_tokens - 1):
            logits, cache = forward_with_cache(
                params, tok.reshape(b * k_beams, 1), cache, s + t, cfg)
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(
                b, k_beams, vocab)
            if eos_id is not None:
                # A finished beam survives UNCHANGED: its only candidate
                # is "emit EOS again at zero cost".
                logp = torch.where(finished[:, :, None], freeze, logp)
            cand = scores[:, :, None] + logp
            scores, flat = torch.topk(cand.reshape(b, k_beams * vocab),
                                      k_beams, dim=-1)
            parent = flat // vocab
            nxt = (flat % vocab).to(tok.dtype)
            seqs = torch.take_along_dim(seqs, parent[:, :, None], dim=1)
            seqs[:, :, t + 1] = nxt
            if eos_id is not None:
                finished = torch.take_along_dim(finished, parent, dim=1)
                finished = finished | (nxt == eos_id)
            rows = (torch.arange(b, device=dev)[:, None] * k_beams
                    + parent).reshape(b * k_beams)
            cache = {n: c.index_select(1, rows) for n, c in cache.items()}
            tok = nxt
        prompts = prompt[:, None, :].expand(b, k_beams, s)
        return torch.cat([prompts, seqs], dim=2), scores

    return beam_search
