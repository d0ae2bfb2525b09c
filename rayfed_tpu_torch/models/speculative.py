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

"""Speculative decoding: a small draft model proposes, the target verifies
(port of ``rayfed_tpu/models/speculative.py``).

Per round the draft proposes ``k_draft`` tokens autoregressively, the
target scores all of them in one forward, and 1 to ``k_draft``+1 tokens
are emitted per target pass. At ``temperature=0`` verification is prefix
matching and the output is **exactly** the target's greedy decoding; at
``temperature > 0`` the Leviathan et al. rejection scheme runs (accept
with min(1, p_target/p_draft), resample the first rejection from the
normalized residual) and the output distribution is ancestral sampling
from the target.

The JAX package's ``lax.while_loop`` is a Python loop here with the same
acceptance rule; the write position is a host int (the round's
acceptance count is read back once per round). Each round re-runs the
trailing ``k_draft+1``-token window through both models at its true
offset, which rewrites identical cache entries and covers the one
position a rejection can have staled, so no validity state is tracked.
Batched rows accept the minimum over rows per round. Sampling draws from
a threefry key folded as the JAX package folds it (the round's position,
then 1000 + i per proposal, 2 for the acceptance uniforms, 3 for the
correction), with ``jax.random``'s ``categorical`` and ``uniform``, so a
sampled run gives the JAX package's tokens for the same key wherever the
logits agree.
"""

from __future__ import annotations

from typing import Optional

import torch

from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.privacy import threefry
from rayfed_tpu_torch.models.decode import (
    _as_tokens,
    _full,
    _key,
    _place_cache,
    _reciprocal,
    _sharded_dispatch,
    cache_spec,
    check_decodable,
    forward_with_cache,
    init_cache,
    prefill,
)


def make_speculative_generate_fn(
    cfg: tfm.TransformerConfig,
    draft_cfg: tfm.TransformerConfig,
    *,
    max_new_tokens: int,
    k_draft: int = 4,
    temperature: float = 0.0,
    eos_id: Optional[int] = None,
    return_stats: bool = False,
    mesh=None,
    party_axis: Optional[str] = "party",
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = "model",
):
    """Build ``generate(params, draft_params, prompt, rng=None) -> (B,
    S+max_new)``.

    ``params``/``cfg`` are the target model, ``draft_params``/``draft_cfg``
    the proposal model (same vocab required). Greedy at the default
    ``temperature=0``: bit-for-bit the target's own greedy decode. With
    ``eos_id``, a row that emits EOS pads the rest of its output with EOS
    (as :func:`~rayfed_tpu_torch.models.decode.make_generate_fn` does).
    Prompt length must be at least ``k_draft + 1``. With ``temperature >
    0``, ``rng`` (a threefry key or an int seed) is required. With
    ``return_stats=True`` the result is ``(tokens, n_rounds)``, the
    number of target forwards.

    With ``mesh``, both models run sharded as
    :func:`~rayfed_tpu_torch.models.decode.make_generate_fn` does: params
    of target and draft placed by the rules, the prompt's batch over
    party x data, each model's K/V cache by its own
    :func:`~rayfed_tpu_torch.models.decode.cache_spec`; both head counts
    must divide the model dim.
    """
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if k_draft < 1:
        raise ValueError("k_draft must be >= 1")
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"target and draft must share a vocab; got {cfg.vocab} vs "
            f"{draft_cfg.vocab}"
        )
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id must be in [0, {cfg.vocab}), got {eos_id}")
    check_decodable(cfg, mesh, model_axis)
    check_decodable(draft_cfg, mesh, model_axis)
    specs = None if mesh is None else tuple(
        cache_spec(mesh, party_axis, data_axis, model_axis, n_heads=c.n_heads)
        for c in (cfg, draft_cfg))
    w = k_draft + 1  # verification window
    sampled = temperature > 0.0
    inv_t = _reciprocal(temperature)

    @torch.no_grad()
    def generate(params, draft_params, prompt, rng=None):
        if sampled and rng is None:
            raise ValueError(
                "temperature > 0 samples: pass rng= (a threefry key or a "
                "seed; a silent fixed key would make every call "
                "identical)"
            )
        dev = params["embed"].device
        prompt = _as_tokens(prompt, dev)
        b, s = prompt.shape
        if s < w:
            raise ValueError(
                f"prompt length {s} shorter than the verification window "
                f"{w} (= k_draft + 1)"
            )
        key = _key(rng) if sampled else None
        total = s + max_new_tokens
        # Slack absorbs the last round's overshoot (writes past `total`
        # are never returned; cache slots past it are never attended).
        cap = total + k_draft + 1
        buf = torch.zeros((b, cap), dtype=prompt.dtype, device=dev)
        buf[:, :s] = _full(prompt)
        t_cache = init_cache(cfg, b, cap, device=dev)
        d_cache = init_cache(draft_cfg, b, cap, device=dev)
        if specs is not None:
            t_cache = _place_cache(t_cache, mesh, specs[0])
            d_cache = _place_cache(d_cache, mesh, specs[1])
        prefill(params, prompt, t_cache, cfg)
        prefill(draft_params, prompt, d_cache, draft_cfg)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        pos, rounds = s, 0

        def logits_of(*args):
            # Whole on every rank (a sharded forward's are vocab-sharded).
            return _full(forward_with_cache(*args)[0])

        def pick(logits, k):
            if not sampled:
                return torch.argmax(logits, dim=-1).to(buf.dtype)
            return threefry.categorical(k, logits * inv_t).to(buf.dtype)

        while pos < total:
            win = buf[:, pos - w:pos]
            # Fresh randomness per (round start, position): pos strictly
            # advances each round, so folded keys never repeat.
            kr = threefry.fold_in(key, pos) if sampled else None
            # Draft: the window pass re-validates its cache and yields
            # q_1; k_draft-1 single-token steps yield q_2..q_k.
            d_logits = logits_of(draft_params, win, d_cache, pos - w,
                                 draft_cfg)
            qs = [pick(d_logits[:, -1],
                       threefry.fold_in(kr, 1000) if sampled else None)]
            d_rows = [d_logits[:, -1]]
            for i in range(k_draft - 1):
                lg = logits_of(draft_params, qs[-1][:, None], d_cache,
                               pos + i, draft_cfg)
                qs.append(pick(lg[:, -1], threefry.fold_in(kr, 1001 + i)
                               if sampled else None))
                d_rows.append(lg[:, -1])
            q = torch.stack(qs, dim=1)                           # (B, k)

            # Target: one forward over [window, q_1..q_k]; its logits at
            # indices w-1..w+k-1 cover positions pos..pos+k.
            t_logits = logits_of(params, torch.cat([win, q], dim=1), t_cache,
                                 pos - w, cfg)
            t_stack = t_logits[:, w - 1:]                      # (B, k+1, V)

            if not sampled:
                t_pred = torch.argmax(t_stack, dim=-1).to(buf.dtype)
                # Longest prefix of proposals the target agrees with, min
                # over batch rows (keeps `pos` one number).
                eq = (q == t_pred[:, :k_draft]).to(torch.int32)
                n = int(torch.cumprod(eq, dim=1).sum(dim=1).min())
                correction = t_pred[:, n]
            else:
                d_stack = torch.stack(d_rows, dim=1)
                t_lp = torch.log_softmax(t_stack.float() * inv_t, -1)
                d_lp = torch.log_softmax(d_stack.float() * inv_t, -1)
                qi = q[..., None].long()
                lt_q = torch.take_along_dim(t_lp[:, :k_draft], qi, -1)[..., 0]
                ld_q = torch.take_along_dim(d_lp, qi, -1)[..., 0]
                u = threefry.uniform(threefry.fold_in(kr, 2), (b, k_draft),
                                     device=dev)
                accept = (threefry.xla_log(torch.clamp(u, min=1e-38))
                          < (lt_q - ld_q)).to(torch.int32)       # (B, k)
                n = int(torch.cumprod(accept, dim=1).sum(dim=1).min())
                # Correction at position pos+n: rows that rejected there
                # resample from the residual max(p_t - p_d, 0); rows the
                # batch-min merely cut short emit their accepted proposal;
                # n == k means every proposal was accepted and the extra
                # token samples straight from the target.
                m = min(n, k_draft - 1)
                pt = torch.exp(t_lp[:, n])
                pd_ = torch.exp(d_lp[:, m])
                res = torch.clamp(pt - pd_, min=0.0)
                z = res.sum(dim=-1, keepdim=True)
                res_probs = torch.where(
                    z > 1e-30, res / torch.clamp(z, min=1e-30), pt)
                final_probs = res_probs if n < k_draft else pt
                sampled_corr = threefry.categorical(
                    threefry.fold_in(kr, 3),
                    threefry.xla_log(torch.clamp(final_probs, min=1e-38)),
                ).to(buf.dtype)
                if n < k_draft:
                    correction = torch.where(accept[:, m] == 1, q[:, m],
                                             sampled_corr)
                else:
                    correction = sampled_corr

            # Emit q_1..q_n then the correction. Slots past n hold
            # proposals; a later round overwrites them before they can
            # ever be part of the consumed prefix.
            idx = torch.arange(k_draft + 1, device=dev)[None, :]
            padded_q = torch.cat([q, q[:, -1:]], dim=1)
            emit = torch.where(idx == n, correction[:, None], padded_q)
            if eos_id is not None:
                # EOS-pad within the emitted block and across rounds.
                is_eos = (emit == eos_id).to(torch.int32)
                past_eos = torch.cumsum(is_eos, dim=1) - is_eos
                emit = torch.where((past_eos > 0) | done[:, None],
                                   torch.full_like(emit, eos_id), emit)
                # Only the consumed prefix (n+1 tokens) can finish a row.
                done = done | ((emit == eos_id) & (idx <= n)).any(dim=1)
            buf[:, pos:pos + k_draft + 1] = emit
            pos += n + 1
            rounds += 1
        out = buf[:, :total]
        return (out, rounds) if return_stats else out

    if mesh is None:
        return generate
    return _sharded_dispatch(generate, mesh, party_axis, data_axis,
                             n_param_trees=2)
