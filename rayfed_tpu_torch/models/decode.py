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
``jax.random.categorical``'s Gumbel-max tokens from a threefry key
(:mod:`rayfed_tpu_torch.privacy.threefry`), split per step as the JAX
package splits it, so a sampled decode gives the JAX package's tokens
for the same key wherever the logits agree. Greedy decoding, beam search
and all logits match it.

With ``mesh=`` (a DeviceMesh from ``mesh.build_mesh``) decoding runs
sharded, as the JAX package's does: params are DTensors placed by the
partition rules (``parallel/sharding.py``), the prompt's batch shards over
``party`` x ``data``, and the K/V cache (:func:`cache_spec`) keeps its
batch there and its heads over ``model``, the layout the rules give the
attention's activations. Each rank writes and reads its own cache shard;
each step's logits are gathered whole, so sampling, beam bookkeeping and
speculative acceptance run on every rank alike, on plain tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.privacy import threefry
from rayfed_tpu_torch.utils import DeviceLike, resolve_device

Cache = dict

def cache_spec(mesh, party_axis: Optional[str] = "party",
               data_axis: Optional[str] = "data",
               model_axis: Optional[str] = "model",
               n_heads: Optional[int] = None) -> tuple:
    """Spec of the stacked (L, B, T, H, Dh) K/V cache: batch over party x
    data, heads over the tensor-parallel dim, the layout the Megatron
    rules give the attention activations. With ``n_heads`` the head dim
    replicates when it does not divide the model dim (the JAX package's
    rule; the port's sharded decode needs it to divide,
    :func:`check_decodable`)."""
    from rayfed_tpu_torch.parallel import sharding as shd

    batch = shd.batch_spec(mesh, party_axis, data_axis)[0]
    names = tuple(mesh.mesh_dim_names or ())
    heads = model_axis if model_axis in names else None
    if (heads is not None and n_heads is not None
            and n_heads % shd.mesh_size(mesh, model_axis) != 0):
        heads = None
    return (None, batch, None, heads, None)


def check_decodable(cfg: tfm.TransformerConfig, mesh=None,
                    model_axis: Optional[str] = "model") -> None:
    """Raise for what cached decoding does not take. With a ``mesh``: its
    dims must be placeable (``sharding.check_mesh``) and ``n_heads`` must
    divide the model dim, so each rank's cache holds its own heads. An MoE
    config decodes through ``ffn_apply``'s MoE lane."""
    if mesh is None:
        return
    from rayfed_tpu_torch.parallel import sharding as shd

    shd.check_mesh(mesh)
    tp = shd.mesh_size(mesh, model_axis)
    if cfg.n_heads % tp:
        raise ValueError(
            f"sharded decoding needs n_heads ({cfg.n_heads}) divisible by "
            f"the {model_axis!r} mesh dim ({tp})")


def _cache_batch_placements(cache_tensor) -> list:
    """The placements of a (B, S) token block sharded as the cache's batch
    dim (1)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if isinstance(p, Shard) and p.dim == 1 else Replicate()
            for p in cache_tensor.placements]


def _batch_block(cache_tensor):
    """(first row, rows) of this rank's block of the cache's batch dim."""
    from torch.distributed.tensor import Shard

    mesh = cache_tensor.device_mesh
    coord = mesh.get_coordinate()
    idx = 0
    for i, p in enumerate(cache_tensor.placements):
        if isinstance(p, Shard) and p.dim == 1:
            idx = idx * mesh.size(i) + coord[i]
    rows = cache_tensor.to_local().shape[1]
    return idx * rows, rows


def _tile_rows(c, k: int):
    """``c.repeat_interleave(k, dim=1)``. On a DTensor cache each batch
    row's ``k`` copies stay in its rank's block, so each rank tiles its
    own rows."""
    if tfm.is_dtensor(c):
        return tfm.like_dtensor(c.to_local().repeat_interleave(k, dim=1), c)
    return c.repeat_interleave(k, dim=1)


def _take_rows(c, rows: torch.Tensor):
    """``c.index_select(1, rows)``. A beam's parent is a beam of the same
    batch row, so on a DTensor cache every row a rank needs is its own."""
    if not tfm.is_dtensor(c):
        return c.index_select(1, rows)
    lo, n = _batch_block(c)
    mine = rows[lo:lo + n] - lo
    if bool(((mine < 0) | (mine >= n)).any()):
        raise ValueError("beam reordering crossed a rank's batch rows")
    return tfm.like_dtensor(c.to_local().index_select(1, mine), c)


def _place_cache(cache: Cache, mesh, spec) -> Cache:
    from rayfed_tpu_torch.parallel import sharding as shd

    pl = shd.placements_for(spec, mesh)
    return {n: shd.place(c, mesh, pl) for n, c in cache.items()}


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
    b, s = tokens.shape
    ck, cv = cache["k"], cache["v"]
    sharded = tfm.is_dtensor(ck)
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
        if sharded:
            raise ValueError("per-row offsets need a cache on one device")
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
        if sharded and not tfm.is_dtensor(tokens):
            from rayfed_tpu_torch.parallel import sharding as shd

            tokens = shd.place(tokens, ck.device_mesh,
                               _cache_batch_placements(ck))
        positions = tfm.positions_like(tokens, off)
    cdt = cfg.compute_dtype
    x = tfm.embed_tokens(params["embed"], tokens).to(cdt)
    stacked = params["layers"]
    # Each rank writes its own batch rows and heads of the cache.
    lk, lv = (ck.to_local(), cv.to_local()) if sharded else (ck, cv)
    for i in range(cfg.n_layers):
        layer = tfm.stacked_layer(stacked, i)
        q, k, v = tfm.qkv_proj(x, layer, positions, cfg)
        kl, vl = (k.to_local(), v.to_local()) if sharded else (k, v)
        if per_row:
            lk[i][rows, positions] = kl.to(lk.dtype)
            lv[i][rows, positions] = vl.to(lv.dtype)
        else:
            lk[i, :, off:off + s] = kl.to(lk.dtype)
            lv[i, :, off:off + s] = vl.to(lv.dtype)
        o = tfm.causal_attention(q, ck[i], cv[i], q_offset=off)
        wo = layer["wo"].to(cdt)
        x = x + tfm.constrain_like(o.reshape(b, s, -1)
                                   @ wo.reshape(-1, wo.shape[-1]), x)
        hmlp = tfm.rms_norm(x, layer["ln2"])
        x = x + tfm.constrain_like(tfm.ffn_apply(hmlp, layer, cfg), x)
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


def _reciprocal(temperature: float) -> float:
    """The float32 reciprocal of ``temperature``: XLA compiles ``logits /
    temperature`` (a constant) as a multiply by it."""
    if temperature <= 0.0:
        return 0.0
    return float(np.float32(1.0) / np.float32(temperature))


def _key(rng) -> threefry.Key:
    """A threefry key from ``rng``: a key (a pair of uint32 words, as
    ``jax.random.PRNGKey`` gives) or an int seed (``prng_key(seed)``)."""
    if isinstance(rng, torch.Generator):
        raise TypeError(
            "sampling draws from a threefry key, as jax.random does: pass "
            "rng=threefry.prng_key(seed) (or an int seed), not a "
            "torch.Generator")
    return threefry.as_key(rng)


def _full(x):
    """A DTensor's full value (plain, on every rank); anything else as
    it is."""
    return x.full_tensor() if tfm.is_dtensor(x) else x


def _sharded_dispatch(fn, mesh, party_axis, data_axis,
                      n_param_trees: int = 1):
    """``fn(*param_trees, prompt, *extras)`` with each leading param tree
    placed by the Megatron rules and the prompt over party x data (the JAX
    package's ``_sharded_jit``). The placements are keyed per tree (its
    key paths, shapes and dtypes), so a later call with another tree (a
    LoRA-merged one against the base) gets its own placements. Shared by
    the sharded generate, beam search and speculative decoding."""
    from rayfed_tpu_torch.parallel import sharding as shd

    tfm.register_dtensor_rules()
    prompt_placements = shd.placements_for(
        shd.batch_spec(mesh, party_axis, data_axis), mesh)
    placements_by_tree = {}
    dev = shd.mesh_device(mesh)

    def tree_key(tree):
        return tuple((path, tuple(x.shape), x.dtype)
                     for path, x in shd.leaf_paths(tree))

    def place_tree(tree):
        key = tree_key(tree)
        placements = placements_by_tree.get(key)
        if placements is None:
            placements = placements_by_tree[key] = shd.placements_by_path(
                mesh, tree)
        return shd.place_tree(mesh, tree, placements)

    def dispatch(*args, **kwargs):
        trees, (prompt, *rest) = args[:n_param_trees], args[n_param_trees:]
        prompt = shd.place(_as_tokens(_full(prompt), dev), mesh,
                           prompt_placements)
        return fn(*(place_tree(t) for t in trees), prompt, *rest, **kwargs)

    return dispatch


def make_generate_fn(
    cfg: tfm.TransformerConfig,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    mesh=None,
    party_axis: Optional[str] = "party",
    data_axis: Optional[str] = "data",
):
    """Build ``generate(params, prompt, rng=None) -> (B, S+max_new)``.

    Greedy when ``temperature == 0`` (rng unused), otherwise softmax
    sampling at the given temperature, optionally truncated to the
    ``top_k`` highest-probability tokens and/or the ``top_p`` nucleus
    (smallest set of tokens whose probability mass reaches ``top_p``),
    drawn with ``jax.random.categorical``'s Gumbel-max from ``rng`` (a
    threefry key, or an int seed; None is ``prng_key(0)``), split once
    per token as the JAX package splits it. With ``eos_id``, a row that
    emits it keeps emitting EOS for the rest of the generation — the
    output still has shape (B, S+max_new), terminated rows are
    EOS-padded.

    With ``mesh`` decoding runs sharded (module docstring): the result is
    a plain tensor, the same on every rank.
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
    spec = None if mesh is None else cache_spec(
        mesh, party_axis, data_axis, n_heads=cfg.n_heads)

    inv_t = _reciprocal(temperature)

    def sample(logits, key):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits * inv_t
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
        return threefry.categorical(key, logits)

    @torch.no_grad()
    def generate(params, prompt, rng=None):
        dev = params["embed"].device
        prompt = _as_tokens(prompt, dev)
        b, s = prompt.shape
        key = _key(0 if rng is None else rng)
        # The cache only ever holds tokens that later tokens attend to, so
        # the final sampled token needs no slot (and no forward pass).
        cache = init_cache(cfg, b, s + max_new_tokens - 1, device=dev)
        if spec is not None:
            cache = _place_cache(cache, mesh, spec)
        last_logits, cache = prefill(params, prompt, cache, cfg)
        key, sub = threefry.split(key)
        tok = sample(_full(last_logits), sub).to(prompt.dtype)
        done = (tok == eos_id) if eos_id is not None else None
        out = [tok]
        for pos in range(s, s + max_new_tokens - 1):
            logits, cache = forward_with_cache(
                params, tok[:, None], cache, pos, cfg)
            key, sub = threefry.split(key)
            nxt = sample(_full(logits[:, -1]), sub).to(prompt.dtype)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            tok = nxt
            out.append(tok)
        return torch.cat([_full(prompt), torch.stack(out, dim=1)], dim=1)

    if mesh is None:
        return generate
    return _sharded_dispatch(generate, mesh, party_axis, data_axis)


def make_beam_search_fn(
    cfg: tfm.TransformerConfig,
    *,
    max_new_tokens: int,
    n_beams: int,
    eos_id: Optional[int] = None,
    mesh=None,
    party_axis: Optional[str] = "party",
    data_axis: Optional[str] = "data",
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
    ``index_select`` over the cache's batch dim. With ``mesh`` the search
    runs sharded as :func:`make_generate_fn` does; a beam's parent is a
    beam of the same batch row, so each rank reorders its own cache rows.
    """
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if n_beams < 1:
        raise ValueError("n_beams must be >= 1")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id must be in [0, {cfg.vocab}), got {eos_id}")
    check_decodable(cfg, mesh)
    spec = None if mesh is None else cache_spec(
        mesh, party_axis, data_axis, n_heads=cfg.n_heads)
    k_beams = n_beams
    vocab = cfg.vocab

    @torch.no_grad()
    def beam_search(params, prompt):
        dev = params["embed"].device
        prompt = _as_tokens(prompt, dev)
        b, s = prompt.shape
        cache = init_cache(cfg, b, s + max_new_tokens - 1, device=dev)
        if spec is not None:
            cache = _place_cache(cache, mesh, spec)
        last_logits, cache = prefill(params, prompt, cache, cfg)
        logp0 = torch.log_softmax(_full(last_logits).float(), dim=-1)

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

        cache = {n: _tile_rows(c, k_beams) for n, c in cache.items()}
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
            logp = torch.log_softmax(_full(logits[:, -1]).float(),
                                     dim=-1).reshape(b, k_beams, vocab)
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
            cache = {n: _take_rows(c, rows) for n, c in cache.items()}
            tok = nxt
        prompts = _full(prompt)[:, None, :].expand(b, k_beams, s)
        return torch.cat([prompts, seqs], dim=2), scores

    if mesh is None:
        return beam_search
    return _sharded_dispatch(beam_search, mesh, party_axis, data_axis)
