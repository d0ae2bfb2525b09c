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

"""The port's KV-cache decoding (``rayfed_tpu_torch/models/decode.py``)
on the CPU: the cases of ``test_decode.py`` (all but the MoE one and the
two sharded ones, whose refusals are held here instead), and the port
against the JAX package on the same params and numpy inputs: cached
logits within 1e-5 (f32 compute), greedy tokens and beams equal.
Sampling draws ``jax.random.categorical``'s tokens from a threefry key,
so sampled runs equal the JAX package's for the same key, and are held
by their properties too.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import decode as jdecode
from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu_torch.models import decode, transformer as tfm
from rayfed_tpu_torch.privacy import threefry

F32_TOL = 1e-5


def _cfgs(**kw):
    base = dict(compute_dtype=jnp.float32)
    base.update(kw)
    jcfg = jtfm.tiny_config(**base)
    tkw = dict(kw, compute_dtype=torch.float32)
    return jcfg, tfm.tiny_config(**tkw)


def _cfg(**kw):
    return _cfgs(**kw)[1]


def _shared_params(jcfg, seed):
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, tfm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _params(cfg, seed):
    """The JAX package's params for ``seed``, carried over."""
    jcfg = jtfm.tiny_config(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, compute_dtype=jnp.float32)
    return _shared_params(jcfg, seed)[1]


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Mirrors of test_decode.py
# ---------------------------------------------------------------------------


def test_prefill_matches_full_forward():
    cfg = _cfg()
    params = _params(cfg, 0)
    tokens = _t(_tokens(cfg.vocab, (2, 12), 1))
    full = tfm.forward(params, tokens, cfg)
    cache = decode.init_cache(cfg, 2, 16, device="cpu")
    cached, _ = decode.forward_with_cache(params, tokens, cache, 0, cfg)
    _close(cached, full.numpy(), 2e-5)


def test_incremental_decode_matches_full_forward():
    cfg = _cfg()
    params = _params(cfg, 2)
    tokens = _t(_tokens(cfg.vocab, (1, 10), 3))
    cache = decode.init_cache(cfg, 1, tokens.shape[1], device="cpu")
    for pos in range(tokens.shape[1]):
        logits, cache = decode.forward_with_cache(
            params, tokens[:, pos:pos + 1], cache, pos, cfg)
        full = tfm.forward(params, tokens[:, :pos + 1], cfg)
        _close(logits[:, -1], full[:, -1].numpy(), 2e-5)


def test_greedy_generate_matches_naive_loop():
    cfg = _cfg()
    params = _params(cfg, 4)
    prompt = _t(_tokens(cfg.vocab, (2, 5), 5))
    max_new = 6
    out = decode.make_generate_fn(cfg, max_new_tokens=max_new)(params, prompt)
    assert out.shape == (2, 5 + max_new)
    assert torch.equal(out[:, :5], prompt)
    seq = prompt
    for _ in range(max_new):
        nxt = torch.argmax(tfm.forward(params, seq, cfg)[:, -1], dim=-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert torch.equal(out, seq)


def test_sampled_generate_deterministic_per_key_and_in_vocab():
    cfg = _cfg()
    params = _params(cfg, 6)
    prompt = _t(_tokens(cfg.vocab, (2, 4), 7))
    gen = decode.make_generate_fn(cfg, max_new_tokens=5, temperature=0.8)
    a = gen(params, prompt, 8)
    b = gen(params, prompt, threefry.prng_key(8))
    c = gen(params, prompt, 9)
    assert torch.equal(a, b)
    assert torch.equal(gen(params, prompt), gen(params, prompt, 0))
    with pytest.raises(TypeError, match="threefry key"):
        gen(params, prompt, torch.Generator().manual_seed(8))
    assert a.shape == (2, 9)
    assert ((a[:, 4:] >= 0) & (a[:, 4:] < cfg.vocab)).all()
    assert not torch.equal(a, c)


_SAMPLING = [dict(temperature=0.8), dict(temperature=0.7, top_k=5),
             dict(temperature=1.1, top_p=0.9),
             dict(temperature=0.9, top_k=7, top_p=0.8, eos_id=3)]


@pytest.mark.parametrize("kw", _SAMPLING,
                         ids=["temp", "top_k", "top_p", "all_eos"])
def test_sampled_generate_equals_the_jax_package_for_the_same_key(kw):
    # jax.random.categorical's Gumbel-max over threefry, the key split
    # once per token: the JAX package's tokens, key for key (tiny f32
    # config; the logits agree within 1e-5).
    jcfg, cfg = _cfgs()
    jparams, params = _shared_params(jcfg, 6)
    prompt = _tokens(cfg.vocab, (3, 4), 7)
    jgen = jdecode.make_generate_fn(jcfg, max_new_tokens=8, **kw)
    gen = decode.make_generate_fn(cfg, max_new_tokens=8, **kw)
    for seed in (0, 3, 2**40 + 8):
        want = np.asarray(jgen(jparams, jnp.asarray(prompt),
                               jax.random.PRNGKey(seed)))
        got = gen(params, _t(prompt), jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, gen(params, _t(prompt), seed))
    np.testing.assert_array_equal(
        gen(params, _t(prompt)).numpy(),
        np.asarray(jgen(jparams, jnp.asarray(prompt))))


@pytest.mark.parametrize("bad", [0, -3])
def test_generate_rejects_bad_lengths(bad):
    with pytest.raises(ValueError):
        decode.make_generate_fn(_cfg(), max_new_tokens=bad)


def test_cache_overflow_raises():
    cfg = _cfg()
    params = _params(cfg, 12)
    cache = decode.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="longer than cache"):
        decode.forward_with_cache(
            params, torch.zeros((1, 6), dtype=torch.long), cache, 0, cfg)
    with pytest.raises(ValueError, match="cache overflow"):
        decode.forward_with_cache(
            params, torch.zeros((1, 2), dtype=torch.long), cache, 3, cfg)
    # Per-row offsets are checked row by row.
    with pytest.raises(ValueError, match="cache overflow"):
        decode.forward_with_cache(
            params, torch.zeros((2, 1), dtype=torch.long),
            decode.init_cache(cfg, 2, 4, device="cpu"), np.array([1, 4]),
            cfg)


def test_topk_one_equals_greedy():
    cfg = _cfg()
    params = _params(cfg, 30)
    prompt = _t(_tokens(cfg.vocab, (2, 4), 31))
    greedy = decode.make_generate_fn(cfg, max_new_tokens=5)(params, prompt)
    topk1 = decode.make_generate_fn(
        cfg, max_new_tokens=5, temperature=0.7, top_k=1)(params, prompt, 32)
    assert torch.equal(topk1, greedy)


def test_topk_topp_sampling_stays_in_nucleus():
    cfg = _cfg()
    params = _params(cfg, 33)
    prompt = _t(_tokens(cfg.vocab, (2, 4), 34))
    gen = decode.make_generate_fn(
        cfg, max_new_tokens=6, temperature=1.0, top_k=16, top_p=0.9)
    out = gen(params, prompt, 35)
    assert out.shape == (2, 10)
    seq = prompt
    for step in range(6):
        logits = tfm.forward(params, seq, cfg)[:, -1]
        top16 = torch.argsort(logits, dim=-1)[:, -16:]
        for b in range(2):
            assert int(out[b, 4 + step]) in top16[b].tolist()
        seq = torch.cat([seq, out[:, 4 + step][:, None]], dim=1)


def test_sampling_params_validated():
    cfg = _cfg()
    with pytest.raises(ValueError, match="top_k"):
        decode.make_generate_fn(cfg, max_new_tokens=2, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        decode.make_generate_fn(cfg, max_new_tokens=2, top_p=0.0)
    with pytest.raises(ValueError, match="top_p"):
        decode.make_generate_fn(cfg, max_new_tokens=2, top_p=1.5)


def _brute_force_best(params, prompt, cfg, t_new):
    """Exhaustive argmax over all vocab^t_new continuations (tiny shapes)."""
    best_score, best_seq = -np.inf, None
    for cont in itertools.product(range(cfg.vocab), repeat=t_new):
        toks = torch.cat([prompt, torch.tensor([cont])], dim=1)
        logp = torch.log_softmax(tfm.forward(params, toks, cfg), dim=-1)
        score = sum(float(logp[0, prompt.shape[1] - 1 + i, cont[i]])
                    for i in range(t_new))
        if score > best_score:
            best_score, best_seq = score, cont
    return best_score, best_seq


def _small(vocab):
    return _cfg(vocab=vocab, d_model=32, n_heads=2, n_layers=2, d_ff=64)


def test_beam_search_finds_exhaustive_argmax():
    cfg = _small(6)
    params = _params(cfg, 0)
    prompt = _t(_tokens(cfg.vocab, (1, 5), 1))
    t_new = 2
    bs = decode.make_beam_search_fn(cfg, max_new_tokens=t_new,
                                    n_beams=cfg.vocab ** (t_new - 1) * 2)
    seqs, scores = bs(params, prompt)
    ref_score, ref_seq = _brute_force_best(params, prompt, cfg, t_new)
    assert tuple(int(x) for x in seqs[0, 0, -t_new:]) == ref_seq
    np.testing.assert_allclose(float(scores[0, 0]), ref_score, rtol=1e-4)
    s = scores[0].numpy()
    assert np.all(s[:-1] >= s[1:] - 1e-6)


def test_beam_search_beam1_is_greedy():
    cfg = _small(16)
    params = _params(cfg, 2)
    prompt = _t(_tokens(cfg.vocab, (2, 4), 3))
    seqs, _ = decode.make_beam_search_fn(
        cfg, max_new_tokens=4, n_beams=1)(params, prompt)
    greedy = decode.make_generate_fn(cfg, max_new_tokens=4)(params, prompt)
    assert torch.equal(seqs[:, 0, :], greedy)


def test_beam_search_validates_args():
    cfg = tfm.tiny_config()
    with pytest.raises(ValueError, match="max_new_tokens"):
        decode.make_beam_search_fn(cfg, max_new_tokens=0, n_beams=2)
    with pytest.raises(ValueError, match="n_beams"):
        decode.make_beam_search_fn(cfg, max_new_tokens=2, n_beams=0)


def test_beam_search_batched_rows_do_not_cross_contaminate():
    cfg = _small(5)
    params = _params(cfg, 4)
    prompts = _t(_tokens(cfg.vocab, (2, 6), 5))
    t_new = 2
    seqs, scores = decode.make_beam_search_fn(
        cfg, max_new_tokens=t_new, n_beams=cfg.vocab ** (t_new - 1))(
        params, prompts)
    for row in range(2):
        ref_score, ref_seq = _brute_force_best(
            params, prompts[row:row + 1], cfg, t_new)
        assert tuple(int(x) for x in seqs[row, 0, -t_new:]) == ref_seq
        np.testing.assert_allclose(float(scores[row, 0]), ref_score,
                                   rtol=1e-4)


def test_beam_search_eos_matches_exhaustive():
    cfg = _small(5)
    params = _params(cfg, 8)
    prompt = _t(_tokens(cfg.vocab, (1, 5), 9))
    eos, t_new = 0, 3
    best = {}
    for cont in itertools.product(range(cfg.vocab), repeat=t_new):
        cut = next((i + 1 for i, c in enumerate(cont) if c == eos), t_new)
        trunc = cont[:cut]
        toks = torch.cat([prompt, torch.tensor([cont])], dim=1)
        logp = torch.log_softmax(tfm.forward(params, toks, cfg), dim=-1)
        score = sum(float(logp[0, prompt.shape[1] - 1 + i, trunc[i]])
                    for i in range(cut))
        if trunc not in best or score > best[trunc]:
            best[trunc] = score
    ref_seq, ref_score = max(best.items(), key=lambda kv: kv[1])
    seqs, scores = decode.make_beam_search_fn(
        cfg, max_new_tokens=t_new, n_beams=cfg.vocab ** (t_new - 1),
        eos_id=eos)(params, prompt)
    got = [int(x) for x in seqs[0, 0, prompt.shape[1]:]]
    cut = next((i + 1 for i, c in enumerate(got) if c == eos), t_new)
    assert tuple(got[:cut]) == ref_seq, (got, ref_seq)
    assert all(c == eos for c in got[cut:]), got
    np.testing.assert_allclose(float(scores[0, 0]), ref_score, rtol=1e-4)


def test_beam_search_eos_validates():
    cfg = tfm.tiny_config()
    with pytest.raises(ValueError, match="eos_id"):
        decode.make_beam_search_fn(
            cfg, max_new_tokens=2, n_beams=2, eos_id=cfg.vocab)


def test_generate_eos_pads_terminated_rows():
    cfg = _small(5)
    params = _params(cfg, 10)
    prompt = _t(_tokens(cfg.vocab, (3, 4), 11))
    eos, t_new = 0, 8
    # Both runs draw the same numbers step for step (a row's EOS padding
    # replaces its draw, it does not skip it), so the trajectories agree
    # up to each row's first EOS.
    plain = decode.make_generate_fn(
        cfg, max_new_tokens=t_new, temperature=1.0)(params, prompt, 12)
    with_eos = decode.make_generate_fn(
        cfg, max_new_tokens=t_new, temperature=1.0, eos_id=eos)(
        params, prompt, 12)
    s = prompt.shape[1]
    terminated = 0
    for row in range(prompt.shape[0]):
        gen_plain = plain[row, s:].tolist()
        gen_eos = with_eos[row, s:].tolist()
        cut = next((i + 1 for i, c in enumerate(gen_plain) if c == eos),
                   t_new)
        assert gen_eos[:cut] == gen_plain[:cut]
        assert all(c == eos for c in gen_eos[cut:]), gen_eos
        terminated += cut < t_new
    assert terminated >= 1


def test_generate_eos_validates():
    with pytest.raises(ValueError, match="eos_id"):
        decode.make_generate_fn(tfm.tiny_config(), max_new_tokens=2, eos_id=-1)


# ---------------------------------------------------------------------------
# mesh=: sharded decoding (tests/test_torch_sharded_decode.py holds it on
# 4 ranks against the JAX package); here on a one-rank mesh in-process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda cfg, mesh: decode.make_generate_fn(cfg, max_new_tokens=3,
                                              mesh=mesh),
    lambda cfg, mesh: (lambda *a: decode.make_beam_search_fn(
        cfg, max_new_tokens=3, n_beams=2, mesh=mesh)(*a)[0]),
], ids=["generate", "beam"])
def test_sharded_decode_on_a_one_rank_mesh(make):
    from tests.torch_mesh import one_rank_mesh

    cfg = _cfg()
    params = _params(cfg, 12)
    prompt = _t(_tokens(cfg.vocab, (2, 5), 13))
    want = make(cfg, None)(params, prompt)
    with one_rank_mesh() as mesh:
        got = make(cfg, mesh)(params, prompt)
    assert not tfm.is_dtensor(got)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_moe_config_decodes():
    # The mirror of test_decode.py::test_moe_config_decodes, on the JAX
    # package's params; the greedy tokens and the cached logits are also
    # held against the JAX package's.
    jcfg, cfg = _cfgs(n_experts=2)
    jp, params = _shared_params(jcfg, 10)
    prompt = _tokens(cfg.vocab, (1, 4), 11)
    out = decode.make_generate_fn(cfg, max_new_tokens=3)(params, _t(prompt))
    assert out.shape == (1, 7)
    want = jdecode.make_generate_fn(jcfg, max_new_tokens=3)(
        jp, jnp.asarray(prompt, jnp.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))

    full = tfm.forward(params, _t(prompt), cfg)
    cache = decode.init_cache(cfg, 1, 8, device="cpu")
    cached, _ = decode.forward_with_cache(params, _t(prompt), cache, 0, cfg)
    _close(cached, full.numpy(), 2e-5)
    jcached, _ = jdecode.forward_with_cache(
        jp, jnp.asarray(prompt, jnp.int32), jdecode.init_cache(jcfg, 1, 8), 0,
        jcfg)
    _close(cached, np.asarray(jcached))


# ---------------------------------------------------------------------------
# Per-row offsets (the serving pool's batched step)
# ---------------------------------------------------------------------------


def test_per_row_offsets_match_each_row_alone():
    """A (B,) offset runs each row at its own position: row r's logits and
    cache row equal a batch-1 run of that row at its offset."""
    cfg = _cfg()
    params = _params(cfg, 14)
    toks = _t(_tokens(cfg.vocab, (3, 12), 15))
    lens = [4, 9, 11]
    cache = decode.init_cache(cfg, 3, 16, device="cpu")
    singles = []
    for r, n in enumerate(lens):
        one = decode.init_cache(cfg, 1, 16, device="cpu")
        decode.forward_with_cache(params, toks[r:r + 1, :n], one, 0, cfg)
        cache["k"][:, r:r + 1] = one["k"]
        cache["v"][:, r:r + 1] = one["v"]
        singles.append(one)
    step = toks[:, -1:]
    logits, cache = decode.forward_with_cache(
        params, step, cache, np.array(lens), cfg)
    for r, n in enumerate(lens):
        want, one = decode.forward_with_cache(
            params, step[r:r + 1], singles[r], n, cfg)
        _close(logits[r:r + 1], want.numpy())
        _close(cache["k"][:, r:r + 1], one["k"].numpy())
        full = tfm.forward(params, torch.cat(
            [toks[r:r + 1, :n], step[r:r + 1]], dim=1), cfg)
        _close(logits[r, -1], full[0, -1].numpy(), 2e-5)


# ---------------------------------------------------------------------------
# The port against the JAX package, on the same params and inputs
# ---------------------------------------------------------------------------


def test_forward_with_cache_and_prefill_match_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _shared_params(jcfg, 20)
    toks = _tokens(cfg.vocab, (2, 12), 21)
    jl, jc = jdecode.forward_with_cache(
        jp, jnp.asarray(toks, jnp.int32), jdecode.init_cache(jcfg, 2, 16), 0,
        jcfg)
    tl, tc = decode.forward_with_cache(
        tp, _t(toks), decode.init_cache(cfg, 2, 16, device="cpu"), 0, cfg)
    _close(tl, np.asarray(jl))
    _close(tc["k"], np.asarray(jc["k"]))
    _close(tc["v"], np.asarray(jc["v"]))
    jlast, _ = jdecode.prefill(jp, jnp.asarray(toks, jnp.int32),
                               jdecode.init_cache(jcfg, 2, 16), jcfg)
    tlast, _ = decode.prefill(tp, _t(toks),
                              decode.init_cache(cfg, 2, 16, device="cpu"), cfg)
    _close(tlast, np.asarray(jlast))


def test_incremental_decode_matches_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _shared_params(jcfg, 22)
    toks = _tokens(cfg.vocab, (2, 9), 23)
    jc = jdecode.init_cache(jcfg, 2, 9)
    tc = decode.init_cache(cfg, 2, 9, device="cpu")
    for pos in range(9):
        jl, jc = jdecode.forward_with_cache(
            jp, jnp.asarray(toks[:, pos:pos + 1], jnp.int32), jc, pos, jcfg)
        tl, tc = decode.forward_with_cache(
            tp, _t(toks[:, pos:pos + 1]), tc, pos, cfg)
        _close(tl, np.asarray(jl))


def test_greedy_generate_matches_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _shared_params(jcfg, 24)
    prompt = _tokens(cfg.vocab, (3, 6), 25)
    want = jdecode.make_generate_fn(jcfg, max_new_tokens=8)(
        jp, jnp.asarray(prompt, jnp.int32))
    got = decode.make_generate_fn(cfg, max_new_tokens=8)(tp, _t(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("eos_id", [None, 0], ids=["no_eos", "eos"])
def test_beam_search_matches_jax(eos_id):
    jcfg, cfg = _cfgs(vocab=5, d_model=32, n_heads=2, n_layers=2, d_ff=64)
    jp, tp = _shared_params(jcfg, 26)
    prompt = _tokens(cfg.vocab, (2, 5), 27)
    jseqs, jscores = jdecode.make_beam_search_fn(
        jcfg, max_new_tokens=4, n_beams=3, eos_id=eos_id)(
        jp, jnp.asarray(prompt, jnp.int32))
    seqs, scores = decode.make_beam_search_fn(
        cfg, max_new_tokens=4, n_beams=3, eos_id=eos_id)(tp, _t(prompt))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
    _close(scores, np.asarray(jscores))
