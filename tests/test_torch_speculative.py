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

"""The port's speculative decoding (``rayfed_tpu_torch/models/
speculative.py``) on the CPU: the six unsharded cases of
``test_speculative.py`` on the JAX package's params carried over, plus
greedy speculative output against the JAX package's greedy target
decode, and the refusal of ``mesh=`` (ROADMAP Queue 1 item 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import decode as jdecode
from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu_torch.models import decode, speculative, transformer as tfm


def _pair(seed, **kw):
    """(JAX cfg, port cfg, JAX params, port params) for one tiny model."""
    jcfg = jtfm.tiny_config(compute_dtype=jnp.float32, **kw)
    cfg = tfm.tiny_config(compute_dtype=torch.float32, **kw)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = tfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, cfg, jp, tp


def _models(seed_t=0, seed_d=1):
    _, cfg, _, params = _pair(seed_t, vocab=32, d_model=32, n_heads=2,
                              n_layers=2, d_ff=64)
    _, dcfg, _, dparams = _pair(seed_d, vocab=32, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32)
    return cfg, params, dcfg, dparams


def _tokens(vocab, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int64))


def test_speculative_equals_target_greedy():
    cfg, params, dcfg, dparams = _models()
    prompt = _tokens(cfg.vocab, (2, 8), 2)
    for t_new, k in [(6, 2), (5, 4), (1, 3), (4, 1)]:
        spec = speculative.make_speculative_generate_fn(
            cfg, dcfg, max_new_tokens=t_new, k_draft=k)
        greedy = decode.make_generate_fn(cfg, max_new_tokens=t_new)
        assert torch.equal(spec(params, dparams, prompt),
                           greedy(params, prompt)), (t_new, k)


def test_speculative_with_perfect_draft():
    cfg, params, _, _ = _models()
    prompt = _tokens(cfg.vocab, (1, 6), 3)
    spec = speculative.make_speculative_generate_fn(
        cfg, cfg, max_new_tokens=7, k_draft=3, return_stats=True)
    out, rounds = spec(params, params, prompt)
    greedy = decode.make_generate_fn(cfg, max_new_tokens=7)
    assert torch.equal(out, greedy(params, prompt))
    floor = -(-7 // 4)
    assert floor <= int(rounds) <= floor + 2, int(rounds)


def test_speculative_validates_args():
    cfg, params, dcfg, dparams = _models()
    with pytest.raises(ValueError, match="max_new_tokens"):
        speculative.make_speculative_generate_fn(
            cfg, dcfg, max_new_tokens=0, k_draft=2)
    with pytest.raises(ValueError, match="k_draft"):
        speculative.make_speculative_generate_fn(
            cfg, dcfg, max_new_tokens=2, k_draft=0)
    with pytest.raises(ValueError, match="vocab"):
        speculative.make_speculative_generate_fn(
            cfg, tfm.tiny_config(vocab=99), max_new_tokens=2, k_draft=2)
    spec = speculative.make_speculative_generate_fn(
        cfg, dcfg, max_new_tokens=2, k_draft=4)
    with pytest.raises(ValueError, match="verification window"):
        spec(params, dparams, torch.zeros((1, 3), dtype=torch.long))


def test_sampled_speculative_matches_exact_target_distribution():
    """temperature > 0: the output distribution of 2 generated tokens
    over many seeded runs against the exactly enumerated target joint."""
    _, cfg, _, params = _pair(0, vocab=4, d_model=16, n_heads=2,
                              n_layers=1, d_ff=32)
    _, dcfg, _, dparams = _pair(1, vocab=4, d_model=8, n_heads=1,
                                n_layers=1, d_ff=16)
    prompt = torch.tensor([[1, 2, 3]])
    t_new, k, temp = 2, 2, 1.0
    exact = np.zeros((cfg.vocab, cfg.vocab))
    lp1 = torch.log_softmax(tfm.forward(params, prompt, cfg)[0, -1] / temp,
                            -1)
    for t1 in range(cfg.vocab):
        ext = torch.cat([prompt, torch.tensor([[t1]])], dim=1)
        lp2 = torch.log_softmax(tfm.forward(params, ext, cfg)[0, -1] / temp,
                                -1)
        for t2 in range(cfg.vocab):
            exact[t1, t2] = float(torch.exp(lp1[t1] + lp2[t2]))
    np.testing.assert_allclose(exact.sum(), 1.0, rtol=1e-5)

    spec = speculative.make_speculative_generate_fn(
        cfg, dcfg, max_new_tokens=t_new, k_draft=k, temperature=temp)
    n_samples = 4096
    gen = torch.Generator().manual_seed(7)
    emp = np.zeros_like(exact)
    for _ in range(n_samples):
        t1, t2 = spec(params, dparams, prompt, gen)[0, -t_new:].tolist()
        emp[t1, t2] += 1.0 / n_samples
    # Per-cell binomial sd <= sqrt(0.25/n) ~ 0.008; 3.5 sigma ~ 0.03.
    np.testing.assert_allclose(emp, exact, atol=0.03)


def test_sampled_speculative_validates_temperature():
    cfg, params, dcfg, dparams = _models()
    with pytest.raises(ValueError, match="temperature"):
        speculative.make_speculative_generate_fn(
            cfg, dcfg, max_new_tokens=2, k_draft=2, temperature=-1.0)
    spec = speculative.make_speculative_generate_fn(
        cfg, dcfg, max_new_tokens=2, k_draft=2, temperature=0.7)
    with pytest.raises(ValueError, match="rng"):
        spec(params, dparams, torch.zeros((1, 4), dtype=torch.long))


def test_speculative_eos_equals_target_greedy_eos():
    _, cfg, _, params = _pair(0, vocab=5, d_model=32, n_heads=2,
                              n_layers=2, d_ff=64)
    _, dcfg, _, dparams = _pair(5, vocab=5, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32)
    # Seed chosen so one row emits EOS after its first token and the
    # other never does.
    prompt = _tokens(cfg.vocab, (2, 5), 112)
    eos, t_new = 0, 8
    ref = decode.make_generate_fn(cfg, max_new_tokens=t_new, eos_id=eos)(
        params, prompt)
    gen = ref[:, 5:].tolist()
    assert any(eos in row for row in gen), gen  # seeds still valid
    assert any(eos not in row for row in gen), gen
    for draft, draft_cfg in ((dparams, dcfg), (params, cfg)):
        spec = speculative.make_speculative_generate_fn(
            cfg, draft_cfg, max_new_tokens=t_new, k_draft=3, eos_id=eos)
        assert torch.equal(spec(params, draft, prompt), ref)


def test_greedy_speculative_matches_jax_greedy_target():
    jcfg, cfg, jp, tp = _pair(40, vocab=16, d_model=32, n_heads=4,
                              n_layers=2, d_ff=64)
    _, dcfg, _, dp = _pair(41, vocab=16, d_model=16, n_heads=2, n_layers=1,
                           d_ff=32)
    prompt = np.random.default_rng(42).integers(0, 16, (4, 6)).astype(
        np.int32)
    want = jdecode.make_generate_fn(jcfg, max_new_tokens=5)(
        jp, jnp.asarray(prompt))
    got = speculative.make_speculative_generate_fn(
        cfg, dcfg, max_new_tokens=5, k_draft=3)(
        tp, dp, torch.from_numpy(prompt.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_speculative_is_refused():
    cfg, _, dcfg, _ = _models()
    with pytest.raises(NotImplementedError, match="item 8"):
        speculative.make_speculative_generate_fn(
            cfg, dcfg, max_new_tokens=2, mesh=object())
