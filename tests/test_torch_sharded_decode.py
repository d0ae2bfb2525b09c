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

"""The port's sharded decoding (``mesh=``) on 4 gloo ranks, data 2 x
model 2, mirroring the sharded cases of ``tests/test_decode.py`` and
``tests/test_speculative.py`` with their configs and keys: greedy
generation, beam search and greedy speculative decoding give the port's
unsharded tokens and the JAX package's sharded tokens (its 4-device CPU
mesh of the same axes), in f32; sampled speculative decoding gives the
unsharded run's tokens for the same threefry key. Beam scores are held to
the reference's ``rtol`` 1e-5, ``atol`` 1e-6. The ranks are spawned once
for the file (``tests/torch_mesh.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from rayfed_tpu.models import decode as jdecode
from rayfed_tpu.models import speculative as jspec
from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.parallel import sharding as jshd
from tests.torch_mesh import WORLD, case_result, run_ranks

SPEC_CFG = dict(vocab=16, d_model=32, n_heads=4, n_layers=2, d_ff=64)
SPEC_DCFG = dict(vocab=16, d_model=16, n_heads=2, n_layers=1, d_ff=32)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _cfg(**kw):
    return jtfm.tiny_config(compute_dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def cases():
    """Each case's inputs and the JAX package's sharded result."""
    devices = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, ("data", "model"))
    out = {}

    cfg = _cfg(n_heads=4)
    params = jtfm.init_params(jax.random.PRNGKey(20), cfg)
    prompt = jax.random.randint(jax.random.PRNGKey(21), (4, 6), 0, cfg.vocab)
    gen = jdecode.make_generate_fn(cfg, max_new_tokens=5, mesh=mesh)
    out["generate"] = dict(
        cfg={"n_heads": 4}, params=_np(params), prompt=np.asarray(prompt),
        jax=np.asarray(gen(jshd.shard_params(mesh, params), prompt)))

    params = jtfm.init_params(jax.random.PRNGKey(30), cfg)
    prompt = jax.random.randint(jax.random.PRNGKey(31), (4, 6), 0, cfg.vocab)
    bs = jdecode.make_beam_search_fn(cfg, max_new_tokens=4, n_beams=3,
                                     eos_id=0, mesh=mesh)
    seqs, scores = bs(jshd.shard_params(mesh, params), prompt)
    out["beam"] = dict(
        cfg={"n_heads": 4}, params=_np(params), prompt=np.asarray(prompt),
        jax=(np.asarray(seqs), np.asarray(scores)))

    tcfg, dcfg = _cfg(**SPEC_CFG), _cfg(**SPEC_DCFG)
    params = jtfm.init_params(jax.random.PRNGKey(40), tcfg)
    dparams = jtfm.init_params(jax.random.PRNGKey(41), dcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(42), (4, 6), 0, tcfg.vocab)
    spec = jspec.make_speculative_generate_fn(
        tcfg, dcfg, max_new_tokens=5, k_draft=3, mesh=mesh)
    out["speculative"] = dict(
        cfg=SPEC_CFG, dcfg=SPEC_DCFG, params=_np(params),
        dparams=_np(dparams), prompt=np.asarray(prompt),
        kw={"max_new_tokens": 5, "k_draft": 3},
        jax=np.asarray(spec(jshd.shard_params(mesh, params),
                            jshd.shard_params(mesh, dparams), prompt)))

    params = jtfm.init_params(jax.random.PRNGKey(43), tcfg)
    dparams = jtfm.init_params(jax.random.PRNGKey(44), dcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(45), (2, 6), 0, tcfg.vocab)
    out["speculative_sampled"] = dict(
        cfg=SPEC_CFG, dcfg=SPEC_DCFG, params=_np(params),
        dparams=_np(dparams), prompt=np.asarray(prompt),
        kw={"max_new_tokens": 4, "k_draft": 2, "temperature": 1.0,
            "rng": np.asarray(jax.random.PRNGKey(46))},
        jax=None)
    for case in out.values():
        case["prompt"] = case["prompt"].astype(np.int64)
    return out


@pytest.fixture(scope="module")
def ranks(cases):
    payload = {name: {k: v for k, v in case.items() if k != "jax"}
               for name, case in cases.items()}
    return run_ranks(WORLD["decode"], "decode", payload)


def test_sharded_generate_matches_unsharded_and_the_jax_package(ranks, cases):
    res = case_result(ranks, "decode")["generate"]
    np.testing.assert_array_equal(res["tokens"], res["ref_tokens"])
    np.testing.assert_array_equal(res["tokens"], cases["generate"]["jax"])


def test_sharded_beam_search_matches_unsharded_and_the_jax_package(
        ranks, cases):
    res = case_result(ranks, "decode")["beam"]
    jseqs, jscores = cases["beam"]["jax"]
    np.testing.assert_array_equal(res["seqs"], res["ref_seqs"])
    np.testing.assert_array_equal(res["seqs"], jseqs)
    np.testing.assert_allclose(res["scores"], res["ref_scores"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res["scores"], jscores, rtol=1e-5, atol=1e-6)


def test_sharded_speculative_matches_unsharded_and_the_jax_package(
        ranks, cases):
    res = case_result(ranks, "decode")["speculative"]
    np.testing.assert_array_equal(res["tokens"], res["ref_tokens"])
    assert res["rounds"] == res["ref_rounds"]
    np.testing.assert_array_equal(res["tokens"], cases["speculative"]["jax"])


def test_sharded_sampled_speculative_matches_unsharded(ranks, cases):
    res = case_result(ranks, "decode")["speculative_sampled"]
    np.testing.assert_array_equal(res["tokens"], res["ref_tokens"])
    assert res["rounds"] == res["ref_rounds"]
    assert res["tokens"].shape == (2, 10)
    np.testing.assert_array_equal(res["tokens"][:, :6],
                                  cases["speculative_sampled"]["prompt"])


def test_a_second_param_tree_gets_its_own_placements(ranks):
    res = case_result(ranks, "lora")
    np.testing.assert_array_equal(res["base"], res["ref_base"])
    np.testing.assert_array_equal(res["merged"], res["ref_merged"])
    assert not np.array_equal(res["ref_base"], res["ref_merged"])
