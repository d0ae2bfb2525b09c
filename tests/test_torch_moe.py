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

"""The port's MoE FFN (``rayfed_tpu_torch.models.moe``) against
``rayfed_tpu.models.moe`` on the same weights (the JAX init, carried over
through numpy) and the same numpy tokens. f32 is held at 1e-5 and bf16 at
the 2e-2 of the transformer tests: the port's GELU rounds each op of the
tanh formula as XLA does (bitwise in bf16, held by its own test), but the
port's products sum in other orders than XLA's einsums. Routing is held exactly: the chosen experts, including on planted ties."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu.models import moe as jmoe
from rayfed_tpu_torch.models import moe

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_TOL = 2e-2
D, F, E = 16, 32, 4


def _weights(seed=0, d=D, f=F, e=E):
    return jax.tree_util.tree_map(
        np.array, jmoe.init_moe_ffn(jax.random.PRNGKey(seed), d, f, e))


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _as(dtype, tree):
    """A numpy tree as (jax arrays, torch tensors) in ``dtype``."""
    if dtype == "bf16":
        tree = jax.tree_util.tree_map(lambda x: x.astype(ml_dtypes.bfloat16),
                                      tree)

    def to_torch(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())

    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(to_torch, tree))


def _pair(dtype, weights, x):
    """(jax weights, jax x, torch weights, torch x) in ``dtype``."""
    jw, tw = _as(dtype, weights)
    jx, tx = _as(dtype, {"x": x})
    return jw, jx["x"], tw, tx["x"]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _apply(kind, mod, params, x):
    if kind == "top1":
        return mod.moe_ffn_apply(params, x, top1=True)
    if kind == "dense":
        return mod.moe_ffn_apply(params, x, top1=False)
    return mod.moe_ffn_apply_topk(params, x, k=2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["top1", "dense", "top2"])
def test_moe_ffn_matches_reference(kind, dtype):
    jp, jx, tp, tx = _pair(dtype, _weights(), _tokens((2, 12, D)))
    want = _apply(kind, jmoe, jp, jx)
    got = _apply(kind, moe, tp, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, F32_TOL if dtype == "f32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["top1", "top2"])
def test_moe_ffn_gradients_match_reference(kind, dtype):
    jp, jx, tp, tx = _pair(dtype, _weights(2), _tokens((2, 12, D), seed=3))
    cot = _tokens((2, 12, D), seed=4)

    def jloss(p, x):
        return jnp.sum(_apply(kind, jmoe, p, x).astype(jnp.float32) * cot)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx.requires_grad_(True)
    (_apply(kind, moe, tp, tx).float() * torch.from_numpy(cot)).sum().backward()
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    # Scale-free: each gradient against its own largest entry.
    for name in ("router", "w_up", "w_down"):
        want = np.asarray(jg_p[name], np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        _close(tp[name].grad / scale, want / scale, tol)
    want = np.asarray(jg_x, np.float32)
    _close(tx.grad / max(1.0, float(np.abs(want).max())),
           want / max(1.0, float(np.abs(want).max())), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
def test_load_balance_loss_and_gradient_match_reference(k, dtype):
    jp, jx, tp, tx = _pair(dtype, _weights(5), _tokens((3, 10, D), seed=6))
    want, jg = jax.value_and_grad(jmoe.load_balance_loss)(jp, jx, k)
    tp = {n: v.requires_grad_(True) for n, v in tp.items()}
    got = moe.load_balance_loss(tp, tx, k)
    got.backward()
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=tol)
    _close(tp["router"].grad, jg["router"], tol)


def test_planted_ties_route_to_the_lower_expert():
    # Experts 1 and 2 (and, for top-k, 5 and 6) get identical router
    # columns: every token's probabilities tie there, in f32 and in the
    # bf16 logits alike. argmax and top-k must take the lower index, as
    # jnp.argmax and lax.top_k do.
    d, e = 8, 8
    w = _weights(7, d=d, f=16, e=e)
    w["router"][:, 1] = 0.5  # experts 1 and 2 first for every token,
    w["router"][:, 2] = w["router"][:, 1]
    w["router"][:, 5] = 0.25  # 5 and 6 tied in third place
    w["router"][:, 6] = w["router"][:, 5]
    x = _tokens((64, d), seed=8)
    x = np.abs(x)  # the shifted columns dominate every token
    for dtype in ("f32", "bf16"):
        jp, jx, tp, tx = _pair(dtype, w, x)
        probs = moe._router_probs(tp, tx)
        assert bool((probs[:, 1] == probs[:, 2]).all())
        top1 = moe._gates(tp, tx, top1=True)
        assert bool((top1[:, 1] > 0).all()) and bool((top1[:, 2] == 0).all())
        tol = F32_TOL if dtype == "f32" else BF16_TOL
        gates = [(top1, jmoe._gates(jp, jx, top1=True))] + [
            (moe.topk_gates(tp, tx, kk), jmoe.topk_gates(jp, jx, kk))
            for kk in (1, 2, 3, 5, 6)]
        for got, want in gates:
            want = np.asarray(want, np.float32)
            # The same experts exactly; the gate values to the tolerance
            # (the softmaxes round differently in the last bit).
            np.testing.assert_array_equal(got.float().numpy() > 0, want > 0)
            _close(got, want, tol)
        for kk in (1, 2, 3):
            assert float(moe.load_balance_loss(tp, tx, kk)) == pytest.approx(
                float(jmoe.load_balance_loss(jp, jx, kk)), rel=F32_TOL)
        # Ties at the k-th place: k = 1 keeps expert 1 and drops 2, k = 3
        # keeps 1, 2 and 5 and drops 6.
        kept = moe.topk_gates(tp, tx, 3)
        assert bool((kept[:, [1, 2, 5]] > 0).all())
        assert bool((kept[:, 6] == 0).all())


def test_topk_gates_and_loss():
    # The mirror of tests/test_pipeline_moe.py::test_topk_gates_and_loss,
    # on its weights and tokens (the JAX draws, carried over).
    d, f, e = 8, 16, 4
    params = _as("f32", _weights(6, d=d, f=f, e=e))[1]
    x = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(7), (32, d))).copy())
    g = moe.topk_gates(params, x, k=2).numpy()
    assert ((g > 0).sum(axis=-1) == 2).all()
    np.testing.assert_allclose(g.sum(axis=-1), 1.0, rtol=1e-5)
    g_all = moe.topk_gates(params, x, k=e).numpy()
    assert ((g_all > 0).sum(axis=-1) == e).all()

    out = moe.moe_ffn_apply_topk(params, x, k=2)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())

    lb = float(moe.load_balance_loss(params, x))
    lb2 = float(moe.load_balance_loss(params, x, k=2))
    assert lb2 >= 1.0 - 1e-6, lb2
    assert lb >= 1.0 - 1e-6, lb
    uniform = dict(params, router=torch.zeros_like(params["router"]))
    np.testing.assert_allclose(float(moe.load_balance_loss(uniform, x)), 1.0,
                               rtol=1e-5)
    router = params["router"].clone().requires_grad_(True)
    moe.load_balance_loss(dict(params, router=router), x).backward()
    assert bool(torch.isfinite(router.grad).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu_matches_jax_nn_gelu(dtype):
    x = _tokens((4096,), seed=11) * 3
    jx, tx = _as(dtype, {"x": x})
    want = np.asarray(jax.nn.gelu(jx["x"]), np.float32)
    got = moe.gelu(tx["x"])
    if dtype == "bf16":  # XLA's op-by-op rounding, bit for bit
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        _close(got, want, F32_TOL)
    # The backward from the saved input alone, against JAX's autodiff.
    t = tx["x"].clone().requires_grad_(True)
    moe.gelu(t).float().sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jax.nn.gelu(v).astype(jnp.float32)))(jx["x"])
    _close(t.grad, jg, F32_TOL if dtype == "f32" else BF16_TOL)


def test_init_moe_ffn_matches_reference_shapes_and_scales():
    want = _weights(0, d=64, f=128, e=8)
    got = moe.init_moe_ffn(torch.Generator().manual_seed(0), 64, 128, 8,
                           device="cpu")
    assert list(got) == ["router", "w_up", "w_down"]
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        assert got[name].dtype == torch.float32
        # Same scales: the stds agree to sampling error.
        np.testing.assert_allclose(float(got[name].std()), float(w.std()),
                                   rtol=0.1)
    bf = moe.init_moe_ffn(0, 8, 16, 2, dtype=torch.bfloat16, device="cpu")
    assert {v.dtype for v in bf.values()} == {torch.bfloat16}


def test_expert_ffn_core_matches_reference():
    w = _weights(9)
    toks = _tokens((E, 5, D), seed=10)
    want = jmoe._expert_ffn(jnp.asarray(w["w_up"]), jnp.asarray(w["w_down"]),
                            jnp.asarray(toks))
    got = moe._expert_ffn(torch.from_numpy(w["w_up"]),
                          torch.from_numpy(w["w_down"]), torch.from_numpy(toks))
    _close(got, want, F32_TOL)


def test_expert_ffn_core_on_shared_tokens_matches_reference():
    # The dense lane's form: every expert reads the same (T, d) tokens,
    # against the reference's core on the tokens broadcast to (E, T, d).
    w = _weights(11)
    toks = _tokens((5, D), seed=12)
    want = jmoe._expert_ffn(jnp.asarray(w["w_up"]), jnp.asarray(w["w_down"]),
                            jnp.broadcast_to(jnp.asarray(toks), (E, 5, D)))
    got = moe._expert_ffn(torch.from_numpy(w["w_up"]),
                          torch.from_numpy(w["w_down"]), torch.from_numpy(toks))
    assert tuple(got.shape) == (E, 5, D)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("make", [moe.make_ep_moe_apply,
                                  moe.make_a2a_moe_apply])
def test_expert_mesh_lanes_raise_naming_item_13b(make):
    with pytest.raises(NotImplementedError, match="item 13b"):
        make(None)
