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

"""The port's transformer against ``rayfed_tpu.models.transformer`` on the
same params (the JAX init, carried over by ``params_from_numpy``) and the
same numpy tokens. f32 compute is held at 1e-5; bf16 compute at the 2e-2
of ``test_transformer_forward_with_flash_attn``.

bf16 logits are held against the reference's blocks run op by op, which
rounds every bf16 op as the port does. The scan-compiled reference forward
lets XLA keep f32 between fused ops (``xla_allow_excess_precision``), so
its bf16 logits differ from its own op-by-op evaluation by more than
2e-2 in a few elements; against it the port is held on the loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.ops.flash_attention import make_flash_attn_fn as j_flash_fn
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.ops.flash_attention import make_flash_attn_fn

# The suite runs in several worker processes on one host: a small torch
# thread pool keeps these tests from starving timing-sensitive ones.
torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _configs(dtype, **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jtfm.tiny_config(compute_dtype=jdt, **kw),
            tfm.tiny_config(compute_dtype=tdt, **kw))


def _shared_params(jcfg, seed=0):
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = tfm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"
    )
    return jparams, tparams


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=tol, atol=tol,
    )


def _jax_forward_op_by_op(params, tokens, cfg, attn_fn=None):
    """``jtfm.forward`` with its layers run one by one outside ``scan``."""
    b, s = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(s), (b, s))
    x = params["embed"][tokens].astype(cfg.compute_dtype)
    for i in range(cfg.n_layers):
        layer = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
        x = jtfm.layer_fn(x, layer, positions, cfg, attn_fn)
    x = jtfm.rms_norm(x, params["ln_f"])
    return (x @ params["lm_head"].astype(cfg.compute_dtype)).astype(jnp.float32)


@pytest.mark.parametrize("dtype,attn", [
    ("f32", "xla"), ("f32", "flash"), ("bf16", "xla"), ("bf16", "flash"),
])
def test_forward_logits_match_reference(dtype, attn):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _shared_params(jcfg)
    toks = _tokens(jcfg.vocab, (2, 32))
    jfn = j_flash_fn(block_q=16, block_k=16) if attn == "flash" else None
    tfn = make_flash_attn_fn(block_q=16, block_k=16) if attn == "flash" else None
    forward = jtfm.forward if dtype == "f32" else _jax_forward_op_by_op
    want = forward(jparams, jnp.asarray(toks), jcfg, attn_fn=jfn)
    got = tfm.forward(tparams, torch.from_numpy(toks).long(), tcfg, attn_fn=tfn)
    assert got.dtype == torch.float32 and got.shape == (2, 32, jcfg.vocab)
    _close(got, want, F32_TOL if dtype == "f32" else BF16_TOL)


@pytest.mark.parametrize("loss_chunk", [None, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_loss_pair_matches_reference(dtype, loss_chunk):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _shared_params(jcfg)
    toks = _tokens(jcfg.vocab, (2, 33))
    want = jtfm.lm_loss_pair(jparams, jnp.asarray(toks[:, :-1]),
                             jnp.asarray(toks[:, 1:]), jcfg,
                             loss_chunk=loss_chunk)
    t = torch.from_numpy(toks).long()
    got = tfm.lm_loss_pair(tparams, t[:, :-1], t[:, 1:], tcfg,
                           loss_chunk=loss_chunk)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=tol)
    # lm_loss is the same pair on a (B, S+1) block.
    assert float(tfm.lm_loss(tparams, t, tcfg)) == pytest.approx(
        float(tfm.lm_loss_pair(tparams, t[:, :-1], t[:, 1:], tcfg)), abs=0)


def test_grads_match_reference_f32():
    jcfg, tcfg = _configs("f32")
    jparams, tparams = _shared_params(jcfg)
    toks = _tokens(jcfg.vocab, (2, 33))
    jgrads = jax.grad(jtfm.lm_loss)(jparams, jnp.asarray(toks), jcfg)
    tparams = jax.tree_util.tree_map(lambda p: p.requires_grad_(True), tparams)
    tfm.lm_loss(tparams, torch.from_numpy(toks).long(), tcfg).backward()
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    got = jax.tree_util.tree_map(lambda p: p.grad, tparams)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, got))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(g, w, F32_TOL)


def test_remat_and_chunking_leave_loss_and_grads_unchanged():
    _, tcfg = _configs("f32")
    tparams = tfm.init_params(0, tcfg, device="cpu")
    t = torch.from_numpy(_tokens(tcfg.vocab, (2, 33))).long()
    results = []
    for remat, chunk in ((False, None), (True, None), (True, 8)):
        ps = jax.tree_util.tree_map(
            lambda p: p.detach().clone().requires_grad_(True), tparams)
        loss = tfm.lm_loss_pair(ps, t[:, :-1], t[:, 1:], tcfg,
                                attn_fn=make_flash_attn_fn(), remat=remat,
                                loss_chunk=chunk)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in jax.tree_util.tree_leaves(ps)]))
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        torch.testing.assert_close(loss, base_loss, rtol=1e-6, atol=1e-6)
        for g, b in zip(grads, base_grads):
            torch.testing.assert_close(g, b, rtol=1e-5, atol=1e-6)


def test_weight_carrier_keeps_paths_layouts_and_bits():
    jcfg, tcfg = _configs("f32")
    jparams, tparams = _shared_params(jcfg)
    assert tparams["layers"]["wq"].shape == (jcfg.n_layers, 64, 4, 16)
    assert tparams["layers"]["wo"].shape == (jcfg.n_layers, 4, 16, 64)
    back = tfm.params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat_b) == {p for p, _ in flat_j}
    for path, arr in flat_j:
        assert flat_b[path].dtype == arr.dtype
        np.testing.assert_array_equal(flat_b[path], arr)
    # bf16 leaves keep their bits both ways.
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = tfm.params_from_numpy({"x": bf}, device="cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(tfm.params_to_numpy({"x": t})["x"], bf)


def test_init_params_matches_reference_shapes():
    jcfg, tcfg = _configs("f32")
    jshapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape), jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    tshapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape), tfm.init_params(0, tcfg, device="cpu"))
    assert tshapes == jshapes


def test_unported_options_raise():
    # What stays refused: the expert-mesh MoE lanes (item 13b). n_experts
    # > 0 and remat="attn" run (the MoE and remat tests here).
    from rayfed_tpu_torch.models import moe

    for make in (moe.make_ep_moe_apply, moe.make_a2a_moe_apply):
        with pytest.raises(NotImplementedError, match="item 13b"):
            make(None)
    _, tcfg = _configs("f32")
    params = tfm.init_params(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="remat must be"):
        tfm.forward(params, torch.zeros((1, 8), dtype=torch.long), tcfg,
                    remat="layers")


@pytest.mark.parametrize("dtype,attn", [
    ("f32", "xla"), ("f32", "flash"), ("bf16", "xla"), ("bf16", "flash"),
])
def test_moe_forward_and_loss_match_reference(dtype, attn):
    jcfg, tcfg = _configs(dtype, n_experts=4)
    jparams, tparams = _shared_params(jcfg, seed=3)
    assert set(tparams["layers"]["moe"]) == {"router", "w_up", "w_down"}
    assert tparams["layers"]["moe"]["w_up"].shape == (jcfg.n_layers, 4, 64, 176)
    toks = _tokens(jcfg.vocab, (2, 33), seed=4)
    jfn = j_flash_fn(block_q=16, block_k=16) if attn == "flash" else None
    tfn = make_flash_attn_fn(block_q=16, block_k=16) if attn == "flash" else None
    forward = jtfm.forward if dtype == "f32" else _jax_forward_op_by_op
    t = torch.from_numpy(toks).long()
    want = forward(jparams, jnp.asarray(toks[:, :-1]), jcfg, attn_fn=jfn)
    got = tfm.forward(tparams, t[:, :-1], tcfg, attn_fn=tfn)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    _close(got, want, tol)
    want = jtfm.lm_loss_pair(jparams, jnp.asarray(toks[:, :-1]),
                             jnp.asarray(toks[:, 1:]), jcfg, attn_fn=jfn)
    got = tfm.lm_loss_pair(tparams, t[:, :-1], t[:, 1:], tcfg, attn_fn=tfn)
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=tol)


def test_moe_grads_match_reference_f32():
    jcfg, tcfg = _configs("f32", n_experts=4)
    jparams, tparams = _shared_params(jcfg, seed=5)
    toks = _tokens(jcfg.vocab, (2, 33), seed=6)
    jgrads = jax.grad(jtfm.lm_loss)(jparams, jnp.asarray(toks), jcfg)
    tparams = jax.tree_util.tree_map(lambda p: p.requires_grad_(True), tparams)
    tfm.lm_loss(tparams, torch.from_numpy(toks).long(), tcfg).backward()
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jgrads)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda p: p.grad, tparams)))
    assert set(got) == set(want)
    for path, w in want.items():
        _close(got[path], w, F32_TOL)
    # The router learns: top-1 gates carry the gradient to it.
    assert float(np.abs(want[next(p for p in want if "router" in
                                  jax.tree_util.keystr(p))]).sum()) > 0


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal cannot show")
    _, tcfg = _configs("f32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(0, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.params_from_numpy({"x": np.zeros(2, np.float32)})
