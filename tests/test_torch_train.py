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

"""The port's local train step against ``make_fed_train_step`` of the JAX
package: one-device mesh, ``attn="flash"`` (Pallas in interpret mode), f32
compute, the same params (JAX init through numpy) and the same batches.

Tolerances: the losses agree to 1e-5 (f32 forward, summation order only).
Params after AdamW agree to 1% of one step's learning rate, absolute:
optax and torch round the same update formula in different orders, and
Adam divides each gradient by its own running magnitude, so an entry whose
gradient is near zero (an embedding row its batch barely touches) turns a
last-bit gradient difference into a visible share of its step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.parallel.train import make_fed_train_step as j_make_step
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.parallel.train import make_fed_train_step

# The suite runs in several worker processes on one host: a small torch
# thread pool keeps these tests from starving timing-sensitive ones.
torch.set_num_threads(2)

LOSS_TOL = 1e-5
LR = 1e-2
PARAM_TOL = 1e-2 * LR


def _jax_cfg():
    return jtfm.tiny_config(compute_dtype=jnp.float32)


def _torch_cfg(**kw):
    return tfm.tiny_config(compute_dtype=torch.float32, **kw)


def _batches(n, vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(4, 33)).astype(np.int32) for _ in range(n)]


def _run_jax(n_steps, accum_steps=1, remat=False):
    cfg = _jax_cfg()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    init_fn, step_fn = j_make_step(cfg, mesh, party_axis=None,
                                   data_axis="data", attn="flash", lr=LR,
                                   accum_steps=accum_steps, remat=remat)
    batches = _batches(n_steps, cfg.vocab)
    params, opt = init_fn(jax.random.PRNGKey(0), jnp.asarray(batches[0][:, :-1]))
    init = jax.tree_util.tree_map(np.asarray, params)
    losses = []
    for blk in batches:
        params, opt, loss = step_fn(params, opt, jnp.asarray(blk[:, :-1]),
                                    jnp.asarray(blk[:, 1:]))
        losses.append(float(loss))
    return init, losses, jax.tree_util.tree_map(np.asarray, params), batches


def _run_torch(init, batches, **kw):
    init_fn, step_fn = make_fed_train_step(_torch_cfg(), device="cpu",
                                           attn="flash", lr=LR, **kw)
    params, opt = init_fn(init)
    losses = []
    for blk in batches:
        params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        losses.append(float(loss))
    return losses, tfm.params_to_numpy(params)


def _assert_params_close(got, want):
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(flat_g[path], w, rtol=0, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_reference(n_steps):
    init, jlosses, jparams, batches = _run_jax(n_steps)
    tlosses, tparams = _run_torch(init, batches)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params_close(tparams, jparams)


def test_grad_accumulation_matches_reference():
    init, jlosses, jparams, batches = _run_jax(1, accum_steps=2)
    tlosses, tparams = _run_torch(init, batches, accum_steps=2)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params_close(tparams, jparams)


def test_remat_on_and_off_agree():
    batches = _batches(2, 256)
    init = tfm.params_to_numpy(tfm.init_params(0, _torch_cfg(), device="cpu"))
    off_losses, off = _run_torch(init, batches, remat=False)
    on_losses, on = _run_torch(init, batches, remat=True)
    assert on_losses == off_losses
    for a, b in zip(jax.tree_util.tree_leaves(on), jax.tree_util.tree_leaves(off)):
        np.testing.assert_array_equal(a, b)


def test_remat_attn_agrees_with_on_and_off_and_the_reference():
    batches = _batches(2, 256)
    init = tfm.params_to_numpy(tfm.init_params(0, _torch_cfg(), device="cpu"))
    off_losses, off = _run_torch(init, batches, remat=False)
    attn_losses, attn = _run_torch(init, batches, remat="attn")
    assert attn_losses == off_losses
    for a, b in zip(jax.tree_util.tree_leaves(attn),
                    jax.tree_util.tree_leaves(off)):
        np.testing.assert_array_equal(a, b)
    # Against the JAX package's train step under its remat="attn" policy.
    init, jlosses, jparams, batches = _run_jax(2, remat="attn")
    tlosses, tparams = _run_torch(init, batches, remat="attn")
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params_close(tparams, jparams)


def _k1_per_layer_in_jax_grad(remat):
    """How often the JAX package's gradient runs its forward kernel per
    layer: the pallas_calls with an f32 (lse) output in the scan body of
    its grad jaxpr, at bf16 compute (where only the forward has one)."""
    from rayfed_tpu.ops.flash_attention import make_flash_attn_fn as j_flash

    cfg = jtfm.tiny_config()
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    blk = jnp.asarray(_batches(1, cfg.vocab)[0])
    jaxpr = jax.make_jaxpr(jax.grad(lambda p: jtfm.lm_loss_pair(
        p, blk[:, :-1], blk[:, 1:], cfg, j_flash(), remat=remat)))(params)
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(any(v.aval.dtype == jnp.float32
                                 for v in eqn.outvars))
            for param in eqn.params.values():
                for sub in (param if isinstance(param, (list, tuple))
                            else [param]):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr.jaxpr)
    return sum(found)


@pytest.mark.parametrize("remat,port_k1,jax_k1", [
    (False, 1, 1), (True, 2, 2), ("attn", 1, 2)])
def test_remat_attn_runs_the_forward_kernel_once(remat, port_k1, jax_k1):
    # The port's "attn" keeps the flash forward's O and lse, so its
    # backward never runs the forward again; the JAX package's policy saves
    # attn_out but not the lse residual of its custom_vjp, so its backward
    # runs the forward kernel again, as remat=True does.
    from rayfed_tpu_torch.ops import flash_attention as fa

    cfg = _torch_cfg()
    params = tree_util.tree_map(lambda p: p.requires_grad_(True),
                                tfm.init_params(0, cfg, device="cpu"))
    blk = torch.from_numpy(_batches(1, cfg.vocab)[0]).long()
    calls = []
    plain = fa._flash_fwd_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    fa._flash_fwd_plain = counted
    try:
        tfm.lm_loss_pair(params, blk[:, :-1], blk[:, 1:], cfg,
                         fa.make_flash_attn_fn(), remat=remat).backward()
    finally:
        fa._flash_fwd_plain = plain
    assert len(calls) == port_k1 * cfg.n_layers
    assert _k1_per_layer_in_jax_grad(remat) == jax_k1


@pytest.mark.parametrize("flash,copies", [(False, 1), (True, 2)])
def test_remat_attn_keeps_the_attention_output_of_any_attn_fn(flash, copies):
    # The reference names attn_out under any attn_fn. Under the dense
    # attention the port keeps its attn_out copy, made once a layer in the
    # forward; under flash it keeps the kernel's O and lse instead and
    # makes the copy again from them in the backward. Either way the loss
    # and gradients are remat=False's, bit for bit.
    from torch.utils._python_dispatch import TorchDispatchMode

    from rayfed_tpu_torch.ops import flash_attention as fa

    class Executed(TorchDispatchMode):
        """Counts the ops that run; ops a selective checkpoint serves from
        what it kept never reach it."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    cfg = _torch_cfg()
    init = tfm.init_params(0, cfg, device="cpu")
    blk = torch.from_numpy(_batches(1, cfg.vocab)[0]).long()
    attn_fn = fa.make_flash_attn_fn() if flash else None
    got = {}
    for remat in (False, "attn"):
        params = tree_util.tree_map(
            lambda p: p.detach().clone().requires_grad_(True), init)
        with Executed() as ran:
            loss = tfm.lm_loss_pair(params, blk[:, :-1], blk[:, 1:], cfg,
                                    attn_fn, remat=remat)
            loss.backward()
        got[remat] = (ran.ops, [loss.detach()] + [
            p.grad for p in tree_util.tree_flatten(params)[0]])
    ops = got["attn"][0]
    assert ops.count(torch.ops.rayfed_tpu_torch.attn_out.default) == (
        copies * cfg.n_layers)
    assert ops.count(torch.ops.rayfed_tpu_torch.flash_fwd.default) == (
        cfg.n_layers if flash else 0)
    for a, b in zip(got["attn"][1], got[False][1]):
        assert torch.equal(a, b)


def test_donate_updates_in_place_and_copy_leaves_inputs():
    blk = _batches(1, 256)[0]
    init = tfm.params_to_numpy(tfm.init_params(0, _torch_cfg(), device="cpu"))
    for donate in (True, False):
        init_fn, step_fn = make_fed_train_step(_torch_cfg(), device="cpu",
                                               lr=LR, donate=donate)
        params, opt = init_fn(init)
        before = tfm.params_to_numpy(params)
        before = jax.tree_util.tree_map(np.copy, before)
        new_params, new_opt, _ = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        if donate:
            assert new_params is params and new_opt is opt
        else:
            assert new_params is not params and new_opt is not opt
            np.testing.assert_array_equal(
                tfm.params_to_numpy(params)["embed"], before["embed"])
            assert not opt.state  # the input optimizer took no step
            # A second step from the copies continues their moments.
            _, opt2, _ = step_fn(new_params, new_opt, blk[:, :-1], blk[:, 1:])
            first = opt2.param_groups[0]["params"][0]
            assert int(opt2.state[first]["step"]) == 2
        assert not np.array_equal(
            tfm.params_to_numpy(new_params)["embed"], before["embed"])


def test_init_from_seed_and_auto_attention_on_cpu():
    cfg = _torch_cfg()
    init_fn, step_fn = make_fed_train_step(cfg, device="cpu")
    params, opt = init_fn(0)
    leaves = tree_util.tree_flatten(params)[0]
    assert all(p.requires_grad and p.device.type == "cpu" for p in leaves)
    assert len(opt.param_groups[0]["params"]) == len(leaves)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.95), 1e-8, 0.01)
    blk = _batches(1, cfg.vocab)[0]
    _, _, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
    assert loss.shape == () and np.isfinite(float(loss))


def test_sharded_options_raise_and_name_the_later_slice():
    cfg = _torch_cfg()
    for kw in ({"seq_axis": "seq"}, {"model_axis": "model"},
               {"shard_opt_state": True}):
        with pytest.raises(NotImplementedError, match="slice"):
            make_fed_train_step(cfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="attn"):
        make_fed_train_step(cfg, device="cpu", attn="ring")


def test_train_step_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fed_train_step(_torch_cfg())
