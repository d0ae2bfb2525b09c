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

"""The port's sharded train step (``make_fed_train_step`` over a
DeviceMesh) on 8 gloo ranks, party 2 x data 2 x model 2, held against the
JAX package's step on its 8-device CPU mesh of the same axes and against
the port's own one-device step; mirrors ``tests/test_parallel.py``'s dp/tp,
accumulation and ZeRO-1 cases.

The 8 ranks are spawned once for the file (``tests/torch_mesh.py``) and
run every case; each test reads one case's result.

Tolerances (f32 compute): losses within ``LOSS_TOL`` (1e-5) of the JAX
package's; between two runs of the port the reference's own: ``rtol`` 1e-5
on every step's loss, and 2e-5 (rtol and atol) on the first step's
gradient (read from the first AdamW moment) and on the params after it.
AdamW's first update of an entry is ``lr * g / (|g| + eps)``, so where a
gradient entry is within 100 eps of zero a reordered sum's last bits are a
visible share of its update: there the gradient is held, the param is not
(at most a thousandth of the entries; an exact zero is held; ZeRO-1, the
same arithmetic on slices, is held on every entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding

from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.parallel import sharding as jshd
from rayfed_tpu.parallel.train import make_fed_train_step as j_make_step
from tests.torch_mesh import (
    LR,
    PARALLEL_NAMES,
    PARALLEL_SHAPE,
    WORLD,
    case_result,
    run_ranks,
)

LOSS_TOL = 1e-5  # as tests/test_torch_train.py
RTOL_LOSS = 1e-5
PARAM_TOL = 2e-5
ADAM_FLAT = 100 * 1e-8  # 100 x AdamW's eps


def _jax_mesh():
    devices = np.array(jax.devices()[:WORLD["parallel"]]).reshape(
        PARALLEL_SHAPE)
    return Mesh(devices, PARALLEL_NAMES)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's five sharded steps (f32, lr 1e-2) from
    ``PRNGKey(0)`` on the reference test's batch, with its init and batch
    as numpy for the port."""
    mesh = _jax_mesh()
    cfg = jtfm.tiny_config(compute_dtype=jnp.float32)
    init_fn, step_fn = j_make_step(cfg, mesh, lr=LR, attn="xla")
    tokens = jax.random.randint(jax.random.PRNGKey(2), (8, 17), 0, cfg.vocab)
    sharding = NamedSharding(mesh, jshd.batch_spec(mesh))
    inputs = jax.device_put(tokens[:, :-1], sharding)
    targets = jax.device_put(tokens[:, 1:], sharding)
    params, opt = init_fn(jax.random.PRNGKey(0), inputs)
    init = jax.tree_util.tree_map(np.asarray, params)
    losses = []
    for _ in range(5):
        params, opt, loss = step_fn(params, opt, inputs, targets)
        losses.append(float(loss))
    return {"init": init, "losses": losses,
            "inputs": np.asarray(tokens[:, :-1]).astype(np.int64),
            "targets": np.asarray(tokens[:, 1:]).astype(np.int64)}


@pytest.fixture(scope="module")
def ranks(jax_run):
    payload = {k: jax_run[k] for k in ("init", "inputs", "targets")}
    return run_ranks(WORLD["parallel"], "parallel", payload)


def _close_trees(got, want, what, where=None):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    keep = dict(jax.tree_util.tree_leaves_with_path(where)) if where else {}
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = flat[path]
        if path in keep:
            g, w = g[keep[path]], w[keep[path]]
        np.testing.assert_allclose(
            g, w, rtol=PARAM_TOL, atol=PARAM_TOL,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _same_steps(res, well_conditioned=True, want="want"):
    """Two runs' losses, first gradients and params after the first step
    agree. AdamW's first update of an entry is ``lr * g / (|g| + eps)``:
    where ``|g|`` is within ``ADAM_FLAT`` (100 eps) of zero a last-bit
    difference in ``g`` is a visible share of the update, so with
    ``well_conditioned`` the params are held on the other entries, and on
    those whose gradient is zero in both (the gradients are held on
    all)."""
    got, want = res["got"], res[want]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL_LOSS)
    _close_trees(got["grads"], want["grads"], "first gradient")
    where = None
    if well_conditioned:
        where = jax.tree_util.tree_map(
            lambda a, b: ((a == 0) & (b == 0))
            | ((np.abs(a) > ADAM_FLAT) & (np.abs(b) > ADAM_FLAT)),
            got["grads"], want["grads"])
        flat = sum(int((~w).sum()) for w in jax.tree_util.tree_leaves(where))
        total = sum(w.size for w in jax.tree_util.tree_leaves(where))
        assert flat < 1e-3 * total, (flat, total)
    _close_trees(got["params"], want["params"], "params after a step", where)


def test_sharded_step_losses_match_the_jax_package(ranks, jax_run):
    got = case_result(ranks, "jax_steps")["losses"]
    np.testing.assert_allclose(got, jax_run["losses"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert all(np.isfinite(got)) and got[-1] < got[0], got


def test_sharded_step_matches_the_one_device_step(ranks):
    res = case_result(ranks, "sharded_vs_unsharded")
    _same_steps(res)
    assert res["got"]["losses"][-1] < res["got"]["losses"][0]


def test_grad_accumulation_matches_full_batch(ranks):
    res = case_result(ranks, "accum")
    _same_steps(res)
    _same_steps(res, want="one_device")


@pytest.mark.parametrize("what", ["zero", 3, 4])
def test_accum_steps_validation(ranks, what):
    msg = case_result(ranks, "accum_errors")[what]
    assert msg is not None
    assert ("accum_steps" if what == "zero" else "not divisible") in msg


def test_zero1_sharded_opt_state_matches_replicated(ranks):
    res = case_result(ranks, "zero1")
    assert res["dp_sharded_moments"], "no moment is sharded over party/data"
    assert res["moments"] == 2 * 12
    # The same gradients through the same AdamW arithmetic, on slices:
    # every entry is held.
    _same_steps(res, well_conditioned=False)
    _same_steps(res, want="one_device")


@pytest.mark.parametrize("opt", ["replicated", "zero1"])
def test_donate_false_leaves_the_inputs_and_gives_the_same_step(ranks, opt):
    res = case_result(ranks, "donate")[opt]
    assert res == {"in_place": True, "fresh": True, "untouched": True,
                   "equal": True}


def test_flash_path_sees_its_heads_and_rows_per_rank(ranks):
    res = case_result(ranks, "flash_heads")
    # tiny_config: 4 heads of 16 over model 2, batch 8 over party x data 4.
    assert res["shapes"] == [(2, 16, 2, 16)], res["shapes"]
    _same_steps(res)


@pytest.mark.parametrize("remat, forwards", [
    ("False", 2), ("True", 4), ("attn", 2)])
def test_remat_modes_over_the_mesh(ranks, remat, forwards):
    # tiny_config's 2 layers: one flash forward a layer and step, twice
    # under remat=True; "attn" keeps the forward's outputs by the op's name.
    res = case_result(ranks, "remat")[remat]
    assert res["forwards"] == forwards
    np.testing.assert_allclose(res["losses"], res["ref_losses"],
                               rtol=RTOL_LOSS)


def test_moe_model_over_the_mesh_matches_the_one_device_step(ranks):
    _same_steps(case_result(ranks, "moe"))


@pytest.mark.parametrize("what, match", [
    ("seq", "item 13b"), ("seq_parallel", "seq_parallel")])
def test_sequence_parallel_options(ranks, what, match):
    res = case_result(ranks, "refusals")
    assert res[what] is not None and match in res[what], res[what]
    assert res["seq_one"]


@pytest.mark.parametrize("kw", [{}, {"shard_opt_state": True,
                                     "accum_steps": 2}],
                         ids=["replicated", "zero1_accum2"])
def test_one_rank_mesh_step_is_bitwise_the_one_device_step(kw):
    """On a mesh of one rank every placement is the whole tensor and every
    collective the identity: in bf16 the sharded step takes the one-device
    step's ops in its order and gives its bits (``chip_smoke.py`` phase 14
    holds the same on the card at the flagship width)."""
    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.parallel import sharding as shd
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from tests.torch_mesh import one_rank_mesh

    cfg = tfm.tiny_config(d_model=64, n_heads=2, d_ff=128)
    gen = torch.Generator().manual_seed(0)
    blocks = [torch.randint(0, cfg.vocab, (4, 129), generator=gen)
              for _ in range(3)]

    def run(mesh_or_device, **step_kw):
        init, step = make_fed_train_step(cfg, mesh_or_device, lr=1e-3,
                                         attn="flash", loss_chunk=64,
                                         **step_kw)
        params, opt = init(0)
        losses = []
        for blk in blocks:
            params, opt, loss = step(params, opt, blk[:, :-1], blk[:, 1:])
            losses.append(float(loss))
        return losses, tree_util.tree_flatten(shd.gather_params(params))[0]

    want = run("cpu", accum_steps=kw.get("accum_steps", 1))
    with one_rank_mesh(("party", "data", "model")) as mesh:
        got = run(mesh, **kw)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
