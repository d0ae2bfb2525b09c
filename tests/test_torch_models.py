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

"""The port's logistic regression, MLP and CNN against the JAX package's
``models/mlp.py`` and ``models/cnn.py``: the same params (JAX init through
numpy), the same inputs, loss and gradients compared.

Tolerance (f32): the loss within 1e-5 of the JAX loss, relative; each
gradient leaf within 1e-5 of the JAX leaf's norm, in norm. The models
differ only in summation order (XLA's dot and convolution vs torch's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import cnn as jcnn
from rayfed_tpu.models import mlp as jmlp
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import cnn, mlp

torch.set_num_threads(2)

REL_TOL = 1e-5


def _case(name):
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    if name == "logreg":
        params = jmlp.init_logreg(key, 64, 10)
        x = rng.normal(size=(16, 64)).astype(np.float32)
        return params, x, jmlp.logreg_loss, mlp.logreg_loss
    if name == "mlp":
        params = jmlp.init_mlp(key, [64, 48, 32, 10])
        x = rng.normal(size=(16, 64)).astype(np.float32)
        return params, x, jmlp.mlp_loss, mlp.mlp_loss
    params = jcnn.init_cnn(key, num_classes=10, channels=(8, 16), input_hw=16)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    return params, x, jcnn.cnn_loss, cnn.cnn_loss


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", ["logreg", "mlp", "cnn"])
def test_loss_and_grads_match_the_jax_package(name):
    jparams, x, jloss, tloss = _case(name)
    y = np.random.default_rng(1).integers(0, 10, size=(x.shape[0],))
    jl, jg = jax.value_and_grad(jloss)(jparams, jnp.asarray(x), jnp.asarray(y))

    params = mlp.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                   "cpu")
    params = tree_util.tree_map(lambda p: p.requires_grad_(True), params)
    loss = tloss(params, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()

    assert abs(float(loss.detach()) - float(jl)) <= REL_TOL * abs(float(jl))
    # The key paths and leaf order match: flatten both in the JAX order.
    want = jax.tree_util.tree_leaves_with_path(jg)
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(
               tree_util.tree_map(lambda p: p.grad.numpy(), params))}
    assert len(got) == len(want)
    for path, g in want:
        t = got[jax.tree_util.keystr(path)]
        assert t.shape == g.shape, path
        assert _rel(t, np.asarray(g)) <= REL_TOL, (path, _rel(t, np.asarray(g)))


def test_cnn_keeps_hwio_leaves_and_round_trips_through_numpy():
    params = cnn.init_cnn(0, channels=(8, 16), input_hw=16, device="cpu")
    assert params["convs"][0]["w"].shape == (3, 3, 3, 8)
    assert params["convs"][1]["w"].shape == (3, 3, 8, 16)
    assert params["dense"]["w"].shape == (4 * 4 * 16, 128)
    back = cnn.params_from_numpy(cnn.params_to_numpy(params), "cpu")
    for a, b in zip(tree_util.tree_flatten(params)[0],
                    tree_util.tree_flatten(back)[0]):
        assert torch.equal(a, b)
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), channels=(8, 16),
                            input_hw=16)
    assert (jax.tree_util.tree_structure(jparams)
            == jax.tree_util.tree_structure(cnn.params_to_numpy(params)))
    logits = cnn.cnn_apply(params, torch.zeros(2, 16, 16, 3))
    assert logits.shape == (2, 10)
