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

"""The port's FedAvg example programs end to end (mirrors
``tests/test_fedavg_e2e.py``): ``rayfed_tpu_torch/examples/fedavg_logreg.py``
and ``fedavg_cnn.py`` in two spawned party processes on the CPU over
localhost TCP, from the JAX package's initial params (through numpy).
Both parties' final digests are equal, and every round's aggregate
agrees with the same rounds run by the JAX package (its models, jitted
SGD steps and ``reduce_by_plan``, the twin of ``fed_aggregate``'s
arithmetic) in this process.

Tolerance (f32): each leaf of each round's aggregate within a share of
the JAX leaf's norm, in norm: 1e-6 for logistic regression (one matrix
product each way), 1e-4 for the CNN, whose conv gradients sum 64 * 32 *
32 products per bias entry in another order than XLA's (its conv biases
start at zero, so after a round they hold three such sums and little
else). The two packages differ only in summation order inside the models
and in XLA's fused ``p - lr * g``."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayfed_tpu import topology as jtopo
from rayfed_tpu.models import cnn as jcnn
from rayfed_tpu.models import mlp as jmlp
from rayfed_tpu.ops.aggregate import reduce_by_plan
from tests.utils import FAST_COMM_CONFIG, run_parties

REL_TOL = {"fedavg_logreg": 1e-6, "fedavg_cnn": 1e-4}
SEEDS = {"alice": 1, "bob": 2}


def run_example(party, addresses, name, rounds, init, out_dir):
    import importlib

    import torch

    torch.set_num_threads(2)
    example = importlib.import_module(f"rayfed_tpu_torch.examples.{name}")
    out = example.run(party, addresses, rounds=rounds, device="cpu",
                      transport="tcp", init=init, comm=FAST_COMM_CONFIG)
    with open(f"{out_dir}/{party}.pkl", "wb") as f:
        pickle.dump(out, f)


def _jax_rounds(name, rounds, init):
    """The example's rounds in the JAX package: per party the local SGD
    steps from the round's global params, then the aggregate."""
    from rayfed_tpu_torch.examples import fedavg_cnn, fedavg_logreg

    if name == "fedavg_logreg":
        ex, loss_fn, lr = fedavg_logreg, jmlp.logreg_loss, fedavg_logreg.LR
    else:
        ex, loss_fn, lr = fedavg_cnn, jcnn.cnn_loss, fedavg_cnn.LR

    @jax.jit
    def step(params, x, y):
        grads = jax.grad(loss_fn)(params, x, y)
        return jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)

    data, cursor = {}, {p: 0 for p in SEEDS}
    for p, seed in SEEDS.items():
        rng = np.random.default_rng(seed)
        if name == "fedavg_logreg":
            n = ex.BATCH
            data[p] = (rng.normal(size=(n, ex.DIM)).astype(np.float32),
                       rng.integers(0, ex.CLASSES, size=(n,)))
        else:
            n = ex.SHARD[p]
            data[p] = (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
                       rng.integers(0, ex.CLASSES, size=(n,)))
    weights = ({p: float(n) for p, n in ex.SHARD.items()}
               if name == "fedavg_cnn" else None)
    plan = jtopo.plan(list(SEEDS), "flat")
    global_params = jax.tree_util.tree_map(jnp.asarray, init)
    out = []
    for _ in range(rounds):
        local = {}
        for p in SEEDS:
            params = global_params
            x, y = data[p]
            for _ in range(ex.LOCAL_STEPS):
                if name == "fedavg_logreg":
                    params = step(params, x, y)
                else:
                    lo = cursor[p] % (len(x) - ex.BATCH + 1)
                    params = step(params, x[lo:lo + ex.BATCH],
                                  y[lo:lo + ex.BATCH])
                    cursor[p] += ex.BATCH
            local[p] = params
        global_params = reduce_by_plan(plan, local, weights)
        out.append(jax.tree_util.tree_map(np.asarray, global_params))
    return out


@pytest.mark.parametrize("name, rounds", [("fedavg_logreg", 3),
                                          ("fedavg_cnn", 2)])
def test_example_two_parties_agree_with_the_jax_package(tmp_path, name, rounds):
    from rayfed_tpu_torch.examples import fedavg_logreg

    if name == "fedavg_logreg":
        init = jmlp.init_logreg(jax.random.PRNGKey(0), fedavg_logreg.DIM,
                                fedavg_logreg.CLASSES)
    else:
        init = jcnn.init_cnn(jax.random.PRNGKey(0), num_classes=10)
    init = jax.tree_util.tree_map(np.asarray, init)
    run_parties(run_example, ["alice", "bob"], timeout=240,
                extra_args=(name, rounds, init, str(tmp_path)))
    got = {}
    for p in SEEDS:
        with open(tmp_path / f"{p}.pkl", "rb") as f:
            got[p] = pickle.load(f)
    assert got["alice"]["digest"] == got["bob"]["digest"]
    assert np.isfinite(got["alice"]["loss"]) and np.isfinite(got["bob"]["loss"])

    want = _jax_rounds(name, rounds, init)
    assert len(got["alice"]["rounds"]) == len(want) == rounds
    for r, (ours, theirs) in enumerate(zip(got["alice"]["rounds"], want)):
        ours = jax.tree_util.tree_leaves_with_path(ours)
        theirs = jax.tree_util.tree_leaves_with_path(theirs)
        assert [k for k, _ in ours] == [k for k, _ in theirs]
        for (path, a), (_, b) in zip(ours, theirs):
            err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert err <= REL_TOL[name], (r, jax.tree_util.keystr(path), err)


def test_lm_worker_loads_a_sorted_key_global_tree_by_key_path():
    """A global tree from a JAX root reaches the worker with its dict
    keys sorted; ``LmWorker.train`` loads each leaf into the param at the
    same key path, not at the same flatten position."""
    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.examples.federated_transformer import LmWorker

    worker = LmWorker._cls(0, device="cpu")
    # The local step leaves the params as loaded.
    worker._step_fn = lambda p, o, x, y: (p, o, torch.zeros(()))
    rng = np.random.default_rng(3)
    mine = tree_util.tree_map(lambda x: x.detach().numpy(), worker.params)
    sent = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(x.dtype), mine)
    # What a JAX root's tree looks like: every dict's keys sorted.
    assert (tree_util.tree_flatten(mine)[1].meta
            != tree_util.tree_flatten(sent)[1].meta)
    got = worker.train(tree_util.tree_map(torch.from_numpy, sent))
    for path, want in jax.tree_util.tree_leaves_with_path(sent):
        have = got
        for k in path:
            have = have[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(have.detach().numpy(), want)
