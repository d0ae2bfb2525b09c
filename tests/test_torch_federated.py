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

"""The port's ``fed_aggregate`` and ``FedAvgTrainer`` in spawned party
processes on the CPU (mirrors ``tests/test_federated_api.py``), held
**bitwise** against the JAX package's ``fed_aggregate``: the same
three-party job runs once on each package, over f32 and bf16 trees, ops
sum/mean/wmean and the flat, tree and ring topologies, with weights bf16
cannot represent. Plus the refusals of what is not ported yet, each
naming its ROADMAP item. The module imports neither package at the top:
each party process loads only its own.
"""

import pickle

import numpy as np
import pytest

from tests.utils import FAST_COMM_CONFIG, run_parties

CONFIG = {"cross_silo_comm": dict(FAST_COMM_CONFIG)}
PARTIES3 = ["alice", "bob", "carol"]
PARTIES4 = ["alice", "bob", "carol", "dave"]
SEEDS = {"alice": 1, "bob": 2, "carol": 3, "dave": 4}
WEIGHTS = {"alice": 0.37, "bob": 1.7, "carol": 1000.5}
CASES = [(dtype, topology, op)
         for dtype in ("float32", "bfloat16")
         for topology in ("flat", "tree", "ring")
         for op in ("sum", "mean", "wmean")]


def _tree(name, dtype, pkg):
    """Party ``name``'s tree in ``pkg``'s leaf types: jax arrays (so the
    JAX package's premultiply is JAX arithmetic) or torch tensors."""
    import ml_dtypes

    rng = np.random.default_rng(SEEDS[name])
    leaves = {"w": rng.standard_normal((24, 5)).astype(np.float32),
              "b": (rng.standard_normal((9,)) * 100).astype(np.float32)}
    if dtype == "bfloat16":
        leaves = {k: v.astype(ml_dtypes.bfloat16) for k, v in leaves.items()}
    if pkg == "jax":
        import jax.numpy as jnp

        return {"w": jnp.asarray(leaves["w"]), "layers": [{"b": jnp.asarray(leaves["b"])}]}
    import torch

    def t(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())

    return {"w": t(leaves["w"]), "layers": [{"b": t(leaves["b"])}]}


def _bits(x):
    if hasattr(x, "detach"):
        import torch

        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _tree_bits(tree):
    return (_bits(tree["w"]), _bits(tree["layers"][0]["b"]))


def run_aggregation_job(party, addresses, pkg, out_dir):
    if pkg == "jax":
        import rayfed_tpu as fed
        from rayfed_tpu.federated import fed_aggregate
    else:
        import rayfed_tpu_torch as fed
        from rayfed_tpu_torch.federated import fed_aggregate
    fed.init(addresses=addresses, party=party, config=CONFIG)

    @fed.remote
    def make(name, dtype):
        return _tree(name, dtype, pkg)

    objs = {dtype: {p: make.party(p).remote(p, dtype) for p in PARTIES3}
            for dtype in ("float32", "bfloat16")}
    out = {}
    for dtype, topology, op in CASES:
        agg = fed_aggregate(objs[dtype], op=op, topology=topology,
                            weights=WEIGHTS if op == "wmean" else None)
        out[(dtype, topology, op)] = _tree_bits(fed.get(agg))
    fed.shutdown()
    with open(f"{out_dir}/{pkg}-{party}.pkl", "wb") as f:
        pickle.dump(out, f)


def test_fed_aggregate_bitwise_equals_the_jax_package(tmp_path):
    for pkg in ("jax", "torch"):
        run_parties(run_aggregation_job, PARTIES3, timeout=180,
                    extra_args=(pkg, str(tmp_path)))
    got = {}
    for pkg in ("jax", "torch"):
        for p in PARTIES3:
            with open(tmp_path / f"{pkg}-{p}.pkl", "rb") as f:
                got[pkg, p] = pickle.load(f)
    for case in CASES:
        want = got["jax", "alice"][case]
        for key, res in got.items():
            assert res[case] == want, (case, key)
    # The job is not trivial: the topologies associate differently.
    assert got["jax", "alice"][CASES[1]] != got["jax", "alice"][CASES[0]]


def _torch_fed():
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.federated import FedAvgTrainer, fed_aggregate

    return fed, fed_aggregate, FedAvgTrainer


def _contrib(fed):
    import torch

    @fed.remote
    def contrib(v):
        return {"w": torch.full((8,), v, dtype=torch.float32)}

    return contrib


def run_hierarchical_mean(party, addresses):
    import torch

    fed, fed_aggregate, _ = _torch_fed()
    from rayfed_tpu_torch import topology as topo

    fed.init(addresses=addresses, party=party, config=dict(
        CONFIG, aggregation={"topology": "hier", "group_size": 2}))
    assert topo.get_default() == ("hier", 2)
    contrib = _contrib(fed)
    objs = {p: contrib.party(p).remote(float(i + 1))
            for i, p in enumerate(PARTIES4)}
    out = fed.get(fed_aggregate(objs, op="mean"))
    assert torch.equal(out["w"], torch.full((8,), 2.5))
    fed.shutdown()
    assert topo.get_default() == ("auto", None)


def test_four_party_hierarchical_mean():
    run_parties(run_hierarchical_mean, PARTIES4, timeout=180)


def run_three_party_sum(party, addresses):
    import torch

    fed, fed_aggregate, _ = _torch_fed()
    fed.init(addresses=addresses, party=party, config=CONFIG)
    contrib = _contrib(fed)
    objs = {p: contrib.party(p).remote(float(i)) for i, p in enumerate(PARTIES3)}
    out = fed.get(fed_aggregate(objs, op="sum"))
    assert torch.equal(out["w"], torch.full((8,), 3.0))
    fed.shutdown()


def test_three_party_sum():
    run_parties(run_three_party_sum, PARTIES3, timeout=180)


def run_weighted_mean_with_a_dead_party(party, addresses):
    import torch

    fed, fed_aggregate, _ = _torch_fed()
    from rayfed_tpu_torch.resilience.liveness import DEAD

    fed.init(addresses=addresses, party=party, config=CONFIG)
    contrib = _contrib(fed)
    objs = {"alice": contrib.party("alice").remote(1.0),
            "bob": contrib.party("bob").remote(5.0),
            "carol": contrib.party("carol").remote(100.0)}
    weights = {"alice": 3.0, "bob": 1.0, "carol": 7.0}
    out = fed.get(fed_aggregate(objs, op="wmean", weights=weights))
    assert torch.equal(out["w"], torch.full((8,), (3 + 5 + 700) / 11.0))
    # carol DEAD: the schedule is laid out over alice and bob only.
    out = fed.get(fed_aggregate(objs, op="wmean", weights=weights,
                                liveness={"carol": DEAD}))
    assert torch.equal(out["w"], torch.full((8,), 2.0))
    fed.shutdown()


def test_weighted_mean():
    run_parties(run_weighted_mean_with_a_dead_party, PARTIES3, timeout=180)


def run_trainer(party, addresses):
    import torch

    fed, _, FedAvgTrainer = _torch_fed()

    @fed.remote
    class LinWorker:
        """w <- w - lr * grad of ||x w - y||^2 on a party-local shard."""

        def __init__(self, seed):
            rng = np.random.default_rng(seed)
            self.x = torch.from_numpy(rng.normal(size=(32, 4)).astype(np.float32))
            self.y = self.x @ torch.arange(1.0, 5.0)
            self.w = torch.zeros(4)

        def train(self, global_w):
            if global_w is not None:
                self.w = global_w["w"]
            for _ in range(5):
                grad = 2 * self.x.T @ (self.x @ self.w - self.y) / len(self.y)
                self.w = self.w - 0.05 * grad
            return {"w": self.w}

    fed.init(addresses=addresses, party=party, config=CONFIG)
    trainer = FedAvgTrainer(LinWorker, ["alice", "bob"],
                            worker_args={"alice": (1,), "bob": (2,)})
    final = fed.get(trainer.run(rounds=15))
    np.testing.assert_allclose(final["w"].numpy(), np.arange(1.0, 5.0),
                               atol=0.25)
    fed.shutdown()


def test_fedavg_trainer_converges():
    run_parties(run_trainer, ["alice", "bob"], timeout=180)


# ---------------------------------------------------------------------------
# What is not ported yet is refused, naming its ROADMAP item
# ---------------------------------------------------------------------------

_REFUSED_INIT = [
    ({"aggregation": {"topology": "tree", "async_bufer_k": 2}},
     ValueError, "unknown aggregation config key 'async_bufer_k'"),
    ({"party_mesh": {"device_ids": [0, 1]}}, ValueError,
     "one process per device"),
    ({"party_mesh": {"mesh_shape": [2, 2]}}, ValueError,
     "one process per device"),
    ({"transport": "cuda"}, RuntimeError, "no CUDA|none is available"),
    ({"party_mesh": {"device_ids": [0]}}, RuntimeError, "none is available"),
    ({"transport": "tpu"}, ImportError, "counterpart .* transport='cuda'"),
]


@pytest.mark.parametrize("config, exc, match", _REFUSED_INIT,
                         ids=["async_keys", "two_devices_in_one_process",
                              "mesh_shape_in_one_process",
                              "cuda_without_a_card", "device_without_a_card",
                              "tpu_names_cuda"])
def test_init_refuses_before_building_state(config, exc, match):
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh
    from rayfed_tpu_torch._private.global_context import get_global_context
    from rayfed_tpu_torch.tenancy import context as tenancy_context

    if torch.cuda.is_available() and exc is RuntimeError:
        pytest.skip("a card is present: the no-card refusal cannot show")
    with pytest.raises(exc, match=match):
        fed.init(addresses={"alice": "127.0.0.1:1"}, party="alice",
                 config=config)
    assert get_global_context() is None and not tenancy_context.contexts()
    assert mesh.get_party_device() is None


@pytest.mark.parametrize("pkind, exc, match", [
    ("meshref", NotImplementedError, "item 12b"),
    ("dma", ValueError, "device_dma is not enabled")], ids=["meshref", "dma"])
def test_cuda_lane_refuses_frames_of_unported_lanes(pkind, exc, match):
    """The same-mesh lane is not ported (item 12b); a device-DMA frame
    at a party without ``device_dma`` is refused with the JAX package's
    message."""
    from rayfed_tpu_torch.proxy.cuda.cuda_proxy import (
        PinnedStaging,
        place_decoded,
    )

    def base(header, payload):
        return {"step": 3, "tag": "x"}

    decode = place_decoded(base, PinnedStaging("cuda:0"))
    with pytest.raises(exc, match=match):
        decode({"pkind": pkind}, b"")
    # A value without tensor leaves passes through without the card.
    assert decode({"pkind": "tree"}, b"") == {"step": 3, "tag": "x"}
    with pytest.raises(ValueError, match="places on a card"):
        PinnedStaging("cpu")
