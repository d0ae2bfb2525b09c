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

"""Mixed-package jobs: one party runs ``rayfed_tpu`` (JAX), the other
``rayfed_tpu_torch``, and then the other way round, over one TCP wire.

f32 and bf16 trees cross in both directions and come back byte-identical;
a one-round FedAvg with its root in either package equals
``rayfed_tpu.ops.aggregate.tree_mean`` of the same trees bitwise; so do
``fed_aggregate`` mean and wmean (weights bf16 cannot represent) over a
tree of f32 and bf16 leaves, each party running its own package's
``fed_aggregate`` (one DAG), with the root in either package, against the
JAX package's ``reduce_by_plan``; a task that raises in one package
surfaces as ``FedRemoteError`` in the other. The port's party runs its
native IO path (``rayfed_tpu_torch._fastwire``) against the JAX party's
Python IO path, which these jobs pin, with leaves large enough for the
pooled scatter receive.
The module imports neither package at the top: each party process loads
only its own.
"""

import numpy as np
import pytest

from tests.utils import FAST_COMM_CONFIG, run_parties

DIRECTIONS = {
    "alice_jax-bob_torch": {"alice": "jax", "bob": "torch"},
    "alice_torch-bob_jax": {"alice": "torch", "bob": "jax"},
}
SEEDS = {"alice": 1, "bob": 2}


def _numpy_tree(seed):
    """The party's parameter tree as numpy: f32 leaves and the bf16 bits
    (uint16) of a bf16 leaf."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    bf = rng.standard_normal((33,)).astype(np.float32)
    bits = bf.view(np.uint32)
    # Round to nearest even into bf16 (finite normals only here).
    bf16 = ((bits + (0x7FFF + ((bits >> 16) & 1))) >> 16).astype(np.uint16)
    return {"w": w, "layers": [{"b": rng.standard_normal(5).astype(np.float32),
                                "h": bf16}], "step": seed}


def _to_package(tree, pkg):
    """The tree in the leaf types of ``pkg``: numpy / ml_dtypes for the
    JAX package, torch tensors for the port."""
    layer = tree["layers"][0]
    if pkg == "jax":
        import ml_dtypes

        h = layer["h"].view(ml_dtypes.bfloat16)
        return {"w": tree["w"], "layers": [{"b": layer["b"], "h": h}],
                "step": tree["step"]}
    import torch

    return {"w": torch.from_numpy(tree["w"].copy()),
            "layers": [{"b": torch.from_numpy(layer["b"].copy()),
                        "h": torch.from_numpy(layer["h"].view(np.int16).copy())
                        .view(torch.bfloat16)}],
            "step": tree["step"]}


def _leaf_bytes(x):
    if hasattr(x, "detach"):  # torch.Tensor
        import torch

        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_tree_bytes(got, expect):
    assert got["step"] == expect["step"]
    assert _leaf_bytes(got["w"]) == _leaf_bytes(expect["w"])
    for key in ("b", "h"):
        assert _leaf_bytes(got["layers"][0][key]) == _leaf_bytes(
            expect["layers"][0][key]), key


def _fed(pkg):
    if pkg == "jax":
        import rayfed_tpu as fed
    else:
        import rayfed_tpu_torch as fed
    return fed


def run_mixed(party, addresses, pkgs, case, expected):
    import sys

    pkg = pkgs[party]
    fed = _fed(pkg)
    other = "rayfed_tpu" if pkg == "torch" else "rayfed_tpu_torch"
    if case == "io_paths":
        if pkg == "jax":
            # The JAX party on its Python IO path, whatever is built.
            from rayfed_tpu.proxy import lanes
            from rayfed_tpu.proxy.tcp import checksum, sockio

            sockio._fastwire = checksum._fw = lanes._fw = None
        else:
            from rayfed_tpu_torch.proxy.tcp import sockio

            assert sockio.io_path() == "native"
    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": dict(FAST_COMM_CONFIG)})

    @fed.remote
    def make(name):
        return _to_package(_numpy_tree(SEEDS[name]), pkg)

    @fed.remote
    def identity(x):
        return x

    if case == "io_paths":
        @fed.remote
        def make_big(name):
            return _big_tree(name, pkg)

        a = make_big.party("alice").remote("alice")
        b = make_big.party("bob").remote("bob")
        ea = identity.party("bob").remote(a)
        eb = identity.party("alice").remote(b)
        got = fed.get([a, b, ea, eb])
        for value, name in zip(got, ["alice", "bob", "alice", "bob"]):
            want = _big_tree(name, pkg)
            _assert_tree_bytes(value, want)
            for key in ("big_f32", "big_bf16"):
                assert _leaf_bytes(value[key]) == _leaf_bytes(want[key])
    elif case == "roundtrip":
        a = make.party("alice").remote("alice")
        b = make.party("bob").remote("bob")
        # Each tree crosses, is echoed back by the other package, and
        # every copy is fetched by both parties.
        ea = identity.party("bob").remote(a)
        eb = identity.party("alice").remote(b)
        got = fed.get([a, b, ea, eb])
        for value, name in zip(got, ["alice", "bob", "alice", "bob"]):
            _assert_tree_bytes(value, _to_package(_numpy_tree(SEEDS[name]),
                                                  pkg))
    elif case == "fedavg":
        @fed.remote
        def fedavg(x, y):
            if pkg == "jax":
                from rayfed_tpu.ops.aggregate import tree_mean
            else:
                from rayfed_tpu_torch.ops.aggregate import tree_mean
            x, y = dict(x), dict(y)
            x.pop("step"), y.pop("step")
            return tree_mean(x, y)

        a = make.party("alice").remote("alice")
        b = make.party("bob").remote("bob")
        agg = fed.get(fedavg.party("alice").remote(a, b))
        assert _leaf_bytes(agg["w"]) == expected["w"]
        assert _leaf_bytes(agg["layers"][0]["b"]) == expected["b"]
        assert _leaf_bytes(agg["layers"][0]["h"]) == expected["h"]
    elif case == "fed_aggregate":
        if pkg == "jax":
            from rayfed_tpu.federated import fed_aggregate
        else:
            from rayfed_tpu_torch.federated import fed_aggregate

        @fed.remote
        def contribution(name):
            return _agg_tree(name, pkg)

        objs = {p: contribution.party(p).remote(p) for p in ("alice", "bob")}
        for op in ("mean", "wmean"):
            agg = fed.get(fed_aggregate(
                objs, op=op, weights=AGG_WEIGHTS if op == "wmean" else None))
            assert _agg_bytes(agg) == expected[op], op
    else:  # error
        # The task raises in the JAX party, and the port's task fed its
        # value fails in turn: an envelope crosses each way. The port's
        # is queued last, just before its shutdown, whose drain must
        # deliver it. (The JAX package can lose an envelope queued just
        # before its own shutdown: ROADMAP Queue 3.)
        jax_party = next(p for p, k in pkgs.items() if k == "jax")
        torch_party = next(p for p, k in pkgs.items() if k == "torch")

        @fed.remote
        def boom():
            raise ValueError("boom")

        x = boom.party(jax_party).remote()
        y = identity.party(torch_party).remote(x)
        if party == jax_party:
            with pytest.raises(ValueError, match="boom"):
                fed.get(x)
        else:
            with pytest.raises(fed.FedRemoteError):
                fed.get(x)
        with pytest.raises(fed.FedRemoteError):
            fed.get(y)
    fed.shutdown()
    # Each party ran on its own package only.
    assert other not in sys.modules


AGG_WEIGHTS = {"alice": 0.37, "bob": 1.7}


def _big_tree(name, pkg):
    """The party's tree plus a 2 MiB f32 leaf and a 1 MiB bf16 leaf."""
    tree = _to_package(_numpy_tree(SEEDS[name]), pkg)
    rng = np.random.default_rng(SEEDS[name] + 10)
    f32 = rng.standard_normal(1 << 19).astype(np.float32)
    bits = rng.integers(0, 1 << 16, 1 << 19, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0  # no NaN or Inf patterns
    if pkg == "jax":
        import ml_dtypes

        tree.update(big_f32=f32, big_bf16=bits.view(ml_dtypes.bfloat16))
    else:
        import torch

        tree.update(big_f32=torch.from_numpy(f32),
                    big_bf16=torch.from_numpy(bits.view(np.int16))
                    .view(torch.bfloat16))
    return tree


def _agg_tree(name, pkg):
    """A tree of f32 and bf16 leaves: jax arrays for the JAX package (its
    premultiply is then JAX arithmetic), torch tensors for the port."""
    tree = _to_package(_numpy_tree(SEEDS[name]), pkg)
    tree.pop("step")
    if pkg == "jax":
        import jax

        tree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    return tree


def _agg_bytes(tree):
    return (_leaf_bytes(tree["w"]), _leaf_bytes(tree["layers"][0]["b"]),
            _leaf_bytes(tree["layers"][0]["h"]))


def _expected_fed_aggregate():
    """The JAX package's ``reduce_by_plan`` (the arithmetic of its
    ``fed_aggregate``) of the two parties' trees, as bytes per op."""
    from rayfed_tpu import topology
    from rayfed_tpu.ops.aggregate import reduce_by_plan

    plan = topology.plan(["alice", "bob"], "flat")
    trees = {p: _agg_tree(p, "jax") for p in ("alice", "bob")}
    return {"mean": _agg_bytes(reduce_by_plan(plan, trees)),
            "wmean": _agg_bytes(reduce_by_plan(plan, trees, AGG_WEIGHTS))}


def _expected_fedavg():
    """The JAX package's tree_mean of the two parties' trees, as bytes."""
    from rayfed_tpu.ops.aggregate import tree_mean

    trees = []
    for name in ("alice", "bob"):
        t = _to_package(_numpy_tree(SEEDS[name]), "jax")
        t.pop("step")
        trees.append(t)
    agg = tree_mean(*trees)
    return {"w": _leaf_bytes(agg["w"]), "b": _leaf_bytes(agg["layers"][0]["b"]),
            "h": _leaf_bytes(agg["layers"][0]["h"])}


@pytest.mark.parametrize("case", ["roundtrip", "fedavg", "fed_aggregate",
                                  "error"])
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_mixed_package_job(direction, case):
    expected = {"fedavg": _expected_fedavg,
                "fed_aggregate": _expected_fed_aggregate}.get(
                    case, lambda: None)()
    run_parties(run_mixed, ["alice", "bob"], timeout=60,
                extra_args=(DIRECTIONS[direction], case, expected))


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_native_port_and_python_jax_party_exchange_trees_bitwise(direction):
    # The port's party on its native IO path, the JAX party on its Python
    # one: f32 and bf16 trees (with MiB leaves) cross both ways, are
    # echoed back by the other package and arrive byte-identical.
    run_parties(run_mixed, ["alice", "bob"], timeout=60,
                extra_args=(DIRECTIONS[direction], "io_paths", None))
