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

"""The port's topology planner and plan-driven folds against the JAX
package's (mirrors ``tests/test_topology.py``).

Plans are compared step for step with ``rayfed_tpu.topology``'s.
``reduce_by_plan`` and ``elastic_weighted_mean`` are held **bitwise** to
the JAX package's on the same numpy trees: f32 and bf16 leaves, 2/4/8
parties, every topology, uniform weights and weights that bf16 cannot
represent (0.37, 1.7, 1000.5), which JAX rounds to the leaf dtype before
the multiply and the divide."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu import topology as jtopo
from rayfed_tpu.ops import aggregate as jagg
from rayfed_tpu_torch import topology as topo
from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean, reduce_by_plan

torch.set_num_threads(2)

CONCRETE = ("flat", "tree", "ring", "hier")
SHAPES = CONCRETE + ("auto",)


def _parties(n):
    return [f"p{i:02d}" for i in range(n)]


def _steps(plan):
    return [[(s.dst, s.srcs) for s in lvl] for lvl in plan.levels]


@pytest.mark.parametrize("n", list(range(1, 10)))
@pytest.mark.parametrize("shape", SHAPES)
def test_plans_equal_the_jax_package_step_for_step(n, shape):
    for kw in ({}, {"group_size": 2}, {"root": _parties(n)[-1]},
               {"dead": {"p01"}} if n > 1 else {}):
        got = topo.plan(_parties(n), shape, **kw)
        want = jtopo.plan(_parties(n), shape, **kw)
        assert (got.topology, got.parties, got.root) == \
            (want.topology, want.parties, want.root)
        assert _steps(got) == _steps(want), kw
        assert (got.num_rounds, got.max_fan_in) == \
            (want.num_rounds, want.max_fan_in)
        assert topo.plan_is_flat(got) == jtopo.plan_is_flat(want)
    old, jold = topo.plan(_parties(n), shape), jtopo.plan(_parties(n), shape)
    if n > 2:
        assert _steps(topo.replan(old, {"p00"})) == \
            _steps(jtopo.replan(jold, {"p00"}))
    assert _steps(topo.plan_secure(_parties(n))) == \
        _steps(jtopo.plan_secure(_parties(n)))
    assert _steps(topo.plan_buffer(_parties(n))) == \
        _steps(jtopo.plan_buffer(_parties(n)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 9, 16, 33, 64])
@pytest.mark.parametrize("shape", CONCRETE)
def test_plans_validate_for_all_shapes(n, shape):
    p = topo.plan(_parties(n), shape)
    p.validate()
    assert p.root == "p00"
    assert p.parties == tuple(_parties(n))
    assert p.topology == shape


def test_shape_properties_and_auto_resolution():
    n = 16
    assert topo.plan(_parties(n), "flat").max_fan_in == n - 1
    assert topo.plan(_parties(n), "tree").num_rounds == 4
    ring = topo.plan(_parties(n), "ring")
    assert ring.num_rounds == n - 1 and all(len(lvl) == 1 for lvl in ring.levels)
    assert topo.plan(_parties(n), "hier").max_fan_in <= 4
    assert topo.plan(_parties(2), "auto").topology == "flat"
    assert topo.plan(_parties(5), "auto").topology == "tree"
    assert topo.plan(_parties(9), "auto").topology == "hier"


def test_dead_parties_replan_and_malformed_plans():
    p = topo.plan(_parties(8), "tree", dead={"p00", "p03"})
    assert "p00" not in p.parties and p.root == "p01"
    with pytest.raises(ValueError, match="no surviving parties"):
        topo.plan(_parties(2), "flat", dead=set(_parties(2)))
    with pytest.raises(ValueError, match="must start with dst"):
        topo.ReduceStep("a", ("b", "a"))
    with pytest.raises(ValueError, match="unknown topology"):
        topo.plan(_parties(3), "mesh")
    old = topo.plan(_parties(8), "hier")
    assert topo.replan(old, dead={"p05"}).root == old.root
    assert topo.replan(old, dead={"p00"}).root == "p01"


def test_default_roundtrip():
    try:
        topo.set_default("ring", group_size=4)
        assert topo.get_default() == ("ring", 4)
        with pytest.raises(ValueError, match="group_size"):
            topo.set_default("hier", group_size=1)
        with pytest.raises(ValueError, match="topology"):
            topo.set_default("star")
    finally:
        topo.reset_default()
    assert topo.get_default() == ("auto", None)


def _numpy_trees(n, dtype):
    rng = np.random.default_rng(n)
    out = {}
    for p in _parties(n):
        w = rng.standard_normal((32, 9)).astype(np.float32)
        b = rng.standard_normal((7,)).astype(np.float32) * 100
        if dtype == "bfloat16":
            w, b = w.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
        out[p] = {"w": w, "layers": [{"b": b}]}
    return out


def _to_torch(tree):
    def leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return {"w": leaf(tree["w"]), "layers": [{"b": leaf(tree["layers"][0]["b"])}]}


def _to_jax(tree):
    return {"w": jnp.asarray(tree["w"]),
            "layers": [{"b": jnp.asarray(tree["layers"][0]["b"])}]}


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_same_bits(got, want):
    assert _bits(got["w"]) == _bits(want["w"])
    assert _bits(got["layers"][0]["b"]) == _bits(want["layers"][0]["b"])


def _weights(kind, n):
    if kind == "uniform":
        return None
    cycle = (0.37, 1.7, 1000.5)
    return {p: cycle[i % 3] for i, p in enumerate(_parties(n))}


@pytest.mark.parametrize("weights", ["uniform", "inexact"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_reduce_by_plan_bitwise_equals_the_jax_package(n, shape, dtype, weights):
    trees = _numpy_trees(n, dtype)
    w = _weights(weights, n)
    got = reduce_by_plan(topo.plan(_parties(n), shape),
                         {p: _to_torch(t) for p, t in trees.items()}, w)
    want = jagg.reduce_by_plan(jtopo.plan(_parties(n), shape),
                               {p: _to_jax(t) for p, t in trees.items()}, w)
    assert got["w"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                              else torch.float32)
    _assert_same_bits(got, want)


def _int_contribs(n, shape=(64,)):
    return {
        p: {"w": torch.full(shape, float(i + 1)),
            "b": torch.arange(8, dtype=torch.float32) * (i + 1)}
        for i, p in enumerate(_parties(n))
    }


@pytest.mark.parametrize("n", [4, 9, 16])
def test_reduce_by_plan_bitwise_identical_across_topologies(n):
    contribs = _int_contribs(n)
    ref = reduce_by_plan(topo.plan(_parties(n), "flat"), contribs)
    for shape in CONCRETE[1:]:
        out = reduce_by_plan(topo.plan(_parties(n), shape), contribs)
        for k in ref:
            assert torch.equal(out[k], ref[k]), shape
    assert float(ref["w"][0]) == sum(range(1, n + 1)) / n


def test_reduce_by_plan_missing_contribution_rejected():
    with pytest.raises(ValueError, match="no contribution"):
        reduce_by_plan(topo.plan(_parties(4), "tree"), _int_contribs(3))


@pytest.mark.parametrize("shape", [None, "tree", "ring", "hier"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elastic_weighted_mean_replans_over_survivors(shape, dtype):
    from rayfed_tpu.resilience.degraded import MISSING as JMISSING
    from rayfed_tpu.resilience.liveness import DEAD as JDEAD
    from rayfed_tpu_torch.resilience.degraded import MISSING
    from rayfed_tpu_torch.resilience.liveness import DEAD

    n = 8
    trees = _numpy_trees(n, dtype)
    w = _weights("inexact", n)
    # p02 is DEAD though its value arrived; p05's push was lost.
    ours = {p: _to_torch(t) for p, t in trees.items()}
    ours["p05"] = MISSING
    theirs = {p: _to_jax(t) for p, t in trees.items()}
    theirs["p05"] = JMISSING
    got = elastic_weighted_mean(ours, w, liveness={"p02": DEAD},
                                topology=shape)
    want = jagg.elastic_weighted_mean(theirs, w, liveness={"p02": JDEAD},
                                      topology=shape)
    _assert_same_bits(got, want)
    # The survivors' plan leaves the dead and the missing out.
    survivors = [p for p in _parties(n) if p not in ("p02", "p05")]
    if shape is not None:
        only = reduce_by_plan(topo.plan(survivors, shape),
                              {p: ours[p] for p in survivors},
                              {p: w[p] for p in survivors})
        _assert_same_bits(got, only)
    with pytest.raises(ValueError, match="no surviving contributors"):
        elastic_weighted_mean({"p00": None}, liveness={})
