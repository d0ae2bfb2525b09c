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

"""The port's FedAvg folds against ``rayfed_tpu.ops.aggregate``, bitwise:
the same numpy trees through both must give the same bits (the JAX
package's determinism promise, now across the two packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.ops import aggregate as jagg
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models.transformer import params_from_numpy, params_to_numpy
from rayfed_tpu_torch.ops import aggregate as agg

# The suite runs in several worker processes on one host: a small torch
# thread pool keeps these tests from starving timing-sensitive ones.
torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _trees(n, dtype, seed=0):
    """n parameter-like trees (nested dicts, mixed shapes) as numpy."""
    rng = np.random.default_rng(seed)
    jdt = _DTYPES[dtype][0]

    def leaf(shape):
        x = rng.standard_normal(shape).astype(np.float32) * 3
        return np.asarray(jnp.asarray(x, jdt))

    return [{"embed": leaf((17, 8)), "layers": {"wq": leaf((2, 8, 4)),
                                               "ln": leaf((2, 8))},
             "bias": leaf((5,))} for _ in range(n)]


def _assert_bitwise(torch_tree, jax_tree):
    got = params_to_numpy(torch_tree)
    want = jax.tree_util.tree_map(np.asarray, jax_tree)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def _both(trees):
    return ([jax.tree_util.tree_map(jnp.asarray, t) for t in trees],
            [params_from_numpy(t, device="cpu") for t in trees])


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_sum_bitwise(dtype, n):
    jt, tt = _both(_trees(n, dtype))
    _assert_bitwise(agg.tree_sum(*tt), jagg.tree_sum(*jt))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_mean_bitwise(dtype, n):
    # The reference's `/ n` compiles to a multiply by the f32 reciprocal;
    # for n = 3 a true division would differ in the last bit.
    jt, tt = _both(_trees(n, dtype))
    _assert_bitwise(agg.tree_mean(*tt), jagg.tree_mean(*jt))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_weighted_mean_bitwise(dtype, n):
    jt, tt = _both(_trees(n, dtype))
    rng = np.random.default_rng(n)
    weights = [float(w) for w in rng.uniform(0.5, 40.0, size=n)]
    _assert_bitwise(agg.tree_weighted_mean(tt, weights),
                    jagg.tree_weighted_mean(jt, weights))
    counts = [int(c) for c in rng.integers(1, 1000, size=n)]  # sample counts
    _assert_bitwise(agg.tree_weighted_mean(tt, counts),
                    jagg.tree_weighted_mean(jt, counts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_mix_bitwise(dtype):
    jt, tt = _both(_trees(2, dtype))
    _assert_bitwise(agg.tree_mix(tt[0], tt[1], 0.37),
                    jagg.tree_mix(jt[0], jt[1], 0.37))


def test_mean_in_leaf_dtype_bitwise():
    jt, tt = _both(_trees(3, "bfloat16"))
    _assert_bitwise(agg.tree_mean(*tt, acc_dtype=None),
                    jagg.tree_mean(*jt, acc_dtype=None))


def test_single_tree_and_unit_mix_return_input_untouched():
    _, tt = _both(_trees(2, "float32"))
    assert agg.tree_sum(tt[0]) is tt[0]
    assert agg.tree_mean(tt[0]) is tt[0]
    assert agg.tree_weighted_mean([tt[0]], [3.0]) is tt[0]
    assert agg.tree_mix(tt[0], tt[1], 1.0) is tt[1]
    assert agg.tree_mix(None, tt[1], 0.5) is tt[1]


def test_mismatched_trees_raise():
    _, tt = _both(_trees(2, "float32"))
    del tt[1]["bias"]
    with pytest.raises(ValueError, match="structures differ"):
        agg.tree_mean(*tt)
    with pytest.raises(ValueError, match="weights"):
        agg.tree_weighted_mean(tt, [1.0])


def test_folds_pair_dict_leaves_by_key_not_by_order():
    # A tree from the JAX package reaches the port with its dict keys
    # sorted (jax.tree_util rebuilds dicts so); the port's own trees keep
    # insertion order. The fold pairs leaves by key and keeps the first
    # tree's order.
    jt, tt = _both(_trees(2, "float32"))
    sorted_second = {k: tt[1][k] for k in sorted(tt[1], reverse=True)}
    assert list(sorted_second) != list(tt[0])
    out = agg.tree_mean(tt[0], sorted_second)
    assert list(out) == list(tt[0])
    _assert_bitwise(out, jagg.tree_mean(*jt))


@pytest.mark.parametrize("fold", ["tree_sum", "tree_mean",
                                  "tree_weighted_mean", "tree_mix"])
def test_a_fold_over_leaves_on_two_devices_names_the_transport(fold):
    # A root's own tree on its card meets a tree received under
    # transport="tcp", which lands on the CPU. The meta device stands in
    # for the card here.
    _, tt = _both(_trees(2, "float32"))
    elsewhere = tree_util.tree_map(
        lambda v: torch.empty_like(v, device="meta"), tt[1])
    call = {"tree_sum": lambda: agg.tree_sum(tt[0], elsewhere),
            "tree_mean": lambda: agg.tree_mean(tt[0], elsewhere),
            "tree_weighted_mean":
                lambda: agg.tree_weighted_mean([tt[0], elsewhere], [1.0, 2.0]),
            "tree_mix": lambda: agg.tree_mix(tt[0], elsewhere, 0.5)}[fold]
    with pytest.raises(ValueError, match="transport='cuda'"):
        call()


def test_fma_rounds_once():
    """The emulated fused multiply-add against exact rational arithmetic
    (f64 products of f32 values are exact; the sum is rounded once)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a, b, c = (torch.from_numpy(rng.standard_normal(4000).astype(np.float32)
                                * s) for s in (1.0, 1.0, 1e-3))
    got = agg._fma(a, b, c).numpy()
    for i in range(0, 4000, 97):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the nearest float32 to the exact value (ties to even)
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                         int(np.float32(f).view(np.uint32)) & 1))
        assert got[i] == best
