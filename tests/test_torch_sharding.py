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

"""The port's partition rules (``rayfed_tpu_torch/parallel/sharding.py``)
against the JAX package's, and its DeviceMesh helpers on 4 gloo ranks.

Every leaf's spec of the tiny, MoE and LoRA trees equals the JAX package's
``PartitionSpec`` (mirrors ``test_parallel.py::test_partition_rules``);
``prune_spec_to_mesh`` and ``batch_spec`` agree on each mesh's axis names;
``build_mesh`` raises what the JAX package's raises and names the items
still to come; ``shard_params`` followed by ``full_tensor()`` gives the
input's bits back.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed.tensor
from jax.sharding import Mesh

from rayfed_tpu.models import lora as jlora
from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.parallel import sharding as jshd
from rayfed_tpu_torch import mesh as pm
from rayfed_tpu_torch.parallel import sharding as shd
from tests.torch_mesh import SHARDING_MESHES, WORLD, case_result, run_ranks


def _trees():
    """The JAX package's tiny, MoE and LoRA trees, as numpy."""
    cfg = jtfm.tiny_config()
    tiny = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    moe = jtfm.init_params(jax.random.PRNGKey(1),
                           jtfm.tiny_config(n_experts=4))
    ad = jlora.init_lora(jax.random.PRNGKey(2), cfg, rank=4)
    trees = {"tiny": tiny, "moe": moe, "lora": {"layers": ad["layers"]}}
    return {k: jax.tree_util.tree_map(lambda x: np.array(x, copy=True), v)
            for k, v in trees.items()}


def _jax_specs(tree):
    paths = jax.tree_util.tree_leaves_with_path(jshd.make_param_specs(
        tree), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in paths}


@pytest.mark.parametrize("name", ["tiny", "moe", "lora"])
def test_specs_equal_the_jax_packages(name):
    tree = _trees()[name]
    want = _jax_specs(tree)
    got = dict(shd.leaf_paths(shd.make_param_specs(
        jax.tree_util.tree_map(torch.from_numpy, tree)),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert got == want
    if name == "tiny":
        # test_parallel.py::test_partition_rules's pins.
        assert got["layers/wq"] == (None, None, "model", None)
        assert got["layers/w_down"] == (None, "model", None)
        assert got["layers/ln1"] == ()
        assert got["lm_head"] == (None, "model")
        assert got["embed"] == (None, None)


@pytest.fixture(scope="module")
def ranks():
    specs = sorted({spec for tree in _trees().values()
                    for spec in _jax_specs(tree).values()}, key=repr)
    payload = {"specs": specs + [(("party", "data"), None),
                                 (("expert", "model"),), ("seq", "expert")],
               "trees": _trees()}
    return run_ranks(WORLD["sharding"], "sharding", payload), payload


@pytest.mark.parametrize("names, shape", SHARDING_MESHES,
                         ids=["x".join(n) for n, _ in SHARDING_MESHES])
def test_prune_and_batch_spec_match_on_each_mesh(ranks, names, shape):
    results, payload = ranks
    got = case_result(results, "spec_functions")[names]
    devices = np.array(jax.devices()[:4]).reshape(shape)
    mesh = Mesh(devices, names)
    want_prune = [tuple(jshd.prune_spec_to_mesh(
        jax.sharding.PartitionSpec(*spec), mesh)) for spec in payload["specs"]]
    assert got["prune"] == want_prune
    assert got["batch"] == tuple(jshd.batch_spec(mesh))
    assert got["batch_seq"] == tuple(jshd.batch_spec(mesh, seq_axis="seq"))
    assert got["batch_party_only"] == tuple(
        jshd.batch_spec(mesh, data_axis=None))


@pytest.mark.parametrize("name", ["tiny", "moe", "lora"])
def test_shard_params_round_trips_bitwise(ranks, name):
    res = case_result(ranks[0], "shard_params")[name]
    assert res["bitwise"]
    assert res["placements"] == res["rules_placements"]
    if name == "tiny":
        # party 1 x data 2 x model 2: wq's heads over model, the rest whole.
        assert res["placements"]["layers/wq"] == [
            str(torch.distributed.tensor.Replicate())] * 2 + [
            str(torch.distributed.tensor.Shard(2))]
        assert res["local_shapes"]["layers/wq"] == (2, 64, 2, 16)
        assert res["local_shapes"]["lm_head"] == (64, 128)
        assert res["local_shapes"]["embed"] == (256, 64)
    if name == "moe":
        # The expert rows place nothing until ROADMAP item 13b.
        assert res["local_shapes"]["layers/moe/w_up"] == (2, 4, 64, 176)


@pytest.mark.parametrize("what", ["flash", "dense"])
def test_attention_over_a_sharded_sequence_is_refused(ranks, what):
    res = case_result(ranks[0], "sequence")
    assert res[what] is not None and "item 13b" in res[what], res[what]
    assert res["flash_batch"]


@pytest.mark.parametrize("what, exc_text", [
    ("not_covered", "does not cover 4 devices"),
    ("expert", "item 13b"),
])
def test_build_mesh_errors(ranks, what, exc_text):
    msg = case_result(ranks[0], "build_mesh")[what]
    assert msg is not None and exc_text in msg, msg


def test_init_distributed_reuses_the_group(ranks):
    """A process whose group is up joins its party by reusing it, if the
    group is the party's: a join naming another world size is refused
    (the relay would wait for processes that are not the party's)."""
    res = case_result(ranks[0], "build_mesh")
    assert res["init_distributed"] == ["gloo", 4]
    msg = res["init_distributed_mismatch"]
    assert msg is not None and "rank 0 of 4, not as process 0 of 2" in msg


def test_build_mesh_names_and_subsets(ranks):
    res = case_result(ranks[0], "build_mesh")
    assert res["default_names"] == ["data", "model"]
    assert res["subset"] == ["data"]


def test_build_mesh_needs_a_process_group_and_a_card_unless_cpu():
    with pytest.raises(RuntimeError, match="init_process_group"):
        pm.build_mesh(mesh_shape=[1], device_type="cpu")
    if not torch.cuda.is_available():
        import torch.distributed as dist

        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                pm.build_mesh()
        finally:
            dist.destroy_process_group()
