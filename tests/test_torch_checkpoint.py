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

"""The port's party checkpoints (``rayfed_tpu_torch.checkpoint``): the
mirrors of ``tests/test_checkpoint.py`` — a one-device round trip (the
sharded one waits for the multi-card party, ROADMAP item 17), the newest
complete step, and a two-party federated resume whose aggregates
continue bitwise — plus bf16 and f32 leaves round-tripping bitwise, a
template of another dtype or shape refused, and the meta JSON equal to
the JAX package's for the same engine context. The format is this
package's own (``torch.save``); neither package reads the other's.
"""

import json
import os

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import checkpoint
from tests.utils import FAST_COMM_CONFIG, get_addresses, run_parties


def test_roundtrip_one_device(tmp_path):
    state = {"w": torch.arange(64.0).reshape(8, 8),
             "step_count": torch.tensor(7, dtype=torch.int32)}
    # No engine context: metadata fields degrade to None.
    path = str(tmp_path / "snap")
    checkpoint.save_party_state(path, state, step=7)
    restored = checkpoint.restore_party_state(path, template=state)
    assert torch.equal(restored["w"], state["w"])
    assert restored["w"].device == state["w"].device
    assert restored["step_count"].dtype == torch.int32
    assert checkpoint.load_meta(path) == {
        "step": 7, "party": None, "job": None, "seq_id_watermark": None}


def test_latest_step(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    for s in (1, 5, 3):
        d = checkpoint.step_dir(str(tmp_path), s)
        checkpoint.save_party_state(d, {"x": torch.ones(4)}, step=s)
    # A step dir without its meta file is incomplete and not counted.
    os.makedirs(checkpoint.step_dir(str(tmp_path), 9))
    assert checkpoint.latest_step(str(tmp_path)) == 5


def _bits(x):
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x) \
        .numpy().tobytes()


def test_bf16_and_f32_leaves_round_trip_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {
        "layers": [{"w": torch.randn(33, 17, generator=g).to(torch.bfloat16),
                    "b": torch.randn(17, generator=g)}],
        "scale": (torch.randn(5, generator=g) * 1e30).to(torch.bfloat16),
        "nan": torch.tensor([float("nan"), -0.0, float("inf")]),
        "meta": {"round": 3, "name": "x", "lr": 0.37, "none": None},
        "np": np.arange(6, dtype=np.int64),
    }
    checkpoint.save_party_state(str(tmp_path / "s"), state)
    for template in (None, state):
        got = checkpoint.restore_party_state(str(tmp_path / "s"), template)
        for path in (("layers", 0, "w"), ("layers", 0, "b"), ("scale",),
                     ("nan",)):
            a, b = got, state
            for k in path:
                a, b = a[k], b[k]
            assert a.dtype == b.dtype and _bits(a) == _bits(b), path
        assert got["meta"] == state["meta"]
        assert np.array_equal(got["np"], state["np"])


@pytest.mark.parametrize("bad", ["dtype", "shape", "key"])
def test_template_of_another_dtype_shape_or_key_raises(tmp_path, bad):
    state = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    checkpoint.save_party_state(str(tmp_path / "s"), state)
    template = {"dtype": {"w": torch.zeros(4, 3, dtype=torch.bfloat16),
                          "b": torch.zeros(3)},
                "shape": {"w": torch.zeros(3, 4), "b": torch.zeros(3)},
                "key": {"w": torch.zeros(4, 3), "bias": torch.zeros(3)}}[bad]
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoint.restore_party_state(str(tmp_path / "s"), template)


def test_an_optimizer_template_loads_the_saved_state(tmp_path):
    p = torch.nn.Parameter(torch.randn(5))
    opt = torch.optim.AdamW([p], lr=0.01)
    p.grad = torch.ones(5)
    opt.step()
    checkpoint.save_party_state(str(tmp_path / "s"),
                                {"model": {"p": p.detach()}, "opt": opt})
    fresh = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(5))], lr=0.01)
    got = checkpoint.restore_party_state(
        str(tmp_path / "s"), {"model": {"p": torch.zeros(5)}, "opt": fresh})
    assert got["opt"] is fresh
    want, have = opt.state_dict()["state"][0], fresh.state_dict()["state"][0]
    for k in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(want[k], have[k]), k


def test_an_orbax_checkpoint_is_refused(tmp_path):
    import jax.numpy as jnp

    from rayfed_tpu import checkpoint as jcheckpoint

    jcheckpoint.save_party_state(str(tmp_path / "s"), {"x": jnp.ones(4)})
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_party_state(str(tmp_path / "s"))


def test_meta_json_equals_the_jax_packages(tmp_path):
    import jax.numpy as jnp

    import rayfed_tpu as jfed
    from rayfed_tpu import checkpoint as jcheckpoint

    metas = {}
    for pkg, f, ckpt, leaf in (("jax", jfed, jcheckpoint, jnp.ones(4)),
                               ("torch", fed, checkpoint, torch.ones(4))):
        f.init(addresses=get_addresses(["alice"]), party="alice",
               job_name="ckpt-meta",
               config={"cross_silo_comm": dict(FAST_COMM_CONFIG)})
        try:
            @f.remote
            def one():
                return 1

            # The same DAG position in both: two tasks issued and got.
            assert f.get([one.party("alice").remote(),
                          one.party("alice").remote()]) == [1, 1]
            ckpt.save_party_state(str(tmp_path / pkg), {"x": leaf}, step=4)
        finally:
            f.shutdown()
        with open(tmp_path / pkg / "fed_meta.json") as fh:
            metas[pkg] = json.load(fh)
    assert metas["torch"] == metas["jax"]
    assert metas["torch"]["job"] == "ckpt-meta"
    assert metas["torch"]["seq_id_watermark"] is not None


def run_fed_resume(party, addresses, ckpt_root):
    from rayfed_tpu_torch.ops.aggregate import tree_mean

    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": dict(FAST_COMM_CONFIG)})

    @fed.remote
    def local_update(w, bump):
        return {"w": w["w"] + bump}

    @fed.remote
    def fedavg(a, b):
        return tree_mean(a, b)

    base = checkpoint.step_dir(f"{ckpt_root}/{party}", 0)
    resumed = checkpoint.latest_step(f"{ckpt_root}/{party}")
    if resumed is None:
        state = {"w": torch.zeros(4)}
    else:
        state = checkpoint.restore_party_state(
            checkpoint.step_dir(f"{ckpt_root}/{party}", resumed),
            template={"w": torch.zeros(4)})

    wa = local_update.party("alice").remote(state, 1.0)
    wb = local_update.party("bob").remote(state, 3.0)
    agg = fedavg.party("alice").remote(wa, wb)
    final = fed.get(agg)
    expected = 2.0 if resumed is None else 4.0  # mean(+1,+3) each phase
    assert torch.equal(final["w"], torch.full((4,), expected))
    checkpoint.save_party_state(
        base if resumed is None
        else checkpoint.step_dir(f"{ckpt_root}/{party}", 1),
        final, step=0 if resumed is None else 1)
    fed.shutdown()


def test_torch_two_party_checkpoint_resume(tmp_path):
    root = str(tmp_path)
    # Phase 1: fresh start, snapshot aggregates.
    run_parties(run_fed_resume, ["alice", "bob"], extra_args=(root,))
    # Phase 2: new processes restore and continue.
    run_parties(run_fed_resume, ["alice", "bob"], extra_args=(root,))
    for party in ("alice", "bob"):
        assert checkpoint.latest_step(f"{root}/{party}") == 1
