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

"""Multi-process parties in the port (``config["jax_distributed"]``):
alice runs as two processes, leader and follower, joined by a gloo group
on the CPU with a ``data = 2`` party mesh; bob as one. Mirrors
``tests/test_multihost_party.py`` (the party's all-reduce consumed at bob,
bob's push consumed by both of alice's processes, the file KV cleared by
the leader only) and holds what the port adds: the relay of a tree
bitwise and of an error, the relay keys deleted by the last ack, one
frame an edge (the follower sends none), the planes on the leader only,
received trees placed on the party mesh by the rules, and the ``data =
2`` step's losses within 1e-5 of the JAX package's step over a ``data =
2`` CPU mesh from the same numpy params.

The three processes are spawned once for the file (``tests/torch_mesh.py``)
and each test reads their results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding

import rayfed_tpu_torch as fed
from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.parallel import sharding as jshd
from rayfed_tpu.parallel.train import make_fed_train_step as j_make_step
from tests.torch_mesh import LR, run_party_processes, party_result

LOSS_TOL = 1e-5  # as tests/test_torch_parallel.py
ALICE = [("alice", 0), ("alice", 1)]
ALL = ALICE + [("bob", 0)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's two steps (f32, lr 1e-2) over a data = 2 CPU
    mesh, from PRNGKey(0), with its init and batch as numpy."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    cfg = jtfm.tiny_config(compute_dtype=jnp.float32)
    init_fn, step_fn = j_make_step(cfg, mesh, lr=LR, attn="xla")
    tokens = jax.random.randint(jax.random.PRNGKey(2), (4, 17), 0, cfg.vocab)
    sharding = NamedSharding(mesh, jshd.batch_spec(mesh))
    inputs = jax.device_put(tokens[:, :-1], sharding)
    targets = jax.device_put(tokens[:, 1:], sharding)
    params, opt = init_fn(jax.random.PRNGKey(0), inputs)
    init = jax.tree_util.tree_map(np.asarray, params)
    losses = []
    for _ in range(2):
        params, opt, loss = step_fn(params, opt, inputs, targets)
        losses.append(float(loss))
    return {"init": init, "losses": losses,
            "inputs": np.asarray(tokens[:, :-1]).astype(np.int64),
            "targets": np.asarray(tokens[:, 1:]).astype(np.int64)}


@pytest.fixture(scope="module")
def job(jax_run):
    payload = {k: jax_run[k] for k in ("init", "inputs", "targets")}
    out = run_party_processes("multihost", payload)
    return {role: party_result(out, role) for role in ALL}


def test_two_process_party_trains_and_pushes(job):
    # Both of alice's processes took part in the all-reduce (10 + 20),
    # and every process of every party saw bob's result of it.
    for role in ALL:
        assert job[role]["aggregate"] == 60.0, role


def test_both_alice_processes_consume_bobs_push(job):
    for role in ALL:
        assert job[role]["inbound"] == 28.0, role


def test_file_kv_backend_shares_and_leader_clears(tmp_path):
    from rayfed_tpu_torch._private import kv

    kv.kv_configure("file", str(tmp_path), clear_on_reset=False)
    kv.kv_initialize("job")
    kv.kv_put("job", "k", b"v")
    # A second "process" (fresh backend object on the same dir) sees it.
    kv.kv_configure("file", str(tmp_path), clear_on_reset=False)
    kv.kv_initialize("job")
    assert kv.kv_get("job", "k") == b"v"
    kv.kv_reset()  # follower reset must NOT clear the shared store
    kv.kv_configure("file", str(tmp_path), clear_on_reset=True)
    kv.kv_initialize("job")
    assert kv.kv_get("job", "k") == b"v"
    kv.kv_reset()  # leader reset clears
    kv.kv_configure("file", str(tmp_path), clear_on_reset=True)
    kv.kv_initialize("job")
    assert kv.kv_get("job", "k") is None
    kv.kv_reset()


def test_jax_distributed_joins_a_gloo_party_group(job):
    """What the item-17 refusal of ``jax_distributed`` became: both of
    alice's processes joined one gloo group of two (the CPU)."""
    for pid, (role) in enumerate(ALICE):
        res = job[role]
        assert res["leader"] == (pid == 0)
        assert (res["backend"], res["world"]) == ("gloo", 2)
    assert job[("bob", 0)]["leader"]


def test_party_mesh_over_two_processes(job):
    """What the item-17 refusal of a two-device ``party_mesh`` became:
    a DeviceMesh over the party group's two ranks."""
    for role in ALICE:
        assert job[role]["mesh"] == {"data": 2}


def test_relayed_tree_is_bitwise_on_both_processes(job):
    want = job[("bob", 0)]["sent_digest"]
    for role in ALICE:
        held = job[role]["held"]
        assert held["digest"] == want, role
        assert held["step"] == 3
    # 10 MiB: past what the store holds itself, so its bytes went point
    # to point over the gloo bulk group.
    from rayfed_tpu_torch.proxy.barriers import STORE_INLINE

    assert max(r["nbytes"] for r in job[("alice", 1)]["relay"]) > STORE_INLINE


def test_received_tree_is_placed_on_the_party_mesh(job):
    # Replicated by the rules on a data-only mesh: each process holds the
    # whole leaf as a DTensor.
    for role in ALICE:
        assert job[role]["held"]["replicated"], role


def test_error_envelope_reaches_both_processes(job):
    for role in ALICE:
        kind, msg = job[role]["remote_error"]
        assert kind == "FedRemoteError" and "party bob" in msg, (role, msg)


def test_last_ack_deletes_every_relay_key(job):
    leader = job[("alice", 0)]
    assert leader["relayed"] >= 4, leader["relayed"]
    assert leader["keys_left"] == []
    follower = [r for r in job[("alice", 1)]["relay"]
                if r["role"] == "follower"]
    assert len(follower) == leader["relayed"]


def test_follower_sends_no_frame(job):
    # bob decoded one frame a DAG edge from alice, though both of alice's
    # processes ran each push.
    frames = job[("bob", 0)]["frames"]
    assert frames and len(frames) == len(set(frames)), frames
    assert job[("bob", 0)]["alice_push"] == 16.0  # the leader's tree


def test_planes_and_proxies_only_on_the_leader(job):
    assert job[("alice", 0)]["proxies"] == (True, True)
    assert job[("alice", 0)]["privacy_plane"]
    assert job[("alice", 1)]["proxies"] == (False, False)
    assert not job[("alice", 1)]["privacy_plane"]
    assert job[("bob", 0)]["privacy_plane"]


def test_data_parallel_step_matches_the_jax_package(job, jax_run):
    got = [job[role]["dp"] for role in ALICE]
    np.testing.assert_allclose(got[0]["losses"], jax_run["losses"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    # Both processes hold the same params and losses, bitwise.
    assert got[0] == got[1]


def test_fed_init_after_shutdown_reuses_the_party_group():
    # As jax.distributed's, the group outlives fed.shutdown: the next
    # fed.init in the same processes reuses it (the same store), and its
    # collectives span both processes again; shutdown_distributed ends it.
    out = run_party_processes("rejoin", roles=ALICE)
    for role in ALICE:
        res = party_result(out, role)
        runs = res["runs"]
        assert [r["total"] for r in runs] == [3.0, 30.0], role
        assert all(r["world"] == 2 and r["owned"] and r["up"]
                   for r in runs), runs
        assert runs[0]["store"] == runs[1]["store"]
        assert res["left"]


def test_collective_is_refused_with_a_multi_process_party():
    with pytest.raises(ValueError, match="cannot share a process"):
        fed.init(addresses={"alice": "127.0.0.1:1"}, party="alice", config={
            "jax_distributed": {"coordinator_address": "127.0.0.1:2",
                                "num_processes": 2, "process_id": 0},
            "collective": {"coordinator": "127.0.0.1:3"}})


def test_chip_smoke_multiproc_phase_at_tiny_size_on_cpu():
    """``chip_smoke.py``'s phase 15 on the CPU at tiny size: the phase
    fails on any of its checks (a)-(f)."""
    import chip_smoke
    from rayfed_tpu_torch.models import transformer as tfm

    launches = chip_smoke.phase_multiproc(
        "cpu", tfm.tiny_config(), batch=4, seq=32, timeout_s=120)
    assert set(launches) == set(chip_smoke.BF16_KERNELS)


@pytest.mark.parametrize("form", ["device_ids", "mesh_shape"])
def test_party_mesh_forms_span_the_group(job, form):
    """What the item-17 refusals of a ``party_mesh`` over two devices
    became: either form spans the party group's two ranks."""
    want = {"device_ids": {"data": 2}, "mesh_shape": {"data": 2, "model": 1}}
    for role in ALICE:
        assert job[role]["mesh_forms"][form] == want[form]


def test_received_leaves_shard_by_the_rules(job):
    """On a data x model = 1 x 2 mesh each process holds its half of the
    leaves the rules shard, the whole of the ones they replicate."""
    for role in ALICE:
        shapes = job[role]["sharded_shapes"]
        local, full, placements = shapes["layers/wq"]
        assert local[2] * 2 == full[2]
        assert placements == ["Replicate", "Shard2"]
        local, full, placements = shapes["layers/w_down"]
        assert local[1] * 2 == full[1]
        assert placements == ["Replicate", "Shard1"]
        local, full, placements = shapes["embed"]
        assert local == full and placements == ["Replicate"] * 2


def test_sharded_push_arrives_whole_at_bob(job):
    """alice's DTensor leaves sharded over her two processes reach bob
    whole and bitwise: the leader sends the follower's shards too."""
    assert job[("bob", 0)]["sharded_at_bob"] == job[("bob", 0)]["full_digest"]


def test_sharr_encoding_decodes_bitwise_in_the_jax_package(job):
    """The leader's ``sharr`` frame of a DTensor leaf sharded over its two
    processes, read by the JAX package's serialization, is the whole
    leaf, bitwise; its meta is the JAX package's (mesh, spec, shards)."""
    import msgpack

    from rayfed_tpu._private import serialization as jser
    from rayfed_tpu_torch.models import transformer as tfm
    from tests.torch_mesh import _tiny_f32

    wire = job[("alice", 0)]["sharr"]
    assert job[("alice", 1)]["sharr"] is None
    meta = msgpack.unpackb(wire["meta"], raw=False)
    descs = {d["t"] for d in meta["leaves"]}
    assert "sharr" in descs, descs
    wq = [d for d in meta["leaves"] if d["t"] == "sharr"][0]
    assert wq["mesh"] == {"axes": ["data", "model"], "shape": [1, 2]}
    assert wq["spec"] == [None, None, "model", None]
    assert len(wq["shards"]) == 2
    got = jser.decode_payload(wire["kind"], wire["meta"], wire["payload"])
    want = tfm.init_params(0, _tiny_f32(), "cpu")
    np.testing.assert_array_equal(np.asarray(got["layers"]["wq"]),
                                  want["layers"]["wq"].numpy())
    np.testing.assert_array_equal(np.asarray(got["embed"]),
                                  want["embed"].numpy())
