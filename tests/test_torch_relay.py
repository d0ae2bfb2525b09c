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

"""The multi-process party's relay (``rayfed_tpu_torch/proxy/barriers.py``)
in one process, over an in-memory store standing in for the party
group's ``TCPStore``: a tree relayed bitwise to every follower, an error
envelope and a wire failure relayed as errors, the key deleted by the
last follower's ack, a follower's deadline, a follower's send with no
frame; and the ``sharr`` descriptor the port writes for a sharded leaf,
read by the JAX package's serialization bitwise."""

from concurrent.futures import Future

import msgpack
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rayfed_tpu._private import serialization as jser
from rayfed_tpu.proxy import barriers as jbarriers
from rayfed_tpu_torch import mesh
from rayfed_tpu_torch._private import serialization
from rayfed_tpu_torch.exceptions import FedRemoteError
from rayfed_tpu_torch.proxy import barriers

KEY = barriers._relay_key("job", "3#0", "4")


class _Ctx:
    """The global context's face a follower's fetch reads."""

    def __init__(self, leader=False):
        self.leader = leader
        self.errors = []

    def get_job_name(self):
        return "relay-test"

    def is_party_leader(self):
        return self.leader

    def set_last_received_error(self, e):
        self.errors.append(e)


@pytest.fixture
def group(monkeypatch):
    """A party group of three (a leader, two followers) over one
    in-memory store; this process plays each role in turn."""
    g = dict(store=dist.HashStore(), backend="gloo", rank=1, world=3,
             timeout_s=5.0, owned=False)
    monkeypatch.setattr(mesh, "_party_group", g)
    monkeypatch.setattr(barriers, "_relay_published", [])
    return g


def _tree():
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(33, 17, generator=g),
            "bf16": torch.randn(4, 129, generator=g).to(torch.bfloat16),
            "ids": [torch.arange(10, dtype=torch.int64),
                    {"b": torch.randn(3, generator=g).double()}],
            "round": 7, "name": "alice"}


def _bits(x):
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _assert_bitwise(got, want):
    from rayfed_tpu_torch import tree_util

    g, gs = tree_util.tree_flatten(got)
    w, ws = tree_util.tree_flatten(want)
    assert gs == ws
    for a, b in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            assert a == b


def test_relay_key_is_the_jax_packages():
    assert KEY == jbarriers._relay_key("job", "3#0", "4")


def test_relay_bytes_round_trip_a_tree_bitwise():
    blob, nbytes = barriers._relay_encode(_tree(), False)
    value, is_error, on_card, t = barriers._relay_decode(blob)
    _assert_bitwise(value, _tree())
    assert not is_error and not on_card and t > 0
    assert nbytes == sum(x.nbytes for x in (
        _tree()["w"], _tree()["bf16"], _tree()["ids"][0],
        _tree()["ids"][1]["b"]))


def test_relay_bytes_carry_an_error_envelope():
    err = FedRemoteError("bob", ValueError("bob's task failed"))
    value, is_error, _, _ = barriers._relay_decode(
        barriers._relay_encode(err, True)[0])
    assert is_error and isinstance(value, FedRemoteError)
    assert "bob" in str(value)


def test_every_follower_gets_the_tree_and_the_last_ack_deletes_it(group):
    barriers._relay_publish(group, KEY, _tree(), False)
    store = group["store"]
    assert store.check([KEY])
    futs = []
    for rank in (1, 2):
        group["rank"] = rank
        futs.append(barriers._relay_fetch(_Ctx(), KEY))
        _assert_bitwise(futs[-1].result(10), _tree())
        # The first follower's ack leaves the key for the second.
        assert store.check([KEY]) == (rank == 1)
    assert not store.check([f"{KEY}:ack"])
    assert barriers.relay_keys_left() == []
    roles = [r["role"] for r in barriers.relay_stats()[-3:]]
    assert roles == ["leader", "follower", "follower"]


def test_a_small_value_is_held_in_its_one_store_key(group):
    # Up to STORE_INLINE bytes the store carries the relay's bytes itself,
    # under the relay key and no other.
    barriers._relay_publish(group, KEY, _tree(), False)
    store = group["store"]
    head = store.get(KEY)
    assert head[:1] == b"=" and len(head) - 1 <= barriers.STORE_INLINE
    _assert_bitwise(barriers._relay_decode(memoryview(head)[1:])[0], _tree())
    assert store.num_keys() == 1


def test_a_relayed_error_envelope_raises_at_the_follower(group):
    err = FedRemoteError("bob", ValueError("bob's task failed"))
    barriers._relay_publish(group, KEY, err, True)
    ctx = _Ctx()
    with pytest.raises(FedRemoteError):
        barriers._relay_fetch(ctx, KEY).result(10)
    assert len(ctx.errors) == 1


def test_a_wire_failure_reaches_the_follower(group):
    barriers._relay_publish(group, KEY, ConnectionError("wire cut"), True)
    with pytest.raises(ConnectionError, match="wire cut"):
        barriers._relay_fetch(_Ctx(), KEY).result(10)


def test_an_unencodable_value_relays_an_error(group):
    # A lambda has no wire form: the followers learn at once.
    barriers._relay_publish(group, KEY, {"f": lambda: 1}, False)
    with pytest.raises(RuntimeError, match="could not relay"):
        barriers._relay_fetch(_Ctx(), KEY).result(10)


def test_a_follower_waits_at_most_the_deadline(group):
    group["timeout_s"] = 0.3
    fut = barriers._relay_fetch(_Ctx(), KEY)
    with pytest.raises(TimeoutError, match="within 0.3 s"):
        fut.result(10)


def test_a_followers_send_resolves_without_a_frame(monkeypatch, group):
    monkeypatch.setattr(barriers, "get_global_context",
                        lambda: _Ctx(leader=False))
    # No proxy is up: a frame would need one.
    fut = barriers.send("bob", {"w": torch.ones(3)}, 5, 6)
    assert isinstance(fut, Future) and fut.result(0) is True
    assert barriers.sender_proxy() is None


def _sharded_leaf(dtype):
    full = torch.randn(6, 8, generator=torch.Generator().manual_seed(1))
    full = full.to(dtype)
    shards = [([[0, 6], [4, 8]], full[:, 4:]), ([[0, 6], [0, 4]], full[:, :4])]
    return full, serialization.ShardedLeaf(
        dtype, full.shape, ["data", "model"], [1, 2], [None, "model"], shards)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharr_leaf_decodes_bitwise_in_both_packages(dtype):
    full, leaf = _sharded_leaf(dtype)
    kind, meta, bufs = serialization.encode_payload({"w": leaf, "n": 1})
    payload = b"".join(bytes(b) for b in bufs)
    desc = msgpack.unpackb(meta, raw=False)["leaves"][0]
    assert desc["t"] == "sharr"
    assert desc["mesh"] == {"axes": ["data", "model"], "shape": [1, 2]}
    assert desc["spec"] == [None, "model"]
    assert [s["i"] for s in desc["shards"]] == [[[0, 6], [0, 4]],
                                                 [[0, 6], [4, 8]]]
    got = jser.decode_payload(kind, meta, payload)
    arr = np.asarray(got["w"])
    want = _bits(full)
    np.testing.assert_array_equal(arr.view(want.dtype), want)
    assert got["n"] == 1
    mine = serialization.decode_payload(kind, meta, payload)
    _assert_bitwise(mine["w"], full)
