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

"""The port's device-DMA lane (``rayfed_tpu_torch/proxy/cuda/dma.py``) on
the CPU, held against the JAX package's (``rayfed_tpu/proxy/tpu/dma.py``,
``tests/test_dma.py``): the same four tests with torch trees, where the
parties' device is the CPU (the CUDA proxies with ``device = "cpu"``), so
pulls take the socket engine between processes and the local engine
within one; then the descriptor against the JAX descriptor, pull-once,
the failed-send cap, capture at resolution, the refusal of JAX
descriptors, the reset hook, and ``examples/split_learning.py`` on the
port against the JAX example's arithmetic.

Module level imports no JAX: the party processes load only the port.
"""

import os
import runpy

import numpy as np
import pytest
import torch

from rayfed_tpu_torch._private import msgpack_codec
from rayfed_tpu_torch.proxy.cuda import dma
from rayfed_tpu_torch.proxy.cuda.cuda_proxy import (
    CudaReceiverProxy,
    CudaSenderProxy,
)
from tests.utils import FAST_COMM_CONFIG, run_parties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class CpuDmaSender(CudaSenderProxy):
    """The CUDA sender with the party's device the CPU."""

    device = "cpu"


class CpuDmaReceiver(CudaReceiverProxy):
    """The CUDA receiver with the party's device the CPU."""

    device = "cpu"


CPU_LANE = dict(sender_proxy_cls=CpuDmaSender,
                receiver_proxy_cls=CpuDmaReceiver)


def _dma_party(party, addresses):
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.proxy.cuda import dma

    comm = dict(FAST_COMM_CONFIG)
    comm["device_dma"] = True
    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": comm}, **CPU_LANE)

    @fed.remote
    def produce():
        return {
            "w": torch.arange(1 << 18, dtype=torch.float32) * 0.5,
            "b": (torch.ones((64, 64), dtype=torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)),
        }

    @fed.remote
    def consume(tree):
        assert isinstance(tree["w"], torch.Tensor), type(tree["w"])
        assert tree["b"][0].dtype == torch.bfloat16
        assert tree["b"][1].dtype == torch.int32 and tree["b"][1].shape == ()
        return (
            float(tree["w"].sum())
            + float(tree["b"][0].float().sum())
            + int(tree["b"][1])
        )

    out = consume.party("bob").remote(produce.party("alice").remote())
    got = fed.get(out)
    expect = float(np.arange(1 << 18, dtype=np.float32).sum() * 0.5) \
        + 64 * 64 + 7
    assert got == expect, (got, expect)

    # Captured when it resolved: the in-place step after it is not sent.
    @fed.remote
    class Holder:
        def __init__(self):
            self.w = torch.zeros(1 << 16)

        def get(self):
            return {"w": self.w}

        def bump(self):
            self.w.add_(1.0)
            return float(self.w[0])

    @fed.remote
    def first(tree):
        return float(tree["w"].abs().max())

    holder = Holder.party("alice").remote()
    seen = first.party("bob").remote(holder.get.remote())
    bumped = holder.bump.remote()
    assert fed.get([seen, bumped]) == [0.0, 1.0]

    if party == "alice":
        # The descriptor lane really ran: the server came up on the
        # producing side.
        assert dma._server is not None
    else:
        # ...and the consumer pulled through a cached connection, by the
        # socket engine (a host snapshot in another process).
        assert dma._connections, "no DMA connection was opened"
        assert dma.stats()["pulls"] == {"ipc": 0, "local": 0, "socket": 2}

    # A mixed payload (string leaf) rides the socket lane on the same
    # transport and config.
    @fed.remote
    def produce_mixed():
        return {"tag": "hello", "x": torch.zeros(4)}

    @fed.remote
    def consume_mixed(tree):
        return tree["tag"]

    assert fed.get(consume_mixed.party("alice").remote(
        produce_mixed.party("bob").remote())) == "hello"
    if party == "alice":
        assert dma.stats()["pulls"]["socket"] == 0
    fed.shutdown()


def test_two_party_dma_push():
    run_parties(_dma_party, ["alice", "bob"], timeout=240)


def _dma_off_party(party, addresses):
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.proxy.cuda import dma

    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": dict(FAST_COMM_CONFIG)}, **CPU_LANE)

    @fed.remote
    def produce():
        return torch.arange(1024.0)

    @fed.remote
    def consume(x):
        return float(x[-1])

    assert fed.get(consume.party("bob").remote(
        produce.party("alice").remote())) == 1023.0
    assert dma._server is None  # feature off -> no transfer server
    assert sum(dma.stats()["pulls"].values()) == 0
    fed.shutdown()


def test_dma_disabled_stays_on_socket_lane():
    run_parties(_dma_off_party, ["alice", "bob"], timeout=240)


def _jax_roundtrip(tree):
    """The JAX package's single-process register + pull of ``tree``
    (numpy leaves placed as jax arrays); the result as numpy."""
    import jax
    import jax.numpy as jnp

    from rayfed_tpu.proxy.tpu import dma as jdma

    reg = jdma.try_register(jax.tree_util.tree_map(jnp.asarray, tree),
                            "127.0.0.1:0")
    assert reg is not None
    out = jdma.pull(reg[1], "127.0.0.1:0")
    return jax.tree_util.tree_map(np.asarray, out)


def test_dma_roundtrip_single_process():
    """Register + pull within one process (the local engine): pytree
    structure, dtypes and bytes survive, as through the JAX package's
    lane; numpy-leaf trees are refused (the socket lane's job)."""
    from rayfed_tpu_torch.config import TcpCrossSiloMessageConfig

    cfg = TcpCrossSiloMessageConfig.from_dict({"device_dma": True})
    assert cfg.device_dma is True

    host = {
        "a": np.arange(4096, dtype=np.int32),
        "nest": [np.full((8, 3), 2.5, np.float32),
                 (np.array(1.5, np.float32),)],
    }
    tree = {"a": torch.from_numpy(host["a"]),
            "nest": [torch.from_numpy(host["nest"][0]),
                     (torch.from_numpy(host["nest"][1][0]),)]}
    before = dma.stats()["pulls"]["local"]
    reg = dma.try_register(tree, cfg.dma_listen_addr, "cpu")
    assert reg is not None
    header_fields, payload, on_done = reg
    assert header_fields["pkind"] == "dma"
    assert callable(on_done)
    assert len(payload) < 4096  # descriptor, not data

    out = dma.pull(payload)
    assert dma.stats()["pulls"]["local"] == before + 1
    assert isinstance(out, dict) and isinstance(out["nest"], list)
    assert isinstance(out["nest"][1], tuple)
    want = _jax_roundtrip(host)
    np.testing.assert_array_equal(out["a"].numpy(), want["a"])
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4096))
    np.testing.assert_array_equal(out["nest"][0].numpy(), want["nest"][0])
    assert float(out["nest"][1][0]) == float(want["nest"][1][0]) == 1.5
    assert out["nest"][1][0].shape == ()

    # Host-memory numpy leaves are not the party's tensors: socket lane.
    assert dma.try_register({"x": np.zeros(4)}, cfg.dma_listen_addr,
                            "cpu") is None


def _hostile(**extra):
    return msgpack_codec.packb(
        {
            "uuid": 1,
            "addr": "127.0.0.1:1",
            "spec": {"k": "leaf", "m": None, "c": []},
            "leaves": [{"shape": [1 << 20, 1 << 20], "dtype": "float32"}],
            **extra,
        },
        use_bin_type=True,
    )


def test_dma_receiver_rejects_oversized_descriptor():
    """A tiny descriptor frame must not be able to command a huge
    allocation: the receiver's payload cap applies to the DECLARED leaf
    sizes before anything is allocated or pulled."""
    from rayfed_tpu_torch.proxy.cuda.cuda_proxy import place_decoded

    hostile = _hostile(engine="cuda", host="elsewhere", pid=1, card=None)
    with pytest.raises(ValueError, match="payload cap"):
        dma.pull(hostile, max_bytes=1 << 20)
    decode = place_decoded(None, None, device_dma=True,
                           max_decompressed_bytes=1 << 20)
    with pytest.raises(ValueError, match="payload cap"):
        decode({"pkind": "dma"}, hostile)
    # Without device_dma the frame is refused with the JAX message.
    off = place_decoded(None, None)
    with pytest.raises(ValueError, match="device_dma is not enabled"):
        off({"pkind": "dma"}, hostile)


def test_descriptor_matches_the_jax_descriptor():
    """For the same tree the port's descriptor carries the JAX
    descriptor's wire spec, leaf shapes and dtypes and an integer uuid,
    plus the engine tag and the sender's identity."""
    import jax.numpy as jnp
    import msgpack

    from rayfed_tpu.proxy.tpu import dma as jdma

    rng = np.random.default_rng(3)
    host = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": (rng.normal(size=(3,)).astype(np.float32),
                  np.array(7, np.int32))}
    jtree = {"a": jnp.asarray(host["a"]),
             "b": (jnp.asarray(host["b"][0]).astype(jnp.bfloat16),
                   jnp.asarray(host["b"][1]))}
    ttree = {"a": torch.from_numpy(host["a"]),
             "b": (torch.from_numpy(host["b"][0]).to(torch.bfloat16),
                   torch.from_numpy(host["b"][1]))}
    jreg = jdma.try_register(jtree, "127.0.0.1:0")
    treg = dma.try_register(ttree, "127.0.0.1:0", "cpu")
    jdesc = msgpack.unpackb(jreg[1], raw=False)
    tdesc = msgpack.unpackb(treg[1], raw=False)
    assert tdesc["spec"] == jdesc["spec"]
    assert tdesc["leaves"] == jdesc["leaves"] == [
        {"shape": [5, 7], "dtype": "float32"},
        {"shape": [3], "dtype": "bfloat16"},
        {"shape": [], "dtype": "int32"}]
    assert isinstance(tdesc["uuid"], int) and isinstance(jdesc["uuid"], int)
    assert set(tdesc) - set(jdesc) == {"engine", "host", "pid", "card"}
    assert tdesc["engine"] == "host" and tdesc["card"] is None
    assert tdesc["pid"] == os.getpid()
    # Both pulled, so neither server keeps them parked.
    jout = jdma.pull(jreg[1], "127.0.0.1:0")
    tout = dma.pull(treg[1])
    np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
    np.testing.assert_array_equal(
        tout["b"][0].view(torch.int16).numpy(),
        np.asarray(jout["b"][0]).view(np.int16))


def _socket_descriptor(payload):
    """``payload`` with a foreign process id: the pull then goes to the
    server over a connection (the socket engine for host snapshots)."""
    desc = msgpack_codec.unpackb(payload, raw=False)
    desc["pid"] = -1
    return msgpack_codec.packb(desc, use_bin_type=True)


@pytest.mark.parametrize("engine", ["local", "socket"])
def test_second_pull_of_a_uuid_errors(engine):
    reg = dma.try_register({"x": torch.arange(10.0)}, "127.0.0.1:0", "cpu")
    payload = reg[1] if engine == "local" else _socket_descriptor(reg[1])
    before = dma.stats()["pulls"][engine]
    out = dma.pull(payload)
    assert torch.equal(out["x"], torch.arange(10.0))
    assert dma.stats()["pulls"][engine] == before + 1
    with pytest.raises(RuntimeError, match="already-pulled"):
        dma.pull(payload)
    assert dma.stats()["parked"] == 0


def test_failed_send_cap_turns_off_the_sender(monkeypatch):
    from rayfed_tpu_torch.proxy import barriers

    monkeypatch.setattr(dma, "_FAILED_PINNED_CAP", 1000)
    monkeypatch.setattr(dma, "_failed_pinned_bytes", 0)
    monkeypatch.setattr(dma, "_sender_disabled", None)
    tree = {"x": torch.zeros(100)}  # 400 bytes
    reg = dma.try_register(tree, "127.0.0.1:0", "cpu")
    reg[2](True)  # delivered: not counted
    assert dma.stats()["failed_send_bytes"] == 0
    dma.pull(reg[1])
    for _ in range(3):
        reg = dma.try_register(tree, "127.0.0.1:0", "cpu")
        assert reg is not None
        reg[2](False)  # its snapshot stays parked
    assert dma.stats()["failed_send_bytes"] == 1200
    assert dma.stats()["sender_disabled"] is not None
    assert dma.try_register(tree, "127.0.0.1:0", "cpu") is None

    class Sender:
        _TRANSPORT = "cuda"

        class _config:
            @staticmethod
            def for_dest(dest):
                return type("C", (), {"device_dma": True,
                                      "dma_listen_addr": "127.0.0.1:0"})

        @staticmethod
        def dma_device():
            return torch.device("cpu")

    # The capture at resolution stages to host from now on.
    assert barriers._dma_device(Sender, "bob") is None
    monkeypatch.setattr(dma, "_sender_disabled", None)
    assert barriers._dma_device(Sender, "bob") == torch.device("cpu")
    # Pulling still works for what stayed parked.
    for uuid in list(dma._server._pending):
        dma._server.take(uuid)


def test_a_tree_mutated_after_it_resolved_arrives_as_it_resolved():
    from concurrent.futures import Future

    from rayfed_tpu_torch._private import executor
    from rayfed_tpu_torch.proxy import barriers

    tree = {"w": torch.zeros(1000), "b": torch.ones(3, dtype=torch.int64)}
    fut = Future()
    staged = barriers._capture_for_send("bob", fut, "1", "2",
                                        dma_device=torch.device("cpu"))
    executor.set_result_versioned(fut, tree)
    tree["w"].add_(5.0)  # the producer's next in-place step
    tree["b"].mul_(3)
    snap = staged.result()
    assert isinstance(snap, dma.Snapshot) and snap.nbytes == 4024
    out = dma.pull(dma.try_register(snap, "127.0.0.1:0")[1])
    assert torch.equal(out["w"], torch.zeros(1000))
    assert torch.equal(out["b"], torch.ones(3, dtype=torch.int64))
    # A push registered after a later mutation is refused, as on the
    # socket lane.
    late = Future()
    executor.set_result_versioned(late, tree)
    tree["w"].add_(1.0)
    with pytest.raises(RuntimeError, match="mutated in place"):
        barriers._capture_for_send("bob", late, "1", "3",
                                   dma_device=torch.device("cpu")).result()


def test_jax_descriptor_is_refused_naming_mixed_jobs():
    """Each package refuses the other's lane: a JAX descriptor (no engine
    tag) at a port receiver, and the JAX package's socket engine asking
    the port's server (no requester identity)."""
    import jax
    import jax.numpy as jnp

    from rayfed_tpu.proxy.tpu import dma as jdma
    from rayfed_tpu_torch.proxy.cuda.cuda_proxy import place_decoded

    jreg = jdma.try_register({"x": jnp.arange(8.0)}, "127.0.0.1:0")
    with pytest.raises(ValueError, match="mixed JAX/torch jobs"):
        dma.pull(jreg[1])
    decode = place_decoded(None, None, device_dma=True)
    with pytest.raises(ValueError, match="mixed JAX/torch jobs"):
        decode({"pkind": "dma"}, jreg[1])
    jdma.pull(jreg[1], "127.0.0.1:0")

    treg = dma.try_register({"x": torch.arange(8.0)}, "127.0.0.1:0", "cpu")
    desc = msgpack_codec.unpackb(treg[1], raw=False)
    conn = jdma._SocketTransferConnection(desc["addr"])
    sd = jax.ShapeDtypeStruct((8,), np.float32)
    with pytest.raises(RuntimeError, match="mixed JAX/torch jobs"):
        conn.pull(desc["uuid"], [sd])
    conn._sock.close()
    dma.pull(treg[1])


def test_reset_hooks_drop_the_lane_connections():
    from rayfed_tpu_torch.tenancy import reset

    reg = dma.try_register({"x": torch.arange(4.0)}, "127.0.0.1:0", "cpu")
    dma.pull(_socket_descriptor(reg[1]))
    assert dma._connections
    conn = next(iter(dma._connections.values()))
    assert "rayfed_tpu_torch.proxy.cuda.dma" in reset.RESET_HOOKS
    assert reset.verify_inventory_coverage() == []
    assert reset.run_all_reset_hooks(last=True) == []
    assert not dma._connections
    assert conn._sock.fileno() == -1  # closed
    # The server stays up: a new pull dials again.
    reg = dma.try_register({"x": torch.arange(4.0)}, "127.0.0.1:0", "cpu")
    assert torch.equal(dma.pull(_socket_descriptor(reg[1]))["x"],
                       torch.arange(4.0))


# ---------------------------------------------------------------------------
# examples/split_learning.py on the port against the JAX example
# ---------------------------------------------------------------------------


def _split_party(party, addresses, lane, out_dir):
    import json

    from rayfed_tpu_torch.examples import split_learning

    kw = {}
    comm = dict(FAST_COMM_CONFIG)
    if lane == "dma":
        kw = CPU_LANE
        comm["device_dma"] = True
    losses = split_learning.run(party, addresses, device="cpu",
                                transport="tcp", comm=comm, **kw)
    if lane == "dma":
        from rayfed_tpu_torch.proxy.cuda import dma

        # Alice pulls each gradient, bob each activation.
        assert dma.stats()["pulls"]["socket"] == split_learning.STEPS
    with open(os.path.join(out_dir, f"{party}.json"), "w") as f:
        json.dump(losses, f)


def _jax_split_losses(steps):
    """The JAX example's classes, run in this process: the same steps as
    main(), without the engine."""
    mod = runpy.run_path(os.path.join(REPO, "examples", "split_learning.py"))
    bottom, head = mod["Bottom"]._cls(), mod["Head"]._cls()
    losses = []
    for _ in range(steps):
        bottom.backward(head.step(bottom.forward()))
        losses.append(head.get_loss())
    return losses


@pytest.mark.parametrize("lane", ["tcp", "dma"])
def test_split_learning_matches_the_jax_example(tmp_path, lane):
    import json

    from rayfed_tpu_torch.examples import split_learning

    run_parties(_split_party, ["alice", "bob"], timeout=240,
                extra_args=(lane, str(tmp_path)))
    got = {p: json.load(open(tmp_path / f"{p}.json"))
           for p in ("alice", "bob")}
    want = _jax_split_losses(split_learning.STEPS)
    assert got["alice"] == got["bob"]
    assert len(want) == split_learning.STEPS == 10
    np.testing.assert_allclose(got["alice"], want, rtol=0, atol=1e-5)
    assert want[-1] < want[0]
