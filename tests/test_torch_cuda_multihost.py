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

"""A multi-process party on the card: alice as two processes sharing the
one card (a gloo party group: NCCL refuses two ranks on one card) with a
``data = 2`` party mesh, bob as one, all on ``transport="cuda"``. bob
pushes a tree of card tensors; the leader receives it on the wire, the
follower through the leader's relay, and both hold it bitwise as bob
hashed it, placed on the card as replicated DTensors. Every test here is
marked ``cuda`` and skips without a card. The file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_multihost.py
"""

import hashlib
import multiprocessing
import os
import pickle
import socket
import tempfile
import traceback

import pytest
import torch

pytestmark = pytest.mark.cuda

#: Seconds a process's program may take; the relay's deadline is shorter.
JOB_TIMEOUT_S = 180
RECV_MS = 60_000


def _port():
    # Left in TIME_WAIT from the server's side, so no later connect or
    # bind(0) takes it before its owner binds it with SO_REUSEADDR.
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        name = s.getsockname()
        with socket.socket() as c:
            c.connect(name)
            s.accept()[0].close()
        return name[1]


def _tree():
    g = torch.Generator(device="cuda").manual_seed(5)
    return {"w": torch.randn(512, 384, device="cuda", generator=g),
            "bf16": torch.randn(3, 1000, device="cuda", generator=g).to(
                torch.bfloat16),
            "ids": torch.arange(77, device="cuda")}


def _digest(tree):
    from torch.distributed.tensor import DTensor

    out = {}
    for k, x in tree.items():
        if isinstance(x, DTensor):
            x = x.to_local()
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        out[k] = hashlib.sha256(x.numpy().tobytes()).hexdigest()
    return out


def _program(party, pid, addresses, coordinator, out_path):
    res = {}
    try:
        from torch.distributed.tensor import DTensor, Replicate

        import rayfed_tpu_torch as fed

        config = {"cross_silo_comm": {"recv_timeout_in_ms": RECV_MS}}
        if party == "alice":
            config["jax_distributed"] = {"coordinator_address": coordinator,
                                         "num_processes": 2,
                                         "process_id": pid}
            config["party_mesh"] = {"mesh_shape": [2],
                                    "axis_names": ["data"]}
        fed.init(addresses=addresses, party=party, transport="cuda",
                 config=config)

        @fed.remote
        def produce():
            return _tree()

        @fed.remote
        def sent(tree):
            return _digest(tree)

        @fed.remote
        def held(tree):
            return dict(digest=_digest(tree), placed=sorted({
                f"{type(x).__name__}:{x.device.type}:" + ",".join(
                    type(p).__name__ for p in x.placements)
                for x in tree.values() if isinstance(x, DTensor)}),
                dtensors=all(isinstance(x, DTensor) and all(
                    isinstance(p, Replicate) for p in x.placements)
                    for x in tree.values()))

        tree = produce.party("bob").remote()
        res["sent"] = fed.get(sent.party("bob").remote(tree))
        res["held"] = fed.get(held.party("alice").remote(tree))
        if party == "alice":
            from rayfed_tpu_torch import mesh
            from rayfed_tpu_torch.proxy import barriers

            res["backend"] = mesh.party_group()["backend"]
            res["relay"] = barriers.relay_stats()
        fed.shutdown()
        # The party group outlives fed.shutdown; the process is done.
        from rayfed_tpu_torch import mesh as fed_mesh

        fed_mesh.shutdown_distributed()
    except Exception:  # noqa: BLE001 - reported to the test
        res = {"error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def job():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mp = multiprocessing.get_context("spawn")
    addresses = {p: f"127.0.0.1:{_port()}" for p in ("alice", "bob")}
    coordinator = f"127.0.0.1:{_port()}"
    roles = [("alice", 0), ("alice", 1), ("bob", 0)]
    with tempfile.TemporaryDirectory() as tmp:
        outs = {r: os.path.join(tmp, f"{r[0]}{r[1]}.pkl") for r in roles}
        procs = [mp.Process(target=_program, args=(p, i, addresses,
                                                   coordinator, outs[p, i]))
                 for p, i in roles]
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOB_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out = {}
        for r in roles:
            assert os.path.exists(outs[r]), f"process {r} left no result"
            with open(outs[r], "rb") as f:
                out[r] = pickle.load(f)
            assert "error" not in out[r], out[r]["error"]
        return out


def test_both_processes_hold_the_card_tree_bitwise(job):
    want = job[("bob", 0)]["sent"]
    for pid in (0, 1):
        assert job[("alice", pid)]["held"]["digest"] == want, pid
    # The follower's copy came through the leader's relay.
    relayed = [r for r in job[("alice", 1)]["relay"]
               if r["role"] == "follower"]
    assert relayed and max(r["nbytes"] for r in relayed) > 512 * 384 * 4


def test_the_relayed_tree_is_placed_on_the_card(job):
    for pid in (0, 1):
        res = job[("alice", pid)]
        assert res["backend"] == "gloo"
        assert res["held"]["dtensors"], pid
        assert res["held"]["placed"] == ["DTensor:cuda:Replicate"], pid
