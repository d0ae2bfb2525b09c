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

"""The device-DMA lane (``rayfed_tpu_torch/proxy/cuda/dma.py``) on the
card: two party processes on one card push f32 and bf16 trees bitwise over
CUDA IPC, a push within one process takes the local engine, a card snapshot
served to a foreign process id takes the socket engine and lands on the
card, the sender's snapshot is freed after the pull (by the lane's counts
and by the card's free memory), a snapshot taken while PyTorch's cache
holds the card's free memory empties that cache, and a sender killed
before the pull makes the receiver raise within its deadline. Every test is marked ``cuda`` and
skips without an sm_90 card. The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dma.py
"""

import hashlib
import json
import multiprocessing
import os
import socket
import time

import pytest
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch._private import msgpack_codec
from rayfed_tpu_torch.proxy.cuda import dma

COMM = {"retry_policy": {"max_attempts": 20, "initial_backoff_ms": 100},
        "device_dma": True}
PARTIES = ("alice", "bob")
SEEDS = {"alice": 1, "bob": 2}
# What a party may hold on the card after its pushes beyond before them.
MEMORY_SLACK = 64 << 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the lane copies on one)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the port targets sm_90 (Hopper) cards")
    return torch.device("cuda", 0)


def _tree(seed, device):
    """f32 and bf16 leaves (a scalar and an empty one among them) and an
    int64 one."""
    g = torch.Generator().manual_seed(seed)
    tree = {"f32": {"w": torch.randn(1000, 777, generator=g),
                    "s": torch.tensor(2.5 + seed)},
            "bf16": [torch.randn(513, 129, generator=g).to(torch.bfloat16),
                     torch.zeros(0, 4, dtype=torch.bfloat16)],
            "i": torch.arange(7, dtype=torch.int64) * seed}
    return tree_util.tree_map(lambda x: x.to(device), tree)


def _digests(tree):
    out = []
    for x in tree_util.tree_flatten(tree)[0]:
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        out.append([str(x.dtype), list(x.shape),
                    hashlib.sha256(x.numpy().tobytes()).hexdigest()])
    return out


def _party(party, addresses, out_path):
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh

    result = {}
    try:
        fed.init(addresses=addresses, party=party, transport="cuda",
                 config={"cross_silo_comm": COMM})
        device = mesh.get_party_device()

        @fed.remote
        def produce(seed):
            return _tree(seed, device)

        @fed.remote
        def received(tree):
            return dict(
                digests=_digests(tree),
                devices=sorted({str(x.device)
                                for x in tree_util.tree_flatten(tree)[0]}))

        @fed.remote
        def lane_state(allocated_before):
            # The server frees a snapshot once the receiver says "done".
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                s = dma.stats()
                if s["device_snapshots"] == 0 and s["parked"] == 0:
                    break
                time.sleep(0.05)
            s = dma.stats()
            s["allocated_growth"] = (torch.cuda.memory_allocated(device)
                                     - allocated_before)
            return s

        allocated = torch.cuda.memory_allocated(device)
        to_bob = received.party("bob").remote(
            produce.party("alice").remote(SEEDS["alice"]))
        to_alice = received.party("alice").remote(
            produce.party("bob").remote(SEEDS["bob"]))
        result["received"] = dict(zip(("bob", "alice"),
                                      fed.get([to_bob, to_alice])))
        result["states"] = dict(zip(PARTIES, fed.get(
            [lane_state.party(p).remote(allocated) for p in PARTIES])))
        result["device"] = str(device)
        fed.shutdown()
        result["ok"] = True
    except BaseException as e:  # noqa: BLE001 - reported to the test
        result = {"ok": False, "error": repr(e)}
    with open(out_path, "w") as f:
        json.dump(result, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_party_run(tmp_path_factory):
    """alice pushes her tree to bob and bob his to alice, in two spawned
    party processes on the card, ``transport="cuda"`` and ``device_dma``."""
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 CUDA card")
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path_factory.mktemp("dma")
    addresses = {p: f"127.0.0.1:{_free_port()}" for p in PARTIES}
    procs = {p: ctx.Process(target=_party, args=(
        p, addresses, str(out / f"{p}.json"))) for p in PARTIES}
    for p in procs.values():
        p.start()
    for p in procs.values():
        p.join(240)
    late = [n for n, p in procs.items() if p.is_alive()]
    for p in procs.values():
        if p.is_alive():
            p.kill()
            p.join()
    assert not late, f"party processes {late} did not finish in 240 s"
    results = {}
    for n in PARTIES:
        with open(out / f"{n}.json") as f:
            results[n] = json.load(f)
        assert results[n]["ok"], results[n]["error"]
    return results


@pytest.mark.cuda
def test_two_parties_push_f32_and_bf16_trees_bitwise_over_ipc(
        cuda_device, two_party_run):
    for party in PARTIES:
        res = two_party_run[party]
        for dst, src in (("bob", "alice"), ("alice", "bob")):
            got = res["received"][dst]
            assert got["digests"] == _digests(_tree(SEEDS[src], "cpu"))
            assert got["devices"] == [res["device"]]
        for p, state in res["states"].items():
            assert state["pulls"] == {"ipc": 1, "local": 0, "socket": 0}, p
            assert state["pulled_bytes"]["ipc"] == sum(
                x.nbytes
                for x in tree_util.tree_flatten(_tree(1, "cpu"))[0]), p


@pytest.mark.cuda
def test_the_senders_snapshot_is_freed_after_the_pull(cuda_device,
                                                      two_party_run):
    for p, state in two_party_run["alice"]["states"].items():
        assert state["device_snapshots"] == 0 and state["device_bytes"] == 0, p
        assert state["parked"] == 0, p
        assert state["allocated_growth"] <= MEMORY_SLACK, p


@pytest.mark.cuda
def test_a_push_within_one_process_takes_the_local_engine(cuda_device):
    tree = _tree(3, cuda_device)
    want = _digests(tree)
    before = dma.stats()
    reg = dma.try_register(tree, "127.0.0.1:0", cuda_device)
    assert reg is not None
    assert dma.stats()["device_snapshots"] == before["device_snapshots"] + 1
    # The snapshot was taken at registration: a later in-place step does
    # not reach the receiver.
    for x in tree_util.tree_flatten(tree)[0]:
        x.mul_(0)
    out = dma.pull(reg[1], device=cuda_device)
    after = dma.stats()
    assert after["pulls"]["local"] == before["pulls"]["local"] + 1
    assert after["pulls"]["ipc"] == before["pulls"]["ipc"]
    assert after["device_snapshots"] == before["device_snapshots"]
    assert _digests(out) == want
    assert {x.device for x in tree_util.tree_flatten(out)[0]} == {cuda_device}
    # A tree with a leaf off the card is not the lane's.
    assert dma.try_register({"x": torch.zeros(3)}, "127.0.0.1:0",
                            cuda_device) is None


@pytest.mark.cuda
def test_a_card_snapshot_is_served_over_the_socket_engine(cuda_device):
    tree = _tree(4, cuda_device)
    want = _digests(tree)
    before = dma.stats()
    reg = dma.try_register(tree, "127.0.0.1:0", cuda_device)
    # A foreign process id: the pull dials the server, which cannot serve
    # its own process by IPC and so sends the snapshot's bytes.
    desc = msgpack_codec.unpackb(reg[1], raw=False)
    desc["pid"] = -1
    out = dma.pull(msgpack_codec.packb(desc, use_bin_type=True),
                   device=cuda_device)
    after = dma.stats()
    assert {e: after["pulls"][e] - before["pulls"][e] for e in dma.ENGINES} \
        == {"ipc": 0, "local": 0, "socket": 1}
    assert _digests(out) == want
    assert {x.device for x in tree_util.tree_flatten(out)[0]} == {cuda_device}
    assert after["device_snapshots"] == before["device_snapshots"]
    assert after["parked"] == 0


@pytest.mark.cuda
def test_a_snapshot_empties_torchs_cache_when_the_card_is_full(cuda_device):
    nbytes = 256 << 20
    tree = {"w": torch.full((nbytes // 4,), 1.5, device=cuda_device)}
    torch.cuda.synchronize()
    free = torch.cuda.mem_get_info(cuda_device)[0]
    # A freed block that PyTorch's allocator keeps cached leaves the card
    # less free memory than the snapshot needs.
    hog = torch.empty(free - (64 << 20), dtype=torch.uint8,
                      device=cuda_device)
    del hog
    assert torch.cuda.mem_get_info(cuda_device)[0] < nbytes
    try:
        reg = dma.try_register(tree, "127.0.0.1:0", cuda_device)
        assert reg is not None
        out = dma.pull(reg[1], device=cuda_device)
        assert torch.equal(out["w"], tree["w"])
    finally:
        torch.cuda.empty_cache()


# The tree whose snapshot the card must get back.
FREED_BYTES = 1 << 30


def _measured_sender(go, queue):
    """Parks a FREED_BYTES tree, then reports the card's free memory before
    its snapshot and once the receiver let go of its own copy."""
    dev = torch.device("cuda", 0)
    tree = {"w": torch.full((FREED_BYTES // 4,), 1.5, device=dev)}
    dma.snapshot({"w": torch.ones(1, device=dev)}, dev).free()  # warm-up
    torch.cuda.synchronize()
    go.get(timeout=120)  # the receiver's context is up
    before = torch.cuda.mem_get_info(dev)[0]
    queue.put(dma.try_register(tree, "127.0.0.1:0", dev)[1])
    go.get(timeout=120)  # the receiver pulled and freed its copy
    # The server frees the snapshot on the receiver's "done"; a snapshot
    # that leaked never comes back, and the last reading shows it.
    deadline = time.monotonic() + 10
    while True:
        after = torch.cuda.mem_get_info(dev)[0]
        if before - after <= MEMORY_SLACK or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    queue.put((before, after))
    time.sleep(600)


@pytest.mark.cuda
def test_the_card_gets_the_senders_snapshot_back(cuda_device):
    ctx = multiprocessing.get_context("spawn")
    go, queue = ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_measured_sender, args=(go, queue))
    proc.start()
    try:
        torch.ones(1, device=cuda_device)
        dma.snapshot({"w": torch.ones(1, device=cuda_device)},
                     cuda_device).free()  # this process's lane library
        torch.cuda.synchronize()
        go.put(True)
        payload = queue.get(timeout=120)
        ipc = dma.stats()["pulls"]["ipc"]
        out = dma.pull(payload, device=cuda_device, timeout_s=30)
        assert dma.stats()["pulls"]["ipc"] == ipc + 1
        assert torch.equal(out["w"], torch.full((FREED_BYTES // 4,), 1.5,
                                                device=cuda_device))
        del out
        torch.cuda.empty_cache()
        go.put(True)
        before, after = queue.get(timeout=60)
    finally:
        proc.kill()
        proc.join()
    assert before - after <= MEMORY_SLACK, (
        f"the card's free memory fell by {before - after} B over a push of "
        f"{FREED_BYTES} B after the receiver freed its copy")


def _parked_sender(queue):
    reg = [dma.try_register({"w": torch.full((1 << 20,), float(i),
                                             device="cuda:0")},
                            "127.0.0.1:0", "cuda:0") for i in range(2)]
    for r in reg:
        queue.put(r[1])
    time.sleep(600)


@pytest.mark.cuda
def test_a_killed_sender_makes_the_pull_raise(cuda_device):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_parked_sender, args=(queue,))
    proc.start()
    try:
        payloads = [queue.get(timeout=120) for _ in range(2)]
        # The first pull succeeds by IPC and leaves a cached connection.
        first = dma.pull(payloads[0], device=cuda_device, timeout_s=10)
        assert torch.equal(first["w"], torch.zeros(1 << 20,
                                                   device=cuda_device))
    finally:
        proc.kill()
        proc.join()
    # EOF on the cached connection, then a refused connection: each raises
    # well within the deadline instead of hanging.
    for _ in range(2):
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            dma.pull(payloads[1], device=cuda_device, timeout_s=10)
        assert time.monotonic() - t0 < 30
