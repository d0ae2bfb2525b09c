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

"""The CUDA placement lane and the device iterator on the card. Every
test here is marked ``cuda`` and skips without an sm_90 card. The file
imports neither JAX nor the JAX package, so it runs on a machine that
has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lane.py
"""

import socket

import numpy as np
import pytest
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.proxy.cuda import cuda_proxy
from rayfed_tpu_torch.proxy.cuda.cuda_proxy import PinnedStaging

FAST = {"retry_policy": {"max_attempts": 5, "initial_backoff_ms": 100}}


@pytest.fixture
def small_slots(monkeypatch):
    """1 MiB staging slots, so that the test trees span several."""
    monkeypatch.setattr(cuda_proxy, "STAGING_SLOT_BYTES", 1 << 20)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the lane places on one)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the port targets sm_90 (Hopper) cards")
    return torch.device("cuda", 0)


def _addresses(n):
    out = []
    for _ in range(n):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            out.append(f"127.0.0.1:{s.getsockname()[1]}")
    return out


def _tree():
    g = torch.Generator().manual_seed(5)
    return {"w": torch.randn(1000, 777, generator=g),   # > 2 slots of 1 MiB
            "layers": [{"h": torch.randn(33, generator=g).to(torch.bfloat16),
                        "i": torch.arange(7, dtype=torch.int64)}],
            "s": torch.tensor(3.5), "empty": torch.zeros(0, 4), "step": 4}


def _same_bits(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_leaves_land_on_the_card_with_dtype_and_bits(cuda_device, small_slots):
    tree = _tree()
    leaves, spec = tree_util.tree_flatten(tree)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    staging = PinnedStaging(cuda_device)
    placed = staging.place(tensors)
    for src, dst in zip(tensors, placed):
        assert dst.device == cuda_device
        assert _same_bits(dst, src)


@pytest.mark.cuda
def test_pinned_staging_is_reused_across_pushes(cuda_device, small_slots):
    staging = PinnedStaging(cuda_device)
    assert staging.slot_pointers() == []
    staging.place([torch.randn(300_000)])
    first = staging.slot_pointers()
    assert len(first) == 2
    for n in (5_000_000, 17, 1_000_000):
        x = torch.randn(n)
        assert _same_bits(staging.place([x])[0], x)
        assert staging.slot_pointers() == first


@pytest.mark.cuda
def test_a_consumer_on_the_default_stream_reads_the_landed_bytes(cuda_device):
    staging = PinnedStaging(cuda_device)
    n = 64 << 20  # 256 MiB of f32
    a = torch.randn(n, device=cuda_device)
    want = float(a.double().sum())
    m = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(3):
        # Queue seconds of default-stream work, then a read of x behind
        # it; x's block is freed at once and the placement may be handed
        # that block while the read is still queued: the lane's side
        # stream must wait for the default stream before it writes.
        x = a.clone()
        for _ in range(40):
            m = m @ m / 64.0
        s = x.double().sum()
        del x
        host = torch.randn(n)
        placed = staging.place([host])[0]
        assert float(s) == want
        # Read at once on the default stream: the bytes have landed.
        assert bool(torch.equal(placed, host.to(cuda_device)))


def _fold_trees(dtype, n=3):
    g = torch.Generator().manual_seed(11)
    return [{"w": (torch.randn(300, 257, generator=g) * 4).to(dtype),
             "b": torch.randn(1031, generator=g).to(dtype)}
            for _ in range(n)]


# Weights that are not exact in bf16 and a total (1002.57) that is not
# exact in f32, so a divide taken as a multiply by the reciprocal, or a
# scalar met in f32 by a bf16 leaf, changes bits.
FOLD_WEIGHTS = (0.37, 1.7, 1000.5)


def _folds():
    from rayfed_tpu_torch import topology
    from rayfed_tpu_torch.ops import aggregate as agg

    names = ["p0", "p1", "p2"]
    weights = dict(zip(names, FOLD_WEIGHTS))

    def by_plan(shape, w):
        def run(trees):
            return agg.reduce_by_plan(topology.plan(names, shape),
                                      dict(zip(names, trees)), w)
        return run

    return {
        "reduce_by_plan flat mean": by_plan("flat", None),
        "reduce_by_plan flat wmean": by_plan("flat", weights),
        "reduce_by_plan tree wmean": by_plan("tree", weights),
        "tree_divide by 3": lambda t: agg.tree_divide(agg.tree_sum(*t), 3.0),
        "tree_divide by the total":
            lambda t: agg.tree_divide(agg.tree_sum(*t), sum(FOLD_WEIGHTS)),
        "tree_scale": lambda t: agg.tree_scale(t[0], FOLD_WEIGHTS[0]),
        "tree_mean": lambda t: agg.tree_mean(*t),
        "tree_weighted_mean":
            lambda t: agg.tree_weighted_mean(t, list(FOLD_WEIGHTS)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold", list(_folds()))
def test_folds_on_the_card_give_the_cpu_bits(cuda_device, fold, dtype):
    """The root folds received trees on its card under transport="cuda";
    the CPU tests hold the CPU folds bitwise to the JAX package, and this
    holds the card's folds bitwise to the CPU's."""
    trees = _fold_trees(dtype)
    fn = _folds()[fold]
    want = fn(trees)
    got = fn([tree_util.tree_map(lambda x: x.to(cuda_device), t)
              for t in trees])
    for a, b in zip(tree_util.tree_flatten(got)[0],
                    tree_util.tree_flatten(want)[0]):
        assert a.device == cuda_device
        assert _same_bits(a, b), (fold, int((a.cpu() != b).sum()))


@pytest.mark.cuda
def test_cuda_receiver_places_a_pushed_tree(cuda_device):
    from rayfed_tpu_torch.proxy.cuda.cuda_proxy import (
        CudaReceiverProxy,
        CudaSenderProxy,
    )

    a_addr, b_addr = _addresses(2)
    addr = {"alice": a_addr, "bob": b_addr}
    rp = CudaReceiverProxy(addr["bob"], "bob", "job", None, dict(FAST))
    rp.start()
    ok, err = rp.is_ready()
    assert ok, err
    sp = CudaSenderProxy(addr, "alice", "job", None, dict(FAST))
    sp.start()
    try:
        tree = _tree()
        assert sp.send("bob", tree, "1#0", 1).result(timeout=60) is True
        got = rp.get_data("alice", "1#0", 1).result(timeout=60)
        sent, spec = tree_util.tree_flatten(tree)
        recv, spec2 = tree_util.tree_flatten(got)
        assert spec == spec2
        for s, r in zip(sent, recv):
            if isinstance(s, torch.Tensor):
                assert r.device == cuda_device and _same_bits(r, s)
            else:
                assert r == s
    finally:
        sp.stop()
        rp.stop()


@pytest.mark.cuda
def test_fed_init_binds_the_party_card(cuda_device):
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh

    (addr,) = _addresses(1)
    fed.init(addresses={"alice": addr}, party="alice",
             config={"party_mesh": {"device_ids": [0]}}, transport="cuda")
    try:
        assert mesh.get_party_device() == cuda_device
    finally:
        fed.shutdown()
    assert mesh.get_party_device() is None


@pytest.mark.cuda
def test_batch_iterator_on_the_card_equals_the_cpu_blocks(cuda_device):
    from rayfed_tpu_torch.data import make_batch_iterator, synthetic_lm_dataset

    ds = synthetic_lm_dataset(vocab=1000, n_tokens=12 * 257 * 3, seq_len=256,
                              seed=4)
    with make_batch_iterator(ds, 12, "cpu", epochs=2) as it:
        want = list(it)
    with make_batch_iterator(ds, 12, cuda_device, epochs=2, prefetch=2) as it:
        got = list(it)
    assert len(got) == len(want) == 6
    for (x, y), (cx, cy) in zip(got, want):
        assert x.device == cuda_device and x.dtype == torch.int32
        assert torch.equal(x.cpu(), cx) and torch.equal(y.cpu(), cy)
        # Consumed on the default stream right away.
        assert bool(torch.equal(x[:, 1:], y[:, :-1]))
    assert np.array_equal(got[0][0].cpu().numpy(), want[0][0].numpy())
