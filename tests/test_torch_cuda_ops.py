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

"""The fault injector on card tensors: a ``corrupt`` rule flips one bit
of each card leaf, the same bit as in a CPU leaf with the same bytes, in
a copy that stays on the card, and link pacing counts a card leaf's
bytes. Every test is marked ``cuda`` and skips without an sm_90 card.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ops.py
"""

import pytest
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.resilience.inject import (
    FaultSchedule,
    InjectingSenderProxy,
    _corrupt_value,
    _estimate_nbytes,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the leaves live on one)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the port targets sm_90 (Hopper) cards")
    return torch.device("cuda", 0)


def _tree():
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(1000, 777, generator=g),
            "layers": [{"h": torch.randn(513, 129, generator=g)
                        .to(torch.bfloat16)},
                       {"i": torch.arange(4099, dtype=torch.int64)}],
            "step": 7}


def _ints(x):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.contiguous().reshape(-1).view(ints[x.element_size()])


@pytest.mark.cuda
def test_corrupt_flips_the_cpu_bit_of_each_card_leaf_on_the_card(cuda_device):
    host = _tree()
    card = dict(host, w=host["w"].to(cuda_device), layers=[
        {k: v.to(cuda_device) for k, v in layer.items()}
        for layer in host["layers"]])
    got = _corrupt_value(card, 11, "alice", "bob", "3#0", "4")
    want = _corrupt_value(host, 11, "alice", "bob", "3#0", "4")
    assert got["step"] == 7
    for g, w, before in zip(tree_util.tree_flatten(got)[0],
                            tree_util.tree_flatten(want)[0],
                            tree_util.tree_flatten(card)[0]):
        if not isinstance(g, torch.Tensor):
            continue
        assert g.device == cuda_device and g.dtype == before.dtype
        assert g.shape == before.shape
        assert torch.equal(_ints(g).cpu(), _ints(w))
        diff = (_ints(g) ^ _ints(before)).cpu()
        mask = (1 << (8 * g.element_size())) - 1
        assert sum(bin(int(d) & mask).count("1")
                   for d in diff[diff != 0]) == 1


class _NullSender:
    def send(self, dest, data, up, down, is_error=False):
        from concurrent.futures import Future

        out = Future()
        out.set_result(True)
        return out

    def get_stats(self):
        return {}


@pytest.mark.cuda
def test_link_pacing_counts_a_card_leafs_bytes(cuda_device):
    w = torch.zeros(3125, dtype=torch.float32, device=cuda_device)
    assert _estimate_nbytes({"w": w}) == 12500
    inj = InjectingSenderProxy(
        _NullSender(),
        FaultSchedule.from_dict({"seed": 0, "links": [{"rate_mbit": 1}]}),
        "alice",
    )
    assert inj.send("bob", {"w": w}, 1, 1).result(timeout=5) is True
    assert inj.link_stats()["paced_bytes"] == 12500
