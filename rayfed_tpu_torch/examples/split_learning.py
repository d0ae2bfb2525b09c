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

"""Split learning on the port: ``examples/split_learning.py`` over
``rayfed_tpu_torch``, with the same data, layers and steps.

Alice holds the feature extractor and the raw data (64x32 inputs, a 32x16
tanh layer), bob the head and the labels (16x1). Only the activations and
their gradients cross the boundary, both as ordinary owner pushes; on the
card they ride the device-DMA lane (``device_dma``), pulled by CUDA IPC
when both parties share a host and a card.

    python -m rayfed_tpu_torch.examples.split_learning alice 127.0.0.1:9121 127.0.0.1:9122
    python -m rayfed_tpu_torch.examples.split_learning bob   127.0.0.1:9121 127.0.0.1:9122
"""

import sys
import time

import numpy as np
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch.mesh import party_device

STEPS, LR = 10, 0.1
COMM = {"retry_policy": {"max_attempts": 30, "initial_backoff_ms": 500}}
#: On the card the pushes ride the device-DMA lane.
DMA_COMM = dict(COMM, device_dma=True)


@fed.remote
class Bottom:
    def __init__(self, device=None):
        dev = party_device(device)
        rng = np.random.default_rng(0)
        self.x = torch.from_numpy(
            rng.normal(size=(64, 32)).astype(np.float32)).to(dev)
        self.w = torch.from_numpy(
            rng.normal(size=(32, 16)).astype(np.float32) * 0.1).to(dev)

    def forward(self):
        self.h = torch.tanh(self.x @ self.w)
        return self.h

    def backward(self, grad_h):
        gz = grad_h * (1 - self.h**2)  # tanh'
        self.w = self.w - LR * (self.x.T @ gz) / self.x.shape[0]


@fed.remote
class Head:
    def __init__(self, device=None):
        dev = party_device(device)
        rng = np.random.default_rng(1)
        self.wh = torch.from_numpy(
            rng.normal(size=(16, 1)).astype(np.float32) * 0.1).to(dev)
        self.y = torch.from_numpy(
            rng.normal(size=(64, 1)).astype(np.float32)).to(dev)

    def step(self, h):
        wh = self.wh.detach().requires_grad_(True)
        h = h.detach().requires_grad_(True)
        loss = ((h @ wh - self.y) ** 2).mean()
        gwh, grad_h = torch.autograd.grad(loss, (wh, h))
        self.wh = (wh - LR * gwh).detach()
        self.loss = float(loss.detach())
        return grad_h

    def get_loss(self):
        return self.loss


def run(party, addresses, *, device=None, transport="cuda", comm=None,
        step_ms=None, **init_kw):
    """The program for ``party``: ``STEPS`` split-learning steps. Returns
    the head's loss after each step (every party fetches it); ``step_ms``,
    a list, gets each step's wall ms. ``init_kw`` goes to ``fed.init``."""
    fed.init(addresses=addresses, party=party, transport=transport,
             config={"cross_silo_comm": comm or DMA_COMM}, **init_kw)
    bottom = Bottom.party("alice").remote(device)
    head = Head.party("bob").remote(device)
    losses = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        h = bottom.forward.remote()
        grad_h = head.step.remote(h)
        bottom.backward.remote(grad_h)
        losses.append(fed.get(head.get_loss.remote()))
        if step_ms is not None:
            step_ms.append(1e3 * (time.perf_counter() - t0))
    fed.shutdown()
    return losses


def main(argv=None):
    party, addr_a, addr_b = (argv or sys.argv[1:])[:3]
    losses = run(party, {"alice": addr_a, "bob": addr_b})
    for step, loss in enumerate(losses):
        print(f"[{party}] step {step}: loss {loss:.5f}")
    assert losses[-1] < losses[0], \
        f"loss did not decrease: {losses[0]} -> {losses[-1]}"


if __name__ == "__main__":
    main()
