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

"""2-party federated CNN training at CIFAR-10 shapes (BASELINE config
#5), on the port: ``examples/fedavg_cnn.py`` over ``rayfed_tpu_torch``,
with the same rounds, shards, steps and sample-count weights.

Run the SAME script once per party (different machines or terminals):

    python -m rayfed_tpu_torch.examples.fedavg_cnn alice 127.0.0.1:9103 127.0.0.1:9104
    python -m rayfed_tpu_torch.examples.fedavg_cnn bob   127.0.0.1:9103 127.0.0.1:9104

Each party holds a disjoint shard of (synthetic) 32x32x3 images and
trains the shared convnet on its card; per-round weights cross the TCP
wire, land on the receiver's card (``transport="cuda"``) and are averaged
at alice weighted by the shards' sample counts, so both parties print
identical digests.
"""

import sys

import numpy as np
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch.examples._common import digest, sgd_step
from rayfed_tpu_torch.federated import FedAvgTrainer
from rayfed_tpu_torch.mesh import party_device

CLASSES, BATCH, LOCAL_STEPS, ROUNDS = 10, 64, 3, 4
LR = 0.05
SHARD = {"alice": 640, "bob": 384}  # unequal shards: exercises weighting
COMM = {"retry_policy": {"max_attempts": 30, "initial_backoff_ms": 500}}


@fed.remote
class CnnWorker:
    def __init__(self, party, seed, init=None, device=None):
        from rayfed_tpu_torch.models.cnn import init_cnn, params_from_numpy

        dev = party_device(device)
        self.params = (init_cnn(0, num_classes=CLASSES, device=dev)
                       if init is None else params_from_numpy(init, dev))
        rng = np.random.default_rng(seed)
        n = SHARD[party]
        self.x = torch.from_numpy(
            rng.normal(size=(n, 32, 32, 3)).astype(np.float32)).to(dev)
        self.y = torch.from_numpy(rng.integers(0, CLASSES, size=(n,))).to(dev)
        self._n = n
        self._i = 0

    def train(self, global_params):
        from rayfed_tpu_torch.models.cnn import cnn_loss

        if global_params is not None:
            self.params = global_params
        for _ in range(LOCAL_STEPS):
            lo = self._i % (self._n - BATCH + 1)
            self.params, loss = sgd_step(cnn_loss, self.params,
                                         self.x[lo: lo + BATCH],
                                         self.y[lo: lo + BATCH], LR)
            self._i += BATCH
        self._last_loss = float(loss)
        return self.params

    def num_samples(self):
        return float(self._n)

    def loss(self):
        return self._last_loss


def run(party, addresses, *, rounds=ROUNDS, device=None, transport="cuda",
        init=None, comm=None):
    """The program for ``party``: ``rounds`` FedAvg rounds weighted by the
    shard sizes. Returns each round's aggregate as numpy, the final
    aggregate's digest and this party's last local loss."""
    from rayfed_tpu_torch.models.cnn import params_to_numpy

    fed.init(addresses=addresses, party=party, transport=transport,
             config={"cross_silo_comm": comm or COMM})
    trainer = FedAvgTrainer(
        CnnWorker, ["alice", "bob"],
        worker_args={"alice": ("alice", 1, init, device),
                     "bob": ("bob", 2, init, device)},
        op="wmean",
        weights={p: float(n) for p, n in SHARD.items()},
    )
    history, global_params = [], None
    for _ in range(rounds):
        global_params = trainer.run(1, global_params)
        history.append(fed.get(global_params))
    loss = fed.get(trainer.workers[party].loss.remote())
    fed.shutdown()
    return dict(rounds=[params_to_numpy(t) for t in history],
                digest=digest(history[-1]), loss=loss)


def main(argv=None):
    party, addr_a, addr_b = (argv or sys.argv[1:])[:3]
    out = run(party, {"alice": addr_a, "bob": addr_b})
    conv0 = float(out["rounds"][-1]["convs"][0]["w"].sum())
    print(f"[{party}] final conv0 digest {conv0:.6f} ({out['digest'][:16]}), "
          f"local loss {out['loss']:.4f}")


if __name__ == "__main__":
    main()
