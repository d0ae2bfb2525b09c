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

"""2-party FedAvg logistic regression at MNIST shapes (BASELINE config
#3), on the port: ``examples/fedavg_logreg.py`` over
``rayfed_tpu_torch``, with the same rounds, shards and steps.

Run the SAME script once per party (different machines or terminals):

    python -m rayfed_tpu_torch.examples.fedavg_logreg alice 127.0.0.1:9101 127.0.0.1:9102
    python -m rayfed_tpu_torch.examples.fedavg_logreg bob   127.0.0.1:9101 127.0.0.1:9102

Each party trains on its own synthetic data shard on its card; weights
cross the TCP wire and land on the receiver's card (``transport="cuda"``);
``fed_aggregate`` averages them at alice, so both parties print identical
digests.
"""

import sys

import numpy as np
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch.examples._common import digest, sgd_step
from rayfed_tpu_torch.federated import FedAvgTrainer
from rayfed_tpu_torch.mesh import party_device

DIM, CLASSES, BATCH, ROUNDS = 784, 10, 128, 5
LOCAL_STEPS, LR = 3, 0.1
PARTIES = ("alice", "bob")
COMM = {"retry_policy": {"max_attempts": 30, "initial_backoff_ms": 500}}


@fed.remote
class LogRegWorker:
    def __init__(self, seed, init=None, device=None):
        from rayfed_tpu_torch.models.mlp import init_logreg, params_from_numpy

        dev = party_device(device)
        self.params = (init_logreg(0, DIM, CLASSES, device=dev) if init is None
                       else params_from_numpy(init, dev))
        rng = np.random.default_rng(seed)
        self.x = torch.from_numpy(
            rng.normal(size=(BATCH, DIM)).astype(np.float32)).to(dev)
        self.y = torch.from_numpy(rng.integers(0, CLASSES, size=(BATCH,))).to(dev)

    def train(self, global_params):
        from rayfed_tpu_torch.models.mlp import logreg_loss

        if global_params is not None:
            self.params = global_params
        for _ in range(LOCAL_STEPS):  # local epochs
            self.params, loss = sgd_step(logreg_loss, self.params, self.x,
                                         self.y, LR)
        self._last_loss = float(loss)
        return self.params

    def loss(self):
        return self._last_loss


def run(party, addresses, *, rounds=ROUNDS, device=None, transport="cuda",
        init=None, comm=None):
    """The program for ``party``: ``rounds`` FedAvg rounds. Returns each
    round's aggregate as numpy, the final aggregate's digest and this
    party's last local loss."""
    from rayfed_tpu_torch.models.mlp import params_to_numpy

    fed.init(addresses=addresses, party=party, transport=transport,
             config={"cross_silo_comm": comm or COMM})
    trainer = FedAvgTrainer(
        LogRegWorker, list(PARTIES),
        worker_args={"alice": (1, init, device), "bob": (2, init, device)},
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
    w_sum = float(out["rounds"][-1]["w"].sum())
    print(f"[{party}] final weight digest {w_sum:.6f} ({out['digest'][:16]}), "
          f"local loss {out['loss']:.4f}")


if __name__ == "__main__":
    main()
