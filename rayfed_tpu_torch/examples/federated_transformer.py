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

"""Federated LM training on the port: ``examples/federated_transformer.py``
over ``rayfed_tpu_torch``. Each party takes a local AdamW step on its
card per round; weight trees cross per round over the TCP wire, land on
the receiver's card (``transport="cuda"``), and ``fed_aggregate`` averages
them at alice.

Run once per party:

    python -m rayfed_tpu_torch.examples.federated_transformer alice 127.0.0.1:9111 127.0.0.1:9112
    python -m rayfed_tpu_torch.examples.federated_transformer bob   127.0.0.1:9111 127.0.0.1:9112
"""

import sys

import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.federated import fed_aggregate
from rayfed_tpu_torch.mesh import party_device

ROUNDS = 3
PARTIES = ("alice", "bob")
COMM = {"retry_policy": {"max_attempts": 30, "initial_backoff_ms": 500}}


@fed.remote
class LmWorker:
    """One party's params and AdamW state on its card, fed by a
    prefetching batch iterator over its own token shard."""

    def __init__(self, seed, cfg=None, *, batch=8, seq=64, local_steps=1,
                 lr=1e-2, device=None):
        from rayfed_tpu_torch.data import make_batch_iterator, synthetic_lm_dataset
        from rayfed_tpu_torch.models import transformer as tfm
        from rayfed_tpu_torch.parallel.train import make_fed_train_step

        self.cfg = cfg or tfm.tiny_config(vocab=512, d_model=128, n_heads=4,
                                          n_layers=2, d_ff=352)
        self.device = party_device(device)
        # The step updates params in place (donate): the tree this worker
        # returns is consumed (pushed, or folded at the root) before the
        # next round's train, which depends on that round's aggregate.
        init_fn, self._step_fn = make_fed_train_step(self.cfg, self.device,
                                                     lr=lr)
        self.params, self.opt_state = init_fn(0)
        data = synthetic_lm_dataset(self.cfg.vocab,
                                    batch * local_steps * (seq + 1), seq,
                                    seed=seed)
        self._batches = make_batch_iterator(data, batch, self.device)
        self._local_steps = local_steps
        self._received = []

    def train(self, global_params):
        if global_params is not None:
            params, spec = tree_util.tree_flatten(self.params)
            # By key path: a tree from a JAX root has its dict keys sorted.
            leaves = tree_util.leaves_like(global_params, spec)
            self._received = sorted({str(x.device) for x in leaves})
            # No copy to the card here: the lane placed the tree on it.
            with torch.no_grad():
                for p, g in zip(params, leaves):
                    p.copy_(g)
        for _ in range(self._local_steps):
            inputs, targets = next(self._batches)
            self.params, self.opt_state, loss = self._step_fn(
                self.params, self.opt_state, inputs, targets)
        self._loss = float(loss)
        return self.params

    def loss(self):
        return self._loss

    def received_devices(self):
        """The devices the last global tree's leaves arrived on."""
        return self._received


def run(party, workers, rounds=ROUNDS, on_round=None):
    """The rounds: every party's worker trains, ``fed_aggregate`` folds the
    trees at alice, the next round starts from the aggregate.
    ``on_round(r, locals_, global_params)`` sees each round's FedObjects.
    Returns the final aggregate (``fed.get``)."""
    global_params = None
    for r in range(rounds):
        locals_ = {p: workers[p].train.remote(global_params) for p in workers}
        global_params = fed_aggregate(locals_, op="mean")
        my_loss = fed.get(workers[party].loss.remote())
        print(f"[{party}] round {r}: local loss {my_loss:.4f}", flush=True)
        if on_round is not None:
            on_round(r, locals_, global_params)
    return fed.get(global_params)


def main(argv=None):
    party, addr_a, addr_b = (argv or sys.argv[1:])[:3]
    fed.init(addresses={"alice": addr_a, "bob": addr_b}, party=party,
             transport="cuda", config={"cross_silo_comm": COMM})
    workers = {p: LmWorker.party(p).remote(seed=i)
               for i, p in enumerate(PARTIES)}
    final = run(party, workers)
    digest = float(sum(x.double().sum() for x in
                       tree_util.tree_flatten(final)[0]))
    placed = fed.get(workers[party].received_devices.remote())
    print(f"[{party}] final aggregate digest {digest:.6f}; global trees "
          f"received on {placed}")
    fed.shutdown()


if __name__ == "__main__":
    main()
