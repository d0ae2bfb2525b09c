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

"""Federated LoRA fine-tuning on the port: ``examples/fedavg_lora.py`` over
``rayfed_tpu_torch``. Only adapter trees cross the wire.

Every party holds the same frozen base LM (distributed once out of band)
and fine-tunes low-rank adapters on its private tokens on its card; each
round ``fed_aggregate`` averages just the A/B matrices at alice, orders of
magnitude smaller than the base weights (the ratio printed per round is
derived from ``lora_nbytes``). The merged model is identical in every
party after each round. The rounds issue the JAX package's calls in its
order, so one party may run this program and the other the JAX package's.

    python -m rayfed_tpu_torch.examples.fedavg_lora alice 127.0.0.1:9131 127.0.0.1:9132
    python -m rayfed_tpu_torch.examples.fedavg_lora bob   127.0.0.1:9131 127.0.0.1:9132
"""

import sys

import numpy as np
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.examples._common import digest
from rayfed_tpu_torch.federated import fed_aggregate
from rayfed_tpu_torch.mesh import party_device

ROUNDS = 2
LOCAL_STEPS = 3  # Adam steps between aggregation rounds
RANK = 8
SEEDS = {"alice": 11, "bob": 22}
COMM = {"retry_policy": {"max_attempts": 30, "initial_backoff_ms": 500}}


@fed.remote
class LoraWorker:
    """One party's frozen base, adapters and Adam state on its card.

    ``init`` carries weights and data over as numpy (``{"params",
    "adapters", "tokens"}``: a base tree, an adapter ``layers`` tree and a
    (batch, seq + 1) token block), for example the JAX package's; without
    it the base comes from seed 0 and the adapters from seed 1 in every
    party, the tokens from ``seed``."""

    def __init__(self, seed, cfg=None, *, batch=8, seq=64, lr=1e-2, init=None,
                 device=None):
        from rayfed_tpu_torch.models import lora, transformer as tfm

        self.lora = lora
        self.cfg = cfg or tfm.tiny_config(vocab=512, d_model=128, n_heads=4,
                                          n_layers=2, d_ff=352)
        dev = party_device(device)
        if init is None:
            self.params = tfm.init_params(0, self.cfg, dev)
            self.ad = lora.init_lora(1, self.cfg, rank=RANK, device=dev)
            tok = np.random.default_rng(seed).integers(
                0, self.cfg.vocab, (batch, seq + 1))
        else:
            self.params = tfm.params_from_numpy(init["params"], dev)
            self.ad = {"layers": tfm.params_from_numpy(init["adapters"], dev),
                       "alpha": float(RANK), "rank": RANK}
            tok = np.asarray(init["tokens"])
        tok = torch.as_tensor(tok, device=dev).long()
        self.inputs, self.targets = tok[:, :-1], tok[:, 1:]
        self.step, optimizer = lora.make_lora_train_step(self.cfg, lr=lr)
        self.opt = optimizer.init(self.ad["layers"])

    def train(self, global_ab):
        if global_ab is not None:
            self.ad = {**self.ad, "layers": global_ab}
        for _ in range(LOCAL_STEPS):
            self.ad, self.opt, loss = self.step(
                self.params, self.ad, self.opt, self.inputs, self.targets)
        self._loss = float(loss)
        return self.ad["layers"]

    def report(self, global_ab):
        """Loss, merged-model digest (must match across parties) and how
        many times smaller the push is than the base weights."""
        with torch.no_grad():
            merged = self.lora.merge_lora(
                self.params, {**self.ad, "layers": global_ab})
            digest = float(sum(x.double().sum()
                               for x in tree_util.tree_flatten(merged)[0]))
        pushed = self.lora.lora_nbytes({"layers": global_ab})
        return self._loss, digest, self._base_nbytes() / max(pushed, 1)

    def _base_nbytes(self):
        return sum(x.numel() * x.element_size()
                   for x in tree_util.tree_flatten(self.params)[0])

    def digests(self, global_ab=None):
        """sha256 of the model merged with ``global_ab`` (this worker's own
        adapters when None) and of the frozen base, each over its leaves
        in sorted key-path order (the JAX package's tree order), so equal
        trees hash the same in either package; and the base's bytes."""
        layers = self.ad["layers"] if global_ab is None else global_ab
        with torch.no_grad():
            merged = self.lora.merge_lora(
                self.params, {**self.ad, "layers": layers})
        return {"merged": digest(_sorted(merged)),
                "base": digest(_sorted(self.params)),
                "base_bytes": self._base_nbytes()}


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def run(party, workers, rounds=ROUNDS, on_round=None):
    """The rounds: both workers train from the last aggregate, alice folds
    the adapter trees (``fed_aggregate`` mean), both report on it.
    ``on_round(r, locals_, g, reports)`` sees each round's pushed adapter
    trees and aggregate (FedObjects) and both reports. Returns the final
    aggregate's FedObject."""
    wa, wb = workers["alice"], workers["bob"]
    g = None
    for rnd in range(rounds):
        locals_ = {"alice": wa.train.remote(g), "bob": wb.train.remote(g)}
        g = fed_aggregate(locals_, op="mean")
        # Multi-controller rule: every party issues the same calls; both
        # reports are requested everywhere, each party prints its own.
        ra, rb = wa.report.remote(g), wb.report.remote(g)
        reports = fed.get([ra, rb])
        (loss_a, dig_a, ratio), (loss_b, dig_b, _) = reports
        # Bitwise-equal merged models give equal digests on one package;
        # across packages the f64 sums may add in another order.
        assert abs(dig_a - dig_b) <= 1e-6 * max(1.0, abs(dig_a)), (
            f"merged models diverged: {dig_a} != {dig_b}")
        loss = loss_a if party == "alice" else loss_b
        print(f"[{party}] round {rnd}: loss {loss:.4f} "
              f"(pushes {ratio:.0f}x smaller than full weights)", flush=True)
        if on_round is not None:
            on_round(rnd, locals_, g, reports)
    print(f"[{party}] merged-model digest identical in both parties",
          flush=True)
    return g


def main(argv=None):
    party, addr_a, addr_b = (argv or sys.argv[1:])[:3]
    fed.init(addresses={"alice": addr_a, "bob": addr_b}, party=party,
             transport="cuda", config={"cross_silo_comm": COMM})
    workers = {p: LoraWorker.party(p).remote(seed)
               for p, seed in SEEDS.items()}
    run(party, workers)
    fed.shutdown()


if __name__ == "__main__":
    main()
