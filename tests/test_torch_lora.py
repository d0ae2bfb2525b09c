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

"""The port's LoRA adapters (``rayfed_tpu_torch.models.lora``) and its
``examples/fedavg_lora.py``: mirrors of ``tests/test_lora.py``, the merge
held bitwise against the JAX package's in f32, the adapter training
against the JAX package's at the train tests' tolerances (Adam rounds
differently in torch and optax), and a LoRA round with a JAX alice and a
torch bob."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu.models import lora as jlora
from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import lora, transformer as tfm
from tests.utils import FAST_COMM_CONFIG, run_parties

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
LR = 1e-2
# Adapters after Adam: 1% of one step's learning rate, absolute (the train
# tests' bound for AdamW, tests/test_torch_train.py).
ADAPTER_TOL = 1e-2 * LR


def _cfg(**kw):
    return tfm.tiny_config(compute_dtype=torch.float32, **kw)


def _jcfg(**kw):
    return jtfm.tiny_config(compute_dtype=jnp.float32, **kw)


def _carried(jtree):
    return tfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                 device="cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _leaves(tree):
    return tree_util.tree_flatten(tree)[0]


# ---------------------------------------------------------------------------
# Mirrors of tests/test_lora.py
# ---------------------------------------------------------------------------


def test_zero_init_matches_base():
    cfg = _cfg()
    params = tfm.init_params(0, cfg, device="cpu")
    ad = lora.init_lora(1, cfg, rank=4, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg.vocab, (2, 12), 2))
    base = tfm.forward(params, tokens, cfg)
    merged = tfm.forward(lora.merge_lora(params, ad), tokens, cfg)
    torch.testing.assert_close(merged, base, rtol=1e-6, atol=1e-6)


def test_adapter_training_reduces_loss_base_frozen():
    cfg = _cfg()
    params = tfm.init_params(3, cfg, device="cpu")
    frozen = [p.clone() for p in _leaves(params)]
    ad = lora.init_lora(4, cfg, rank=4, device="cpu")
    tokens = _tokens(cfg.vocab, (4, 17), 5)
    step, optimizer = lora.make_lora_train_step(cfg, lr=1e-2)
    opt_state = optimizer.init(ad["layers"])
    losses = []
    for _ in range(8):
        ad, opt_state, loss = step(params, ad, opt_state, tokens[:, :-1],
                                   tokens[:, 1:])
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    # The base tree never changed, and took no gradient.
    for a, b in zip(_leaves(params), frozen):
        assert torch.equal(a, b) and a.grad is None


def test_adapter_is_small():
    cfg = _cfg()
    params = tfm.init_params(6, cfg, device="cpu")
    ad = lora.init_lora(7, cfg, rank=2, device="cpu")
    base_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    assert lora.lora_nbytes(ad) < base_bytes * 0.25


def test_validation():
    cfg = _cfg()
    with pytest.raises(ValueError, match="rank"):
        lora.init_lora(0, cfg, rank=0, device="cpu")
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        lora.init_lora(0, cfg, targets=("wz",), device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        lora.init_lora(0, tfm.tiny_config(n_experts=2),
                       targets=("wq", "w_up"), device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        lora.init_lora(0, cfg, alpha=0.0, device="cpu")
    # Attention targets on an MoE config are fine.
    moe_ad = lora.init_lora(0, tfm.tiny_config(n_experts=2), device="cpu")
    assert list(moe_ad["layers"]) == list(lora.ATTN_TARGETS)


def test_mlp_targets_train():
    cfg = _cfg()
    params = tfm.init_params(8, cfg, device="cpu")
    ad = lora.init_lora(9, cfg, rank=2,
                        targets=("wq", "wo", "w_gate", "w_up", "w_down"),
                        device="cpu")
    tokens = torch.from_numpy(_tokens(cfg.vocab, (2, 9), 10))
    leaves = [x.requires_grad_(True) for x in _leaves(ad["layers"])]
    loss = lora.lora_loss(params, ad, tokens[:, :-1], tokens[:, 1:], cfg)
    loss.backward()
    assert torch.isfinite(loss)
    assert sum(float(x.grad.abs().sum()) for x in leaves) > 0.0


def run_federated_lora(party, addresses):
    """Parties push only adapter trees; the aggregated adapter gives
    identical merged models on both sides."""
    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": dict(FAST_COMM_CONFIG)})
    cfg = _cfg()

    @fed.remote
    class LoraWorker:
        def __init__(self, seed):
            self.params = tfm.init_params(0, cfg, device="cpu")
            self.ad = lora.init_lora(1, cfg, rank=4, device="cpu")
            tok = _tokens(cfg.vocab, (4, 17), seed)
            self.inputs, self.targets = tok[:, :-1], tok[:, 1:]
            self.step, optimizer = lora.make_lora_train_step(cfg, lr=1e-2)
            self.opt = optimizer.init(self.ad["layers"])

        def train(self, global_ab):
            if global_ab is not None:
                self.ad = {**self.ad, "layers": global_ab}
            for _ in range(2):
                self.ad, self.opt, loss = self.step(
                    self.params, self.ad, self.opt, self.inputs, self.targets)
            self._loss = float(loss)
            return tree_util.tree_map(lambda x: x.detach().clone(),
                                      self.ad["layers"])

        def digest(self, global_ab):
            merged = lora.merge_lora(self.params,
                                     {**self.ad, "layers": global_ab})
            return float(sum(x.double().sum() for x in _leaves(merged)))

    @fed.remote
    def avg(a, b):
        la, spec = tree_util.tree_flatten(a)
        lb = tree_util.leaves_like(b, spec)
        return tree_util.tree_unflatten(
            [(x + y) / 2.0 for x, y in zip(la, lb)], spec)

    wa = LoraWorker.party("alice").remote(11)
    wb = LoraWorker.party("bob").remote(22)
    g = None
    for _ in range(2):
        g = avg.party("alice").remote(wa.train.remote(g), wb.train.remote(g))
    da = fed.get(wa.digest.remote(g))
    db = fed.get(wb.digest.remote(g))
    assert da == db, (da, db)
    fed.shutdown()


def test_federated_lora_round():
    run_parties(run_federated_lora, ["alice", "bob"], timeout=240)


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("targets,d_ff,max_ulp", [
    (lora.ATTN_TARGETS, 176, 0), (tuple(lora._TARGETS), 192, 0),
    (tuple(lora._TARGETS), 176, 2),
], ids=["attention", "all-dff192", "all-dff176"])
def test_merge_is_bitwise_the_jax_merge_in_f32(targets, d_ff, max_ulp):
    # Bitwise wherever XLA's CPU dot sums the rank-r product in sequence
    # with FMAs, as torch does: every output width that is a multiple of
    # 64 (all attention targets here and at the flagship width, and the
    # FFN targets at d_ff 192 or the flagship's 5632). At d_ff 176 XLA sums
    # the FFN targets' products in vector lanes, so they may differ in the
    # last bits (ROADMAP Queue 3).
    jcfg = _jcfg(d_ff=d_ff)
    jparams = jtfm.init_params(jax.random.PRNGKey(11), jcfg)
    jad = jlora.init_lora(jax.random.PRNGKey(12), jcfg, rank=4,
                          targets=targets, alpha=6.0)
    # Nonzero b, so every delta is a real product.
    jad["layers"] = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(13),
                                               x.shape), jad["layers"])
    want = jax.tree_util.tree_map(np.asarray, jlora.merge_lora(jparams, jad))
    ad = {**jad, "layers": _carried(jad["layers"])}
    got = tfm.params_to_numpy(lora.merge_lora(_carried(jparams), ad))
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        ffn = any(t in jax.tree_util.keystr(path)
                  for t in ("w_gate", "w_up", "w_down"))
        if max_ulp and ffn:
            # Within max_ulp ulps of the leaf's largest entry.
            np.testing.assert_allclose(
                flat[path], w, rtol=0,
                atol=max_ulp * float(np.spacing(np.abs(w).max())))
        else:
            np.testing.assert_array_equal(flat[path], w,
                                          err_msg=jax.tree_util.keystr(path))


def test_init_lora_matches_reference_shapes():
    jcfg, cfg = _jcfg(), _cfg()
    targets = tuple(lora._TARGETS)
    want = jlora.init_lora(jax.random.PRNGKey(0), jcfg, rank=3,
                           targets=targets)
    got = lora.init_lora(0, cfg, rank=3, targets=targets, device="cpu")
    assert (got["alpha"], got["rank"]) == (want["alpha"], want["rank"])
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), want["layers"])
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                  got["layers"]) == shapes
    assert all(bool((ab["b"] == 0).all()) for ab in got["layers"].values())
    assert lora.lora_nbytes(got) == jlora.lora_nbytes(want)


def test_adapter_training_matches_reference():
    jcfg, cfg = _jcfg(), _cfg()
    jparams = jtfm.init_params(jax.random.PRNGKey(14), jcfg)
    jad = jlora.init_lora(jax.random.PRNGKey(15), jcfg, rank=4)
    params, ad = _carried(jparams), {**jad, "layers": _carried(jad["layers"])}
    jstep, joptimizer = jlora.make_lora_train_step(jcfg, lr=LR)
    step, optimizer = lora.make_lora_train_step(cfg, lr=LR)
    jopt, opt = joptimizer.init(jad["layers"]), optimizer.init(ad["layers"])
    jlosses, losses = [], []
    for i in range(4):
        tok = _tokens(cfg.vocab, (4, 17), 16 + i).astype(np.int32)
        jad, jopt, jloss = jstep(jparams, jad, jopt, jnp.asarray(tok[:, :-1]),
                                 jnp.asarray(tok[:, 1:]))
        ad, opt, loss = step(params, ad, opt, tok[:, :-1], tok[:, 1:])
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jad["layers"])))
    got = dict(jax.tree_util.tree_leaves_with_path(
        tfm.params_to_numpy(ad["layers"])))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=ADAPTER_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_step_pairs_a_sorted_key_tree_by_key_path():
    # A tree from a JAX root has its keys sorted ("wk" before "wq"): the
    # step loads each leaf into the optimizer's tensor of the same path.
    cfg = _cfg()
    params = tfm.init_params(0, cfg, device="cpu")
    ad = lora.init_lora(1, cfg, rank=2, device="cpu")
    step, optimizer = lora.make_lora_train_step(cfg, lr=0.0)
    opt = optimizer.init(ad["layers"])
    marked = {t: {"a": torch.full_like(ab["a"], i + 1.0),
                  "b": torch.full_like(ab["b"], -(i + 1.0))}
              for i, (t, ab) in enumerate(ad["layers"].items())}
    sorted_tree = {t: marked[t] for t in sorted(marked)}
    tok = _tokens(cfg.vocab, (2, 9), 3)
    new, _, _ = step(params, {**ad, "layers": sorted_tree}, opt,
                     tok[:, :-1], tok[:, 1:])
    assert list(new["layers"]) == list(ad["layers"])
    for t, ab in new["layers"].items():
        assert torch.equal(ab["a"], marked[t]["a"])
        assert torch.equal(ab["b"], marked[t]["b"])


def test_step_returns_new_trees_and_changes_none_it_was_given():
    # The reference's step is functional: a tree it returned keeps its
    # values through later steps, so the delta of two steps is not zero.
    cfg = _cfg()
    params = tfm.init_params(0, cfg, device="cpu")
    ad0 = lora.init_lora(1, cfg, rank=2, device="cpu")
    kept0 = tree_util.tree_map(torch.clone, ad0["layers"])
    step, optimizer = lora.make_lora_train_step(cfg, lr=1e-2)
    opt = optimizer.init(ad0["layers"])
    tok = _tokens(cfg.vocab, (2, 9), 4)
    ad1, opt, _ = step(params, ad0, opt, tok[:, :-1], tok[:, 1:])
    kept1 = tree_util.tree_map(torch.clone, ad1["layers"])
    ad2, opt, _ = step(params, ad1, opt, tok[:, :-1], tok[:, 1:])
    for was, tree in ((kept0, ad0), (kept1, ad1)):
        for a, b in zip(tree_util.tree_flatten(was)[0],
                        tree_util.tree_flatten(tree["layers"])[0]):
            assert torch.equal(a, b)
    live = opt.param_groups[0]["params"]
    for x in tree_util.tree_flatten(ad2["layers"])[0]:
        assert all(x is not p for p in live)
    delta = [b - a for a, b in zip(tree_util.tree_flatten(ad1["layers"])[0],
                                   tree_util.tree_flatten(ad2["layers"])[0])]
    assert any(bool(d.abs().max() > 0) for d in delta)


# ---------------------------------------------------------------------------
# examples/fedavg_lora.py on the port, and with a JAX party
# ---------------------------------------------------------------------------


def run_lora_example(party, addresses):
    """The port's example program on the CPU over TCP; both parties'
    reports must carry the same digest of the merged model, bit for bit."""
    from rayfed_tpu_torch.examples import fedavg_lora as ex

    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": dict(FAST_COMM_CONFIG)})
    workers = {p: ex.LoraWorker.party(p).remote(seed, device="cpu")
               for p, seed in ex.SEEDS.items()}
    seen = []
    g = ex.run(party, workers,
               on_round=lambda r, locals_, g, reports: seen.append(
                   (reports, fed.get([workers[p].digests.remote(g)
                                      for p in ex.SEEDS]))))
    final = fed.get(g)
    fed.shutdown()
    assert len(seen) == ex.ROUNDS
    for ((_, dig_a, ratio), (_, dig_b, _)), (sha_a, sha_b) in seen:
        assert dig_a == dig_b and ratio > 5
        assert sha_a == sha_b
    assert set(final) == set(lora.ATTN_TARGETS)


def test_lora_example_round_on_the_port():
    run_parties(run_lora_example, ["alice", "bob"], timeout=240)


def _jax_example_party(party, addresses):
    """The JAX package's examples/fedavg_lora.py, unmodified."""
    sys.argv = ["fedavg_lora.py", party, addresses["alice"], addresses["bob"]]
    runpy.run_path(os.path.join(REPO, "examples", "fedavg_lora.py"),
                   run_name="__main__")


def _torch_example_party(party, addresses):
    """The port's example as the other party, on the JAX example's base,
    adapters and tokens (its seeds, drawn with jax.random and carried over
    through numpy). After the rounds the port's merge of the final
    aggregate must equal the JAX package's merge of it, bit for bit."""
    from rayfed_tpu_torch.examples import fedavg_lora as ex

    cfg = jtfm.tiny_config(vocab=512, d_model=128, n_heads=4, n_layers=2,
                           d_ff=352)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    jad = jlora.init_lora(jax.random.PRNGKey(1), cfg, rank=8)
    tok = jax.random.randint(jax.random.PRNGKey(ex.SEEDS[party]), (8, 65), 0,
                             cfg.vocab)
    init = {"params": jax.tree_util.tree_map(np.asarray, jparams),
            "adapters": jax.tree_util.tree_map(np.asarray, jad["layers"]),
            "tokens": np.asarray(tok)}
    fed.init(addresses=addresses, party=party,
             config={"cross_silo_comm": ex.COMM})
    workers = {p: ex.LoraWorker.party(p).remote(
        seed, init=init if p == party else None, device="cpu")
        for p, seed in ex.SEEDS.items()}
    final = fed.get(ex.run(party, workers))
    fed.shutdown()
    merged = lora.merge_lora(
        tfm.params_from_numpy(init["params"], "cpu"),
        {"layers": final, "alpha": jad["alpha"], "rank": jad["rank"]})
    got = dict(jax.tree_util.tree_leaves_with_path(
        tfm.params_to_numpy(merged)))
    want = jlora.merge_lora(jparams, {**jad, "layers": jax.tree_util.tree_map(
        jnp.asarray, tfm.params_to_numpy(final))})
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, want)):
        np.testing.assert_array_equal(got[path], w)


def run_mixed_lora(party, addresses):
    if party == "alice":
        _jax_example_party(party, addresses)
    else:
        _torch_example_party(party, addresses)


def test_mixed_package_lora_round_jax_alice_torch_bob():
    # Each party's program asserts that both merged-model digests agree
    # every round; bob also holds his merge against the JAX merge.
    run_parties(run_mixed_lora, ["alice", "bob"], timeout=240)
