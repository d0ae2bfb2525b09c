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

"""The port's DP layer (``rayfed_tpu_torch/privacy/dp.py`` and the
manager's clip, noise and ledger) on the CPU: the mirrors of
``tests/test_privacy.py``'s DP tests on torch trees, and the port against
the JAX package on the same numpy inputs — the norm (numpy's pairwise
order), the clip, the noise (threefry ``normal``) and the ledger's
epsilon bit for bit, a DP secure round in process, and a spawned DP
secure job whose alice (the root) runs the JAX package and whose bob and
carol run the port, against the all-JAX job.
"""

import math
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import topology as topo
from rayfed_tpu_torch.ops.aggregate import reduce_by_plan
from rayfed_tpu_torch.privacy import PrivacyLedger
from rayfed_tpu_torch.privacy import dp as dp_mod
from rayfed_tpu_torch.privacy.manager import set_privacy_manager
from tests.test_torch_privacy import (
    PARTIES3,
    _assert_trees_bitwise,
    _envelopes,
    _float_trees,
    _int_tree,
    _manager,
    _tree_bits,
)
from tests.utils import FAST_COMM_CONFIG, run_parties


@pytest.fixture(autouse=True)
def _clean_privacy_state():
    set_privacy_manager(None)
    yield
    set_privacy_manager(None)


def _np_tree(seed, big=False):
    """Leaves of several dtypes and shapes in a non-JAX key order; with
    ``big``, a 2-D leaf past numpy's 8192-element reduction buffer."""
    rng = np.random.default_rng(seed)
    tree = {
        "w": (rng.standard_normal((33, 17)) * 3).astype(np.float32),
        "layers": [{"b": rng.standard_normal(9).astype(np.float32),
                    "h": (rng.standard_normal(130) * 5).astype(np.float16)}],
        "a": rng.standard_normal(5).astype(np.float64),
        "e": (rng.standard_normal(40) * 2).astype(ml_dtypes.bfloat16),
    }
    if big:
        tree["big"] = rng.standard_normal((300, 1001)).astype(np.float32)
    return tree


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


# ---------------------------------------------------------------------------
# Clip and norm
# ---------------------------------------------------------------------------


def test_clip_tree_identity_within_bound_is_bit_preserving():
    tree = {"w": torch.tensor([3.0, 4.0])}  # L2 = 5
    out = dp_mod.clip_tree(tree, 5.0)
    assert out is tree  # in-bound: IDENTITY, same bits
    clipped = dp_mod.clip_tree(tree, 2.5)
    assert dp_mod.tree_l2_norm(clipped) == pytest.approx(2.5, rel=1e-6)
    np.testing.assert_allclose(clipped["w"].numpy(), [1.5, 2.0], rtol=1e-6)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 128, 129, 1000, 8192, 8193,
                               100003, 3 * 8192 + 77])
def test_pairwise_sum_is_numpys_sum(n):
    a = np.random.default_rng(n).standard_normal(n) ** 2
    assert dp_mod.pairwise_sum(torch.from_numpy(a)) == float(np.sum(a))


@pytest.mark.parametrize("big", [False, True], ids=["small", "big"])
@pytest.mark.parametrize("clip", [0.5, 7.0, 1e9])
def test_norm_and_clip_equal_the_jax_package(big, clip):
    from rayfed_tpu.privacy import dp as jdp

    for seed in range(3):
        tree = _np_tree(seed, big)
        ttree = _to_torch(tree)
        assert dp_mod.tree_l2_norm(ttree) == jdp.tree_l2_norm(tree)
        got = dp_mod.clip_tree(ttree, clip)
        want = jdp.clip_tree(tree, clip)
        _assert_trees_bitwise(got, want)
        assert list(got) == list(ttree)  # the caller's key order


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------


def test_gaussian_noise_deterministic_per_round():
    tree = {"w": torch.zeros(128)}
    a = dp_mod.gaussian_noise_tree(tree, 1.0, seed=3, round_index=0)
    b = dp_mod.gaussian_noise_tree(tree, 1.0, seed=3, round_index=0)
    _assert_trees_bitwise(a, b)
    c = dp_mod.gaussian_noise_tree(tree, 1.0, seed=3, round_index=1)
    assert not torch.equal(a["w"], c["w"])
    sd = float(a["w"].std())
    assert 0.5 < sd < 2.0  # the right stddev scale, not garbage
    assert dp_mod.gaussian_noise_tree(tree, 0.0, 3, 0) is tree


@pytest.mark.parametrize("seed, rnd", [(11, 0), (2**40 + 3, 5),
                                       (2**63 + 9, 2**31 + 7)])
def test_gaussian_noise_equals_the_jax_package(seed, rnd):
    # Keyed on (seed, round) and then on each leaf's index in JAX's leaf
    # order; x64 + noise64 * stddev cast back as numpy casts it.
    from rayfed_tpu.privacy import dp as jdp

    tree = _np_tree(seed % 97)
    got = dp_mod.gaussian_noise_tree(_to_torch(tree), 0.37, seed, rnd)
    want = jdp.gaussian_noise_tree(tree, 0.37, seed, rnd)
    _assert_trees_bitwise(got, want)


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------


def test_ledger_accrues_basic_composition():
    from rayfed_tpu.privacy import dp as jdp

    ledger = PrivacyLedger(delta=1e-5)
    per_round = dp_mod.gaussian_epsilon(1.2, 1e-5)
    assert per_round == jdp.gaussian_epsilon(1.2, 1e-5)
    assert per_round == math.sqrt(2 * math.log(1.25 / 1e-5)) / 1.2
    assert dp_mod.gaussian_epsilon(0.0, 1e-5) == math.inf
    ledger.record_round(["alice", "bob"], 1.2)
    ledger.record_round(["alice"], 1.2)
    assert ledger.epsilon("alice") == pytest.approx(2 * per_round)
    assert ledger.epsilon("bob") == pytest.approx(per_round)
    assert ledger.epsilon("carol") == 0.0
    snap = ledger.snapshot()
    assert snap["alice"]["rounds"] == 2 and snap["alice"]["delta"] == 1e-5
    # No-noise rounds accrue nothing.
    ledger.record_round(["alice"], 0.0)
    assert snap == {k: v for k, v in ledger.snapshot().items()}
    # The JAX package's ledger holds the same numbers.
    jledger = jdp.PrivacyLedger(delta=1e-5)
    jledger.record_round(["alice", "bob"], 1.2)
    jledger.record_round(["alice"], 1.2)
    assert jledger.snapshot() == snap


def test_privacy_ledger_empty_without_plane():
    assert fed.privacy_ledger() == {}


# ---------------------------------------------------------------------------
# DP at the root
# ---------------------------------------------------------------------------


def test_dp_noise_applied_at_root_and_ledger_exposed():
    trees = {p: _int_tree(100 + i) for i, p in enumerate(PARTIES3)}
    managers = {
        p: _manager(p, clip_norm=1e9, noise_multiplier=1.0, noise_seed=11)
        for p in PARTIES3
    }
    managers, envs = _envelopes(trees, managers=managers)
    root = managers["alice"]
    out = root.secure_reduce("mean", PARTIES3, "dom", 0, None, envs)
    plan = topo.plan(PARTIES3, "flat")
    plain = reduce_by_plan(plan, trees)
    # Noise genuinely perturbed the aggregate ...
    assert not torch.equal(out["w"], plain["w"])
    # ... by the calibrated scale (z * clip / n), and the ledger accrued.
    delta = out["w"].double() - plain["w"].double()
    assert float(delta.abs().max()) < 10 * 1e9 / 3
    snap = root.ledger_snapshot()
    assert set(snap) == set(PARTIES3)
    assert snap["alice"]["epsilon"] > 0
    set_privacy_manager(root)
    assert fed.privacy_ledger() == snap


def _dp_jax_managers(**kw):
    from rayfed_tpu.privacy import PrivacyConfig as JConfig
    from rayfed_tpu.privacy import PrivacyManager as JManager

    from tests.test_torch_privacy import _store_seeds

    return {p: _store_seeds(JManager("job", p, JConfig(
        secure_aggregation=True, **kw)), p, PARTIES3) for p in PARTIES3}


@pytest.mark.parametrize("op", ["sum", "mean", "wmean"])
def test_dp_secure_round_equals_the_jax_package(op):
    # The clip acts (clip_norm under every tree's norm), the root adds
    # the round's noise: aggregate and ledger are the JAX package's bits.
    kw = dict(clip_norm=3.0, noise_multiplier=0.8, noise_seed=2024,
              delta=1e-6)
    trees_np, trees = _float_trees(50, half=True)
    weights = ({"alice": 0.37, "bob": 1.7, "carol": 3.25}
               if op == "wmean" else None)
    jm = _dp_jax_managers(**kw)
    jenvs = {p: jm[p].mask_contribution(
        trees_np[p], party=p, parties=PARTIES3, domain="fedagg",
        round_index=4, weight=None if weights is None else weights[p])
        for p in PARTIES3}
    managers = {p: _manager(p, **kw) for p in PARTIES3}
    managers, envs = _envelopes(trees, domain="fedagg", round_index=4,
                                weights=weights, managers=managers)
    for p in PARTIES3:
        assert _tree_bits(envs[p]["q"]) == _tree_bits(jenvs[p]["q"])
    out = managers["alice"].secure_reduce(op, PARTIES3, "fedagg", 4,
                                          weights, envs)
    jout = jm["alice"].secure_reduce(op, PARTIES3, "fedagg", 4, weights,
                                     jenvs)
    _assert_trees_bitwise(out, jout)
    assert managers["alice"].ledger_snapshot() == \
        jm["alice"].ledger_snapshot()


def test_epsilon_gauge_tracks_the_ledger():
    from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

    trees = {p: _int_tree(120 + i) for i, p in enumerate(PARTIES3)}
    managers = {p: _manager(p, clip_norm=1e9, noise_multiplier=2.0)
                for p in PARTIES3}
    managers, envs = _envelopes(trees, managers=managers)
    root = managers["alice"]
    root.secure_reduce("mean", PARTIES3, "dom", 0, None, envs)
    root.secure_reduce("mean", PARTIES3, "dom", 0, None, envs)
    series = telemetry_metrics.get_registry().snapshot()[
        "fed_privacy_ledger_epsilon"]["series"]
    gauge = {s["labels"]["party"]: s["value"] for s in series}
    for p in PARTIES3:
        assert gauge[p] == root.ledger.epsilon(p) == pytest.approx(
            2 * dp_mod.gaussian_epsilon(2.0, 1e-5))
    # A restore refreshes the gauges from the snapshot.
    root.ledger_restore({"bob": {"epsilon": 0.25, "delta": 1e-5,
                                 "rounds": 1}})
    series = telemetry_metrics.get_registry().snapshot()[
        "fed_privacy_ledger_epsilon"]["series"]
    assert {s["labels"]["party"]: s["value"]
            for s in series}["bob"] == 0.25


# ---------------------------------------------------------------------------
# A spawned DP secure job: a JAX root with torch bob and carol
# ---------------------------------------------------------------------------

DP_PRIVACY = {"secure_aggregation": True, "mask_seed": 1234,
              "handshake_timeout_s": 120.0, "clip_norm": 4.0,
              "noise_multiplier": 0.7, "noise_seed": 99}


def _mixed_dp_party(party, addresses, pkgs, out_dir):
    """Two DP secure means rooted at alice (clip at every party, noise
    at the root); off-grid f32 and f16 leaves."""
    if pkgs[party] == "jax":
        import jax.numpy as jnp

        import rayfed_tpu as fed_
        from rayfed_tpu.federated import fed_aggregate

        def tree(p, r):
            t = _float_trees(80 + r, half=True)[0][p]
            return {"w": jnp.asarray(t["w"]),
                    "layers": [{"b": jnp.asarray(t["layers"][0]["b"])}],
                    "a": jnp.asarray(t["a"])}
    else:
        import rayfed_tpu_torch as fed_
        from rayfed_tpu_torch.federated import fed_aggregate

        def tree(p, r):
            return _float_trees(80 + r, half=True)[1][p]

    fed_.init(addresses=addresses, party=party, config={
        "barrier_on_initializing": True,
        "cross_silo_comm": dict(FAST_COMM_CONFIG, recv_timeout_in_ms=120000),
        "privacy": DP_PRIVACY,
    })

    @fed_.remote
    def contrib(p, r):
        return tree(p, r)

    out = {}
    for r in range(2):
        objs = {p: contrib.party(p).remote(p, r) for p in PARTIES3}
        out[f"mean{r}"] = _tree_bits(fed_.get(
            fed_aggregate(objs, op="mean", secure=True)))
    out["ledger"] = fed_.privacy_ledger()
    fed_.shutdown()
    with open(f"{out_dir}/{'-'.join(pkgs.values())}-{party}.pkl", "wb") as f:
        pickle.dump(out, f)


def test_mixed_package_dp_job_equals_the_jax_job_bitwise(tmp_path):
    runs = [{"alice": "jax", "bob": "jax", "carol": "jax"},
            {"alice": "jax", "bob": "torch", "carol": "torch"}]
    for pkgs in runs:
        run_parties(_mixed_dp_party, PARTIES3, timeout=240,
                    extra_args=(pkgs, str(tmp_path)))
    got = {}
    for pkgs in runs:
        tag = "-".join(pkgs.values())
        for p in PARTIES3:
            with open(tmp_path / f"{tag}-{p}.pkl", "rb") as f:
                got[tag, p] = pickle.load(f)
    want = got["jax-jax-jax", "alice"]
    for (tag, p), res in got.items():
        for case in ("mean0", "mean1"):
            assert res[case] == want[case], (tag, p, case)
    # The root's ledger charged every party two rounds; the others'
    # ledgers are empty (epsilon accrues where the noise is added).
    eps = math.sqrt(2 * math.log(1.25 / 1e-5)) / 0.7
    for tag in ("jax-jax-jax", "jax-torch-torch"):
        ledger = got[tag, "alice"]["ledger"]
        assert set(ledger) == set(PARTIES3)
        assert all(rec["rounds"] == 2 and rec["epsilon"] == eps + eps
                   for rec in ledger.values())
        assert got[tag, "bob"]["ledger"] == {}
    # The noise is there: the DP mean is not the plaintext mean's grid.
    assert want["mean0"] != want["mean1"]
