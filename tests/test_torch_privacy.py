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

"""The port's secure aggregation (``rayfed_tpu_torch/privacy``): the
mirrors of ``tests/test_privacy.py``'s secure-aggregation tests on torch
trees (strict config, the fixed-point ring, bitwise mask cancellation,
secure reduce against the plaintext fold, dropout recovery, the ``prv:``
handler, the async secure groups, the counters, a spawned three-party
secure FedAvg), held against the JAX package where the two meet: the
same trees and seeds give the JAX package's envelopes word for word and
its aggregate bit for bit, in process and in a spawned job whose alice
runs the JAX package and whose bob and carol run the port, with a JAX
root and a torch root. The DP and quantizer keys are accepted with the
JAX package's validation (their layers are held by
tests/test_torch_dp.py and tests/test_torch_quantize.py); the same-mesh
modular sum names item 12.
"""

import itertools
import pickle

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import federated, topology as topo
from rayfed_tpu_torch._private.constants import CODE_FORBIDDEN, CODE_OK
from rayfed_tpu_torch.async_rounds import BufferedAggregator
from rayfed_tpu_torch.config import AsyncAggregationConfig
from rayfed_tpu_torch.ops.aggregate import reduce_by_plan
from rayfed_tpu_torch.privacy import (
    PrivacyConfig,
    PrivacyManager,
    SecAggError,
    protocol,
    secagg,
    validate_wire_dtype_gate,
)
from rayfed_tpu_torch.privacy.manager import set_privacy_manager
from rayfed_tpu_torch.resilience.liveness import DEAD
from tests.utils import FAST_COMM_CONFIG, get_addresses, run_parties

PARTIES3 = ["alice", "bob", "carol"]

#: Deterministic pairwise seeds (what the prv:seed exchange would have
#: agreed); stored directly on the in-process managers below.
PAIR_SEEDS = {
    ("alice", "bob"): 1_0001,
    ("alice", "carol"): 1_0002,
    ("bob", "carol"): 1_0003,
}


@pytest.fixture(autouse=True)
def _clean_privacy_state():
    set_privacy_manager(None)
    federated._reset_secure_rounds()
    yield
    set_privacy_manager(None)
    federated._reset_secure_rounds()


def _store_seeds(mgr, party, parties):
    for a, b in itertools.combinations(sorted(parties), 2):
        if party == a:
            mgr.store_seed(b, PAIR_SEEDS[(a, b)])
        elif party == b:
            mgr.store_seed(a, PAIR_SEEDS[(a, b)])
    return mgr


def _manager(party, parties=PARTIES3, **cfg_kw):
    cfg_kw.setdefault("secure_aggregation", True)
    return _store_seeds(
        PrivacyManager("test-job", party, PrivacyConfig(**cfg_kw)),
        party, parties)


def _np_int_tree(seed, lo=-1000, hi=1000):
    """Integer-VALUED float leaves: both the ring and float32 addition
    are exact on them, which is what makes bitwise parity with the
    plaintext fold assertable. Insertion order w, b (JAX's is b, w)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.integers(lo, hi, size=(33, 17)).astype(np.float32),
        "b": rng.integers(lo, hi, size=(7,)).astype(np.float32),
    }


def _int_tree(seed, **kw):
    return {k: torch.from_numpy(v)
            for k, v in _np_int_tree(seed, **kw).items()}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.dtype).rpartition(".")[2], x.numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.tobytes()


def _tree_bits(tree):
    """{key path: (dtype name, bytes)} of a tree of either package."""
    out = {}

    def go(node, path):
        if isinstance(node, dict):
            for k in node:
                go(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                go(v, f"{path}/{i}")
        else:
            out[path] = _bits(node)

    go(tree, "")
    return out


def _assert_trees_bitwise(a, b):
    assert _tree_bits(a) == _tree_bits(b)


# ---------------------------------------------------------------------------
# config["privacy"]: strict validation, the DP and quantizer keys
# ---------------------------------------------------------------------------


def test_unknown_privacy_key_rejected_with_known_list():
    with pytest.raises(ValueError, match="secure_agregation"):
        PrivacyConfig.from_dict({"secure_agregation": True})
    with pytest.raises(ValueError, match="known keys"):
        PrivacyConfig.from_dict({"secure_agregation": True})


def test_noise_without_clip_rejected():
    with pytest.raises(ValueError, match="clip_norm"):
        PrivacyConfig(noise_multiplier=1.0)
    # Clipping alone is legal, as in the JAX package, and so is noise
    # with its clip.
    assert PrivacyConfig(clip_norm=1.0).clip_norm == 1.0
    assert PrivacyConfig(clip_norm=1.0, noise_multiplier=1.0).delta == 1e-5


def test_fixedpoint_bits_bounds():
    with pytest.raises(ValueError, match="fixedpoint_bits"):
        PrivacyConfig(fixedpoint_bits=0)
    with pytest.raises(ValueError, match="fixedpoint_bits"):
        PrivacyConfig(fixedpoint_bits=31)


def test_int8_wire_dtype_gated_on_privacy_quantize():
    with pytest.raises(ValueError, match=r'\["quantize"\]'):
        validate_wire_dtype_gate("int8", None)
    with pytest.raises(ValueError, match="int8"):
        validate_wire_dtype_gate("int8", {"secure_aggregation": True})
    validate_wire_dtype_gate("int8", {"quantize": "int8"})
    validate_wire_dtype_gate("bf16", None)
    validate_wire_dtype_gate(None, None)


def test_init_rejects_privacy_typo_before_any_state():
    from rayfed_tpu_torch._private.global_context import get_global_context
    from rayfed_tpu_torch.tenancy import context as tenancy_context

    addresses = get_addresses(["alice"])
    with pytest.raises(ValueError, match="secure_agregation"):
        fed.init(
            addresses=addresses, party="alice",
            config={"privacy": {"secure_agregation": True}},
        )
    assert get_global_context() is None and not tenancy_context.contexts()


def test_init_rejects_int8_wire_naming_item_11b():
    # As the JAX package does, init gates the int8 tier on
    # privacy.quantize (naming the knob) and takes it with the knob.
    from rayfed_tpu_torch._private.global_context import get_global_context

    addresses = get_addresses(["alice"])
    comm = dict(FAST_COMM_CONFIG, payload_wire_dtype="int8")
    for privacy in (None, {"secure_aggregation": True}):
        config = {"cross_silo_comm": comm}
        if privacy is not None:
            config["privacy"] = privacy
        with pytest.raises(ValueError, match=r'\["quantize"\] = "int8"'):
            fed.init(addresses=addresses, party="alice", config=config)
        assert get_global_context() is None
    fed.init(addresses=addresses, party="alice", config={
        "cross_silo_comm": comm, "privacy": {"quantize": "int8"}})
    try:
        from rayfed_tpu_torch.privacy import get_privacy_manager

        assert get_privacy_manager().config.quantize == "int8"
    finally:
        fed.shutdown()
    assert get_global_context() is None


_DP_KEYS = [("clip_norm", 1.0), ("noise_multiplier", 0.0),
            ("noise_seed", 3), ("quantize", "int8"), ("error_feedback", False)]


#: A value of each key the JAX package's validation refuses (None: the
#: key takes any value of its type).
_DP_BAD = {"clip_norm": (0.0, "clip_norm must be > 0"),
           "noise_multiplier": (-1.0, "noise_multiplier must be >= 0"),
           "noise_seed": None,
           "quantize": ("int4", "quantize must be one of"),
           "error_feedback": None}


@pytest.mark.parametrize("key, value", _DP_KEYS, ids=[k for k, _ in _DP_KEYS])
def test_dp_and_quantizer_keys_name_item_11b(key, value):
    # Each DP and quantizer key is accepted, by the config and by init,
    # and validated as the JAX package validates it.
    from rayfed_tpu.privacy import PrivacyConfig as JConfig

    from rayfed_tpu_torch._private.global_context import get_global_context
    from rayfed_tpu_torch.privacy import get_privacy_manager
    from rayfed_tpu_torch.tenancy import context as tenancy_context

    cfg = PrivacyConfig.from_dict({"secure_aggregation": True, key: value})
    assert cfg.as_dict() == JConfig.from_dict(
        {"secure_aggregation": True, key: value}).as_dict()
    bad = _DP_BAD[key]
    if bad is not None:
        with pytest.raises(ValueError, match=bad[1]):
            PrivacyConfig.from_dict({key: bad[0]})
        with pytest.raises(ValueError, match=bad[1]):
            JConfig.from_dict({key: bad[0]})
        with pytest.raises(ValueError, match=bad[1]):
            fed.init(addresses=get_addresses(["alice"]), party="alice",
                     config={"privacy": {key: bad[0]}})
        assert get_global_context() is None
        assert not tenancy_context.contexts()
    fed.init(addresses=get_addresses(["alice"]), party="alice",
             config={"privacy": {key: value}})
    try:
        assert getattr(get_privacy_manager().config, key) == value
    finally:
        fed.shutdown()


def test_restoring_a_dp_ledger_names_item_11b(tmp_path):
    # A cut that holds a DP ledger restores it into the installed
    # manager (the spent budget survives the restart).
    from rayfed_tpu_torch import checkpoint

    path = checkpoint.step_dir(str(tmp_path), 1)
    import os

    os.makedirs(path)
    with open(os.path.join(path, checkpoint._META_FILE), "w") as f:
        f.write('{"step": 1, "kind": "job", "has_arrays": []}')
    ledger = {"alice": {"epsilon": 1.0, "delta": 1e-5, "rounds": 2}}
    checkpoint._save_tree(
        os.path.join(path, checkpoint._CONTROL_FILE),
        {"privacy_ledger": ledger})
    got = checkpoint.restore_job_state(str(tmp_path), step=1, install=False)
    assert got["control"]["privacy_ledger"] == ledger
    mgr = _manager("alice", clip_norm=1.0, noise_multiplier=1.0)
    set_privacy_manager(mgr)
    checkpoint.restore_job_state(str(tmp_path), step=1, install=True)
    assert mgr.ledger_snapshot() == ledger
    assert fed.privacy_ledger() == ledger


def test_secure_aggregate_needs_the_privacy_plane():
    from rayfed_tpu_torch.async_rounds import async_round

    objs = {"alice": object()}
    for call in (lambda: federated.fed_aggregate(objs, secure=True),
                 lambda: federated.fed_aggregate(objs, mode="async",
                                                 secure=True),
                 lambda: async_round(objs, secure=True)):
        with pytest.raises(RuntimeError, match="needs the privacy plane"):
            call()
    set_privacy_manager(PrivacyManager("job", "alice", PrivacyConfig()))
    with pytest.raises(ValueError, match="secure_aggregation"):
        federated.fed_aggregate(objs, secure=True)
    with pytest.raises(ValueError, match="secure_aggregation"):
        async_round(objs, secure=True)
    set_privacy_manager(_manager("alice"))
    with pytest.raises(ValueError, match="sum/mean/wmean"):
        federated.fed_aggregate(objs, op="max", secure=True)
    with pytest.raises(ValueError, match="single-hop"):
        federated.fed_aggregate(objs, topology="tree", secure=True)
    with pytest.raises(ValueError, match="flat plan"):
        federated.fed_aggregate(
            {p: object() for p in PARTIES3}, secure=True,
            plan=topo.plan(PARTIES3, "tree", group_size=2))


# ---------------------------------------------------------------------------
# Fixed-point ring codec
# ---------------------------------------------------------------------------


def test_ring_roundtrip_exact_on_grid_values():
    tree = {
        "w": torch.tensor([1.0, -2.0, 1000.0, 0.5, -0.25]),
        "b": torch.tensor([3.0, -7.0], dtype=torch.float64),
        "h": torch.tensor([0.5, -3.0], dtype=torch.bfloat16),
    }
    ring, dtypes, spec = secagg.encode_tree(tree, 16, 3)
    assert dtypes == ["float64", "bfloat16", "float32"]  # JAX's order b, h, w
    out = secagg.decode_sum(ring, dtypes, spec, 16)
    _assert_trees_bitwise(out, tree)


def test_ring_headroom_overflow_names_the_knob():
    with pytest.raises(SecAggError, match="fixedpoint_bits"):
        secagg.encode_tree({"w": torch.tensor([70000.0])}, 16, 1)
    secagg.encode_tree({"w": torch.tensor([70000.0])}, 8, 1)
    secagg.encode_tree({"w": torch.tensor([30000.0])}, 16, 1)
    with pytest.raises(SecAggError, match="parties"):
        secagg.encode_tree({"w": torch.tensor([30000.0])}, 16, 2)


def test_ring_rejects_non_float_leaves():
    with pytest.raises(SecAggError, match="float"):
        secagg.encode_tree({"i": torch.arange(4, dtype=torch.int32)}, 16, 2)


def test_encode_and_decode_equal_the_jax_package():
    """Off-grid values in every float dtype the JAX package masks: the
    same words, the same decoded bits (numpy rounds f64 to float16 once,
    torch twice: the port rounds through f32 to odd)."""
    from rayfed_tpu.privacy import secagg as jsecagg

    rng = np.random.default_rng(4)
    base = rng.standard_normal(4096) * 300.0
    tree_np = {"f32": base.astype(np.float32),
               "f16": (base / 8).astype(np.float16),
               "f64": base * 1.0001}
    tree = {k: torch.from_numpy(v.copy()) for k, v in tree_np.items()}
    ring, dtypes, spec = secagg.encode_tree(tree, 16, 3)
    jring, jdtypes, jdef = jsecagg.encode_tree(tree_np, 16, 3)
    assert dtypes == jdtypes
    for got, want in zip(ring, jring):
        assert got.numpy().astype(np.uint32).tobytes() == want.tobytes()
    # Decode sums of three such encodings, offset by a grid step.
    sums = [(w.astype(np.int64) * 3 + 1) % (1 << 32) for w in jring]
    out = secagg.decode_sum([torch.from_numpy(s) for s in sums], dtypes,
                            spec, 16)
    jout = jsecagg.decode_sum([s.astype(np.uint32) for s in sums], jdtypes,
                              jdef, 16)
    _assert_trees_bitwise(out, jout)


def test_bfloat16_leaves_are_masked_where_the_jax_package_refuses_them():
    """The JAX package reads a bf16 leaf's numpy kind ("V" for
    ml_dtypes) and refuses it as non-float (ROADMAP Queue 3); the port
    masks bf16 like any float: its decode rounds through f32 as
    ml_dtypes' cast does."""
    import ml_dtypes

    from rayfed_tpu.privacy import secagg as jsecagg

    # |x| >= 2**-9: every such bf16 value lies on the 2**-16 grid.
    rng = np.random.default_rng(5)
    x = (rng.uniform(1.0, 100.0, 512) * rng.choice([-1.0, 1.0], 512)).astype(
        ml_dtypes.bfloat16)
    with pytest.raises(jsecagg.SecAggError, match="bfloat16"):
        jsecagg.encode_tree({"a": x}, 16, 3)
    t = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    ring, dtypes, spec = secagg.encode_tree({"a": t}, 16, 3)
    assert dtypes == ["bfloat16"]
    _assert_trees_bitwise(secagg.decode_sum(ring, dtypes, spec, 16),
                          {"a": t})
    s = [(w * 3 + 1) & 0xFFFFFFFF for w in ring]
    lifted = torch.where(s[0] >= 2**31, s[0] - 2**32, s[0]).double()
    want = (lifted.numpy() * 2.0**-16).astype(ml_dtypes.bfloat16)
    assert secagg.decode_sum(s, dtypes, spec, 16)["a"].view(
        torch.int16).numpy().tobytes() == want.view(np.int16).tobytes()


# ---------------------------------------------------------------------------
# Mask cancellation: the core one-time-pad invariant
# ---------------------------------------------------------------------------


def _seeds_of(p, parties=PARTIES3):
    return {q: PAIR_SEEDS[tuple(sorted((p, q)))] for q in parties if q != p}


def test_masks_cancel_bitwise_in_modular_sum():
    trees = {p: _int_tree(i) for i, p in enumerate(PARTIES3)}
    plain, masked = [], []
    for p in PARTIES3:
        ring, dtypes, spec = secagg.encode_tree(trees[p], 16, 3)
        m = secagg.apply_masks(ring, p, PARTIES3, _seeds_of(p), "dom", 0)
        assert all(not torch.equal(mm, rr) for mm, rr in zip(m, ring))
        plain.append(ring)
        masked.append(m)
    sum_plain = secagg.modular_sum_host(plain)
    sum_masked = secagg.modular_sum_host(masked)
    for a, b in zip(sum_plain, sum_masked):
        assert torch.equal(a, b)  # cancellation is BITWISE
    out = secagg.decode_sum(sum_masked, dtypes, spec, 16)
    for k in ("w", "b"):
        expect = sum(trees[p][k].double() for p in PARTIES3)
        assert torch.equal(out[k].double(), expect)


def test_mask_streams_differ_across_domain_round_and_leaf():
    base = secagg.mask_stream(7, "dom", 0, 0, (64,))
    assert not torch.equal(base, secagg.mask_stream(7, "dom2", 0, 0, (64,)))
    assert not torch.equal(base, secagg.mask_stream(7, "dom", 1, 0, (64,)))
    assert not torch.equal(base, secagg.mask_stream(7, "dom", 0, 1, (64,)))
    assert torch.equal(base, secagg.mask_stream(7, "dom", 0, 0, (64,)))


def test_masks_past_one_chunk_are_the_stream(monkeypatch):
    """``apply_masks`` adds each stream a chunk at a time: the same words
    as the whole stream added at once."""
    from rayfed_tpu_torch.privacy import threefry

    ring = [torch.arange(1000, dtype=torch.int64).reshape(10, 100)]
    whole = secagg.apply_masks(ring, "alice", ["alice", "bob"],
                               {"bob": 5}, "dom", 2)
    monkeypatch.setattr(threefry, "CHUNK_WORDS", 64)
    chunked = secagg.apply_masks(ring, "alice", ["alice", "bob"],
                                 {"bob": 5}, "dom", 2)
    stream = secagg.mask_stream(5, "dom", 2, 0, (10, 100))
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[0], (ring[0] + stream) & 0xFFFFFFFF)


def test_modular_sum_mesh_names_item_12():
    with pytest.raises(NotImplementedError, match="item 12"):
        secagg.modular_sum_mesh(None, [[torch.zeros(2, dtype=torch.int64)]])


# ---------------------------------------------------------------------------
# secure_reduce: bitwise parity with the plaintext fold
# ---------------------------------------------------------------------------


def _envelopes(trees, domain="dom", round_index=0, weights=None,
               parties=PARTIES3, managers=None):
    managers = managers or {p: _manager(p, parties) for p in parties}
    return managers, {
        p: managers[p].mask_contribution(
            trees[p], party=p, parties=list(parties), domain=domain,
            round_index=round_index,
            weight=None if weights is None else weights[p],
        )
        for p in trees
    }


def test_secure_mean_bitwise_equals_reduce_by_plan():
    trees = {p: _int_tree(10 + i) for i, p in enumerate(PARTIES3)}
    managers, envs = _envelopes(trees)
    out = managers["alice"].secure_reduce(
        "mean", PARTIES3, "dom", 0, None, envs
    )
    plan = topo.plan(PARTIES3, "flat")
    _assert_trees_bitwise(secagg.jax_order(reduce_by_plan(plan, trees)), out)


def test_secure_wmean_bitwise_equals_reduce_by_plan():
    trees = {p: _int_tree(20 + i) for i, p in enumerate(PARTIES3)}
    weights = {"alice": 1.0, "bob": 2.0, "carol": 5.0}
    managers, envs = _envelopes(trees, weights=weights)
    out = managers["alice"].secure_reduce(
        "wmean", PARTIES3, "dom", 0, weights, envs
    )
    plan = topo.plan(PARTIES3, "flat")
    _assert_trees_bitwise(
        secagg.jax_order(reduce_by_plan(plan, trees, weights=weights)), out)


def test_secure_sum_and_unknown_op():
    trees = {p: _int_tree(40 + i) for i, p in enumerate(PARTIES3)}
    managers, envs = _envelopes(trees)
    out = managers["alice"].secure_reduce(
        "sum", PARTIES3, "dom", 0, None, envs
    )
    expect = sum(trees[p]["w"].double() for p in PARTIES3)
    assert torch.equal(out["w"].double(), expect)
    with pytest.raises(ValueError, match="sum/mean/wmean"):
        managers["alice"].secure_reduce("max", PARTIES3, "dom", 1, None, envs)


def test_secure_reduce_missing_party_needs_recovery_seeds():
    trees = {p: _int_tree(50 + i) for i, p in enumerate(PARTIES3)}
    managers, envs = _envelopes(trees)
    del envs["carol"]
    with pytest.raises(SecAggError, match="re-offered"):
        managers["alice"].secure_reduce(
            "mean", PARTIES3, "dom", 0, None, envs
        )


def test_secure_reduce_recovers_dropout_bitwise():
    trees = {p: _int_tree(60 + i) for i, p in enumerate(PARTIES3)}
    managers, envs = _envelopes(trees)
    del envs["carol"]
    root = managers["alice"]
    code, _ = root.control_handler({}, protocol.make_recover_offer(
        "bob", "carol", PAIR_SEEDS[("bob", "carol")], protocol.new_nonce(), 0
    ))
    assert code == CODE_OK
    out = root.secure_reduce("mean", PARTIES3, "dom", 0, None, envs)
    survivors = ["alice", "bob"]
    plan = topo.plan(survivors, "flat")
    _assert_trees_bitwise(
        secagg.jax_order(
            reduce_by_plan(plan, {p: trees[p] for p in survivors})), out)
    assert root.stats["dropout_recoveries"] == 1


# ---------------------------------------------------------------------------
# The JAX package's envelopes and aggregates, in process
# ---------------------------------------------------------------------------


def _float_trees(seed, half=False):
    """Off-grid trees (the secure result is not the plaintext one there,
    but it is the JAX package's): numpy for the JAX package, torch for
    the port, insertion order unlike JAX's; leaf "a" float16 with
    ``half``."""
    out_np, out_t = {}, {}
    for i, p in enumerate(PARTIES3):
        rng = np.random.default_rng(seed + i)
        t = {"w": rng.standard_normal((24, 5)).astype(np.float32),
             "layers": [{"b": (rng.standard_normal(9) * 100).astype(
                 np.float32)}],
             "a": (rng.standard_normal(7) * 3).astype(np.float32)}
        if half:
            t["a"] = t["a"].astype(np.float16)
        out_np[p] = t

        def conv(x):
            return torch.from_numpy(x.copy())

        out_t[p] = {"w": conv(t["w"]), "layers": [{"b": conv(
            t["layers"][0]["b"])}], "a": conv(t["a"])}
    return out_np, out_t


def _jax_managers():
    from rayfed_tpu.privacy import PrivacyConfig as JConfig
    from rayfed_tpu.privacy import PrivacyManager as JManager

    return {p: _store_seeds(JManager("job", p, JConfig(
        secure_aggregation=True)), p, PARTIES3) for p in PARTIES3}


@pytest.mark.parametrize("op", ["sum", "mean", "wmean"])
@pytest.mark.parametrize("half", [False, True], ids=["f32", "f16"])
def test_envelopes_and_aggregate_equal_the_jax_package(op, half):
    trees_np, trees = _float_trees(30, half)
    weights = ({"alice": 0.37, "bob": 1.7, "carol": 3.25}
               if op == "wmean" else None)
    jm = _jax_managers()
    jenvs = {p: jm[p].mask_contribution(
        trees_np[p], party=p, parties=PARTIES3, domain="fedagg",
        round_index=5, weight=None if weights is None else weights[p])
        for p in PARTIES3}
    managers, envs = _envelopes(trees, domain="fedagg", round_index=5,
                                weights=weights)
    for p in PARTIES3:
        assert envs[p]["dtypes"] == jenvs[p]["dtypes"]
        assert {k: v for k, v in envs[p].items() if k not in ("q",)} == \
            {k: v for k, v in jenvs[p].items() if k not in ("q",)}
        assert _tree_bits(envs[p]["q"]) == _tree_bits(jenvs[p]["q"])
    out = managers["alice"].secure_reduce(op, PARTIES3, "fedagg", 5,
                                          weights, envs)
    jout = jm["alice"].secure_reduce(op, PARTIES3, "fedagg", 5, weights,
                                     jenvs)
    _assert_trees_bitwise(out, jout)


def test_a_torch_root_folds_a_jax_partys_envelope():
    """alice's envelope from the JAX package crosses the wire (its
    encoder, the port's decoder: ``uint32`` leaves arrive as
    ``torch.uint32``); the port's root folds it with the port's own and
    gets the JAX package's aggregate, recovering a dropped carol too."""
    from rayfed_tpu._private import serialization as jser

    from rayfed_tpu_torch._private import serialization as ser

    trees_np, trees = _float_trees(40)
    jm = _jax_managers()
    jenv = jm["alice"].mask_contribution(
        trees_np["alice"], party="alice", parties=PARTIES3, domain="fedagg",
        round_index=0)
    meta, bufs = jser.try_encode_tree(jenv)
    wired = ser.decode_payload("tree", meta, jser.concat_buffers(bufs))
    assert all(leaf.dtype == torch.uint32
               for leaf in secagg._leaves(wired["q"])[0])
    managers, envs = _envelopes({p: trees[p] for p in ("bob", "carol")},
                                domain="fedagg")
    envs["alice"] = wired
    out = managers["bob"].secure_reduce("mean", PARTIES3, "fedagg", 0, None,
                                        envs)
    jenvs = {"alice": jenv, **{p: jm[p].mask_contribution(
        trees_np[p], party=p, parties=PARTIES3, domain="fedagg",
        round_index=0) for p in ("bob", "carol")}}
    _assert_trees_bitwise(out, jm["alice"].secure_reduce(
        "mean", PARTIES3, "fedagg", 0, None, jenvs))
    # carol drops: bob (the root) recovers with alice's re-offer.
    del envs["carol"], jenvs["carol"]
    managers["bob"].store_recovery("carol", "alice",
                                   PAIR_SEEDS[("alice", "carol")])
    jm["alice"].store_recovery("carol", "bob", PAIR_SEEDS[("bob", "carol")])
    _assert_trees_bitwise(
        managers["bob"].secure_reduce("mean", PARTIES3, "fedagg", 0, None,
                                      envs),
        jm["alice"].secure_reduce("mean", PARTIES3, "fedagg", 0, None,
                                  jenvs))


# ---------------------------------------------------------------------------
# PrivacyManager: seed exchange plumbing and the prv: control handler
# ---------------------------------------------------------------------------


def test_control_handler_verdicts():
    mgr = PrivacyManager("job", "bob", PrivacyConfig(secure_aggregation=True))
    code, _ = mgr.control_handler({}, protocol.make_seed_offer(
        "alice", "bob", 4242, protocol.new_nonce()
    ))
    assert code == CODE_OK
    assert mgr.pair_seed("alice") == 4242
    code, msg = mgr.control_handler({}, protocol.make_seed_offer(
        "carol", "dave", 1, protocol.new_nonce()
    ))
    assert code == CODE_FORBIDDEN and "elsewhere" in msg
    assert mgr.pair_seed("carol") is None
    code, _ = mgr.control_handler({}, {"kind": "mystery"})
    assert code == CODE_FORBIDDEN
    code, _ = mgr.control_handler({}, "not-a-dict")
    assert code == CODE_FORBIDDEN


def test_deterministic_seed_generation_is_symmetric():
    from rayfed_tpu.privacy import PrivacyConfig as JConfig
    from rayfed_tpu.privacy import PrivacyManager as JManager

    a = PrivacyManager("job", "alice",
                       PrivacyConfig(secure_aggregation=True, mask_seed=9))
    b = PrivacyManager("job", "bob",
                       PrivacyConfig(secure_aggregation=True, mask_seed=9))
    assert a._generate_seed("bob") == b._generate_seed("alice")
    c = PrivacyManager("job", "alice",
                       PrivacyConfig(secure_aggregation=True, mask_seed=10))
    assert a._generate_seed("bob") != c._generate_seed("bob")
    # The JAX package's party derives the same pair seed.
    j = JManager("job", "bob", JConfig(secure_aggregation=True, mask_seed=9))
    assert j._generate_seed("alice") == a._generate_seed("bob")


def test_reoffer_seeds_self_store_at_root():
    mgr = _manager("alice")
    mgr.reoffer_seeds("carol", root="alice")
    seeds = mgr.recovery_seeds("carol", ["alice"])
    assert seeds == {"alice": PAIR_SEEDS[("alice", "carol")]}
    with pytest.raises(SecAggError, match="no pairwise seed"):
        mgr.reoffer_seeds("nobody", root="alice")


# ---------------------------------------------------------------------------
# The async secure groups
# ---------------------------------------------------------------------------


def test_async_secure_group_folds_on_completeness_not_buffer_k():
    trees = {p: _int_tree(80 + i) for i, p in enumerate(PARTIES3)}
    managers, envs = _envelopes(trees, domain="async:full")
    set_privacy_manager(managers["alice"])
    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=1, staleness="constant"),
        session="full",
    )
    agg.offer("alice", envs["alice"], round_tag=0)
    agg.offer("bob", envs["bob"], round_tag=0)
    assert agg.version == 0  # buffer_k=1 did NOT force a partial unmask
    st = agg.offer("carol", envs["carol"], round_tag=0)
    assert st.get("published") == 1 and agg.version == 1
    plan = topo.plan(PARTIES3, "flat")
    _assert_trees_bitwise(secagg.jax_order(reduce_by_plan(plan, trees)),
                          agg.current()["params"])


def test_async_secure_drops_dead_party_envelope():
    trees = {p: _int_tree(90 + i) for i, p in enumerate(PARTIES3)}
    managers, envs = _envelopes(trees, domain="async:dead")
    set_privacy_manager(managers["alice"])
    agg = BufferedAggregator(
        AsyncAggregationConfig(buffer_k=2, staleness="constant"),
        liveness_fn=lambda: {"carol": DEAD},
        session="dead",
    )
    st = agg.offer("carol", envs["carol"], round_tag=0)
    assert not st["accepted"] and st["reason"] == "dead"
    assert agg.snapshot_stats()["dropped_dead"] == 1


def test_privacy_metrics_registered_and_bumped():
    from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

    reg = telemetry_metrics.get_registry()

    def _total(name):
        snap = reg.snapshot().get(name)
        if not snap:
            return 0.0
        return sum(s["value"] for s in snap["series"])

    masks0 = _total("fed_privacy_masks_exchanged_total")
    trees = {p: _int_tree(110 + i) for i, p in enumerate(PARTIES3)}
    managers, envs = _envelopes(trees)
    assert _total("fed_privacy_masks_exchanged_total") == masks0 + 6
    assert managers["alice"].stats["masks_exchanged"] == 2  # mirror

    rec0 = _total("fed_privacy_dropout_recoveries_total")
    del envs["carol"]
    root = managers["alice"]
    root.store_recovery("carol", "bob", PAIR_SEEDS[("bob", "carol")])
    root.secure_reduce("mean", PARTIES3, "dom", 0, None, envs)
    assert _total("fed_privacy_dropout_recoveries_total") == rec0 + 1

    saved0 = _total("fed_privacy_quantized_bytes_saved_total")
    from rayfed_tpu_torch._private import serialization as ser

    ser.encode_payload(
        {"g": torch.zeros(256)},
        wire_dtype=ser.wire_dtype_name("int8"),
    )
    assert _total("fed_privacy_quantized_bytes_saved_total") == \
        saved0 + 256 * 3  # 4-byte leaves shipped as 1 byte


# ---------------------------------------------------------------------------
# End-to-end: 3 real parties, real prv:seed exchange, secure FedAvg
# bitwise-equal to plaintext across the sync fold and the async buffer.
# ---------------------------------------------------------------------------


def _secure_e2e_party(party, addresses):
    import time

    import numpy as np_
    import torch as torch_

    import rayfed_tpu_torch as fed_
    from rayfed_tpu_torch import topology as topo_
    from rayfed_tpu_torch.async_rounds import async_session_stats
    from rayfed_tpu_torch.federated import fed_aggregate
    from rayfed_tpu_torch.ops.aggregate import reduce_by_plan as reduce_
    from tests.utils import FAST_COMM_CONFIG as COMM

    parties = ["alice", "bob", "carol"]
    # Generous deadlines: a loaded host skews the parties' starts, and a
    # pair's larger party waits for the smaller one's prv:seed frame.
    fed_.init(
        addresses=addresses, party=party,
        config={
            "barrier_on_initializing": True,
            "cross_silo_comm": dict(COMM, recv_timeout_in_ms=120000),
            "privacy": {"secure_aggregation": True, "mask_seed": 1234,
                        "handshake_timeout_s": 120.0},
        },
    )

    def local_tree(p):
        rng = np_.random.default_rng(sum(map(ord, p)))
        return {
            "w": torch_.from_numpy(
                rng.integers(-500, 500, (33, 17)).astype(np_.float32)),
            "b": torch_.from_numpy(
                rng.integers(-500, 500, (7,)).astype(np_.float32)),
        }

    @fed_.remote
    def contrib(p):
        return local_tree(p)

    def bitwise(a, b):
        for k in ("w", "b"):
            assert torch_.equal(a[k], b[k]), k

    trees = {p: local_tree(p) for p in parties}
    plan = topo_.plan(parties, "flat")

    objs = {p: contrib.party(p).remote(p) for p in parties}
    sec = fed_.get(fed_aggregate(objs, op="mean", secure=True))
    bitwise(sec, reduce_(plan, trees))

    weights = {"alice": 1.0, "bob": 2.0, "carol": 5.0}
    objs = {p: contrib.party(p).remote(p) for p in parties}
    sec = fed_.get(fed_aggregate(objs, op="wmean", weights=weights,
                                 secure=True))
    bitwise(sec, reduce_(plan, trees, weights=weights))

    objs = {p: contrib.party(p).remote(p) for p in parties}
    fed_.async_round(
        objs, round_tag=0, root="alice", session="sec",
        staleness_fn="constant", secure=True, fetch_model=False,
    )
    deadline = time.monotonic() + 120
    while True:
        stats = fed_.get(async_session_stats("alice", "sec"))
        if stats["publishes"] >= 1:
            break
        assert time.monotonic() < deadline, stats
        time.sleep(0.02)
    objs = {p: contrib.party(p).remote(p) for p in parties}
    model = fed_.get(fed_.async_round(
        objs, round_tag=1, root="alice", session="sec",
        staleness_fn="constant", secure=True,
    ).model)
    assert model["version"] >= 1
    bitwise(model["params"], reduce_(plan, trees))
    deadline = time.monotonic() + 120
    while fed_.get(async_session_stats("alice", "sec"))["publishes"] < 2:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    fed_.shutdown()


def test_three_party_secure_fedavg_bitwise_end_to_end():
    run_parties(_secure_e2e_party, PARTIES3, timeout=240)


# ---------------------------------------------------------------------------
# A mixed-package secure job: JAX alice, torch bob and carol
# ---------------------------------------------------------------------------

MIXED_WEIGHTS = {"alice": 0.37, "bob": 1.7, "carol": 3.25}


def _mixed_secure_party(party, addresses, pkgs, out_dir):
    """The same secure job in either package per party: a mean rooted at
    alice, a wmean rooted at bob (objs ordered bob first), and one
    secure async round rooted at carol; off-grid f32 and f16 leaves."""
    import time

    if pkgs[party] == "jax":
        import jax.numpy as jnp

        import rayfed_tpu as fed_
        from rayfed_tpu import async_rounds as ar
        from rayfed_tpu.federated import fed_aggregate

        def tree(p):
            t = _float_trees(70, half=True)[0][p]
            return {"w": jnp.asarray(t["w"]),
                    "layers": [{"b": jnp.asarray(t["layers"][0]["b"])}],
                    "a": jnp.asarray(t["a"])}
    else:
        import rayfed_tpu_torch as fed_
        from rayfed_tpu_torch import async_rounds as ar
        from rayfed_tpu_torch.federated import fed_aggregate

        def tree(p):
            return _float_trees(70, half=True)[1][p]

    # Generous deadlines: a JAX party starts seconds after a torch one,
    # more on a loaded host, and the seed exchange waits for it.
    fed_.init(addresses=addresses, party=party, config={
        "barrier_on_initializing": True,
        "cross_silo_comm": dict(FAST_COMM_CONFIG, recv_timeout_in_ms=120000),
        "privacy": {"secure_aggregation": True, "mask_seed": 1234,
                    "handshake_timeout_s": 120.0},
    })

    @fed_.remote
    def contrib(p):
        return tree(p)

    out = {}
    objs = {p: contrib.party(p).remote(p) for p in PARTIES3}
    out["mean@alice"] = _tree_bits(fed_.get(
        fed_aggregate(objs, op="mean", secure=True)))
    objs = {p: contrib.party(p).remote(p) for p in ("bob", "alice", "carol")}
    out["wmean@bob"] = _tree_bits(fed_.get(fed_aggregate(
        objs, op="wmean", weights=MIXED_WEIGHTS, secure=True)))
    objs = {p: contrib.party(p).remote(p) for p in PARTIES3}
    h = ar.async_round(objs, root="carol", round_tag=0, session="mix",
                       weights=MIXED_WEIGHTS, secure=True, fetch_model=False)
    fed_.get([h.offers[p] for p in PARTIES3])
    if party == "carol":
        deadline = time.monotonic() + 60
        while ar.get_session("mix").current()["version"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        out["async@carol"] = _tree_bits(
            ar.get_session("mix").current()["params"])
    fed_.shutdown()
    with open(f"{out_dir}/{'-'.join(pkgs.values())}-{party}.pkl", "wb") as f:
        pickle.dump(out, f)


def test_mixed_package_secure_job_equals_the_jax_job_bitwise(tmp_path):
    runs = [{"alice": "jax", "bob": "jax", "carol": "jax"},
            {"alice": "jax", "bob": "torch", "carol": "torch"}]
    for pkgs in runs:
        run_parties(_mixed_secure_party, PARTIES3, timeout=240,
                    extra_args=(pkgs, str(tmp_path)))
    got = {}
    for pkgs in runs:
        tag = "-".join(pkgs.values())
        for p in PARTIES3:
            with open(tmp_path / f"{tag}-{p}.pkl", "rb") as f:
                got[tag, p] = pickle.load(f)
    want = got["jax-jax-jax", "alice"]
    assert set(want) == {"mean@alice", "wmean@bob"}
    assert got["jax-jax-jax", "carol"]["async@carol"]
    for (tag, p), res in got.items():
        for case in ("mean@alice", "wmean@bob"):
            assert res[case] == want[case], (tag, p, case)
    assert (got["jax-torch-torch", "carol"]["async@carol"]
            == got["jax-jax-jax", "carol"]["async@carol"])
    # Off-grid leaves: the secure mean is not the plaintext one, so the
    # agreement above is the masks' and the codec's, not a trivial fold.
    assert want["mean@alice"]["/a"][0] == "float16"
