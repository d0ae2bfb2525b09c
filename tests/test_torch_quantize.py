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

"""The port's int8 quantizer (``rayfed_tpu_torch/privacy/quantize.py``)
and its wire tier (``payload_wire_dtype="int8"``) on the CPU: the mirrors
of ``tests/test_privacy.py``'s quantizer tests on torch trees, the port
against the JAX package on the same numpy inputs (leaf and tree
quantization, error feedback over rounds, bit for bit; the int8 frames
are held byte for byte in tests/test_torch_wire.py), and spawned int8
pushes: a torch bob to a JAX alice, and between two torch parties.
"""

import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu_torch.privacy import quantize as quant_mod
from tests.test_torch_privacy import _assert_trees_bitwise, _tree_bits
from tests.utils import FAST_COMM_CONFIG, run_parties


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((33, 17)) * 3).astype(np.float32),
        "layers": [{"b": rng.standard_normal(9).astype(np.float64),
                    "h": (rng.standard_normal(130) * 5).astype(np.float16)}],
        "z": np.zeros(6, np.float32),
        "i": rng.integers(-9, 9, 4).astype(np.int32),
        "e": rng.standard_normal(8).astype(ml_dtypes.bfloat16),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(257,)).astype(np.float32))
    q, scale = quant_mod.quantize_leaf(x)
    assert q.dtype == torch.int8
    back = quant_mod.dequantize_leaf(q, scale, x.dtype)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0,
                               atol=scale / 2 + 1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_quantize_leaf_equals_the_jax_package(dtype):
    from rayfed_tpu.privacy import quantize as jquant

    rng = np.random.default_rng(3)
    for x in (rng.standard_normal((40, 3)) * 7, np.zeros(5),
              np.array([0.5, -0.5, 1.5, -127.5, 127.0]),  # ties to even
              np.zeros((0,)), np.array(3.25)):
        x = np.asarray(x, dtype)
        q, scale = quant_mod.quantize_leaf(torch.from_numpy(x))
        jq, jscale = jquant.quantize_leaf(x)
        assert scale == jscale
        assert q.numpy().tobytes() == jq.tobytes()
        back = quant_mod.dequantize_leaf(q, scale, x.dtype.name)
        assert back.numpy().tobytes() == jquant.dequantize_leaf(
            jq, jscale, x.dtype).tobytes()


def test_quantize_tree_equals_the_jax_package():
    # JAX's leaf order (sorted keys) for the scales and dtypes; bf16 and
    # integer leaves pass through, as in the JAX package.
    from rayfed_tpu.privacy import quantize as jquant

    tree = _np_tree(1)
    env = quant_mod.quantize_tree(_to_torch(tree))
    jenv = jquant.quantize_tree(tree)
    assert env["scales"] == jenv["scales"]
    assert env["dtypes"] == jenv["dtypes"]
    assert _tree_bits(env["q"]) == _tree_bits(jenv["q"])
    assert list(env["q"]) == sorted(tree)
    _assert_trees_bitwise(quant_mod.dequantize_tree(env),
                          jquant.dequantize_tree(jenv))
    # Each package dequantizes the other's envelope.
    _assert_trees_bitwise(quant_mod.dequantize_tree(
        {**jenv, "q": _to_torch(jenv["q"])}), jquant.dequantize_tree(jenv))


def test_error_feedback_compensates_over_rounds():
    # A constant update off the int8 grid: stateless quantization biases
    # every round by the same residual; error feedback carries it so the
    # RUNNING SUM of restored updates stays within one grid step of the
    # truth instead of drifting linearly.
    x = {"w": torch.full((64,), 0.3)}
    scale = 0.3 / 127.0
    ef = quant_mod.ErrorFeedbackQuantizer()
    total = torch.zeros(64, dtype=torch.float64)
    rounds = 50
    for _ in range(rounds):
        packed = ef.quantize("alice", x)
        total += quant_mod.dequantize_tree(packed)["w"].double()
    err = (total - rounds * 0.3).abs()
    assert float(err.max()) <= scale + 1e-9

    # Stateless comparison drifts: each round repeats the same rounding.
    q, s = quant_mod.quantize_leaf(x["w"])
    per_round_bias = abs(float(
        quant_mod.dequantize_leaf(q, s, torch.float32)[0]) - 0.3)
    if per_round_bias > 0:
        assert per_round_bias * rounds > float(err.max())

    ef.reset("alice")
    assert ef.residual("alice") is None


def test_error_feedback_equals_the_jax_package_over_rounds():
    from rayfed_tpu.privacy import quantize as jquant

    ef, jef = quant_mod.ErrorFeedbackQuantizer(), \
        jquant.ErrorFeedbackQuantizer()
    for r in range(3):
        tree = _np_tree(10 + r)
        for party in ("alice", "bob"):
            env = ef.quantize(party, _to_torch(tree))
            jenv = jef.quantize(party, tree)
            assert env["scales"] == jenv["scales"]
            assert _tree_bits(env["q"]) == _tree_bits(jenv["q"])
            res, jres = ef.residual(party), jef.residual(party)
            assert _tree_bits(res) == _tree_bits(jres)
            assert all(x.dtype == torch.float64 for x in
                       quant_mod._leaves(res)[0])
    ef.reset()
    assert ef.residual("bob") is None


# ---------------------------------------------------------------------------
# The int8 wire tier
# ---------------------------------------------------------------------------


def test_int8_tier_quantizes_wide_floats_only():
    from rayfed_tpu_torch._private import serialization as ser

    tree = {"f32": torch.linspace(-1, 1, 40), "f64": torch.ones(3,
            dtype=torch.float64), "f16": torch.ones(4, dtype=torch.float16),
            "bf16": torch.ones(4, dtype=torch.bfloat16),
            "i": torch.arange(5)}
    meta, bufs = ser.try_encode_tree(tree, wire_dtype="int8")
    import msgpack

    descs = msgpack.unpackb(meta, raw=False)["leaves"]
    assert ["qs" in d for d in descs] == [True, True, False, False, False]
    assert [(d["dtype"], d.get("odt")) for d in descs] == [
        ("int8", "float32"), ("int8", "float64"), ("float16", None),
        ("bfloat16", None), ("int64", None)]
    # A quarter of the f32 bytes, an eighth of the f64's.
    assert [memoryview(b).nbytes for b in bufs[:2]] == [40, 3]
    out = ser.decode_payload("tree", meta, ser.concat_buffers(bufs))
    env = quant_mod.quantize_tree({"f32": tree["f32"]})
    assert torch.equal(out["f32"],
                       quant_mod.dequantize_tree(env)["f32"])


def test_capture_keeps_card_leaves_for_the_int8_tier_only():
    # On the CPU a captured leaf is a clone either way; the int8 tier
    # changes nothing for CPU leaves.
    from rayfed_tpu_torch.proxy import barriers

    tree = {"w": torch.ones(3), "i": torch.arange(2)}
    for quantize in (False, True):
        out = barriers._host_snapshot(tree, quantize)
        assert out["w"] is not tree["w"] and torch.equal(out["w"], tree["w"])


def _int8_push_party(party, addresses, pkgs, out_dir):
    """bob pushes an f32 tree to alice under the int8 tier; alice
    records what arrived."""
    comm = dict(FAST_COMM_CONFIG, payload_wire_dtype="int8")
    privacy = {"quantize": "int8"}
    tree = _np_tree(21)
    if pkgs[party] == "jax":
        import rayfed_tpu as fed_
    else:
        import rayfed_tpu_torch as fed_

    fed_.init(addresses=addresses, party=party, config={
        "barrier_on_initializing": True, "cross_silo_comm": comm,
        "privacy": privacy})

    @fed_.remote
    def produce():
        if pkgs["bob"] == "jax":
            return tree
        return _to_torch(tree)

    @fed_.remote
    def record(t):
        return _tree_bits(t)

    got = fed_.get(record.party("alice").remote(produce.party("bob").remote()))
    saved = None
    if party == "bob" and pkgs["bob"] == "torch":
        from rayfed_tpu_torch.privacy import get_privacy_manager

        saved = get_privacy_manager().stats["quantized_bytes_saved"]
    fed_.shutdown()
    with open(f"{out_dir}/{'-'.join(pkgs.values())}-{party}.pkl", "wb") as f:
        pickle.dump({"tree": got, "saved": saved}, f)


@pytest.mark.parametrize("alice", ["jax", "torch"])
def test_torch_int8_push_decodes_bitwise(tmp_path, alice):
    from rayfed_tpu.privacy import quantize as jquant

    pkgs = {"alice": alice, "bob": "torch"}
    run_parties(_int8_push_party, ["alice", "bob"], timeout=240,
                extra_args=(pkgs, str(tmp_path)))
    with open(tmp_path / f"{alice}-torch-alice.pkl", "rb") as f:
        got = pickle.load(f)["tree"]
    with open(tmp_path / f"{alice}-torch-bob.pkl", "rb") as f:
        saved = pickle.load(f)["saved"]
    # What the JAX package's own int8 tier would have delivered: each
    # f32/f64 leaf dequantized from its int8 grid, the rest as sent.
    tree = _np_tree(21)
    want = {}
    for k, v in tree.items():
        if k == "layers":
            continue
        if v.dtype.kind == "f" and v.dtype.itemsize > 2:
            q, s = jquant.quantize_leaf(v)
            v = jquant.dequantize_leaf(q, s, v.dtype)
        want[k] = v
    b = tree["layers"][0]["b"]
    q, s = jquant.quantize_leaf(b)
    want["layers"] = [{"b": jquant.dequantize_leaf(q, s, b.dtype),
                       "h": tree["layers"][0]["h"]}]
    assert got == _tree_bits(want)
    # bob's savings: three quarters of w's and z's f32 bytes, seven
    # eighths of b's f64 bytes.
    assert saved == (33 * 17 + 6) * 3 + 9 * 7
