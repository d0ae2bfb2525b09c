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

"""The port's wire codec held against the JAX package's, on the CPU.

Both packages encode the same trees (numpy / ml_dtypes leaves on the JAX
side, torch leaves on the port's) and the meta bytes and every buffer
must be byte-equal; each package decodes the other's frames bitwise; the
port's msgpack codec equals ``msgpack`` on generated values. The rest
mirrors ``test_serialization.py``, ``test_wire_precision.py``,
``test_codec_properties.py``, ``test_small_message.py`` and
``test_sockio.py`` where they exercise what the port has.
"""

import pickle
import socket
import threading
from collections import namedtuple

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rayfed_tpu._private import serialization as jser
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch._private import msgpack_codec
from rayfed_tpu_torch._private import serialization as ser
from rayfed_tpu_torch.exceptions import FedRemoteError
from rayfed_tpu_torch.proxy.tcp import sockio, wire


# ---------------------------------------------------------------------------
# Byte equality with the JAX package
# ---------------------------------------------------------------------------


def _pair_cases():
    """name -> (tree for the JAX package, the same tree for the port)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((6, 5)).astype(np.float32)
    f64 = rng.standard_normal((3, 4)) * 100.0
    f16 = rng.standard_normal((4,)).astype(np.float16)
    i32 = rng.integers(-5, 5, (7,)).astype(np.int32)
    t = torch.from_numpy
    # Rounding edges for the bf16/fp16 wire casts: exact ties, a tie
    # broken by a low bit, overflow to inf, a subnormal, signed NaNs.
    edges = np.array(
        [1 + 2**-8, 1 + 3 * 2**-8, 1 + 2**-8 + 2**-30, 65504.0 * 4, 1e-40,
         np.nan, -np.nan, np.inf, -np.inf, 3.4e38, -0.0], np.float64)
    return {
        "nested": (
            {"w": f32, "layers": [{"k": f16, "b": (i32, 3)}, None],
             "name": "x", "lr": 0.5, "flag": True, "blob": b"ab"},
            {"w": t(f32), "layers": [{"k": t(f16), "b": (t(i32), 3)}, None],
             "name": "x", "lr": 0.5, "flag": True, "blob": b"ab"},
        ),
        "bf16": (
            {"p": [f32.astype(ml_dtypes.bfloat16), f32]},
            {"p": [t(f32).to(torch.bfloat16), t(f32)]},
        ),
        "f64_and_edges": (
            [f64, edges, edges.astype(np.float32)],
            [t(f64), t(edges), t(edges.astype(np.float32))],
        ),
        "zero_d_and_empty": (
            [np.array(2.5, np.float32), np.zeros((0, 3), np.float32),
             np.zeros((2, 0), np.int64)],
            [torch.tensor(2.5), torch.zeros(0, 3),
             torch.zeros(2, 0, dtype=torch.int64)],
        ),
        "non_contiguous": (
            [f32.T, f32[::2, 1:]],
            [t(f32).T, t(f32)[::2, 1:]],
        ),
        "big_endian_numpy": (
            {"g": f32.astype(">f4"), "h": np.arange(5, dtype=">i8")},
            {"g": f32.astype(">f4"), "h": np.arange(5, dtype=">i8")},
        ),
        "bool_uint8_int64": (
            (f32 > 0, np.arange(9, dtype=np.uint8), np.arange(3)),
            (t(f32) > 0, torch.arange(9, dtype=torch.uint8), torch.arange(3)),
        ),
    }


_PAIRS = _pair_cases()
_WIRE = [None, "bfloat16", "float16", "int8"]


def _buffers_bytes(buffers):
    return [bytes(memoryview(b).cast("B")) for b in buffers]


@pytest.mark.parametrize("wire_dtype", _WIRE, ids=str)
@pytest.mark.parametrize("case", sorted(_PAIRS))
def test_frames_byte_equal_to_jax_package(case, wire_dtype):
    jtree, ptree = _PAIRS[case]
    jmeta, jbufs = jser.try_encode_tree(jtree, wire_dtype=wire_dtype)
    pmeta, pbufs = ser.try_encode_tree(ptree, wire_dtype=wire_dtype)
    assert pmeta == jmeta
    assert _buffers_bytes(pbufs) == _buffers_bytes(jbufs)


def _leaf_record(x):
    """(dtype name, shape, raw bytes) of a decoded leaf of either package."""
    if isinstance(x, torch.Tensor):
        arr, name = ser._tensor_to_host(x)
        return name, tuple(arr.shape), arr.tobytes()
    if isinstance(x, np.generic):
        # The JAX package's int8-tier decode returns a 0-d leaf as a
        # numpy scalar (``(arr * qs).astype(odt)`` on a 0-d array).
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        native = np.ascontiguousarray(x, x.dtype.newbyteorder("="))
        return x.dtype.name, x.shape, native.tobytes()
    return type(x).__name__, None, x


def _records(tree):
    leaves, spec = tree_util.tree_flatten(tree)
    return [_leaf_record(x) for x in leaves], spec


@pytest.mark.parametrize("wire_dtype", _WIRE, ids=str)
@pytest.mark.parametrize("case", sorted(_PAIRS))
def test_each_package_decodes_the_others_frames_bitwise(case, wire_dtype):
    jtree, ptree = _PAIRS[case]
    jmeta, jbufs = jser.try_encode_tree(jtree, wire_dtype=wire_dtype)
    pmeta, pbufs = ser.try_encode_tree(ptree, wire_dtype=wire_dtype)
    ref = jser.decode_payload("tree", jmeta, jser.concat_buffers(jbufs))
    from_jax = ser.decode_payload("tree", jmeta, b"".join(_buffers_bytes(jbufs)))
    from_port = jser.decode_payload("tree", pmeta, ser.concat_buffers(pbufs))
    for leaf in tree_util.tree_flatten(from_jax)[0]:
        assert not isinstance(leaf, np.ndarray)  # tensors, not arrays
    ref_rec, ref_spec = _records(ref)
    for out in (from_jax, from_port):
        rec, spec = _records(out)
        assert spec == ref_spec and rec == ref_rec
    if wire_dtype is None:
        # Lossless: the decoded tensors are the source, bit for bit.
        src_rec, _ = _records(ptree)
        assert _records(from_jax)[0] == src_rec


def test_decoded_tensors_are_writable_cpu_tensors_of_the_wire_dtype():
    meta, bufs = jser.try_encode_tree(
        {"w": np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)})
    out = ser.decode_payload("tree", meta, ser.concat_buffers(bufs))["w"]
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    out.add_(1)  # a read-only receive buffer would have been copied
    assert out.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]


@pytest.mark.parametrize("name", ["int4", "float8_e4m3fn"])
def test_unrepresentable_wire_dtype_raises_type_error(name):
    meta, bufs = jser.try_encode_tree([np.zeros(2, np.uint8)])
    meta = msgpack.unpackb(meta, raw=False)
    meta["leaves"][0]["dtype"] = name
    with pytest.raises(TypeError, match=name):
        ser.decode_payload("tree", msgpack.packb(meta, use_bin_type=True),
                           ser.concat_buffers(bufs))


# ---------------------------------------------------------------------------
# The msgpack codec against msgpack itself
# ---------------------------------------------------------------------------

_SCALARS = st.one_of(
    st.none(), st.booleans(),
    st.integers(-2**63, 2**64 - 1),
    st.floats(allow_nan=False),
    st.text(max_size=300),
    st.binary(max_size=300),
)
_VALUES = st.recursive(
    _SCALARS,
    lambda ch: st.one_of(
        st.lists(ch, max_size=20),
        st.lists(ch, max_size=5).map(tuple),
        st.dictionaries(st.text(max_size=8), ch, max_size=20),
    ),
    max_leaves=40,
)


def _listify(x):
    if isinstance(x, (list, tuple)):
        return [_listify(v) for v in x]
    if isinstance(x, dict):
        return {k: _listify(v) for k, v in x.items()}
    return x


@settings(max_examples=300, deadline=None)
@given(_VALUES)
def test_codec_packs_like_msgpack_and_round_trips(value):
    blob = msgpack_codec.packb(value, use_bin_type=True)
    assert blob == msgpack.packb(value, use_bin_type=True)
    assert msgpack.unpackb(blob, raw=False) == _listify(value)
    assert msgpack_codec.unpackb(blob, raw=False) == _listify(value)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(-2**63, 2**64 - 1), max_size=40),
       st.lists(st.sampled_from([0, 31, 32, 255, 256, 65535, 65536]),
                max_size=4))
def test_codec_length_boundaries_match_msgpack(ints, lengths):
    value = {"i": ints, "s": ["x" * n for n in lengths],
             "b": [b"y" * n for n in lengths],
             "a": [[0] * min(n, 70000) for n in lengths]}
    assert msgpack_codec.packb(value) == msgpack.packb(value, use_bin_type=True)


def test_codec_strict_types_and_errors_match_msgpack():
    for value in [(1, 2), [1, (2,)]]:
        with pytest.raises(TypeError):
            msgpack.packb(value, use_bin_type=True, strict_types=True)
        with pytest.raises(TypeError):
            msgpack_codec.packb(value, use_bin_type=True, strict_types=True)
    ok = {"a": [1, 2.5, None, True, b"z"]}
    assert msgpack_codec.packb(ok, strict_types=True) == msgpack.packb(
        ok, use_bin_type=True, strict_types=True)
    for bad in [2**64, -2**63 - 1]:
        with pytest.raises(OverflowError):
            msgpack_codec.packb(bad)
    with pytest.raises(TypeError):
        msgpack_codec.packb(object())
    blob = msgpack.packb({1: 2})
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(blob, raw=False)
    assert msgpack_codec.unpackb(blob, raw=False, strict_map_key=False) == {1: 2}
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(msgpack.packb([1, 2, 3])[:-1], raw=False)
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(msgpack.packb(1) + b"\x01", raw=False)


# ---------------------------------------------------------------------------
# Mirrors of test_serialization.py
# ---------------------------------------------------------------------------


def roundtrip(data, allowed=None):
    kind, meta, buffers = ser.encode_payload(data)
    payload = ser.concat_buffers(buffers)
    return kind, ser.decode_payload(kind, meta, payload, allowed)


def test_array_tree_fast_path():
    data = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.ones(4, dtype=torch.float64),
        "step": 7,
        "name": "layer0",
        "nested": [np.int32(3), {"flag": True, "none": None}],
    }
    kind, out = roundtrip(data)
    assert kind == "tree"
    assert torch.equal(out["w"], data["w"]) and torch.equal(out["b"], data["b"])
    assert out["step"] == 7 and out["name"] == "layer0"
    assert out["nested"][0].dtype == torch.int32 and out["nested"][0] == 3
    assert out["nested"][1] == {"flag": True, "none": None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16], ids=str)
def test_tensor_roundtrip_keeps_dtype_shape_and_bits(dtype):
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(dtype)
    for value in (x, x.T, x[0], x.reshape(-1)[3]):
        kind, out = roundtrip([value])
        assert kind == "tree"
        assert out[0].dtype == dtype and out[0].shape == value.shape
        assert torch.equal(out[0], value)


def test_tensor_with_grad_is_detached():
    x = torch.ones(3, requires_grad=True) * 2
    kind, out = roundtrip({"x": x})
    assert kind == "tree" and not out["x"].requires_grad
    assert out["x"].tolist() == [2.0, 2.0, 2.0]


def test_zero_dim_and_empty_arrays():
    kind, out = roundtrip({"s": np.float32(2.5), "e": torch.zeros((0, 3))})
    assert kind == "tree"
    assert out["s"] == 2.5 and out["s"].shape == ()
    assert out["e"].shape == (0, 3)


class Custom:
    def __init__(self, v):
        self.v = v

    def __eq__(self, other):
        return isinstance(other, Custom) and other.v == self.v


def test_pickle_fallback_for_custom_objects():
    kind, out = roundtrip(Custom(5))
    assert kind == "pickle"
    assert out == Custom(5)


def test_namedtuple_falls_back_to_pickle():
    P = globals().setdefault("_P", namedtuple("_P", "x y"))
    kind, _, _ = ser.encode_payload(P(1, 2))
    assert kind == "pickle"


def test_lambda_is_refused_by_stdlib_pickle():
    # The port pickles with the stdlib, not cloudpickle (ROADMAP Queue 3).
    with pytest.raises((pickle.PicklingError, AttributeError)):
        ser.encode_payload(lambda x: x)


@pytest.mark.parametrize(
    "allowed", [{__name__: ["Custom"]}, {__name__: ["*"]}, {__name__: None},
                {"*": None}],
    ids=["listed", "wildcard", "none_value", "top_level_star"])
def test_whitelist_admits(allowed):
    assert ser.restricted_loads(ser.dumps(Custom(5)), allowed) == Custom(5)


def test_whitelist_blocks_non_whitelisted_class():
    with pytest.raises(pickle.UnpicklingError):
        ser.restricted_loads(ser.dumps(Custom(5)), {"numpy": ["ndarray"]})


@pytest.mark.parametrize("allowed", [None, {"numpy": ["ndarray"]}],
                         ids=["open", "whitelist"])
def test_fed_remote_error_always_unpicklable(allowed):
    out = ser.restricted_loads(
        ser.dumps(FedRemoteError("alice", "cause")), allowed)
    assert isinstance(out, FedRemoteError)
    assert out.src_party == "alice"


def test_error_envelopes_cross_between_packages():
    import rayfed_tpu.exceptions as jexc

    # The port writes the envelope under the JAX package's class name, so
    # the JAX package's whitelist loads it as its own class ...
    blob = ser.dumps(FedRemoteError("bob", ValueError("boom")))
    assert b"rayfed_tpu_torch" not in blob
    got = jser.restricted_loads(blob, {"numpy": ["ndarray"]})
    assert type(got) is jexc.FedRemoteError
    assert got.src_party == "bob" and repr(got.cause) == "ValueError('boom')"
    # ... and the JAX package's envelope loads here as the port's class.
    for allowed in (None, {"numpy": ["ndarray"]}):
        got = ser.restricted_loads(
            jser.dumps(jexc.FedRemoteError("alice", None)), allowed)
        assert type(got) is FedRemoteError and got.src_party == "alice"


# ---------------------------------------------------------------------------
# Mirrors of test_wire_precision.py
# ---------------------------------------------------------------------------


def _wire_roundtrip(value, knob=None):
    kind, meta, buffers = ser.encode_payload(
        value, wire_dtype=ser.wire_dtype_name(knob))
    assert kind == "tree", kind
    return ser.decode_payload(kind, meta, ser.concat_buffers(buffers), {})


def test_bf16_representable_values_roundtrip_exactly():
    x = torch.tensor([1.0, -2.0, 0.5, 4096.0, 0.0, -0.25])
    out = _wire_roundtrip({"g": x}, "bf16")["g"]
    assert out.dtype == torch.float32 and torch.equal(out, x)


def test_bf16_error_bound_and_dtype_restoration():
    x = torch.randn(512, generator=torch.Generator().manual_seed(0))
    out = _wire_roundtrip({"g": x}, "bf16")["g"]
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x, rtol=2**-8, atol=0)
    assert not torch.equal(out, x)  # genuinely lossy on random data


def test_fp16_roundtrip_and_float64_downcast():
    x64 = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64)
    out = _wire_roundtrip({"g": x64}, "fp16")["g"]
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, x64, rtol=2**-11, atol=2**-20)


def test_bf16_keeps_fp32_range_where_fp16_overflows():
    x = torch.tensor([1e5, -3e38])
    out = _wire_roundtrip({"g": x}, "bf16")["g"]
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, x, rtol=2**-8, atol=0)


def test_non_float_and_half_leaves_untouched():
    tree = {"i": torch.arange(16, dtype=torch.int32),
            "b": torch.tensor([True, False]),
            "h": torch.tensor([1.5, 2.5], dtype=torch.float16),
            "bf": torch.tensor([1.5, 2.5], dtype=torch.bfloat16),
            "s": "label", "k": 7}
    out = _wire_roundtrip(tree, "bf16")
    for key in ("i", "b", "h", "bf"):
        assert out[key].dtype == tree[key].dtype
        assert torch.equal(out[key], tree[key])
    assert out["s"] == "label" and out["k"] == 7


def test_wire_bytes_actually_halve():
    x = torch.zeros(1024)
    _, _, raw = ser.encode_payload({"g": x})
    _, _, cast = ser.encode_payload({"g": x},
                                    wire_dtype=ser.wire_dtype_name("bf16"))
    assert sum(memoryview(b).nbytes for b in cast) * 2 == sum(
        memoryview(b).nbytes for b in raw)


def test_unknown_knob_rejected():
    with pytest.raises(ValueError, match="payload_wire_dtype"):
        ser.wire_dtype_name("int4")


def test_int8_knob_names_its_roadmap_item():
    # The privacy plane's quantized tier: the knob names the int8 wire
    # dtype in both packages (fed.init gates it on privacy.quantize).
    assert ser.wire_dtype_name("int8") == "int8"
    assert ser.wire_dtype_name("INT8") == jser.wire_dtype_name("int8")


def test_off_by_default_bitwise_exact():
    x = torch.randn(64, generator=torch.Generator().manual_seed(1))
    out = _wire_roundtrip({"g": x})["g"]
    assert out.dtype == torch.float32 and torch.equal(out, x)


def test_big_endian_source_array_roundtrips_correctly():
    out = _wire_roundtrip({"g": np.arange(4, dtype=">f4")})["g"]
    assert torch.equal(out, torch.arange(4, dtype=torch.float32))


def test_int8_tier_frames_from_the_jax_package_decode():
    # The quantized tier's frames decode: the scale rides the meta and
    # dequantizes to odt (tests/test_torch_quantize.py holds the port's
    # own int8 frames byte for byte).
    x = np.linspace(-1.0, 1.0, 33, dtype=np.float32)
    meta, bufs = jser.try_encode_tree({"g": x}, wire_dtype="int8")
    ref = jser.decode_payload("tree", meta, jser.concat_buffers(bufs))["g"]
    out = ser.decode_payload("tree", meta, ser.concat_buffers(bufs))["g"]
    assert out.dtype == torch.float32
    assert out.numpy().tobytes() == ref.tobytes()


# ---------------------------------------------------------------------------
# Mirrors of test_codec_properties.py
# ---------------------------------------------------------------------------

_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_,
           np.float16, "bf16"]


def _tensors():
    def build(draw):
        dtype, shape, seed = draw
        rng = np.random.default_rng(seed)
        if dtype == np.bool_:
            return torch.from_numpy(np.asarray(rng.integers(0, 2, size=shape)
                                               > 0))
        if dtype == "bf16":
            return torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
        if np.issubdtype(dtype, np.integer):
            return torch.from_numpy(rng.integers(0, 100, size=shape)
                                    .astype(dtype))
        return torch.from_numpy(rng.normal(size=shape).astype(dtype))

    shapes = st.lists(st.integers(0, 5), min_size=0, max_size=3).map(tuple)
    return st.tuples(st.sampled_from(_DTYPES), shapes,
                     st.integers(0, 2**31)).map(build)


def _trees():
    leaves = st.one_of(
        _tensors(), st.integers(-2**31, 2**31),
        st.floats(allow_nan=False, allow_infinity=False, width=32),
        st.booleans(), st.none(), st.text(max_size=12), st.binary(max_size=32))
    return st.recursive(
        leaves,
        lambda children: st.one_of(
            st.lists(children, max_size=4),
            st.dictionaries(st.text(max_size=6), children, max_size=4),
            st.lists(children, max_size=3).map(tuple),
        ),
        max_leaves=12,
    )


def _assert_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), type(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, float):
        assert a == pytest.approx(b, nan_ok=True)
    else:
        assert a == b, (a, b)


@settings(max_examples=120, deadline=None)
@given(_trees())
def test_payload_roundtrip(tree):
    kind, meta, buffers = ser.encode_payload(tree)
    out = ser.decode_payload(kind, meta, ser.concat_buffers(buffers), None)
    _assert_equal(tree, out)


@settings(max_examples=60, deadline=None)
@given(_trees(), st.integers(0, 2**31))
def test_truncated_tree_payload_never_returns_wrong_data(tree, seed):
    kind, meta, buffers = ser.encode_payload(tree)
    payload = ser.concat_buffers(buffers)
    if kind != "tree" or len(payload) == 0:
        return
    cut = np.random.default_rng(seed).integers(0, len(payload))
    try:
        out = ser.decode_payload(kind, meta, payload[:cut], None)
    except Exception:
        return  # controlled rejection is the expected outcome
    _assert_equal(tree, out)


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=0, max_size=4096),
       st.sampled_from(["zlib", "zstd"]), st.integers(1, 5))
def test_compression_roundtrip(raw, scheme, level):
    packed = ser.compress_buffers([raw], scheme, level)
    if packed is None:
        return  # incompressible payloads legitimately ship raw
    blob, raw_len = packed
    assert raw_len == len(raw)
    out = ser.decompress_payload(blob, scheme, raw_len, max_bytes=1 << 20)
    assert bytes(memoryview(out)) == raw


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=1, max_size=512), st.sampled_from(["zlib", "zstd"]))
def test_garbage_never_decompresses_silently(blob, scheme):
    try:
        out = ser.decompress_payload(blob, scheme, len(blob), max_bytes=1 << 20)
    except Exception:
        return
    assert memoryview(out).nbytes == len(blob)


@settings(max_examples=120, deadline=None)
@given(st.integers(0, 255),
       st.dictionaries(st.text(max_size=8),
                       st.one_of(st.text(max_size=8), st.integers(0, 2**31),
                                 st.booleans(), st.binary(max_size=16)),
                       max_size=6),
       st.integers(0, 2**40))
def test_frame_prefix_header_roundtrip(ftype, header, payload_len):
    raw = wire.encode_prefix_and_header(ftype, header, payload_len)
    from rayfed_tpu.proxy.tcp import wire as jwire

    assert raw == jwire.encode_prefix_and_header(ftype, header, payload_len)
    magic, version, ft, hlen, plen = wire._PREFIX.unpack(raw[:wire.PREFIX_LEN])
    assert magic == wire.WIRE_MAGIC and version == wire.WIRE_VERSION
    assert ft == ftype and plen == payload_len
    assert msgpack.unpackb(raw[wire.PREFIX_LEN:wire.PREFIX_LEN + hlen],
                           raw=False) == header


@settings(max_examples=80, deadline=None)
@given(_trees(), st.sampled_from(["bf16", "fp16"]))
def test_wire_dtype_roundtrip_structure_dtype_and_bounds(tree, knob):
    kind, meta, buffers = ser.encode_payload(
        tree, wire_dtype=ser.wire_dtype_name(knob))
    if kind != "tree":
        return
    out = ser.decode_payload(kind, meta, ser.concat_buffers(buffers), None)
    flat_in, spec_in = tree_util.tree_flatten(tree)
    flat_out, spec_out = tree_util.tree_flatten(out)
    assert spec_in == spec_out
    rtol = 2**-8 if knob == "bf16" else 2**-11
    for a, b in zip(flat_in, flat_out):
        if isinstance(a, torch.Tensor) and a.dtype in (torch.float32,
                                                        torch.float64):
            assert b.dtype == a.dtype
            a64, b64 = a.double(), b.double()
            keep = torch.isfinite(a64)
            if knob == "fp16":
                keep &= a64.abs() < 6e4  # fp16 overflows past 65504
            torch.testing.assert_close(
                b64[keep], a64[keep], rtol=rtol,
                atol=(2**-24 if knob == "fp16" else 2**-133))
        else:
            _assert_equal(a, b)


# ---------------------------------------------------------------------------
# Mirrors of test_small_message.py and test_sockio.py (Python IO path)
# ---------------------------------------------------------------------------

_CLEAN = [None, True, 0, -1, 2**63 - 1, 1.5, "", "héllo", b"\x00\xff",
          [], [1, [2, [3]]], {}, {"a": {"b": [1, None]}}, {1: "int key"}]
_DIRTY = [(1, 2), [1, (2,)], np.float32(1.0), torch.ones(2), {"a": {1, 2}},
          2**64, {(1, 2): 3}]


@pytest.mark.parametrize("value", _CLEAN, ids=repr)
def test_compact_roundtrip_exact_types(value):
    blob = ser.try_encode_compact(value, 1 << 16)
    assert blob is not None
    assert blob == jser.try_encode_compact(value, 1 << 16)
    out = ser.decode_compact(blob)
    assert out == value and type(out) is type(value)


@pytest.mark.parametrize("value", _DIRTY, ids=lambda v: repr(v)[:40])
def test_compact_declines_unclean(value):
    assert ser.try_encode_compact(value, 1 << 16) is None


def test_encode_payload_routes_by_threshold():
    assert ser.encode_payload({"a": 1}, small_threshold=64)[0] == "mp"
    assert ser.encode_payload({"a": "x" * 100}, small_threshold=64)[0] == "tree"
    assert ser.encode_payload({"t": torch.ones(2)}, small_threshold=64)[0] \
        == "tree"
    assert ser.encode_payload({"a": 1})[0] == "tree"


def test_quick_payload_bound_is_conservative():
    for value in [{"t": torch.ones(64)}, [torch.zeros(3, dtype=torch.bfloat16),
                                          "abc", 7], {"n": None}]:
        kind, meta, buffers = ser.encode_payload(value)
        actual = len(meta) + sum(ser.buffer_nbytes(b) for b in buffers)
        assert ser.quick_payload_bound(value, actual + 512)
    assert not ser.quick_payload_bound({"t": torch.ones(1024)}, 1024)


def _roundtrip_frame(header, buffers, max_payload=None):
    a, b = socket.socketpair()
    result = {}

    def reader():
        try:
            result["frame"] = sockio.recv_frame(b, max_payload=max_payload)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            result["error"] = e

    t = threading.Thread(target=reader)
    t.start()
    try:
        sockio.send_frame(a, wire.FTYPE_DATA, header, buffers)
        t.join(timeout=10)
    finally:
        a.close()
        b.close()
    assert not t.is_alive(), "reader thread did not finish within 10s"
    if "error" in result:
        raise result["error"]
    return result["frame"]


def test_python_io_path_runs_without_the_native_extension(monkeypatch):
    # The port builds its native lane where a C++ compiler exists (here);
    # with the module taken away, frames take sockio's Python path and
    # cross the same.
    assert sockio.io_path() == "native"
    monkeypatch.setattr(sockio, "_fastwire", None)
    assert sockio.io_path() == "python"
    payload = bytes(range(256)) * 300
    header = {"up": 1, "down": 2, "job": "j", "pkind": "tree"}
    ftype, hdr, got = _roundtrip_frame(header, [payload[:1000],
                                                payload[1000:]])
    assert ftype == wire.FTYPE_DATA and hdr == header
    assert ser.payload_bytes(got) == payload


@pytest.mark.parametrize("nbytes", [0, 1, 65535, 65536, 1 << 20])
def test_frame_roundtrip(nbytes):
    payload = bytes(range(256)) * (nbytes // 256) + b"x" * (nbytes % 256)
    header = {"up": 1, "down": 2, "job": "j", "pkind": "tree"}
    ftype, hdr, got = _roundtrip_frame(header, [payload[: nbytes // 2],
                                                payload[nbytes // 2:]])
    assert ftype == wire.FTYPE_DATA and hdr == header
    assert ser.payload_bytes(got) == payload


def test_oversized_frame_rejected_before_buffering():
    with pytest.raises(Exception, match="(?i)exceed|too large|max"):
        _roundtrip_frame({"up": 1}, [b"x" * 4096], max_payload=1024)
