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

"""The port's optional wire compression (``rayfed_tpu_torch/_private/
serialization.py``, zlib + zstd): the mirrors of
``tests/test_compression.py`` on torch trees — helper round-trips with
decompression-bomb guards, writable decoded tensors, and two-party pushes
with ``payload_compression`` set, plus a compressed push under the int8
wire tier (the tier and the codec share the tree lane)."""

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch._private import serialization
from tests.utils import FAST_COMM_CONFIG, run_parties

try:
    import zstandard  # noqa: F401

    _HAS_ZSTD = True
except ImportError:
    _HAS_ZSTD = False

# The zstd scheme rides the optional 'zstandard' C extension (the zlib
# scheme is stdlib and always covered); without it the serialization
# layer refuses the scheme at config time, so these cases skip.
requires_zstd = pytest.mark.skipif(
    not _HAS_ZSTD, reason="optional 'zstandard' module not installed"
)

_SCHEMES = ["zlib", pytest.param("zstd", marks=requires_zstd)]


@pytest.mark.parametrize("scheme", _SCHEMES)
def test_compress_roundtrip(scheme):
    buffers = [b"abc" * 1000, torch.zeros(1000).numpy()]
    blob, raw_len = serialization.compress_buffers(buffers, scheme)
    raw = b"".join(memoryview(b).cast("B") for b in buffers)
    assert raw_len == len(raw)
    assert len(blob) < raw_len
    out = serialization.decompress_payload(blob, scheme, raw_len, None)
    assert bytes(out) == raw


@pytest.mark.parametrize("scheme", _SCHEMES)
def test_incompressible_ships_raw(scheme):
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, size=200_000, dtype=np.uint8).tobytes()
    assert serialization.compress_buffers([noise], scheme) is None


def test_unknown_scheme_rejected():
    with pytest.raises(ValueError, match="unknown payload_compression"):
        serialization.compress_buffers([b"x"], "lz77")
    with pytest.raises(ValueError, match="unknown compression scheme"):
        serialization.decompress_payload(b"x", "lz77", 1, None)


def test_decompression_bomb_guards():
    import zlib

    raw = b"\x00" * 1_000_000
    blob = zlib.compress(raw, 9)
    # Declared rawlen smaller than reality -> rejected.
    with pytest.raises(ValueError, match="inflates past"):
        serialization.decompress_payload(blob, "zlib", 1000, None)
    # Receiver-side cap smaller than the payload -> rejected before any
    # rawlen-sized allocation.
    with pytest.raises(ValueError, match="past the allowed size"):
        serialization.decompress_payload(blob, "zlib", len(raw), 4096)
    # Out-of-range compression level -> config-shaped error at send time.
    with pytest.raises(ValueError, match="compression_level"):
        serialization.compress_buffers([b"x" * 100], "zlib", level=10)
    # Missing rawlen header -> rejected (never an unbounded inflate).
    with pytest.raises(ValueError, match="missing its rawlen"):
        serialization.decompress_payload(blob, "zlib", -1, None)
    # Trailing garbage after the stream -> rejected.
    with pytest.raises(ValueError, match="trailing bytes"):
        serialization.decompress_payload(
            blob + b"junk", "zlib", len(raw), None
        )


def _ramp_and_noise():
    # Highly compressible (ramp) + an incompressible noise tail: the
    # first crosses compressed, the second falls back to raw framing.
    ramp = {"w": torch.arange(512.0).repeat(2048)}
    rng = np.random.default_rng(7)
    noise = torch.from_numpy(
        rng.integers(0, 2**31, size=300_000, dtype=np.int32))
    return ramp, noise


def run_compressed_push(party, addresses, transport, scheme="zlib",
                        wire_dtype=None):
    comm = dict(FAST_COMM_CONFIG)
    comm["payload_compression"] = scheme
    if scheme == "zstd":
        comm["compression_level"] = 3
    config = {"cross_silo_comm": comm, "transport": transport}
    if wire_dtype is not None:
        comm["payload_wire_dtype"] = wire_dtype
        config["privacy"] = {"quantize": "int8"}
    fed.init(addresses=addresses, party=party, config=config)

    @fed.remote
    def produce():
        return _ramp_and_noise()

    @fed.remote
    def digest(pair):
        ramp, noise = pair
        return float(ramp["w"].double().sum()) + float(
            noise.to(torch.int64).sum())

    out = digest.party("bob").remote(produce.party("alice").remote())
    got = fed.get(out)

    ramp, noise = _ramp_and_noise()
    if wire_dtype == "int8":
        from rayfed_tpu_torch.privacy import quantize

        q, s = quantize.quantize_leaf(ramp["w"])
        ramp = {"w": quantize.dequantize_leaf(q, s, torch.float32)}
    expect = float(ramp["w"].double().sum()) + float(
        noise.to(torch.int64).sum())
    assert got == expect, (got, expect)
    fed.shutdown()


def test_two_party_compressed_push_tcp():
    run_parties(run_compressed_push, ["alice", "bob"], extra_args=("tcp",))


@requires_zstd
def test_two_party_zstd_push_tcp():
    run_parties(
        run_compressed_push, ["alice", "bob"], extra_args=("tcp", "zstd")
    )


def test_two_party_compressed_int8_push_tcp():
    run_parties(run_compressed_push, ["alice", "bob"],
                extra_args=("tcp", "zlib", "int8"))


@requires_zstd
def test_zstd_bomb_guards():
    import zstandard

    raw = b"\x00" * 1_000_000
    blob = zstandard.ZstdCompressor(level=3).compress(raw)
    # Declared rawlen smaller than reality -> rejected without a
    # full-size materialisation.
    with pytest.raises(ValueError, match="inflates past"):
        serialization.decompress_payload(blob, "zstd", 1000, None)
    # Receiver-side cap smaller than the payload -> rejected up front.
    with pytest.raises(ValueError, match="past the allowed size"):
        serialization.decompress_payload(blob, "zstd", len(raw), 4096)
    # Truncated/declared-too-large stream -> size mismatch error.
    with pytest.raises(ValueError, match="!= declared rawlen"):
        serialization.decompress_payload(blob, "zstd", len(raw) + 5, None)
    # Corrupt stream -> clean ValueError, not a zstd traceback.
    with pytest.raises(ValueError, match="corrupt zstd stream"):
        serialization.decompress_payload(
            b"\x12\x34" + blob[2:], "zstd", len(raw), None
        )
    # zstd levels are validated on their own range.
    with pytest.raises(ValueError, match="compression_level"):
        serialization.compress_buffers([b"x" * 100], "zstd", level=23)
    # Trailing garbage after the frame -> rejected (parsed as a next
    # frame, which fails its header check).
    with pytest.raises(ValueError, match="corrupt zstd stream"):
        serialization.decompress_payload(
            blob + b"junk", "zstd", len(raw), None
        )
    # A valid SECOND frame appended -> rejected (inflates past rawlen).
    with pytest.raises(ValueError, match="inflates past"):
        serialization.decompress_payload(
            blob + blob, "zstd", len(raw), None
        )


def test_decompressed_tensors_are_writable():
    """Raw frames decode to writable tensors (recv pool); compressed
    frames must match that invariant."""
    arr = torch.arange(64.0).repeat(64)
    kind, meta, buffers = serialization.encode_payload({"w": arr})
    blob, raw_len = serialization.compress_buffers(buffers, "zlib")
    payload = serialization.decompress_payload(blob, "zlib", raw_len, None)
    out = serialization.decode_payload(kind, meta, payload)
    out["w"][0] = 42.0  # raises if the tensor is over a read-only buffer
    assert out["w"][0] == 42.0
    assert torch.equal(out["w"][1:], arr[1:])
