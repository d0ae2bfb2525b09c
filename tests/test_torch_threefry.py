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

"""The port's threefry (``rayfed_tpu_torch/privacy/threefry.py``) held
bitwise against ``jax.random`` under the JAX package's settings (threefry
partitionable, x64 off): ``PRNGKey`` on seeds past 32 bits (whose high
word JAX drops), ``fold_in`` chains, ``bits(dtype=uint32)`` on every
shape class, any range of a stream from its counters alone, and the
secure-aggregation mask streams built on them
(``secagg.mask_stream``) against the JAX package's; ``split`` and the
float draws (``uniform``, ``normal``, ``gumbel``, ``categorical``) and
XLA's CPU ``log``, ``log1p`` and ``erf_inv`` beneath them, bit for bit
(special values included).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rayfed_tpu.privacy import secagg as jsecagg  # noqa: E402
from rayfed_tpu_torch.privacy import secagg, threefry  # noqa: E402

SEEDS = [0, 5, 2**32 - 1, 2**32 + 5, 2**40 + 5, 2**62 + 7]
SHAPES = [(), (0,), (1,), (7,), (3, 5), (2, 3, 129), (4097,)]


def _key_words(key):
    return tuple(int(x) for x in np.asarray(key))


def _chain(seed, n):
    """A fold_in chain of ``n`` data words from ``seed``, in both
    packages."""
    rng = np.random.default_rng(seed % (1 << 32) + n)
    data = [int(x) for x in rng.integers(0, 1 << 31, n)]
    jkey = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    for d in data:
        jkey = jax.random.fold_in(jkey, d)
        tkey = threefry.fold_in(tkey, d)
    return jkey, tkey


def test_partitionable_threefry_is_the_reference_setting():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_keeps_the_low_word(seed):
    assert threefry.prng_key(seed) == _key_words(jax.random.PRNGKey(seed))
    assert threefry.prng_key(seed) == (0, seed & 0xFFFFFFFF)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_chains(seed, n):
    jkey, tkey = _chain(seed, n)
    assert tkey == _key_words(jkey)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_uint32(seed, shape):
    jkey, tkey = _chain(seed, 2)
    want = np.asarray(jax.random.bits(jkey, shape, dtype=jnp.uint32))
    got = threefry.random_bits(tkey, shape)
    assert tuple(got.shape) == want.shape
    assert got.numpy().astype(np.uint32).tobytes() == want.tobytes()
    # The words are uint32 values held in int64.
    assert got.numel() == 0 or (int(got.min()) >= 0
                                and int(got.max()) <= 0xFFFFFFFF)


def test_hash_on_python_ints_matches_tensors():
    import torch

    x1 = torch.tensor([0, 1, 0xFFFFFFFF])
    x2 = torch.tensor([7, 0, 0x12345678])
    a, b = threefry.threefry2x32(11, 0xDEADBEEF, x1, x2)
    for i in range(3):
        assert threefry.threefry2x32(11, 0xDEADBEEF, int(x1[i]),
                                     int(x2[i])) == (int(a[i]), int(b[i]))


@pytest.mark.parametrize("start, stop", [(0, 10), (4093, 4097), (17, 2000)])
def test_a_range_from_its_counters_is_the_stream_slice(start, stop,
                                                      monkeypatch):
    key = threefry.fold_in(threefry.prng_key(9), 3)
    whole = threefry.random_bits(key, (4097,))
    monkeypatch.setattr(threefry, "CHUNK_WORDS", 64)
    part = threefry.words(key, start, stop)
    assert part.tolist() == whole[start:stop].tolist()


def test_counters_past_two_to_the_32_hash_the_high_word(monkeypatch):
    # The partitionable layout's high counter word: word 2**32 + i hashes
    # the pair (1, i), not (0, i) — and a range across the boundary
    # mixes both.
    key = threefry.prng_key(3)
    lo, hi = threefry.threefry2x32(key[0], key[1], 1, 5)
    assert int(threefry.words(key, 2**32 + 5, 2**32 + 6)[0]) == lo ^ hi
    monkeypatch.setattr(threefry, "CHUNK_WORDS", 3)
    span = threefry.words(key, 2**32 - 2, 2**32 + 2)
    want = [a ^ b for a, b in (threefry.threefry2x32(key[0], key[1], i >> 32,
                                                     i & 0xFFFFFFFF)
                               for i in range(2**32 - 2, 2**32 + 2))]
    assert span.tolist() == want


GRID = [(seed, domain, rnd, leaf)
        for seed in (1_0001, 2**62 + 7)
        for domain in ("fedagg", "async:default")
        for rnd in (0, 3, 2**31 + 1)
        for leaf in (0, 2)]


@pytest.mark.parametrize("seed, domain, rnd, leaf", GRID)
def test_mask_stream_equals_the_jax_package(seed, domain, rnd, leaf):
    want = jsecagg.mask_stream(seed, domain, rnd, leaf, (5, 7))
    got = secagg.mask_stream(seed, domain, rnd, leaf, (5, 7))
    assert want.dtype == np.uint32
    assert got.numpy().astype(np.uint32).tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# split and the float draws
# ---------------------------------------------------------------------------


def _f32_bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 5])
@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_split_equals_jax(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = threefry.split(threefry.prng_key(seed), num)
    assert [tuple(int(v) for v in row) for row in want] == got
    # A split key chains like any key.
    assert threefry.split(got[-1])[0] == _key_words(
        jax.random.split(want[-1])[0])


RANGES = [(0.0, 1.0), (-3.3, 7.1), (0.5, 0.75), (1.1754943508222875e-38, 1.0)]


@pytest.mark.parametrize("shape", [(), (7,), (37, 53), (4099,)])
@pytest.mark.parametrize("lo, hi", RANGES, ids=["unit", "wide", "narrow",
                                                "tiny"])
def test_uniform_equals_jax(shape, lo, hi):
    jkey, tkey = _chain(11, 2)
    want = jax.random.uniform(jkey, shape, minval=lo, maxval=hi)
    got = threefry.uniform(tkey, shape, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.parametrize("seed", [7, 2**40 + 5])
def test_normal_equals_jax(seed, monkeypatch):
    # 2**16 draws reach both erf_inv branches (|z| > 2.9 is w >= 5);
    # small chunks make the stream cross several of them.
    monkeypatch.setattr(threefry, "CHUNK_WORDS", 10007)
    jkey, tkey = _chain(seed, 1)
    want = jax.random.normal(jkey, (256, 256))
    got = threefry.normal(tkey, (256, 256))
    assert (np.abs(np.asarray(want)) > 2.9).sum() > 50
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.parametrize("shape", [(5,), (64, 129)])
def test_gumbel_equals_jax(shape):
    jkey, tkey = _chain(3, 3)
    np.testing.assert_array_equal(
        _f32_bits(threefry.gumbel(tkey, shape)),
        _f32_bits(jax.random.gumbel(jkey, shape)))


@pytest.mark.parametrize("shape", [(9,), (4, 1000), (2, 3, 50)])
def test_categorical_equals_jax(shape):
    rng = np.random.default_rng(sum(shape))
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    logits[..., 1] = -np.inf  # a masked category is never drawn
    for seed in range(4):
        jkey, tkey = _chain(seed, 1)
        want = np.asarray(jax.random.categorical(jkey, logits, axis=-1))
        got = threefry.categorical(tkey, torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got != 1).all()
    with pytest.raises(TypeError, match="float32"):
        threefry.categorical(tkey, torch.zeros(3, dtype=torch.float64))


_F32_MIN = np.finfo(np.float32).tiny


def _log_inputs():
    rng = np.random.default_rng(0)
    wide = np.exp(rng.uniform(-87, 88, 1 << 16)).astype(np.float32)
    unit = rng.uniform(0, 1, 1 << 16).astype(np.float32)
    edges = np.array([0.0, -0.0, 1e-40, -1e-40, _F32_MIN, 1.0, 0.5,
                      0.70710677, 0.7071068, 2.0, np.inf, 3.4e38],
                     np.float32)
    return np.concatenate([wide, unit, edges])


def test_xla_log_equals_jax_log():
    x = _log_inputs()
    want = np.asarray(jax.jit(jnp.log)(x))
    got = threefry.xla_log(torch.from_numpy(x))
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))
    # Outside the domain: NaN for a negative or NaN input.
    bad = np.array([-1.0, -3e-30, np.nan], np.float32)
    assert np.isnan(np.asarray(jax.jit(jnp.log)(bad))).all()
    assert torch.isnan(threefry.xla_log(torch.from_numpy(bad))).all()


def test_xla_log1p_equals_jax_log1p():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(-0.999, 3.0, 1 << 16),
        rng.uniform(-0.45, 0.45, 1 << 16),  # both sides of sqrt(2) - 1
        np.exp(rng.uniform(-80, 80, 1 << 14)),
        [0.0, -0.0, 1e-40, 0.41421354, 0.41421357, -0.41421357, -1.0,
         np.inf]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = threefry.xla_log1p(torch.from_numpy(x))
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


def test_xla_erf_inv_equals_jax_erf_inv():
    rng = np.random.default_rng(2)
    near_one = 1.0 - np.exp(rng.uniform(-16.5, -1, 1 << 15))
    x = np.concatenate([
        rng.uniform(-1, 1, 1 << 16), near_one, -near_one,
        [0.0, -0.0, 1.0, -1.0, 0.99999994, -0.99999994]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = threefry.xla_erf_inv(torch.from_numpy(x))
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


def test_as_key_takes_keys_and_seeds():
    assert threefry.as_key(5) == threefry.prng_key(5)
    assert threefry.as_key(jax.random.PRNGKey(2**40 + 5)) == (0, 5)
    assert threefry.as_key((1, 2)) == (1, 2)
