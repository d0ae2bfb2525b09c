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

"""Threefry-2x32 as ``jax.random`` computes it, in PyTorch.

The JAX package's mask streams (``rayfed_tpu/privacy/secagg.py``) are
``jax.random.bits`` words under JAX's default settings: the threefry
PRNG, ``jax_threefry_partitionable=True`` and ``jax_enable_x64=False``.
This module gives the same words, so a torch party's masks cancel a JAX
party's in one secure round:

- :func:`threefry2x32`: the 20-round hash (rotations 13/15/26/6 and
  17/29/16/24, key injection with ``0x1BD11BDA`` every four rounds);
- :func:`prng_key`: ``jax.random.PRNGKey``, which without x64 keeps only
  the seed's low 32 bits (the key is ``[0, seed & 0xFFFFFFFF]``);
- :func:`fold_in`: the hash of the counter pair ``(0, data)``;
- :func:`random_bits` / :func:`words`: the partitionable layout. Word
  ``i`` (row-major flat index) hashes the counter pair ``(i >> 32,
  i & 0xFFFFFFFF)`` and is the XOR of the two output words, so any range
  of a stream is computable from its counters alone;
- :func:`split`: key ``i`` is both output words of the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)``;
- :func:`uniform`, :func:`normal`, :func:`gumbel` and
  :func:`categorical`: float32 draws as XLA computes them on the CPU,
  bit for bit. ``normal`` is ``sqrt(2) * erf_inv(u)`` and ``gumbel``
  is ``-log(-log(u))``; XLA's CPU backend evaluates ``log``,
  ``log1p`` and ``erf_inv`` with its own polynomials (Cephes' ``logf``,
  a rational ``log1p`` near zero, Giles' two-branch ``erfinv``), with
  each Horner step contracted into a fused multiply-add and subnormal
  inputs read as zero. :func:`xla_log`, :func:`xla_log1p` and
  :func:`xla_erf_inv` are those polynomials, with the contractions
  rounded once (``aggregate._fma``), so a card draws the CPU's bits.

``torch.uint32`` has no add or shift, so the words are int64 tensors
holding values in ``[0, 2**32)``, masked after every add and shift. A
key is a pair of Python ints; the hash also runs on Python ints, which
is how keys are derived (no device work, no synchronization).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rayfed_tpu_torch.ops.aggregate import _fma

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: Words hashed per pass by :func:`words`: each of the pass's int64
#: temporaries is 32 MiB, whatever the stream's length.
CHUNK_WORDS = 1 << 22

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pairs ``(x1, x2)`` under the key
    ``(k1, k2)``: Python ints or int64 tensors (broadcasting) holding
    uint32 values; returns the two output words, of the same kind."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK32
    y = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK32
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        y = (y + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, y


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed is cut to its
    low 32 bits first (``PRNGKey(2**40 + 5)`` is ``PRNGKey(5)``)."""
    return 0, int(seed) & MASK32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashes the counter pair
    ``(0, uint32(data))``."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK32)


def words(key: Key, start: int, stop: int,
          device: Optional[torch.device] = None) -> torch.Tensor:
    """Words ``[start, stop)`` of ``key``'s stream in the partitionable
    layout, as a flat int64 tensor on ``device``, hashed
    :data:`CHUNK_WORDS` words at a time."""
    start, stop = int(start), int(stop)
    out = torch.empty(max(0, stop - start), dtype=torch.int64, device=device)
    for lo in range(start, stop, CHUNK_WORDS):
        hi = min(stop, lo + CHUNK_WORDS)
        out[lo - start:hi - start] = _chunk_words(key, lo, hi, device)
    return out


def _chunk_words(key: Key, start: int, stop: int, device) -> torch.Tensor:
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    if start >> 32 == (stop - 1) >> 32:
        high = start >> 32  # one value across the chunk: a Python int
    else:
        high = idx >> 32
    a, b = threefry2x32(key[0], key[1], high, idx & MASK32)
    return a ^ b


def random_bits(key: Key, shape: Sequence[int],
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, dtype=jnp.uint32)`` as an int64
    tensor of ``shape`` on ``device``."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    return words(key, 0, n, device).reshape(shape)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` under the partitionable layout: key
    ``i`` is both output words of the counter pair ``(i >> 32, i &
    0xFFFFFFFF)``."""
    return [threefry2x32(key[0], key[1], i >> 32, i & MASK32)
            for i in range(int(num))]


def as_key(rng) -> Key:
    """A key from a key (a pair of ints, or anything with two entries, as
    ``jax.random.PRNGKey`` returns) or an int seed (``prng_key(seed)``)."""
    if isinstance(rng, int):
        return prng_key(rng)
    k0, k1 = (int(v) for v in rng)
    return k0 & MASK32, k1 & MASK32


# ---------------------------------------------------------------------------
# Float draws, bit for bit XLA's CPU code
# ---------------------------------------------------------------------------

_F32 = torch.float32
#: The smallest normal float32: XLA's CPU code reads a smaller magnitude
#: (a subnormal) as zero.
FLT_MIN = 1.1754943508222875e-38
_SQRT2 = 1.4142135381698608  # float32(sqrt(2))

# Cephes' logf (XLA's CPU log, ``log_f32``).
_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1 = -0.00021219444170128554
_LOG_Q2 = 0.693359375

# XLA's log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x).
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_P = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)
_LOG1P_Q = (15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)

# Giles' single-precision erfinv, the w < 5 and w >= 5 coefficient sets.
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32, device=like.device)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` (Cephes ``logf``), bit for bit: the
    Horner steps fused as its code generator fuses them; a subnormal
    input is zero (-inf), a negative one or NaN gives NaN."""
    x = x.to(_F32)
    z = torch.clamp(x, min=FLT_MIN)
    bits = z.view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(_F32)
    below = m < _SQRTHF
    t = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.to(_F32)
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = _fma(t, _const(p[0], t), _const(p[1], t))
    y = _fma(y, t, _const(p[2], t))
    y1 = _fma(t, _const(p[3], t), _const(p[4], t))
    y1 = _fma(y1, t, _const(p[5], t))
    y = _fma(t3, y, y1)
    y2 = _fma(t, _const(p[6], t), _const(p[7], t))
    y2 = _fma(y2, t, _const(p[8], t))
    y = _fma(y, t3, y2)
    y = _fma(t3, y, e * _LOG_Q1)
    # x - x^2/2 (the product is exact) plus the tail, plus e*ln2's high
    # part (e * 0.693359375 is exact).
    r = y + (t - t2 * 0.5)
    r = r + e * _LOG_Q2
    r = torch.where(x.abs() < FLT_MIN, float("-inf"), r)
    r = torch.where(torch.isposinf(x), float("inf"), r)
    return torch.where((x < 0) & (x.abs() >= FLT_MIN) | torch.isnan(x),
                       float("nan"), r)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``, bit for bit: ``log(1 + x)`` for
    ``|x| >= sqrt(2) - 1``, else ``x - x^2/2 + x^3 P(x)/Q(x)``; a
    subnormal input is zero."""
    x = x.to(_F32)
    x = torch.where(x.abs() < FLT_MIN, x * 0.0, x)
    big = xla_log(x + 1.0)
    x2 = x * x
    q = x + _LOG1P_Q[0]
    for c in _LOG1P_Q[1:]:
        q = _fma(q, x, _const(c, x))
    p = torch.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = _fma(p, x, _const(c, x))
    small = x + ((x * x2) * (p / q) - x2 * 0.5)
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


def xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' two-branch polynomial on ``w =
    -log1p(-x*x)``), bit for bit its CPU code: each Horner step one
    fused multiply-add."""
    x = x.to(_F32)
    lw = xla_log1p(x * -x)
    w = -lw
    lo = w < 5.0
    # The square root rounded once (through f64), as the CPU's sqrtps
    # rounds it; torch's float32 sqrt on the CPU is not always.
    t = torch.where(lo, w - 2.5, torch.sqrt(w.double()).to(_F32) - 3.0)
    p = torch.where(lo, _const(_ERFINV_LO[0], x), _const(_ERFINV_HI[0], x))
    for clo, chi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma(p, t, torch.where(lo, _const(clo, x), _const(chi, x)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Float32 in ``[0, 1)`` from uint32 words: the top 23 bits as the
    mantissa of a number in ``[1, 2)``, minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``:
    ``floats * (maxval - minval) + minval`` (one fused multiply-add, as
    XLA compiles it), then clamped below at ``minval``."""
    f = _unit_floats(random_bits(key, shape, device))
    lo = torch.tensor(minval, dtype=_F32, device=f.device)
    span = torch.tensor(maxval, dtype=_F32, device=f.device) - lo
    return torch.maximum(lo, _fma(f, span, lo))


def normal_range(key: Key, start: int, stop: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Draws ``[start, stop)`` (row-major flat indices) of
    ``jax.random.normal(key, shape, jnp.float32)`` for any shape holding
    them: ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
    ``[nextafter(-1, 0), 1)``, bit for bit, :data:`CHUNK_WORDS` words at
    a time."""
    start, stop = int(start), int(stop)
    out = torch.empty(max(0, stop - start), dtype=_F32, device=device)
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=_F32),
                               torch.tensor(0.0, dtype=_F32)))
    for a in range(start, stop, CHUNK_WORDS):
        b = min(stop, a + CHUNK_WORDS)
        # uniform on [lo, 1): floats * 2 + lo (the product is exact).
        u = torch.clamp(_unit_floats(words(key, a, b, device)) * 2.0 + lo,
                        min=lo)
        out[a - start:b - start] = xla_erf_inv(u) * _SQRT2
    return out


def normal(key: Key, shape: Sequence[int],
           device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.float32)``, bit for bit."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    return normal_range(key, 0, n, device).reshape(shape)


def gumbel(key: Key, shape: Sequence[int],
           device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, jnp.float32)`` (the default "low"
    mode): ``-log(-log(u))`` for ``u`` uniform on ``[tiny, 1)``."""
    u = uniform(key, shape, FLT_MIN, 1.0, device)
    return -xla_log(-xla_log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    logits: the Gumbel-max draw ``argmax(gumbel + logits)`` (the first
    index on a tie, as ``jnp.argmax``)."""
    if logits.dtype != _F32:
        raise TypeError(
            f"categorical draws float32 logits (jax.random's gumbel bits "
            f"for other dtypes differ), got {logits.dtype}")
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=-1)
