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
  of a stream is computable from its counters alone.

``torch.uint32`` has no add or shift, so the words are int64 tensors
holding values in ``[0, 2**32)``, masked after every add and shift. A
key is a pair of Python ints; the hash also runs on Python ints, which
is how keys are derived (no device work, no synchronization).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

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
