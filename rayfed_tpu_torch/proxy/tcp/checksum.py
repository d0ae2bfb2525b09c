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

"""FTP1 frame-integrity checksums (optional, ``frame_crc`` config key).

The checksum rides the DATA header as two fields — ``"crc"`` (u32
value) and ``"crca"`` (algorithm id) — never a WIRE_VERSION bump, so
CRC-enabled and CRC-less parties interoperate: a receiver that sees no
``crc`` key verifies nothing, a receiver that can't compute the named
algorithm skips verification (logged once) rather than failing frames
it can't check.

Algorithms:

- ``"c"`` — CRC-32C (Castagnoli), the native fastwire fast path
  (table-driven C loop, GIL released). Preferred when the extension is
  loaded.
- ``"z"`` — ``zlib.crc32``, the always-available Python fallback
  (zlib's C loop, also fast — "Python fallback" means "no extension
  required", not "slow").

Both use the zlib streaming convention (pass the previous value to
accumulate), so multi-buffer payloads — sender buffer lists, receiver
:class:`~rayfed_tpu_torch.proxy.tcp.sockio.SegmentedPayload` scatter reads —
checksum without a coalescing copy.

The CRC covers exactly the payload bytes as they appear on the wire:
post-serialization, post-compression, the same bytes ``plen`` counts.
"""

from __future__ import annotations

import logging
import zlib
from typing import Iterable, Optional, Tuple

from rayfed_tpu_torch._private import native_wire

# The native crc32c (None without a C++ compiler: the table fallback).
_fw = native_wire.load()

logger = logging.getLogger(__name__)

ALG_CRC32C = "c"
ALG_ZLIB = "z"

_warned_algs = set()  # fedlint: disable=global-mutable-singleton (log-once latch for unknown crc algs; test-only growth, bounded by alg-id space)


def _native_crc32c():
    if _fw is not None and hasattr(_fw, "crc32c"):
        return _fw.crc32c
    return None


def preferred_alg() -> str:
    return ALG_CRC32C if _native_crc32c() is not None else ALG_ZLIB


def _as_views(buffers) -> Iterable[memoryview]:
    for b in buffers:
        view = memoryview(b)
        if view.format != "B" or view.ndim != 1:
            view = view.cast("B")
        if view.nbytes:
            yield view


def compute(buffers, alg: Optional[str] = None) -> Tuple[int, str]:
    """Checksum of the concatenation of ``buffers`` → (value, alg id).

    ``alg=None`` picks :func:`preferred_alg`. Raises ``ValueError`` for
    an unknown algorithm — senders always name one they can compute.
    """
    if alg is None:
        alg = preferred_alg()
    if alg == ALG_CRC32C:
        fn = _native_crc32c()
        if fn is not None:
            crc = 0
            for view in _as_views(buffers):
                crc = fn(view, crc)
            return crc & 0xFFFFFFFF, ALG_CRC32C
        # Extension vanished between preferred_alg() and now (or caller
        # pinned "c" without it): fall through to zlib, honestly labeled.
        alg = ALG_ZLIB
    if alg == ALG_ZLIB:
        crc = 0
        for view in _as_views(buffers):
            crc = zlib.crc32(view, crc)
        return crc & 0xFFFFFFFF, ALG_ZLIB
    raise ValueError(f"unknown crc algorithm id {alg!r}")


def payload_buffers(payload) -> Iterable:
    """Normalize a received payload — bytes-like or a SegmentedPayload
    (anything whose ``.segments()`` gives (pos, buf) pairs, already in
    order) — into an iterable of buffers for :func:`compute`. (The JAX
    package iterates the bound method itself, so a segmented frame, any
    frame of 1 MiB or more, fails its crc check with a TypeError.)"""
    segments = getattr(payload, "segments", None)
    if segments is not None:
        return [buf for _pos, buf in segments()]
    return [payload]


def verify(header, payload) -> Optional[bool]:
    """Check a received frame against its header CRC.

    Returns True (match), False (MISMATCH — NACK this frame with
    CODE_DATA_CORRUPT), or None when unverifiable: no ``crc`` in the
    header, or an algorithm this process can't compute (skip, log
    once — never fail a frame we can't check).
    """
    want = header.get("crc")
    if want is None:
        return None
    alg = header.get("crca", ALG_ZLIB)
    if alg == ALG_CRC32C and _native_crc32c() is None:
        if alg not in _warned_algs:
            _warned_algs.add(alg)
            logger.warning(
                "peer sends crc32c frames but the fastwire extension is "
                "not loaded here; frame integrity is NOT being verified"
            )
        return None
    if alg not in (ALG_CRC32C, ALG_ZLIB):
        if alg not in _warned_algs:
            _warned_algs.add(alg)
            logger.warning("unknown crc algorithm id %r; skipping checks", alg)
        return None
    got, _ = compute(payload_buffers(payload), alg)
    return got == int(want)
