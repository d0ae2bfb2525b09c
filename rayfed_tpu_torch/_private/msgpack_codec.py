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

"""The port's own msgpack codec: the two calls the wire makes.

``packb(obj, use_bin_type=True[, strict_types=True])`` and
``unpackb(b, raw=False[, strict_map_key=False])``, in pure Python and
byte-identical to msgpack 1.x for the types the wire carries: None, bool,
int, float, str, bytes (and bytearray / memoryview), list, tuple and dict.
Encoding always picks the smallest form (fixint, the smallest int width,
fixstr/str8/16/32, bin8/16/32, fixarray/array16/32, fixmap/map16/32) and
floats are always float64, as msgpack does by default. The decoder also
reads float32, which msgpack never writes with these settings.

The port carries no try-import of ``msgpack``: one code path runs on every
machine, and the frame bytes are those of the JAX package, so parties of
the two packages read each other's headers and tree metas.
"""

from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb", "ExtraData"]

_RECURSE_LIMIT = 511  # msgpack's DEFAULT_RECURSE_LIMIT

_pack_d = struct.Struct(">Bd").pack
_unpack_from = struct.unpack_from


class ExtraData(ValueError):
    """Bytes remain after the one object ``unpackb`` decoded (msgpack's
    ``ExtraData``)."""

    def __init__(self, unpacked, extra):
        self.unpacked = unpacked
        self.extra = extra

    def __str__(self):
        return "unpack(b) received extra data."


def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(n)
        elif n <= 0xFF:
            out += struct.pack(">BB", 0xCC, n)
        elif n <= 0xFFFF:
            out += struct.pack(">BH", 0xCD, n)
        elif n <= 0xFFFFFFFF:
            out += struct.pack(">BI", 0xCE, n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += struct.pack(">BQ", 0xCF, n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -0x20:
        out.append(n & 0xFF)
    elif n >= -0x80:
        out += struct.pack(">Bb", 0xD0, n)
    elif n >= -0x8000:
        out += struct.pack(">Bh", 0xD1, n)
    elif n >= -0x80000000:
        out += struct.pack(">Bi", 0xD2, n)
    elif n >= -0x8000000000000000:
        out += struct.pack(">Bq", 0xD3, n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, tags, out: bytearray,
              what: str) -> None:
    """A str/bin/array/map length prefix: the fix form when ``fix`` is
    given and ``n < fix_max``, else the smallest of the 8/16/32-bit forms
    in ``tags`` (None where the family has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif tags[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", tags[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", tags[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", tags[2], n)
    else:
        raise ValueError(f"{what} is too large")


_STR_TAGS = (0xD9, 0xDA, 0xDB)
_BIN_TAGS = (0xC4, 0xC5, 0xC6)
_ARRAY_TAGS = (None, 0xDC, 0xDD)
_MAP_TAGS = (None, 0xDE, 0xDF)


def _pack(obj: Any, out: bytearray, strict: bool, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif t is int if strict else isinstance(obj, int):
        _pack_int(int(obj), out)
    elif t is float if strict else isinstance(obj, float):
        out += _pack_d(0xCB, obj)
    elif (t in (bytes, bytearray) if strict
          else isinstance(obj, (bytes, bytearray))):
        _pack_len(len(obj), None, 0, _BIN_TAGS, out, "bytes")
        out += obj
    elif t is str if strict else isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, _STR_TAGS, out, "String")
        out += data
    elif t is dict if strict else isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP_TAGS, out, "Dict")
        for k, v in obj.items():
            _pack(k, out, strict, depth - 1)
            _pack(v, out, strict, depth - 1)
    elif t is list if strict else isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARRAY_TAGS, out, "list")
        for v in obj:
            _pack(v, out, strict, depth - 1)
    elif isinstance(obj, memoryview):
        data = obj.cast("B") if obj.ndim != 1 or obj.format != "B" else obj
        _pack_len(data.nbytes, None, 0, _BIN_TAGS, out, "memoryview")
        out += data
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any, use_bin_type: bool = True,
          strict_types: bool = False) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True, strict_types=...)``.

    With ``strict_types`` only the exact builtin types pack (a tuple or a
    subclass raises ``TypeError``), as in msgpack."""
    if not use_bin_type:
        raise ValueError("the wire always packs with use_bin_type=True")
    out = bytearray()
    _pack(obj, out, strict_types, _RECURSE_LIMIT)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos", "strict_map_key")

    def __init__(self, buf: memoryview, strict_map_key: bool):
        self.buf = buf
        self.pos = 0
        self.strict_map_key = strict_map_key

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def fmt(self, f: str, n: int):
        if self.pos + n > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        v = _unpack_from(f, self.buf, self.pos)[0]
        self.pos += n
        return v


# (format, width) of each fixed-width int/float tag.
_SCALAR = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# tag -> (kind, length format, width)
_SIZED = {
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _unpack(r: _Reader, depth: int) -> Any:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    tag = r.fmt(">B", 1)
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag == 0xC0:
        return None
    elif tag == 0xC2:
        return False
    elif tag == 0xC3:
        return True
    elif tag in _SCALAR:
        return r.fmt(*_SCALAR[tag])
    elif tag in _SIZED:
        kind, f, w = _SIZED[tag]
        n = r.fmt(f, w)
    else:
        raise ValueError(f"msgpack type 0x{tag:02x} is not used by the wire")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r, depth - 1) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r, depth - 1)
        if r.strict_map_key and type(k) not in (str, bytes):
            raise ValueError(
                f"{type(k).__name__} is not allowed for map key when "
                "strict_map_key=True"
            )
        if isinstance(k, list):
            raise ValueError("list is not allowed for map key")
        out[k] = _unpack(r, depth - 1)
    return out


def unpackb(packed, raw: bool = False, strict_map_key: bool = True) -> Any:
    """``msgpack.unpackb(packed, raw=False, strict_map_key=...)``: str as
    str, bin as bytes, arrays as lists. Trailing bytes raise
    :class:`ExtraData` and a short buffer ``ValueError``, as in msgpack."""
    if raw:
        raise ValueError("the wire always unpacks with raw=False")
    r = _Reader(memoryview(packed).cast("B"), strict_map_key)
    obj = _unpack(r, _RECURSE_LIMIT)
    if r.pos != len(r.buf):
        raise ExtraData(obj, bytes(r.buf[r.pos:]))
    return obj
