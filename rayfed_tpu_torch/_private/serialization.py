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

"""Payload serialization: array fast path + whitelisted unpickling.

Two lanes (SURVEY.md C15 + §7 "mixed payloads"):

1. ``tree`` — the fast path. A pytree whose containers are
   msgpack-encodable and whose leaves are tensors / arrays / simple
   scalars is encoded as a msgpack skeleton plus the raw array bytes
   concatenated — **zero pickle on either end**. The frame bytes are the
   JAX package's: the same meta, the same dtype names (``"bfloat16"``
   included) and the same ``odt`` restore meta, so parties of the two
   packages exchange trees. ``torch.Tensor`` leaves are staged to host
   (CUDA tensors copied off the card, bf16 carried as its 16-bit integer
   view); decoded array leaves come back as CPU tensors of the wire
   dtype.
2. ``pickle`` — fallback for arbitrary Python objects (stdlib ``pickle``,
   so values only ``cloudpickle`` can serialise — lambdas, local classes —
   are refused), guarded on the receiver by a module/class whitelist
   unpickler, mirroring ``fed/_private/serialization_utils.py:24-83``.
   The error envelopes cross under the JAX package's class names
   (``rayfed_tpu.exceptions.FedRemoteError``), written here without
   importing that package and mapped back to this package's classes on
   load, so an envelope raised by either package re-raises in the other.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import exceptions as _exceptions
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch._private import msgpack_codec as msgpack

# The module the envelope classes are named under on the wire: the JAX
# package's, which is what its whitelist admits and what it re-raises.
_WIRE_EXCEPTIONS_MODULE = "rayfed_tpu.exceptions"
_ENVELOPES = (_exceptions.FedRemoteError, _exceptions.FedLocalError)

# Modules that are always unpicklable even under a whitelist: our own error
# envelope must be able to cross (the peer re-raises it), and the exception
# *types* it may wrap. Note: unlike a blanket ``builtins`` pass-through,
# builtins are only admitted when the resolved object is an exception class —
# ``builtins.eval``/``getattr`` stay forbidden.
_ALWAYS_ALLOWED = {
    _WIRE_EXCEPTIONS_MODULE: {"FedRemoteError", "FedLocalError"},
}


class _EnvelopePickler(pickle._Pickler):
    """The pure-Python pickler with one change: this package's envelope
    classes are written under their wire names. ``pickle``'s own global
    lookup would import ``rayfed_tpu`` to check the name, and that module
    is not (and must not be) loaded here."""

    def save_global(self, obj, name=None):
        if obj in _ENVELOPES:
            self.save(_WIRE_EXCEPTIONS_MODULE)
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dumps(obj: Any) -> bytes:
    if isinstance(obj, _ENVELOPES):
        buf = io.BytesIO()
        _EnvelopePickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(obj)
        return buf.getvalue()
    return pickle.dumps(obj)


class _PortUnpickler(pickle.Unpickler):
    """Loads the envelope's wire names as this package's classes."""

    def find_class(self, module: str, name: str):
        if module == _WIRE_EXCEPTIONS_MODULE:
            cls = getattr(_exceptions, name, None)
            if isinstance(cls, type) and issubclass(cls, BaseException):
                return cls
        return super().find_class(module, name)


class _WhitelistUnpickler(_PortUnpickler):
    def __init__(self, file, allowed: Dict[str, set]):
        super().__init__(file)
        self._allowed = allowed

    def find_class(self, module: str, name: str):
        for table in (self._allowed, _ALWAYS_ALLOWED):
            names = table.get(module)
            if names is not None and ("*" in names or name in names):
                return super().find_class(module, name)
        if module == "builtins":
            obj = getattr(__import__("builtins"), name, None)
            if isinstance(obj, type) and issubclass(obj, BaseException):
                return obj
        raise pickle.UnpicklingError(
            f"global '{module}.{name}' is forbidden by the serialization "
            "whitelist (serializing_allowed_list)."
        )


def restricted_loads(
    data: bytes, allowed_list: Optional[Dict[str, List[str]]]
) -> Any:
    """Unpickle; if a whitelist is configured, only whitelisted globals load.

    Accepts the reference's config forms (``serialization_utils.py:66-83``):
    a top-level ``"*"`` key disables the whitelist entirely, and a ``None``
    (or ``["*"]``) value allows every name in that module.
    """
    if allowed_list is None or "*" in allowed_list:
        return _PortUnpickler(io.BytesIO(data)).load()
    allowed = {
        m: {"*"} if ns is None else set(ns) for m, ns in allowed_list.items()
    }
    return _WhitelistUnpickler(io.BytesIO(data), allowed).load()


# ---------------------------------------------------------------------------
# Array-tree fast path
# ---------------------------------------------------------------------------

_MSGPACK_SCALARS = (bool, int, float, str, bytes, type(None))


class SegmentedPayload:
    """A frame payload received as several buffers instead of one.

    The receiver scatter-reads large ``tree`` payloads into leaf/shard-
    aligned buffers (sized from the frame's meta) so no host buffer of the
    whole payload — for a sharded array, of the global array — is ever
    allocated. Consumers address it by the same absolute ``(offset, n)``
    ranges the tree meta records.
    """

    def __init__(self, segments):
        # segments: list of (absolute_offset, buffer), ascending, contiguous.
        self._segments = [(off, memoryview(buf)) for off, buf in segments]
        self._starts = [off for off, _ in self._segments]
        self.nbytes = sum(v.nbytes for _, v in self._segments)

    def range(self, off: int, n: int) -> memoryview:
        import bisect

        i = bisect.bisect_right(self._starts, off) - 1
        if i >= 0:
            seg_off, view = self._segments[i]
            if off + n <= seg_off + view.nbytes:
                return view[off - seg_off: off - seg_off + n]
        raise ValueError(
            f"range ({off}, {n}) does not fall inside one received segment"
        )

    def tobytes(self) -> bytes:
        return b"".join(bytes(v) for _, v in self._segments)

    def segments(self):
        """The (absolute_offset, view) pairs — for re-basing a stripe's
        local segments into the reassembled payload's address space."""
        return list(self._segments)


def payload_nbytes(payload) -> int:
    if payload is None:
        return 0
    if isinstance(payload, SegmentedPayload):
        return payload.nbytes
    return memoryview(payload).nbytes


def payload_range(payload, off: int, n: int) -> memoryview:
    if isinstance(payload, SegmentedPayload):
        return payload.range(off, n)
    return memoryview(payload)[off: off + n]


def payload_bytes(payload) -> bytes:
    if isinstance(payload, SegmentedPayload):
        return payload.tobytes()
    return bytes(payload)


# Extents below this are coalesced with their neighbors: scatter-reading
# only pays off at shard scale, and thousands of tiny-leaf recv calls
# would regress small-tree throughput.
_MIN_SEGMENT = 256 * 1024


def tree_segment_lengths(meta_bytes: bytes, plen: int):
    """Buffer-aligned segment lengths for scatter-reading a ``tree``
    payload, or None when the meta doesn't contiguously cover it.

    Consecutive extents smaller than ``_MIN_SEGMENT`` are merged (a
    leaf's range always stays inside one segment — merging only widens
    segments), so a many-tiny-leaf tree still reads in big chunks while
    shard-scale extents get their own buffers.
    """
    try:
        meta = msgpack.unpackb(meta_bytes, raw=False)
        extents = []
        for d in meta["leaves"]:
            if d["t"] == "arr":
                extents.append((d["off"], d["n"]))
            elif d["t"] == "sharr":
                extents.extend((s["off"], s["n"]) for s in d["shards"])
        extents.sort()
        lengths = []
        pos = 0
        for off, n in extents:
            if n < 0 or off != pos:
                return None
            if n:
                if (
                    lengths
                    and lengths[-1] < _MIN_SEGMENT
                    and n < _MIN_SEGMENT
                ):
                    lengths[-1] += n
                else:
                    lengths.append(n)
                pos += n
        if pos != plen:
            return None
        return lengths
    except Exception:  # noqa: BLE001 - malformed meta -> single-buffer read
        return None


def _coalesce_sizes(sizes):
    """Apply the ``_MIN_SEGMENT`` coalescing rule to a list of extent
    sizes (shared between :func:`tree_segment_lengths` and the per-stripe
    segment plans — extents always stay inside one segment)."""
    lengths = []
    for n in sizes:
        if not n:
            continue
        if lengths and lengths[-1] < _MIN_SEGMENT and n < _MIN_SEGMENT:
            lengths[-1] += n
        else:
            lengths.append(n)
    return lengths


# ---------------------------------------------------------------------------
# Shard striping (multi-stream data plane): a large multi-buffer ``tree``
# payload is split at buffer boundaries into K contiguous byte-balanced
# stripes, each shipped as its own frame (``pkind: "stripe"``) over its
# own wire lane; the receiver reassembles them into one SegmentedPayload
# whose segments stay leaf/shard-aligned. Stripe frames carry a stripe
# descriptor ``sd``: {"i": stripe index, "n": stripe count, "off":
# absolute byte offset, "tot": total payload bytes, "segs": this
# stripe's scatter-read segment lengths}; stripe 0 additionally carries
# the original pkind/pmeta (``pk``/``pm`` live in the outer header as
# pkind/pmeta of the reassembled offer).
# ---------------------------------------------------------------------------

# A payload below this never stripes: lane-parallelism only pays at
# frame-pipelining scale, and the receive path's segment machinery wants
# shard-scale buffers.
STRIPE_MIN_BYTES = 1 << 20


def plan_stripes(buffers, k: int):
    """Partition ordered payload buffers into up to ``k`` contiguous,
    byte-balanced stripes, split only at buffer boundaries (so every
    leaf/shard extent stays inside one stripe and, within it, one
    scatter segment). Returns [(soff, bufs, nbytes, segs), ...] or None
    when striping is pointless (fewer than 2 non-empty buffers, or
    k <= 1)."""
    entries = []
    off = 0
    for b in buffers:
        n = buffer_nbytes(b)
        if n:
            entries.append((off, b, n))
        off += n
    total = off
    k = min(k, len(entries))
    if k <= 1 or total < STRIPE_MIN_BYTES:
        return None
    stripes = []
    i = 0
    done = 0
    for si in range(k):
        left = k - si
        target = (total - done + left - 1) // left
        soff = entries[i][0]
        bufs = []
        nbytes = 0
        while i < len(entries):
            # Leave at least one buffer for every remaining stripe.
            if bufs and (len(entries) - i) <= (left - 1):
                break
            if bufs and nbytes >= target:
                break
            bufs.append(entries[i][1])
            nbytes += entries[i][2]
            i += 1
        stripes.append((
            soff, bufs, nbytes,
            _coalesce_sizes([buffer_nbytes(b) for b in bufs]),
        ))
        done += nbytes
    return stripes


def stripe_segment_lengths(sd, plen: int):
    """Validated scatter-read segment lengths from a stripe frame's
    descriptor, or None for a single contiguous read. Shared by the
    Python and native receive paths, like :func:`tree_segment_lengths`."""
    try:
        segs = sd.get("segs")
        if not isinstance(segs, list) or len(segs) < 2:
            return None
        total = 0
        for n in segs:
            if not isinstance(n, int) or n <= 0:
                return None
            total += n
        if total != plen:
            return None
        return segs
    except Exception:  # noqa: BLE001 - malformed descriptor -> single read
        return None


def _array_buffer(arr: np.ndarray):
    """A bytes-like for the raw contents of a C-contiguous array. Zero-copy
    (memoryview) when the buffer protocol supports the dtype; ml_dtypes
    dtypes (bfloat16, float8) are reinterpreted as a same-width integer
    view (the buffer protocol rejects them directly, and ``tobytes`` would
    copy); only 0-d/empty arrays fall back to a copy."""
    if arr.nbytes == 0:
        return b""
    try:
        return memoryview(arr).cast("B")
    except (ValueError, TypeError):
        pass
    if arr.ndim and arr.dtype.itemsize in (1, 2, 4):
        view = arr.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[
            arr.dtype.itemsize
        ])
        return memoryview(view).cast("B")
    return arr.tobytes()


def buffer_nbytes(buf) -> int:
    return memoryview(buf).nbytes


def concat_buffers(buffers) -> bytes:
    return b"".join(bytes(memoryview(b)) if not isinstance(b, bytes) else b
                    for b in buffers)


# The wire dtype name numpy has no element type for (the JAX package
# writes it through ml_dtypes): carried here as the same-width integer.
# name -> (numpy carrier, torch dtype). Torch bf16 rides as int16, not
# uint16: torch's uint16 support is partial. Any other name numpy cannot
# parse (float8, int4, ...) raises TypeError.
_CARRIED = {"bfloat16": (np.int16, torch.bfloat16)}
_CARRIED_NAMES = {tdt: name for name, (_, tdt) in _CARRIED.items()}


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's bytes (its integer
    carrier for the names in ``_CARRIED``)."""
    carried = _CARRIED.get(name)
    if carried is not None:
        return np.dtype(carried[0])
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(
            f"wire dtype {name!r} has no torch counterpart in "
            f"rayfed_tpu_torch (supported beyond numpy's: "
            f"{sorted(_CARRIED)})"
        ) from None


def _torch_dtype(name: str) -> torch.dtype:
    carried = _CARRIED.get(name)
    if carried is not None:
        return carried[1]
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"wire dtype {name!r} has no torch counterpart")
    return dt


def _as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A CPU tensor of wire dtype ``name`` over a received numpy array
    (zero-copy; a read-only buffer is copied first, since torch tensors
    are writable)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    carried = _CARRIED.get(name)
    return t.view(carried[1]) if carried is not None else t


def shm_buf_type():
    """The native wire's ``ShmBuf`` type (a view of one adopted shm-ring
    chunk), or None while the native module is not loaded."""
    import sys

    fw = sys.modules.get("rayfed_tpu_torch._fastwire")
    return getattr(fw, "ShmBuf", None)


_SHM_ATTR = "_fed_shm_chunk"


def shm_chunk(t: torch.Tensor):
    """The ``ShmBuf`` a decoded tensor views zero-copy, or None. The
    serving plane's publish adopts such leaves instead of copying them
    (``serving/publish.py``); a tensor made from one (a copy, a cast, a
    move to the card) carries no tag."""
    return getattr(t, _SHM_ATTR, None)


def _shm_owner(payload):
    """The ``ShmBuf`` a received payload is a view of, or None."""
    shm_buf = shm_buf_type()
    if shm_buf is None:
        return None
    if isinstance(payload, shm_buf):
        return payload
    obj = getattr(payload, "obj", None)
    return obj if isinstance(obj, shm_buf) else None


def _tensor_to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Stage one tensor leaf for the wire: (C-contiguous host array, wire
    dtype name). A CUDA tensor is copied to host; dtypes numpy lacks are
    viewed as their integer carrier."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    name = _CARRIED_NAMES.get(t.dtype)
    if name is None:
        arr = t.numpy()
        return arr, arr.dtype.name
    return t.view(torch.int16).numpy(), name


class ShardedLeaf:
    """A leaf that crosses the wire as the JAX package's ``sharr``
    descriptor: a DTensor sharded over a multi-process party's ranks,
    with every distinct shard in hand (``proxy/barriers.py`` gathers the
    followers' shards to the leader). ``mesh_axes`` / ``mesh_shape`` are
    the DeviceMesh's dims, ``spec`` one entry a tensor dim (None, a mesh
    dim name or a list of them, as the JAX package's ``PartitionSpec``),
    ``shards`` ``[(region, tensor)]`` with ``region`` ``[[start, stop],
    ...]`` a dim, one a distinct shard."""

    def __init__(self, dtype: torch.dtype, shape, mesh_axes, mesh_shape,
                 spec, shards) -> None:
        self.dtype = dtype
        self.shape = [int(d) for d in shape]
        self.mesh_axes = [str(a) for a in mesh_axes]
        self.mesh_shape = [int(d) for d in mesh_shape]
        self.spec = list(spec)
        self.shards = sorted(shards, key=lambda e: tuple(
            a for ab in e[0] for a in ab))

    def encode(self, offset: int):
        """(desc, buffers, nbytes) of the ``sharr`` leaf at ``offset``,
        shards in the JAX package's order (by region)."""
        descs, buffers, total, name = [], [], 0, None
        for region, t in self.shards:
            arr, name = _tensor_to_host(t)
            buffers.append(_array_buffer(arr))
            descs.append({"i": [list(r) for r in region],
                          "off": offset + total, "n": arr.nbytes})
            total += arr.nbytes
        desc = {"t": "sharr",
                "dtype": name or _CARRIED_NAMES.get(self.dtype)
                or str(self.dtype).replace("torch.", ""),
                "shape": self.shape,
                "mesh": {"axes": self.mesh_axes, "shape": self.mesh_shape},
                "spec": self.spec, "shards": descs}
        return desc, buffers, total


def _downcast(arr: np.ndarray, wire_dtype: str) -> np.ndarray:
    """The lossy wire cast of a native-order f32/f64 host array, rounded
    bit for bit as the JAX package rounds it: numpy's cast to float16;
    to bfloat16 through float32 with round-to-nearest-even and a NaN
    becoming the quiet NaN of its sign, as ml_dtypes does (torch's own
    cast writes NaN otherwise)."""
    if wire_dtype == "float16":
        return arr.astype(np.float16)
    f = arr.astype(np.float32)
    bits = f.view(np.uint32)
    out = ((bits + (0x7FFF + ((bits >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(f)
    if nan.any():
        out[nan] = np.where(np.signbit(f[nan]), 0xFFC0, 0x7FC0)
    return out


def _quantized(leaf) -> bool:
    """Whether the int8 tier quantizes ``leaf`` (a tensor or a host
    array): a float wider than two bytes (bf16 and f16 leaves ship as
    they are)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() and leaf.element_size() > 2
    return leaf.dtype.kind == "f" and leaf.dtype.itemsize > 2


def _quantize_to_host(t: torch.Tensor):
    """``(int8 host array, producer dtype name, scale)`` of an int8-tier
    leaf, quantized on its device; the f64 temporaries are freed before
    the next leaf. Bumps the privacy plane's savings counter."""
    from rayfed_tpu_torch.privacy.manager import record_quantized_bytes_saved
    from rayfed_tpu_torch.privacy.quantize import quantize_leaf

    q, scale = quantize_leaf(t)
    arr = _tensor_to_host(q)[0]
    saved = t.numel() * t.element_size() - arr.nbytes
    if saved > 0:
        record_quantized_bytes_saved(saved)
    return arr, str(t.dtype).rpartition(".")[2], scale


def _is_array_leaf(x: Any) -> bool:
    # torch.Tensor explicitly; numpy (and anything else exposing
    # ``__array__``) by duck type, without importing it.
    return isinstance(x, torch.Tensor) or (
        hasattr(x, "shape") and hasattr(x, "dtype") and hasattr(x, "__array__")
    )


def _spec_to_wire(spec: tree_util.TreeSpec) -> Optional[dict]:
    if spec.kind == "namedtuple":
        return None  # type object not wire-encodable -> caller falls back
    meta = spec.meta
    if spec.kind in ("dict", "odict"):
        if not all(isinstance(k, (str, int)) for k in meta):
            return None
        meta = list(meta)
    children = []
    for c in spec.children:
        w = _spec_to_wire(c)
        if w is None:
            return None
        children.append(w)
    return {"k": spec.kind, "m": meta, "c": children}


def _spec_from_wire(w: dict) -> tree_util.TreeSpec:
    return tree_util.TreeSpec(
        w["k"], w["m"], tuple(_spec_from_wire(c) for c in w["c"])
    )


# Lossy wire precision (config ``payload_wire_dtype``): accepted knob
# values -> canonical dtype names. bf16 keeps float32's exponent range
# (safe for gradients); fp16 halves mantissa error but overflows past
# 65504 — callers pick their poison explicitly. int8 is the privacy
# plane's quantized tier (4x fewer bulk bytes than fp32): symmetric
# per-leaf uniform quantization, the scale rides the leaf descriptor
# (``qs``) — gated at fed.init on config["privacy"]["quantize"]="int8"
# (privacy/config.validate_wire_dtype_gate).
WIRE_DTYPES = {
    "bf16": "bfloat16",
    "bfloat16": "bfloat16",
    "fp16": "float16",
    "float16": "float16",
    "int8": "int8",
}


def wire_dtype_name(knob: Optional[str]) -> Optional[str]:
    """Canonical dtype name for the ``payload_wire_dtype`` knob (None
    passes through); unknown values raise at send time, like the
    compression knobs."""
    if knob is None:
        return None
    try:
        return WIRE_DTYPES[str(knob).lower()]
    except KeyError:
        raise ValueError(
            f"unknown payload_wire_dtype {knob!r}; supported: "
            f"{sorted(set(WIRE_DTYPES))}"
        ) from None


def try_encode_tree(
    data: Any, wire_dtype: Optional[str] = None
) -> Optional[Tuple[bytes, List[Any]]]:
    """Attempt the zero-pickle encoding.

    Returns (meta_bytes, buffers) or None if the payload needs pickling.
    ``meta_bytes`` is the msgpack-packed meta dict; ``buffers`` is a list of
    byte-like objects to be written after the header (no concatenation of
    large arrays).

    A ``torch.Tensor`` leaf is detached, copied to host when it lives on
    a card, made contiguous and read through ``.numpy()``; bf16 is sent as
    its int16 view under the name ``"bfloat16"``. ``wire_dtype``
    (canonical name from :func:`wire_dtype_name`) downcasts f32/f64 leaves
    on the wire — LOSSY, opt-in; each leaf's original dtype rides the meta
    (``odt``) and is restored on decode. Under ``"int8"`` a leaf is
    quantized on its own device (a card's before its device-to-host copy,
    so a quarter of the bytes cross PCIe) and its scale rides the meta
    (``qs``).
    """
    leaves, spec = tree_util.tree_flatten(data)
    wire_spec = _spec_to_wire(spec)
    if wire_spec is None:
        return None
    descs = []
    buffers: List[Any] = []
    offset = 0
    for leaf in leaves:
        if isinstance(leaf, ShardedLeaf):
            desc, bufs, nbytes = leaf.encode(offset)
            descs.append(desc)
            buffers.extend(bufs)
            offset += nbytes
        elif _is_array_leaf(leaf):
            if isinstance(leaf, torch.Tensor):
                host = None
            else:
                host = np.asarray(leaf)
                if host.dtype == object:
                    return None
                if not host.dtype.isnative:
                    # The wire declares endianness-less dtype NAMES and the
                    # receiver reads native order — a big-endian source
                    # array shipped raw would decode to garbage values.
                    host = host.astype(host.dtype.newbyteorder("="))
            odt = qscale = None
            if wire_dtype == "int8" and _quantized(
                    leaf if host is None else host):
                # Quantized tier: symmetric per-leaf int8 on the leaf's
                # device, scale in the descriptor.
                arr, odt, qscale = _quantize_to_host(
                    leaf if host is None else torch.from_numpy(host))
                name = "int8"
            elif host is None:
                arr, name = _tensor_to_host(leaf)
            else:
                arr, name = host, host.dtype.name
            if (
                qscale is None
                and wire_dtype not in (None, "int8")
                and arr.dtype.kind == "f"
                and arr.dtype.itemsize > 2
            ):
                odt = name
                arr = _downcast(arr, wire_dtype)
                name = wire_dtype
            if not arr.flags["C_CONTIGUOUS"]:
                arr = np.ascontiguousarray(arr)
            buf = _array_buffer(arr)
            desc = {
                "t": "arr",
                "dtype": name,
                "shape": list(arr.shape),
                "off": offset,
                "n": arr.nbytes,
            }
            if odt is not None:
                desc["odt"] = odt
            if qscale is not None:
                desc["qs"] = float(qscale)
            descs.append(desc)
            buffers.append(buf)
            offset += arr.nbytes
        elif isinstance(leaf, _MSGPACK_SCALARS):
            if isinstance(leaf, int) and abs(leaf) >= 2**63:
                return None
            descs.append({"t": "obj", "v": leaf})
        else:
            return None
    meta = {"spec": wire_spec, "leaves": descs}
    try:
        meta_bytes = msgpack.packb(meta, use_bin_type=True)
    except Exception:  # noqa: BLE001 - any unpackable meta -> pickle lane
        return None
    return meta_bytes, buffers


def shard_view(desc: dict, shard: dict, payload) -> np.ndarray:
    """A zero-copy numpy view of one received shard's data."""
    dtype = _np_dtype(desc["dtype"])
    shape = [b - a for a, b in shard["i"]]
    raw = payload_range(payload, shard["off"], shard["n"])
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def region_volume(region) -> int:
    v = 1
    for a, b in region:
        v *= max(0, b - a)
    return v


def regions_cover_exactly(regions, target) -> bool:
    """True iff ``regions`` (clipped to ``target``) tile ``target`` exactly:
    full coverage, zero overlap. Guards against hostile/buggy shard metas
    whose byte counts add up while leaving holes (which would surface
    uninitialized receiver memory as array contents)."""
    clipped = []
    for r in regions:
        c = [
            [max(a, ta), min(b, tb)]
            for (a, b), (ta, tb) in zip(r, target)
        ]
        if region_volume(c) > 0:
            clipped.append(c)
    if sum(region_volume(c) for c in clipped) != region_volume(target):
        return False
    for i in range(len(clipped)):
        for j in range(i + 1, len(clipped)):
            inter = [
                [max(a1, a2), min(b1, b2)]
                for (a1, b1), (a2, b2) in zip(clipped[i], clipped[j])
            ]
            if region_volume(inter) > 0:
                return False
    return True


def extract_region(desc: dict, payload, region) -> np.ndarray:
    """Host array for one requested slice of a ``sharr`` leaf's global
    array: a zero-copy view when the region matches a received shard
    exactly, otherwise assembled from the overlapping shards. ``region``
    is [[start, stop], ...] per dimension. The received shards must
    exactly tile the requested region (no holes, no double-writes) — the
    guard against hostile/buggy metas surfacing uninitialized memory."""
    for shard in desc["shards"]:
        if shard["i"] == region:
            return shard_view(desc, shard, payload)
    if not regions_cover_exactly([s["i"] for s in desc["shards"]], region):
        raise ValueError(
            f"received shards do not exactly tile requested region {region}"
        )
    shape = [b - a for a, b in region]
    out = np.empty(shape, _np_dtype(desc["dtype"]))
    for shard in desc["shards"]:
        inter = [
            [max(sa, ra), min(sb, rb)]
            for (sa, sb), (ra, rb) in zip(shard["i"], region)
        ]
        if any(a >= b for a, b in inter):
            continue
        src = shard_view(desc, shard, payload)
        src_sl = tuple(
            slice(a - sa, b - sa)
            for (a, b), (sa, _) in zip(inter, shard["i"])
        )
        dst_sl = tuple(
            slice(a - ra, b - ra)
            for (a, b), (ra, _) in zip(inter, region)
        )
        out[dst_sl] = src[src_sl]
    return out


def assemble_global(desc: dict, payload) -> np.ndarray:
    """Reassemble a ``sharr`` leaf into one dense host array (fallback for
    receivers without a device mesh; the TPU lane reassembles per-device
    instead, see ``proxy/tpu/tpu_proxy.py``)."""
    return extract_region(
        desc, payload, [[0, int(d)] for d in desc["shape"]]
    )


def decode_tree(meta: dict, payload, sharded_fn=None) -> Any:
    """Inverse of :func:`try_encode_tree`. ``payload`` is a bytes-like (or
    :class:`SegmentedPayload`) of the concatenated buffers; array leaves are
    materialized as CPU tensors of the wire dtype, zero-copy over the
    received buffer. ``sharr`` leaves (a JAX party's sharded
    arrays) are assembled into one dense tensor unless ``sharded_fn(desc,
    payload)`` places them."""
    spec = _spec_from_wire(meta["spec"])
    shm = _shm_owner(payload)
    leaves = []
    for d in meta["leaves"]:
        if d["t"] == "arr":
            raw = payload_range(payload, d["off"], d["n"])
            arr = np.frombuffer(raw, dtype=_np_dtype(d["dtype"]))
            odt = d.get("odt")
            qs = d.get("qs")
            if qs is not None:
                # Quantized-tier leaf: dequantize through the shipped
                # per-leaf scale back to the producer's dtype (values
                # carry the int8 grid's rounding).
                odt = odt or "float32"
                arr = (arr.astype(np.float64) * qs).astype(_np_dtype(odt))
                leaves.append(_as_tensor(arr.reshape(d["shape"]), odt))
                continue
            t = _as_tensor(arr.reshape(d["shape"]), d["dtype"])
            if odt:
                # Lossy-wire leaf: restore the producer's dtype so the
                # consumer sees the type it sent (values carry the
                # wire dtype's rounding).
                t = t.to(_torch_dtype(odt))
            elif shm is not None and arr.flags.writeable:
                # Zero-copy over the chunk (``_as_tensor`` copies only a
                # read-only buffer): record the chunk on the tensor.
                setattr(t, _SHM_ATTR, shm)
            leaves.append(t)
        elif d["t"] == "sharr":
            if sharded_fn is not None:
                leaves.append(sharded_fn(d, payload))
            else:
                leaves.append(
                    _as_tensor(assemble_global(d, payload), d["dtype"])
                )
        else:
            leaves.append(d["v"])
    return tree_util.tree_unflatten(leaves, spec)


# ---------------------------------------------------------------------------
# Small-message compact lane ("mp"): scalars and plain containers of
# scalars cross as a single msgpack blob — no tree walk, no per-leaf meta,
# no pickle on either end. Type fidelity is strict: anything msgpack would
# round-trip as a *different* Python type (tuples, namedtuples, subclasses,
# numpy scalars) falls through to the tree/pickle lanes.
# ---------------------------------------------------------------------------

_MP_EXACT_SCALARS = frozenset(
    (bool, int, float, str, bytes, type(None))
)
_MP_MAX_DEPTH = 32


def _msgpack_clean(x: Any, depth: int = 0) -> bool:
    """True iff ``x`` round-trips through msgpack with exact types: only
    the exact builtin scalar types (int within 64 bits), lists, and dicts
    with str/int keys. Subclasses and tuples are rejected — msgpack would
    return them as base types / lists."""
    if depth > _MP_MAX_DEPTH:
        return False
    t = type(x)
    if t in _MP_EXACT_SCALARS:
        return t is not int or -(2**63) <= x < 2**64
    if t is list:
        return all(_msgpack_clean(v, depth + 1) for v in x)
    if t is dict:
        return all(
            type(k) in (str, int) and _msgpack_clean(v, depth + 1)
            for k, v in x.items()
        )
    return False


def try_encode_compact(data: Any, max_bytes: int) -> Optional[bytes]:
    """Encode ``data`` as one msgpack blob when it is msgpack-clean and the
    blob fits in ``max_bytes``; None otherwise (caller falls through to the
    tree/pickle lanes)."""
    if max_bytes <= 0 or not _msgpack_clean(data):
        return None
    try:
        blob = msgpack.packb(data, use_bin_type=True, strict_types=True)
    except Exception:  # noqa: BLE001 - anything unpackable -> normal lanes
        return None
    if len(blob) > max_bytes:
        return None
    return blob


def decode_compact(payload) -> Any:
    return msgpack.unpackb(
        payload_bytes(payload), raw=False, strict_map_key=False
    )


def quick_payload_bound(data: Any, limit: int) -> bool:
    """Conservative constant-ish-time probe: True only when the encoded
    payload for ``data`` is guaranteed to fit within ``limit`` bytes.
    False means "don't know / too big" — callers fall back to the normal
    queued path, so under-estimation is the only correctness hazard and
    every unknown leaf type declines. Used by the send fast path to decide
    *before* encoding whether a payload may ride the inline small lane."""
    if limit <= 0:
        return False
    budget = _quick_bound(data, 0)
    return budget is not None and budget <= limit


_QUICK_ITEM_CAP = 256


def _quick_bound(x: Any, depth: int) -> Optional[int]:
    if depth > _MP_MAX_DEPTH:
        return None
    t = type(x)
    if t in _MP_EXACT_SCALARS:
        if t is str:
            return 8 + 4 * len(x)  # worst-case UTF-8 expansion
        if t is bytes:
            return 8 + len(x)
        return 16
    if t in (list, tuple):
        if len(x) > _QUICK_ITEM_CAP:
            return None
        total = 8
        for v in x:
            b = _quick_bound(v, depth + 1)
            if b is None:
                return None
            total += b
        return total
    if t is dict:
        if len(x) > _QUICK_ITEM_CAP:
            return None
        total = 8
        for k, v in x.items():
            kb = _quick_bound(k, depth + 1)
            vb = _quick_bound(v, depth + 1)
            if kb is None or vb is None:
                return None
            total += kb + vb
        return total
    nbytes = getattr(x, "nbytes", None)
    if isinstance(nbytes, int):
        # Array-like leaf: raw bytes + generous per-leaf meta margin.
        return nbytes + 256
    return None


def encode_payload(
    data: Any,
    wire_dtype: Optional[str] = None,
    small_threshold: Optional[int] = None,
) -> Tuple[str, bytes, List[Any]]:
    """Encode any payload for the wire.

    Returns (kind, meta_bytes, buffers): kind in {"mp", "tree", "pickle"};
    meta_bytes is msgpack (tree) or empty (mp/pickle); buffers are written
    after the frame header in order. ``wire_dtype`` — see
    :func:`try_encode_tree` (tree lane only; the pickle lane ships
    objects verbatim). ``small_threshold`` (> 0) enables the compact
    ``mp`` lane for msgpack-clean payloads whose blob fits within it.
    """
    if small_threshold:
        blob = try_encode_compact(data, small_threshold)
        if blob is not None:
            return "mp", b"", [blob]
    enc = try_encode_tree(data, wire_dtype=wire_dtype)
    if enc is not None:
        meta_bytes, buffers = enc
        return "tree", meta_bytes, buffers
    return "pickle", b"", [dumps(data)]


def decode_payload(
    kind: str,
    meta_bytes: bytes,
    payload,
    allowed_list: Optional[Dict[str, List[str]]] = None,
    sharded_fn=None,
) -> Any:
    if kind == "tree":
        return decode_tree(
            msgpack.unpackb(meta_bytes, raw=False), payload, sharded_fn
        )
    if kind == "mp":
        # Pure msgpack — no unpickling, so no whitelist concerns.
        return decode_compact(payload)
    if kind == "pickle":
        return restricted_loads(payload_bytes(payload), allowed_list)
    raise ValueError(f"unknown payload kind: {kind}")


# ---------------------------------------------------------------------------
# Optional wire compression (native lanes only; the reference wire has no
# equivalent field, so the gRPC parity lane never compresses)
# ---------------------------------------------------------------------------

COMPRESSION_SCHEMES = ("zlib", "zstd")

# Valid compression_level range per scheme (zstd: negative = fast modes).
_LEVEL_RANGES = {"zlib": (-1, 9), "zstd": (-22, 22)}


def _check_scheme_level(scheme: str, level: int, knob: str) -> None:
    if scheme not in COMPRESSION_SCHEMES:
        raise ValueError(
            f"unknown {knob} {scheme!r}; supported: {COMPRESSION_SCHEMES}"
        )
    lo, hi = _LEVEL_RANGES[scheme]
    if not lo <= level <= hi:
        raise ValueError(
            f"compression_level must be in [{lo}, {hi}] for "
            f"{scheme}, got {level}"
        )


def compress_buffers(buffers, scheme: str, level: int = 1):
    """Compress the payload buffers into one stream (zlib or zstd).

    Returns (blob, raw_len) — or None when compression does not shrink the
    payload (incompressible data ships raw; the header then carries no
    ``comp`` flag, so the receive path is unchanged). Buffers are fed to
    the compressor incrementally — the payload is never concatenated, so
    peak send-side memory is payload + blob, not 2x payload.

    ``zstd`` is the codec of choice for gradient/weight data: at level 1-3
    it compresses comparably to zlib-6 at several times the speed
    (zlib stays supported for deployments pinning the earlier wire).

    Wire compatibility: a ``comp`` frame is only decodable by a
    compression-aware build supporting that scheme (the receiver fails
    the frame with a clear error otherwise), so ``payload_compression``
    requires every receiving party to run one; it is opt-in config,
    never negotiated silently.
    """
    _check_scheme_level(scheme, level, "payload_compression")
    if scheme == "zstd":
        import zstandard

        c = zstandard.ZstdCompressor(level=level).compressobj()
    else:
        import zlib

        c = zlib.compressobj(level)
    raw_len = 0
    parts = []
    for b in buffers:
        view = memoryview(b).cast("B")
        raw_len += view.nbytes
        chunk = c.compress(view)
        if chunk:
            parts.append(chunk)
    parts.append(c.flush())
    blob = b"".join(parts)
    if len(blob) >= raw_len:
        return None
    return blob, raw_len


def decompress_payload(payload, scheme: str, raw_len: int,
                       max_bytes: Optional[int]) -> memoryview:
    """Inverse of :func:`compress_buffers`, with decompression-bomb
    protection: output is bounded by ``max_bytes`` (and must match the
    header's declared ``rawlen``) BEFORE a full-size buffer can be
    produced."""
    if scheme not in COMPRESSION_SCHEMES:
        raise ValueError(f"unknown compression scheme on wire: {scheme!r}")
    if raw_len < 0:
        raise ValueError("compressed frame is missing its rawlen header")
    if max_bytes is not None and raw_len > max_bytes:
        raise ValueError(
            f"compressed payload declares rawlen {raw_len} past the "
            f"allowed size ({max_bytes} bytes)"
        )
    # Chunked inflate: a bomb is caught at the first chunk that overflows
    # the declared rawlen, and the bytearray keeps the receiver's
    # writable-view promise (numpy leaves decoded from raw frames come
    # from the recv pool). rawlen is only trusted for preallocation after
    # the cap validated it; in explicit no-cap deployments the buffer
    # grows with the actual inflated bytes instead, so a forged header
    # can never trigger a large allocation by itself.
    bounded = max_bytes is not None
    out = bytearray(raw_len if bounded else 0)
    pos = 0

    def put(chunk):
        nonlocal pos
        if not chunk:
            return
        if pos + len(chunk) > raw_len:
            raise ValueError(
                f"compressed payload inflates past its declared size "
                f"({raw_len} bytes)"
            )
        if bounded:
            out[pos: pos + len(chunk)] = chunk
        else:
            out.extend(chunk)
        pos += len(chunk)

    src = memoryview(payload_bytes(payload))
    step = 4 << 20
    if scheme == "zstd":
        import zstandard

        # stream_reader bounds OUTPUT per read call, so a bomb never
        # materialises more than one step past the declared size no
        # matter how extreme the ratio of a single compressed block.
        # Trailing bytes after the frame are rejected too: the reader
        # parses them as a following frame — garbage fails the frame
        # header, a real second frame overflows the declared rawlen
        # (both pinned in tests). The one undetectable tail is a valid
        # zero-output empty frame, which contributes no bytes.
        reader = zstandard.ZstdDecompressor().stream_reader(src)
        try:
            while True:
                want = min(step, raw_len - pos + 1)
                chunk = reader.read(max(1, want))
                if not chunk:
                    break
                put(chunk)
        except zstandard.ZstdError as e:
            raise ValueError(f"corrupt zstd stream: {e}") from None
        if pos != raw_len:
            raise ValueError(
                f"decompressed size {pos} != declared rawlen {raw_len}"
            )
        return memoryview(out)

    import zlib

    d = zlib.decompressobj()
    for i in range(0, len(src), step):
        put(d.decompress(src[i: i + step], raw_len - pos + 1))
    put(d.flush())
    if d.unused_data:
        raise ValueError("trailing bytes after the compressed stream")
    if not d.eof or pos != raw_len:
        raise ValueError(
            f"decompressed size {pos} != declared rawlen {raw_len}"
        )
    return memoryview(out)
