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

"""Device-DMA push lane on CUDA IPC (port of ``rayfed_tpu/proxy/tpu/dma.py``).

With ``cross_silo_comm.device_dma: true`` on ``transport="cuda"``, a pushed
tree whose every leaf is a tensor on the party's device does not cross the
socket: the sender parks a snapshot of it on this process's transfer server
(:func:`try_register`), only a descriptor frame (pkind ``"dma"``: uuid,
server address, wire tree spec, shapes and dtypes, the engine tag and the
sender's host and card identity) rides the data plane, and the receiver
pulls the bytes exactly once (:func:`pull`).

The snapshot (:func:`snapshot`, taken when the pushed value resolves) packs
the tree's card leaves into one ``cudaMalloc`` buffer outside PyTorch's
caching allocator (``csrc/dma_ipc.cu``), each leaf at a 256-byte aligned
offset, so a push is one handle, one open and one copy, and the lane frees
the buffer itself. An allocation the card refuses empties PyTorch's cache
of freed blocks and is tried once more. CPU leaves (a party whose device is the CPU, as in the
CPU tests) are cloned. A received tree's leaves are views of one buffer.

Engines, picked per pull from what the receiver reports about itself (host,
process id, card uuid) against the descriptor's sender identity:

- ``ipc``: a card snapshot and a receiver in another process of the same
  host on the same card. The server answers with the buffer's CUDA IPC
  handle; the receiver opens it, copies device to device into a buffer on
  its party device, synchronizes, closes it and says "done" on the same
  connection. Only then does the server free the snapshot.
- ``local``: sender and receiver in one process (CUDA IPC cannot open a
  handle in the process that exported it): the pull copies from the parked
  snapshot directly, with no connection.
- ``socket``: host snapshots, and receivers on another host or another
  card (NCCL peer copies are ROADMAP Queue 1 item 12b): the JAX package's
  socket engine and protocol, length-prefixed msgpack messages and then
  each leaf's raw bytes; a card snapshot is copied to host first, and a
  receiver on a card copies the bytes there.

Each pull is counted per engine (:func:`stats`, the ``fed_dma_pulls_total``
series) and recorded as a ``pull`` tracing span whose ``extra`` names its
engine and, for a pull over a connection, the ms of its request, of an
IPC pull's allocation, open, copy (with its synchronize) and close, and of
a socket pull's copy to the card. A uuid is served once: the server pops
it on the first request. A pull from a sender that died raises (connection refused, or EOF on the
cached connection) within the connection's timeout instead of hanging.
Descriptors of the JAX package carry no engine tag and are refused here,
and the JAX package cannot pull this lane's: mixed JAX/torch jobs keep
``device_dma`` off.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import math
import os
import random
import socket
import struct
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from rayfed_tpu_torch import tracing, tree_util
from rayfed_tpu_torch._private import msgpack_codec as msgpack
from rayfed_tpu_torch._private import serialization
from rayfed_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

ENGINES = ("ipc", "local", "socket")
#: Every leaf of a packed snapshot starts at a multiple of this.
ALIGN = 256
#: The receiver's default wait for a pull (connect and each read).
PULL_TIMEOUT_S = 60.0

_MIXED_JOBS = (
    "mixed JAX/torch jobs keep cross_silo_comm.device_dma off: the two "
    "packages' device-DMA lanes cannot pull each other's descriptors"
)

_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
_server: Optional["_TransferServer"] = None  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
_server_addr: Optional[str] = None  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
_server_failed: Optional[str] = None  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
_uuid_counter = None  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
_connections: Dict[str, "_Connection"] = {}  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)

# Failed-send leak bound: a registered uuid whose descriptor frame never
# reached the peer is never pulled, so its snapshot stays parked for the
# process's life. Each failed send adds its bytes here; past the cap the
# lane's sender side turns itself off (socket lane) instead of parking
# toward an OOM. Successful sends are presumed pulled.
_failed_pinned_bytes = 0  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
_FAILED_PINNED_CAP = 1 << 30
_sender_disabled: Optional[str] = None  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)

# Pull counts and the bytes of live card snapshots. Snapshots are freed
# from finalizers too, which may run inside any allocation, hence a
# reentrant lock of their own.
_acct_lock = threading.RLock()  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
_pulls = {e: [0, 0] for e in ENGINES}  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)
# Live card snapshots: count, bytes.
_device_bytes = [0, 0]  # fedlint: disable=global-mutable-singleton (one transfer server per process, as in the JAX package)

_reg = telemetry_metrics.get_registry()
_m_pulls = _reg.counter(
    "fed_dma_pulls_total", "Device-DMA pulls by the engine that served them.",
    labels=("engine",))


def note_send_result(nbytes: int, ok: bool) -> None:
    """Sender-side accounting hook, called when a dma descriptor send
    resolves. Failures accumulate parked bytes; past the cap the lane's
    SENDER side shuts off for this process (pulling still works)."""
    global _failed_pinned_bytes, _sender_disabled
    if ok:
        return
    with _lock:
        _failed_pinned_bytes += nbytes
        if _failed_pinned_bytes > _FAILED_PINNED_CAP and _sender_disabled is None:
            _sender_disabled = (
                f"{_failed_pinned_bytes} bytes parked by failed sends "
                f"(cap {_FAILED_PINNED_CAP})"
            )
            logger.warning(
                "device-DMA sender disabled: %s — pushes use the socket "
                "lane from now on.", _sender_disabled,
            )


def stats() -> Dict:
    """Pulls and pulled bytes per engine, the card snapshots alive in this
    process, the snapshots parked on its server, failed-send bytes."""
    with _acct_lock:
        out = {"pulls": {e: n for e, (n, _) in _pulls.items()},
               "pulled_bytes": {e: b for e, (_, b) in _pulls.items()},
               "device_snapshots": _device_bytes[0],
               "device_bytes": _device_bytes[1]}
    server = _server
    out["parked"], out["parked_bytes"] = (
        server.parked() if server is not None else (0, 0))
    out["failed_send_bytes"] = _failed_pinned_bytes
    out["sender_disabled"] = _sender_disabled
    return out


def _count_pull(engine: str, nbytes: int) -> None:
    with _acct_lock:
        _pulls[engine][0] += 1
        _pulls[engine][1] += nbytes
    _m_pulls.labels(engine=engine).inc()


# ---------------------------------------------------------------------------
# Identity, layout and the CUDA IPC calls
# ---------------------------------------------------------------------------


def _host_id() -> str:
    """This host: its name and the kernel's boot id (two containers of one
    name, or one host before and after a reboot, differ)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}/{boot}"


def _card_uuid(device: torch.device) -> str:
    return str(torch.cuda.get_device_properties(device).uuid)


def _full_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _identity(device=None) -> Dict:
    """What a party reports of itself: host, process id and, for a card,
    its uuid."""
    card = None
    if device is not None and torch.device(device).type == "cuda":
        card = _card_uuid(_full_device(device))
    return {"host": _host_id(), "pid": os.getpid(), "card": card}


def _dtype_name(t: torch.Tensor) -> str:
    """The wire dtype name (the JAX descriptor's ``str(x.dtype)``)."""
    name = serialization._CARRIED_NAMES.get(t.dtype)
    return name if name is not None else str(t.dtype).rpartition(".")[2]


def _leaf_nbytes(shape, dtype: str) -> int:
    return int(math.prod(shape)) * serialization._np_dtype(dtype).itemsize


def _layout(sizes: List[int]) -> Tuple[List[int], int]:
    """Each leaf's offset in a packed buffer and the buffer's size."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // ALIGN) * ALIGN
    return offsets, total


def _views(buf: torch.Tensor, leaves: List[Dict], offsets: List[int],
           sizes: List[int]) -> List[torch.Tensor]:
    """The leaves ``leaves`` describes, as views of the packed ``buf``."""
    return [buf[off:off + n].view(serialization._torch_dtype(e["dtype"]))
            .view(e["shape"])
            for e, off, n in zip(leaves, offsets, sizes)]


def _call(name: str, *args) -> None:
    from rayfed_tpu_torch.ops import _native

    lib = _native.lib()
    code = getattr(lib, name)(*args)
    if code != 0:
        # cudaErrorMemoryAllocation: the card is out of memory.
        raise (torch.cuda.OutOfMemoryError if code == 2 else RuntimeError)(
            f"{name} failed: {lib.rf_error_string(code).decode()} "
            f"(code {code})")


def _copy(dst: int, src: int, nbytes: int, device: torch.device) -> None:
    """Copy ``nbytes`` from ``src`` to ``dst`` (device or host addresses)
    on ``device``'s current stream, landed when this returns."""
    if nbytes == 0:
        return
    stream = torch.cuda.current_stream(device)
    _call("rf_dma_copy", ctypes.c_void_p(dst), ctypes.c_void_p(src),
          ctypes.c_ulonglong(nbytes), ctypes.c_void_p(stream.cuda_stream))
    stream.synchronize()


def _free_device(index: int, ptr: int, nbytes: int) -> None:
    _call("rf_dma_free", index, ctypes.c_void_p(ptr))
    with _acct_lock:
        _device_bytes[0] -= 1
        _device_bytes[1] -= nbytes


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------


class Snapshot:
    """A pushed tree's leaves parked for one pull: packed into one
    ``cudaMalloc`` buffer on a card (``ptr``), or host tensors (``host``).
    :meth:`free` releases the buffer; so does dropping the snapshot
    unregistered (a send that failed before it encoded)."""

    def __init__(self, wire_spec, meta: List[Dict], device: torch.device,
                 ptr: Optional[int] = None,
                 host: Optional[List[torch.Tensor]] = None):
        self.wire_spec = wire_spec
        self.meta = meta
        self.device = device
        self.sizes = [_leaf_nbytes(e["shape"], e["dtype"]) for e in meta]
        self.offsets, self.packed = _layout(self.sizes)
        self.nbytes = sum(self.sizes)
        self.ptr = ptr
        self.host = host
        self._finalizer = None
        if ptr is not None:
            with _acct_lock:
                _device_bytes[0] += 1
                _device_bytes[1] += self.packed
            self._finalizer = weakref.finalize(
                self, _free_device, device.index, ptr, self.packed)
            self._finalizer.atexit = False  # process exit releases it

    def free(self) -> None:
        """Release the card buffer (once; later calls do nothing) and the
        host leaves."""
        self.host = None
        if self._finalizer is not None:
            self._finalizer()

    def ipc_handle(self) -> bytes:
        from rayfed_tpu_torch.ops import _native

        out = ctypes.create_string_buffer(_native.lib().rf_dma_handle_size())
        _call("rf_dma_ipc_handle", ctypes.c_void_p(self.ptr), out)
        return out.raw

    def copy_to(self, device: torch.device) -> torch.Tensor:
        """The packed bytes in a new uint8 buffer on ``device`` (a card or
        the host)."""
        buf = torch.empty(self.packed, dtype=torch.uint8, device=device)
        _copy(buf.data_ptr(), self.ptr, self.packed, self.device)
        return buf

    def host_buffers(self) -> List:
        """Each leaf's bytes in host memory, for the socket engine."""
        if self.ptr is None:
            return [x.reshape(-1).view(torch.uint8).numpy()
                    for x in self.host]
        arr = self.copy_to(torch.device("cpu")).numpy()
        return [arr[off:off + n] for off, n in zip(self.offsets, self.sizes)]


def _flatten_for_lane(value, device: torch.device):
    """(leaves, wire spec, leaf descriptors) when every leaf of ``value``
    is a tensor on ``device`` and the tree ships; else None."""
    try:
        leaves, spec = tree_util.tree_flatten(value)
    except Exception:  # noqa: BLE001 - unflattenable values
        return None
    if not leaves or not all(isinstance(x, torch.Tensor) and
                             x.device == device for x in leaves):
        return None
    wire_spec = serialization._spec_to_wire(spec)
    if wire_spec is None:
        return None
    meta = [{"shape": list(x.shape), "dtype": _dtype_name(x)} for x in leaves]
    try:
        for e in meta:
            serialization._np_dtype(e["dtype"])
    except TypeError:
        return None  # a dtype the wire cannot name rides the socket lane
    return leaves, wire_spec, meta


def _alloc(device: torch.device, nbytes: int) -> int:
    """A new ``cudaMalloc`` buffer of ``nbytes`` on ``device``. When the card
    is full, PyTorch's allocator may still cache freed blocks: empty its
    cache and try once more before giving up, as that allocator does."""
    ptr = ctypes.c_void_p()
    # At least one aligned block: cudaMalloc(0) gives no address to export.
    args = (device.index, ctypes.c_ulonglong(max(nbytes, ALIGN)),
            ctypes.byref(ptr))
    try:
        _call("rf_dma_alloc", *args)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        _call("rf_dma_alloc", *args)
    return ptr.value


def snapshot(value, device) -> Optional[Snapshot]:
    """Capture ``value`` for the lane when every leaf is a tensor on
    ``device``: card leaves packed into one new device buffer (copied on
    the device's current stream, after the work queued there, and landed
    when this returns), CPU leaves cloned. None for any other value (the
    socket lane's)."""
    device = _full_device(device)
    flat = _flatten_for_lane(value, device)
    if flat is None:
        return None
    leaves, wire_spec, meta = flat
    if device.type != "cuda":
        return Snapshot(wire_spec, meta, device, host=[
            x.detach().clone(memory_format=torch.contiguous_format)
            for x in leaves])
    sizes = [_leaf_nbytes(e["shape"], e["dtype"]) for e in meta]
    offsets, packed = _layout(sizes)
    snap = Snapshot(wire_spec, meta, device, ptr=_alloc(device, packed))
    stream = torch.cuda.current_stream(device)
    keep = []  # contiguous copies stay alive until the stream is synchronized
    for x, off, n in zip(leaves, offsets, sizes):
        if n == 0:
            continue
        x = x.detach()
        if not x.is_contiguous():
            x = x.contiguous()
            keep.append(x)
        _call("rf_dma_copy", ctypes.c_void_p(snap.ptr + off),
              ctypes.c_void_p(x.data_ptr()), ctypes.c_ulonglong(n),
              ctypes.c_void_p(stream.cuda_stream))
    stream.synchronize()
    del keep
    return snap


# ---------------------------------------------------------------------------
# The socket protocol (the JAX package's socket engine)
# ---------------------------------------------------------------------------


def _recv_into(sock, view: memoryview) -> None:
    got, n = 0, view.nbytes
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError("transfer peer closed mid-message")
        got += r


def _read_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


def _read_msg(sock) -> dict:
    (n,) = struct.unpack("!I", _read_exact(sock, 4))
    if n > 1 << 20:
        raise ValueError(f"transfer control message too large ({n} bytes)")
    return msgpack.unpackb(_read_exact(sock, n), raw=False)


def _write_msg(sock, msg: dict) -> None:
    blob = msgpack.packb(msg, use_bin_type=True)
    sock.sendall(struct.pack("!I", len(blob)) + blob)


class _Connection:
    """Client half: one TCP connection to a sender's server; pulls are
    serialized under a lock (the rendezvous store pulls one descriptor at a
    time per edge anyway)."""

    def __init__(self, addr: str, timeout_s: float):
        host, port = addr.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout_s)
        try:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover - platform-specific
            pass
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass

    def pull(self, desc: Dict, sizes: List[int],
             device: Optional[torch.device]):
        """(packed buffer, engine, ms of its parts) of ``desc``'s uuid."""
        offsets, packed = _layout(sizes)
        parts = {}
        with self._lock:
            t0 = time.perf_counter()
            _write_msg(self._sock, {"uuid": desc["uuid"], **_identity(device)})
            reply = _read_msg(self._sock)
            parts["ask_ms"] = 1e3 * (time.perf_counter() - t0)
            if "error" in reply:
                raise RuntimeError(f"transfer pull failed: {reply['error']}")
            engine = reply.get("engine")
            if engine == "ipc":
                if device is None or device.type != "cuda" \
                        or reply.get("nbytes", -1) < packed:
                    raise RuntimeError(
                        f"transfer pull: an ipc answer of {reply.get('nbytes')}"
                        f" bytes for {packed} packed bytes on {device}")
                buf = _ipc_copy(reply["handle"], packed, device, parts)
                _write_msg(self._sock, {"done": True})
            elif engine == "socket":
                if list(reply.get("lens", ())) != sizes:
                    raise RuntimeError(
                        f"transfer pull returned leaves of {reply.get('lens')}"
                        f" bytes, expected {sizes}")
                buf = torch.empty(packed, dtype=torch.uint8)
                view = memoryview(buf.numpy())
                for off, n in zip(offsets, sizes):
                    _recv_into(self._sock, view[off:off + n])
            else:
                raise RuntimeError(f"transfer pull: unknown engine {engine!r}")
        return buf, engine, parts


def _ipc_copy(handle: bytes, packed: int, device: torch.device,
              parts: Dict):
    """Open a peer's snapshot handle, copy its ``packed`` bytes into a new
    buffer on ``device``, synchronize and close the handle; the ms of each
    step go into ``parts``."""
    t = [time.perf_counter()]

    def lap(name):
        t.append(time.perf_counter())
        parts[name] = 1e3 * (t[-1] - t[-2])

    buf = torch.empty(packed, dtype=torch.uint8, device=device)
    lap("alloc_ms")
    src = ctypes.c_void_p()
    _call("rf_dma_ipc_open", device.index,
          ctypes.create_string_buffer(handle, len(handle)), ctypes.byref(src))
    lap("open_ms")
    try:
        _copy(buf.data_ptr(), src.value, packed, device)
        lap("copy_ms")
    finally:
        _call("rf_dma_ipc_close", device.index, src)
        lap("close_ms")
    return buf


class _TransferServer:
    """Server half: parks snapshots per uuid and serves each exactly once
    (popped on request), by the engine the requester's identity allows."""

    def __init__(self, listen_addr: str):
        host, port = listen_addr.rsplit(":", 1)
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self._addr = f"{host}:{self._sock.getsockname()[1]}"
        self._host = _host_id()
        self._pending: Dict[int, Snapshot] = {}
        self._lock = threading.Lock()
        threading.Thread(target=self._accept_loop, name="fedtpu-dma-server",
                         daemon=True).start()

    def address(self) -> str:
        return self._addr

    def await_pull(self, uuid: int, snap: Snapshot) -> None:
        with self._lock:
            self._pending[uuid] = snap

    def take(self, uuid) -> Optional[Snapshot]:
        with self._lock:
            return self._pending.pop(uuid, None)

    def parked(self) -> Tuple[int, int]:
        with self._lock:
            return (len(self._pending),
                    sum(s.nbytes for s in self._pending.values()))

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:  # pragma: no cover - socket torn down
                return
            threading.Thread(target=self._serve, args=(conn,),
                             name="fedtpu-dma-conn", daemon=True).start()

    def _serve(self, conn) -> None:
        try:
            while True:
                req = _read_msg(conn)
                if "pid" not in req:
                    # The JAX package's socket engine asks with a uuid only.
                    _write_msg(conn, {"error": "a device-DMA pull without a "
                                               "requester identity: "
                                               + _MIXED_JOBS})
                    continue
                snap = self.take(req.get("uuid"))
                if snap is None:
                    _write_msg(conn, {"error": f"unknown or already-pulled "
                                               f"uuid {req.get('uuid')}"})
                    continue
                try:
                    self._answer(conn, snap, req)
                finally:
                    # This daemon thread keeps no tensor while it waits:
                    # one freed when the interpreter stops it aborts.
                    snap.free()
                    snap = None
        except (ConnectionError, OSError, ValueError):
            pass  # peer gone / malformed: drop this connection only
        finally:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass

    def _answer(self, conn, snap: Snapshot, req: Dict) -> None:
        if (snap.ptr is not None and req.get("host") == self._host
                and req.get("pid") != os.getpid()
                and req.get("card") == _card_uuid(snap.device)):
            try:
                handle = snap.ipc_handle()
            except RuntimeError as e:
                _write_msg(conn, {"error": str(e)})
                return
            _write_msg(conn, {"engine": "ipc", "handle": handle,
                              "nbytes": snap.packed})
            # The receiver has copied and closed its mapping: free after.
            _read_msg(conn)
            return
        bufs = snap.host_buffers()
        _write_msg(conn, {"engine": "socket",
                          "lens": [memoryview(b).nbytes for b in bufs]})
        for b in bufs:
            conn.sendall(b)


def get_transfer_server(listen_addr: str = "127.0.0.1:0"):
    """The process-wide transfer server (lazy; one per process) and its
    address, or (None, None) when it cannot start: callers then use the
    socket lane."""
    global _server, _server_addr, _server_failed, _uuid_counter
    with _lock:
        if _server is not None:
            return _server, _server_addr
        if _server_failed is not None:
            return None, None
        try:
            _server = _TransferServer(listen_addr)
        except OSError as e:
            _server_failed = str(e)
            logger.warning("device-DMA transfer server unavailable (%s); "
                           "pushes use the socket lane.", e)
            return None, None
        _server_addr = _server.address()
        # uuids are scoped to this server; the random base keeps repeat
        # fed.init() in one process from reusing ids.
        _uuid_counter = itertools.count(random.getrandbits(30) << 20)
        return _server, _server_addr


def try_register(
    value, listen_addr: str, device=None,
) -> Optional[Tuple[Dict, bytes, Callable[[bool], None]]]:
    """Park ``value`` on the transfer server and return (header_fields,
    descriptor, on_done) for a ``dma`` frame (``on_done(ok)`` feeds the
    failed-send accounting). ``value`` is a :class:`Snapshot` taken at
    resolution, or a tree whose every leaf is a tensor on ``device``
    (snapshotted here). None for any other value, or while the sender side
    is off or the server cannot start: the socket lane's."""
    snap = value
    if not isinstance(value, Snapshot):
        if _sender_disabled is not None or device is None:
            return None
        snap = snapshot(value, device)
        if snap is None:
            return None
    # Up already for a snapshot taken at resolution (see ready()).
    server, addr = get_transfer_server(listen_addr)
    if server is None:
        snap.free()
        return None
    uuid = next(_uuid_counter)
    payload = msgpack.packb({
        "uuid": uuid,
        "addr": addr,
        "spec": snap.wire_spec,
        "leaves": snap.meta,
        "engine": "cuda" if snap.ptr is not None else "host",
        **_identity(snap.device),
    }, use_bin_type=True)
    server.await_pull(uuid, snap)
    nbytes = snap.nbytes

    def on_done(ok: bool) -> None:
        note_send_result(nbytes, ok)

    return {"pkind": "dma"}, payload, on_done


def ready(listen_addr: str) -> bool:
    """Whether a push may be snapshotted for the lane now: the sender side
    is on and the transfer server is up (started here)."""
    return _sender_disabled is None and \
        get_transfer_server(listen_addr)[0] is not None


def _connection(addr: str, timeout_s: float) -> _Connection:
    with _lock:
        conn = _connections.get(addr)
    if conn is None:
        conn = _Connection(addr, timeout_s)
        with _lock:
            prior = _connections.setdefault(addr, conn)
        if prior is not conn:
            conn.close()
            conn = prior
    return conn


def _drop_connection(addr: str, conn: _Connection) -> None:
    with _lock:
        if _connections.get(addr) is conn:
            del _connections[addr]
    conn.close()


def _pull_local(desc: Dict, device: Optional[torch.device]):
    """(leaves, "local"): the snapshot parked on this process's server."""
    snap = _server.take(desc["uuid"]) if _server is not None else None
    if snap is None:
        raise RuntimeError(f"transfer pull failed: unknown or already-pulled "
                           f"uuid {desc['uuid']}")
    try:
        if snap.ptr is None:
            leaves = snap.host  # already the lane's own clones
            return leaves, "local"
        buf = snap.copy_to(device if device is not None else snap.device)
        return _views(buf, snap.meta, snap.offsets, snap.sizes), "local"
    finally:
        snap.free()


def pull(meta_payload, max_bytes: Optional[int] = None, device=None,
         timeout_s: Optional[float] = None, peer: str = "",
         upstream_seq_id: str = "", downstream_seq_id: str = ""):
    """Receiver side: pull a descriptor's tree onto ``device`` (the party's
    card; None or the CPU: host tensors) and return it. Records a ``pull``
    span (the engine in its ``extra``) and counts the pull per engine.

    The descriptor's declared sizes are checked against ``max_bytes`` (the
    receiver's payload cap) BEFORE any allocation: a tiny descriptor cannot
    command a huge one. ``timeout_s`` bounds the connect and each read
    (None: ``PULL_TIMEOUT_S``). A receiver needs no server of its own."""
    desc = msgpack.unpackb(bytes(meta_payload), raw=False)
    if "engine" not in desc:
        raise ValueError("received a device-DMA descriptor without an engine "
                         "tag (the JAX package's): " + _MIXED_JOBS)
    sizes = [_leaf_nbytes(e["shape"], e["dtype"]) for e in desc["leaves"]]
    total = sum(sizes)
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"dma descriptor declares {total} bytes, exceeding the "
            f"receiver's payload cap ({max_bytes})")
    spec = serialization._spec_from_wire(desc["spec"])
    if device is not None:
        device = _full_device(device)
    with tracing.span("pull", peer, upstream_seq_id, downstream_seq_id,
                      total) as sp:
        parts = {}
        if desc.get("host") == _host_id() and desc.get("pid") == os.getpid():
            leaves, engine = _pull_local(desc, device)
        else:
            addr, conn = desc["addr"], None
            try:
                conn = _connection(
                    addr, PULL_TIMEOUT_S if timeout_s is None else timeout_s)
                buf, engine, parts = conn.pull(desc, sizes, device)
                if device is not None and buf.device != device:
                    # The socket engine lands the bytes in host memory.
                    t0 = time.perf_counter()
                    buf = buf.to(device)
                    parts["place_ms"] = 1e3 * (time.perf_counter() - t0)
            except BaseException as e:
                if conn is not None:
                    _drop_connection(addr, conn)
                if isinstance(e, (ConnectionError, OSError, ValueError)):
                    raise ConnectionError(
                        f"device-DMA pull of uuid {desc['uuid']} from "
                        f"{addr} failed: {e!r}") from e
                raise
            leaves = _views(buf, desc["leaves"], _layout(sizes)[0], sizes)
        sp.set_extra(engine=engine, **parts)
    _count_pull(engine, total)
    return tree_util.tree_unflatten(list(leaves), spec)


def reset() -> None:
    """Drop cached connections (the tenancy reset hook). The server and the
    snapshots parked on it stay, as the JAX package's do: a peer may still
    pull them."""
    with _lock:
        conns = list(_connections.values())
        _connections.clear()
    for conn in conns:
        conn.close()
