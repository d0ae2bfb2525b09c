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

"""CUDA data-plane transport: the TCP wire + placement on the party's card
on arrival (port of ``rayfed_tpu/proxy/tpu/tpu_proxy.py``).

Payloads cross the wire as raw tensor bytes (the ``tree`` lane of
``_private/serialization.py``); this backend completes the lane by
placing every received tensor leaf **on the party's device**
(``mesh.get_party_device``) inside the receiver's decode, so the consuming
task finds its inputs on the card and never copies them itself.

Placement runs on a decode worker thread while the consuming task runs on
another, on the default stream. So the destination is allocated on the
default stream and the side stream waits on it before copying (the
allocator may hand out memory that queued default-stream work still
reads); the bytes go through reused pinned host slots with non-blocking
copies; and the side stream is synchronized before the value resolves.
The slots are the only pinned memory: the receive buffer is never pinned.

The JAX sender's other lanes — same-mesh reference frames and device DMA
— are not ported; their frames raise here.
"""

from __future__ import annotations

import threading
from typing import List

import torch

from rayfed_tpu_torch import tracing, tree_util
from rayfed_tpu_torch.proxy.tcp.tcp_proxy import TcpReceiverProxy, TcpSenderProxy

# Pinned host slots per receiver: two, so the host copy into one overlaps
# the card's copy out of the other.
STAGING_SLOTS = 2
STAGING_SLOT_BYTES = 64 << 20


class PinnedStaging:
    """Places CPU tensors on one card through ``STAGING_SLOTS`` pinned host
    slots of ``STAGING_SLOT_BYTES``, allocated at first use and reused by
    every later placement, and a side stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"the CUDA lane places on a card, not {device}")
        self._lock = threading.Lock()
        self._stream = None
        self._slots: List = []

    def slot_pointers(self) -> List[int]:
        """Host addresses of the pinned slots (empty before first use)."""
        return [buf.data_ptr() for buf, _ in self._slots]

    def place(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """New tensors on the card with the dtype, shape and bytes of
        ``tensors`` (CPU), landed when this returns."""
        with self._lock, torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._slots = [
                    (torch.empty(STAGING_SLOT_BYTES, dtype=torch.uint8,
                                 pin_memory=True), torch.cuda.Event())
                    for _ in range(STAGING_SLOTS)
                ]
            outs = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                    for t in tensors]
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            slot_bytes = self._slots[0][0].numel()
            k = 0
            for src, dst in zip(tensors, outs):
                n = src.numel() * src.element_size()
                if n == 0:
                    continue
                src_b = src.contiguous().reshape(-1).view(torch.uint8)
                dst_b = dst.reshape(-1).view(torch.uint8)
                for off in range(0, n, slot_bytes):
                    m = min(slot_bytes, n - off)
                    buf, done = self._slots[k % len(self._slots)]
                    k += 1
                    done.synchronize()  # the slot's last copy has left it
                    buf[:m].copy_(src_b[off:off + m])
                    with torch.cuda.stream(self._stream):
                        dst_b[off:off + m].copy_(buf[:m], non_blocking=True)
                        done.record(self._stream)
            self._stream.synchronize()
        return outs


def place_decoded(base_decode, staging: PinnedStaging):
    """Wrap a rendezvous decode function: the decoded value with every CPU
    tensor leaf placed on ``staging``'s card (a ``place`` tracing span);
    other leaves as they are."""

    def decode(header, payload):
        kind = header.get("pkind")
        if kind == "meshref":
            raise NotImplementedError(
                "received a same-mesh reference frame: the same-mesh push "
                "lane is ROADMAP Queue 1 item 12, not ported to "
                "rayfed_tpu_torch yet"
            )
        if kind == "dma":
            raise NotImplementedError(
                "received a device-DMA frame: the DMA half of ROADMAP "
                "Queue 1 item 4 (CUDA IPC / NCCL peer copies, with item "
                "12) is not ported to rayfed_tpu_torch yet"
            )
        value = base_decode(header, payload)
        leaves, spec = tree_util.tree_flatten(value)
        idx = [i for i, x in enumerate(leaves)
               if isinstance(x, torch.Tensor) and x.device.type == "cpu"]
        if not idx:
            return value
        nbytes = sum(leaves[i].numel() * leaves[i].element_size() for i in idx)
        with tracing.span("place", header.get("src", ""), header.get("up", ""),
                          header.get("down", ""), nbytes):
            placed = staging.place([leaves[i] for i in idx])
        for i, t in zip(idx, placed):
            leaves[i] = t
        return tree_util.tree_unflatten(leaves, spec)

    return decode


class CudaSenderProxy(TcpSenderProxy):
    """Sender side: the TCP sender. Tensors on a card are staged to host
    when the pushed value resolves (``proxy/barriers``), as on the TCP
    lane."""

    _TRANSPORT = "cuda"  # fed_transport_send_ops_total{transport="cuda"}


class CudaReceiverProxy(TcpReceiverProxy):
    """Receiver side: the TCP receiver, placing received tensors on the
    party's device (bound by ``fed.init``; the current card otherwise)."""

    def _make_decode_fn(self):
        from rayfed_tpu_torch import mesh

        self._staging = PinnedStaging(mesh.party_device())
        return place_decoded(super()._make_decode_fn(), self._staging)
