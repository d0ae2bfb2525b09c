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

"""Slot-pooled and block-paged K/V caches for the serving plane (port of
``rayfed_tpu/serving/kv_pool.py``).

Two layouts share one engine contract:

:class:`KVPool` (``serving.kv_layout = "slab"``) — one
(L, max_slots, max_len+1, H, Dh) cache pair allocated at server start;
every request borrows one batch row (a *slot*) for its lifetime.

:class:`PagedKVPool` (``"paged"``, the default) — the physical cache is
(L, 1 + num_blocks, block_size, H, Dh) and each slot holds an int32
*block table* mapping logical block i of its sequence to a physical
block. Blocks are granted on demand at token boundaries and returned to
a free list at release; prefix reuse is a block-table copy plus one
boundary-block clone; every grant/free is charged to the tenant ledger
so ``tenancy.kv_block_quota`` means resident blocks.

Bitwise compatibility: the paged decode step gathers each row's block
chain into a contiguous (L, R, max_len+1, H, Dh) scratch slab, runs the
same step function as the slab layout on a tensor of the same shape and
strides (so the same kernels run and give the same bits), then scatters
each row's single written position back through its block table. The
gather stands in for a fused paged-attention kernel.

The pools own their tensors and every write is in place (the JAX
package's donated buffers); only the engine thread touches them.

Sacrificial position: the cache is one position longer than ``max_len``.
A batched decode step always runs every pool row; rows that are free, or
pinned to a different model version than the step's params, write their
K/V at position ``max_len`` (block 0 in the paged pool) — a position no
real query attends to. Recycled slots and blocks need no zeroing: every
position a new request attends to was written by its own prefill or
decode first.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rayfed_tpu_torch.models import decode
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.utils import DeviceLike


class KVPool:
    """Fixed pool of ``max_slots`` decode rows over one stacked cache.

    Slot bookkeeping is lock-guarded so ``release`` may be called from
    request completion paths while the engine thread allocates.
    """

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        max_slots: int,
        max_len: int,
        dtype=None,
        *,
        device: DeviceLike = None,
    ):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        # One extra position: the sacrificial write target for junk rows.
        self.junk_pos = max_len
        cache = decode.init_cache(cfg, max_slots, max_len + 1, dtype, device)
        self._k = cache["k"]
        self._v = cache["v"]
        self.device = self._k.device
        self._lock = threading.Lock()
        self._free: List[int] = list(range(max_slots))
        # slot -> (version, prompt bytes) for live donor rows.
        self._prefix: Dict[int, Tuple[int, bytes]] = {}

    @property
    def kv(self):
        """The pool's (k, v) tensors (engine thread only)."""
        return self._k, self._v

    def row(self, slot: int):
        """Slot ``slot``'s (L, 1, max_len+1, H, Dh) views; writes into
        them land in the pool."""
        return self._k[:, slot:slot + 1], self._v[:, slot:slot + 1]

    @property
    def nbytes(self) -> int:
        return (self._k.numel() * self._k.element_size()
                + self._v.numel() * self._v.element_size())

    # -- slot lifecycle --------------------------------------------------

    def acquire(self) -> Optional[int]:
        with self._lock:
            if not self._free:
                return None
            return self._free.pop()

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._free:
                raise ValueError(f"slot {slot} double-released")
            # The freed row's bytes stay intact until re-acquired, but only
            # LIVE rows are donors (a re-prefill would invalidate silently).
            self._prefix.pop(slot, None)
            self._free.append(slot)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    # -- prefix reuse ----------------------------------------------------

    def note_prefix(self, slot: int, version: int, prompt_key: bytes) -> None:
        with self._lock:
            self._prefix[slot] = (version, prompt_key)

    def lookup_prefix(self, version: int, prompt_key: bytes) -> Optional[int]:
        """A live slot prefilled from exactly (version, prompt), if any."""
        with self._lock:
            for slot, key in self._prefix.items():
                if key == (version, prompt_key):
                    return slot
        return None

    def copy_row(self, src: int, dst: int) -> None:
        """Clone donor row ``src`` into ``dst`` (engine thread only)."""
        self._k[:, dst] = self._k[:, src]
        self._v[:, dst] = self._v[:, src]


class PagedKVPool:
    """Block-granular K/V pool: ``max_slots`` logical rows over
    ``num_blocks`` shared physical blocks (+ the sacrificial block 0).

    Block tables live on the host as int32 numpy; each data movement
    ships the tables it needs to the device. Physical block 0 is the junk
    target: ungranted table entries point at it, junk decode rows scatter
    into it, and no real query attends a position that resolves to it.

    Tenant accounting: every fresh block grant charges one ``kv_blocks``
    unit against the constructing job's ledger and every physical free
    releases it. Prefix-shared blocks are charged once.
    """

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        max_slots: int,
        max_len: int,
        dtype=None,
        *,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2")
        if block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.junk_pos = max_len
        self.block_size = int(block_size)
        # The gather slab is (max_len + 1) long, the slab layout's row.
        self.row_len = max_len + 1
        self.blocks_per_row = -(-self.row_len // self.block_size)
        self.num_blocks = (
            int(num_blocks)
            if num_blocks
            else max_slots * self.blocks_per_row
        )
        if self.num_blocks < 1:
            raise ValueError("kv_blocks must be >= 1")
        cache = decode.init_cache(
            cfg, 1 + self.num_blocks, self.block_size, dtype, device
        )
        self._k = cache["k"]
        self._v = cache["v"]
        self.device = self._k.device
        self._lock = threading.Lock()
        self._free_slots: List[int] = list(range(max_slots))
        # pop() hands out low block ids first.
        self._free_blocks: List[int] = list(range(self.num_blocks, 0, -1))
        # Physical block refcounts (prefix sharing); index 0 unused.
        self._refcnt = [0] * (1 + self.num_blocks)
        self._tables = np.zeros(
            (max_slots, self.blocks_per_row), np.int32
        )
        # Granted logical blocks per slot (a contiguous prefix of the
        # table).
        self._granted = [0] * max_slots
        self._prefix: Dict[int, Tuple[int, bytes]] = {}
        from rayfed_tpu_torch.tenancy.context import current_job

        self._job = current_job()

    # -- data movement (engine thread only) ------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def gather(self, tables: np.ndarray):
        """Assemble contiguous (L, R, max_len+1, H, Dh) scratch rows from
        (R, blocks_per_row) tables; each row is bit-identical to the slab
        layout's cache row at every granted position."""
        t = self._dev(tables)
        L, H, Dh = self._k.shape[0], self._k.shape[-2], self._k.shape[-1]
        r, nb = t.shape
        T, bs = self.row_len, self.block_size

        def one(p):
            return p[:, t].reshape(L, r, nb * bs, H, Dh)[:, :, :T].contiguous()

        return one(self._k), one(self._v)

    def gather_slot(self, slot: int):
        """One slot's contiguous (L, 1, max_len+1, H, Dh) row."""
        with self._lock:
            table = self._tables[slot].copy()
        return self.gather(table[None])

    def scatter_step(self, k_slab, v_slab, positions, wblocks, woffs) -> None:
        """Write each row's single position ``positions[r]`` of a step's
        output slab to (``wblocks[r]``, ``woffs[r]``). Junk rows target
        (block 0, offset 0): duplicate writes there are garbage into the
        sacrificial block, never read unmasked."""
        rows = torch.arange(k_slab.shape[1], device=self.device)
        pos = self._dev(positions)
        wb, wo = self._dev(wblocks), self._dev(woffs)
        self._k[:, wb, wo] = k_slab[:, rows, pos]
        self._v[:, wb, wo] = v_slab[:, rows, pos]

    def scatter_slot(self, slot: int, k_row, v_row) -> None:
        """Write a whole (L, 1, max_len+1, H, Dh) row back through
        ``slot``'s table. Ungranted entries resolve to block 0, so their
        positions land in the sacrificial block."""
        with self._lock:
            table = self._tables[slot].copy()
        t = self._dev(table)
        L, T, H, Dh = k_row.shape[0], k_row.shape[2], k_row.shape[3], \
            k_row.shape[4]
        pad = t.shape[0] * self.block_size - T

        def blocks(row):
            row = row[:, 0]
            if pad:
                row = torch.cat([row, row.new_zeros((L, pad, H, Dh))], 1)
            return row.reshape(L, t.shape[0], self.block_size, H, Dh)

        self._k[:, t] = blocks(k_row)
        self._v[:, t] = blocks(v_row)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy physical block ``src`` over block ``dst`` (the prefix-reuse
        boundary clone)."""
        self._k[:, dst] = self._k[:, src]
        self._v[:, dst] = self._v[:, src]

    @property
    def nbytes(self) -> int:
        return (self._k.numel() * self._k.element_size()
                + self._v.numel() * self._v.element_size())

    # -- slot + block lifecycle ------------------------------------------

    def acquire(self) -> Optional[int]:
        with self._lock:
            if not self._free_slots:
                return None
            return self._free_slots.pop()

    def release(self, slot: int) -> None:
        freed = 0
        with self._lock:
            if slot in self._free_slots:
                raise ValueError(f"slot {slot} double-released")
            for i in range(self._granted[slot]):
                blk = int(self._tables[slot, i])
                self._refcnt[blk] -= 1
                if self._refcnt[blk] == 0:
                    self._free_blocks.append(blk)
                    freed += 1
            self._tables[slot] = 0
            self._granted[slot] = 0
            self._prefix.pop(slot, None)
            self._free_slots.append(slot)
        if freed:
            self._ledger_release(freed)

    def ensure_blocks(self, slot: int, pos: int) -> str:
        """Grant blocks so position ``pos`` of ``slot`` is resident.

        Returns ``"ok"``, ``"full"`` (free list empty) or ``"quota"``
        (tenant ledger refused). A partial grant is kept (it covers
        earlier positions and will satisfy a retry), never rolled back.
        """
        needed = pos // self.block_size + 1
        while True:
            with self._lock:
                if self._granted[slot] >= needed:
                    return "ok"
                if not self._free_blocks:
                    return "full"
            # Charge outside the pool lock (the ledger has its own).
            if not self._ledger_charge(1):
                return "quota"
            with self._lock:
                if not self._free_blocks:
                    charged_back = True
                else:
                    charged_back = False
                    blk = self._free_blocks.pop()
                    self._refcnt[blk] = 1
                    self._tables[slot, self._granted[slot]] = blk
                    self._granted[slot] += 1
            if charged_back:
                self._ledger_release(1)
                return "full"

    def _ledger_charge(self, n: int) -> bool:
        from rayfed_tpu_torch.tenancy.qos import TenantQuotaExceeded, get_ledger

        try:
            get_ledger().charge(self._job, "kv_blocks", n)
            return True
        except TenantQuotaExceeded:
            return False

    def _ledger_release(self, n: int) -> None:
        from rayfed_tpu_torch.tenancy.qos import get_ledger

        get_ledger().release(self._job, "kv_blocks", n)

    def table(self, slot: int) -> np.ndarray:
        with self._lock:
            return self._tables[slot].copy()

    def write_target(self, slot: int, pos: int) -> Tuple[int, int]:
        """(physical block, offset) for writing position ``pos``."""
        with self._lock:
            return (
                int(self._tables[slot, pos // self.block_size]),
                pos % self.block_size,
            )

    def granted(self, slot: int) -> int:
        with self._lock:
            return self._granted[slot]

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free_slots)

    @property
    def blocks_free(self) -> int:
        with self._lock:
            return len(self._free_blocks)

    @property
    def blocks_in_use(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free_blocks)

    # -- prefix reuse (block-chain sharing) ------------------------------

    def note_prefix(self, slot: int, version: int, prompt_key: bytes) -> None:
        with self._lock:
            self._prefix[slot] = (version, prompt_key)

    def lookup_prefix(self, version: int, prompt_key: bytes) -> Optional[int]:
        with self._lock:
            for slot, key in self._prefix.items():
                if key == (version, prompt_key):
                    return slot
        return None

    def adopt_prefix(self, donor: int, dst: int, plen: int) -> str:
        """Share the donor's fully-prompt blocks with ``dst`` (refcount
        bump, no data movement) and clone the boundary block when the
        prompt ends mid-block — the donor decodes into its own boundary
        copy, so sharing it would mix sequences. Returns "ok", "full" or
        "quota"; on failure the shares are rolled back and the caller
        falls through to a normal prefill.
        """
        bs = self.block_size
        full = plen // bs
        with self._lock:
            for i in range(full):
                blk = int(self._tables[donor, i])
                self._refcnt[blk] += 1
                self._tables[dst, i] = blk
            self._granted[dst] = full
        if plen % bs == 0:
            return "ok"
        status = self.ensure_blocks(dst, plen - 1)
        if status != "ok":
            with self._lock:
                for i in range(full):
                    blk = int(self._tables[dst, i])
                    self._refcnt[blk] -= 1
                self._tables[dst, :full] = 0
                self._granted[dst] = 0
            return status
        with self._lock:
            src_blk = int(self._tables[donor, full])
            dst_blk = int(self._tables[dst, full])
        self.copy_block(src_blk, dst_blk)
        return "ok"
