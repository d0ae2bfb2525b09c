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

"""The warp-specialised f32 K2 and K3 at D=256
(``rayfed_tpu_torch/csrc/flash_attention_f32_d256.cu``), as far as the CPU
can hold them: the hand-over from the f32 entry points, the shared
memory and register plan in its source, and the fragment orders it reads
its swizzled tiles in, replayed here in numpy against the products they
must give. The kernels themselves run only on a card
(``tests/test_torch_cuda_kernels.py``)."""

import os
import re

import numpy as np
import pytest

import chip_fault_check as fc

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "rayfed_tpu_torch", "csrc")
NAME = "flash_attention_f32_d256.cu"


def _source(name=NAME):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(name):
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", _source())
    return int(value)


def test_f32_entry_points_hand_d256_k2_k3_to_their_own_source():
    f32 = _source("flash_attention_f32.cu")
    assert "rf_f32_d256::dq(" in f32 and "rf_f32_d256::dkv(" in f32
    assert "rf_f32_d256::kernel_info(" in f32
    # The plan before this one (two warps to each group, each computing
    # the group's whole scores) is gone; K1's D=256 plan stays.
    for name in ("kDqF32W256", "kDqF32N256", "kDqF32C256", "kDkvF32W256",
                 "kDkvF32N256", "kDkvF32C256"):
        assert name not in f32
    assert "constexpr int kFwdF32C256 = " in f32


def test_f32_d256_kernels_read_the_grid_head_major():
    # Both kernels take their (b * h, tile) from block_tile, as the bf16
    # D=256 kernels do, and read no grid index of their own.
    text = _source()
    assert text.count("  block_tile(&bh, &tile);\n") == 2
    body = text.split("// Host side")[0]
    assert "blockIdx" not in body
    assert "block_tile(&bh, &t);" in _source("flash_attention_d256.cu")


def test_register_hand_over_and_shared_memory_fit_the_block():
    # 384 threads: the launch holds 168 registers a thread; the producer
    # warpgroup gives up what the consumers take (multiples of 8).
    for prod, cons in (("kDqProducerRegs", "kDqConsumerRegs"),
                       ("kDkvProducerRegs", "kDkvConsumerRegs")):
        p, c = _constant(prod), _constant(cons)
        assert p % 8 == 0 and c % 8 == 0 and 24 <= p and c <= 256
        assert 128 * p + 256 * c <= 168 * 384
    # Two 64-row resident tiles, two stages of two 16-row tiles, the
    # pairs' exchange buffers (4 groups x 2 parities x 2 warps x two
    # 16 x 16 tiles), 2 x 32 lse/delta values, 5 mbarriers and the
    # alignment slack, within the 232,448 bytes a block has.
    m, n, stages = _constant("kM"), _constant("kN"), _constant("kStages")
    assert (m, n, stages) == (64, 16, 2)
    smem = (2 * m * 1024 + stages * 2 * n * 1024
            + (m // 16) * 2 * 2 * 2 * 16 * n * 4 + stages * 2 * n * 4
            + 8 * (1 + 2 * stages) + 1024)
    assert smem == 230696 <= 232448


def test_both_kernels_carry_a_planted_fault_and_share_the_split():
    assert [f[3] for f in fc.FAULTS[NAME]] == ["skip", "skip"]
    text = _source()
    for anchor, _, count, _ in fc.FAULTS[NAME]:
        assert text.count(anchor) == count
    # The split fault lands in the header both f32 sources include: the
    # nearest split of K1 and of the D <= 128 K2/K3, and tf32_lo here.
    split = [f[0] for f in fc.FAULTS["tf32.cuh"]]
    assert len(split) == 2 and "tf32_lo(" in text


# The fragment orders, replayed: a tile of R rows lands as 32-column
# boxes in the 128-byte swizzle (TMA's layout: box c // 32 at float
# (c // 32) R 32, row r's 16-byte chunk j at chunk j ^ (r % 8)).


def _swizzled(tile):
    rows = tile.shape[0]
    out = np.zeros(rows * 256)
    for r in range(rows):
        for c in range(256):
            at = (c // 32) * rows * 32 + r * 32 + (
                (((c % 32) // 4) ^ (r % 8)) << 2) + c % 4
            out[at] = tile[r, c]
    return out


def _mma(d, a, b):
    """d[lane] += A B for m16n8k8 fragments (a[lane]: 4 values, b[lane]:
    2) in mma.sync's lane layout."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
    C = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        d[lane] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                    C[g + 8, 2 * t + 1]]


@pytest.mark.parametrize("half,r0", [(0, 0), (1, 48)])
def test_score_fragments_give_the_half_d_partial_scores(half, r0):
    # scores_half: lane (g, t) loads rows r0 + g, r0 + g + 8 (A) and 8 j +
    # g (B) at columns k0 + t and k0 + t + 4, one float each, from chunks
    # (k0 % 32 / 4) ^ g and + 1. The 16 x 16 partial scores over the half
    # are Q K^T over its 128 columns, and each load hits all 32 banks.
    rng = np.random.default_rng(half)
    q, k = rng.standard_normal((64, 256)), rng.standard_normal((16, 256))
    qb, kb = _swizzled(q), _swizzled(k)
    qh, kh = 4 * half * 64 * 32, 4 * half * 16 * 32  # the half's first box
    s = [np.zeros((32, 4)) for _ in range(2)]
    for k0 in range(0, 128, 8):
        a, b, banks = [], [[], []], set()
        for lane in range(32):
            g, t = divmod(lane, 4)
            c = (k0 % 32) // 4
            x0, x1 = (c ^ g) << 2, ((c + 1) ^ g) << 2
            at = qh + (k0 // 32) * 64 * 32 + (r0 + g) * 32 + t
            a.append([qb[at + x0], qb[at + 8 * 32 + x0], qb[at + x1],
                      qb[at + 8 * 32 + x1]])
            banks.add((at + x0) % 32)
            for j in range(2):
                bt = kh + (k0 // 32) * 16 * 32 + (8 * j + g) * 32 + t
                b[j].append([kb[bt + x0], kb[bt + x1]])
        assert len(banks) == 32
        for j in range(2):
            _mma(s[j], a, b[j])
    want = q[r0:r0 + 16, 128 * half:128 * half + 128] \
        @ k[:, 128 * half:128 * half + 128].T
    got = np.zeros((16, 16))
    for j in range(2):
        for lane in range(32):
            g, t = divmod(lane, 4)
            c0 = 8 * j + 2 * t
            got[g, c0], got[g, c0 + 1], got[g + 8, c0], got[g + 8, c0 + 1] \
                = s[j][lane]
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("box0,cols", [(0, 128), (4, 128), (0, 256)])
def test_output_fragments_give_p_m(box0, cols):
    # pv<cols>: P (16 x 16, from accumulators, k relabelled: A's column t
    # is key 2t, t + 4 is 2t + 1) times M's columns from box box0 (K2: a
    # half of dQ's; K3: all of dV's or dK's); lane (g, t) loads rows 8 j +
    # 2t and 8 j + 2t + 1, column 8 i + g, one float each, from chunk
    # (2 i % 8 + g / 4) ^ (row % 8): all 32 banks a load.
    rng = np.random.default_rng(7 + box0 + cols)
    p, m = rng.standard_normal((16, 16)), rng.standard_normal((16, 256))
    mb = _swizzled(m)
    base = box0 * 16 * 32
    a = []
    for j in range(2):
        frag = []
        for lane in range(32):
            g, t = divmod(lane, 4)
            acc = [p[g, 8 * j + 2 * t], p[g, 8 * j + 2 * t + 1],
                   p[g + 8, 8 * j + 2 * t], p[g + 8, 8 * j + 2 * t + 1]]
            frag.append([acc[0], acc[2], acc[1], acc[3]])  # frag_acc
        a.append(frag)
    got = np.zeros((16, cols))
    for i in range(cols // 8):
        part = np.zeros((32, 4))
        for j in range(2):
            b, banks = [], set()
            for lane in range(32):
                g, t = divmod(lane, 4)
                x = base + (i // 4) * 16 * 32 + (8 * j + 2 * t) * 32 + g % 4
                c = (2 * i) % 8 + g // 4
                at0, at1 = x + ((c ^ (2 * t)) << 2), \
                    x + 32 + ((c ^ (2 * t + 1)) << 2)
                b.append([mb[at0], mb[at1]])
                banks.add(at0 % 32)
            assert len(banks) == 32
            _mma(part, a[j], b)
        for lane in range(32):
            g, t = divmod(lane, 4)
            got[g, 8 * i + 2 * t:8 * i + 2 * t + 2] = part[lane][:2]
            got[g + 8, 8 * i + 2 * t:8 * i + 2 * t + 2] = part[lane][2:]
    np.testing.assert_allclose(got, p @ m[:, 32 * box0:32 * box0 + cols],
                               atol=1e-12)
