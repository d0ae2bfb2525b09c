// Copyright 2026 The rayfed-tpu Authors.
//
// Licensed under the Apache License, Version 2.0 (the "License");
// you may not use this file except in compliance with the License.
// You may obtain a copy of the License at
//
//     http://www.apache.org/licenses/LICENSE-2.0
//
// Unless required by applicable law or agreed to in writing, software
// distributed under the License is distributed on an "AS IS" BASIS,
// WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
// See the License for the specific language governing permissions and
// limitations under the License.

// Causal flash attention in exact f32 for Hopper (sm_90a) at head dim 256:
// the dQ pass and the dK/dV pass, warp-specialised. They replace, at
// D = 256, the Pallas TPU kernels of rayfed_tpu/ops/flash_attention.py:
//   flash_bwd_dq_f32_kernel<256>  <- _flash_bwd_dq_kernel   (K2)
//   flash_bwd_dkv_f32_kernel<256> <- _flash_bwd_dkv_kernel  (K3)
// (K1 at D = 256, and K1-K3 at D <= 128, are flash_attention_f32.cu's.)
// The contract is flash_attention_f32.cu's: scale D**-0.5 (the true D when
// the wrapper zero-pads D 136-255 to 256), causal with query positions
// shifted by q_offset, masked scores -1e30, each f32 product as three TF32
// mma.sync products, corrections first (tf32.cuh; the operands split by
// truncation, tf32_lo, with the bound that file's header states for these
// two kernels), each step's products in a fresh accumulator joined to dQ,
// dK and dV by an f32 add, delta = rowsum(dO * O) an FFMA sum in K2's
// prologue, no atomics (two launches give the same bits).
//
// What bounds them: the three TF32 products of every f32 product (bound
// 3 x FLOP / 495 TFLOP/s, wgmma's rate). mma.sync, which takes its
// operands split in registers, runs TF32 at 323 TFLOP/s at most on the
// H100 (chip_tile_sweep.py mma), and only with four or more independent
// accumulator chains a scheduler. A 16-row f32 accumulator 256 wide is
// 128 registers a thread, so two warps share each 16-row group: in K2
// each holds half of dQ's columns (64 registers), in K3 one holds dV and
// the other dK (128). The plan before this one had each warp of a pair
// compute the group's whole S and dP itself (the pair's scores twice).
// Here each warp computes the group's scores over its half of D only
// (kHalf columns), and the pair sums the two partial tiles through shared
// memory behind a named barrier of its 64 threads: every score is
// computed once, and the group's tensor-core work a step is one S, one dP
// and one output product (K3 two) instead of K2's 5/3 and K3's 1.5 times
// that.
//
// Both kernels take one shape: a block of three warpgroups. Warpgroup 0 is
// the producer: it gives up its registers (setmaxnreg.dec) and keeps TMA
// copies in flight into a two-stage ring of kN-row stages, each with a
// full and an empty mbarrier; its first warp also stores K3's lse and
// delta. Warpgroups 1 and 2 are the consumers (setmaxnreg.inc): 8 warps,
// 4 row groups of 16 rows. A consumer warp waits only on the stage it
// needs and on its partner, never on a block-wide barrier, so the row
// groups drift apart and hide each other's waits. Tiles land as 32-column
// (128-byte) boxes in the 128-byte swizzle (tma.cuh), in which the
// fragment reads below hit 32 different banks. The grid is read
// head-major (block_tile), heaviest tile of a head first.
//
// Shared memory: two 64-row resident tiles (64 KiB each), two stages of two
// 16-row streamed tiles (16 KiB each), and the pairs' exchange buffers (a
// warp's two 1 KiB partial tiles, two parities so that one barrier a step
// suffices: 32 KiB), 224 KiB of the 227 a block has. A third stage, or
// 32-row stages, would need 32 KiB more.
//
// K2: one block per (b * h, 64-query tile), Q and dO resident; per 16-key
// stage (K, V) S = Q K^T and dP = dO V^T (half-D partials, summed), P =
// exp(S scale - lse) and dS = P (dP - delta) scale, dQ[:, half] += dS K.
// K3: one block per (b * h, 64-key tile), K and V resident; per 16-query
// stage (Q, dO, lse, delta) from the first that reaches the tile's
// diagonal, S^T = K Q^T and dP^T = V dO^T (half-D partials, summed), P^T
// and dS^T, dV += P^T dO (warp 0 of a pair) and dK += dS^T Q (warp 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_f32_d256.cuh"
#include "tf32.cuh"
#include "tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Tile plan
// ---------------------------------------------------------------------------

constexpr int kD = 256;
constexpr int kHalf = kD / 2;  // output columns (and score terms) a warp owns
constexpr int kM = 64;         // resident rows a block: 4 groups of 16
constexpr int kN = 16;         // streamed rows a ring stage
constexpr int kStages = 2;
constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kRowBytes = kD * 4;
constexpr int kResBytes = kM * kRowBytes;
constexpr int kStreamBytes = kN * kRowBytes;
// A warp's slot of an exchange buffer: its partial S and dP tiles, as
// float4s, lane-major.
constexpr int kXWarp = 2 * (kN / 8) * 32;
constexpr int kRingOff = 2 * kResBytes;
constexpr int kXOff = kRingOff + kStages * 2 * kStreamBytes;
constexpr int kStatOff = kXOff + (kM / 16) * 2 * 2 * kXWarp * 16;
constexpr int kBarOff = kStatOff + kStages * 2 * kN * 4;  // K3's lse, delta
constexpr size_t kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
static_assert(kSmem <= 232448, "the ring passes a block's 227 KB");
// Registers a thread of the producer gives up to, and each consumer's:
// 128 x prod + 256 x cons may not pass the 168 x 384 the launch holds.
constexpr int kDqProducerRegs = 24;
constexpr int kDqConsumerRegs = 240;
constexpr int kDkvProducerRegs = 24;
constexpr int kDkvConsumerRegs = 240;

// The tensor maps of a launch: (D, H, S, B) views of q, k, v and dout.
struct TmaF32 {
  CUtensorMap q, k, v, d;
};

// Rows [row0, row0 + R) of head h, batch b: eight 32-column boxes.
template <int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int h,
                                         int b) {
  tma_boxes<R, kD / 32>(dst, map, bar, row0, h, b, 32);
}

// ---------------------------------------------------------------------------
// Fragments of swizzled f32 tiles
// ---------------------------------------------------------------------------

// An R-row tile is 8 boxes of 32 columns, box c / 32 at float (c / 32) R
// 32; in a box, row r's 16-byte chunk j sits at chunk j ^ (r % 8). Every
// fragment value is a 4-byte load of its own, straight into its fragment
// register (16-byte loads would take a move for each value the fragment
// wants elsewhere, and those moves cost more than the loads: PERF.md):
// in the scores (A B^T), A's rows r0 + g and r0 + g + 8 and B's row 8 j
// + g at columns k0 + t and k0 + t + 4, chunks (k0 % 32 / 4) ^ g and + 1;
// in the output products (P M, P from registers), M's rows 2t and 2t + 1
// of the k8 slice (the relabelled order) at column 8 i + g, chunks
// (2 i % 8 + g / 4) ^ 2t and ^ (2t + 1). Each load's 32 lanes hit 32
// banks. Every value, of a tile or of P or dS, goes to the products as
// hi = x itself and lo = tf32_lo(x).

__device__ __forceinline__ void split_raw(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = tf32_lo(x);
}

// s[j] = A[r0 + i] . B[8 j + n] over kHalf columns (i < 16, n < 8, j <
// kN / 8): a warp's partial scores over its half of D, the resident tile
// A (kM rows) and the streamed B (kN rows) from the half's first box.
__device__ __forceinline__ void scores_half(const float* A, const float* B,
                                            int r0, float (&s)[kN / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int k0 = 0; k0 < kHalf; k0 += 8) {
    // Columns k0 + t and k0 + t + 4: chunks c and c + 1 of box k0 / 32,
    // in rows whose r % 8 is g.
    const int c = (k0 % 32) / 4;
    // (c ^ g) << 2 as an immediate XOR a per-thread value, which ptxas
    // recomputes where it would keep each offset in a register.
    const int x0 = (c << 2) ^ (g << 2), x1 = ((c + 1) << 2) ^ (g << 2);
    const float* a = A + (k0 / 32) * kM * 32 + (r0 + g) * 32 + t;
    uint32_t a_hi[4], a_lo[4], b_hi[kN / 8][2], b_lo[kN / 8][2];
    split_raw(a[x0], a_hi[0], a_lo[0]);
    split_raw(a[8 * 32 + x0], a_hi[1], a_lo[1]);
    split_raw(a[x1], a_hi[2], a_lo[2]);
    split_raw(a[8 * 32 + x1], a_hi[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float* b = B + (k0 / 32) * kN * 32 + (8 * j + g) * 32 + t;
      split_raw(b[x0], b_hi[j][0], b_lo[j][0]);
      split_raw(b[x1], b_hi[j][1], b_lo[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      mma_f32(s[j], a_hi, a_lo, b_hi[j], b_lo[j]);
    }
  }
}

// acc[i] += P M[:, 8 i .. 8 i + 7] (i < kCols / 8): P a warp's 16 x kN
// accumulator tiles, M a kN-row streamed tile from the first box of the
// warp's kCols output columns; one k8 slice per accumulator tile of P. acc
// sums over the whole sequence, so the step's products go into a fresh
// accumulator and join acc by an f32 add.
template <int kCols>
__device__ __forceinline__ void pv(const float (&p)[kN / 8][4],
                                   const float* M,
                                   float (&acc)[kCols / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // P's accumulator tiles as A fragments (frag_acc's relabelled order),
  // hi = P itself.
  uint32_t a_hi[kN / 8][4], a_lo[kN / 8][4];
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_raw(p[j][e == 1 ? 2 : e == 2 ? 1 : e], a_hi[j][e], a_lo[j][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i) {
    float part[4] = {};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      // Rows 8 j + 2t and 8 j + 2t + 1 (the relabelled order), column
      // 8 i + g: chunk 2 i % 8 + g / 4 of box i / 4.
      const float* x = M + (i / 4) * kN * 32 + (8 * j + 2 * t) * 32 + g % 4;
      // (2 i % 8 + g / 4) ^ 2t = (2 i % 8) ^ (g / 4 ^ 2t): an immediate
      // and a per-thread value.
      const int k4 = ((g / 4) ^ (2 * t)) << 2;
      uint32_t b_hi[2], b_lo[2];
      split_raw(x[(((2 * i) % 8) << 2) ^ k4], b_hi[0], b_lo[0]);
      split_raw(x[32 + ((((2 * i) % 8) << 2) ^ k4 ^ 4)], b_hi[1], b_lo[1]);
      mma_f32(part, a_hi[j], a_lo[j], b_hi, b_lo);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[i][x] += part[x];
  }
}

// The pair's sum of its partial scores: each warp stores its partial s
// and dp in its slot (`mine`), the pair meets at named barrier `bar` (64
// threads), and each adds the other warp's (`other`; thread for thread,
// the same fragment elements). Both end with the same sums, since f32
// addition commutes. The caller alternates two buffers by step parity: a
// warp writes a slot again only two steps on, after the barrier of the
// step between, which its partner passes only once it has read the slot.
__device__ __forceinline__ void pair_sum(float (&s)[kN / 8][4],
                                         float (&dp)[kN / 8][4], float4* mine,
                                         const float4* other, int bar) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    mine[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    mine[(kN / 8 + j) * 32 + lane] =
        make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
  }
  asm volatile("bar.sync %0, 64;\n" :: "r"(bar) : "memory");
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const float4 x = other[j * 32 + lane];
    const float4 y = other[(kN / 8 + j) * 32 + lane];
    s[j][0] += x.x; s[j][1] += x.y; s[j][2] += x.z; s[j][3] += x.w;
    dp[j][0] += y.x; dp[j][1] += y.y; dp[j][2] += y.z; dp[j][3] += y.w;
  }
}

// The block's shared memory, from its 1024-byte aligned base: the two
// resident tiles, the ring (stage s: two streamed tiles), the exchange
// buffers, K3's lse and delta a stage, the mbarriers (resident tiles
// full, then full and empty a stage).
struct Smem {
  uint32_t base;
  unsigned char* ptr;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    base = (smem_u32(raw) + 1023) & ~1023u;
    ptr = raw + (base - smem_u32(raw));
  }
  __device__ __forceinline__ const float* res(int i) const {
    return reinterpret_cast<const float*>(ptr + i * kResBytes);
  }
  __device__ __forceinline__ const float* stream(int st, int i) const {
    return reinterpret_cast<const float*>(
        ptr + kRingOff + (2 * st + i) * kStreamBytes);
  }
  __device__ __forceinline__ uint32_t res_u32(int i) const {
    return base + i * kResBytes;
  }
  __device__ __forceinline__ uint32_t stream_u32(int st, int i) const {
    return base + kRingOff + (2 * st + i) * kStreamBytes;
  }
  // Warp `half` of row group `grp`'s slot, at step parity `par`.
  __device__ __forceinline__ float4* xslot(int grp, int par, int half) const {
    return reinterpret_cast<float4*>(ptr + kXOff) +
           ((grp * 2 + par) * 2 + half) * kXWarp;
  }
  __device__ __forceinline__ float* stats(int st) const {
    return reinterpret_cast<float*>(ptr + kStatOff) + st * 2 * kN;
  }
  __device__ __forceinline__ uint32_t res_full() const {
    return base + kBarOff;
  }
  __device__ __forceinline__ uint32_t full(int st) const {
    return base + kBarOff + 8 * (1 + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return base + kBarOff + 8 * (1 + kStages + st);
  }
  // Thread 0: the barriers, `full_count` arrivals a stage's fill.
  __device__ __forceinline__ void init(uint32_t full_count) const {
    if (threadIdx.x == 0) {
      mbar_init(res_full(), 1);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(s), full_count);
        mbar_init(empty(s), 8);  // one arrival a consumer warp
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// K2: the dQ pass
// ---------------------------------------------------------------------------

// One block per (b * h, 64-query tile) (block_tile), the last query tiles
// first; the key steps at or below the block's last query.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ TmaF32 tm, const Params p) {
  static_assert(D == kD, "the D = 256 plan");
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  int bh, tile;
  block_tile(&bh, &tile);
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - tile) * kM;
  const int block_last = p.q_offset + min(q0 + kM, p.Sq) - 1;
  const int n_kt = min(block_last / kN + 1, (p.Sk + kN - 1) / kN);
  sm.init(1);

  if (threadIdx.x < kWgThreads) {
    reg_dealloc<kDqProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.res_full(), 2 * kResBytes);
      tma_tile<kM>(sm.res_u32(0), &tm.q, sm.res_full(), q0, h, b);
      tma_tile<kM>(sm.res_u32(1), &tm.d, sm.res_full(), q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        // The first pass finds every stage free (the parity before phase 0).
        mbar_wait(sm.empty(st), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(sm.full(st), 2 * kStreamBytes);
        tma_tile<kN>(sm.stream_u32(st, 0), &tm.k, sm.full(st), kt * kN, h, b);
        tma_tile<kN>(sm.stream_u32(st, 1), &tm.v, sm.full(st), kt * kN, h, b);
      }
    }
    return;
  }
  reg_alloc<kDqConsumerRegs>();

  const int cw = threadIdx.x / 32 - 4;  // consumer warp 0 .. 7
  const int grp = cw / 2, half = cw % 2;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = grp * 16;        // this group's first row
  const int c0 = half * kHalf;    // and this warp's first output column
  const float* dout = p.dout + b * p.do_sb + h * p.do_sh;

  // lse and delta = rowsum(dO * O) (f32 FFMA) of this thread's rows r0 + g
  // and r0 + g + 8, while the tiles land: the four lanes of a quad sum
  // every fourth float4 of a row and join by two shuffles. Rows past Sq
  // take 0.
  float lse[2], delta[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g + 8 * e;
    const bool valid = row < p.Sq;
    float sum = 0.f;
    if (valid) {
      const float* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
      const float* drow = dout + row * p.do_ss;
      for (int c = 4 * t; c < kD; c += 16) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        sum += y.x * x.x + y.y * x.y + y.z * x.z + y.w * x.w;
      }
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const long long at = ((long long)b * p.Sq + row) * p.H + h;
    delta[e] = sum;
    lse[e] = valid ? p.lse_in[at] : 0.f;
    if (valid && t == 0 && half == 0) p.stat_out[at] = sum;
  }

  // This group's first and last query positions.
  const int q_first = p.q_offset + q0 + r0;
  const int q_last = p.q_offset + min(q0 + r0 + 15, p.Sq - 1);
  const int box0 = half * (kHalf / 32);  // this warp's first column box
  const float* Qh = sm.res(0) + box0 * kM * 32;
  const float* DOh = sm.res(1) + box0 * kM * 32;
  float dq[kHalf / 8][4] = {};
  mbar_wait(sm.res_full(), 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * kN;
    mbar_wait(sm.full(st), (kt / kStages) & 1);
    // A group whose rows lie past Sq, or all before this step's first key,
    // has nothing to add; both warps of the pair skip together.
    if (q0 + r0 < p.Sq && k0 <= q_last) {
      const float* Kh = sm.stream(st, 0) + box0 * kN * 32;
      const float* Vh = sm.stream(st, 1) + box0 * kN * 32;
      float s[kN / 8][4] = {}, dp[kN / 8][4] = {};
      scores_half(Qh, Kh, r0, s);
      scores_half(DOh, Vh, r0, dp);
      pair_sum(s, dp, sm.xslot(grp, kt & 1, half),
               sm.xslot(grp, kt & 1, half ^ 1), 1 + grp);
      // Mask only a step that crosses the group's diagonal or the end of
      // the keys.
      const bool masked = k0 + kN - 1 > q_first || k0 + kN > p.Sk;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          const int q_pos = q_first + g + 8 * (e >> 1);
          float pr = expf(s[j][e] * p.scale - lse[e >> 1]);
          if (masked && (k_pos > q_pos || k_pos >= p.Sk)) pr = 0.f;
          s[j][e] = pr * (dp[j][e] - delta[e >> 1]) * p.scale;  // dS
        }
      }
      pv<kHalf>(s, Kh, dq);
    }
    release_stage(sm.empty(st));
  }

  const long long o_ss = (long long)p.H * kD;
  float* dqb = p.out0 + (long long)b * p.Sq * o_ss + (long long)h * kD;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g + 8 * e;
    if (row < p.Sq) {
#pragma unroll
      for (int i = 0; i < kHalf / 8; ++i) {
        *reinterpret_cast<float2*>(dqb + row * o_ss + c0 + 8 * i + 2 * t) =
            make_float2(dq[i][2 * e], dq[i][2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the dK/dV pass
// ---------------------------------------------------------------------------

// One block per (b * h, 64-key tile) (block_tile), the first key tiles
// first; the query steps from the first that reaches the tile's first key.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ TmaF32 tm, const Params p) {
  static_assert(D == kD, "the D = 256 plan");
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  int bh, tile;
  block_tile(&bh, &tile);
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = tile * kM;
  // Query rows below k0 - q_offset see none of these keys.
  const int qt0 = max(0, k0 - p.q_offset) / kN;
  const int n = max(0, (p.Sq + kN - 1) / kN - qt0);  // query steps
  sm.init(32);  // a fill: the producer warp's 32 lanes

  if (threadIdx.x < kWgThreads) {
    reg_dealloc<kDkvProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32 && n > 0) {
      if (lane == 0) {
        mbar_expect_tx(sm.res_full(), 2 * kResBytes);
        tma_tile<kM>(sm.res_u32(0), &tm.k, sm.res_full(), k0, h, b);
        tma_tile<kM>(sm.res_u32(1), &tm.v, sm.res_full(), k0, h, b);
      }
      // Lane l stores lse (l < kN) or delta (l >= kN) of row l % kN.
      const float* src = (lane < kN ? p.lse_in : p.delta_in) +
                         (long long)b * p.Sq * p.H + h;
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const int q0 = (qt0 + i) * kN;
        const int row = q0 + lane % kN;
        mbar_wait(sm.empty(st), ((i / kStages) & 1) ^ 1);
        sm.stats(st)[lane] = row < p.Sq ? src[(long long)row * p.H] : 0.f;
        if (lane == 0) {
          mbar_expect_tx(sm.full(st), 2 * kStreamBytes);
          tma_tile<kN>(sm.stream_u32(st, 0), &tm.q, sm.full(st), q0, h, b);
          tma_tile<kN>(sm.stream_u32(st, 1), &tm.d, sm.full(st), q0, h, b);
        } else {
          mbar_arrive(sm.full(st));
        }
      }
    }
    return;
  }
  reg_alloc<kDkvConsumerRegs>();

  const int cw = threadIdx.x / 32 - 4;  // consumer warp 0 .. 7
  const int grp = cw / 2, half = cw % 2;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = grp * 16;        // this group's first key row
  const int k_first = k0 + r0;    // and first key
  const int box0 = half * (kHalf / 32);
  const float* Kh = sm.res(0) + box0 * kM * 32;
  const float* Vh = sm.res(1) + box0 * kM * 32;
  // Warp 0 of a pair holds the group's dV, warp 1 its dK, all 256 columns
  // each: one output product a warp, with only the operand it reads live
  // (P^T, or dS^T).
  const bool holds_dv = half == 0;
  float acc[kD / 8][4] = {};
  if (n > 0) mbar_wait(sm.res_full(), 0);

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int q0 = (qt0 + i) * kN;
    mbar_wait(sm.full(st), (i / kStages) & 1);
    // A group whose keys lie past Sk, or all past this step's last query,
    // has nothing to add; both warps of the pair skip together.
    if (k_first < p.Sk && p.q_offset + q0 + kN - 1 >= k_first) {
      const float* Qs = sm.stream(st, 0);
      const float* DOs = sm.stream(st, 1);
      const float* Qh = Qs + box0 * kN * 32;
      const float* DOh = DOs + box0 * kN * 32;
      const float* lse = sm.stats(st);
      const float* delta = lse + kN;
      float s[kN / 8][4] = {}, dp[kN / 8][4] = {};
      scores_half(Kh, Qh, r0, s);    // S^T
      scores_half(Vh, DOh, r0, dp);  // dP^T
      pair_sum(s, dp, sm.xslot(grp, i & 1, half),
               sm.xslot(grp, i & 1, half ^ 1), 1 + grp);
      // Mask only a step that crosses the group's diagonal or the end of
      // the queries.
      const bool masked = k_first + 15 > p.q_offset + q0 || q0 + kN > p.Sq;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);  // the query's stage row
          const int k_pos = k_first + g + 8 * (e >> 1);
          float pr = expf(s[j][e] * p.scale - lse[c]);
          if (masked && (q0 + c >= p.Sq || p.q_offset + q0 + c < k_pos)) {
            pr = 0.f;
          }
          // P^T, or dS^T = P^T (dP^T - delta) scale.
          s[j][e] = holds_dv ? pr : pr * (dp[j][e] - delta[c]) * p.scale;
        }
      }
      // dV += P^T dO, or dK += dS^T Q (one copy of the product's code).
      pv<kD>(s, holds_dv ? DOs : Qs, acc);
    }
    release_stage(sm.empty(st));
  }

  const long long o_ss = (long long)p.H * kD;
  float* out = (holds_dv ? p.out1 : p.out0) + (long long)b * p.Sk * o_ss +
               (long long)h * kD;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = k_first + g + 8 * e;
    if (row < p.Sk) {
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        *reinterpret_cast<float2*>(out + row * o_ss + 8 * i + 2 * t) =
            make_float2(acc[i][2 * e], acc[i][2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The tensor map of an f32 (B, S, H, 256) tensor (tma.cuh's, in boxes of
// 32 columns x `rows` rows). Returns 0 or kBadTensorMap.
int encode(CUtensorMap* map, const void* ptr, const Params& p, long long S,
           long long sb, long long ss, long long sh, int rows) {
  return encode_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kD, p.B, S,
                    p.H, sb, ss, sh, rows) ? 0 : kBadTensorMap;
}

const void* const kDqFn = (const void*)flash_bwd_dq_f32_kernel<kD>;
const void* const kDkvFn = (const void*)flash_bwd_dkv_f32_kernel<kD>;

int launch(const void* fn, int seq, const TmaF32& tm, const Params& p,
           void* stream) {
  int err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err) return err;
  // The kernels read the grid's linear index head-major (block_tile).
  const dim3 grid(p.B * p.H, (seq + kM - 1) / kM);
  void* args[] = {(void*)&tm, (void*)&p};
  err = (int)cudaLaunchKernel(fn, grid, dim3(kThreads), args, kSmem,
                              (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

namespace rf_f32_d256 {

int kernel_info(int which, const void** fn, int* threads, int* rows,
                size_t* smem) {
  if (which != 1 && which != 2) return kBadKernel;
  *fn = which == 1 ? kDqFn : kDkvFn;
  *threads = kThreads;
  *rows = kM;
  *smem = kSmem;
  return 0;
}

int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* dq, void* delta,
       const long long* dims, float scale, void* stream) {
  Params p = make_params(dims, scale);
  p.o = (const float*)o;
  p.dout = (const float*)dout;
  p.lse_in = (const float*)lse;
  p.out0 = (float*)dq;
  p.stat_out = (float*)delta;
  TmaF32 tm = {};
  int err = encode(&tm.q, q, p, p.Sq, p.q_sb, p.q_ss, p.q_sh, kM);
  if (!err) err = encode(&tm.d, dout, p, p.Sq, p.do_sb, p.do_ss, p.do_sh, kM);
  if (!err) err = encode(&tm.k, k, p, p.Sk, p.k_sb, p.k_ss, p.k_sh, kN);
  if (!err) err = encode(&tm.v, v, p, p.Sk, p.v_sb, p.v_ss, p.v_sh, kN);
  if (err) return err;
  return launch(kDqFn, p.Sq, tm, p, stream);
}

int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv,
        const long long* dims, float scale, void* stream) {
  Params p = make_params(dims, scale);
  p.lse_in = (const float*)lse;
  p.delta_in = (const float*)delta;
  p.out0 = (float*)dk;
  p.out1 = (float*)dv;
  TmaF32 tm = {};
  int err = encode(&tm.k, k, p, p.Sk, p.k_sb, p.k_ss, p.k_sh, kM);
  if (!err) err = encode(&tm.v, v, p, p.Sk, p.v_sb, p.v_ss, p.v_sh, kM);
  if (!err) err = encode(&tm.q, q, p, p.Sq, p.q_sb, p.q_ss, p.q_sh, kN);
  if (!err) err = encode(&tm.d, dout, p, p.Sq, p.do_sb, p.do_ss, p.do_sh, kN);
  if (err) return err;
  return launch(kDkvFn, p.Sk, tm, p, stream);
}

}  // namespace rf_f32_d256
