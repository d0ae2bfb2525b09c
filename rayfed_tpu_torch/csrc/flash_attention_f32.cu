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

// Causal flash attention in exact f32 for Hopper (sm_90a): forward, dQ
// pass, dK/dV pass.
//
// The Pallas TPU kernels of rayfed_tpu/ops/flash_attention.py take bf16 or
// f32 inputs; flash_attention.cu holds their bf16 counterparts, this file
// the f32 ones:
//   flash_fwd_f32_kernel     <- _flash_kernel          (K1)
//   flash_bwd_dq_f32_kernel  <- _flash_bwd_dq_kernel   (K2)
//   flash_bwd_dkv_f32_kernel <- _flash_bwd_dkv_kernel  (K3)
//
// Contract (the bf16 kernels' and the plain PyTorch versions' in
// rayfed_tpu_torch/ops/flash_attention.py): q is (B, Sq, H, D), k/v
// (B, Sk, H, D), dout (B, Sq, H, D), f32, read through their (b, s, h)
// element strides with a unit stride on D; scale = D**-0.5; causal with
// query positions shifted by q_offset; masked scores are -1e30 (not -inf);
// l is clamped at 1e-30. In f32 the reference's casts of P and dS to the
// storage dtype are no-ops, so nothing is rounded between the products.
// Outputs are contiguous: o/dq/dk/dv (B, S, H, D) f32, lse/delta (B, Sq, H)
// f32. dQ's kernel also computes delta = rowsum(dO * O), as the bf16 one
// does.
//
// What bounds them on this card: at the main path's shape every kernel
// does ~S/2 multiply-adds per byte it must move, so they are bound by
// operations, and exact f32 leaves two routes: FFMA on the CUDA cores
// (67 TFLOP/s), or each product split into three TF32 products on the
// tensor cores (3 x FLOP / 495 TFLOP/s, the faster bound). No score tile
// reaches device memory, and there are no atomics: dQ and dK/dV are two
// passes, so the gradients are deterministic as in the reference.
//
// All three take the second route. FFMA caps a kernel at 67 TFLOP/s,
// and an FFMA loop fed from shared memory gets 2-3 FMAs per word it
// reads, far less. Here each operand value x is split as hi = x rounded
// to TF32 (to nearest) and lo = x - hi (exact in f32, read by the tensor
// core as TF32), and each product a b runs as lo(a) hi(b) + hi(a) lo(b) +
// hi(a) hi(b), the two corrections issued into the f32 accumulator before
// the large one (as CUTLASS's OpMultiplyAddFastF32 does); the dropped
// lo(a) lo(b) term is below 2^-22 of the product, so the sums keep f32's
// digits where one TF32 product keeps three. K2 and K3 at D = 256
// (flash_attention_f32_d256.cu) split otherwise: hi = x itself, which the
// tensor core reads truncated to TF32, and lo = x - hi read truncated in
// turn, so each operand reaches the product within 2^-20 |x|, toward
// zero, and the dropped term is below 2^-20 of the product: two
// operations a value where the nearest split takes three, 9-11 % faster
// on an H100, every reading still within the exact-f32 limit (PERF.md).
// Every product is split: S,
// then acc += P V (K1); S and dP, then dQ += dS K (K2); S^T and dP^T,
// then dV += P^T dO and dK += dS^T Q (K3), the register operands P and dS
// too. The tensor core's f32 accumulation does not round to nearest, so
// each step's products go into a fresh accumulator and join O's
// accumulator, dQ, dK and dV by an f32 add (in K1, acc = acc alpha +
// part, the reference's own expression). delta stays an FFMA row sum in
// K2's prologue.
//
// The products are mma.sync m16n8k8 (tf32 in, f32 accumulate), not wgmma.
// tf32 wgmma reads a shared-memory operand only K-major (its transpose
// flags exist for 16-bit types only), and each operand would have to be
// stored twice, as a hi tile and a lo tile. K1's S = Q K^T would fit (K's
// tile is K-major for it), but its P V does not: V's tile has D
// contiguous, which makes it MN-major for that product, and a transposed
// V copy as hi and lo tiles does not fit beside the ring. K3 would hold K
// and V as hi/lo plus Q and dO as hi/lo in both layouts (row-major for
// S^T = K Q^T and dP^T = V dO^T, transposed for P^T dO and dS^T Q),
// 393,216 B at 64 x 128 tiles, and K2 K in both layouts, 327,680 B, where
// a block has 232,448 B. mma.sync takes its fragments from registers:
// each thread reads its fragment elements from an f32 tile in shared
// memory, in whichever order the product needs (a transpose is
// addressing), and splits them in registers.
//
// A block of kW warps owns 16 kW resident rows, 16 a warp (the m16 of its
// products; in K1 at D = 256, below, kC warps to each 16):
// queries in K1; queries with their dO, lse and delta in K2; keys with
// their values in K3. Every tile is raw f32, split at every read (K1's Q
// split once, as it lands, into {hi, lo} pairs, was slower: PERF.md).
// The other side streams through a two-stage cp.async ring of kN-row
// tiles (K1 and K2: K and V; K3: Q, dO, lse and delta), 16-byte copies
// that zero-fill ragged rows, so the copy of step i+1 runs under the
// products of step i, with one barrier when a stage lands and one when
// it is free. S and dP come out
// of the mma in registers; the online softmax (K1: the running max and
// sum of a row over the 4 lanes of a quad, two shuffles each), P and dS
// are formed there and go straight back as the A operand of the second
// product. The m16n8 accumulator gives a thread columns 2t and 2t+1 of
// each n8 tile (t = lane % 4, g = lane / 4), where the tf32 A fragment
// wants columns t and t+4 of a k8 slice: instead of shuffling, the k
// order is relabelled (A's column t is key 2t, t+4 is key 2t+1) and the B
// fragment reads its rows in that same order, since a sum over k does not
// care. No score, P or dS tile goes through shared memory. Every tile has
// a row stride of D + 4 floats: the row-wise fragment reads hit banks
// 4 g + t and, in the relabelled order, the column-wise ones (rows 2t,
// 2t+1, column g) banks 8 t + g, so both orders are free of bank
// conflicts with no swizzle. K1 and K2 run the last query tiles first, K3
// the first key tiles first (they see the most keys or queries), and a
// warp skips a step that lies wholly on the masked side of its diagonal;
// K1 and K2 mask only a step that crosses the warp's diagonal or the end
// of the keys.
//
// That is the plan for head dims 16, 32, 64 and 128. K1 has one of its
// own at D = 256 (kFwdF32W256 .. kFwdF32C256): a 16-row f32 accumulator
// 256 wide is 128 registers a thread, and a 128-row tile at row stride 260
// floats is 133,120 B, so two of them and a ring of 32-row stages pass the
// 232,448 B a block has. K1 keeps one warp a row group, 8 warps (128
// queries, 128-register O accumulators, 255 registers, no spill) against
// 16-row stages, 199,680 B; chip_tile_sweep.py timed two warps a group
// (kFwdF32C256 = 2, each owning half of the output columns) 1.35x slower
// (PERF.md). K2 and K3 at D = 256 are warp-specialised kernels of their
// own (flash_attention_f32_d256.cu: a TMA producer warpgroup, two warps to
// each 16-row group summing half-D partial scores), to which the C entry
// points below hand that head dim. The split and the TF32 products all of
// them use are in tf32.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_attention_f32_d256.cuh"
#include "tf32.cuh"

namespace {

template <int D>
struct Cfg {
  static constexpr int kLD = D + 4;  // row stride of a D-wide tile
};

// ---------------------------------------------------------------------------
// Tile plans, and the fragments of row-major tiles
// ---------------------------------------------------------------------------

// kW groups of 16 resident rows, kC warps a group (each owning D / kC of
// the output columns), against kN-row ring stages; every tile has a row
// stride of D + 4 floats.
template <int D, int kW, int kN_, int kC>
struct TcCfg {
  static constexpr int kM = 16 * kW;          // resident rows per block
  static constexpr int kN = kN_;              // streamed rows per stage
  static constexpr int kDC = D / kC;          // output columns a warp owns
  static constexpr int kThreads = 32 * kW * kC;
  static constexpr int kResident = kM * Cfg<D>::kLD;  // floats, resident tile
  static constexpr int kStream = kN * Cfg<D>::kLD;    // floats, streamed tile
  // A two-stage ring of two streamed tiles, and the resident tiles: K1 Q;
  // K2 Q and dO; K3 K and V, and kN lse and kN delta values a ring stage.
  static constexpr size_t kRing = sizeof(float) * 4 * kStream;
  static constexpr size_t kSmemFwd = sizeof(float) * kResident + kRing;
  static constexpr size_t kSmemDq = sizeof(float) * 2 * kResident + kRing;
  static constexpr size_t kSmemDkv = kSmemDq + sizeof(float) * 4 * kN;
  static_assert(kN % 8 == 0 && 2 * kN <= kThreads, "ring stage rows");
  static_assert(kDC % 8 == 0 && kDC * kC == D, "output column split");
};
// 8 warps (128 resident rows) against 32-row stages: two warps a scheduler
// and ~135 KB (K1) or ~203 KB (K2, K3) of shared memory, one block per SM.
// chip_tile_sweep.py times other settings (4 warps against 64-row stages,
// or 64-row stages alone, are the other candidates).
constexpr int kFwdF32W = 8;
constexpr int kFwdF32N = 32;
constexpr int kDqF32W = 8;
constexpr int kDqF32N = 32;
constexpr int kDkvF32W = 8;
constexpr int kDkvF32N = 32;
// K1 at D = 256: 8 row groups of one warp (128 queries) against 16-row
// stages, one block per SM.
constexpr int kFwdF32W256 = 8;
constexpr int kFwdF32N256 = 16;
constexpr int kFwdF32C256 = 1;

// A fragment, split: rows r0 .. r0 + 15 and columns k0 .. k0 + 7 of a
// row-major tile of row stride LD.
template <int LD>
__device__ __forceinline__ void frag_a(const float* T, int r0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x % 32;
  const float* x = T + (r0 + lane / 4) * LD + k0 + lane % 4;
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[8 * LD], hi[1], lo[1]);
  split_tf32(x[4], hi[2], lo[2]);
  split_tf32(x[8 * LD + 4], hi[3], lo[3]);
}

// B fragment of A T^T, split: the tile's rows n0 .. n0 + 7 are the
// columns, its columns k0 .. k0 + 7 the reduction.
template <int LD>
__device__ __forceinline__ void frag_bt(const float* T, int n0, int k0,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int lane = threadIdx.x % 32;
  const float* x = T + (n0 + lane / 4) * LD + k0 + lane % 4;
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[4], hi[1], lo[1]);
}

// B fragment of A T with A from an accumulator (frag_acc), split: the
// tile's rows k0 .. k0 + 7 are the reduction in the relabelled order (k t
// is row k0 + 2t, k t + 4 is row k0 + 2t + 1), its columns n0 .. n0 + 7
// the columns.
template <int LD>
__device__ __forceinline__ void frag_b(const float* T, int k0, int n0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int lane = threadIdx.x % 32;
  const float* x = T + (k0 + 2 * (lane % 4)) * LD + n0 + lane / 4;
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[LD], hi[1], lo[1]);
}

// An accumulator tile as the split A fragment of the k8 slice over its 8
// columns, in the relabelled order: A's column t is the tile's column 2t,
// t + 4 is 2t + 1. No value moves between lanes.
__device__ __forceinline__ void frag_acc(const float (&c)[4],
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// s[j] += A[r0 + i] . B[8 j + n] over D (i < 16, n < 8, j < N / 8): the
// scores of a warp's 16 resident rows against the N rows of a streamed
// tile, both row-major.
template <int D, int N>
__device__ __forceinline__ void scores_tc(const float* A, int r0,
                                          const float* B, float (&s)[N / 8][4]) {
  constexpr int kLD = Cfg<D>::kLD;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 8) {
    uint32_t a_hi[4], a_lo[4];
    frag_a<kLD>(A, r0, k0, a_hi, a_lo);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t b_hi[2], b_lo[2];
      frag_bt<kLD>(B, 8 * j, k0, b_hi, b_lo);
      mma_f32(s[j], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// acc[i] += P M[:, 8 i .. 8 i + 7] (i < DC / 8): P a warp's 16 x N
// accumulator tiles (p[j] holds its columns 8 j .. 8 j + 7), M the first
// of the DC columns the warp owns in an N x D streamed tile; one k8 slice
// per accumulator tile. acc sums over the whole sequence, so the step's
// products go into a fresh accumulator and join acc by an f32 add:
// chained into acc on the tensor core, whose accumulation does not round
// to nearest, the error grows with the sequence (PERF.md).
template <int D, int N, int DC>
__device__ __forceinline__ void pv_tc(const float (&p)[N / 8][4],
                                      const float* M, float (&acc)[DC / 8][4]) {
  constexpr int kLD = Cfg<D>::kLD;
  uint32_t a_hi[N / 8][4], a_lo[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) frag_acc(p[j], a_hi[j], a_lo[j]);
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    float part[4] = {};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t b_hi[2], b_lo[2];
      frag_b<kLD>(M, 8 * j, 8 * i, b_hi, b_lo);
      mma_f32(part, a_hi[j], a_lo[j], b_hi, b_lo);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[i][x] += part[x];
  }
}

// Rows row0 .. row0 + R - 1 of one (b, h) slice (`src` at its row 0, rows
// `row_stride` elements apart) into an R x D tile of row stride D + 4 by
// 16-byte cp.async, T threads; rows at or past n_rows are zero-filled.
template <int D, int R, int T>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                long long row_stride, int row0,
                                                int n_rows) {
  constexpr int kChunks = D / 4;
  constexpr int kTotal = R * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + T - 1) / T; ++i) {
    const int c = threadIdx.x + i * T;
    if (kTotal % T == 0 || c < kTotal) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
      const bool valid = row0 + r < n_rows;
      cp_async16(smem_u32(dst + r * Cfg<D>::kLD + col),
                 valid ? src + (long long)(row0 + r) * row_stride + col : src,
                 valid);
    }
  }
}

// Key step kt's K and V tiles into stage st of a two-stage ring of kN-row
// tiles (stage st: K, then V), T threads.
template <int D, int kN, int T>
__device__ __forceinline__ void load_kv(float* ring, int st, int kt,
                                        const Params& p, const float* k,
                                        const float* v) {
  constexpr int kStream = kN * Cfg<D>::kLD;
  float* Ks = ring + 2 * st * kStream;
  load_tile_async<D, kN, T>(Ks, k, p.k_ss, kt * kN, p.Sk);
  load_tile_async<D, kN, T>(Ks + kStream, v, p.v_ss, kt * kN, p.Sk);
}

// ---------------------------------------------------------------------------
// K1: the forward. One block per (b, h) and 16 kW-query tile; per kN-key
// step S = Q K^T (each of a group's kC warps the group's whole S), the
// online softmax in registers (running max m, l = l alpha + rowsum P),
// acc = acc alpha + P V; then O = acc / max(l, 1e-30) and lse = m +
// log(max(l, 1e-30)).
// ---------------------------------------------------------------------------

template <int D, int kW, int kN, int kC>
__global__ void __launch_bounds__(32 * kW * kC, 1)
    flash_fwd_f32_kernel(const Params p) {
  using C = TcCfg<D, kW, kN, kC>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* ring = Qs + C::kResident;  // stage s: K, then V
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  // The last query tiles see the most keys: they go in the first wave.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kM;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = threadIdx.x / 32 / kC * 16;     // this warp's first row
  const int c0 = threadIdx.x / 32 % kC * C::kDC;  // and output column
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  load_tile_async<D, C::kM, C::kThreads>(Qs, q, p.q_ss, q0, p.Sq);
  load_kv<D, kN, C::kThreads>(ring, 0, 0, p, k, v);
  cp_async_commit();

  // This warp's first and last query positions.
  const int q_first = p.q_offset + q0 + r0;
  const int q_last = p.q_offset + min(q0 + r0 + 15, p.Sq - 1);
  const int block_last = p.q_offset + min(q0 + C::kM, p.Sq) - 1;
  const int n_kt = min(block_last / kN + 1, (p.Sk + kN - 1) / kN);
  // Rows r0 + g (index 0) and r0 + g + 8 (index 1) of this thread.
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  float acc[C::kDC / 8][4] = {};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const float* Ks = ring + 2 * st * C::kStream;
    const float* Vs = Ks + C::kStream;
    const int k0 = kt * kN;
    if (kt + 1 < n_kt) {
      load_kv<D, kN, C::kThreads>(ring, st ^ 1, kt + 1, p, k, v);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // key step kt has landed in stage st
    // A warp whose rows lie past Sq, or all before this step's first key,
    // has nothing to add: its scores there are all masked, which leaves m,
    // l and acc as they are.
    if (q0 + r0 < p.Sq && k0 <= q_last) {
      float s[kN / 8][4] = {};
      scores_tc<D, kN>(Qs, r0, Ks, s);
      const bool masked = k0 + kN - 1 > q_first || k0 + kN > p.Sk;
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          const int q_pos = q_first + g + 8 * (e >> 1);
          float x = s[j][e] * p.scale;
          if (masked && (k_pos > q_pos || k_pos >= p.Sk)) x = kNegBig;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // A row's scores lie in the 4 lanes of a quad.
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);  // P
          rs[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
        rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int i = 0; i < C::kDC / 8; ++i) {
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][x] *= alpha[x >> 1];
      }
      pv_tc<D, kN, C::kDC>(s, Vs + c0, acc);
    }
    __syncthreads();  // stage st is free for step kt + 2
  }

  const long long o_ss = (long long)p.H * D;
  float* ob = p.out0 + (long long)b * p.Sq * o_ss + (long long)h * D;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g + 8 * e;
    if (row < p.Sq) {
      const float l_safe = fmaxf(l[e], 1e-30f);
#pragma unroll
      for (int i = 0; i < C::kDC / 8; ++i) {
        *reinterpret_cast<float2*>(ob + row * o_ss + c0 + 8 * i + 2 * t) =
            make_float2(acc[i][2 * e] / l_safe, acc[i][2 * e + 1] / l_safe);
      }
      if (t == 0 && c0 == 0) {
        p.stat_out[((long long)b * p.Sq + row) * p.H + h] =
            m[e] + logf(l_safe);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the dQ pass. One block per (b, h) and 16 kW-query tile, with its dO,
// lse and delta; per kN-key step S = Q K^T and dP = dO V^T, P = exp(S
// scale - lse) and dS = P (dP - delta) scale in registers, dQ += dS K.
// ---------------------------------------------------------------------------

template <int D, int kW, int kN>
__global__ void __launch_bounds__(32 * kW, 1)
    flash_bwd_dq_f32_kernel(const Params p) {
  using C = TcCfg<D, kW, kN, 1>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* DOs = Qs + C::kResident;
  float* ring = DOs + C::kResident;  // stage s: K, then V
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  // The last query tiles see the most keys: they go in the first wave.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kM;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = threadIdx.x / 32 * 16;  // this warp's first row
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
  load_tile_async<D, C::kM, C::kThreads>(Qs, q, p.q_ss, q0, p.Sq);
  load_tile_async<D, C::kM, C::kThreads>(DOs, dout, p.do_ss, q0, p.Sq);
  load_kv<D, kN, C::kThreads>(ring, 0, 0, p, k, v);
  cp_async_commit();

  // lse and delta = rowsum(dO * O) (f32 FFMA) of this thread's rows
  // r0 + g and r0 + g + 8, while the tiles land: the four lanes of a quad
  // sum every fourth float4 of a row and join by two shuffles. Rows past
  // Sq take 0.
  float lse[2], delta[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g + 8 * e;
    const bool valid = row < p.Sq;
    float sum = 0.f;
    if (valid) {
      const float* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
      const float* drow = dout + row * p.do_ss;
      for (int c = 4 * t; c < D; c += 16) {
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
    if (valid && t == 0) p.stat_out[at] = sum;
  }

  // This warp's first and last query positions.
  const int q_first = p.q_offset + q0 + r0;
  const int q_last = p.q_offset + min(q0 + r0 + 15, p.Sq - 1);
  const int block_last = p.q_offset + min(q0 + C::kM, p.Sq) - 1;
  const int n_kt = min(block_last / kN + 1, (p.Sk + kN - 1) / kN);
  float dq[D / 8][4] = {};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const float* Ks = ring + 2 * st * C::kStream;
    const float* Vs = Ks + C::kStream;
    const int k0 = kt * kN;
    if (kt + 1 < n_kt) {
      load_kv<D, kN, C::kThreads>(ring, st ^ 1, kt + 1, p, k, v);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // keys and values of step kt have landed in stage st
    // A warp whose rows lie past Sq, or all before this step's first key,
    // has nothing to add.
    if (q0 + r0 < p.Sq && k0 <= q_last) {
      float s[kN / 8][4] = {}, dp[kN / 8][4] = {};
      scores_tc<D, kN>(Qs, r0, Ks, s);
      scores_tc<D, kN>(DOs, r0, Vs, dp);
      // Mask only a step that crosses the warp's diagonal or the end of
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
      pv_tc<D, kN, D>(s, Ks, dq);
    }
    __syncthreads();  // stage st is free for tile kt + 2
  }

  const long long o_ss = (long long)p.H * D;
  float* dqb = p.out0 + (long long)b * p.Sq * o_ss + (long long)h * D;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g + 8 * e;
    if (row < p.Sq) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(dqb + row * o_ss + 8 * i + 2 * t) =
            make_float2(dq[i][2 * e], dq[i][2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the dK/dV pass. One block per (b, h) and 16 kW-key tile, with its
// values; the kN-query tiles from the first that reaches the tile's
// diagonal, each with its dO, lse and delta. S^T = K Q^T, dP^T = V dO^T,
// P^T and dS^T in registers, dV += P^T dO, dK += dS^T Q.
// ---------------------------------------------------------------------------

template <int D, int kW, int kN>
__global__ void __launch_bounds__(32 * kW, 1)
    flash_bwd_dkv_f32_kernel(const Params p) {
  using C = TcCfg<D, kW, kN, 1>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + C::kResident;
  float* ring = Vs + C::kResident;       // stage s: Q, then dO
  float* stats = ring + 4 * C::kStream;  // stage s: lse[kN], then delta[kN]
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  // The first key tiles see the most queries, and run in the first wave.
  const int k0 = blockIdx.y * C::kM;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = threadIdx.x / 32 * 16;  // this warp's first row
  const int k_first = k0 + r0;           // and its first key
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat_b = (long long)b * p.Sq * p.H + h;
  // Query tile qt's Q, dO, lse and delta into ring stage st.
  auto load_stage = [&](int st, int qt) {
    const int q0 = qt * kN;
    float* Qs = ring + 2 * st * C::kStream;
    load_tile_async<D, kN, C::kThreads>(Qs, q, p.q_ss, q0, p.Sq);
    load_tile_async<D, kN, C::kThreads>(Qs + C::kStream, dout, p.do_ss, q0,
                                        p.Sq);
    const int i = threadIdx.x;
    if (i < 2 * kN) {
      const int r = i % kN;
      const bool valid = q0 + r < p.Sq;
      const float* src = i < kN ? p.lse_in : p.delta_in;
      cp_async4(smem_u32(stats + 2 * st * kN + i),
                valid ? src + stat_b + (long long)(q0 + r) * p.H : src, valid);
    }
  };

  // The first query tile with a query at or past this tile's first key.
  const int qt0 = max(0, k0 - p.q_offset) / kN;
  const int n_qt = (p.Sq + kN - 1) / kN;
  if (qt0 < n_qt) {
    load_tile_async<D, C::kM, C::kThreads>(Ks, k, p.k_ss, k0, p.Sk);
    load_tile_async<D, C::kM, C::kThreads>(Vs, v, p.v_ss, k0, p.Sk);
    load_stage(0, qt0);
    cp_async_commit();
  }
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    const float* Qs = ring + 2 * st * C::kStream;
    const float* DOs = Qs + C::kStream;
    const float* lse = stats + 2 * st * kN;
    const float* delta = lse + kN;
    const int q0 = qt * kN;
    if (qt + 1 < n_qt) {
      load_stage(st ^ 1, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // query tile qt has landed in stage st
    // A warp whose keys lie past Sk, or all past this tile's last query,
    // has nothing to add.
    if (k_first < p.Sk && p.q_offset + q0 + kN - 1 >= k_first) {
      // P^T is used by dV before dP^T is formed: with dK and dV in 128
      // registers a thread (D = 128), P^T and dS^T live at once, and
      // split, would spill.
      float s[kN / 8][4] = {};
      scores_tc<D, kN>(Ks, r0, Qs, s);  // S^T
      // Mask only a tile that crosses the warp's diagonal or the end of
      // the queries.
      const bool masked = k_first + 15 > p.q_offset + q0 || q0 + kN > p.Sq;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);  // the query's tile row
          const int k_pos = k_first + g + 8 * (e >> 1);
          float pr = expf(s[j][e] * p.scale - lse[c]);
          if (masked && (q0 + c >= p.Sq || p.q_offset + q0 + c < k_pos)) {
            pr = 0.f;
          }
          s[j][e] = pr;  // P^T
        }
      }
      pv_tc<D, kN, D>(s, DOs, dv);
      float dp[kN / 8][4] = {};
      scores_tc<D, kN>(Vs, r0, DOs, dp);  // dP^T
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          dp[j][e] = s[j][e] * (dp[j][e] - delta[c]) * p.scale;  // dS^T
        }
      }
      pv_tc<D, kN, D>(dp, Qs, dk);
    }
    __syncthreads();  // stage st is free for tile qt + 2
  }

  const long long o_ss = (long long)p.H * D;
  const long long base = (long long)b * p.Sk * o_ss + (long long)h * D;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = k0 + r0 + g + 8 * e;
    if (row < p.Sk) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const long long at = base + row * o_ss + 8 * i + 2 * t;
        *reinterpret_cast<float2*>(p.out0 + at) =
            make_float2(dk[i][2 * e], dk[i][2 * e + 1]);
        *reinterpret_cast<float2*>(p.out1 + at) =
            make_float2(dv[i][2 * e], dv[i][2 * e + 1]);
      }
    }
  }
}

// A kernel instantiation with its launch shape: threads, rows of the
// tiled sequence (queries for K1 and K2, keys for K3) a block owns, and
// dynamic shared memory.
struct Kernel {
  const void* fn;
  int threads;
  int rows;
  size_t smem;
};

// Each kernel's tile plan at head dim D: the D <= 128 plan (one warp a
// row group), or K1's D = 256 one.
template <int D>
Kernel fwd_kernel() {
  constexpr int kW = D > 128 ? kFwdF32W256 : kFwdF32W;
  constexpr int kN = D > 128 ? kFwdF32N256 : kFwdF32N;
  constexpr int kC = D > 128 ? kFwdF32C256 : 1;
  using C = TcCfg<D, kW, kN, kC>;
  return {(const void*)flash_fwd_f32_kernel<D, kW, kN, kC>, C::kThreads,
          C::kM, C::kSmemFwd};
}
template <int D>
Kernel dq_kernel() {
  using C = TcCfg<D, kDqF32W, kDqF32N, 1>;
  return {(const void*)flash_bwd_dq_f32_kernel<D, kDqF32W, kDqF32N>,
          C::kThreads, C::kM, C::kSmemDq};
}
template <int D>
Kernel dkv_kernel() {
  using C = TcCfg<D, kDkvF32W, kDkvF32N, 1>;
  return {(const void*)flash_bwd_dkv_f32_kernel<D, kDkvF32W, kDkvF32N>,
          C::kThreads, C::kM, C::kSmemDkv};
}

// which: 0 = K1, 1 = K2, 2 = K3.
template <int D>
Kernel pick(int which) {
  switch (which) {
    case 0: return fwd_kernel<D>();
    case 1: return dq_kernel<D>();
    case 2: return dkv_kernel<D>();
  }
  return {nullptr, 0, 0, 0};
}

int find_kernel(int which, long long head_dim, Kernel* out) {
  switch (head_dim) {
    case 16: *out = pick<16>(which); break;
    case 32: *out = pick<32>(which); break;
    case 64: *out = pick<64>(which); break;
    case 128: *out = pick<128>(which); break;
    case 256:
      if (which == 0) {
        *out = fwd_kernel<256>();
        break;
      }
      *out = {nullptr, 0, 0, 0};
      return rf_f32_d256::kernel_info(which, &out->fn, &out->threads,
                                      &out->rows, &out->smem);
    default: return kBadHeadDim;
  }
  return out->fn ? 0 : kBadKernel;
}

int launch(int which, const Params& p, long long head_dim, void* stream) {
  Kernel k;
  int err = find_kernel(which, head_dim, &k);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
  if (err) return err;
  const int n_tiles = ((which == 2 ? p.Sk : p.Sq) + k.rows - 1) / k.rows;
  const dim3 grid(p.B * p.H, n_tiles);
  void* args[] = {(void*)&p};
  err = (int)cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, k.smem,
                              (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rf_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                     void* lse, const long long* dims, float scale,
                     void* stream) {
  Params p = make_params(dims, scale);
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.out0 = (float*)o;
  p.stat_out = (float*)lse;
  return launch(0, p, dims[4], stream);
}

int rf_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, void* delta, const long long* dims,
                        float scale, void* stream) {
  if (dims[4] == 256) {
    return rf_f32_d256::dq(q, k, v, o, dout, lse, dq, delta, dims, scale,
                           stream);
  }
  Params p = make_params(dims, scale);
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.o = (const float*)o;
  p.dout = (const float*)dout;
  p.lse_in = (const float*)lse;
  p.out0 = (float*)dq;
  p.stat_out = (float*)delta;
  return launch(1, p, dims[4], stream);
}

int rf_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, const long long* dims,
                         float scale, void* stream) {
  if (dims[4] == 256) {
    return rf_f32_d256::dkv(q, k, v, dout, lse, delta, dk, dv, dims, scale,
                            stream);
  }
  Params p = make_params(dims, scale);
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.dout = (const float*)dout;
  p.lse_in = (const float*)lse;
  p.delta_in = (const float*)delta;
  p.out0 = (float*)dk;
  p.out1 = (float*)dv;
  return launch(2, p, dims[4], stream);
}

// Resources of f32 kernel `which` (0 = K1, 1 = K2, 2 = K3) at head dim
// `head_dim`: out = {registers per thread, dynamic shared memory bytes,
// threads per block, resident blocks per SM}.
int rf_kernel_resources_f32(int which, int head_dim, int* out) {
  Kernel k;
  int err = find_kernel(which, head_dim, &k);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, k.fn);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k.fn, k.threads, k.smem);
  if (err) return err;
  out[0] = attr.numRegs;
  out[1] = (int)k.smem;
  out[2] = k.threads;
  out[3] = blocks;
  return 0;
}

// Rows of the tiled sequence one block of f32 kernel `which` owns at head
// dim `head_dim` (the launch grid's y dimension counts these tiles).
int rf_kernel_rows_f32(int which, int head_dim, int* rows) {
  Kernel k;
  int err = find_kernel(which, head_dim, &k);
  if (err) return err;
  *rows = k.rows;
  return 0;
}

}  // extern "C"
