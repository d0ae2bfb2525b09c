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

// Causal flash attention for Hopper (sm_90a), bf16 at head dim 256: the
// forward and the dK/dV pass, warp-specialised. They replace, at D = 256,
// the Pallas TPU kernels of rayfed_tpu/ops/flash_attention.py:
//   flash_fwd_kernel<256>     <- _flash_kernel          (K1)
//   flash_bwd_dkv_kernel<256> <- _flash_bwd_dkv_kernel  (K3)
// (K2 at D = 256, and K1-K3 at D <= 128, are flash_attention.cu's.) The
// contract is flash_attention.cu's: scale D**-0.5 (the true D when the
// wrapper zero-pads D 129-255 to 256), causal with query positions
// shifted by q_offset, masked scores -1e30, l clamped at 1e-30, f32
// accumulation, P and dS rounded to bf16 where the reference casts them,
// no atomics (two launches give the same bits).
//
// What bounds them: at the main path's shape (S = 2048) each does ~S/2
// multiply-adds a byte it must move, far above the H100's ridge, so the
// tensor cores bound them. At D = 256 a 64-row f32 accumulator is 128
// registers a thread, so registers, not shared memory, shape the plan;
// and a score product over 64 keys reads as many shared-memory bytes a
// cycle as the SM has, so the consumers must never leave the tensor cores
// waiting on anything else.
//
// Both kernels take one shape: a block of three warpgroups. Warpgroup 0
// is the producer: it gives up its registers (setmaxnreg.dec) and keeps
// TMA copies in flight into a ring of shared-memory stages, each with a
// full and an empty mbarrier, so no thread spends registers or issue
// slots on addresses. TMA writes the 128-byte swizzle that the wgmma
// descriptors read (a 256-wide row is four 64-column boxes of a 4-D
// (D, H, S, B) tensor map; rows past S arrive as zeros). Warpgroups 1 and
// 2 are consumers (setmaxnreg.inc) on wgmma, which wait only on the
// mbarriers of the stage they need and never on each other at a
// block-wide barrier. A head's blocks run together (block_tile), so its
// streamed tiles are read from device memory about once.
//
// K1: 128 queries a block (64 a consumer), kFwd256N keys a ring stage. K
// and V have full and empty barriers of their own: S = Q K^T starts before
// V lands, and K's stage is free again as soon as its S is done. A
// consumer issues S_{j+1} = Q K_{j+1}^T with O += P_j V_j and waits for
// S_{j+1} alone (wgmma.wait_group 1): the softmax of tile j+1 runs while
// P_j V_j is on the tensor cores. With kFwd256PingPong the two consumers
// take turns issuing their products on two named barriers.
//
// K3: 64 keys a block, K and V resident (64 KiB), kDkv256Stages stages of
// 64 queries (Q, dO by TMA; lse and delta stored by the producer's
// threads). dK and dV at once would be 256 registers a thread, so they
// live in different warpgroups: consumer V holds dV, forms S^T = K Q^T
// and P^T = exp(S^T scale - lse), hands P^T in f32 to consumer K through
// a 16 KiB shared buffer on two named barriers, and adds P^T dO into dV;
// consumer K holds dK, forms dP^T = V dO^T, dS^T = P^T (dP^T - delta)
// scale and adds dS^T Q into dK. Four products a query tile, two in each
// warpgroup, m64n64 and m64n256, with Q and dO streamed once. Unlike K1's,
// a consumer does not issue the next tile's scores with this tile's
// product: both of a tile's products read Q and dO, so a stage is free
// only when both consumers are done with it, and with the two stages
// that fit, the next tile's copy would have no time to land.

#include "flash_attention_d256.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Tile plans (chip_tile_sweep.py rewrites these)
// ---------------------------------------------------------------------------

// K1: keys a ring stage (64 or 80), ring stages, and the consumers'
// ping-pong (1 = on).
constexpr int kFwd256N = 80;
constexpr int kFwd256Stages = 2;
constexpr int kFwd256PingPong = 1;
// K3: ring stages of 64 queries.
constexpr int kDkv256Stages = 2;

constexpr int kD = 256;
constexpr int kThreads256 = 3 * kWgThreads;  // producer + two consumers
constexpr int kTileRowBytes = kD * 2;        // a 256-wide bf16 row
constexpr size_t kMaxSmem = 232448;          // a block's dynamic share
// Registers a thread of the producer gives up to, and each consumer's:
// 128 x prod + 256 x cons may not pass the 168 x 384 the launch holds.
constexpr int kFwdProducerRegs = 24;
constexpr int kFwdConsumerRegs = 240;
constexpr int kDkvProducerRegs = 40;
constexpr int kDkvConsumerRegs = 232;

// ---------------------------------------------------------------------------
// TMA tiles and named barriers (mbarriers and the register hand-over are
// tma.cuh's)
// ---------------------------------------------------------------------------

// The tensor maps of a launch: (D, H, S, B) views of q, k, v and dout.
struct Tma256 {
  CUtensorMap q, k, v, d;
};

// Rows [row0, row0 + R) of head h, batch b, all 256 columns, as four
// 64-column boxes into the R-row swizzled tile at dst (sw_offset<R>'s
// layout); completion is reported to bar.
template <int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int h,
                                         int b) {
  tma_boxes<R, kD / 64>(dst, map, bar, row0, h, b, 64);
}

// Named barriers 1.. (0 is __syncthreads) over the two consumers.
constexpr int kConsumerThreads = 2 * kWgThreads;
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kConsumerThreads)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kConsumerThreads)
               : "memory");
}

// Wait until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// K1: the forward
// ---------------------------------------------------------------------------

template <int N, int STAGES>
struct Fwd256Cfg {
  static constexpr int kM = 128;  // query rows a block, 64 a consumer
  static constexpr int kQBytes = kM * kTileRowBytes;
  static constexpr int kKVBytes = N * kTileRowBytes;
  // Q, STAGES x (K, V), then the mbarriers: Q full, then K full, V full,
  // K empty and V empty a stage; slack to align the base to 1024.
  static constexpr int kBarOff = kQBytes + 2 * STAGES * kKVBytes;
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(kSmem <= kMaxSmem, "K1's ring passes a block's 227 KB");
};

// The named barriers of the consumers' turns: consumer c waits on
// kTurn + c before issuing its products and, once issued, lets the other
// go on kTurn + (c ^ 1).
constexpr int kTurn = 1;

// One key tile of the online softmax: scale S into log2 units, mask
// (only a tile that crosses the diagonal or the end of the keys), update
// the running max m and sum l of this thread's two rows, and write
// P = exp(S - m) in f32 to p; alpha is what O must be scaled by. S is
// only read, and P is packed to bf16 apart (pack_p): in the overlap, both
// writes would fall on registers of the P V in flight (the S wgmma's, the
// A operand's once ptxas coalesces the copy), and ptxas would serialize
// the products.
template <int N>
__device__ __forceinline__ void softmax_tile(const float (&s)[N / 2],
                                             float (&p)[N / 2],
                                             float (&alpha)[2], float (&m)[2],
                                             float (&l)[2], bool masked,
                                             int k0, int q_pos0, int lane,
                                             int Sk, float scale_log2) {
  float mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * scale_log2;
      if (masked) {
        const int k_pos = k0 + acc_col(i, e, lane);
        if (k_pos > q_pos0 + 8 * (e / 2) || k_pos >= Sk) x = kNegBig;
      }
      p[4 * i + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    const float m_new = fmaxf(m[j], mx[j]);
    alpha[j] = exp2f(m[j] - m_new);
    m[j] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      p[4 * i + e] = exp2f(p[4 * i + e] - m[e / 2]);
      p[4 * i + e + 1] = exp2f(p[4 * i + e + 1] - m[e / 2]);
      sum[e / 2] += p[4 * i + e] + p[4 * i + e + 1];
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
}

// P as bf16 A fragments (see acc_col).
template <int N>
__device__ __forceinline__ void pack_p(const float (&p)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      a[i / 2][2 * (i % 2) + e / 2] = pack_bf16(p[4 * i + e],
                                                p[4 * i + e + 1]);
    }
  }
}

// Issue S = Q K^T for a consumer's 64 rows (not committed).
template <int N>
__device__ __forceinline__ void issue_qk(float (&s)[N / 2], uint32_t sQ,
                                         int cw, uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    Wgmma<N>::ss(s, kmajor_desc<128>(sQ, cw * 64, kk),
                 kmajor_desc<N>(sK, 0, kk), kk > 0);
  }
}
// Issue O += P V, P from registers (not committed).
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2],
                                         const uint32_t (&a)[N / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    Wgmma<kD>::rs(o, a[kk], mnmajor_desc<N>(sV, kk));
  }
}

// One block per (b * h, 128-query tile) (block_tile); the key tiles at or
// below the block's last query row.
template <int D, int N, int STAGES, bool kPingPong>
__global__ void __launch_bounds__(kThreads256, 1)
flash_fwd_kernel(const __grid_constant__ Tma256 tm, const Params p) {
  static_assert(D == kD, "the D = 256 plan");
  using C = Fwd256Cfg<N, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sRing = sQ + C::kQBytes;  // stage s: K, then V
  const uint32_t bars = sQ + C::kBarOff;
  const uint32_t q_full = bars;
  // + 8 s for stage s. K is free once S = Q K^T is done, V once P V is.
  const uint32_t k_full = bars + 8;
  const uint32_t v_full = bars + 8 * (1 + STAGES);
  const uint32_t k_empty = bars + 8 * (1 + 2 * STAGES);
  const uint32_t v_empty = bars + 8 * (1 + 3 * STAGES);

  const int wg = threadIdx.x / kWgThreads;  // 0 producer, 1 and 2 consumers
  int bh, t;
  block_tile(&bh, &t);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = (gridDim.y - 1 - t) * C::kM;  // the last q tiles first
  const int q_last = p.q_offset + min(q0 + C::kM, p.Sq) - 1;
  const int n_kt = min(q_last / N + 1, (p.Sk + N - 1) / N);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival a consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<kFwdProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      tma_tile<C::kM>(sQ, &tm.q, q_full, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        // The first pass finds every stage free (the parity before phase 0).
        const uint32_t parity = ((kt / STAGES) & 1) ^ 1;
        const uint32_t sK = sRing + 2 * st * C::kKVBytes;
        mbar_wait(k_empty + 8 * st, parity);
        mbar_expect_tx(k_full + 8 * st, C::kKVBytes);
        tma_tile<N>(sK, &tm.k, k_full + 8 * st, kt * N, h, b);
        mbar_wait(v_empty + 8 * st, parity);
        mbar_expect_tx(v_full + 8 * st, C::kKVBytes);
        tma_tile<N>(sK + C::kKVBytes, &tm.v, v_full + 8 * st, kt * N, h, b);
      }
    }
    return;
  }
  reg_alloc<kFwdConsumerRegs>();

  const int cw = wg - 1;  // this consumer's rows: [64 cw, 64 cw + 64)
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // This thread's two rows of the block's 128 (see acc_col).
  const int r0 = cw * 64 + warp * 16 + lane / 4;
  const int q_pos0 = p.q_offset + q0 + r0;
  // Tiles reaching past the consumer's first query need the mask.
  const int wg_q_first = p.q_offset + q0 + cw * 64;
  const float scale_log2 = p.scale * kLog2e;
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.0f, 0.0f};
  float alpha[2];
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
  uint32_t a[N / 16][4];
  auto masked = [&](int k0) {
    return k0 + N - 1 > wg_q_first || k0 + N > p.Sk;
  };

  // Consumer 0 takes the first turn.
  if (kPingPong && cw == 1) bar_arrive(kTurn);
  mbar_wait(q_full, 0);

  // S_0 and its softmax (O is zero: no rescale).
  mbar_wait(k_full, 0);
  float s[N / 2];
  if (kPingPong) bar_sync(kTurn + cw);
  wgmma_fence();
  issue_qk<N>(s, sQ, cw, sRing);
  wgmma_commit();
  if (kPingPong) bar_arrive(kTurn + (cw ^ 1));
  wgmma_wait<0>();
  fence_regs(s);
  release_stage(k_empty);
  float pr[N / 2];
  softmax_tile<N>(s, pr, alpha, m, l, masked(0), 0, q_pos0, lane, p.Sk,
                  scale_log2);
  pack_p<N>(pr, a);

  // Each turn issues S_{kt+1} and P_kt V_kt; the softmax of kt + 1 runs
  // while P_kt V_kt is on the tensor cores. P_{kt+1} is packed and O
  // rescaled only after P_kt V_kt's wait: a register that a product in
  // flight reads or writes, written before its wait, makes ptxas
  // serialize the products.
  for (int kt = 0; kt + 1 < n_kt; ++kt) {
    const int st = kt % STAGES;
    const int nst = (kt + 1) % STAGES;
    const int k0n = (kt + 1) * N;
    mbar_wait(k_full + 8 * nst, ((kt + 1) / STAGES) & 1);
    float s[N / 2];
    if (kPingPong) bar_sync(kTurn + cw);
    wgmma_fence();
    issue_qk<N>(s, sQ, cw, sRing + 2 * nst * C::kKVBytes);
    wgmma_commit();
    mbar_wait(v_full + 8 * st, (kt / STAGES) & 1);
    wgmma_fence();
    issue_pv<N>(o, a, sRing + (2 * st + 1) * C::kKVBytes);
    wgmma_commit();
    if (kPingPong) bar_arrive(kTurn + (cw ^ 1));
    wgmma_wait<1>();
    fence_regs(s);
    release_stage(k_empty + 8 * nst);
    softmax_tile<N>(s, pr, alpha, m, l, masked(k0n), k0n, q_pos0, lane, p.Sk,
                    scale_log2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(a);
    release_stage(v_empty + 8 * st);
    pack_p<N>(pr, a);
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] *= alpha[e / 2];
    }
  }
  // The last tile's P V, in a turn of its own.
  {
    const int st = (n_kt - 1) % STAGES;
    mbar_wait(v_full + 8 * st, ((n_kt - 1) / STAGES) & 1);
    if (kPingPong) bar_sync(kTurn + cw);
    fence_regs(o);
    fence_regs(a);
    wgmma_fence();
    issue_pv<N>(o, a, sRing + (2 * st + 1) * C::kKVBytes);
    wgmma_commit();
    if (kPingPong) bar_arrive(kTurn + (cw ^ 1));
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(a);
  }
  // Consumer 1's last hand-over to consumer 0 has no turn after it.
  if (kPingPong && cw == 0) bar_sync(kTurn);

  // Each row's sum is spread over the four lanes of its quad.
  const long long o_ss = (long long)p.H * kD;
  bf16* ob = p.out0 + (long long)b * p.Sq * o_ss + (long long)h * kD;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    const float l_safe = fmaxf(l[j], 1e-30f);
    const int row = q0 + r0 + 8 * j;
    if (row < p.Sq) {
      if (lane % 4 == 0) {
        p.stat_out[((long long)b * p.Sq + row) * p.H + h] =
            m[j] * kLn2 + logf(l_safe);
      }
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        const int c = acc_col(i, 0, lane);
        *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + c) =
            __floats2bfloat162_rn(o[4 * i + 2 * j] / l_safe,
                                  o[4 * i + 2 * j + 1] / l_safe);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the dK/dV pass
// ---------------------------------------------------------------------------

template <int STAGES>
struct Dkv256Cfg {
  static constexpr int kN = 64;  // keys a block
  static constexpr int kM = 64;  // queries a ring stage
  static constexpr int kTileBytes = 64 * kTileRowBytes;
  static constexpr int kStatBytes = 2 * kM * 4;      // lse, delta
  static constexpr int kPBytes = 64 * 64 * 4;        // P^T in f32
  // K, V, STAGES x (Q, dO), STAGES x (lse, delta), P^T, then the
  // mbarriers: K/V full, full and empty a stage; slack for the alignment.
  static constexpr int kRingOff = 2 * kTileBytes;
  static constexpr int kStatOff = kRingOff + 2 * STAGES * kTileBytes;
  static constexpr int kPOff = kStatOff + STAGES * kStatBytes;
  static constexpr int kBarOff = kPOff + kPBytes;
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(kSmem <= kMaxSmem, "K3's ring passes a block's 227 KB");
};

// Named barriers of the P^T buffer: full, and free again.
constexpr int kPFull = 1;
constexpr int kPFree = 2;

// One block per (b * h, 64-key tile) (block_tile). Streams the q tiles
// from the diagonal on, in the transposed orientation (rows are keys).
template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads256, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Tma256 tm, const Params p) {
  static_assert(D == kD, "the D = 256 plan");
  using C = Dkv256Cfg<STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base;
  const uint32_t sV = base + C::kTileBytes;
  const uint32_t sRing = base + C::kRingOff;  // stage s: Q, then dO
  float* const stat = reinterpret_cast<float*>(base_ptr + C::kStatOff);
  float4* const pbuf = reinterpret_cast<float4*>(base_ptr + C::kPOff);
  const uint32_t kv_full = base + C::kBarOff;
  const uint32_t full = kv_full + 8;                // + 8 s
  const uint32_t empty = kv_full + 8 * (1 + STAGES);  // + 8 s

  const int wg = threadIdx.x / kWgThreads;  // 0 producer, 1 (dV), 2 (dK)
  int bh, t;
  block_tile(&bh, &t);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = t * C::kN;  // the first keys see the most queries
  // Query rows below k0 - q_offset see none of these keys.
  const int qt_start = max(0, k0 - p.q_offset) / C::kM;
  const int n = (p.Sq + C::kM - 1) / C::kM - qt_start;  // q tiles, maybe 0

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, kWgThreads);  // every producer thread
      mbar_init(empty + 8 * s, 8);          // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<kDkvProducerRegs>();
    const int t = threadIdx.x;
    if (n > 0 && t == 0) {
      mbar_expect_tx(kv_full, 2 * C::kTileBytes);
      tma_tile<C::kN>(sK, &tm.k, kv_full, k0, h, b);
      tma_tile<C::kN>(sV, &tm.v, kv_full, k0, h, b);
    }
    // Thread t stores lse (t < 64) or delta (t >= 64) of row t % 64.
    const float* src = (t < C::kM ? p.lse_in : p.delta_in) +
                       (long long)b * p.Sq * p.H + h;
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const int q0 = (qt_start + i) * C::kM;
      const int row = q0 + t % C::kM;
      mbar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
      stat[st * 2 * C::kM + t] = row < p.Sq ? src[(long long)row * p.H] : 0.0f;
      if (t == 0) {
        const uint32_t sQ = sRing + 2 * st * C::kTileBytes;
        mbar_expect_tx(full + 8 * st, 2 * C::kTileBytes);
        tma_tile<C::kM>(sQ, &tm.q, full + 8 * st, q0, h, b);
        tma_tile<C::kM>(sQ + C::kTileBytes, &tm.d, full + 8 * st, q0, h, b);
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }
  reg_alloc<kDkvConsumerRegs>();

  const int cw = wg - 1;  // 0 holds dV, 1 holds dK
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // This thread's two key rows of the block's 64 (see acc_col).
  const int r0 = warp * 16 + lane / 4;
  const int k_pos0 = k0 + r0;
  const float scale_log2 = p.scale * kLog2e;
  float acc[kD / 2];  // dV (cw 0) or dK (cw 1)
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;

  if (n > 0) {
    mbar_wait(kv_full, 0);
    if (cw == 1) bar_arrive(kPFree);  // the P^T buffer starts free
  }
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES;
    const int q0 = (qt_start + i) * C::kM;
    const uint32_t sQ = sRing + 2 * st * C::kTileBytes;
    const uint32_t sDO = sQ + C::kTileBytes;
    const float* lse = stat + st * 2 * C::kM;
    const float* delta = lse + C::kM;
    mbar_wait(full + 8 * st, (i / STAGES) & 1);

    // Consumer V: S^T = K Q^T; consumer K: dP^T = V dO^T.
    float sc[C::kM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      Wgmma<C::kM>::ss(sc, kmajor_desc<C::kN>(cw == 0 ? sK : sV, 0, kk),
                       kmajor_desc<C::kM>(cw == 0 ? sQ : sDO, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Consumer V: P^T = exp(S^T scale - lse) (lse is given: no running
    // max), masked only in a tile that crosses the diagonal or the end of
    // the queries, handed to consumer K in f32 in this thread's fragment
    // order (thread tid of both consumers holds the same rows and
    // columns). Consumer K: dS^T = P^T (dP^T - delta) scale from it.
    float x[C::kM / 2];
    if (cw == 0) {
      const bool masked = k0 + C::kN - 1 > p.q_offset + q0 ||
                          q0 + C::kM > p.Sq;
#pragma unroll
      for (int j = 0; j < C::kM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = acc_col(j, e, lane);
          float v = exp2f(sc[4 * j + e] * scale_log2 - lse[c] * kLog2e);
          if (masked) {
            const int q_row = q0 + c;
            if (q_row >= p.Sq || p.q_offset + q_row < k_pos0 + 8 * (e / 2)) {
              v = 0.0f;
            }
          }
          x[4 * j + e] = v;
        }
      }
      bar_sync(kPFree);
#pragma unroll
      for (int j = 0; j < C::kM / 8; ++j) {
        pbuf[j * kWgThreads + tid] = make_float4(x[4 * j], x[4 * j + 1],
                                                 x[4 * j + 2], x[4 * j + 3]);
      }
      bar_arrive(kPFull);
    } else {
      bar_sync(kPFull);
#pragma unroll
      for (int j = 0; j < C::kM / 8; ++j) {
        const float4 v = pbuf[j * kWgThreads + tid];
        x[4 * j] = v.x;
        x[4 * j + 1] = v.y;
        x[4 * j + 2] = v.z;
        x[4 * j + 3] = v.w;
      }
      if (i + 1 < n) bar_arrive(kPFree);
#pragma unroll
      for (int j = 0; j < C::kM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[4 * j + e] = x[4 * j + e] *
                         (sc[4 * j + e] - delta[acc_col(j, e, lane)]) *
                         p.scale;
        }
      }
    }

    // dV += P^T dO (consumer V) or dK += dS^T Q (consumer K), A rounded
    // to bf16 as the reference casts it.
    uint32_t a[C::kM / 16][4];
    pack_p<C::kM>(x, a);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kM / 16; ++kk) {
      Wgmma<kD>::rs(acc, a[kk], mnmajor_desc<C::kM>(cw == 0 ? sDO : sQ, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    release_stage(empty + 8 * st);
  }

  const long long o_ss = (long long)p.H * kD;
  bf16* const out = cw == 0 ? p.out1 : p.out0;
  const long long at0 = (long long)b * p.Sk * o_ss + (long long)h * kD;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = k_pos0 + 8 * j;
    if (row < p.Sk) {
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + at0 + row * o_ss + acc_col(i, 0, lane)) =
            __floats2bfloat162_rn(acc[4 * i + 2 * j], acc[4 * i + 2 * j + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The tensor map of a bf16 (B, S, H, 256) tensor (tma.cuh's, in boxes of
// 64 columns x `rows` rows). Returns 0 or kBadTensorMap.
int encode_map(CUtensorMap* map, const void* ptr, long long B, long long S,
               long long H, long long sb, long long ss, long long sh,
               int rows) {
  return encode_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kD, B, S,
                    H, sb, ss, sh, rows) ? 0 : kBadTensorMap;
}

using FwdC = Fwd256Cfg<kFwd256N, kFwd256Stages>;
using DkvC = Dkv256Cfg<kDkv256Stages>;
const void* const kFwdFn = (const void*)flash_fwd_kernel<
    kD, kFwd256N, kFwd256Stages, kFwd256PingPong != 0>;
const void* const kDkvFn =
    (const void*)flash_bwd_dkv_kernel<kD, kDkv256Stages>;

int launch(const void* fn, size_t smem, int rows, int seq, const Tma256& tm,
           const Params& p, void* stream) {
  int err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  // The kernels read the grid's linear index head-major (block_tile).
  const dim3 grid(p.B * p.H, (seq + rows - 1) / rows);
  void* args[] = {(void*)&tm, (void*)&p};
  err = (int)cudaLaunchKernel(fn, grid, dim3(kThreads256), args, smem,
                              (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

// Rows [row0, row0 + R) of one (b, h) slice, loaded once by TMA and once
// by cp.async (load_sw_tile, the D <= 128 kernels' copy), both into the
// swizzled layout the wgmma descriptors read; each copy's shared-memory
// bytes go to their own output.
template <int R>
__global__ void __launch_bounds__(kWgThreads)
tma_tile_check_kernel(const __grid_constant__ CUtensorMap map,
                      const bf16* src, long long stride_s, int n_rows, int b,
                      int h, int row0, uint4* out_tma, uint4* out_cp) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kBytes = R * kTileRowBytes;
  const uint32_t tile_tma = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t tile_cp = tile_tma + kBytes;
  const uint32_t bar = tile_cp + kBytes;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, kBytes);
    tma_tile<R>(tile_tma, &map, bar, row0, h, b);
  }
  load_sw_tile<kD, R, kWgThreads>(tile_cp, src, stride_s, row0, n_rows);
  cp_async_commit();
  cp_async_wait<0>();
  mbar_wait(bar, 0);
  __syncthreads();
  const unsigned char* base = smem_raw + (tile_tma - smem_u32(smem_raw));
  const uint4* a = reinterpret_cast<const uint4*>(base);
  const uint4* c = reinterpret_cast<const uint4*>(base + kBytes);
  for (int i = threadIdx.x; i < kBytes / 16; i += kWgThreads) {
    out_tma[i] = a[i];
    out_cp[i] = c[i];
  }
}

}  // namespace

namespace rf_d256 {

int kernel_info(int which, const void** fn, int* threads, int* rows,
                size_t* smem) {
  *threads = kThreads256;
  if (which == 0) {
    *fn = kFwdFn;
    *rows = FwdC::kM;
    *smem = FwdC::kSmem;
    return 0;
  }
  if (which == 2) {
    *fn = kDkvFn;
    *rows = DkvC::kN;
    *smem = DkvC::kSmem;
    return 0;
  }
  return kBadKernel;
}

int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const long long* dims, float scale, void* stream) {
  Params p = make_params(dims, scale);
  p.out0 = (bf16*)o;
  p.stat_out = (float*)lse;
  Tma256 tm = {};
  int err = encode_map(&tm.q, q, p.B, p.Sq, p.H, p.q_sb, p.q_ss, p.q_sh,
                       FwdC::kM);
  if (!err) {
    err = encode_map(&tm.k, k, p.B, p.Sk, p.H, p.k_sb, p.k_ss, p.k_sh,
                     kFwd256N);
  }
  if (!err) {
    err = encode_map(&tm.v, v, p.B, p.Sk, p.H, p.v_sb, p.v_ss, p.v_sh,
                     kFwd256N);
  }
  if (err) return err;
  return launch(kFwdFn, FwdC::kSmem, FwdC::kM, p.Sq, tm, p, stream);
}

int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv,
        const long long* dims, float scale, void* stream) {
  Params p = make_params(dims, scale);
  p.lse_in = (const float*)lse;
  p.delta_in = (const float*)delta;
  p.out0 = (bf16*)dk;
  p.out1 = (bf16*)dv;
  Tma256 tm = {};
  int err = encode_map(&tm.q, q, p.B, p.Sq, p.H, p.q_sb, p.q_ss, p.q_sh,
                       DkvC::kM);
  if (!err) {
    err = encode_map(&tm.k, k, p.B, p.Sk, p.H, p.k_sb, p.k_ss, p.k_sh,
                     DkvC::kN);
  }
  if (!err) {
    err = encode_map(&tm.v, v, p.B, p.Sk, p.H, p.v_sb, p.v_ss, p.v_sh,
                     DkvC::kN);
  }
  if (!err) {
    err = encode_map(&tm.d, dout, p.B, p.Sq, p.H, p.do_sb, p.do_ss, p.do_sh,
                     DkvC::kM);
  }
  if (err) return err;
  return launch(kDkvFn, DkvC::kSmem, DkvC::kN, p.Sk, tm, p, stream);
}

}  // namespace rf_d256

extern "C" {

// Loads rows [row0, row0 + rows) of head h, batch b of the bf16
// (B, S, H, 256) tensor x (dims: B, S, H, then its element strides sb,
// ss, sh) by TMA and by cp.async into shared memory and writes each
// copy's bytes (rows x 512) to out_tma and out_cp. rows: 64, 80 or 128.
int rf_tma_tile_check(const void* x, const long long* dims, int b, int h,
                      int row0, int rows, void* out_tma, void* out_cp,
                      void* stream) {
  const void* fn;
  switch (rows) {
    case 64: fn = (const void*)tma_tile_check_kernel<64>; break;
    case 80: fn = (const void*)tma_tile_check_kernel<80>; break;
    case 128: fn = (const void*)tma_tile_check_kernel<128>; break;
    default: return kBadKernel;
  }
  CUtensorMap map;
  int err = encode_map(&map, x, dims[0], dims[1], dims[2], dims[3], dims[4],
                       dims[5], rows);
  if (err) return err;
  const size_t smem = 2 * (size_t)rows * kTileRowBytes + 8 + 1024;
  err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const bf16* src = (const bf16*)x + b * dims[3] + h * dims[5];
  long long stride_s = dims[4];
  int n_rows = (int)dims[1];
  uint4* out_a = (uint4*)out_tma;
  uint4* out_b = (uint4*)out_cp;
  void* args[] = {(void*)&map, (void*)&src, (void*)&stride_s, (void*)&n_rows,
                  (void*)&b, (void*)&h, (void*)&row0, (void*)&out_a,
                  (void*)&out_b};
  err = (int)cudaLaunchKernel(fn, dim3(1), dim3(kWgThreads), args, smem,
                              (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
