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

// Causal flash attention for Hopper (sm_90a): forward, dQ pass, dK/dV pass.
//
// These three kernels replace the Pallas TPU kernels of
// rayfed_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _flash_kernel          (K1)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (K2)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (K3)
//
// Contract shared with the Pallas kernels and with the plain PyTorch
// versions in rayfed_tpu_torch/ops/flash_attention.py: q is (B, Sq, H, D),
// k/v/dout (B, Sk, H, D) (dout is (B, Sq, H, D)), bf16, read through their
// (b, s, h) element strides with a unit stride on D; scale = D**-0.5;
// causal with query positions shifted by q_offset; masked scores are
// -1e30 (not -inf); l is clamped at 1e-30; all accumulation is f32; the
// probabilities are cast to bf16 before P.V and P^T.dO, and dS before dS.K
// and dS^T.Q, exactly where the reference casts. Outputs are contiguous:
// o/dq/dk/dv (B, S, H, D) bf16, lse/delta (B, Sq, H) f32.
//
// What bounds them on this card: at the main path's shape (S = 2048,
// D = 128) every kernel does ~S/2 multiply-adds per byte it must move, far
// above the H100's ~295 FLOP/byte ridge, so they are bound by tensor-core
// operations, not memory. Every kernel keeps the S x S scores out of
// device memory and skips every tile above the causal diagonal. There are
// no atomics: dQ and dK/dV are two passes, so gradients are deterministic
// as in the reference.
//
// All three are built for Hopper's warpgroup MMA (wgmma), the only route
// to the card's tensor-core rate. Each warpgroup (128 threads) owns 64
// rows (queries in K1 and K2, keys in K3) and a block holds two, which
// share the streamed tiles (K1: 128 queries against 128-key K/V tiles; K2:
// 128 queries, resident with their dO, against 64-key K/V tiles; K3: 128
// keys, resident with their V, against 64-query Q/dO/lse/delta tiles).
// Tiles sit in shared memory in the layout of the 128-byte swizzle that
// wgmma reads through a matrix descriptor; they arrive by cp.async (which
// reads the (b, s, h) strides and zero-fills ragged rows) into a two-stage
// ring, so the copy of tile i+1 runs while tile i is computed. Scores come
// out of wgmma in registers, the softmax (or, in the backward passes, P and
// dS from the given lse) runs there (a row lives on the four lanes of a
// quad), and the bf16 probabilities or dS are fed straight back as the
// register A operand of the next wgmma: no score, probability, dS or
// partial output tile goes through shared memory.
//
// Those tiles are the plan for head dims 16, 32, 64 and 128. At D = 256 a
// 64-row f32 accumulator 256 wide is 128 registers a thread and a 256-wide
// tile twice the bytes: K2 keeps this file's shape with 32-key stages
// (kDqWG256, kDqN256), while K1 and K3 are warp-specialised kernels of
// their own (flash_attention_d256.cu: a TMA producer warpgroup and two
// consumers; K3 holds dV in one consumer and dK in the other), to which
// the C entry points below hand D = 256. The tiles, descriptors and wgmma
// instructions both files use are in wgmma.cuh.

#include "flash_attention_d256.cuh"
#include "wgmma.cuh"

namespace {

// Key/value tile kt (N rows each) into stage st of a two-stage ring of
// (K, V) pairs at ring (K1 and K2).
template <int D, int N, int T>
__device__ __forceinline__ void load_kv_stage(uint32_t ring, int st, int kt,
                                              const bf16* kb, const bf16* vb,
                                              const Params& p) {
  const uint32_t sK = ring + 2 * st * sw_bytes<D, N>();
  load_sw_tile<D, N, T>(sK, kb, p.k_ss, kt * N, p.Sk);
  load_sw_tile<D, N, T>(sK + sw_bytes<D, N>(), vb, p.v_ss, kt * N, p.Sk);
}

// ---------------------------------------------------------------------------
// K1: the forward
// ---------------------------------------------------------------------------

// kWG warpgroups share one block's key/value ring, each owning 64 query
// rows; kN keys per ring stage.
template <int D, int kWG, int kN_>
struct FwdCfg {
  static constexpr int kM = 64 * kWG;  // query rows per block
  static constexpr int kN = kN_;       // key rows per ring stage
  static constexpr int kThreads = kWgThreads * kWG;
  static constexpr int kQBytes = sw_bytes<D, kM>();
  static constexpr int kKVBytes = sw_bytes<D, kN>();
  // Q, a two-stage ring of (K, V), and slack to align the base to 1024.
  static constexpr size_t kSmem = kQBytes + 4 * kKVBytes + 1024;
};
// Two warpgroups (128 query rows) share each key/value tile, halving the
// bytes a FLOP pulls through L2 against one; 128-key stages take wgmma's
// n128 shape. 255 registers, no spills at D = 128; one block per SM.
constexpr int kFwdWG = 2;
constexpr int kFwdN = 128;
// One block per (b * h, q tile), the heaviest (last) q tiles first. Online
// softmax over the key tiles at or below the block's last query row.
template <int D, int kWG, int kN>
__global__ void __launch_bounds__(kWgThreads * kWG)
flash_fwd_kernel(const Params p) {
  using C = FwdCfg<D, kWG, kN>;
  constexpr int kDp = dpad<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sRing = sQ + C::kQBytes;  // stage s: K, then V

  const int wg = threadIdx.x / kWgThreads;
  const int warp = threadIdx.x % kWgThreads / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kM;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;

  const int q_last = p.q_offset + min(q0 + C::kM, p.Sq) - 1;
  const int n_kt = min(q_last / C::kN + 1, (p.Sk + C::kN - 1) / C::kN);

  load_sw_tile<D, C::kM, C::kThreads>(sQ, qb, p.q_ss, q0, p.Sq);
  load_kv_stage<D, C::kN, C::kThreads>(sRing, 0, 0, kb, vb, p);
  cp_async_commit();

  // This thread's two rows of the warpgroup's 64 (see acc_col).
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int q_pos0 = p.q_offset + q0 + r0;
  // Tiles reaching past the warpgroup's first query need the mask.
  const int wg_q_first = p.q_offset + q0 + wg * 64;
  const float scale_log2 = p.scale * kLog2e;
  // Running max (of the scaled score, in log2 units) and sum of each row.
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.0f, 0.0f};
  float o[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) o[i] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const uint32_t sK = sRing + 2 * st * C::kKVBytes;
    const uint32_t sV = sK + C::kKVBytes;
    if (kt + 1 < n_kt) {
      load_kv_stage<D, C::kN, C::kThreads>(sRing, st ^ 1, kt + 1, kb, vb, p);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // key tile kt has landed in stage st
    const int k0 = kt * C::kN;

    // S = Q K^T for this warpgroup's 64 rows.
    float s[C::kN / 2];
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<C::kN>::ss(s, kmajor_desc<C::kM>(sQ, wg * 64, kk),
                       kmajor_desc<C::kN>(sK, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scale into log2 units; mask only a tile that crosses the diagonal or
    // the end of the keys.
    const bool masked = k0 + C::kN - 1 > wg_q_first || k0 + C::kN > p.Sk;
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int i = 0; i < C::kN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * scale_log2;
        if (masked) {
          const int k_pos = k0 + acc_col(i, e, lane);
          if (k_pos > q_pos0 + 8 * (e / 2) || k_pos >= p.Sk) x = kNegBig;
        }
        s[4 * i + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      alpha[j] = exp2f(m[j] - m_new);
      m[j] = m_new;
    }
    // P = exp(S - m) into bf16 A fragments; this lane's partial row sums.
    uint32_t a[C::kN / 16][4];
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < C::kN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float p0 = exp2f(s[4 * i + e] - m[e / 2]);
        const float p1 = exp2f(s[4 * i + e + 1] - m[e / 2]);
        sum[e / 2] += p0 + p1;
        a[i / 2][2 * (i % 2) + e / 2] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
#pragma unroll
    for (int i = 0; i < kDp / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] *= alpha[e / 2];
    }

    // O += P V, P straight from registers.
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kN / 16; ++kk) {
      Wgmma<kDp>::rs(o, a[kk], mnmajor_desc<C::kN>(sV, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(a);
    __syncthreads();  // stage st is free for tile kt + 2
  }

  // Each row's sum is spread over the four lanes of its quad.
  const long long o_ss = (long long)p.H * D;
  bf16* ob = p.out0 + (long long)b * p.Sq * o_ss + (long long)h * D;
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
      for (int i = 0; i < kDp / 8; ++i) {
        const int c = acc_col(i, 0, lane);
        if (c < D) {
          *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + c) =
              __floats2bfloat162_rn(o[4 * i + 2 * j] / l_safe,
                                    o[4 * i + 2 * j + 1] / l_safe);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the dQ pass
// ---------------------------------------------------------------------------

// kWG warpgroups share one block's key/value ring, each owning 64 query
// rows (with their dO); kN keys per ring stage.
template <int D, int kWG, int kN_>
struct DqCfg {
  static constexpr int kM = 64 * kWG;  // query rows per block
  static constexpr int kN = kN_;       // key rows per ring stage
  static constexpr int kThreads = kWgThreads * kWG;
  static constexpr int kQBytes = sw_bytes<D, kM>();
  static constexpr int kKVBytes = sw_bytes<D, kN>();
  // Q and dO resident, a two-stage ring of (K, V), and slack to align the
  // base to 1024.
  static constexpr size_t kSmem = 2 * kQBytes + 4 * kKVBytes + 1024;
};
// Two warpgroups (128 query rows) share each key/value tile; 64-key
// stages.
constexpr int kDqWG = 2;
constexpr int kDqN = 64;
// D = 256: resident Q and dO take 128 KiB, so the ring steps 32 keys (64
// KiB); dQ is 128 registers a thread, S, dP and dS 40 more.
constexpr int kDqWG256 = 2;
constexpr int kDqN256 = 32;

// One block per (b * h, q tile), the heaviest (last) q tiles first. Per key
// stage each warpgroup forms S = Q K^T and dP = dO V^T for its 64 rows,
// P = exp(S scale - lse) from the given lse (no running max) and
// dS = P (dP - delta) scale in registers, and accumulates dQ += dS K with
// dS as the register A operand; dQ stays in f32 registers throughout. Its
// prologue computes delta = rowsum(dO * O) in f32, which the dK/dV pass
// reads, while the first key stage is in flight.
template <int D, int kWG, int kN>
__global__ void __launch_bounds__(kWgThreads * kWG)
flash_bwd_dq_kernel(const Params p) {
  using C = DqCfg<D, kWG, kN>;
  constexpr int kDp = dpad<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + C::kQBytes;
  const uint32_t sRing = sDO + C::kQBytes;  // stage s: K, then V

  const int wg = threadIdx.x / kWgThreads;
  const int warp = threadIdx.x % kWgThreads / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kM;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;

  const int q_last = p.q_offset + min(q0 + C::kM, p.Sq) - 1;
  const int n_kt = min(q_last / C::kN + 1, (p.Sk + C::kN - 1) / C::kN);

  load_sw_tile<D, C::kM, C::kThreads>(sQ, qb, p.q_ss, q0, p.Sq);
  load_sw_tile<D, C::kM, C::kThreads>(sDO, dob, p.do_ss, q0, p.Sq);
  load_kv_stage<D, C::kN, C::kThreads>(sRing, 0, 0, kb, vb, p);
  cp_async_commit();

  // This thread's two rows of the warpgroup's 64 (see acc_col).
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int q_pos0 = p.q_offset + q0 + r0;
  // Tiles reaching past the warpgroup's first query need the mask.
  const int wg_q_first = p.q_offset + q0 + wg * 64;
  const float scale_log2 = p.scale * kLog2e;

  // delta and lse of the two rows, in the quad that owns them: each lane
  // sums every fourth 8-column chunk of dO * O (read from device memory
  // while the tiles land), two shuffles join the four partial sums. Rows
  // past Sq read nothing and take lse = delta = 0.
  float lse2[2], delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r0 + 8 * j;
    const bool valid = row < p.Sq;
    float d = 0.0f;
    if (valid) {
      const bf16* orow = ob + (long long)row * p.o_ss;
      const bf16* dorow = dob + (long long)row * p.do_ss;
#pragma unroll
      for (int c = 8 * (lane % 4); c < D; c += 32) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dorow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 of = __bfloat1622float2(o2[x]);
          const float2 df = __bfloat1622float2(d2[x]);
          d += df.x * of.x + df.y * of.y;
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const long long idx = ((long long)b * p.Sq + row) * p.H + h;
    delta[j] = d;
    lse2[j] = valid ? p.lse_in[idx] * kLog2e : 0.0f;
    if (valid && lane % 4 == 0) p.stat_out[idx] = d;
  }

  float dq[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) dq[i] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const uint32_t sK = sRing + 2 * st * C::kKVBytes;
    const uint32_t sV = sK + C::kKVBytes;
    if (kt + 1 < n_kt) {
      load_kv_stage<D, C::kN, C::kThreads>(sRing, st ^ 1, kt + 1, kb, vb, p);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // keys and values of step kt have landed in stage st
    const int k0 = kt * C::kN;

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows.
    float s[C::kN / 2];
    float dp[C::kN / 2];
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) {
      s[i] = 0.0f;
      dp[i] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<C::kN>::ss(s, kmajor_desc<C::kM>(sQ, wg * 64, kk),
                       kmajor_desc<C::kN>(sK, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<C::kN>::ss(dp, kmajor_desc<C::kM>(sDO, wg * 64, kk),
                       kmajor_desc<C::kN>(sV, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S scale - lse) stays f32; dS = P (dP - delta) scale is
    // rounded to bf16 once, into A fragments. Mask only a tile that
    // crosses the diagonal or the end of the keys (zero-filled keys past
    // Sk score 0, not -1e30).
    const bool masked = k0 + C::kN - 1 > wg_q_first || k0 + C::kN > p.Sk;
    uint32_t a[C::kN / 16][4];
#pragma unroll
    for (int i = 0; i < C::kN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        float ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float pr = exp2f(s[4 * i + e + x] * scale_log2 - lse2[e / 2]);
          if (masked) {
            const int k_pos = k0 + acc_col(i, e + x, lane);
            if (k_pos > q_pos0 + 8 * (e / 2) || k_pos >= p.Sk) pr = 0.0f;
          }
          ds[x] = pr * (dp[4 * i + e + x] - delta[e / 2]) * p.scale;
        }
        a[i / 2][2 * (i % 2) + e / 2] = pack_bf16(ds[0], ds[1]);
      }
    }

    // dQ += dS K, dS straight from registers, K read MN-major.
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kN / 16; ++kk) {
      Wgmma<kDp>::rs(dq, a[kk], mnmajor_desc<C::kN>(sK, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(a);
    __syncthreads();  // stage st is free for tile kt + 2
  }

  const long long o_ss = (long long)p.H * D;
  bf16* dqb = p.out0 + (long long)b * p.Sq * o_ss + (long long)h * D;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r0 + 8 * j;
    if (row < p.Sq) {
#pragma unroll
      for (int i = 0; i < kDp / 8; ++i) {
        const int c = acc_col(i, 0, lane);
        if (c < D) {
          *reinterpret_cast<__nv_bfloat162*>(dqb + row * o_ss + c) =
              __floats2bfloat162_rn(dq[4 * i + 2 * j], dq[4 * i + 2 * j + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the dK/dV pass
// ---------------------------------------------------------------------------

// kWG warpgroups share one block's query ring, each owning 64 keys.
template <int D, int kWG, int kM_>
struct DkvCfg {
  static constexpr int kN = 64 * kWG;  // key rows per block
  static constexpr int kM = kM_;       // query rows per ring stage
  static constexpr int kThreads = kWgThreads * kWG;
  static constexpr int kKBytes = sw_bytes<D, kN>();
  static constexpr int kQBytes = sw_bytes<D, kM>();
  // K and V resident; a two-stage ring of (Q, dO) tiles and (lse, delta)
  // rows; slack to align the base to 1024.
  static constexpr size_t kSmem =
      2 * kKBytes + 4 * kQBytes + 2 * 2 * kM * sizeof(float) + 1024;
};
// Two warpgroups (128 keys) share each query tile; 64-query stages. With one
// warpgroup a 64-query stage spills (dK and dV alone hold 128 registers),
// with two it does not: 255 registers at D = 128, one block per SM.
constexpr int kDkvWG = 2;
constexpr int kDkvM = 64;
// One block per (b * h, k tile), k tiles in order (the first keys see the
// most queries, so the heaviest blocks start first). Streams the q tiles
// from the diagonal on, in the transposed orientation (rows are keys): the
// warpgroup holds dK and dV for its 64 keys in f32 registers throughout.
template <int D, int kWG, int kM>
__global__ void __launch_bounds__(kWgThreads * kWG)
flash_bwd_dkv_kernel(const Params p) {
  using C = DkvCfg<D, kWG, kM>;
  constexpr int kDp = dpad<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + C::kKBytes;
  const uint32_t sQ0 = sV + C::kKBytes;  // stage s: Q, then dO
  const uint32_t sStat = sQ0 + 4 * C::kQBytes;  // stage s: lse[kM], delta[kM]
  const float* stat = reinterpret_cast<const float*>(
      smem_raw + (sStat - smem_u32(smem_raw)));

  const int wg = threadIdx.x / kWgThreads;
  const int warp = threadIdx.x % kWgThreads / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * C::kN;
  const int wg_k0 = k0 + wg * 64;  // this warpgroup's first key

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat_b = (long long)b * p.Sq * p.H + h;

  // Query rows below k0 - q_offset see none of these keys.
  const int qt_start = max(0, k0 - p.q_offset) / C::kM;
  const int n_qt = (p.Sq + C::kM - 1) / C::kM;

  // The q tile qt's Q, dO, lse and delta into ring stage st.
  auto load_stage = [&](int st, int qt) {
    const int q0 = qt * C::kM;
    const uint32_t q_tile = sQ0 + 2 * st * C::kQBytes;
    load_sw_tile<D, C::kM, C::kThreads>(q_tile, qb, p.q_ss, q0, p.Sq);
    load_sw_tile<D, C::kM, C::kThreads>(q_tile + C::kQBytes, dob, p.do_ss,
                                        q0, p.Sq);
    const int t = threadIdx.x;
    if (t < 2 * C::kM) {
      const int r = t % C::kM;
      const bool valid = q0 + r < p.Sq;
      const float* src = t < C::kM ? p.lse_in : p.delta_in;
      cp_async4(sStat + (2 * st * C::kM + t) * sizeof(float),
                valid ? src + stat_b + (long long)(q0 + r) * p.H : src, valid);
    }
  };

  // K and V join the first q tile's copy group.
  if (qt_start < n_qt) {
    load_sw_tile<D, C::kN, C::kThreads>(sK, kb, p.k_ss, k0, p.Sk);
    load_sw_tile<D, C::kN, C::kThreads>(sV, vb, p.v_ss, k0, p.Sk);
    load_stage(0, qt_start);
    cp_async_commit();
  }

  // This thread's two key rows (see acc_col).
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int k_pos0 = k0 + r0;
  const float scale_log2 = p.scale * kLog2e;
  float dk[kDp / 2];
  float dv[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  for (int qt = qt_start; qt < n_qt; ++qt) {
    const int st = (qt - qt_start) & 1;
    const uint32_t sQ = sQ0 + 2 * st * C::kQBytes;
    const uint32_t sDO = sQ + C::kQBytes;
    const float* lse = stat + 2 * st * C::kM;
    const float* delta = lse + C::kM;
    if (qt + 1 < n_qt) {
      load_stage(st ^ 1, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    const int q0 = qt * C::kM;
    __syncthreads();  // query tile qt has landed in stage st

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys.
    float s[C::kM / 2];
    float dp[C::kM / 2];
#pragma unroll
    for (int i = 0; i < C::kM / 2; ++i) {
      s[i] = 0.0f;
      dp[i] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<C::kM>::ss(s, kmajor_desc<C::kN>(sK, wg * 64, kk),
                       kmajor_desc<C::kM>(sQ, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<C::kM>::ss(dp, kmajor_desc<C::kN>(sV, wg * 64, kk),
                       kmajor_desc<C::kM>(sDO, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T scale - lse) (no running max: lse is given) and
    // dS^T = P^T (dP^T - delta) scale, both into bf16 A fragments. Mask
    // only a tile that crosses the diagonal or the end of the queries.
    const bool masked = wg_k0 + 63 > p.q_offset + q0 || q0 + C::kM > p.Sq;
    uint32_t pa[C::kM / 16][4];
    uint32_t da[C::kM / 16][4];
#pragma unroll
    for (int i = 0; i < C::kM / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        float pr[2], ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = acc_col(i, e + x, lane);
          float v = exp2f(s[4 * i + e + x] * scale_log2 - lse[c] * kLog2e);
          if (masked) {
            const int q_row = q0 + c;
            if (q_row >= p.Sq || p.q_offset + q_row < k_pos0 + 8 * (e / 2)) {
              v = 0.0f;
            }
          }
          pr[x] = v;
          ds[x] = v * (dp[4 * i + e + x] - delta[c]) * p.scale;
        }
        pa[i / 2][2 * (i % 2) + e / 2] = pack_bf16(pr[0], pr[1]);
        da[i / 2][2 * (i % 2) + e / 2] = pack_bf16(ds[0], ds[1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands from registers.
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kM / 16; ++kk) {
      Wgmma<kDp>::rs(dv, pa[kk], mnmajor_desc<C::kM>(sDO, kk));
    }
#pragma unroll
    for (int kk = 0; kk < C::kM / 16; ++kk) {
      Wgmma<kDp>::rs(dk, da[kk], mnmajor_desc<C::kM>(sQ, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    __syncthreads();  // stage st is free for tile qt + 2
  }

  const long long o_ss = (long long)p.H * D;
  const long long base = (long long)b * p.Sk * o_ss + (long long)h * D;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = k0 + r0 + 8 * j;
    if (row < p.Sk) {
#pragma unroll
      for (int i = 0; i < kDp / 8; ++i) {
        const int c = acc_col(i, 0, lane);
        if (c < D) {
          const long long at = base + row * o_ss + c;
          *reinterpret_cast<__nv_bfloat162*>(p.out0 + at) =
              __floats2bfloat162_rn(dk[4 * i + 2 * j], dk[4 * i + 2 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(p.out1 + at) =
              __floats2bfloat162_rn(dv[4 * i + 2 * j], dv[4 * i + 2 * j + 1]);
        }
      }
    }
  }
}

// A kernel instantiation with its launch shape: threads and shared memory
// a block, and the rows of the tiled sequence (Sq for K1 and K2, Sk for
// K3) a block owns.
struct Kernel {
  const void* fn;
  int threads;
  int rows;
  size_t smem;
};

// Each kernel's tile plan at head dim D: the D <= 128 plan, or, for K2,
// the D = 256 one (K1 and K3 at D = 256 are flash_attention_d256.cu's).
template <int D>
Kernel fwd_kernel() {
  using C = FwdCfg<D, kFwdWG, kFwdN>;
  return {(const void*)flash_fwd_kernel<D, kFwdWG, kFwdN>, C::kThreads,
          C::kM, C::kSmem};
}
template <int D>
Kernel dq_kernel() {
  constexpr int kWG = D > 128 ? kDqWG256 : kDqWG;
  constexpr int kN = D > 128 ? kDqN256 : kDqN;
  using C = DqCfg<D, kWG, kN>;
  return {(const void*)flash_bwd_dq_kernel<D, kWG, kN>, C::kThreads, C::kM,
          C::kSmem};
}
template <int D>
Kernel dkv_kernel() {
  using C = DkvCfg<D, kDkvWG, kDkvM>;
  return {(const void*)flash_bwd_dkv_kernel<D, kDkvWG, kDkvM>, C::kThreads,
          C::kN, C::kSmem};
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
      if (which == 1) {
        *out = dq_kernel<256>();
        break;
      }
      *out = {nullptr, 0, 0, 0};
      return rf_d256::kernel_info(which, &out->fn, &out->threads, &out->rows,
                                  &out->smem);
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
  // b * h first, so that the heaviest tiles of every head run in the
  // first wave.
  const dim3 grid(p.B * p.H, n_tiles);
  void* args[] = {(void*)&p};
  err = (int)cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, k.smem,
                              (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rf_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, const long long* dims, float scale,
                 void* stream) {
  if (dims[4] == 256) return rf_d256::fwd(q, k, v, o, lse, dims, scale, stream);
  Params p = make_params(dims, scale);
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.out0 = (bf16*)o;
  p.stat_out = (float*)lse;
  return launch(0, p, dims[4], stream);
}

int rf_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* dq, void* delta, const long long* dims,
                    float scale, void* stream) {
  Params p = make_params(dims, scale);
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.o = (const bf16*)o;
  p.dout = (const bf16*)dout;
  p.lse_in = (const float*)lse;
  p.out0 = (bf16*)dq;
  p.stat_out = (float*)delta;
  return launch(1, p, dims[4], stream);
}

int rf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, const long long* dims, float scale,
                     void* stream) {
  if (dims[4] == 256) {
    return rf_d256::dkv(q, k, v, dout, lse, delta, dk, dv, dims, scale,
                        stream);
  }
  Params p = make_params(dims, scale);
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.dout = (const bf16*)dout;
  p.lse_in = (const float*)lse;
  p.delta_in = (const float*)delta;
  p.out0 = (bf16*)dk;
  p.out1 = (bf16*)dv;
  return launch(2, p, dims[4], stream);
}

// Resources of kernel `which` (0 = K1, 1 = K2, 2 = K3) at head dim
// `head_dim`: out = {registers per thread, dynamic shared memory bytes,
// threads per block, resident blocks per SM}.
int rf_kernel_resources(int which, int head_dim, int* out) {
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

// Rows of the tiled sequence one block of kernel `which` owns at head dim
// `head_dim` (the launch grid's y dimension counts these tiles).
int rf_kernel_rows(int which, int head_dim, int* rows) {
  Kernel k;
  int err = find_kernel(which, head_dim, &k);
  if (err) return err;
  *rows = k.rows;
  return 0;
}

const char* rf_error_string(int code) {
  if (code == kBadHeadDim) {
    return "no kernel at this head dim (16, 32, 64, 128 or 256)";
  }
  if (code == kBadKernel) return "no such kernel";
  if (code == kBadTensorMap) {
    return "the TMA tensor map refused the layout (cuTensorMapEncodeTiled "
           "takes a 16-byte aligned start and (b, s, h) strides that are "
           "multiples of 16 bytes)";
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
