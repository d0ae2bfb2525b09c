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
// What bounds them on this card: exact f32 leaves two routes, FFMA on the
// CUDA cores (67 TFLOP/s) or a product split into three TF32 products on
// the tensor cores (3 x 1/495 TFLOP/s, the faster bound). These kernels
// take the first: wgmma rounds its f32 operands to TF32 (10-bit mantissa),
// about three digits, far from the 2e-5 the reference's f32 tests hold.
// At the main path's shape every kernel does ~S/2 multiply-adds per byte it
// must move, so they are bound by operations. The design is the simple
// one: a block of 256 threads owns 64 rows (queries in K1 and K2, keys in
// K3) of one (batch, head), keeps them in shared memory, and streams the
// other side in 64-row tiles through shared memory, stopping at the causal
// diagonal. Thread (ty, tx) of the 16 x 16 holds the scores of rows
// 4 ty .. 4 ty + 3 against columns tx + 16 j (j < 4), reads both operands
// as float4 along D from tiles padded to a row stride of D + 4 floats
// (conflict-free), and keeps the softmax of its rows in registers, reduced
// over the 16 lanes that share them. P (or dS) goes through one 64 x 68
// shared tile into the second product, where the same thread owns the
// same rows and D / 16 columns of the output. The S x S scores never reach
// device memory, and there are no atomics: dQ and dK/dV are two passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kT = 64;         // rows of every tile, the block's and streamed
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = kT + 4;    // row stride (floats) of a 64 x 64 score tile
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int kLD = D + 4;        // row stride of a 64 x D tile
  static constexpr int kTile = kT * kLD;   // floats of one 64 x D tile
  static constexpr int kVec = D >= 64 ? 4 : D / 16;  // output columns per load
  static constexpr int kCols = D / 16;     // output columns per thread
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse_in;
  const float* delta_in;
  float* out0;      // o (fwd), dq (dq pass), dk (dkv pass)
  float* out1;      // dv (dkv pass)
  float* stat_out;  // lse (fwd), delta (dq pass)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  int B, H, Sq, Sk, q_offset;
  float scale;
};

__device__ __forceinline__ float comp(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// Rows row0 .. row0 + 63 of one (b, h) slice (`src` at its row 0, rows
// `row_stride` elements apart) into a 64 x D tile; rows at or past
// `n_rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kV = D / 4;
  for (int i = threadIdx.x; i < kT * kV; i += kThreads) {
    const int r = i / kV, c = (i % kV) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      x = *reinterpret_cast<const float4*>(
          src + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * Cfg<D>::kLD + c) = x;
  }
}

// s[i][j] += A[4 ty + i] . B[tx + 16 j] over D (both 64 x D tiles).
template <int D>
__device__ __forceinline__ void scores(const float* A, const float* B,
                                       float (&s)[4][4]) {
  constexpr int kLD = Cfg<D>::kLD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * kLD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kLD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
    }
  }
}

// Column c (< D / 16) of this thread's share of a D-wide row: whole
// vectors of kVec columns, 16 kVec columns apart.
template <int D>
__device__ __forceinline__ int out_col(int c, int tx) {
  constexpr int kVec = Cfg<D>::kVec;
  return (c / kVec) * 16 * kVec + tx * kVec + c % kVec;
}

// This thread's D / 16 columns of row `row` (a pointer to its element 0).
template <int D>
__device__ __forceinline__ void load_cols(const float* row, int tx,
                                          float (&m)[Cfg<D>::kCols]) {
  constexpr int kVec = Cfg<D>::kVec;
#pragma unroll
  for (int g = 0; g < Cfg<D>::kCols / kVec; ++g) {
    const float* at = row + g * 16 * kVec + tx * kVec;
    if constexpr (kVec == 4) {
      const float4 x = *reinterpret_cast<const float4*>(at);
      m[4 * g] = x.x; m[4 * g + 1] = x.y; m[4 * g + 2] = x.z; m[4 * g + 3] = x.w;
    } else if constexpr (kVec == 2) {
      const float2 x = *reinterpret_cast<const float2*>(at);
      m[2 * g] = x.x; m[2 * g + 1] = x.y;
    } else {
      m[g] = *at;
    }
  }
}

template <int D>
__device__ __forceinline__ void store_cols(float* row, int tx,
                                           const float (&m)[Cfg<D>::kCols]) {
  constexpr int kVec = Cfg<D>::kVec;
#pragma unroll
  for (int g = 0; g < Cfg<D>::kCols / kVec; ++g) {
    float* at = row + g * 16 * kVec + tx * kVec;
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(at) =
          make_float4(m[4 * g], m[4 * g + 1], m[4 * g + 2], m[4 * g + 3]);
    } else if constexpr (kVec == 2) {
      *reinterpret_cast<float2*>(at) = make_float2(m[2 * g], m[2 * g + 1]);
    } else {
      *at = m[g];
    }
  }
}

// acc[i][c] += sum over kk < 64 of P[4 ty + i][kk] * M[kk][out_col(c)]
// (P a 64 x 64 score tile, M a 64 x D tile).
template <int D>
__device__ __forceinline__ void pv(const float* P, const float* M,
                                   float (&acc)[4][Cfg<D>::kCols]) {
  constexpr int kLD = Cfg<D>::kLD, kCols = Cfg<D>::kCols;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int kk = 0; kk < kT; kk += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pr[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kLP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float m[kCols];
      load_cols<D>(M + (kk + u) * kLD, tx, m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = comp(pr[i], u);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(x, m[c], acc[i][c]);
      }
    }
  }
}

// Max and sum over the 16 lanes that hold one row's scores.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Index of element 0 of (b, row, h) in a contiguous (B, S, H, D) output.
__device__ __forceinline__ long long out_row(const Params& p, int b, int S,
                                             int row, int h, int D) {
  return (((long long)b * S + row) * p.H + h) * D;
}

// ---------------------------------------------------------------------------
// K1: the forward. One block per (b, h) and 64-query tile; online softmax
// over the 64-key tiles up to the tile's last query position.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + C::kTile;
  float* Vs = Ks + C::kTile;
  float* Ps = Vs + C::kTile;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  // The last query tiles see the most keys: they go in the first wave.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);

  const int last_q = p.q_offset + min(q0 + kT - 1, p.Sq - 1);
  const int n_kt = min(last_q / kT + 1, (p.Sk + kT - 1) / kT);
  float m[4], l[4], acc[4][C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the last step is done with Ks, Vs and Ps
    load_tile<D>(Ks, k, p.k_ss, k0, p.Sk);
    load_tile<D>(Vs, v, p.v_ss, k0, p.Sk);
    __syncthreads();  // key tile kt has landed
    float s[4][4] = {};
    scores<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = p.q_offset + q0 + 4 * ty + i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (!(q_pos >= k_pos && k_pos < p.Sk)) x = kNegBig;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * kLP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // P is in shared memory
    pv<D>(Ps, Vs, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < p.Sq) {
      const float l_safe = fmaxf(l[i], 1e-30f);
      float out[C::kCols];
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) out[c] = acc[i][c] / l_safe;
      store_cols<D>(p.out0 + out_row(p, b, p.Sq, row, h, D), tx, out);
      if (tx == 0)
        p.stat_out[((long long)b * p.Sq + row) * p.H + h] = m[i] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the dQ pass. One block per (b, h) and 64-query tile, with its dO,
// lse and delta; P = exp(S scale - lse) and dS = P (dP - delta) scale per
// 64-key tile, dQ += dS K.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* DOs = Qs + C::kTile;
  float* Ks = DOs + C::kTile;
  float* Vs = Ks + C::kTile;
  float* Ps = Vs + C::kTile;
  float* lse_s = Ps + kT * kLP;
  float* delta_s = lse_s + kT;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
  load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);
  load_tile<D>(DOs, dout, p.do_ss, q0, p.Sq);
  {
    // delta = rowsum(dO * O) in f32, four threads a row.
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < p.Sq) {
      const float* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
      const float* drow = dout + row * p.do_ss;
      for (int c = 4 * part; c < D; c += 16) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        sum += y.x * x.x + y.y * x.y + y.z * x.z + y.w * x.w;
      }
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      if (row < p.Sq) p.stat_out[((long long)b * p.Sq + row) * p.H + h] = sum;
    }
    if (threadIdx.x < kT) {
      const int row_l = q0 + threadIdx.x;
      lse_s[threadIdx.x] =
          row_l < p.Sq ? p.lse_in[((long long)b * p.Sq + row_l) * p.H + h] : 0.f;
    }
  }

  const int last_q = p.q_offset + min(q0 + kT - 1, p.Sq - 1);
  const int n_kt = min(last_q / kT + 1, (p.Sk + kT - 1) / kT);
  float acc[4][C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the last step is done with Ks, Vs and Ps
    load_tile<D>(Ks, k, p.k_ss, k0, p.Sk);
    load_tile<D>(Vs, v, p.v_ss, k0, p.Sk);
    __syncthreads();  // keys and values of step kt have landed
    float s[4][4] = {}, dp[4][4] = {};
    scores<D>(Qs, Ks, s);
    scores<D>(DOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int q_pos = p.q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const float pr = (q_pos >= k_pos && k_pos < p.Sk)
                             ? expf(s[i][j] * p.scale - lse_s[r])
                             : 0.f;
        Ps[r * kLP + tx + 16 * j] = pr * (dp[i][j] - delta_s[r]) * p.scale;
      }
    }
    __syncthreads();  // dS is in shared memory
    pv<D>(Ps, Ks, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < p.Sq)
      store_cols<D>(p.out0 + out_row(p, b, p.Sq, row, h, D), tx, acc[i]);
  }
}

// ---------------------------------------------------------------------------
// K3: the dK/dV pass. One block per (b, h) and 64-key tile, with its
// values; the 64-query tiles from the first that reaches the tile's
// diagonal, each with its dO, lse and delta. dV += P^T dO, dK += dS^T Q.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_f32_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + C::kTile;
  float* Qs = Vs + C::kTile;
  float* DOs = Qs + C::kTile;
  float* Pt = DOs + C::kTile;
  float* St = Pt + kT * kLP;
  float* lse_s = St + kT * kLP;
  float* delta_s = lse_s + kT;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  // The first key tiles see the most queries, and run in the first wave.
  const int k0 = blockIdx.y * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
  load_tile<D>(Ks, k, p.k_ss, k0, p.Sk);
  load_tile<D>(Vs, v, p.v_ss, k0, p.Sk);

  // The first query tile with a row at or past this tile's first key.
  const int first_q = k0 - p.q_offset;
  const int qt0 = first_q <= 0 ? 0 : first_q / kT;
  const int n_qt = (p.Sq + kT - 1) / kT;
  float acc_k[4][C::kCols], acc_v[4][C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // the last step is done with Qs, DOs, Pt and St
    load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);
    load_tile<D>(DOs, dout, p.do_ss, q0, p.Sq);
    if (threadIdx.x < kT) {
      const int row = q0 + threadIdx.x;
      const long long at = ((long long)b * p.Sq + row) * p.H + h;
      lse_s[threadIdx.x] = row < p.Sq ? p.lse_in[at] : 0.f;
      delta_s[threadIdx.x] = row < p.Sq ? p.delta_in[at] : 0.f;
    }
    __syncthreads();  // query tile qt has landed
    float st[4][4] = {}, dpt[4][4] = {};
    scores<D>(Ks, Qs, st);
    scores<D>(Vs, DOs, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int k_pos = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool kept = q0 + c < p.Sq && p.q_offset + q0 + c >= k_pos;
        const float pr = kept ? expf(st[i][j] * p.scale - lse_s[c]) : 0.f;
        Pt[r * kLP + c] = pr;
        St[r * kLP + c] = pr * (dpt[i][j] - delta_s[c]) * p.scale;
      }
    }
    __syncthreads();  // P^T and dS^T are in shared memory
    pv<D>(Pt, DOs, acc_v);
    pv<D>(St, Qs, acc_k);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row < p.Sk) {
      const long long at = out_row(p, b, p.Sk, row, h, D);
      store_cols<D>(p.out0 + at, tx, acc_k[i]);
      store_cols<D>(p.out1 + at, tx, acc_v[i]);
    }
  }
}

// dims: B, Sq, Sk, H, D, q_offset, then the (b, s, h) element strides of
// q, k, v, o and dout (15 values; unused ones may be 0).
Params make_params(const long long* dims, float scale) {
  Params p = {};
  p.B = (int)dims[0];
  p.Sq = (int)dims[1];
  p.Sk = (int)dims[2];
  p.H = (int)dims[3];
  p.q_offset = (int)dims[5];
  p.q_sb = dims[6];  p.q_ss = dims[7];  p.q_sh = dims[8];
  p.k_sb = dims[9];  p.k_ss = dims[10]; p.k_sh = dims[11];
  p.v_sb = dims[12]; p.v_ss = dims[13]; p.v_sh = dims[14];
  p.o_sb = dims[15]; p.o_ss = dims[16]; p.o_sh = dims[17];
  p.do_sb = dims[18]; p.do_ss = dims[19]; p.do_sh = dims[20];
  p.scale = scale;
  return p;
}

// A kernel instantiation with its dynamic shared memory.
struct Kernel {
  const void* fn;
  size_t smem;
};

// which: 0 = K1, 1 = K2, 2 = K3.
template <int D>
Kernel pick(int which) {
  constexpr size_t tile = sizeof(float) * Cfg<D>::kTile;
  constexpr size_t scores_tile = sizeof(float) * kT * kLP;
  constexpr size_t stats = sizeof(float) * 2 * kT;
  switch (which) {
    case 0:
      return {(const void*)flash_fwd_f32_kernel<D>, 3 * tile + scores_tile};
    case 1:
      return {(const void*)flash_bwd_dq_f32_kernel<D>,
              4 * tile + scores_tile + stats};
    case 2:
      return {(const void*)flash_bwd_dkv_f32_kernel<D>,
              4 * tile + 2 * scores_tile + stats};
  }
  return {nullptr, 0};
}

// The codes rf_error_string (flash_attention.cu) names.
constexpr int kBadHeadDim = -1;
constexpr int kBadKernel = -2;

int find_kernel(int which, long long head_dim, Kernel* out) {
  switch (head_dim) {
    case 16: *out = pick<16>(which); break;
    case 32: *out = pick<32>(which); break;
    case 64: *out = pick<64>(which); break;
    case 128: *out = pick<128>(which); break;
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
  const int n_tiles = ((which == 2 ? p.Sk : p.Sq) + kT - 1) / kT;
  const dim3 grid(p.B * p.H, n_tiles);
  void* args[] = {(void*)&p};
  err = (int)cudaLaunchKernel(k.fn, grid, dim3(kThreads), args, k.smem,
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
      &blocks, k.fn, kThreads, k.smem);
  if (err) return err;
  out[0] = attr.numRegs;
  out[1] = (int)k.smem;
  out[2] = kThreads;
  out[3] = blocks;
  return 0;
}

}  // extern "C"
