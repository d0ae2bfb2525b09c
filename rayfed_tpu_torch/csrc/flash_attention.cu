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
// Those tiles are the plan for head dims 16, 32, 64 and 128. D = 256 has a
// plan of its own (kFwdWG256 .. kDkvM256): a 64-row f32 accumulator 256
// wide is 128 registers a thread and a 256-wide tile twice the bytes, so
// K1 streams 64-key tiles and K2 32-key tiles, and K3, which cannot hold
// dK and dV at once (256 registers), sweeps its 32-query tiles twice,
// accumulating dV in the first sweep and dK in the second.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegBig = -1e30f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse_in;
  const float* delta_in;
  bf16* out0;       // o (fwd), dq (dq pass), dk (dkv pass)
  bf16* out1;       // dv (dkv pass)
  float* stat_out;  // lse (fwd), delta (dq pass)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  int B, H, Sq, Sk, q_offset;
  float scale;
};

// ---------------------------------------------------------------------------
// Hopper building blocks: cp.async ring (copies in cp_async.cuh),
// swizzled tiles, wgmma descriptors and instructions
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Width in elements of a swizzled tile: whole 64-element (128-byte) column
// blocks. Columns past D are never loaded; they feed only product columns
// (or terms of a zero-width sum) that are discarded.
template <int D>
__host__ __device__ constexpr int dpad() { return D < 64 ? 64 : D; }

// Bytes of an R-row swizzled bf16 tile.
template <int D, int R>
__host__ __device__ constexpr int sw_bytes() { return R * dpad<D>() * 2; }

// Byte offset of element (r, c), c a multiple of 8, in an R-row tile laid
// out for the 128-byte swizzle: 64-column blocks of R rows x 128 bytes
// each, the 16-byte chunk index XOR-ed with r % 8. Tiles start on 1024-byte
// boundaries, the swizzle's period.
template <int R>
__device__ __forceinline__ uint32_t sw_offset(int r, int c) {
  return (c / 64) * (R * 128) + r * 128 + ((((c % 64) / 8) ^ (r & 7)) * 16);
}

// Make this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + R) of one (b, h) slice into a swizzled tile, 16 bytes
// per copy, neighbouring threads on neighbouring chunks of a row; rows at
// or past n_rows are zero-filled.
template <int D, int R, int T>
__device__ __forceinline__ void load_sw_tile(uint32_t dst, const bf16* src,
                                             long long stride_s, int row0,
                                             int n_rows) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = R * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + T - 1) / T; ++i) {
    const int c = threadIdx.x + i * T;
    if (kTotal % T == 0 || c < kTotal) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const bool valid = row0 + r < n_rows;
      const bf16* g = valid ? src + (long long)(row0 + r) * stride_s + col : src;
      cp_async16(dst + sw_offset<R>(r, col), g, valid);
    }
  }
}

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

// wgmma matrix descriptor of a tile in the 128-byte swizzle: start address,
// leading byte offset (LBO), stride byte offset (SBO = 1024, the distance
// between 8-row groups), layout type 1 (128-byte swizzle), all in the
// encoding of the PTX ISA's matrix-descriptor format.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo_bytes & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand: the tile's rows are the M (or N) dimension and its
// columns the reduction. Step kk covers columns [16 kk, 16 kk + 16): inside
// a 64-column block the start moves 32 bytes, the hardware applies the
// swizzle to the address. row0 (a multiple of 8) picks A's 64 rows.
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  return sw128_desc(tile + (kk / 4) * (R * 128) + row0 * 128 + (kk % 4) * 32,
                    16);
}
// MN-major B operand: the tile's rows are the reduction and its columns N.
// Step kk covers rows [16 kk, 16 kk + 16); LBO steps between 64-column
// blocks.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, R * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers in place across the asynchronous wgmma: the compiler may
// not move their reads or writes over this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A warpgroup's m64nN f32 accumulator: thread t holds, for each 8-column
// group i, d[4i + e] at row 16 (t / 32 % 4) + (t % 32) / 4 + 8 (e / 2) and
// column 8 i + 2 (t % 4) + e % 2. The register A operand of an m64k16 step
// kk is the same rows and columns [16 kk, 16 kk + 16) packed as bf16 pairs:
// a[kk][2 (i % 2) + e / 2] holds d[4i + e], d[4i + e + 1] for i = 2 kk,
// 2 kk + 1 and e = 0, 2.
__device__ __forceinline__ int acc_col(int i, int e, int lane) {
  return 8 * i + 2 * (lane % 4) + (e & 1);
}

// wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators, spelled out
// for each N the kernels use (the PTX names every accumulator register).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D[64 x 32] (+)= A[64 x 16] . B[32 x 16]^T, A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 32] += A[64 x 16] . B[16 x 32], A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// The D = 256 accumulators (P V, dS K, P^T dO, dS^T Q): one m64n256 product,
// 128 accumulator registers a thread.
template <>
struct Wgmma<256> {
  // D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

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
// D = 256: O alone is 128 registers a thread and a 128-key stage of K and V
// is 128 KiB, so the ring steps 64 keys (S and P then take 48 registers);
// Q and the ring take 192 KiB of shared memory.
constexpr int kFwdWG256 = 2;
constexpr int kFwdN256 = 64;

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
// D = 256: dK and dV would be 256 registers a thread, past the 255 a
// thread may hold, so the kernel sweeps the query tiles twice, dV first,
// then dK (recomputing S^T, 5 products where one sweep does 4). Resident K
// and V take 128 KiB, so the ring steps 32 queries (64 KiB).
constexpr int kDkvWG256 = 2;
constexpr int kDkvM256 = 32;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// One block per (b * h, k tile), k tiles in order (the first keys see the
// most queries, so the heaviest blocks start first). Streams the q tiles
// from the diagonal on, in the transposed orientation (rows are keys): the
// warpgroup holds dK and dV for its 64 keys in f32 registers throughout,
// or, where both do not fit (D = 256), one of them per sweep.
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

  // K and V join the first sweep's first copy group.
  if (qt_start < n_qt) {
    load_sw_tile<D, C::kN, C::kThreads>(sK, kb, p.k_ss, k0, p.Sk);
    load_sw_tile<D, C::kN, C::kThreads>(sV, vb, p.v_ss, k0, p.Sk);
  }

  // This thread's two key rows (see acc_col).
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int k_pos0 = k0 + r0;
  const float scale_log2 = p.scale * kLog2e;

  // One sweep over the q tiles: dV (with_dv) and/or dK (with_dk)
  // accumulated in registers, then written.
  auto sweep = [&](auto with_dv, auto with_dk) {
    constexpr bool kDV = decltype(with_dv)::value;
    constexpr bool kDK = decltype(with_dk)::value;
    if (qt_start < n_qt) {
      load_stage(0, qt_start);
      cp_async_commit();
    }
    float dk[kDK ? kDp / 2 : 1];
    float dv[kDV ? kDp / 2 : 1];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) {
      if constexpr (kDK) dk[i] = 0.0f;
      if constexpr (kDV) dv[i] = 0.0f;
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

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys (dP^T
      // for dK alone).
      float s[C::kM / 2];
      float dp[kDK ? C::kM / 2 : 1];
#pragma unroll
      for (int i = 0; i < C::kM / 2; ++i) {
        s[i] = 0.0f;
        if constexpr (kDK) dp[i] = 0.0f;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<C::kM>::ss(s, kmajor_desc<C::kN>(sK, wg * 64, kk),
                         kmajor_desc<C::kM>(sQ, 0, kk), kk > 0);
      }
      if constexpr (kDK) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          Wgmma<C::kM>::ss(dp, kmajor_desc<C::kN>(sV, wg * 64, kk),
                           kmajor_desc<C::kM>(sDO, 0, kk), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if constexpr (kDK) fence_regs(dp);

      // P^T = exp(S^T scale - lse) (no running max: lse is given) and
      // dS^T = P^T (dP^T - delta) scale, both into bf16 A fragments. Mask
      // only a tile that crosses the diagonal or the end of the queries.
      const bool masked = wg_k0 + 63 > p.q_offset + q0 || q0 + C::kM > p.Sq;
      uint32_t pa[kDV ? C::kM / 16 : 1][4];
      uint32_t da[kDK ? C::kM / 16 : 1][4];
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
            if constexpr (kDK) {
              ds[x] = v * (dp[4 * i + e + x] - delta[c]) * p.scale;
            }
          }
          if constexpr (kDV) {
            pa[i / 2][2 * (i % 2) + e / 2] = pack_bf16(pr[0], pr[1]);
          }
          if constexpr (kDK) {
            da[i / 2][2 * (i % 2) + e / 2] = pack_bf16(ds[0], ds[1]);
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q, the A operands from registers.
      if constexpr (kDV) fence_regs(dv);
      if constexpr (kDK) fence_regs(dk);
      wgmma_fence();
      if constexpr (kDV) {
#pragma unroll
        for (int kk = 0; kk < C::kM / 16; ++kk) {
          Wgmma<kDp>::rs(dv, pa[kk], mnmajor_desc<C::kM>(sDO, kk));
        }
      }
      if constexpr (kDK) {
#pragma unroll
        for (int kk = 0; kk < C::kM / 16; ++kk) {
          Wgmma<kDp>::rs(dk, da[kk], mnmajor_desc<C::kM>(sQ, kk));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (kDV) fence_regs(dv);
      if constexpr (kDK) fence_regs(dk);
      if constexpr (kDV) fence_regs(pa);
      if constexpr (kDK) fence_regs(da);
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
            if constexpr (kDK) {
              *reinterpret_cast<__nv_bfloat162*>(p.out0 + at) =
                  __floats2bfloat162_rn(dk[4 * i + 2 * j],
                                        dk[4 * i + 2 * j + 1]);
            }
            if constexpr (kDV) {
              *reinterpret_cast<__nv_bfloat162*>(p.out1 + at) =
                  __floats2bfloat162_rn(dv[4 * i + 2 * j],
                                        dv[4 * i + 2 * j + 1]);
            }
          }
        }
      }
    }
  };

  if constexpr (kDp <= 128) {
    sweep(Flag<true>(), Flag<true>());
  } else {
    sweep(Flag<true>(), Flag<false>());
    sweep(Flag<false>(), Flag<true>());
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

// A kernel instantiation with its launch shape: threads and shared memory
// a block, and the rows of the tiled sequence (Sq for K1 and K2, Sk for
// K3) a block owns.
struct Kernel {
  const void* fn;
  int threads;
  int rows;
  size_t smem;
};

// Each kernel's tile plan at head dim D: the D <= 128 plan, or the D = 256
// one.
template <int D>
Kernel fwd_kernel() {
  constexpr int kWG = D > 128 ? kFwdWG256 : kFwdWG;
  constexpr int kN = D > 128 ? kFwdN256 : kFwdN;
  using C = FwdCfg<D, kWG, kN>;
  return {(const void*)flash_fwd_kernel<D, kWG, kN>, C::kThreads, C::kM,
          C::kSmem};
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
  constexpr int kWG = D > 128 ? kDkvWG256 : kDkvWG;
  constexpr int kM = D > 128 ? kDkvM256 : kDkvM;
  using C = DkvCfg<D, kWG, kM>;
  return {(const void*)flash_bwd_dkv_kernel<D, kWG, kM>, C::kThreads, C::kN,
          C::kSmem};
}

constexpr int kBadHeadDim = -1;
constexpr int kBadKernel = -2;

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
    case 256: *out = pick<256>(which); break;
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
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
