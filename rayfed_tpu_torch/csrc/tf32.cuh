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

// What the exact-f32 flash kernels share (flash_attention_f32.cu, and
// flash_attention_f32_d256.cu's K2 and K3 at D = 256): their parameters,
// and each f32 product as three TF32 mma.sync products (the file header
// of flash_attention_f32.cu says why).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// dims: B, Sq, Sk, H, D, q_offset, then the (b, s, h) element strides of
// q, k, v, o and dout (15 values; unused ones may be 0).
inline Params make_params(const long long* dims, float scale) {
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

// x as hi + lo for the TF32 products. hi is x rounded to TF32 (10
// mantissa bits, to nearest, ties away from zero, low 13 bits clear):
// for finite x the bits of cvt.rna.tf32.f32, which compiles to an inf/NaN
// test, a predicated add and a mask, where this is an add and a mask
// (every value here is finite). lo = x - hi is exact in f32 and goes to
// the product as it is: a TF32 operand is read from its upper 19 bits, so
// the product takes lo rounded toward zero, within 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// lo of x where hi is x itself (flash_attention_f32_d256.cu): the tensor
// core reads a TF32 operand from its upper 19 bits, so hi is x truncated
// to TF32 and needs no operation, and lo = x - hi is exact in f32, below
// 2^-10 |x|, and read truncated in turn (within 2^-20 |x|): two
// operations a value, where split_tf32 takes three.
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  uint32_t lo = __float_as_uint(x - __uint_as_float(__float_as_uint(x) &
                                                    0xffffe000u));
  return lo;
}

// d += a b, a 16 x 8 (row) by 8 x 8 (col) TF32 product into f32. With
// g = lane / 4, t = lane % 4 a thread holds A's (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4), B's (k t, n g), (k t + 4, n g) and the
// accumulator's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in f32: the corrections lo(a) hi(b) and hi(a) lo(b) first,
// then hi(a) hi(b).
__device__ __forceinline__ void mma_f32(float (&d)[4],
                                        const uint32_t (&a_hi)[4],
                                        const uint32_t (&a_lo)[4],
                                        const uint32_t (&b_hi)[2],
                                        const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

}  // namespace
