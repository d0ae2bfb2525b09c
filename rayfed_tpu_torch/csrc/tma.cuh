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

// What the warp-specialised D = 256 kernels share (flash_attention_d256.cu
// in bf16, flash_attention_f32_d256.cu in f32): mbarriers, the register
// hand-over between a producer warpgroup and its consumers, the
// head-major reading of the launch grid, and the TMA tensor maps of a
// (B, S, H, D) tensor.

#pragma once

#include <cuda.h>  // CUtensorMap and its encoding's types; no driver link
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// A consumer warp is done with a ring stage: one arrival a warp.
__device__ __forceinline__ void release_stage(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// The (b * h, row tile) of this block. The launch grid is (B * H, row
// tiles), but its linear index is read head-major: the blocks of one head
// run together, so the tiles they stream (K1 and K2: K and V; K3: Q and
// dO) come from device memory once and from L2 for the head's other
// blocks, where b * h fastest would keep some 132 heads' tiles live at
// once, far past L2. Within a head, tile t = 0 is the heaviest.
__device__ __forceinline__ void block_tile(int* bh, int* t) {
  const long long lin = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  *bh = (int)(lin / gridDim.y);
  *t = (int)(lin % gridDim.y);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime so the library
// needs no link to the driver.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// The (D, H, S, B) tensor map of a (B, S, H, D) tensor of `elem`-byte
// elements with element strides sb, ss, sh (unit on D), read in boxes of
// 128 bytes of columns (box_cols elements) x `rows` rows in the 128-byte
// swizzle; rows past S read as zeros. A dim of size 1 is never stepped,
// so its stride is given as a contiguous layout's. False if the encoding
// refuses the layout.
inline bool encode_map(CUtensorMap* map, const void* ptr,
                       CUtensorMapDataType type, int elem, long long D,
                       long long B, long long S, long long H, long long sb,
                       long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  if (H == 1) sh = D;
  if (S == 1) ss = H * sh;
  if (B == 1) sb = S * ss;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * elem),
                                 (cuuint64_t)(ss * elem),
                                 (cuuint64_t)(sb * elem)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rows [row0, row0 + R) of head h, batch b, all D columns, as D * elem /
// 128 boxes of 128 bytes of columns, box cb at dst + cb * R * 128 (each
// box's rows 128 bytes apart in the 128-byte swizzle); completion is
// reported to bar.
template <int R, int kBoxes>
__device__ __forceinline__ void tma_boxes(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row0, int h,
                                          int b, int box_cols) {
#pragma unroll
  for (int cb = 0; cb < kBoxes; ++cb) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst + cb * R * 128), "l"((uint64_t)map), "r"(bar),
           "r"(cb * box_cols), "r"(h), "r"(row0), "r"(b)
        : "memory");
  }
}

}  // namespace
