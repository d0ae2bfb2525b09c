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

// The f32 K2 and K3 at head dim 256 (flash_attention_f32_d256.cu), to
// which the C entry points of flash_attention_f32.cu hand that head dim.

#pragma once

#include <stddef.h>

#include "flash_attention_d256.cuh"  // the C entry points' error codes

namespace rf_f32_d256 {

// K2 (which = 1) or K3 (which = 2): the kernel, threads and dynamic shared
// memory a block, and the rows of the tiled sequence (Sq for K2, Sk for
// K3) a block owns. Returns 0, or kBadKernel for another `which`.
int kernel_info(int which, const void** fn, int* threads, int* rows,
                size_t* smem);

// rf_flash_bwd_dq_f32 and rf_flash_bwd_dkv_f32 at D = 256, with their
// arguments.
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* dq, void* delta,
       const long long* dims, float scale, void* stream);
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv,
        const long long* dims, float scale, void* stream);

}  // namespace rf_f32_d256
