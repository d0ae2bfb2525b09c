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

// The device-DMA lane's CUDA IPC calls (rayfed_tpu_torch/proxy/cuda/dma.py).
//
// A pushed tree's snapshot is one cudaMalloc allocation outside PyTorch's
// caching allocator, so that its IPC handle names exactly that buffer (no
// segment offset, no allocator setting such as expandable_segments in the
// way) and the lane frees it when the receiver says it is done. No kernel:
// the copies are cudaMemcpyAsync on the caller's stream.
//
// Every entry returns 0 or a cudaError_t code (rf_error_string names it).

#include <cuda_runtime.h>

#include <cstring>

namespace {

// Run `body` with `device` current, then restore the caller's device.
template <typename F>
int on_device(int device, F body) {
  int prev = 0;
  int err = (int)cudaGetDevice(&prev);
  if (err) return err;
  if (prev != device) {
    err = (int)cudaSetDevice(device);
    if (err) return err;
  }
  err = body();
  if (prev != device) {
    int back = (int)cudaSetDevice(prev);
    if (!err) err = back;
  }
  return err;
}

}  // namespace

extern "C" {

int rf_dma_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

// A failed allocation also clears the thread's last error, so that a later
// error check of the caller's (PyTorch checks after each launch) does not
// report it again.
int rf_dma_alloc(int device, unsigned long long nbytes, void** out) {
  return on_device(device, [&] {
    int err = (int)cudaMalloc(out, nbytes);
    if (err) (void)cudaGetLastError();
    return err;
  });
}

int rf_dma_free(int device, void* ptr) {
  return on_device(device, [&] { return (int)cudaFree(ptr); });
}

int rf_dma_ipc_handle(void* ptr, void* out) {
  cudaIpcMemHandle_t h;
  int err = (int)cudaIpcGetMemHandle(&h, ptr);
  if (err) return err;
  std::memcpy(out, &h, sizeof h);
  return 0;
}

int rf_dma_ipc_open(int device, const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return on_device(device, [&] {
    return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

int rf_dma_ipc_close(int device, void* ptr) {
  return on_device(device, [&] { return (int)cudaIpcCloseMemHandle(ptr); });
}

// dst and src may be device or host pointers (unified addressing picks the
// direction); the copy is ordered on `stream`.
int rf_dma_copy(void* dst, const void* src, unsigned long long nbytes,
                void* stream) {
  return (int)cudaMemcpyAsync(dst, src, nbytes, cudaMemcpyDefault,
                              (cudaStream_t)stream);
}

}  // extern "C"
