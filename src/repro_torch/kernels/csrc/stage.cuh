// Staging rows of device memory into shared memory with cp.async, shared
// by the recurrent kernels (mlstm_chunk.cu, mamba_scan.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 bytes from global to shared memory, asynchronously; zero-filled (and
// `src` not read) where `live` is false
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of `row_bytes` into shared memory at `dst` (row stride
// `ds` bytes) from `src` (row stride `ss` bytes): byte b of row r is the
// source's where r < live_rows and b < live_bytes, else 0. With `vec`
// every live row start is 16-byte aligned and live_bytes a multiple of
// 16, and the copy is cp.async (asynchronous, 16 bytes a thread at a
// time; the caller commits and waits); else plain loads and stores of
// `esz`-byte elements (2 or 4), synchronous. row_bytes and ds are
// multiples of 16.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int ds,
                                           const unsigned char* src,
                                           long long ss, int rows,
                                           int row_bytes, int live_rows,
                                           int live_bytes, bool vec, int esz,
                                           int tid, int nthreads) {
  if (vec) {
    const int cpr = row_bytes / 16;
    for (int i = tid; i < rows * cpr; i += nthreads) {
      const int r = i / cpr, c = (i % cpr) * 16;
      const bool live = r < live_rows && c < live_bytes;
      cp16(dst + r * ds + c, live ? src + r * ss + c : src, live);
    }
    return;
  }
  const int epr = row_bytes / esz;
  for (int i = tid; i < rows * epr; i += nthreads) {
    const int r = i / epr, c = (i % epr) * esz;
    const bool live = r < live_rows && c < live_bytes;
    if (esz == 2)
      *reinterpret_cast<uint16_t*>(dst + r * ds + c) =
          live ? *reinterpret_cast<const uint16_t*>(src + r * ss + c) : 0;
    else
      *reinterpret_cast<uint32_t*>(dst + r * ds + c) =
          live ? *reinterpret_cast<const uint32_t*>(src + r * ss + c) : 0u;
  }
}

}  // namespace
