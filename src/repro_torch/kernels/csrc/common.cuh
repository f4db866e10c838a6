// Host helpers shared by the port's CUDA sources.
#pragma once

#include <cuda_runtime.h>

// Raises `kernel`'s dynamic shared memory limit to `bytes` once per device,
// not on every launch. `done` is the caller's per-kernel static word, one
// bit per device; devices past 31 set the attribute every time.
inline cudaError_t set_smem_once(const void* kernel, int bytes,
                                 unsigned int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned int bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && bit) __atomic_fetch_or(done, bit, __ATOMIC_RELEASE);
  return err;
}
