// TMA loads, mbarriers and the host-side tensor maps, shared by the
// port's two tensor-core flash attention kernels (flash_attention_tc.cu,
// bfloat16 on wgmma; flash_attention_tf32.cu, float32 as 3xTF32).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled from the driver, without linking it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (B, S, heads, D) tensor of `type` (elements of `esize` bytes) as a 4-D
// map over (D, heads, S, B), box (box_d, 1, box_rows, 1), 128-byte
// swizzle (box_d * esize must be 128); rows past S read as zeros. Encoded
// maps are cached per host thread while the pointer, shape and box
// repeat; the map is copied out by value, so a later miss that reuses its
// slot cannot change a map already handed out.
struct MapKey {
  const void* ptr;
  int type, box_rows, D, heads, S, B;
};
constexpr int MAP_CACHE = 16;

bool tensor_map(CUtensorMap* out, const void* ptr, CUtensorMapDataType type,
                int esize, int box_d, int box_rows, int D, int heads, int S,
                int B) {
  thread_local MapKey keys[MAP_CACHE] = {};
  thread_local CUtensorMap maps[MAP_CACHE];
  thread_local int next = 0;
  const MapKey key = {ptr, (int)type, box_rows, D, heads, S, B};
  for (int i = 0; i < MAP_CACHE; ++i)
    if (keys[i].ptr == key.ptr && keys[i].type == key.type &&
        keys[i].box_rows == key.box_rows && keys[i].D == D &&
        keys[i].heads == heads && keys[i].S == S && keys[i].B == B) {
      *out = maps[i];
      return true;
    }
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const int slot = next;
  next = (next + 1) % MAP_CACHE;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * esize,
                                 (cuuint64_t)heads * D * esize,
                                 (cuuint64_t)S * heads * D * esize};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  keys[slot].ptr = nullptr;
  if (fn(&maps[slot], type, 4, const_cast<void*>(ptr), dims, strides, box,
         estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[slot] = key;
  *out = maps[slot];
  return true;
}

}  // namespace
