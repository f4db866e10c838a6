// The query tiles' key ends of a causal flash kernel given a query-position
// tensor, shared by flash_attention_tc.cu and flash_attention_tf32.cu.
#pragma once

#include <cuda_runtime.h>

// ends[b * n_qt + t] = 1 + the largest position among query rows
// t * bq .. t * bq + bq - 1 (those below Sq) of sequence b, at least 1:
// one warp a query tile
__global__ void tile_ends(const int* __restrict__ qpos, int* __restrict__ ends,
                          int B, int Sq, int bq, int n_qt) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= B * n_qt) return;  // w is the same for the whole warp
  const int b = w / n_qt, q0 = (w % n_qt) * bq;
  int m = 0;
  for (int r = q0 + (threadIdx.x & 31); r < min(q0 + bq, Sq); r += 32)
    m = max(m, __ldg(qpos + (size_t)b * Sq + r));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) ends[w] = m + 1;
}

// launches tile_ends over B sequences of Sq query rows in tiles of bq rows:
// four warps a block
inline cudaError_t launch_tile_ends(const int* qpos, int* ends, int B, int Sq,
                                    int bq, cudaStream_t stream) {
  const int n_qt = (Sq + bq - 1) / bq;
  tile_ends<<<(B * n_qt + 3) / 4, 128, 0, stream>>>(qpos, ends, B, Sq, bq,
                                                     n_qt);
  return cudaGetLastError();
}
