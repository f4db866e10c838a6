// Selective scan (the Mamba recurrence) for Hopper (sm_90a), CUDA-core
// version, with the state read from and written back to device memory.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py:mamba_scan
// (body _mamba_kernel). Same function, per batch row b, channel e and
// step t, in fp32:
//   h[n] = exp(dt_t A[e, n]) h[n] + dt_t u_t B_t[n]
//   y_t  = sum_n h[n] C_t[n] + D[e] u_t
// with u, dt (Bt, T, E), B, C (Bt, T, N) each in float32 or bfloat16 as
// the model gives them, A (E, N) and D (E,) float32, and y in u's dtype
// (D u added in fp32 before the cast). The TPU kernel starts from h = 0
// and returns y only; this one reads the initial h (Bt, E, N) and writes
// the final one in place, as the served model needs.
//
// Design. The TPU kernel walks a sequential grid of time chunks with a
// (256, N) state block in VMEM. Here one thread owns one (b, e) channel
// and keeps its h[16] and A[e, :] in registers; the grid is (Bt,
// ceil(E / 128)), 256 blocks of 128 threads at the served prefill (Bt 4,
// E 8192). Each chunk of 32 steps stages u and dt for the block's 128
// channels (coalesced rows) and the chunk's B_t and C_t rows, which all
// channels of a row share, in shared memory as fp32; the steps then run
// from shared memory and registers, one coalesced store of y a step.
// N <= 16: rows of A, B and C past N are zero, so those h entries stay 0.
// B and C may be column slices of one projection: they are read with a
// row stride (elements between consecutive (b, t) rows), so the model
// hands them over without a copy.
//
// Bound on an H100 SXM: bytes. At the served prefill u and B, C in bf16,
// dt in fp32 and y in bf16 are 8 bytes a (b, t, e), 134 MB, 40 us at
// 3.35 TB/s; its ~7 operations and one exp per (b, t, e, n) are 1.9
// GFLOP, 28 us at 67 TFLOP/s. Its 16 exps a step and channel go through
// the special-function units, at a quarter of the FMA rate.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/mamba_scan.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels a block
constexpr int CT = 32;        // steps staged per chunk
constexpr int MAXN = 16;      // state size, at most

__device__ __forceinline__ float ld(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(THREADS)
    mamba_fwd(const void* __restrict__ u, const void* __restrict__ dt,
              const float* __restrict__ A, const void* __restrict__ Bm,
              const void* __restrict__ Cm, const float* __restrict__ D,
              float* __restrict__ h, void* __restrict__ y, int T, int E,
              int N, long long ldb, long long ldc, int u_bf16, int dt_bf16,
              int b_bf16, int c_bf16) {
  __shared__ float us[CT][THREADS];
  __shared__ float dts[CT][THREADS];
  __shared__ float bs[CT][MAXN];
  __shared__ float cs[CT][MAXN];

  const int tid = threadIdx.x, b = blockIdx.x;
  const int e = blockIdx.y * THREADS + tid;
  const bool live = e < E;
  float* hb = h + ((size_t)b * E + e) * N;
  float a[MAXN], hr[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    a[i] = (live && i < N) ? A[(size_t)e * N + i] : 0.f;
    hr[i] = (live && i < N) ? hb[i] : 0.f;
  }
  const float dd = live ? D[e] : 0.f;

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int nt = min(CT, T - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll 4
    for (int s = 0; s < CT; ++s) {
      const size_t off = ((size_t)b * T + t0 + s) * E + e;
      const bool in = live && s < nt;
      us[s][tid] = in ? ld(u, off, u_bf16) : 0.f;
      dts[s][tid] = in ? ld(dt, off, dt_bf16) : 0.f;
    }
    for (int i = tid; i < CT * MAXN; i += THREADS) {
      const int s = i / MAXN, j = i % MAXN;
      const size_t row = (size_t)b * T + t0 + s;
      const bool in = s < nt && j < N;
      bs[s][j] = in ? ld(Bm, row * ldb + j, b_bf16) : 0.f;
      cs[s][j] = in ? ld(Cm, row * ldc + j, c_bf16) : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < nt; ++s) {
      const float uu = us[s][tid], dl = dts[s][tid], du = dl * uu;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        hr[i] = fmaf(expf(dl * a[i]), hr[i], du * bs[s][i]);
        acc = fmaf(hr[i], cs[s][i], acc);
      }
      if (live) {
        const size_t off = ((size_t)b * T + t0 + s) * E + e;
        const float out = acc + dd * uu;
        if (u_bf16)
          static_cast<__nv_bfloat16*>(y)[off] = __float2bfloat16(out);
        else
          static_cast<float*>(y)[off] = out;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      if (i < N) hb[i] = hr[i];
  }
}

}  // namespace

extern "C" {

// u, dt, y: (Bt, T, E) contiguous; A: (E, N), D: (E,) float32; B, C:
// (Bt, T, N) with unit column stride and row stride ldb, ldc elements;
// h: (Bt, E, N) float32, read and overwritten. *_bf16 = 1 for bfloat16,
// 0 for float32; y takes u's. N <= 16. Returns 0, a cudaError_t, or -1
// for an unsupported N.
int mamba_scan_forward(const void* u, const void* dt, const void* A,
                       const void* B, const void* C, const void* D, void* h,
                       void* y, int Bt, int T, int E, int N, long long ldb,
                       long long ldc, int u_bf16, int dt_bf16, int b_bf16,
                       int c_bf16, void* stream) {
  if (N < 1 || N > MAXN) return -1;
  const dim3 grid(Bt, (E + THREADS - 1) / THREADS);
  mamba_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      u, dt, static_cast<const float*>(A), B, C,
      static_cast<const float*>(D), static_cast<float*>(h), y, T, E, N, ldb,
      ldc, u_bf16, dt_bf16, b_bf16, c_bf16);
  return (int)cudaGetLastError();
}

const char* mamba_scan_error_string(int err) {
  return err < 0 ? "unsupported state size (N must be 1..16)"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
