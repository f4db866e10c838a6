// Fused GroupNorm (+ optional SiLU) for Hopper (sm_90a): one thread-block
// cluster per (sample, group), x read from device memory once.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_groupnorm.py:
// fused_groupnorm (body _gn_kernel). Same function: per-sample GroupNorm
// over (spatial x C/g) with fp32 mean and population variance, eps added
// to the variance, then per-channel scale/bias, then an optional SiLU, on
// channels-last float32 (B, HW, C); the wrapper shrinks g to the largest
// divisor of C (kernels/ref.group_count).
//
// Design. The TPU kernel holds a whole sample (HW, C) in VMEM; at the
// UNet's (64 x 64, 384) that is 6.3 MB, and one (sample, group) slice is
// 768 KB, over a block's 227 KB of shared memory. So the slice is spread
// over the `cs` (1-8, portable) blocks of a cluster: block r owns HW rows
// [r * rows, (r + 1) * rows) of the group's CG channels and copies them
// into its shared memory with cp.async (16 bytes a thread where CG is a
// multiple of 4 and x 16-byte aligned, else 4). From that copy it takes
// its exact partial statistics in two passes, the mean first and then
// the sums of the deviations and of their squares (the corrected
// two-pass algorithm, no division per element); the blocks
// exchange (count, mean, M2) through distributed shared memory between
// two cluster barriers and each merges them in rank order with Chan's
// formula, so all blocks hold the same mean and variance. Each block then
// normalises its rows from shared memory, applies scale/bias and the
// SiLU, and writes them once. One read and one write of x: the bound.
// The wrapper's planner (fused_groupnorm.plan) picks `cs` from the shape
// and the SM count: the fewest blocks whose shares fit (each share plus
// the group's scale and bias within 227 KB), doubled while the blocks
// need a second wave of the SMs, or while twice as many still fit one
// wave and each holds over 32 KB (one SM's copies alone fall short of
// the memory's rate). Clusters cost launch time, 8 blocks the most, so
// no cluster is larger than that asks; a cluster of one is a plain
// launch. A slice that does not fit 8 blocks
// (mode "reread") is walked in chunks that fit, each chunk's statistics
// merged by Chan's formula as it goes, and the normalising pass reads x
// again (from L2 where it still is); no path shape needs it.
//
// CUDA C++, not Triton: the design needs thread-block clusters and
// distributed shared memory, which Triton does not expose. The copy is
// cp.async, not TMA: a tensor map would have to be encoded on the host
// for every (pointer, shape) of the ~60 GroupNorm calls of a forward, on
// a path whose small batches are host-bound already, and its 16-byte
// stride rule leaves out the discriminator's 24-channel shapes.
//
// Bound on an H100 SXM: bytes. At (8, 64, 64, 384) float32 the function
// reads 50.3 MB and writes 50.3 MB, 30 us at 3.35 TB/s; its ~12
// operations an element are far below the fp32 peak. Over one UNet and
// one discriminator forward at b = 8 (63 calls) the bound is 0.280 ms.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/fused_groupnorm.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
// dynamic shared memory a block may take: 227 KB less 1 KB for the static
// part and slack (fused_groupnorm.SMEM_BYTES)
constexpr int SMEM_MAX = 232448 - 1024;

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float sum(const float4& v) {
    return (v.x + v.y) + (v.z + v.w);
  }
  // the deviations from m: their sum and the sum of their squares
  __device__ static void dev(const float4& v, float m, float& e, float& q) {
    const float a = v.x - m, b = v.y - m, c = v.z - m, d = v.w - m;
    e += (a + b) + (c + d);
    q += (a * a + b * b) + (c * c + d * d);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static float sum(float v) { return v; }
  __device__ static void dev(float v, float m, float& e, float& q) {
    const float a = v - m;
    e += a;
    q += a * a;
  }
};

// the sum over the block, in the same order in every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();  // red is written again by the next call
  return t;
}

// (n, mean, m2) += (nb, mb, m2b), Chan's pairwise formula
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                    float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nt = n + nb, d = mb - mean;
  mean += d * (nb / nt);
  m2 += m2b + d * d * (n * (nb / nt));
  n = nt;
}

// y * sigmoid(y) on the special-function unit: 2^x and 1/x, each within
// 2 ulp; past exp's range 1/inf = 0, so the SiLU saturates to y or -0
__device__ __forceinline__ float silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(-1.4426950408889634f * y));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

__device__ __forceinline__ float norm(float v, float mean, float rstd,
                                      float s, float b, int act) {
  const float y = fmaf((v - mean) * rstd, s, b);
  return act ? silu(y) : y;
}

// walks the vectors i = tid, tid + THREADS, ... of a (rows x CV) buffer,
// keeping (row, vector in the row) without a division a step
struct RowWalk {
  int r, v;
  const int dr, dv, cv;
  __device__ RowWalk(int i, int cv_)
      : r(i / cv_), v(i % cv_), dr(THREADS / cv_), dv(THREADS % cv_),
        cv(cv_) {}
  __device__ void step() {
    r += dr;
    v += dv;
    if (v >= cv) {
      v -= cv;
      ++r;
    }
  }
};

// grid: B * G clusters of `cs` blocks; see the note above. `chunk_rows`
// rows fit a block's buffer; rows <= chunk_rows is the resident mode.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    gn_fwd(const float* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, float* __restrict__ y, int HW,
           int C, int CG, int G, int rows, int chunk_rows, int act,
           float eps) {
  using V = Vec<VEC>;
  using T = typename V::T;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  __shared__ float red[WARPS];
  __shared__ float stats[3];  // this block's (n, mean, M2), read by peers
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / cs, b = pair / G, grp = pair % G;
  const int r_begin = min(HW, rank * rows), r_end = min(HW, r_begin + rows);
  const size_t off = (size_t)b * HW * C + (size_t)grp * CG;
  const float* const xb = x + off;
  float* const yb = y + off;
  const int CV = CG / VEC;  // vectors a row
  // the group's scale and bias, then the rows (16-byte aligned)
  float* const sc = reinterpret_cast<float*>(smem4);
  float* const bi = sc + CG;
  T* const buf = reinterpret_cast<T*>(smem4 + (2 * CG + 3) / 4);
  const int tid = threadIdx.x;
  for (int c = tid; c < CG; c += THREADS) {
    sc[c] = scale[grp * CG + c];
    bi[c] = bias[grp * CG + c];
  }

  // this block's statistics, chunk by chunk (one chunk when resident)
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int c0 = r_begin; c0 < r_end; c0 += chunk_rows) {
    const int nv = min(chunk_rows, r_end - c0) * CV;
    // (the last chunk's reads ended at block_sum's closing barrier)
    RowWalk w(tid, CV);
    for (int i = tid; i < nv; i += THREADS, w.step())
      cp_async<VEC>(reinterpret_cast<float*>(buf + i),
                    xb + (size_t)(c0 + w.r) * C + w.v * VEC);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();
    float s = 0.f;
    for (int i = tid; i < nv; i += THREADS) s += V::sum(buf[i]);
    const float cn = (float)(nv * VEC);
    const float cmean = block_sum(s, red) / cn;
    // second pass: the deviations also correct the mean's rounding (the
    // corrected two-pass algorithm): mean += sum(d) / n, M2 = sum(d^2) -
    // sum(d)^2 / n
    float e = 0.f, q = 0.f;
    for (int i = tid; i < nv; i += THREADS) V::dev(buf[i], cmean, e, q);
    e = block_sum(e, red);
    q = block_sum(q, red);
    chan(n, mean, m2, cn, cmean + e / cn, q - e * e / cn);
  }

  // the cluster's statistics: every block merges all blocks' partials in
  // rank order (remote reads issued together), so all agree
  if (tid == 0) {
    stats[0] = n;
    stats[1] = mean;
    stats[2] = m2;
  }
  cluster.sync();
  float pn[MAX_CLUSTER], pm[MAX_CLUSTER], pq[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    if (r < cs) {
      const float* ps = cluster.map_shared_rank(stats, r);
      pn[r] = ps[0];
      pm[r] = ps[1];
      pq[r] = ps[2];
    }
  // peers may leave once every block has read; this block waits for that
  // at its end
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  n = mean = m2 = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    if (r < cs) chan(n, mean, m2, pn[r], pm[r], pq[r]);
  const float rstd = rsqrtf(m2 / n + eps);

  const int nv = (r_end - r_begin) * CV;
  const bool resident = r_end - r_begin <= chunk_rows;
  RowWalk w(tid, CV);
  for (int i = tid; i < nv; i += THREADS, w.step()) {
    const int v = w.v;
    const size_t at = (size_t)(r_begin + w.r) * C + v * VEC;
    const T val = resident ? buf[i] : *reinterpret_cast<const T*>(xb + at);
    if constexpr (VEC == 4) {
      const int c = v * 4;
      *reinterpret_cast<float4*>(yb + at) = make_float4(
          norm(val.x, mean, rstd, sc[c], bi[c], act),
          norm(val.y, mean, rstd, sc[c + 1], bi[c + 1], act),
          norm(val.z, mean, rstd, sc[c + 2], bi[c + 2], act),
          norm(val.w, mean, rstd, sc[c + 3], bi[c + 3], act));
    } else {
      yb[at] = norm(val, mean, rstd, sc[v], bi[v], act);
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int VEC>
int launch(const float* x, const float* scale, const float* bias, float* y,
           int B, int HW, int C, int G, int cs, int rows, int chunk_rows,
           int act, float eps, cudaStream_t stream) {
  static unsigned int smem_set = 0;
  cudaError_t err = set_smem_once((const void*)gn_fwd<VEC>, SMEM_MAX,
                                  &smem_set);
  if (err != cudaSuccess) return (int)err;
  const int CG = C / G;
  const size_t bytes =
      16 * (size_t)((2 * CG + 3) / 4) + (size_t)chunk_rows * CG * 4;
  if (bytes > (size_t)SMEM_MAX) return -1;
  if (cs == 1) {  // a block is its own cluster; a plain launch costs less
    gn_fwd<VEC><<<B * G, THREADS, bytes, stream>>>(
        x, scale, bias, y, HW, C, CG, G, rows, chunk_rows, act, eps);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * G * cs, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_fwd<VEC>, x, scale, bias, y, HW, C, CG,
                           G, rows, chunk_rows, act, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 x, y: (B, HW, C) contiguous; scale, bias: (C,); G groups of
// CG = C / G channels. `cs` (1..8) blocks a (sample, group), block r
// taking rows [r * rows, (r + 1) * rows) with (cs - 1) * rows < HW;
// `chunk_rows` (<= rows: resident) rows fit a block's shared memory.
// vec 4 needs CG % 4 == 0 and x, y 16-byte aligned. Returns 0, a
// cudaError_t, or -1 for an unsupported split or vector width.
int fused_groupnorm_forward(const void* x, const void* scale,
                            const void* bias, void* y, int B, int HW, int C,
                            int G, int cs, int rows, int chunk_rows, int vec,
                            int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || C % G || cs < 1 || cs > MAX_CLUSTER || rows < 1 ||
      chunk_rows < 1 || chunk_rows > rows ||
      (long long)(cs - 1) * rows >= HW || (long long)cs * rows < HW)
    return -1;
  const float* xs = static_cast<const float*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* ys = static_cast<float*>(y);
  if (vec == 4 && (C / G) % 4 == 0)
    return launch<4>(xs, sc, bi, ys, B, HW, C, G, cs, rows, chunk_rows, act,
                     eps, s);
  if (vec == 1)
    return launch<1>(xs, sc, bi, ys, B, HW, C, G, cs, rows, chunk_rows, act,
                     eps, s);
  return -1;
}

const char* fused_groupnorm_error_string(int err) {
  return err < 0 ? "unsupported split, chunk or vector width"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
