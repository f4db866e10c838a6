// Flash attention forward for Hopper (sm_90a), fp32 CUDA-core version.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel). Same function: online-softmax
// attention with fp32 scores and accumulator, optional same-position
// causal mask, GQA (query head h reads kv head h / G), a kv_len bound
// that masks K/V rows at or past it, the denominator clamped at 1e-30,
// output in the input dtype (float32 or bfloat16). A query offset q_off
// places query row r at position q_off + r (a prompt chunk written into a
// KV cache at cache_index = q_off), and a query-position tensor qpos (int32
// (B, Sq), where given) at qpos[b, r] (the JAX package's mask: M-RoPE's t
// axis or the positions a forward is given); the mask is then col > the
// row's position. With qpos a block reads every key tile below kv_len
// (a plain mask: no served path takes this route).
//
// Design. One block per (query tile of BQ rows, batch*head). The TPU
// kernel's sequential KV grid axis becomes a loop inside the block: each
// iteration stages one BK-row K and V tile in shared memory, and the
// running max / sum / accumulator live in registers. Rows past kv_len
// (or past Sk) are masked by bounds, so callers need not pad Sk. 256
// threads form a 16 x 16 grid: thread (ty, tx) owns query rows
// ty*4 .. ty*4+3, score columns tx + 16*j and output columns tx + 16*c, so
// the row max and row sum are shuffle reductions inside a 16-lane group
// and output stores are coalesced. Tiles are fp32 in dynamic shared
// memory (115,456 bytes at D = 128, above the 48 KB static limit); row
// strides are padded by one float so column reads are bank-conflict free.
//
// Bound on an H100 SXM at the UNet's shape (b=8, 4 heads, Sq=256,
// Sk=264, D=128, f32): 4*8*4*256*264*128 = 1.11 GFLOP, 16.5 us at the
// 67 TFLOP/s fp32 CUDA-core peak; 17.0 MB of q, k, v and o, 5.1 us at
// 3.35 TB/s. So operations bound it. This first version runs on CUDA
// cores and reads every operand from shared memory once per FMA pair,
// so shared-memory bandwidth, not the FMA rate, limits it. At head dims
// 64 and 128 both dtypes take tensor-core kernels instead (bfloat16, every
// LM prefill call: flash_attention_tc.cu; float32, every UNet call:
// flash_attention_tf32.cu); this one keeps float32 and bf16 at head dims
// 16 and 32.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
              int H, int KH, int kv_len, int causal, int q_off,
              const int* __restrict__ qpos, float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  float* Qs = smem;           // BQ x DP
  float* Ks = Qs + BQ * DP;   // BK x DP
  float* Vs = Ks + BK * DP;   // BK x D
  float* Ps = Vs + BK * D;    // BQ x PP

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;

  const size_t q_row = (size_t)H * D;
  const size_t k_row = (size_t)KH * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * k_row + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * k_row + (size_t)kh * D;
  T* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qr = q0 + r;
    Qs[r * DP + d] = qr < Sq ? to_f32(qb[(size_t)qr * q_row + d]) : 0.f;
  }

  float acc[4][DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles entirely above this query tile's diagonal are skipped
  const int k_end =
      causal && !qpos ? min(kv_len, q_off + q0 + BQ) : kv_len;
  // the positions of the thread's rows, for the causal mask
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    pos[i] = qpos ? __ldg(qpos + (size_t)b * Sq + min(qr, Sq - 1))
                  : q_off + qr;
  }
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's K, V and P reads are done
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int kr = k0 + r;
      const bool ok = kr < kv_len;
      Ks[r * DP + d] = ok ? to_f32(kb[(size_t)kr * k_row + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(vb[(size_t)kr * k_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mloc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kc >= kv_len || (causal && kc > pos[i])) x = NEG_INF;
        s[i][j] = x;
        mloc = fmaxf(mloc, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_new = fmaxf(m_i[i], mloc);
      const float alpha = expf(m_i[i] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        lsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      l_i[i] = alpha * l_i[i] + lsum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(&ob[(size_t)qr * q_row + tx + 16 * c], acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int kv_len, int causal, int q_off,
           const int* qpos, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static unsigned int smem_set = 0;
  cudaError_t err =
      set_smem_once((const void*)flash_fwd<T, D>, (int)bytes, &smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KH, kv_len,
      causal, q_off, qpos, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KH, int D, int kv_len, int causal,
               int q_off, const int* qpos, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                           q_off, qpos, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                           q_off, qpos, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                           q_off, qpos, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                           q_off, qpos, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// q: (B, Sq, H, D); k, v: (B, Sk, KH, D); o: (B, Sq, H, D); all
// contiguous, on the device of `stream`. dtype 0 = float32, 1 = bfloat16.
// `q_off` >= 0 is the absolute position of query row 0 (the causal mask is
// col > q_off + row); `qpos`, where not null, int32 (B, Sq) on the device,
// each query row's position instead (col > qpos[b, row]).
// Returns 0, a cudaError_t, or -1 for an unsupported D / dtype.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int Sq, int Sk, int H, int KH,
                            int D, int kv_len, int causal, float scale,
                            int dtype, int q_off, const void* qpos,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, KH, D, kv_len, causal,
                             q_off, qp, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, D, kv_len,
                                     causal, q_off, qp, scale, s);
  return -1;
}

const char* flash_attention_error_string(int err) {
  return err < 0 ? "unsupported head dim or dtype"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
