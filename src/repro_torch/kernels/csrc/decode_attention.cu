// Decode attention for Hopper (sm_90a): one new token per sequence
// against a KV cache, CUDA-core version.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:
// decode_attention (body _decode_kernel). Same function: q (B, H, D)
// with H = KH * G, k and v (B, T, KH, D), valid_len (B,) int32 read from
// device memory; fp32 scores scaled by 1/sqrt(D), columns at or past
// valid_len[b] masked, online softmax in fp32, output acc / max(l, 1e-30)
// in the input dtype (float32 or bfloat16). So valid_len = 0 gives zeros.
// Unlike the TPU kernel, T need not be a multiple of the key tile: rows
// at or past valid_len are never read.
//
// Design. One block per (batch, KV head). The TPU kernel's sequential
// grid axis over key tiles becomes a loop inside the block; the G query
// heads of the KV head share each BK-row K and V tile staged in shared
// memory, the reuse the TPU kernel gets from its (G, D) tile. Tiles stay
// in the input dtype in shared memory (16-byte vector loads and stores,
// rows padded by 16 bytes so a warp's vector reads hit distinct banks);
// q is held in fp32. Per tile: (1) thread (key j, head slot) computes the
// dot products of its key with up to MAX_G / 4 heads; (2) one warp per
// head takes the tile's max and sum (the online-softmax update, state in
// that warp's registers) and writes the probabilities; (3) thread
// (16-byte column chunk, head slot) rescales and accumulates P V in
// registers. The loop ends at the tile holding valid_len[b] - 1.
//
// Bound on an H100 SXM: bytes. At one layer of decode_32k (B 128, 32769
// live rows of KH 4 x D 128, bf16) the kernel must read 8.6 GB of K and
// V, 2.56 ms at 3.35 TB/s; its 4 G D flops a row are ~4 per byte, far
// below the ridge. At the served decode shape (B 4, <= 544 live rows) it
// reads 4.5 MB (1.3 us) and its 16 blocks fill 16 of 132 SMs: the launch
// cost bounds it there. Splitting T across blocks (split-K with a
// combine pass) and cp.async double buffering are later work.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/decode_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // keys per tile (two per lane in the softmax)
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_G = 16;     // query heads per KV head
constexpr int HS = THREADS / BK;  // head slots in the score phase
constexpr int PS = BK + 1;    // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the 16 bytes at p as fp32 values (4 floats or 8 bfloat16s)
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int D>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int DV = D / VEC;          // 16-byte chunks in a row
  static constexpr int KS = D + VEC;          // padded row stride
  static constexpr int HS2 = THREADS / DV;    // head slots in the PV phase
  static constexpr int R2 = (MAX_G + HS2 - 1) / HS2;
  static constexpr size_t smem_bytes =
      2 * sizeof(T) * BK * KS + sizeof(float) * (MAX_G * D + MAX_G * PS +
                                                 2 * MAX_G);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ valid_len,
               T* __restrict__ o, int T_len, int KH, int G, float scale) {
  using L = Layout<T, D>;
  constexpr int VEC = L::VEC, DV = L::DV, KS = L::KS, HS2 = L::HS2,
                R2 = L::R2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                  // BK x KS
  T* Vs = Ks + BK * KS;                                     // BK x KS
  float* Qs = reinterpret_cast<float*>(Vs + BK * KS);      // MAX_G x D
  float* Ps = Qs + MAX_G * D;                               // MAX_G x PS
  float* As = Ps + MAX_G * PS;                              // MAX_G
  float* Ls = As + MAX_G;                                   // MAX_G

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int valid = min(max(valid_len[b], 0), T_len);
  const size_t row = (size_t)KH * D;  // elements between cache rows
  const T* kb = k + (size_t)b * T_len * row + (size_t)kh * D;
  const T* vb = v + (size_t)b * T_len * row + (size_t)kh * D;
  const size_t head0 = ((size_t)b * KH + kh) * G * D;  // q, o: (B, H, D)

  for (int i = tid; i < G * D; i += THREADS) Qs[i] = to_f32(q[head0 + i]);

  float m_r[MAX_G / 8], l_r[MAX_G / 8];  // softmax state, heads warp + 8r
#pragma unroll
  for (int r = 0; r < MAX_G / 8; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
  }
  const int j = tid % BK, hs = tid / BK;     // score phase
  const int dg = tid % DV, hs2 = tid / DV;   // PV phase
  float acc[R2][VEC];
#pragma unroll
  for (int r = 0; r < R2; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;

  for (int k0 = 0; k0 < valid; k0 += BK) {
    __syncthreads();  // the last tile's reads are done (and Qs is written)
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i % DV;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < valid) {
        const size_t off = (size_t)(k0 + r) * row + c * VEC;
        kv = *reinterpret_cast<const uint4*>(kb + off);
        vv = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * KS + c * VEC) = kv;
      *reinterpret_cast<uint4*>(Vs + r * KS + c * VEC) = vv;
    }
    __syncthreads();

    // (1) scores of key j against heads hs, hs + HS, ...
    float s[MAX_G / HS];
#pragma unroll
    for (int r = 0; r < MAX_G / HS; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      float kf[VEC];
      load16(Ks + j * KS + c * VEC, kf);
#pragma unroll
      for (int r = 0; r < MAX_G / HS; ++r) {
        const int g = hs + HS * r;
        if (g < G) {
          const float* qq = Qs + g * D + c * VEC;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qq + e);
            s[r] = fmaf(qv.x, kf[e], s[r]);
            s[r] = fmaf(qv.y, kf[e + 1], s[r]);
            s[r] = fmaf(qv.z, kf[e + 2], s[r]);
            s[r] = fmaf(qv.w, kf[e + 3], s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_G / HS; ++r) {
      const int g = hs + HS * r;
      if (g < G) Ps[g * PS + j] = k0 + j < valid ? s[r] * scale : NEG_INF;
    }
    __syncthreads();

    // (2) online-softmax update, one warp per head
#pragma unroll
    for (int r = 0; r < MAX_G / 8; ++r) {
      const int g = warp + 8 * r;
      if (g < G) {
        float* pr = Ps + g * PS;
        const float s0 = pr[lane], s1 = pr[lane + 32];
        float mloc = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
        const float m_new = fmaxf(m_r[r], mloc);
        const float alpha = expf(m_r[r] - m_new);
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        float lsum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
        l_r[r] = alpha * l_r[r] + lsum;
        m_r[r] = m_new;
        pr[lane] = p0;
        pr[lane + 32] = p1;
        if (lane == 0) As[g] = alpha;
      }
    }
    __syncthreads();

    // (3) acc = acc * alpha + P V for column chunk dg of heads hs2 + HS2 r
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      const int g = hs2 + HS2 * r;
      if (g < G) {
        const float alpha = As[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
        const float* pr = Ps + g * PS;
#pragma unroll 4
        for (int jj = 0; jj < BK; ++jj) {
          float vf[VEC];
          load16(Vs + jj * KS + dg * VEC, vf);
          const float p = pr[jj];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAX_G / 8; ++r) {
      const int g = warp + 8 * r;
      if (g < G) Ls[g] = l_r[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R2; ++r) {
    const int g = hs2 + HS2 * r;
    if (g < G) {
      const float inv = 1.f / fmaxf(Ls[g], 1e-30f);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(&o[head0 + (size_t)g * D + dg * VEC + e], acc[r][e] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* vl,
           void* o, int B, int T_len, int KH, int G, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  decode_fwd<T, D><<<B * KH, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), vl, static_cast<T*>(o), T_len, KH, G,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* vl,
               void* o, int B, int T_len, int KH, int G, int D, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, vl, o, B, T_len, KH, G, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, vl, o, B, T_len, KH, G, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, vl, o, B, T_len, KH, G, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, vl, o, B, T_len, KH, G, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// q: (B, KH * G, D); k, v: (B, T, KH, D); valid_len: (B,) int32;
// o: (B, KH * G, D); all contiguous, 16-byte aligned, on the device of
// `stream`. dtype 0 = float32, 1 = bfloat16. G <= 16. Returns 0, a
// cudaError_t, or -1 for an unsupported D, G or dtype.
int decode_attention_forward(const void* q, const void* k, const void* v,
                             const void* valid_len, void* o, int B, int T,
                             int KH, int G, int D, float scale, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid_len);
  if (G < 1 || G > MAX_G) return -1;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, vl, o, B, T, KH, G, D, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, vl, o, B, T, KH, G, D, scale,
                                     s);
  return -1;
}

const char* decode_attention_error_string(int err) {
  return err < 0 ? "unsupported head dim, group size or dtype"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
