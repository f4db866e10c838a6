// Decode attention for Hopper (sm_90a): one new token per sequence
// against a KV cache, the cache split across the blocks of a thread-block
// cluster and combined on chip, in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:
// decode_attention (body _decode_kernel). Same function: q (B, H, D)
// with H = KH * G, k and v (B, T, KH, D), valid_len (B,) int32 read from
// device memory; fp32 scores scaled by 1/sqrt(D), columns at or past
// valid_len[b] masked, online softmax in fp32, output acc / max(l, 1e-30)
// in the input dtype (float32 or bfloat16). So valid_len = 0 gives zeros.
// T need not be a multiple of any tile: rows at or past valid_len are
// never read (their shared-memory rows are zero-filled).
//
// Design (flash-decoding). The TPU kernel walks the cache of one (batch,
// KV head) in order on one core; here the grid is (B * KH, splits) and
// the `splits` blocks of a (batch, KV head) form one cluster. Split s
// owns rows [s * rows, (s + 1) * rows) of the cache, `rows` a multiple of
// 64; the wrapper picks `splits` (at most 8, a portable cluster) from T,
// B * KH and the SM count, never from valid_len, which only the device
// reads. A block whose rows all lie at or past valid_len[b] loads nothing
// and leaves an empty partial (m = -inf, l = 0). Inside a block each of
// the 4 warps takes every 4th chunk of 16 rows and keeps its own online
// softmax state, so warps never wait for one another: a warp streams its
// chunks through a private ring of shared-memory stages with 16-byte
// cp.async loads, NSTAGE - 1 chunks in flight while it computes on one.
// At the end the 4 warp partials are merged in shared memory into the
// block's (m, l, acc) for its G query heads; after cluster.sync() each
// block reads the partials of every block of its cluster through
// distributed shared memory and writes 1/splits of the output; a second
// cluster.sync() keeps every block's shared memory alive until its peers
// are done reading it. No scratch in device memory, no second launch.
//
// Arithmetic. bfloat16 runs both products on tensor cores (mma.sync
// m16n8k16, fp32 accumulate): S = Q K^T with the G <= 16 query heads as
// the 16 rows of A (rows past G are zero; at G = 8 half the rows are
// padding, which costs nothing on a kernel bound by bytes), K from
// shared memory by ldmatrix; then O += P V with P, the fp32
// probabilities, rounded to bfloat16 as the A operand and V read by
// ldmatrix.trans. That rounding of P (8 bits of mantissa) is the one
// numerical difference from the TPU kernel, which multiplies fp32 P by V
// widened to fp32; Q K^T loses nothing (a product of two bf16 values is
// exact in fp32), and l sums the unrounded fp32 P. float32 (not on the
// served path; the model's float32 checks) keeps every product in fp32
// on CUDA cores in the same structure.
//
// Bound on an H100 SXM: bytes, the live rows of K and V read once. One
// layer of decode_32k (B 128, 32769 live rows of KH 4 x D 128, bf16) is
// 8.6 GB, 2.56 ms at 3.35 TB/s; the tensor cores do ~4 flops a byte, far
// below the ridge. At the served decode shape (B 4, <= 544 live rows of
// T 1024) it reads 4.5 MB (1.3 us): there 16 (batch, KV head) pairs x 8
// splits give 128 blocks for 132 SMs, where one block per pair left 116
// SMs idle.
//
// Log-sum-exp (optional). Calls over disjoint row blocks of one cache
// (the model ranks of a sequence-sharded cache) are joined outside the
// kernel from each call's output and log-sum-exp. The cluster's combine
// already holds the head's (m, l) over all its splits, so with an lse
// pointer the first split's block writes ln 2 * (m + log2 l) per (batch,
// head) (m is in log2 units), -inf where l = 0: B * H floats more, no
// other work. It is a template flag, so the launch without it keeps its
// code.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/decode_attention.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 16;             // rows a warp takes at a time
constexpr int TILE = WARPS * CHUNK;   // split sizes are multiples of this
constexpr int MAX_G = 16;             // query heads per KV head
constexpr int MAX_SPLITS = 8;         // blocks of a (portable) cluster
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int D>
struct Cfg {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VEC = 16 / sizeof(T);    // elements in 16 bytes
  static constexpr int DV = D / VEC;            // 16-byte pieces a row
  static constexpr int RS = D + VEC;            // padded row stride
  static constexpr int NSTAGE = BF16 ? 3 : 2;   // chunks in a warp's ring
  static constexpr int STAGE = 2 * CHUNK * RS;  // K rows, then V rows
  static constexpr size_t stage_bytes =
      sizeof(T) * (size_t)WARPS * NSTAGE * STAGE;
  static constexpr int PART = MAX_G * D + 2 * MAX_G;  // acc, m, l
  // fp32 only: q and the warps' probabilities in shared memory
  static constexpr int QF = BF16 ? 0 : MAX_G * D + WARPS * MAX_G * CHUNK
                                           + WARPS * MAX_G;
  static constexpr size_t smem_bytes =
      stage_bytes + sizeof(float) * (size_t)(PART + MAX_SPLITS * MAX_G + QF);
  static_assert(sizeof(float) * WARPS * PART <= stage_bytes,
                "the warp partials alias the stage ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a b: m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a finite stand-in for an m that is still -inf (no live column yet), so
// that exp2(x - m) is 0, never NaN
__device__ __forceinline__ float finite_m(float m) {
  return m == -INFINITY ? 0.f : m;
}

// Streams warp `warp`'s chunks of rows [r0, r1) through its ring and
// hands each to `body(stage K rows, stage V rows, first row)`.
template <typename T, int D, typename Body>
__device__ __forceinline__ void stream_chunks(const T* kb, const T* vb,
                                              size_t row, int r0, int r1,
                                              T* ring, int warp, int lane,
                                              Body body) {
  using C = Cfg<T, D>;
  const int n_chunks = r1 > r0 ? (r1 - r0 + CHUNK - 1) / CHUNK : 0;
  const int mine = n_chunks > warp ? (n_chunks - warp + WARPS - 1) / WARPS : 0;
  auto load = [&](int i) {
    T* st = ring + (i % C::NSTAGE) * C::STAGE;
    const int base = r0 + (warp + WARPS * i) * CHUNK;
#pragma unroll
    for (int p = lane; p < CHUNK * C::DV; p += 32) {
      const int r = p / C::DV, c = (p % C::DV) * C::VEC;
      const bool ok = base + r < r1;
      const size_t off = ok ? (size_t)(base + r) * row + c : 0;
      cp_async16(st + r * C::RS + c, kb + off, ok);
      cp_async16(st + (CHUNK + r) * C::RS + c, vb + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < C::NSTAGE - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + C::NSTAGE - 1 < mine) load(i + C::NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<C::NSTAGE - 1>();
    __syncwarp();
    const T* st = ring + (i % C::NSTAGE) * C::STAGE;
    body(st, st + CHUNK * C::RS, r0 + (warp + WARPS * i) * CHUNK);
    __syncwarp();  // the stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();
}

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
    decode_split(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ valid_len,
                 T* __restrict__ o, float* __restrict__ lse, int T_len,
                 int KH, int G, int rows, float scale) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring_all = reinterpret_cast<T*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw + C::stage_bytes);
  float* bacc = part;                    // MAX_G x D, the block partial
  float* bm = part + MAX_G * D;          // MAX_G
  float* bl = bm + MAX_G;                // MAX_G
  float* cw = bl + MAX_G;                // MAX_SPLITS x MAX_G weights
  float* extra = cw + MAX_SPLITS * MAX_G;  // fp32 only
  // after the stream: the warp partials, in the ring's place
  float* wpart = reinterpret_cast<float*>(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int split = blockIdx.y, splits = gridDim.y;
  const int valid = min(max(valid_len[b], 0), T_len);
  const int r0 = split * rows;
  const int r1 = min(r0 + rows, valid);
  const size_t row = (size_t)KH * D;  // elements between cache rows
  const T* kb = k + (size_t)b * T_len * row + (size_t)kh * D;
  const T* vb = v + (size_t)b * T_len * row + (size_t)kh * D;
  const size_t head0 = ((size_t)b * KH + kh) * G * D;  // q, o: (B, H, D)
  const float sl2 = scale * LOG2E;  // scores in log2 units: exp2 below
  T* ring = ring_all + warp * C::NSTAGE * C::STAGE;
  float* wp = wpart + warp * C::PART;  // this warp's partial

  if constexpr (C::BF16) {
    // A fragments of Q (16 heads x D, rows past G zero), kept in registers
    const int g0 = lane >> 2, kq = 2 * (lane & 3);
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = g0 + 8 * (e & 1), d = ks * 16 + kq + 8 * (e >> 1);
        qa[ks][e] = g < G ? *reinterpret_cast<const uint32_t*>(
                                q + head0 + (size_t)g * D + d)
                          : 0u;
      }
    // rows g0 and g0 + 8 of S and O; acc[j] covers columns 8j..8j+7
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    stream_chunks<T, D>(kb, vb, row, r0, r1, ring, warp, lane,
                        [&](const T* Ks, const T* Vs, int base) {
      // S = Q K^T over the chunk's 16 keys: s[j] for keys 8j..8j+7
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + ((mi >> 1) * 8 + ri) * C::RS + ks * 16 +
                            (mi & 1) * 8);
        mma_bf16(s[0], qa[ks], kf[0], kf[1]);
        mma_bf16(s[1], qa[ks], kf[2], kf[3]);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = base + 8 * j + kq + (e & 1);
          const float x = col < r1 ? s[j][e] * sl2 : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        mu[h] = finite_m(m_new);
        alpha[h] = exp2f(m_r[h] - mu[h]);
        m_r[h] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - mu[e >> 1]);
          psum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + psum[h];
      // P as the A operand: rows g0, g0 + 8; keys 0-7, then 8-15
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + ((mi & 1) * 8 + ri) * C::RS + jp * 16 +
                                  (mi >> 1) * 8);
        mma_bf16(acc[2 * jp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * jp + 1], pa, vf[2], vf[3]);
      }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    }
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = g0 + 8 * h;
      if (g < G) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          wp[g * D + 8 * j + kq] = acc[j][2 * h];
          wp[g * D + 8 * j + kq + 1] = acc[j][2 * h + 1];
        }
        if ((lane & 3) == 0) {
          wp[MAX_G * D + g] = m_r[h];
          wp[MAX_G * D + MAX_G + g] = l_r[h];
        }
      }
    }
  } else {
    // float32 on CUDA cores: lane (key j, head parity hh) scores key j
    // against heads hh, hh + 2, ...; then lane owns columns lane + 32c
    float* qs = extra;                           // MAX_G x D
    float* ps = qs + MAX_G * D + warp * MAX_G * CHUNK;  // MAX_G x CHUNK
    float* as = qs + MAX_G * D + WARPS * MAX_G * CHUNK + warp * MAX_G;
    for (int i = tid; i < G * D; i += THREADS) qs[i] = q[head0 + i];
    __syncthreads();
    constexpr int NC = (D + 31) / 32;
    const int j = lane & 15, hh = lane >> 4;
    const unsigned half = 0xffffu << (16 * hh);  // this lane's 16-lane half
    float m_r[MAX_G / 2], l_r[MAX_G / 2];
#pragma unroll
    for (int r = 0; r < MAX_G / 2; ++r) {
      m_r[r] = -INFINITY;
      l_r[r] = 0.f;
    }
    float acc[MAX_G][NC];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[g][c] = 0.f;
    stream_chunks<T, D>(kb, vb, row, r0, r1, ring, warp, lane,
                        [&](const T* Ks, const T* Vs, int base) {
      float s[MAX_G / 2];
#pragma unroll
      for (int r = 0; r < MAX_G / 2; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(Ks) + j * C::RS + d);
#pragma unroll
        for (int r = 0; r < MAX_G / 2; ++r) {
          const int g = hh + 2 * r;
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + d);
            s[r] = fmaf(qv.x, kv.x, s[r]);
            s[r] = fmaf(qv.y, kv.y, s[r]);
            s[r] = fmaf(qv.z, kv.z, s[r]);
            s[r] = fmaf(qv.w, kv.w, s[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_G / 2; ++r) {
        const int g = hh + 2 * r;
        if (g < G) {  // uniform over each 16-lane half
          const float x = base + j < r1 ? s[r] * sl2 : -INFINITY;
          float mx = x;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(half, mx, off));
          const float m_new = fmaxf(m_r[r], mx);
          const float mu = finite_m(m_new);
          const float alpha = exp2f(m_r[r] - mu);
          const float p = exp2f(x - mu);
          float ps_sum = p;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            ps_sum += __shfl_xor_sync(half, ps_sum, off);
          l_r[r] = l_r[r] * alpha + ps_sum;
          m_r[r] = m_new;
          ps[g * CHUNK + j] = p;
          if (j == 0) as[g] = alpha;
        }
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float alpha = as[g];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[g][c] *= alpha;
#pragma unroll 4
          for (int jj = 0; jj < CHUNK; ++jj) {
            const float p = ps[g * CHUNK + jj];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int d = lane + 32 * c;
              if (d < D)
                acc[g][c] = fmaf(
                    p, reinterpret_cast<const float*>(Vs)[jj * C::RS + d],
                    acc[g][c]);
            }
          }
        }
      }
      __syncwarp();  // ps and as are rewritten by the next chunk
    });
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) wp[g * D + d] = acc[g][c];
        }
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < MAX_G / 2; ++r) {
        const int g = hh + 2 * r;
        if (g < G) {
          wp[MAX_G * D + g] = m_r[r];
          wp[MAX_G * D + MAX_G + g] = l_r[r];
        }
      }
    }
  }
  __syncthreads();

  // the block's partial: the 4 warps' merged
  if (tid < G) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, wpart[w * C::PART + MAX_G * D + tid]);
    const float mu = finite_m(m);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(wpart[w * C::PART + MAX_G * D + tid] - mu);
      cw[w * MAX_G + tid] = wt;
      l += wt * wpart[w * C::PART + MAX_G * D + MAX_G + tid];
    }
    bm[tid] = m;
    bl[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += cw[w * MAX_G + g] * wpart[w * C::PART + i];
    bacc[i] = a;
  }

  // the cluster's splits, combined: this block writes 1/splits of o.
  // Remote reads are issued together (one a thread, or unrolled), so the
  // combine waits for distributed shared memory about twice, not once a
  // split.
  cluster.sync();
  __shared__ float fm[MAX_SPLITS][MAX_G], fl[MAX_SPLITS][MAX_G];
  for (int i = tid; i < splits * G; i += THREADS) {
    const int r = i / G, g = i % G;
    fm[r][g] = *cluster.map_shared_rank(bm + g, r);
    fl[r][g] = *cluster.map_shared_rank(bl + g, r);
  }
  __syncthreads();
  if (tid < G) {
    float m = -INFINITY;
    for (int r = 0; r < splits; ++r) m = fmaxf(m, fm[r][tid]);
    const float mu = finite_m(m);
    float l = 0.f;
    for (int r = 0; r < splits; ++r) {
      fm[r][tid] = exp2f(fm[r][tid] - mu);  // now the split's weight
      l += fm[r][tid] * fl[r][tid];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int r = 0; r < splits; ++r) fm[r][tid] *= inv;
    if constexpr (LSE) {
      if (split == 0)
        lse[head0 / D + tid] = l > 0.f ? (mu + log2f(l)) * LN2 : -INFINITY;
    }
  }
  __syncthreads();
  const int per = (G * D + splits - 1) / splits;
  const int lo = split * per, hi = min(lo + per, G * D);
  for (int i = lo + tid; i < hi; i += THREADS) {
    const int g = i / D;
    float part[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      part[r] = r < splits ? *cluster.map_shared_rank(bacc + i, r) : 0.f;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) a += fm[r][g] * part[r];
    store(&o[head0 + i], a);
  }
  cluster.sync();  // peers read this block's partial until here
}

template <typename T, int D, bool LSE>
int launch(const void* q, const void* k, const void* v, const int* vl,
           void* o, float* lse, int B, int T_len, int KH, int G, int splits,
           int rows, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Cfg<T, D>::smem_bytes;
  static unsigned int smem_set = 0;
  cudaError_t err = set_smem_once((const void*)decode_split<T, D, LSE>,
                                  (int)bytes, &smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KH, splits, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_split<T, D, LSE>,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), vl, static_cast<T*>(o),
                           lse, T_len, KH, G, rows, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool LSE>
int dispatch_d(const void* q, const void* k, const void* v, const int* vl,
               void* o, float* lse, int B, int T_len, int KH, int G, int D,
               int splits, int rows, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16, LSE>(q, k, v, vl, o, lse, B, T_len, KH, G, splits,
                                rows, scale, stream);
    case 32:
      return launch<T, 32, LSE>(q, k, v, vl, o, lse, B, T_len, KH, G, splits,
                                rows, scale, stream);
    case 64:
      return launch<T, 64, LSE>(q, k, v, vl, o, lse, B, T_len, KH, G, splits,
                                rows, scale, stream);
    case 128:
      return launch<T, 128, LSE>(q, k, v, vl, o, lse, B, T_len, KH, G,
                                 splits, rows, scale, stream);
    default:
      return -1;
  }
}

template <typename T>
int dispatch_lse(const void* q, const void* k, const void* v, const int* vl,
                 void* o, float* lse, int B, int T_len, int KH, int G, int D,
                 int splits, int rows, float scale, cudaStream_t stream) {
  return lse ? dispatch_d<T, true>(q, k, v, vl, o, lse, B, T_len, KH, G, D,
                                   splits, rows, scale, stream)
             : dispatch_d<T, false>(q, k, v, vl, o, lse, B, T_len, KH, G, D,
                                    splits, rows, scale, stream);
}

}  // namespace

extern "C" {

// q: (B, KH * G, D); k, v: (B, T, KH, D); valid_len: (B,) int32;
// o: (B, KH * G, D); lse: (B, KH * G) float32, or null (not written);
// all contiguous, 16-byte aligned, on the device of `stream`. dtype
// 0 = float32, 1 = bfloat16. G <= 16. `splits` (1..8) blocks share each
// (batch, KV head), split s taking cache rows [s * rows, (s + 1) * rows),
// rows a multiple of 64 with splits * rows >= T. Returns 0, a
// cudaError_t, or -1 for an unsupported D, G, split or dtype.
int decode_attention_forward(const void* q, const void* k, const void* v,
                             const void* valid_len, void* o, void* lse, int B,
                             int T, int KH, int G, int D, int splits, int rows,
                             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid_len);
  if (G < 1 || G > MAX_G || splits < 1 || splits > MAX_SPLITS ||
      rows < 1 || rows % TILE || (long long)splits * rows < T)
    return -1;
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_lse<float>(q, k, v, vl, o, l, B, T, KH, G, D, splits,
                               rows, scale, s);
  if (dtype == 1)
    return dispatch_lse<__nv_bfloat16>(q, k, v, vl, o, l, B, T, KH, G, D,
                                       splits, rows, scale, s);
  return -1;
}

const char* decode_attention_error_string(int err) {
  return err < 0 ? "unsupported head dim, group size, split or dtype"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
