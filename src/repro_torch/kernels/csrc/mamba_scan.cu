// Selective scan (the Mamba recurrence) for Hopper (sm_90a), with the
// state read from and written back to device memory. Two kernels, chosen
// by the wrapper from T (repro_torch/kernels/mamba_scan.py: route): a
// prompt (T > 1) takes the chunked scan (mamba_scan_fwd), a decode step
// (T = 1) one step (mamba_step_fwd).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py:mamba_scan
// (body _mamba_kernel). Same function, per batch row b, channel e and
// step t, in fp32:
//   h[n] = exp(dt_t A[e, n]) h[n] + dt_t u_t B_t[n]
//   y_t  = sum_n h[n] C_t[n] + D[e] u_t
// with u, dt (Bt, T, E), B, C (Bt, T, N) each in float32 or bfloat16 as
// the model gives them, A (E, N) and D (E,) float32, and y in u's dtype
// (D u added in fp32 before the cast). The TPU kernel starts from h = 0
// and returns y only; these read the initial h (Bt, E, N) and write the
// final one in place, as the served model needs. B and C may be column
// slices of one projection: they are read with a row stride (elements
// between consecutive (b, t) rows), so the model hands them over without
// a copy. N <= 16: states past N stay 0.
//
// Bound on an H100 SXM at Jamba's served prefill (Bt 4, T 512, E 8192,
// N 16; u, B, C and y bf16, dt fp32): bytes, 134 MB, 40 us at 3.35 TB/s.
// Beneath it lies a floor the bytes do not show: 4 x 512 x 8192 x 16 =
// 268 M exponentials, which the special-function units (16 results a
// clock an SM) take 64 us for at 1.98 GHz (72 us at 1.755 GHz).
//
// Design (scan). A thread owns one (b, e) channel: its 16 states in
// registers, with A[e, :] pre-scaled by log2(e). A block is 64 channels
// (64 threads), the grid (E / 64, Bt): 512 blocks at the served prefill.
// Chunks of 32 steps of u and dt (the block's 64 columns) and of B and C
// (their N columns) are staged with cp.async into two stages, so chunk
// c + 1 arrives while chunk c runs; B and C are widened to fp32 in shared
// memory once a chunk, and a step reads them as 16-byte broadcasts. The
// step loop is unrolled by 4: exp(dt A) does not depend on h, so the
// next steps' loads and exponentials issue while this step's sums finish
// (h's update is one FMA deep a step). The exponentials are 2^(dt A
// log2 e): ex2.approx on the special-function unit, and for PJ = 1 of a
// channel's 16 states a polynomial on the FMA pipe (exp2_fma: Cody-Waite
// reduction to |f| <= 1/2, a degree-5 minimax polynomial for 2^f with
// c0 = 1, 2^j added to the exponent bits; coefficients from the wrapper,
// relative error 1.7e-7). Throwaway variants on one H100 (no number kept)
// ranked the layouts: two or four threads a channel (more warps, y
// summed by shuffles) and two channels a thread (half the shared-memory
// loads an element) were slower than one thread a channel; one
// polynomial state in 16 was the fastest share, and all 16 on the
// polynomial the slowest; y gathered a chunk at a time in shared memory
// and stored in rows after the chunk was slower than each thread storing
// its channel's y every step (a warp's 32 adjacent values).
//
// Design (step, T = 1). No staging: a thread owns (b, e, 4 states) and
// reads and writes h with coalesced 16-byte accesses; y's four quarters
// are summed with two shuffles; B's and C's rows, shared by every channel
// of a block, come through the cache. A throwaway variant with a thread
// per (e, 4 states) looping over b, which reads A once, was slower (no
// number kept): a quarter of the loads in flight. The bound is h's 4.2 MB
// in and out (1.25 us); the launch's fixed cost is most of its time.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/mamba_scan.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "stage.cuh"

namespace {

constexpr int MCH = 64;             // channels (threads) a block
constexpr int PJ = 1;               // states a thread computes by exp2_fma
constexpr int CT = 32;              // steps a chunk
constexpr int MAXN = 16;            // state size, at most
constexpr int BC_RAW = CT * MAXN * 4;  // a stage's B (or C) rows, bytes
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NPOLY = 6;            // coefficients of 2^f, degree 5

struct Poly {
  float c[NPOLY];  // 2^f = c0 + c1 f + ... + c5 f^5 for |f| <= 1/2
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float ld(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the FMA pipe. x is clamped to [-125, 127], where 2^x is normal
// (below, 2^x < 2^-125 is taken as 2^-125); x = j + f with j = rint(x)
// from the magic-number add (1.5 * 2^23 puts j in the low bits, whose
// shift by 23 is j's exponent field: the constant's own bits shift out),
// |f| <= 1/2, 2^f by Horner.
__device__ __forceinline__ float exp2_fma(float x, const Poly& p) {
  x = fminf(fmaxf(x, -125.f), 127.f);
  const float big = x + 12582912.f;
  const float f = x - (big - 12582912.f);
  float r = p.c[NPOLY - 1];
#pragma unroll
  for (int i = NPOLY - 2; i >= 0; --i) r = fmaf(r, f, p.c[i]);
  return __int_as_float(__float_as_int(r) + (__float_as_int(big) << 23));
}

// a stage's CT rows of B (or C), MAXN values of bf16 or fp32 each, widened
// to fp32 rows of dst's [CT][2][MAXN] layout; the dtype is tested once
__device__ __forceinline__ void widen(float* dst, const unsigned char* raw,
                                      int bf16, int tid) {
  if (bf16) {
    const __nv_bfloat16* const r = reinterpret_cast<const __nv_bfloat16*>(raw);
    for (int i = tid; i < CT * MAXN; i += MCH)
      dst[(i / MAXN) * 2 * MAXN + i % MAXN] = __bfloat162float(r[i]);
  } else {
    const float* const r = reinterpret_cast<const float*>(raw);
    for (int i = tid; i < CT * MAXN; i += MCH)
      dst[(i / MAXN) * 2 * MAXN + i % MAXN] = r[i];
  }
}

// grid (ceil(E / MCH), Bt); see the note above. TU, TD: u's and dt's
// types. The bound of 6 blocks an SM caps a thread at 170 registers,
// which scheduled the unrolled steps a few percent faster than no cap.
template <typename TU, typename TD>
__global__ void __launch_bounds__(MCH, 6)
    mamba_scan_fwd(const TU* __restrict__ u, const TD* __restrict__ dt,
                   const float* __restrict__ A, const void* __restrict__ Bm,
                   const void* __restrict__ Cm, const float* __restrict__ D,
                   float* __restrict__ h, TU* __restrict__ y, int T, int E,
                   int N, long long ldb, long long ldc, int b_bf16,
                   int c_bf16, int vec_u, int vec_dt, int vec_bc, Poly poly) {
  constexpr int U_BYTES = CT * MCH * sizeof(TU);
  constexpr int D_BYTES = CT * MCH * sizeof(TD);
  constexpr int STAGE = U_BYTES + D_BYTES + 2 * BC_RAW;
  extern __shared__ __align__(16) unsigned char smem[];
  // B and C in fp32, [CT][2][MAXN]
  float* const bcf = reinterpret_cast<float*>(smem + 2 * STAGE);

  const int tid = threadIdx.x;
  const int b = blockIdx.y, e0 = blockIdx.x * MCH, e = e0 + tid;
  const bool live = e < E;
  const int live_ch = min(MCH, E - e0);
  float* const hb = h + ((size_t)b * E + e) * N;
  float a2[MAXN], hr[MAXN];
#pragma unroll
  for (int j = 0; j < MAXN; ++j) {
    const bool in = live && j < N;
    a2[j] = in ? A[(size_t)e * N + j] * LOG2E : 0.f;
    hr[j] = in ? hb[j] : 0.f;
  }
  const float dd = live ? D[e] : 0.f;
  const int eb = b_bf16 ? 2 : 4, ec = c_bf16 ? 2 : 4;

  auto load = [&](int chunk, int slot) {
    const int t0 = chunk * CT, nt = min(CT, T - t0);
    const size_t row0 = (size_t)b * T + t0;
    unsigned char* const st = smem + slot * STAGE;
    stage_rows(st, MCH * sizeof(TU),
               reinterpret_cast<const unsigned char*>(u + row0 * E + e0),
               (long long)E * sizeof(TU), CT, MCH * sizeof(TU), nt,
               live_ch * sizeof(TU), vec_u, sizeof(TU), tid, MCH);
    stage_rows(st + U_BYTES, MCH * sizeof(TD),
               reinterpret_cast<const unsigned char*>(dt + row0 * E + e0),
               (long long)E * sizeof(TD), CT, MCH * sizeof(TD), nt,
               live_ch * sizeof(TD), vec_dt, sizeof(TD), tid, MCH);
    stage_rows(st + U_BYTES + D_BYTES, MAXN * eb,
               static_cast<const unsigned char*>(Bm) + row0 * ldb * eb,
               ldb * eb, CT, MAXN * eb, nt, N * eb, vec_bc, eb, tid, MCH);
    stage_rows(st + U_BYTES + D_BYTES + BC_RAW, MAXN * ec,
               static_cast<const unsigned char*>(Cm) + row0 * ldc * ec,
               ldc * ec, CT, MAXN * ec, nt, N * ec, vec_bc, ec, tid, MCH);
    cp_commit();
  };

  const int nch = (T + CT - 1) / CT;
  load(0, 0);
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * CT, nt = min(CT, T - t0);
    if (c + 1 < nch) {
      load(c + 1, (c + 1) & 1);  // its slot was last read by chunk c - 1
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk c has landed for every thread's copies
    const unsigned char* const st = smem + (c & 1) * STAGE;
    const TU* const us = reinterpret_cast<const TU*>(st);
    const TD* const dts = reinterpret_cast<const TD*>(st + U_BYTES);
    widen(bcf, st + U_BYTES + D_BYTES, b_bf16, tid);
    widen(bcf + MAXN, st + U_BYTES + D_BYTES + BC_RAW, c_bf16, tid);
    __syncthreads();
    // unrolled so that the next steps' loads and exponentials issue while
    // this step's sums finish (each step's h update is one FMA deep)
#pragma unroll 4
    for (int s = 0; s < nt; ++s) {
      const float dl = to_f(dts[s * MCH + tid]), uu = to_f(us[s * MCH + tid]);
      const float du = dl * uu;
      const float* const bc = bcf + s * 2 * MAXN;
      float bv[MAXN], cv[MAXN];
#pragma unroll
      for (int j = 0; j < MAXN; j += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bc + j);
        const float4 c4 = *reinterpret_cast<const float4*>(bc + MAXN + j);
        bv[j] = b4.x, bv[j + 1] = b4.y, bv[j + 2] = b4.z, bv[j + 3] = b4.w;
        cv[j] = c4.x, cv[j + 1] = c4.y, cv[j + 2] = c4.z, cv[j + 3] = c4.w;
      }
      float dA[MAXN];
#pragma unroll
      for (int j = 0; j < MAXN; ++j)
        dA[j] = j < MAXN - PJ ? ex2(dl * a2[j]) : exp2_fma(dl * a2[j], poly);
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < MAXN; ++j) {
        hr[j] = fmaf(dA[j], hr[j], du * bv[j]);
        yv = fmaf(hr[j], cv[j], yv);
      }
      if (live) store(y + ((size_t)b * T + t0 + s) * E + e, fmaf(dd, uu, yv));
    }
    __syncthreads();  // the stage's readers are done
  }
#pragma unroll
  for (int j = 0; j < MAXN; ++j)
    if (live && j < N) hb[j] = hr[j];
}

constexpr int STEP_THREADS = 128;

// one step (T = 1): grid (ceil(E G / STEP_THREADS), Bt); thread (e, q) of
// batch row blockIdx.y owns states 4q .. 4q + 3 of channel e (QUAD: N =
// 16 and h, A 16-byte aligned, G = 4), or, else, all N states (G = 1)
template <typename TU, typename TD, bool QUAD>
__global__ void __launch_bounds__(STEP_THREADS)
    mamba_step_fwd(const TU* __restrict__ u, const TD* __restrict__ dt,
                   const float* __restrict__ A, const void* __restrict__ Bm,
                   const void* __restrict__ Cm, const float* __restrict__ D,
                   float* __restrict__ h, TU* __restrict__ y, int E, int N,
                   long long ldb, long long ldc, int b_bf16, int c_bf16) {
  const long long gid = (long long)blockIdx.x * STEP_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const int e = QUAD ? (int)(gid >> 2) : (int)gid;
  const int n0 = QUAD ? 4 * (int)(gid & 3) : 0;
  const bool live = e < E;  // whole quads agree: the shuffles stay legal
  float yv = 0.f, uu = 0.f, dd = 0.f;
  if (live) {
    const size_t be = (size_t)b * E + e;
    dd = D[e];
    const float dl = to_f(dt[be]);
    uu = to_f(u[be]);
    const float du = dl * uu;
    if constexpr (QUAD) {
      float4* const hp = reinterpret_cast<float4*>(h + be * MAXN + n0);
      const float4 hv = *hp;
      const float4 a4 =
          *reinterpret_cast<const float4*>(A + (size_t)e * MAXN + n0);
      const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
      const float as[4] = {a4.x, a4.y, a4.z, a4.w};
      float hn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hn[j] = fmaf(ex2(dl * (as[j] * LOG2E)), hs[j],
                     du * ld(Bm, (size_t)b * ldb + n0 + j, b_bf16));
        yv = fmaf(hn[j], ld(Cm, (size_t)b * ldc + n0 + j, c_bf16), yv);
      }
      *hp = make_float4(hn[0], hn[1], hn[2], hn[3]);
    } else {
      float* const hb = h + be * N;
      for (int n = 0; n < N; ++n) {
        const float hn = fmaf(ex2(dl * (A[(size_t)e * N + n] * LOG2E)), hb[n],
                              du * ld(Bm, (size_t)b * ldb + n, b_bf16));
        hb[n] = hn;
        yv = fmaf(hn, ld(Cm, (size_t)b * ldc + n, c_bf16), yv);
      }
    }
  }
  if (QUAD) {
    yv += __shfl_xor_sync(0xffffffffu, yv, 1);
    yv += __shfl_xor_sync(0xffffffffu, yv, 2);
  }
  if (live && n0 == 0) store(y + (size_t)b * E + e, fmaf(dd, uu, yv));
}

template <typename TU, typename TD>
int launch_scan(const void* u, const void* dt, const float* A, const void* B,
                const void* C, const float* D, float* h, void* y, int Bt,
                int T, int E, int N, long long ldb, long long ldc, int b_bf16,
                int c_bf16, int vec_u, int vec_dt, int vec_bc, Poly poly,
                cudaStream_t s) {
  constexpr int SMEM =
      2 * (CT * MCH * (sizeof(TU) + sizeof(TD)) + 2 * BC_RAW) +
      CT * 2 * MAXN * 4;
  static unsigned int smem_set = 0;
  cudaError_t err = set_smem_once((const void*)mamba_scan_fwd<TU, TD>, SMEM,
                                  &smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((E + MCH - 1) / MCH, Bt);
  mamba_scan_fwd<TU, TD><<<grid, MCH, SMEM, s>>>(
      static_cast<const TU*>(u), static_cast<const TD*>(dt), A, B, C, D, h,
      static_cast<TU*>(y), T, E, N, ldb, ldc, b_bf16, c_bf16, vec_u, vec_dt,
      vec_bc, poly);
  return (int)cudaGetLastError();
}

template <typename TU, typename TD>
void step_typed(const void* u, const void* dt, const float* A, const void* B,
                const void* C, const float* D, float* h, void* y, int Bt,
                int E, int N, long long ldb, long long ldc, int b_bf16,
                int c_bf16, int quad, cudaStream_t s) {
  const TU* const uu = static_cast<const TU*>(u);
  const TD* const dd = static_cast<const TD*>(dt);
  const long long threads = quad ? 4LL * E : (long long)E;
  const dim3 grid((unsigned)((threads + STEP_THREADS - 1) / STEP_THREADS),
                  Bt);
  if (quad)
    mamba_step_fwd<TU, TD, true><<<grid, STEP_THREADS, 0, s>>>(
        uu, dd, A, B, C, D, h, static_cast<TU*>(y), E, N, ldb, ldc, b_bf16,
        c_bf16);
  else
    mamba_step_fwd<TU, TD, false><<<grid, STEP_THREADS, 0, s>>>(
        uu, dd, A, B, C, D, h, static_cast<TU*>(y), E, N, ldb, ldc, b_bf16,
        c_bf16);
}

}  // namespace

extern "C" {

// The scan route (T >= 1; the wrapper sends T > 1). u, dt, y: (Bt, T, E)
// contiguous; A: (E, N), D: (E,) float32; B, C: (Bt, T, N) with unit
// column stride and row stride ldb, ldc elements; h: (Bt, E, N) float32,
// read and overwritten. *_bf16 = 1 for bfloat16, 0 for float32; y takes
// u's. vec_u, vec_dt, vec_bc: those rows are 16-byte aligned (copied with
// cp.async). coef: the NPOLY coefficients of exp2_fma. N <= 16. Returns
// 0, a cudaError_t, or -1 for an unsupported N.
int mamba_scan_forward(const void* u, const void* dt, const void* A,
                       const void* B, const void* C, const void* D, void* h,
                       void* y, int Bt, int T, int E, int N, long long ldb,
                       long long ldc, int u_bf16, int dt_bf16, int b_bf16,
                       int c_bf16, int vec_u, int vec_dt, int vec_bc,
                       const float* coef, void* stream) {
  if (N < 1 || N > MAXN) return -1;
  Poly poly;
  for (int i = 0; i < NPOLY; ++i) poly.c[i] = coef[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *Af = static_cast<const float*>(A),
              *Df = static_cast<const float*>(D);
  float* hf = static_cast<float*>(h);
  if (u_bf16 && !dt_bf16)
    return launch_scan<__nv_bfloat16, float>(u, dt, Af, B, C, Df, hf, y, Bt,
                                             T, E, N, ldb, ldc, b_bf16,
                                             c_bf16, vec_u, vec_dt, vec_bc,
                                             poly, s);
  if (u_bf16)
    return launch_scan<__nv_bfloat16, __nv_bfloat16>(
        u, dt, Af, B, C, Df, hf, y, Bt, T, E, N, ldb, ldc, b_bf16, c_bf16,
        vec_u, vec_dt, vec_bc, poly, s);
  if (dt_bf16)
    return launch_scan<float, __nv_bfloat16>(u, dt, Af, B, C, Df, hf, y, Bt,
                                             T, E, N, ldb, ldc, b_bf16,
                                             c_bf16, vec_u, vec_dt, vec_bc,
                                             poly, s);
  return launch_scan<float, float>(u, dt, Af, B, C, Df, hf, y, Bt, T, E, N,
                                   ldb, ldc, b_bf16, c_bf16, vec_u, vec_dt,
                                   vec_bc, poly, s);
}

// The step route (T = 1), the same layouts with T = 1. quad: N = 16 and
// h, A 16-byte aligned (a thread per 4 states). Returns 0, a
// cudaError_t, or -1 for an unsupported N.
int mamba_step_forward(const void* u, const void* dt, const void* A,
                       const void* B, const void* C, const void* D, void* h,
                       void* y, int Bt, int E, int N, long long ldb,
                       long long ldc, int u_bf16, int dt_bf16, int b_bf16,
                       int c_bf16, int quad, void* stream) {
  if (N < 1 || N > MAXN || (quad && N != MAXN)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *Af = static_cast<const float*>(A),
              *Df = static_cast<const float*>(D);
  float* hf = static_cast<float*>(h);
  if (u_bf16 && !dt_bf16)
    step_typed<__nv_bfloat16, float>(u, dt, Af, B, C, Df, hf, y, Bt, E, N,
                                     ldb, ldc, b_bf16, c_bf16, quad, s);
  else if (u_bf16)
    step_typed<__nv_bfloat16, __nv_bfloat16>(u, dt, Af, B, C, Df, hf, y, Bt,
                                             E, N, ldb, ldc, b_bf16, c_bf16,
                                             quad, s);
  else if (dt_bf16)
    step_typed<float, __nv_bfloat16>(u, dt, Af, B, C, Df, hf, y, Bt, E, N,
                                     ldb, ldc, b_bf16, c_bf16, quad, s);
  else
    step_typed<float, float>(u, dt, Af, B, C, Df, hf, y, Bt, E, N, ldb, ldc,
                             b_bf16, c_bf16, quad, s);
  return (int)cudaGetLastError();
}

const char* mamba_scan_error_string(int err) {
  return err < 0 ? "unsupported state size (N must be 1..16) or share"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
