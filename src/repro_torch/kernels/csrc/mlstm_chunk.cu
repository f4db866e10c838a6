// mLSTM recurrence for Hopper (sm_90a), with the state read from and
// written back to device memory. Two kernels, chosen by the wrapper from
// T (repro_torch/kernels/mlstm_chunk.py: route): a prompt (T > 1) takes
// the chunkwise-parallel form on tensor cores (mlstm_chunk_fwd), a decode
// step (T = 1) one recurrent step split over a cluster (mlstm_step_fwd).
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_chunk.py:mlstm_chunk
// (body _mlstm_kernel). Same function, per (batch, head) and step t:
//   m_t = max(lf_t + m_{t-1}, i_t),  lf_t = log_sigmoid(f_t)
//   fg = exp(lf_t + m_{t-1} - m_t),  ig = exp(i_t - m_t)
//   C  = fg C + ig k_t v_t^T,  n = fg n + ig k_t
//   h_t = C^T q_t / max(|n . q_t|, exp(-m_t)),  q_t scaled by dk^-1/2
// in fp32, with q, k, v float32 or bfloat16 (one dtype) and h in theirs.
// The TPU kernel starts from a zero state (m = -1e30) and returns h only;
// these read the initial C, n, m and write the final ones in place, as
// the served model needs. From C = n = 0 and m = -inf the decays are
// exp(-inf) = 0, with no NaN.
//
// Chunkwise form. Over a chunk of L steps from the state (C_c, n_c, m_c)
// at its start, with F_t the sum of lf over the chunk up to t:
//   h_t = [d_t (C_c^T q_t) + sum_{s<=t} w_ts (q_t . k_s) v_s] / den_t
//   n_t . q_t = d_t (n_c . q_t) + sum_{s<=t} w_ts (q_t . k_s)
//   C_{c+L} = d_e C_c + sum_s w_es k_s v_s^T,  n likewise
// with d_t = exp(F_t + m_c - m_t) and w_ts = exp(F_t - F_s + i_s - m_t),
// both <= 1 because m_t is the max-plus recurrence's value; e is the
// chunk's last step. m_t itself enters den_t, so it is the recurrence's,
// bit for bit: the log-sigmoids run in parallel over the chunk's steps,
// and one lane then runs the max-plus recurrence m = max(lf + m, i) (an
// add and a max a step, in the recurrence's order; a tree scan would
// regroup the adds and round differently). Everything else is parallel.
//
// Design (prefill). A block owns a 48-column tile of C of one (batch,
// head) for the whole sequence: grid (B H, ceil(dv / 48)), 128 blocks at
// xlstm-125m's prefill (B 4, H 4, dv 384) on 132 SMs. Its 12 warps are 3
// column tiles of 16 x 4 row quarters of dk, and each keeps its 16 x
// dk/4 slice of the tile as mma accumulators, C^T[col][d], in registers
// (48 floats a thread at dk = 384) across all chunks. Each chunk of L =
// 32 steps is staged with cp.async (q and k rows, the tile's v columns;
// two stages for bfloat16, one for float32: 105 KB either way) and runs
// four products on mma.sync m16n8k8 TF32:
//   S = Q K^T (6 live 16 x 8 tiles of the causal 32 x 32, dk split over
//     2 warps each), then P = S * qscale * w on the CUDA cores;
//   num^T = C^T Q^T over each warp's row quarter, with C's accumulator
//     tiles used as the A operand (the k index permuted within each
//     8-row block so that the layouts agree), scaled by qscale d_t;
//   num^T += V^T P^T, one 8-step block of s a row quarter; the 4 row
//     quarters' partials are summed in shared memory;
//   C^T = d_e C^T + (w V)^T K into the accumulators.
// qscale is applied after the products, never to an operand.
//
// Numerics. Every product keeps float32 accuracy (3xTF32, tf32x3.cuh):
// an operand exact in TF32 (a bfloat16 q, k or v) enters as it is, every
// other (C, P, w v, and all operands in float32) as hi + lo. So S takes
// one mma in bfloat16 and three in float32, the others two and three.
// One TF32 product of a rounded fp32 operand (C, at xlstm's width) would
// be outside the 1e-4 held on the final state.
//
// Design (decode, T = 1). The bound is C's bytes, read and written once.
// The `cs` blocks of a cluster (up to 8: 8 x 16 = 128 blocks at B 4, H 4)
// split C's dk rows; each issues the loads of its rows (16-byte loads,
// 384 threads: 96 four-column groups x 4 row groups, 12 rows a thread)
// before it waits for the gates' loads, updates the rows, writes them
// back and sums its rows of C^T q and of n . q. Each block pushes its
// partial of every column into the shared memory of the block that owns
// the column (distributed shared memory, in the same launch), one cluster
// barrier, and block r sums and writes h's r-th share of columns.
//
// Bound on an H100 SXM at xlstm-125m's served prefill (B 4, T 512, H 4,
// dk = dv = 384, bfloat16): the recurrence's products (C's update and
// read-out, 4 dk dv a step and head, 4.83 GFLOP) taken at float32
// accuracy with one exact operand are 2 x 4.83 GFLOP of TF32 at 495
// TFLOP/s: 19.5 us (29.3 us in float32, 3 products); its bytes (q, k, v,
// h and C in and out, 44 MB) take 13 us. The chunkwise form does 5.2
// GFLOP of products at L = 32 (2 L^2 (dk + dv) + 4 L dk dv a chunk and
// head): 10.3 GFLOP of TF32 as split, 20.7 us. A decode step moves 18.9
// MB of C (5.6 us at 3.35 TB/s).
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/mlstm_chunk.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "stage.cuh"
#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_D = 384;            // dk and dv, at most
constexpr int L = 32;                 // steps a chunk
constexpr int NT = 48;                // columns of C a block
constexpr int CW = NT / 16;           // warps along the columns
constexpr int DQ = 4;                 // warps along dk (row quarters)
constexpr int WARPS = CW * DQ;
constexpr int THREADS = WARPS * 32;   // 384
constexpr int NQ = MAX_D / (8 * DQ);  // 8-row blocks of a quarter, at most
constexpr int SQ = MAX_D + 8;         // row stride (elements) of Q, K stages
constexpr int SV = NT + 8;            // row stride of the V stage
constexpr int SS = L + 8;             // row stride of S partials and red
constexpr int SPP = L + 4;            // row stride of P
constexpr int NGATE = 9;              // per-step gate arrays
static_assert(L / 8 == DQ, "one 8-step block of s for each row quarter");

// shared memory of the chunkwise kernel, bytes (In: q, k, v's type)
template <typename In>
struct Smem {
  static constexpr int NST = sizeof(In) == 2 ? 2 : 1;  // stages
  static constexpr int K_OFF = L * SQ * (int)sizeof(In);
  static constexpr int V_OFF = 2 * K_OFF;
  static constexpr int STAGE = V_OFF + L * SV * (int)sizeof(In);
  static constexpr int SP_OFF = NST * STAGE;     // float [2][L][SS]
  static constexpr int P_OFF = SP_OFF + 2 * L * SS * 4;   // float [L][SPP]
  static constexpr int RED_OFF = P_OFF + L * SPP * 4;     // [DQ][NT][SS]
  static constexpr int N_OFF = RED_OFF + DQ * NT * SS * 4;  // float [MAX_D]
  static constexpr int G_OFF = N_OFF + MAX_D * 4;   // float [NGATE][L]
  static constexpr int BYTES = G_OFF + NGATE * L * 4;
  static_assert(BYTES <= 232448, "shared memory over the 227 KB limit");
  static_assert(STAGE % 16 == 0 && K_OFF % 16 == 0, "16-byte stages");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float ld_gate(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// fragment values as TF32: as they are where EXACT (bfloat16 inputs),
// else split into hi and lo
template <int N, bool EXACT>
__device__ __forceinline__ void to_tf32(const float (&x)[N],
                                        uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (EXACT) {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    } else {
      split_tf32(x[i], hi[i], lo[i]);
    }
  }
}

// d += A B at float32 accuracy: lo*hi and hi*lo only for operands split
template <bool LO_A, bool LO_B>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (LO_A) mma_tf32(d, al, bh[0], bh[1]);
  if (LO_B) mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// grid (B H, ceil(dv / NT)); see the note above
template <typename In>
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_chunk_fwd(const In* __restrict__ q, const In* __restrict__ k,
                    const In* __restrict__ v, const void* __restrict__ i_pre,
                    const void* __restrict__ f_pre, float* __restrict__ C,
                    float* __restrict__ n, float* __restrict__ m,
                    In* __restrict__ h, unsigned int* __restrict__ arrivals,
                    int T, int H, int dk, int dv, float qscale, int g_bf16,
                    int vec_qk, int vec_v) {
  using S = Smem<In>;
  constexpr bool EXACT = sizeof(In) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const Sp = reinterpret_cast<float*>(smem + S::SP_OFF);
  float* const Ps = reinterpret_cast<float*>(smem + S::P_OFF);
  float* const red = reinterpret_cast<float*>(smem + S::RED_OFF);
  float* const ns = reinterpret_cast<float*>(smem + S::N_OFF);
  float* const gate = reinterpret_cast<float*>(smem + S::G_OFF);
  float* const lfs = gate;          // log_sigmoid(f_t)
  float* const ivs = gate + L;      // i_t
  float* const mts = gate + 2 * L;  // m_t
  float* const Fts = gate + 3 * L;  // F_t
  float* const as = gate + 4 * L;   // F_t - m_t
  float* const bs = gate + 5 * L;   // F_s - i_s
  float* const dec = gate + 6 * L;  // d_t
  float* const wst = gate + 7 * L;  // w_es, the state's weight of step s
  float* const nqs = gate + 8 * L;  // n_t . q_t
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int c0 = blockIdx.y * NT;
  const int dkp = (dk + 31) & ~31;  // dk padded to 4 quarters of 8-row blocks
  const int cm = warp % CW, dq = warp / CW;
  const int dbase = dq * (dkp / DQ), nqb = dkp / (8 * DQ);

  // the warp's slice of the C tile: cacc[j] is the m16n8 accumulator tile
  // C^T[16 cm + (g, g + 8)][dbase + 8 j + (2 t, 2 t + 1)]
  float* const Cb = C + (size_t)bh * dk * dv;
  float cacc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dbase + 8 * j + 2 * t + (e & 1);
      const int col = c0 + 16 * cm + g + 8 * (e >> 1);
      cacc[j][e] = (j < nqb && d < dk && col < dv)
                       ? Cb[(size_t)d * dv + col] : 0.f;
    }
  for (int d = tid; d < dkp; d += THREADS)
    ns[d] = d < dk ? n[(size_t)bh * dk + d] : 0.f;
  float m_c = m[bh];

  const long long row_qk = (long long)H * dk, row_v = (long long)H * dv;
  const In* const qb = q + ((size_t)b * T * H + hd) * dk;
  const In* const kb = k + ((size_t)b * T * H + hd) * dk;
  const In* const vb = v + ((size_t)b * T * H + hd) * dv + c0;
  const int live_cols = min(NT, dv - c0);
  constexpr int ESZ = sizeof(In);
  auto load = [&](int chunk, int slot) {
    const long long t0 = (long long)chunk * L;
    const int nt = min(L, T - (int)t0);
    unsigned char* const st = smem + slot * S::STAGE;
    stage_rows(st, SQ * ESZ,
               reinterpret_cast<const unsigned char*>(qb + t0 * row_qk),
               row_qk * ESZ, L, dkp * ESZ, nt, dk * ESZ, vec_qk, ESZ, tid,
               THREADS);
    stage_rows(st + S::K_OFF, SQ * ESZ,
               reinterpret_cast<const unsigned char*>(kb + t0 * row_qk),
               row_qk * ESZ, L, dkp * ESZ, nt, dk * ESZ, vec_qk, ESZ, tid,
               THREADS);
    stage_rows(st + S::V_OFF, SV * ESZ,
               reinterpret_cast<const unsigned char*>(vb + t0 * row_v),
               row_v * ESZ, L, NT * ESZ, nt, live_cols * ESZ, vec_v, ESZ,
               tid, THREADS);
    cp_commit();
  };

  const int nch = (T + L - 1) / L;
  float f_next = 0.f, i_next = 0.f;  // warp 0: step `lane` of the chunk
  if (warp == 0 && lane < T) {
    const size_t gi = ((size_t)b * T + lane) * H + hd;
    f_next = ld_gate(f_pre, gi, g_bf16);
    i_next = ld_gate(i_pre, gi, g_bf16);
  }
  load(0, 0);
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * L, nt = min(L, T - t0);
    if (S::NST == 1 && c > 0) load(c, 0);  // the previous chunk is done
    if (S::NST == 2 && c + 1 < nch) {
      load(c + 1, (c + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const unsigned char* const st =
        smem + (S::NST == 2 ? (c & 1) : 0) * S::STAGE;
    const In* const Qs = reinterpret_cast<const In*>(st);
    const In* const Ks = reinterpret_cast<const In*>(st + S::K_OFF);
    const In* const Vs = reinterpret_cast<const In*>(st + S::V_OFF);

    // gates: log-sigmoids in parallel over the steps, then the max-plus
    // recurrence of m on one lane, then the decays and weights. Warp 0's
    // lanes hold the chunk's f and i, loaded during the previous chunk,
    // and load the next chunk's now.
    if (warp == 0) {
      if (lane < nt) {
        lfs[lane] = log_sigmoid(f_next);
        ivs[lane] = i_next;
      }
      if (t0 + L + lane < T) {
        const size_t gi = ((size_t)b * T + t0 + L + lane) * H + hd;
        f_next = ld_gate(f_pre, gi, g_bf16);
        i_next = ld_gate(i_pre, gi, g_bf16);
      }
      __syncwarp();
      if (lane == 0) {
        float mm = m_c, F = 0.f;
        for (int s = 0; s < nt; ++s) {
          mm = fmaxf(lfs[s] + mm, ivs[s]);
          F += lfs[s];
          mts[s] = mm;
          Fts[s] = F;
        }
      }
      __syncwarp();
      float a = 0.f, bb = 0.f, de = 0.f, w = 0.f;
      if (lane < nt) {
        const float F = Fts[lane], mt = mts[lane];
        a = F - mt;
        bb = F - ivs[lane];
        de = expf(F + m_c - mt);  // 0 from a fresh state (m_c = -inf)
        w = expf(Fts[nt - 1] - F + ivs[lane] - mts[nt - 1]);
      }
      as[lane] = a;
      bs[lane] = bb;
      dec[lane] = de;
      wst[lane] = w;
    }
    __syncthreads();  // the stage has landed; the gates are ready

    // S = Q K^T: warp -> one live 16 x 8 tile of the causal 32 x 32 and
    // one half of dk; two interleaved partial sums
    {
      const int tile = warp % 6, half = warp / 6;
      const int ms = tile < 2 ? 0 : 1, nsb = tile < 2 ? tile : tile - 2;
      const int kbh = dkp / 16;  // 8-row blocks a half (even)
      const In* const qa = Qs + (16 * ms + g) * SQ + 2 * t + 8 * half * kbh;
      const In* const ka = Ks + (8 * nsb + g) * SQ + 2 * t + 8 * half * kbh;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int j = 0; j < kbh; j += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          // the k index of each 8-block permuted: k = t is column 2 t,
          // k = t + 4 is 2 t + 1, in both operands
          const float2 q0 = ld2(qa + 8 * (j + u));
          const float2 q1 = ld2(qa + 8 * SQ + 8 * (j + u));
          const float2 k0 = ld2(ka + 8 * (j + u));
          const float av[4] = {q0.x, q1.x, q0.y, q1.y};
          const float bv[2] = {k0.x, k0.y};
          uint32_t ah[4], al[4], bhi[2], blo[2];
          to_tf32<4, EXACT>(av, ah, al);
          to_tf32<2, EXACT>(bv, bhi, blo);
          mma3<!EXACT, !EXACT>(acc[u], ah, al, bhi, blo);
        }
      }
      float* const sp = Sp + half * L * SS + (16 * ms + g) * SS + 8 * nsb +
                        2 * t;
      *reinterpret_cast<float2*>(sp) =
          make_float2(acc[0][0] + acc[1][0], acc[0][1] + acc[1][1]);
      *reinterpret_cast<float2*>(sp + 8 * SS) =
          make_float2(acc[0][2] + acc[1][2], acc[0][3] + acc[1][3]);
    }
    __syncthreads();

    // P = S qscale w (causal), and n_t . q_t: a warp a row
    for (int r = warp; r < L; r += WARPS) {
      float p = 0.f, qn = 0.f;
      if (r < nt) {
        if (lane <= r)
          p = (Sp[r * SS + lane] + Sp[(L + r) * SS + lane]) * qscale *
              expf(as[r] - bs[lane]);
        for (int d = lane; d < dk; d += 32)
          qn = fmaf(to_f(Qs[r * SQ + d]), ns[d], qn);
      }
      Ps[r * SPP + lane] = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o);
        qn += __shfl_xor_sync(0xffffffffu, qn, o);
      }
      if (lane == 0) nqs[r] = qn * qscale * dec[r] + p;
    }
    __syncthreads();

    // num^T (the tile's 16 columns x 32 steps) over the warp's quarter:
    // C^T Q^T with C's accumulator tiles as A, then V^T P^T
    {
      float num[4][4];
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8)
#pragma unroll
        for (int e = 0; e < 4; ++e) num[s8][e] = 0.f;
      const In* const qq = Qs + g * SQ + dbase + 2 * t;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        if (j < nqb) {
          const float av[4] = {cacc[j][0], cacc[j][2], cacc[j][1],
                               cacc[j][3]};
          uint32_t ah[4], al[4];
          to_tf32<4, false>(av, ah, al);
#pragma unroll
          for (int s8 = 0; s8 < 4; ++s8) {
            const float2 qv = ld2(qq + 8 * s8 * SQ + 8 * j);
            const float bv[2] = {qv.x, qv.y};
            uint32_t bhi[2], blo[2];
            to_tf32<2, EXACT>(bv, bhi, blo);
            mma3<true, !EXACT>(num[s8], ah, al, bhi, blo);
          }
        }
      }
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          num[s8][e] *= qscale * dec[8 * s8 + 2 * t + (e & 1)];
      {
        const In* const vv = Vs + (8 * dq + t) * SV + 16 * cm + g;
        const float av[4] = {to_f(vv[0]), to_f(vv[8]), to_f(vv[4 * SV]),
                             to_f(vv[4 * SV + 8])};
        uint32_t ah[4], al[4];
        to_tf32<4, EXACT>(av, ah, al);
#pragma unroll
        for (int s8 = 0; s8 < 4; ++s8) {
          const float* const pp = Ps + (8 * s8 + g) * SPP + 8 * dq + t;
          const float bv[2] = {pp[0], pp[4]};
          uint32_t bhi[2], blo[2];
          to_tf32<2, false>(bv, bhi, blo);
          mma3<!EXACT, true>(num[s8], ah, al, bhi, blo);
        }
      }
      float* const rd = red + (dq * NT + 16 * cm + g) * SS + 2 * t;
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8) {
        *reinterpret_cast<float2*>(rd + 8 * s8) =
            make_float2(num[s8][0], num[s8][1]);
        *reinterpret_cast<float2*>(rd + 8 * SS + 8 * s8) =
            make_float2(num[s8][2], num[s8][3]);
      }
    }

    // the state: C^T <- d_e C^T + (w V)^T K, into the accumulators
    {
      const float de = dec[nt - 1];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cacc[j][e] *= de;
#pragma unroll
      for (int s8 = 0; s8 < L / 8; ++s8) {
        const In* const vv = Vs + (8 * s8 + t) * SV + 16 * cm + g;
        const float w0 = wst[8 * s8 + t], w1 = wst[8 * s8 + t + 4];
        const float av[4] = {w0 * to_f(vv[0]), w0 * to_f(vv[8]),
                             w1 * to_f(vv[4 * SV]), w1 * to_f(vv[4 * SV + 8])};
        uint32_t ah[4], al[4];
        to_tf32<4, false>(av, ah, al);
        const In* const kk = Ks + (8 * s8 + t) * SQ + dbase + g;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          if (j < nqb) {
            const float bv[2] = {to_f(kk[8 * j]), to_f(kk[4 * SQ + 8 * j])};
            uint32_t bhi[2], blo[2];
            to_tf32<2, EXACT>(bv, bhi, blo);
            mma3<true, !EXACT>(cacc[j], ah, al, bhi, blo);
          }
        }
      }
    }
    __syncthreads();  // every quarter's num^T is in red

    for (int i = tid; i < L * NT; i += THREADS) {
      const int s = i / NT, cc = i % NT;
      if (s < nt && cc < live_cols) {
        const float* const rr = red + cc * SS + s;
        const float num = rr[0] + rr[NT * SS] + rr[2 * NT * SS] +
                          rr[3 * NT * SS];
        const float den = fmaxf(fabsf(nqs[s]), expf(-mts[s]));
        store(h + (((size_t)b * T + t0 + s) * H + hd) * dv + c0 + cc,
              num / den);
      }
    }
    {
      const float de = dec[nt - 1];
      for (int d = tid; d < dk; d += THREADS) {
        float acc = de * ns[d];
        for (int s = 0; s < nt; ++s)
          acc = fmaf(wst[s], to_f(Ks[s * SQ + d]), acc);
        ns[d] = acc;
      }
    }
    m_c = mts[nt - 1];
    __syncthreads();  // the stage, red and the gates are free again
  }

#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dbase + 8 * j + 2 * t + (e & 1);
      const int col = c0 + 16 * cm + g + 8 * (e >> 1);
      if (j < nqb && d < dk && col < dv) Cb[(size_t)d * dv + col] = cacc[j][e];
    }
  // n and m: every block of this (batch, head) read them at its start;
  // the last one to arrive here writes them and resets the counter
  if (tid == 0) last = atomicAdd(&arrivals[bh], 1u) == gridDim.y - 1;
  __syncthreads();
  if (last) {
    for (int d = tid; d < dk; d += THREADS) n[(size_t)bh * dk + d] = ns[d];
    if (tid == 0) {
      m[bh] = m_c;
      arrivals[bh] = 0u;
    }
  }
}

constexpr int STEP_THREADS = 384;
constexpr int MAX_CLUSTER = 8;
constexpr int RMAX = 12;  // rows of C a thread holds at once (48 / 4)

// one decode step: grid (cs, B H), clusters of cs along x; W columns a
// thread (4: 16-byte loads of C; 1 where dv is not a multiple of 4)
template <typename In, int W>
__global__ void __launch_bounds__(STEP_THREADS, 2)
    mlstm_step_fwd(const In* __restrict__ q, const In* __restrict__ k,
                   const In* __restrict__ v, const void* __restrict__ i_pre,
                   const void* __restrict__ f_pre, float* __restrict__ C,
                   float* __restrict__ n, float* __restrict__ m,
                   In* __restrict__ h, int dk, int dv, float qscale,
                   int g_bf16) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  __shared__ float red[STEP_THREADS * W];  // row groups' partial C^T q
  // every rank's partials of this block's share of columns, and of n . q,
  // written by the ranks themselves
  __shared__ float part[MAX_CLUSTER][MAX_D];
  __shared__ float nqp[MAX_CLUSTER];
  __shared__ float wsum[STEP_THREADS / 32];
  const int tid = threadIdx.x, bh = blockIdx.y;

  const int rpb = (dk + cs - 1) / cs, r0 = rank * rpb;
  const int r1 = min(dk, r0 + rpb);
  const int ncu = (dv + W - 1) / W, rgs = STEP_THREADS / ncu;
  const int cu = tid % ncu, rg = tid / ncu;
  const bool active = rg < rgs;
  const In* const qb = q + (size_t)bh * dk;
  const In* const kb = k + (size_t)bh * dk;
  float* const Cb = C + (size_t)bh * dk * dv + W * cu;
  // this thread's first RMAX rows of C, in flight before the gates' loads
  // are waited for
  float cr[RMAX][W];
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    const int d = r0 + rg + i * rgs;
    if (active && d < r1) {
      const float* const p = Cb + (size_t)d * dv;
      if constexpr (W == 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(p);
        cr[i][0] = c4.x;
        cr[i][1] = c4.y;
        cr[i][2] = c4.z;
        cr[i][3] = c4.w;
      } else {
        cr[i][0] = *p;
      }
    }
  }
  const float lf = log_sigmoid(ld_gate(f_pre, bh, g_bf16));
  const float ii = ld_gate(i_pre, bh, g_bf16), m0 = m[bh];
  const float mn = fmaxf(lf + m0, ii);
  const float fg = expf(lf + m0 - mn), ig = expf(ii - mn);

  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  if (active) {
    float vv[W];
#pragma unroll
    for (int e = 0; e < W; ++e) vv[e] = to_f(v[(size_t)bh * dv + W * cu + e]);
    for (int d0 = r0 + rg; d0 < r1; d0 += RMAX * rgs) {
      if (d0 != r0 + rg) {  // a later round (more than RMAX rows a thread)
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          const int d = d0 + i * rgs;
          if (d < r1) {
            const float* const p = Cb + (size_t)d * dv;
#pragma unroll
            for (int e = 0; e < W; ++e) cr[i][e] = p[e];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RMAX; ++i) {
        const int d = d0 + i * rgs;
        if (d < r1) {
          const float kd = ig * to_f(kb[d]), qd = qscale * to_f(qb[d]);
#pragma unroll
          for (int e = 0; e < W; ++e) {
            cr[i][e] = fmaf(fg, cr[i][e], kd * vv[e]);
            acc[e] = fmaf(qd, cr[i][e], acc[e]);
          }
          float* const p = Cb + (size_t)d * dv;
          if constexpr (W == 4)
            *reinterpret_cast<float4*>(p) =
                make_float4(cr[i][0], cr[i][1], cr[i][2], cr[i][3]);
          else
            *p = cr[i][0];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < W; ++e) red[tid * W + e] = acc[e];
  float nq = 0.f;
  for (int d = r0 + tid; d < r1; d += STEP_THREADS) {
    const float nn = fmaf(fg, n[(size_t)bh * dk + d], ig * to_f(kb[d]));
    n[(size_t)bh * dk + d] = nn;
    nq = fmaf(qscale * to_f(qb[d]), nn, nq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) nq += __shfl_xor_sync(0xffffffffu, nq, o);
  if ((tid & 31) == 0) wsum[tid >> 5] = nq;
  __syncthreads();
  // this block's partial of each column, pushed to the rank that owns the
  // column (cpb columns a rank), and its n . q to every rank
  const int cpb = (dv + cs - 1) / cs;
  for (int col = tid; col < dv; col += STEP_THREADS) {
    const int cu_ = col / W, e = col % W;
    float s = 0.f;
    for (int r = 0; r < rgs; ++r) s += red[(r * ncu + cu_) * W + e];
    cluster.map_shared_rank(&part[0][0], col / cpb)[rank * MAX_D +
                                                     col % cpb] = s;
  }
  if (tid < cs) {
    float s = 0.f;
    for (int w = 0; w < STEP_THREADS / 32; ++w) s += wsum[w];
    cluster.map_shared_rank(nqp, tid)[rank] = s;
  }
  cluster.sync();  // every push has landed; m was read by every block
  float nqt = 0.f;
  for (int r = 0; r < cs; ++r) nqt += nqp[r];
  const float den = fmaxf(fabsf(nqt), expf(-mn));
  for (int c = tid; c < cpb && rank * cpb + c < dv; c += STEP_THREADS) {
    float s = 0.f;
    for (int r = 0; r < cs; ++r) s += part[r][c];
    store(h + (size_t)bh * dv + rank * cpb + c, s / den);
  }
  if (rank == 0 && tid == 0) m[bh] = mn;
}

template <typename In>
int launch_chunk(const void* q, const void* k, const void* v,
                 const void* i_pre, const void* f_pre, float* C, float* n,
                 float* m, void* h, unsigned int* arrivals, int B, int T,
                 int H, int dk, int dv, float qscale, int g_bf16, int vec_qk,
                 int vec_v, cudaStream_t s) {
  static unsigned int smem_set = 0;
  cudaError_t err = set_smem_once((const void*)mlstm_chunk_fwd<In>,
                                  Smem<In>::BYTES, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (dv + NT - 1) / NT);
  mlstm_chunk_fwd<In><<<grid, THREADS, Smem<In>::BYTES, s>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), i_pre, f_pre, C, n, m, static_cast<In*>(h),
      arrivals, T, H, dk, dv, qscale, g_bf16, vec_qk, vec_v);
  return (int)cudaGetLastError();
}

template <typename In, int W>
int launch_step(const void* q, const void* k, const void* v,
                const void* i_pre, const void* f_pre, float* C, float* n,
                float* m, void* h, int B, int H, int dk, int dv, float qscale,
                int g_bf16, int cs, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, B * H, 1);
  cfg.blockDim = dim3(STEP_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, mlstm_step_fwd<In, W>, static_cast<const In*>(q),
      static_cast<const In*>(k), static_cast<const In*>(v), i_pre, f_pre, C,
      n, m, static_cast<In*>(h), dk, dv, qscale, g_bf16);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The chunkwise route (T >= 1; the wrapper sends T > 1). q, k: (B, T, H,
// dk); v, h: (B, T, H, dv), one dtype (x_bf16 = 1 for bfloat16, 0 for
// float32); i_pre, f_pre: (B, T, H) (g_bf16 likewise); C: (B, H, dk,
// dv), n: (B, H, dk), m: (B, H) float32, read and overwritten; arrivals:
// B * H zeroed unsigned ints (left zeroed). All contiguous, on the device
// of `stream`. vec_qk / vec_v: the rows of q and k / of v are 16-byte
// aligned (copied with cp.async). dk, dv <= 384. Returns 0, a
// cudaError_t, or -1 for an unsupported dk or dv.
int mlstm_chunk_forward(const void* q, const void* k, const void* v,
                        const void* i_pre, const void* f_pre, void* C,
                        void* n, void* m, void* h, void* arrivals, int B,
                        int T, int H, int dk, int dv, float qscale,
                        int x_bf16, int g_bf16, int vec_qk, int vec_v,
                        void* stream) {
  if (dk < 1 || dk > MAX_D || dv < 1 || dv > MAX_D) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *Cf = static_cast<float*>(C), *nf = static_cast<float*>(n),
        *mf = static_cast<float*>(m);
  unsigned int* arr = static_cast<unsigned int*>(arrivals);
  if (x_bf16)
    return launch_chunk<__nv_bfloat16>(q, k, v, i_pre, f_pre, Cf, nf, mf, h,
                                       arr, B, T, H, dk, dv, qscale, g_bf16,
                                       vec_qk, vec_v, s);
  return launch_chunk<float>(q, k, v, i_pre, f_pre, Cf, nf, mf, h, arr, B, T,
                             H, dk, dv, qscale, g_bf16, vec_qk, vec_v, s);
}

// The recurrent route: one step (T = 1), the same layouts with T = 1.
// `cluster` (1-8) blocks split dk; vec: dv is a multiple of 4 and C, v
// are aligned for 4-column loads. Returns 0, a cudaError_t, or -1.
int mlstm_step_forward(const void* q, const void* k, const void* v,
                       const void* i_pre, const void* f_pre, void* C,
                       void* n, void* m, void* h, int B, int H, int dk,
                       int dv, float qscale, int x_bf16, int g_bf16,
                       int cluster, int vec, void* stream) {
  if (dk < 1 || dk > MAX_D || dv < 1 || dv > MAX_D || cluster < 1 ||
      cluster > MAX_CLUSTER || (vec && dv % 4))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *Cf = static_cast<float*>(C), *nf = static_cast<float*>(n),
        *mf = static_cast<float*>(m);
  if (x_bf16)
    return vec ? launch_step<__nv_bfloat16, 4>(q, k, v, i_pre, f_pre, Cf, nf,
                                               mf, h, B, H, dk, dv, qscale,
                                               g_bf16, cluster, s)
               : launch_step<__nv_bfloat16, 1>(q, k, v, i_pre, f_pre, Cf, nf,
                                               mf, h, B, H, dk, dv, qscale,
                                               g_bf16, cluster, s);
  return vec ? launch_step<float, 4>(q, k, v, i_pre, f_pre, Cf, nf, mf, h, B,
                                     H, dk, dv, qscale, g_bf16, cluster, s)
             : launch_step<float, 1>(q, k, v, i_pre, f_pre, Cf, nf, mf, h, B,
                                     H, dk, dv, qscale, g_bf16, cluster, s);
}

const char* mlstm_chunk_error_string(int err) {
  return err < 0 ? "unsupported shape (dk, dv must be 1..384; cluster 1..8)"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
