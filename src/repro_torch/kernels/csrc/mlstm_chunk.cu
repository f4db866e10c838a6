// mLSTM recurrence for Hopper (sm_90a): stabilised exponential gating
// over a (dk, dv) matrix memory, CUDA-core version, with the state read
// from and written back to device memory.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_chunk.py:mlstm_chunk
// (body _mlstm_kernel). Same function, per (batch, head) and step t:
//   m' = max(log_sigmoid(f_t) + m, i_t)
//   fg = exp(log_sigmoid(f_t) + m - m'),  ig = exp(i_t - m')
//   C  = fg C + ig k_t v_t^T,  n = fg n + ig k_t
//   h_t = C^T q_t / max(|n . q_t|, exp(-m')),  q_t scaled by dk^-1/2
// in fp32, with q, k, v in float32 or bfloat16 and h in v's dtype. The
// TPU kernel starts from a zero state (m = -1e30) and returns h only;
// this one reads the initial C, n, m and writes the final ones in place,
// as the served model needs. From C = n = 0 and m = -inf the first step
// gives fg = exp(-inf) = 0 and ig = 1, with no NaN.
//
// Design. The TPU kernel keeps the whole (dk, dv) C of one (batch, head)
// in VMEM; at dk = dv = 384 that is 576 KB of fp32, more than the 227 KB
// of shared memory a Hopper block has. The columns of C are independent
// given n and m, so the grid is (batch * head, ceil(dv / 64)): a block
// owns a 64-column tile of C in registers (thread = column x one of 4
// contiguous row groups of RPT = 96 rows, zero-padded past dk; 96 KB of
// fp32 at dk = 384 over 256
// threads) and recomputes n (dk floats, held two a thread) and m. Each
// chunk of 8 steps stages q (pre-scaled) and k as fp32 rows in shared
// memory, which every thread reads as 16-byte broadcasts, and v's tile
// columns; thread 0 runs the scalar m recurrence for the chunk. A step is
// a register update of the tile, a partial C^T q per row group and a
// partial n . q per warp, one barrier, and the 64 threads of row group 0
// sum the partials and store h. The partial buffers alternate between two
// halves, so a step needs one barrier. The C tile goes back to device
// memory at the end; n and m are written by the last block of the (batch,
// head) to finish (an arrival counter per (batch, head), reset by that
// block), after every block has read the initial ones.
//
// Bound on an H100 SXM: a step and head needs 5 dk dv + 5 dk + 2 dv fp32
// operations (an FMA counted as two): per element of C a multiply by
// ig v_e and an FMA for the update and an FMA for C^T q; per row of n an
// FMA and a multiply for the update and an FMA for n . q; per column ig v
// and the division. At the served prefill (B 4, T 512, H 4, dk = dv =
// 384) that is 6.06 GFLOP, 0.090 ms at 67 TFLOP/s; its bytes (q, k, v
// and h in bf16, C in and out) take ~13 us at 3.35 TB/s. At a decode
// step (T 1) the bytes of C, read and written (18.9 MB at B 4), bound it
// at ~5.6 us.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/mlstm_chunk.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // 8 warps
constexpr int TILE = 64;                // columns of C per block
constexpr int GROUPS = THREADS / TILE;  // row groups
constexpr int WARPS = THREADS / 32;
constexpr int CH = 8;                   // steps staged per chunk
constexpr int RPT = 96;                 // rows of C a thread
constexpr int KP = GROUPS * RPT;        // dk, padded: dk <= 384
constexpr int NPT = (KP + THREADS - 1) / THREADS;  // n entries a thread

__device__ __forceinline__ float ld(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(THREADS)
    mlstm_fwd(const void* __restrict__ q, const void* __restrict__ k,
              const void* __restrict__ v, const void* __restrict__ i_pre,
              const void* __restrict__ f_pre, float* __restrict__ C,
              float* __restrict__ n, float* __restrict__ m,
              void* __restrict__ h, unsigned int* __restrict__ arrivals,
              int T, int H, int dk, int dv, float qscale, int q_bf16,
              int k_bf16, int v_bf16, int g_bf16) {
  __shared__ __align__(16) float qs[CH][KP];
  __shared__ __align__(16) float ks[CH][KP];
  __shared__ float vs[CH][TILE];
  __shared__ float fgs[CH], igs[CH], mts[CH];
  __shared__ float nump[2][GROUPS][TILE];
  __shared__ float qnp[2][WARPS];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % TILE, grp = tid / TILE, row0 = grp * RPT;
  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int e = blockIdx.y * TILE + col;
  const bool live = e < dv;

  float* Cb = C + (size_t)bh * dk * dv;
  float cr[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int d = row0 + r;
    cr[r] = (live && d < dk) ? Cb[(size_t)d * dv + e] : 0.f;
  }
  float nr[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int d = tid + j * THREADS;
    nr[j] = d < dk ? n[(size_t)bh * dk + d] : 0.f;
  }
  float mrun = m[bh];  // carried by thread 0

  int half = 0;
  for (int t0 = 0; t0 < T; t0 += CH) {
    const int nt = min(CH, T - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < CH * KP; i += THREADS) {
      const int s = i / KP, d = i % KP;
      float qv = 0.f, kv = 0.f;
      if (s < nt && d < dk) {
        const size_t off = (((size_t)b * T + t0 + s) * H + hd) * dk + d;
        qv = ld(q, off, q_bf16) * qscale;
        kv = ld(k, off, k_bf16);
      }
      qs[s][d] = qv;
      ks[s][d] = kv;
    }
    for (int i = tid; i < CH * TILE; i += THREADS) {
      const int s = i / TILE, c = i % TILE;
      const int ee = blockIdx.y * TILE + c;
      vs[s][c] = (s < nt && ee < dv)
                     ? ld(v, (((size_t)b * T + t0 + s) * H + hd) * dv + ee,
                          v_bf16)
                     : 0.f;
    }
    if (tid == 0) {
      for (int s = 0; s < nt; ++s) {
        const size_t g = ((size_t)b * T + t0 + s) * H + hd;
        const float lf = log_sigmoid(ld(f_pre, g, g_bf16));
        const float ii = ld(i_pre, g, g_bf16);
        const float mn = fmaxf(lf + mrun, ii);
        fgs[s] = expf(lf + mrun - mn);
        igs[s] = expf(ii - mn);
        mts[s] = mn;
        mrun = mn;
      }
    }
    __syncthreads();
    for (int s = 0; s < nt; ++s) {
      const float fg = fgs[s], ig = igs[s];
      const float igv = ig * vs[s][col];
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < RPT; r += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[s][row0 + r]);
        const float4 qq = *reinterpret_cast<const float4*>(&qs[s][row0 + r]);
        cr[r] = fmaf(fg, cr[r], igv * kk.x);
        cr[r + 1] = fmaf(fg, cr[r + 1], igv * kk.y);
        cr[r + 2] = fmaf(fg, cr[r + 2], igv * kk.z);
        cr[r + 3] = fmaf(fg, cr[r + 3], igv * kk.w);
        acc = fmaf(qq.x, cr[r], acc);
        acc = fmaf(qq.y, cr[r + 1], acc);
        acc = fmaf(qq.z, cr[r + 2], acc);
        acc = fmaf(qq.w, cr[r + 3], acc);
      }
      nump[half][grp][col] = acc;
      float qn = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int d = tid + j * THREADS;
        if (d < KP) {
          nr[j] = fmaf(fg, nr[j], ig * ks[s][d]);
          qn = fmaf(qs[s][d], nr[j], qn);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        qn += __shfl_xor_sync(0xffffffffu, qn, off);
      if (lane == 0) qnp[half][warp] = qn;
      __syncthreads();
      if (grp == 0 && live) {
        float num = 0.f, qnt = 0.f;
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) num += nump[half][g][col];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) qnt += qnp[half][w];
        const float den = fmaxf(fabsf(qnt), expf(-mts[s]));
        st(h, (((size_t)b * T + t0 + s) * H + hd) * dv + e, num / den,
           v_bf16);
      }
      half ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int d = row0 + r;
    if (live && d < dk) Cb[(size_t)d * dv + e] = cr[r];
  }
  // n and m: every block of this (batch, head) read them at its start;
  // the last one to arrive here writes them and resets the counter
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&arrivals[bh], 1u) == gridDim.y - 1;
  __syncthreads();
  if (last) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int d = tid + j * THREADS;
      if (d < dk) n[(size_t)bh * dk + d] = nr[j];
    }
    if (tid == 0) {
      m[bh] = mrun;
      arrivals[bh] = 0u;
    }
  }
}

}  // namespace

extern "C" {

// q, k: (B, T, H, dk); v, h: (B, T, H, dv); i_pre, f_pre: (B, T, H);
// C: (B, H, dk, dv), n: (B, H, dk), m: (B, H) float32, read and
// overwritten; arrivals: B * H zeroed unsigned ints (left zeroed). All
// contiguous, on the device of `stream`. *_bf16 = 1 for bfloat16, 0 for
// float32; h takes v's. dk <= 384. Returns 0, a cudaError_t, or -1 for
// an unsupported dk.
int mlstm_chunk_forward(const void* q, const void* k, const void* v,
                        const void* i_pre, const void* f_pre, void* C,
                        void* n, void* m, void* h, void* arrivals, int B,
                        int T, int H, int dk, int dv, float qscale,
                        int q_bf16, int k_bf16, int v_bf16, int g_bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *Cf = static_cast<float*>(C), *nf = static_cast<float*>(n),
        *mf = static_cast<float*>(m);
  unsigned int* arr = static_cast<unsigned int*>(arrivals);
  if (dk < 1 || dk > KP || dv < 1) return -1;
  const dim3 grid(B * H, (dv + TILE - 1) / TILE);
  mlstm_fwd<<<grid, THREADS, 0, s>>>(q, k, v, i_pre, f_pre, Cf, nf, mf, h,
                                     arr, T, H, dk, dv, qscale, q_bf16,
                                     k_bf16, v_bf16, g_bf16);
  return (int)cudaGetLastError();
}

const char* mlstm_chunk_error_string(int err) {
  return err < 0 ? "unsupported head dim (dk must be 1..384)"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
