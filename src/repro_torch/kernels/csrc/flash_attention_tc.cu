// Flash attention forward for Hopper (sm_90a), bfloat16 on tensor cores:
// wgmma fed by TMA, one producer and two consumer warpgroups.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel) for bfloat16 q, k, v at head dims
// 64 and 128, every call of the LM prefill path (Yi-9B, Jamba); float32
// and bf16 at head dims 16 and 32 keep the CUDA-core kernel of
// flash_attention.cu. Same function: scores Q K^T in fp32 scaled by
// 1/sqrt(D), the same-position causal mask (row >= col from position 0),
// a kv_len bound that masks K/V rows at or past it, GQA (query head h
// reads KV head h / G), online softmax in fp32 with an fp32 accumulator,
// output acc / max(l, 1e-30) in bfloat16. A query offset q_off places
// query row r at absolute position q_off + r against keys 0..kv_len-1
// (a prompt chunk written into a KV cache at cache_index = q_off, with
// kv_len = q_off + Sq); the causal mask is then col > q_off + row, and
// q_off = 0 is the same-position mask of the TPU kernel. A query-position
// tensor qpos (int32 (B, Sq), optional) places row r of sequence b at
// qpos[b, r] instead: the JAX package's mask (key <= the query's position:
// M-RoPE's t axis, or the positions a forward is given), which differs from
// the slots on an image prompt whose patches all sit at t = 0. Each query
// tile's key end is then its rows' largest position + 1, found before the
// flash kernel by a small one (tile_ends: a warp a tile reads its 128
// positions and reduces them), so the producer and the consumers read one
// int a tile and the producer keeps its single-lane loop; a tile whose rows
// all sit at t = 0 loads exactly one K/V tile, and every tile at least
// one, which holds key 0. A thread masks a K/V tile once it reaches past
// its own rows' positions. The kernel is compiled twice (POS): without a
// position tensor it is the offset kernel as it was (the same tests at
// run time in one kernel made that route 13-16 % slower on the H100,
// scripts/flash_times_torch.py).
//
// The one numerical difference from the TPU kernel: that kernel
// multiplies P in fp32 by V widened to fp32; here P, computed in fp32,
// is rounded to bfloat16 (8 bits of mantissa) as the register A operand
// of the P V product, since wgmma takes no fp32 A. Q K^T loses nothing (a
// product of two bf16 values is exact in the fp32 accumulator), l sums
// the unrounded fp32 P, and the output is rounded to bfloat16 anyway.
//
// Design. A work item is BQ = 128 query rows of one (batch, head); a
// persistent grid of one block per SM walks the items, those of a causal
// call longest first, so the causal triangle's tiles spread evenly over
// the SMs. Warpgroup 2 is the producer: one lane loads each item's Q
// tile (two Q buffers, so the next item's Q and first K/V tiles load
// while the consumers finish this one) and streams K and V tiles of BK =
// 128 rows through two rings of NSTAGE = 2 stages, each a TMA tile
// (cp.async.bulk.tensor, 128-byte swizzle) completing on its own
// mbarrier; a K (V, Q) stage is refilled once both consumers have
// arrived on its "empty" barrier, so K_{j+2} loads as soon as
// S_j = Q K_j^T is done, and a Q buffer once the item's output has left
// through it. The producer warpgroup gives its registers to
// the consumers (setmaxnreg 24 / 240), which hold S, P and O at once.
// The tensor maps are 4-D over (D, heads, S, B), box (64, 1, 128, 1):
// one head's rows straight from the (B, S, H, D) layout, no transpose
// copy, rows past S zero-filled; D = 128 is two 64-column boxes, as a
// 128-byte swizzle takes at most 128 bytes a row. Warpgroups 0 and 1 own
// query rows 0-63 and 64-127 of the tile. For K/V tile j a consumer
// issues S_j = Q K_j^T (wgmma m64n128k16, Q and K K-major in shared
// memory) and O += P_{j-1} V_{j-1} (wgmma m64nDk16, P from registers,
// the accumulator layout of S being the A-fragment layout; V in the
// transposed, MN-major, layout), waits for S_j only, and runs tile j's
// online softmax on the special-function units while the P V product is
// still on the tensor cores; then it rescales O and turns S_j into P_j.
// The causal mask runs only on tiles that reach past the diagonal, the
// kv_len mask only on the tile that holds kv_len; tiles wholly above the
// diagonal are never loaded. O / l is written into the warpgroup's rows
// of its Q buffer and leaves as 16-byte row-contiguous stores (straight
// from the accumulator layout, each warp store would touch 8 rows 4
// bytes at a time); the ragged Sq edge is masked at the store.
// The tensor maps are built on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda), cached while
// pointer and shape repeat, and passed as __grid_constant__ parameters.
//
// Bound on an H100 SXM at the LM prefill shape (q (4, 512, 32, 128), k/v
// (4, 512, 4, 128), causal): 37.7 MB of q, k, v and o, 11.3 us at 3.35
// TB/s; 8.6 GFLOP of the causal half at 989 TFLOP/s, 8.7 us. So bytes
// bound it.
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int BQ = 128;       // query rows a block (2 warpgroups x 64)
constexpr int BK = 128;       // key rows a tile
constexpr int NSTAGE = 2;     // K/V ring
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int ATOM = 64;      // bf16 columns in a 128-byte swizzle row
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tc {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int OFF_K = 2 * Q_BYTES;  // Q is double-buffered
  static constexpr int OFF_V = OFF_K + NSTAGE * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + NSTAGE * KV_BYTES;
  // barriers: q_full[2], q_empty[2], k_full, v_full, k_empty, v_empty
  // [NSTAGE] each; then slack to align the base to 1024 bytes
  static constexpr int SMEM = OFF_BAR + 8 * (4 + 4 * NSTAGE) + 1024;
};

// named barrier `id` (0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (its asm outputs are written later by the
// hardware than the compiler assumes)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo/sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) + (accumulate ? d : 0):
// A and B bf16 in shared memory (descriptors), B K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) B (16 x 128): B bf16
// in shared memory (descriptor), MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64): B bf16
// in shared memory (descriptor), MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ends[b * n_qt + t] = 1 + the largest position among query rows
// t * BQ .. t * BQ + BQ - 1 (those below Sq) of sequence b, at least 1:
// one warp a query tile, 4 rows a lane
__global__ void tile_ends(const int* __restrict__ qpos, int* __restrict__ ends,
                          int B, int Sq, int n_qt) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= B * n_qt) return;  // w is the same for the whole warp
  const int b = w / n_qt, q0 = (w % n_qt) * BQ;
  int m = 0;
  for (int r = q0 + (threadIdx.x & 31); r < min(q0 + BQ, Sq); r += 32)
    m = max(m, __ldg(qpos + (size_t)b * Sq + r));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) ends[w] = m + 1;
}

// a persistent block walks query tiles (batch, head, 128 rows); see the
// note above. POS: rows at qpos[b, row] with key ends `ends` (else at
// q_off + row; both pointers unused)
template <int D, bool POS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, int B, int Sq, int H, int KH,
                 int kv_len, int causal, int q_off,
                 const int* __restrict__ qpos,
                 const int* __restrict__ ends, float scale_log2) {
  using C = Tc<D>;
  constexpr int HALVES = D / ATOM;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the 128-byte swizzle repeats every 8 rows of 128 B
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sq = base, sk = base + C::OFF_K, sv = base + C::OFF_V;
  const uint32_t bar = base + C::OFF_BAR;
  auto q_full = [&](int i) { return bar + 8 * i; };
  auto q_empty = [&](int i) { return bar + 8 * (2 + i); };
  auto k_full = [&](int s) { return bar + 8 * (4 + s); };
  auto v_full = [&](int s) { return bar + 8 * (4 + NSTAGE + s); };
  auto k_empty = [&](int s) { return bar + 8 * (4 + 2 * NSTAGE + s); };
  auto v_empty = [&](int s) { return bar + 8 * (4 + 3 * NSTAGE + s); };

  const int tid = threadIdx.x;
  const int n_qt = (Sq + BQ - 1) / BQ, n_items = B * H * n_qt;
  // work item i: the longest query tiles of a causal call come first
  // (by q_off + q0, which for one call is the order of q0); with qpos the
  // tile's key end is its rows' (from `ends`), and it loads at least one tile
  auto item = [&](int i, int& b, int& h, int& q0, int& nk) {
    const int slot = i / (B * H), bh = i % (B * H);
    b = bh / H;
    h = bh % H;
    const int qt = causal ? n_qt - 1 - slot : slot;
    q0 = qt * BQ;
    if constexpr (POS) {
      const int k_end =
          causal ? min(kv_len, __ldg(ends + b * n_qt + qt)) : kv_len;
      nk = max((k_end + BK - 1) / BK, 1);
    } else {
      const int k_end = causal ? min(kv_len, q_off + q0 + BQ) : kv_len;
      nk = (k_end + BK - 1) / BK;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), CONSUMERS * 128);
    }
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS * 128);
      mbar_init(v_empty(s), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // producer: one lane issues every copy, running ahead into the next
    // item (Q double-buffered) while the consumers finish this one; its
    // warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == CONSUMERS * 128) {
      int it = 0, n = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
        int b, h, q0, nk;
        item(i, b, h, q0, nk);
        const int kh = h / (H / KH), qs = n & 1;
        if (n >= 2) mbar_wait(q_empty(qs), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qs), C::Q_BYTES);
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load_4d(sq + qs * C::Q_BYTES + hf * BQ * 128, &tq, q_full(qs),
                      hf * ATOM, h, q0, b);
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % NSTAGE, free = ((it / NSTAGE) & 1) ^ 1;
          if (it >= NSTAGE) mbar_wait(k_empty(s), free);
          mbar_expect_tx(k_full(s), C::KV_BYTES);
          for (int hf = 0; hf < HALVES; ++hf)
            tma_load_4d(sk + s * C::KV_BYTES + hf * BK * 128, &tk, k_full(s),
                        hf * ATOM, kh, j * BK, b);
          if (it >= NSTAGE) mbar_wait(v_empty(s), free);
          mbar_expect_tx(v_full(s), C::KV_BYTES);
          for (int hf = 0; hf < HALVES; ++hf)
            tma_load_4d(sv + s * C::KV_BYTES + hf * BK * 128, &tv, v_full(s),
                        hf * ATOM, kh, j * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows wg * 64 .. wg * 64 + 63 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7, t = tid & 127, lane = t & 31;
  const int r_in = wg * 64 + (t >> 5) * 16 + (lane >> 2);  // row in tile
  const int cq = 2 * (lane & 3);  // column of the thread's first pair
  const size_t q_row = (size_t)H * D;
  int it = 0, n = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    int b, h, q0, nk;
    item(i, b, h, q0, nk);
    const int qs = n & 1;
    // absolute positions of the thread's two rows, for the causal mask
    int row_lo = q_off + q0 + r_in, row_hi = row_lo + 8;
    if constexpr (POS) {
      const int* qp = qpos + (size_t)b * Sq;
      row_lo = __ldg(qp + min(q0 + r_in, Sq - 1));
      row_hi = __ldg(qp + min(q0 + r_in + 8, Sq - 1));
    }
    float acc[D / 2];  // O: 64 x D in wgmma's accumulator layout
#pragma unroll
    for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
    float sc[BK / 2];        // S: 64 x BK
    uint32_t pa[BK / 16][4];  // P (bf16), the A fragments of P V
    mbar_wait(q_full(qs), (n >> 1) & 1);

    // S = Q K_j^T into sc, committed as one group
    auto issue_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the atom
        const uint64_t da =
            desc_sw128(sq + qs * C::Q_BYTES + (kk / 4) * BQ * 128 +
                           wg * 64 * 128 + off,
                       16, 1024);
        const uint64_t db = desc_sw128(
            sk + s * C::KV_BYTES + (kk / 4) * BK * 128 + off, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V_j, committed as one group
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // V: 16 key rows (K) x D columns (N), N contiguous: LBO steps to
        // the next 64 columns, SBO to the next 8 rows
        const uint64_t db = desc_sw128(sv + s * C::KV_BYTES + kk * 16 * 128,
                                       BK * 128, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa[kk], db);
        else
          wgmma_rs_n64(acc, pa[kk], db);
      }
      wgmma_commit();
    };
    // the online softmax of tile j's scores, in log2 units: sc becomes
    // P; returns the factor the accumulator is to be rescaled by
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = j * BK;
      // a tile reaching past the warpgroup's first row (with qpos: past
      // the thread's own rows) is masked
      const bool mask =
          k0 + BK > kv_len ||
          (causal && k0 + BK - 1 > (POS ? min(row_lo, row_hi)
                                        : q_off + q0 + wg * 64));
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int k = 0; k < BK / 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (mask) {
            const int col = k0 + 8 * k + cq + (e & 1);
            const int row = e < 2 ? row_lo : row_hi;
            if (col >= kv_len || (causal && col > row))
              sc[4 * k + e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * k + e]);
        }
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m_r[r] - mu[r]);
        m_r[r] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < BK / 2; ++k) {
        const float p = ex2(fmaf(sc[k], scale_log2, -mu[(k >> 1) & 1]));
        sc[k] = p;
        ps[(k >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ps[r];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // tile 0: S, softmax, P; the accumulator is still zero
    float alpha[2];
    {
      const int s = it % NSTAGE;
      mbar_wait(k_full(s), (it / NSTAGE) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_s(s);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty(s));
      softmax(0, alpha);
      pack_p();
    }
    // tile j: S_j on the tensor cores while P_{j-1} V_{j-1} runs, then
    // this tile's softmax while the P V product finishes
    for (int j = 1; j < nk; ++j) {
      const int s = (it + j) % NSTAGE, sp = (it + j - 1) % NSTAGE;
      mbar_wait(k_full(s), ((it + j) / NSTAGE) & 1);
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_s(s);
      mbar_wait(v_full(sp), ((it + j - 1) / NSTAGE) & 1);
      issue_pv(sp);
      wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
      fence_regs(sc);
      mbar_arrive(k_empty(s));
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(v_empty(sp));
#pragma unroll
      for (int k = 0; k < D / 2; ++k) acc[k] *= alpha[(k >> 1) & 1];
      pack_p();
    }
    {
      const int sp = (it + nk - 1) % NSTAGE;
      mbar_wait(v_full(sp), ((it + nk - 1) / NSTAGE) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(sp);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty(sp));
    }
    it += nk;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    // O / l goes out through this warpgroup's rows of its Q buffer (S,
    // their last reader, is done), in the same 128-byte swizzle, so that
    // each row leaves as 16-byte row-contiguous stores; the Q buffer is
    // released to the producer after that
    unsigned char* const stage =
        smem + qs * C::Q_BYTES + wg * 64 * 128;  // + half * BQ * 128
    auto at = [&](int rr, int cc) {  // row rr, 16-byte chunk cc of D
      return stage + (cc / 8) * BQ * 128 + rr * 128 +
             (((cc % 8) ^ (rr & 7)) << 4);
    };
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r_in - wg * 64 + 8 * r;
      const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
#pragma unroll
      for (int k = 0; k < D / 8; ++k)
        *reinterpret_cast<uint32_t*>(at(rr, k) + 2 * cq) =
            pack_bf16(acc[4 * k + 2 * r] * inv, acc[4 * k + 2 * r + 1] * inv);
    }
    named_sync(1 + wg, 128);
    __nv_bfloat16* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;
    for (int c = t; c < 64 * (D / 8); c += 128) {
      const int rr = c / (D / 8), cc = c % (D / 8);
      const int row = q0 + wg * 64 + rr;
      if (row < Sq)
        *reinterpret_cast<uint4*>(ob + (size_t)row * q_row + cc * 8) =
            *reinterpret_cast<const uint4*>(at(rr, cc));
    }
    // these generic-proxy accesses come before the next TMA into the
    // buffer
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(q_empty(qs));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int kv_len, int causal, int q_off,
           const int* qpos, int* ends, float scale, int sms,
           cudaStream_t stream) {
  static unsigned int smem_set[2] = {0, 0};
  const bool pos = qpos && causal;
  cudaError_t err = set_smem_once(
      pos ? (const void*)flash_fwd_tc<D, true>
          : (const void*)flash_fwd_tc<D, false>,
      Tc<D>::SMEM, &smem_set[pos]);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tensor_map(&mq, q, BF16, 2, ATOM, BQ, D, H, Sq, B) ||
      !tensor_map(&mk, k, BF16, 2, ATOM, BK, D, KH, Sk, B) ||
      !tensor_map(&mv, v, BF16, 2, ATOM, BK, D, KH, Sk, B))
    return -2;
  const int n_qt = (Sq + BQ - 1) / BQ, items = B * H * n_qt;
  if (pos) {
    tile_ends<<<(B * n_qt + 3) / 4, 128, 0, stream>>>(qpos, ends, B, Sq,
                                                       n_qt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = pos ? flash_fwd_tc<D, true> : flash_fwd_tc<D, false>;
  kernel<<<min(items, sms), THREADS, Tc<D>::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), B, Sq, H, KH, kv_len,
      causal, q_off, qpos, pos ? ends : nullptr, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 q: (B, Sq, H, D); k, v: (B, Sk, KH, D); o: (B, Sq, H, D); all
// contiguous, 16-byte aligned, on the device of `stream`; D 64 or 128.
// `q_off` >= 0 is the absolute position of query row 0 (the causal mask
// is col > q_off + row); `qpos`, where not null, int32 (B, Sq) on the
// device, >= 0, each query row's position instead (col > qpos[b, row]),
// and `scratch` then int32 on the device with room for B * Sq values (the
// query tiles' key ends; B * ceil(Sq / 128) are written); `sms` is the
// device's SM count, the most blocks of the persistent grid.
// Returns 0, a cudaError_t, -1 for an unsupported D, or -2 if a tensor
// map could not be encoded.
int flash_attention_tc_forward(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KH,
                               int D, int kv_len, int causal, float scale,
                               int q_off, const void* qpos, void* scratch,
                               int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  int* ends = static_cast<int*>(scratch);
  if (D == 64)
    return launch<64>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal, q_off,
                      qp, ends, scale, sms, s);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal, q_off,
                       qp, ends, scale, sms, s);
  return -1;
}

const char* flash_attention_tc_error_string(int err) {
  if (err == -1) return "unsupported head dim";
  if (err == -2) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
