// Flash attention forward for Hopper (sm_90a), float32 on tensor cores
// at float32 accuracy (3xTF32): TMA loads from a producer warp, mma.sync
// m16n8k8 TF32 products in eight consumer warps.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel) for float32 q, k, v at head dims
// 64 and 128, every call of the diffusion path (the UNet's pixel self-
// and text cross-attention); bf16 at these head dims takes the wgmma
// kernel of flash_attention_tc.cu, and both dtypes at head dims 16 and 32
// the CUDA-core kernel of flash_attention.cu. Same function: scores
// Q K^T in fp32 scaled by 1/sqrt(D), the same-position causal mask (row
// >= col from position 0), a kv_len bound that masks K/V rows at or past
// it, GQA (query head h reads KV head h / G), online softmax in fp32 with
// an fp32 accumulator, output acc / max(l, 1e-30) in float32.
//
// Query positions. The causal mask compares a key's index with its
// query row's position: by default the row itself (MASK_SAME, the TPU
// kernel's mask and every diffusion call's code, as it was); row + q_off
// with a query offset (MASK_OFFSET: a prompt chunk written into a KV cache
// at cache_index = q_off, kv_len = q_off + Sq); or qpos[b, row] with a
// query-position tensor (MASK_POS: int32 (B, Sq), M-RoPE's t axis or the
// positions a forward is given, the JAX package's mask). Each is its own
// instantiation, so the diffusion path's code is unchanged. Under
// MASK_POS a block's key end is its rows' largest position + 1, from the
// tile_ends pre-pass (tile_ends.cuh, shared with the bf16 kernel), and a
// warp's is its own 16 rows' (a shuffle reduction), so a row at t = 0 reads
// one key tile, not the cache.
//
// Numerics. A tensor core reads a float32 register as TF32 (10 bits of
// mantissa) by dropping the low bits. Each operand x is split as hi =
// tf32(x), lo = tf32(x - hi), both rounded explicitly to nearest (the
// bits of cvt.rna.tf32.f32, see tf32_rna in tf32x3.cuh), and each
// product is taken as lo*hi + hi*lo + hi*hi in the fp32 accumulator; the
// dropped lo*lo term is below 2^-22 of |x||y|. Both products are split
// so: Q K^T and P V, P (the fp32 probabilities) included. So the result
// keeps float32 accuracy (the float32 tolerance of 1e-4 stands); plain
// TF32 would not, and the served path switches TF32 off on purpose.
//
// Design. A block is 8 consumer warps and 1 producer warp and takes BQ
// query rows of one (batch, head): QW warps along the query rows (16
// rows each, BQ = 16 QW) times KW key groups, QW KW = 8. Key group kw
// takes the key tiles j with j % KW == kw; at the end the groups' (m, l,
// O) partials are merged through shared memory. KW (2, 4 or 8) comes
// from the wrapper (flash_attention.plan_key_groups), from the shapes
// and the SM count: at the UNet's b = 8 (32 (batch, head) pairs x 256
// rows) KW = 2 gives 128 blocks of 64 rows for 132 SMs; at b = 1 (4
// pairs) KW = 8 gives 64 blocks of 16 rows, where 64-row blocks would
// have given 16. Eight warps, two on each SM sub-partition, because one
// warp alone leaves the tensor pipe waiting on each product's latency.
// One lane of the producer warp loads the block's Q tile and streams K
// and V tiles of BK = 64 / KW rows through a ring of NST = 2 KW stages
// (two for each key group), each a TMA copy (cp.async.bulk.tensor, 4-D
// map over (D, heads, S, B), box (32, 1, rows, 1), 128-byte swizzle: one
// head's rows straight from the (B, S, H, D) layout, rows past S
// zero-filled) completing on its own mbarrier; a stage is refilled once
// its group's warps have arrived on its "empty" barrier.
// The products run on mma.sync.m16n8k8.tf32, not on wgmma. wgmma with
// 32-bit types takes both operands K-major from shared memory (there is
// no transpose bit), so V (D-contiguous, MN-major for P V) would have to
// be rewritten transposed, and K's and V's hi and lo parts written to
// shared memory, every tile; with mma.sync K and V stay in shared memory
// as TMA wrote them and each fragment is split in registers as it is
// loaded. A wgmma version was not built, so there is no measurement of
// one against the other; splitting K and V in shared memory once per key
// group, before the mma.sync products (the step a wgmma version could
// not do without), was built and ran slower than splitting fragments in
// registers (lo buffers and group barriers, and a shallower ring). Q,
// read by every tile of a block, is split once: hi over the TMA tile in
// place, lo beside it. The split itself is two integer operations a half
// (tf32_rna), not cvt.rna.tf32.f32, which takes a slower pipe: a split
// runs for every fragment value and is the kernel's largest cost after
// the products.
// Each thread's fragment loads hit 32 distinct banks under the 128-byte
// swizzle (A and K: 8 rows x 4 columns; V: 4 row pairs x 8 columns). The
// accumulator layout of S (thread t of a quad holds columns 2t and 2t + 1
// of each 8) is used as the A fragment of P V with the keys of each 8
// permuted (logical k = t is key 2t, k = t + 4 is key 2t + 1), so P
// never leaves registers, and V's B fragment reads rows 2t and 2t + 1 to
// match. S is summed over the head dim in SETS interleaved partial sums
// (8 independent m16n8 chains a warp), and each 3xTF32 product is issued
// as three rounds over a warp's tiles, so no product waits on the one
// before it. 8-key blocks at or past the warp's last live key (kv_len;
// the diagonal under the causal mask) are skipped in both products: at
// Sk = 264 the last tile holds 8 live keys.
//
// Shared memory (bytes, D = 128): Q hi and lo 2 x BQ x 128 x 4 (64 KB at
// KW = 2, 16 KB at KW = 8); K and V rings NST x BK x D x 4 each, 2 x 64
// KB = 128 KB for every KW; the merge buffer, 8 warps x 32 lanes x (64 +
// 4) floats = 68 KB, over the rings once every tile is consumed;
// barriers and 1 KB of alignment slack: 193 KB (KW = 2) to 145 KB (KW =
// 8) of the 227 KB a block may have, so one block an SM. K and V split
// into hi and lo in shared memory would have doubled the rings to 256 KB,
// past the limit, at the same depth. At D = 64 every figure halves.
//
// Bound on an H100 SXM at the UNet's shape (q (8,256,4,128), k/v
// (8,264,4,128), non-causal): 1.11 GFLOP of the function; at fp32
// accuracy on TF32 tensor cores that is 3 x 1.11 GFLOP at 495 TFLOP/s,
// 6.7 us, against 17.0 MB of q, k, v and o, 5.1 us at 3.35 TB/s. So
// operations bound it (16.5 us on the fp32 CUDA cores, the route it
// replaces).
//
// Plain C interface, built by nvcc into a shared library and called
// through ctypes (repro_torch/kernels/flash_attention.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32x3.cuh"
#include "tile_ends.cuh"
#include "tma.cuh"

namespace {

constexpr int WARPS = 8;                   // consumer warps
constexpr int THREADS = (WARPS + 1) * 32;  // + the producer warp
constexpr int ATOM = 32;  // fp32 columns in a 128-byte swizzle row
constexpr float LOG2E = 1.4426950408889634f;
// the causal mask's query positions (see the note above)
constexpr int MASK_SAME = 0, MASK_OFFSET = 1, MASK_POS = 2;

template <int D, int KW>
struct Cfg {
  static constexpr int QW = WARPS / KW;  // warps along the query rows
  static constexpr int BQ = 16 * QW;     // query rows a block
  static constexpr int BK = 64 / KW;     // key rows a tile
  static constexpr int NK = BK / 8;      // m16n8 tiles of S a warp
  static constexpr int SETS = 8 / NK;    // partial sums of S (see the note)
  static constexpr int NST = 2 * KW;     // ring stages, two a key group
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int KV_BYTES = BK * D * 4;
  static constexpr int OFF_QLO = Q_BYTES;  // Q is split once: hi, lo
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + NST * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + NST * KV_BYTES;
  // a warp's partial for the merge: D / 2 accumulator floats, m[2] and
  // l[2] a lane, written over the K/V rings once every tile is consumed
  static constexpr int PART_FLOATS = D / 2 + 4;
  static_assert(WARPS * 32 * PART_FLOATS * 4 <= 2 * NST * KV_BYTES,
                "the merge buffer fits the rings");
  // barriers: q_full, k_full[NST], v_full[NST], empty[NST]; then slack
  // to align the base to 1024 bytes
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 3 * NST) + 1024;
  static_assert(SMEM <= 232448, "shared memory over the 227 KB limit");
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
};

// byte offset of element (r, c) of an R-row fp32 tile as TMA writes it:
// D / 32 boxes of R rows x 128 bytes, the 16-byte chunks of each row
// XOR-swizzled by the row index mod 8
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 +
         ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[n] += A B_n at fp32 accuracy for the N tiles n with live[n]: lo*hi,
// then hi*lo, then hi*hi, each a round over all n, so that the three
// products into one accumulator are N products apart. b[n] holds B_n's
// two fp32 fragment values, split here.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[N][2],
                                           const bool (&live)[N]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_tf32(b[n][0], bh[n][0], bl[n][0]);
    split_tf32(b[n][1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (live[n]) mma_tf32(d[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (live[n]) mma_tf32(d[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (live[n]) mma_tf32(d[n], ah, bh[n][0], bh[n][1]);
}

// a block takes BQ query rows of one (batch, head); see the note above.
// MASK_OFFSET: rows at q_off + row; MASK_POS: rows at qpos[b, row], the
// block's key end from `ends` (both unused under MASK_SAME)
template <int D, int KW, int MASK>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tf32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   float* __restrict__ o, int Sq, int H, int KH, int kv_len,
                   int causal, int q_off, const int* __restrict__ qpos,
                   const int* __restrict__ ends, float scale_log2) {
  using C = Cfg<D, KW>;
  constexpr int BQ = C::BQ, BK = C::BK, NST = C::NST, QW = C::QW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar = base + C::OFF_BAR;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + NST + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * NST + s); };

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt, qt = blockIdx.x % n_qt, q0 = qt * BQ;
  const int b = bh / H, h = bh % H;
  // the position of row 0 of the block under MASK_SAME and MASK_OFFSET
  const int p0 = MASK == MASK_OFFSET ? q_off + q0 : q0;
  int k_end = causal ? min(kv_len, p0 + BQ) : kv_len;
  if constexpr (MASK == MASK_POS)
    k_end = causal ? min(kv_len, __ldg(ends + b * n_qt + qt)) : kv_len;
  const int nk = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), QW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WARPS * 32) {
    // producer: one lane issues every copy
    if (tid == WARPS * 32) {
      const int kh = h / (H / KH);
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < D / ATOM; ++c)
        tma_load_4d(base + c * BQ * 128, &tq, q_full, c * ATOM, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % NST;
        if (j >= NST) mbar_wait(empty(s), ((j / NST) & 1) ^ 1);
        const uint32_t sk = base + C::OFF_K + s * C::KV_BYTES;
        const uint32_t sv = base + C::OFF_V + s * C::KV_BYTES;
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int c = 0; c < D / ATOM; ++c)
          tma_load_4d(sk + c * BK * 128, &tk, k_full(s), c * ATOM, kh,
                      j * BK, b);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int c = 0; c < D / ATOM; ++c)
          tma_load_4d(sv + c * BK * 128, &tv, v_full(s), c * ATOM, kh,
                      j * BK, b);
      }
    }
    return;
  }

  // consumer warp (qw, kw): query rows qw * 16 .. + 15 of the block, key
  // tiles j with j % KW == kw
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qw = warp % QW, kw = warp / QW;
  const int r0 = qw * 16 + g;  // tile row of c0, c1; r0 + 8 of c2, c3
  // the positions of the thread's two rows, for the causal mask
  int row_lo = p0 + r0, row_hi = row_lo + 8;
  // the warp's live keys end here: 8-key blocks from it on are skipped
  int w_end = causal ? min(kv_len, p0 + qw * 16 + 16) : kv_len;
  if constexpr (MASK == MASK_POS) {
    const int* qp = qpos + (size_t)b * Sq;
    row_lo = __ldg(qp + min(q0 + r0, Sq - 1));
    row_hi = __ldg(qp + min(q0 + r0 + 8, Sq - 1));
    const int top = __reduce_max_sync(0xffffffffu, max(row_lo, row_hi));
    w_end = causal ? min(kv_len, top + 1) : kv_len;
  }
  const unsigned char* const sq = smem;
  const unsigned char* const sqlo = smem + C::OFF_QLO;

  float acc[D / 8][4];  // O: 16 x D, one m16n8 tile per 8 columns
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  // Q is split once for all tiles and warps: hi over the TMA tile in
  // place (no copy writes it again), lo beside it, in the same layout
  for (int i = tid; i < C::Q_BYTES / 16; i += WARPS * 32) {
    const float4 x = reinterpret_cast<const float4*>(smem)[i];
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(smem)[i] = hi;
    reinterpret_cast<uint4*>(smem + C::OFF_QLO)[i] = lo;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");

  for (int j = kw; j < nk; j += KW) {
    const int s = j % NST, ph = (j / NST) & 1, k0 = j * BK;
    const unsigned char* const sk = smem + C::OFF_K + s * C::KV_BYTES;
    const unsigned char* const sv = smem + C::OFF_V + s * C::KV_BYTES;
    // S = Q K_j^T, summed over the head dim in SETS interleaved partial
    // sums: a warp's S is only NK m16n8 tiles, and a single sum would
    // make every product wait for the one before it
    float sp[C::SETS][C::NK][4];
#pragma unroll
    for (int i = 0; i < C::SETS; ++i)
#pragma unroll
      for (int n = 0; n < C::NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[i][n][e] = 0.f;
    mbar_wait(k_full(s), ph);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const int c = ks * 8 + t;
      const int qa[4] = {swz<BQ>(r0, c), swz<BQ>(r0 + 8, c),
                         swz<BQ>(r0, c + 4), swz<BQ>(r0 + 8, c + 4)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = *reinterpret_cast<const uint32_t*>(sq + qa[i]);
        al[i] = *reinterpret_cast<const uint32_t*>(sqlo + qa[i]);
      }
      float kb[C::NK][2];
      bool live[C::NK];
#pragma unroll
      for (int n = 0; n < C::NK; ++n) {
        live[n] = k0 + 8 * n < w_end;
        kb[n][0] = *reinterpret_cast<const float*>(sk + swz<BK>(8 * n + g, c));
        kb[n][1] =
            *reinterpret_cast<const float*>(sk + swz<BK>(8 * n + g, c + 4));
      }
      mma_3xtf32(sp[ks % C::SETS], ah, al, kb, live);
    }
    float sc[C::NK][4];
#pragma unroll
    for (int n = 0; n < C::NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < C::SETS; ++i) v += sp[i][n][e];
        sc[n][e] = v;
      }

    // online softmax in log2 units: sc becomes P
    // a tile reaching past the warp's first row (with qpos: past the
    // thread's own rows) is masked
    const bool mask =
        k0 + BK > kv_len ||
        (causal && k0 + BK - 1 > (MASK == MASK_POS ? min(row_lo, row_hi)
                                                   : p0 + qw * 16));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (mask) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= kv_len || (causal && col > row)) sc[n][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float mu[2], alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(m_r[r] - mu[r]);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[n][e], scale_log2, -mu[e >> 1]));
        sc[n][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ps[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V_j: the A fragment of keys kk*8 .. +7 is S's accumulator
    // tile kk with the keys permuted (logical k = t: key 2t; t + 4: 2t + 1)
    mbar_wait(v_full(s), ph);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      if (k0 + 8 * kk >= w_end) continue;
      uint32_t ah[4], al[4];
      split_tf32(sc[kk][0], ah[0], al[0]);
      split_tf32(sc[kk][2], ah[1], al[1]);
      split_tf32(sc[kk][1], ah[2], al[2]);
      split_tf32(sc[kk][3], ah[3], al[3]);
      const int kr = kk * 8 + 2 * t;
      // 8 output tiles at a time, to bound the registers of split V
#pragma unroll
      for (int h8 = 0; h8 < D / 64; ++h8) {
        float vb[8][2];
        const bool live[8] = {true, true, true, true, true, true, true, true};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 64 * h8 + 8 * n + g;
          vb[n][0] = *reinterpret_cast<const float*>(sv + swz<BK>(kr, col));
          vb[n][1] = *reinterpret_cast<const float*>(sv + swz<BK>(kr + 1, col));
        }
        mma_3xtf32(*reinterpret_cast<float(*)[8][4]>(&acc[8 * h8]), ah, al,
                   vb, live);
      }
    }
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  {
    // every warp leaves its partial in fragment order over the rings (all
    // tiles consumed: no copy is in flight); the key group 0 warp of each
    // row band merges the KW partials of its rows
    asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
    float* const part = reinterpret_cast<float*>(smem + C::OFF_K);
    float* const mine = part + warp * C::PART_FLOATS * 32 + lane;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(D / 2 + r) * 32] = m_r[r];
      mine[(D / 2 + 2 + r) * 32] = l_r[r];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
    if (kw != 0) return;
    float wk[KW][2], mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int k = 0; k < KW; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wk[k][r] = part[((k * QW + qw) * C::PART_FLOATS + D / 2 + r) * 32 +
                        lane];
        mt[r] = fmaxf(mt[r], wk[k][r]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mu = mt[r] == -INFINITY ? 0.f : mt[r];
      l_r[r] = 0.f;
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        wk[k][r] = ex2(wk[k][r] - mu);
        l_r[r] += wk[k][r] *
                  part[((k * QW + qw) * C::PART_FLOATS + D / 2 + 2 + r) * 32 +
                       lane];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < KW; ++k)
          sum += wk[k][e >> 1] *
                 part[((k * QW + qw) * C::PART_FLOATS + 4 * n + e) * 32 +
                      lane];
        acc[n][e] = sum;
      }
  }

  const size_t q_row = (size_t)H * D;
  float* const ob = o + (size_t)b * Sq * q_row + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;  // the output row (not its position)
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(ob + (size_t)row * q_row + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D, int KW, int MASK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int kv_len, int causal, int q_off,
           const int* qpos, int* ends, float scale, cudaStream_t stream) {
  using C = Cfg<D, KW>;
  static unsigned int smem_set = 0;
  cudaError_t err = set_smem_once((const void*)flash_fwd_tf32<D, KW, MASK>,
                                  C::SMEM, &smem_set);
  if (err != cudaSuccess) return (int)err;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, F32, 4, ATOM, C::BQ, D, H, Sq, B) ||
      !tensor_map(&mk, k, F32, 4, ATOM, C::BK, D, KH, Sk, B) ||
      !tensor_map(&mv, v, F32, 4, ATOM, C::BK, D, KH, Sk, B))
    return -2;
  if constexpr (MASK == MASK_POS) {
    err = launch_tile_ends(qpos, ends, B, Sq, C::BQ, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * H * ((Sq + C::BQ - 1) / C::BQ);
  flash_fwd_tf32<D, KW, MASK><<<(unsigned)blocks, THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<float*>(o), Sq, H, KH, kv_len, causal, q_off,
      qpos, ends, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int MASK>
int dispatch_kw(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int KH, int kv_len, int causal,
                int q_off, const int* qpos, int* ends, float scale,
                int key_groups, cudaStream_t stream) {
  switch (key_groups) {
    case 2:
      return launch<D, 2, MASK>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                                q_off, qpos, ends, scale, stream);
    case 4:
      return launch<D, 4, MASK>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                                q_off, qpos, ends, scale, stream);
    case 8:
      return launch<D, 8, MASK>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                                q_off, qpos, ends, scale, stream);
    default:
      return -1;
  }
}

// the mask's instantiation: positions only for a causal call given them,
// an offset only for a causal call with q_off > 0
template <int D>
int dispatch_mask(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Sk, int H, int KH, int kv_len,
                  int causal, int q_off, const int* qpos, int* ends,
                  float scale, int key_groups, cudaStream_t stream) {
  if (causal && qpos)
    return dispatch_kw<D, MASK_POS>(q, k, v, o, B, Sq, Sk, H, KH, kv_len,
                                    causal, 0, qpos, ends, scale, key_groups,
                                    stream);
  if (causal && q_off)
    return dispatch_kw<D, MASK_OFFSET>(q, k, v, o, B, Sq, Sk, H, KH, kv_len,
                                       causal, q_off, nullptr, nullptr,
                                       scale, key_groups, stream);
  return dispatch_kw<D, MASK_SAME>(q, k, v, o, B, Sq, Sk, H, KH, kv_len,
                                   causal, 0, nullptr, nullptr, scale,
                                   key_groups, stream);
}

}  // namespace

extern "C" {

// float32 q: (B, Sq, H, D); k, v: (B, Sk, KH, D); o: (B, Sq, H, D); all
// contiguous, 16-byte aligned, on the device of `stream`; D 64 or 128.
// `key_groups` (2, 4 or 8) splits each block's keys over that many warp
// groups (see the note above). `q_off` >= 0 is the absolute position of
// query row 0 (the causal mask is col > q_off + row); `qpos`, where not
// null, int32 (B, Sq) on the device, >= 0, each query row's position
// instead (col > qpos[b, row]), and `scratch` then int32 on the device with
// room for B * Sq values (the query tiles' key ends). Returns 0, a
// cudaError_t, -1 for an unsupported D or key-group count, or -2 if a
// tensor map could not be encoded.
int flash_attention_tf32_forward(const void* q, const void* k, const void* v,
                                 void* o, int B, int Sq, int Sk, int H,
                                 int KH, int D, int kv_len, int causal,
                                 float scale, int key_groups, int q_off,
                                 const void* qpos, void* scratch,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  int* ends = static_cast<int*>(scratch);
  if (D == 64)
    return dispatch_mask<64>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                             q_off, qp, ends, scale, key_groups, s);
  if (D == 128)
    return dispatch_mask<128>(q, k, v, o, B, Sq, Sk, H, KH, kv_len, causal,
                              q_off, qp, ends, scale, key_groups, s);
  return -1;
}

const char* flash_attention_tf32_error_string(int err) {
  if (err == -1) return "unsupported head dim or key-group count";
  if (err == -2) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
