// Split flash-attention backward for fp32 (B, H, T, 256) operands, T a
// multiple of 32: F2SW (dK and dV) and F3SW (dQ), two deterministic kernels
// of register-tiled fp32 FMAs.
//
// Replace, for fp32 at D 256, the two TPU kernels of JAX's Pallas flash
// attention backward that kronfluence_tpu/ops/attention.py:_flash_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py, both called
// from the custom VJP :254): `_flash_attention_bwd_dkv` (:941, its
// pallas_call :1121) and `_flash_attention_bwd_dq` (:1287, its pallas_call
// :1456). F2S and F3S (flash_backward_f32.cu) take fp32 at D 64, F2SH and
// F3SH (flash_backward_f32_d128.cu) fp32 at D 128; F2 and F3
// (flash_attention.cu) keep bf16 at D 256 (ops/kernels/flash.py:
// backward_route). Semantics are F2's and F3's: logits = (Q K^T) * scale,
// plus -0.7 * FLT_MAX where the key is above the diagonal or in another
// segment (such a pair's P is exactly 0, here as in the plain version); P =
// exp(logit - m) / l with the forward's row max m and row sum l; dS = P * (dP
// - di) * scale with di = rowsum(O * dO) from the caller. Everything is fp32:
// P and dS are not rounded. Every output element is summed by one thread in a
// fixed order, with no atomics: two calls give the same bits.
//
// What bounds it on the H100. At B 16, H 3, T 512, D 256, padded, F2SW's four
// products take 8 D FLOPs a kept query-key pair and F3SW's three 6 D: 9.4 and
// 7.0 GFLOP, 0.140 and 0.105 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores, against 0.045 and 0.038 ms for their bytes at 3.35 TB/s. So the FMA
// units bound both. Both compute every 32 x 32 tile pair up to the diagonal
// (24.0 GFLOP for the pair, 0.358 ms at that peak). An outer product of
// register fragments read from shared memory takes 4 (a + b) bytes for a b
// FMAs on an a x b thread tile, and an SM's shared memory hands its threads
// 128 bytes a clock against the 128 FMA lanes' need: 2 x 4 can run at most at
// a third of the FMA rate, 4 x 4 at half, 8 x 4 at two thirds, 8 x 8 at the
// full rate. F2SH's and F3SH's layouts do not fit at D 256: a padded row is
// 1,040 bytes, so a 64-row tile is 66,560, and F3SH's K and V ring alone
// would take 266 KB of the 227 KB a CTA may hold.
//
// What the design does about it (F2SH's and F3SH's SGEMM register tiling at
// 32-row tiles, each CTA two groups of 4 warps, with D split between the
// groups for S and dP):
//  * every product is built by outer products of register fragments read as
//    float4 from padded shared tiles (rows of 260 floats), so one 128-bit
//    shared load feeds 8 to 16 FMAs. S = Q K^T and dP = dO V^T (and S^T,
//    dP^T) contract two row-major tiles along D ("NT" form); dQ = dS K, dV =
//    P^T dO and dK = dS^T Q contract along the keys or queries ("NN" form);
//  * D split: a 32 x 32 tile of S and one of dP over 256 threads leave a
//    thread 8 outputs, a 2 x 4 tile (a third of the rate). So each of the
//    four pairs of warps sums one product over one half of D: warps 0-1 S
//    and 2-3 dP over columns 0-127 (group 0), warps 4-5 S and 6-7 dP over
//    columns 128-255 (group 1), a 4 x 4 tile a thread. Group 0 writes its
//    partial sums to shared memory; group 1 adds them to its own (the low
//    half plus the high half, one rounding), applies the mask and the
//    softmax statistics, and writes P and dS;
//  * F3SW: one CTA per (32-query tile, head, batch), the last query tiles
//    (the most keys) launched first, 32-key steps from 0 to the diagonal. Q
//    and dO stay in shared memory; K, V and the key segment ids come in by
//    16-byte cp.async through a two-stage ring. Group 1's S warps write P^T,
//    its dP warps read it back after a barrier of the group's 128 threads
//    and write dS^T over it; then all 8 warps add dS K into dQ, 4 x 8 a
//    thread. 215,296 bytes: one CTA an SM;
//  * F2SW: one CTA per (32-key tile, head, batch), the first key tiles (the
//    most queries) launched first, 32-query steps from the diagonal to T.
//    Group 1's S^T warps write P; then group 0 adds P^T dO into dV while
//    group 1's dP^T warps write dS and, after the group's barrier, group 1
//    adds dS^T Q into dK: each group owns one output, 8 x 8 a thread. K and V
//    stay in shared memory; Q, dO, m, l, di and the query segment ids come in
//    by cp.async through a two-stage ring. 220,160 bytes: one CTA an SM;
//  * the pitches put the 4 and 8 distinct rows a warp reads at one NT step,
//    and the 32 scalar stores of a partial, of P or of dS, in distinct banks;
//    an NN step reads 1 or 2 float4 that every lane shares and 2 rows of 32
//    adjacent float4;
//  * exp is `expf` on the raw logit minus m (no log2 e prescale, which would
//    overflow the mask value), and the mask is a select, so masked pairs give
//    exactly 0; every CTA-wide barrier is reached by the whole CTA, and group
//    1 alone waits on a named barrier of its 128 threads.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace kf_flash;

constexpr int kD = 256;                      // head dim
constexpr int kHalf = kD / 2;                // the D columns a group sums in S and dP
constexpr int kTile = 32;                    // F2SW's keys and F3SW's queries a CTA, and the step
constexpr int kLd = kD + 4;                  // shared row pitch of Q, K, V, dO in floats: 1,040 bytes
constexpr int kTileBytes = kTile * kLd * 4;  // 33,280
constexpr int kLdP = kTile + 4;              // pitch of P, dS and their transposes: 144 bytes
constexpr int kPBytes = kTile * kLdP * 4;    // 4,608
constexpr int kLdX = kTile + 8;              // pitch of group 0's partial S and dP: 160 bytes
constexpr int kXBytes = kTile * kLdX * 4;    // 5,120
constexpr int kThreads = 256;                // 8 warps, two groups of 4
constexpr int kGroupThreads = 128;

// rows x 256 fp32 from device memory (row pitch 256) into a padded shared
// tile at shared address `dst`, by kThreads threads from `tid` on.
template <int kRows>
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* src, int tid) {
  static_assert((kRows * (kD / 4)) % kThreads == 0, "copy_rows split");
#pragma unroll
  for (int n = 0; n < kRows * (kD / 4) / kThreads; ++n) {
    const int c = tid + n * kThreads;
    const int r = c / (kD / 4), cc = (c % (kD / 4)) * 4;
    cp_async16(dst + (r * kLd + cc) * 4, src + static_cast<size_t>(r) * kD + cc);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Waits for the 128 threads of group 1 (warps 4-7) alone.
__device__ __forceinline__ void group1_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kGroupThreads) : "memory");
}

// NT form over one half of D: acc[i][j] += sum over d < 128 of A[ra + 8 i][d]
// * B[rb + 8 j][d] (i, j < 4), A and B padded shared tiles of pitch kLd,
// offset to the half's first column. Each step reads 4 float4 of A and 4 of
// B for 64 FMAs; each output sums d in order.
__device__ __forceinline__ void nt_half(float (&acc)[4][4], const float* a, int ra, const float* b,
                                        int rb) {
#pragma unroll
  for (int d = 0; d < kHalf; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(a + (ra + 8 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(b + (rb + 8 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// NN form: acc[4 u + i][4 h + j] += sum over k < 32 of A[k][ca + 4 u + i] *
// B[k][cb + 128 h + j] (i, j < 4, u < kA, h < 2), A a shared tile of pitch
// kLdP, B one of pitch kLd. Each step reads kA float4 of A and 2 of B for
// 32 kA FMAs; each output sums k in order.
template <int kA>
__device__ __forceinline__ void nn_product(float (&acc)[4 * kA][8], const float* a, int ca,
                                           const float* b, int cb) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    float xs[4 * kA];
#pragma unroll
    for (int u = 0; u < kA; ++u) {
      const float4 x = ld4(a + k * kLdP + ca + 4 * u);
      xs[4 * u] = x.x;
      xs[4 * u + 1] = x.y;
      xs[4 * u + 2] = x.z;
      xs[4 * u + 3] = x.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 y = ld4(b + k * kLd + cb + kHalf * h);
#pragma unroll
      for (int i = 0; i < 4 * kA; ++i) {
        acc[i][4 * h + 0] = fmaf(xs[i], y.x, acc[i][4 * h + 0]);
        acc[i][4 * h + 1] = fmaf(xs[i], y.y, acc[i][4 * h + 1]);
        acc[i][4 * h + 2] = fmaf(xs[i], y.z, acc[i][4 * h + 2]);
        acc[i][4 * h + 3] = fmaf(xs[i], y.w, acc[i][4 * h + 3]);
      }
    }
  }
}

template <int kRows, int kCols>
__device__ __forceinline__ void zero(float (&acc)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
}

// Group 0 hands its partial 4 x 4 tile to group 1 through `x` (pitch kLdX):
// group 0 stores it, and after a CTA-wide barrier group 1 adds it to its own.
__device__ __forceinline__ void store_partial(float* x, const float (&acc)[4][4], int r, int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[(r + 8 * i) * kLdX + c + 8 * j] = acc[i][j];
}

__device__ __forceinline__ void add_partial(float (&acc)[4][4], const float* x, int r, int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = x[(r + 8 * i) * kLdX + c + 8 * j] + acc[i][j];
}

// ---------------------------------------------------------------------------
// Both kernels: warp w's pair (w / 2) sums S (S^T in F2SW) when w / 2 is even
// and dP (dP^T) when it is odd, over D columns 128 (w / 4) to 128 (w / 4) +
// 127; its thread (r, c) = (4 (w % 2) + lane / 8, lane % 8), r and c < 8,
// owns the tile's rows r + 8 i and columns c + 8 j (i, j < 4).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// F3SW: dQ. Thread (rq, cq) = (tid / 32, tid % 32) owns dQ at rows 4 rq + i
// and columns 4 cq + 128 h + j (i, j < 4, h < 2).
// ---------------------------------------------------------------------------
// Shared memory, in bytes: Q, dO, two stages of K, two of V, group 0's
// partial S and dP, P^T (then dS^T; key rows, query columns), two stages of
// the key segment ids, then the query rows' m, 1 / l, di and segment ids.
constexpr int kDqSmemQ = 0;
constexpr int kDqSmemDo = kTileBytes;
constexpr int kDqSmemK = 2 * kTileBytes;
constexpr int kDqSmemV = 4 * kTileBytes;
constexpr int kDqSmemX = 6 * kTileBytes;
constexpr int kDqSmemP = kDqSmemX + 2 * kXBytes;
constexpr int kDqSmemSeg = kDqSmemP + kPBytes;
constexpr int kDqSmemRows = kDqSmemSeg + 2 * kTile * 4;
constexpr int kDqSmemBytes = kDqSmemRows + 4 * kTile * 4;  // 215,296
static_assert(kDqSmemBytes <= 232448, "F3SW shared memory");

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32_d256_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ seg,
                                 const float* __restrict__ l_in, const float* __restrict__ m_in,
                                 const float* __restrict__ dout, const float* __restrict__ di,
                                 float* __restrict__ dq, int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const float* fsm = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2, pr = (warp >> 1) & 1;
  const int r = 4 * (warp & 1) + (lane >> 3), c = lane & 7;
  const int rq = tid >> 5, cq = tid & 31;
  const int bh = blockIdx.x;  // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int kt_diag = q0 / kTile;

  auto load_key_tile = [&](int stage, int kt) {
    const size_t k0 = static_cast<size_t>(kt) * kTile;
    copy_rows<kTile>(s0 + kDqSmemK + stage * kTileBytes, k + (base + k0) * kD, tid);
    copy_rows<kTile>(s0 + kDqSmemV + stage * kTileBytes, v + (base + k0) * kD, tid);
    if (tid < kTile / 4) cp_async16(s0 + kDqSmemSeg + (stage * kTile + tid * 4) * 4, segb + k0 + tid * 4);
  };

  copy_rows<kTile>(s0 + kDqSmemQ, q + (base + q0) * kD, tid);
  copy_rows<kTile>(s0 + kDqSmemDo, dout + (base + q0) * kD, tid);
  load_key_tile(0, 0);
  cp_async_commit();

  // The query rows' statistics, visible after the first step's barrier.
  float* rows = reinterpret_cast<float*>(smem + kDqSmemRows);  // m, 1 / l, di, segment ids
  if (tid < kTile) {
    rows[tid] = m_in[base + q0 + tid];
    rows[kTile + tid] = 1.f / l_in[base + q0 + tid];
    rows[2 * kTile + tid] = di[base + q0 + tid];
    reinterpret_cast<int*>(rows)[3 * kTile + tid] = segb[q0 + tid];
  }

  float dq_acc[4][8];
  zero(dq_acc);
  // This warp's half of Q (S) or dO (dP); its product's partial buffer.
  const float* a_nt = fsm + (pr ? kDqSmemDo : kDqSmemQ) / 4 + kHalf * g;
  float* xs = reinterpret_cast<float*>(smem + kDqSmemX + pr * kXBytes);
  float* pt = reinterpret_cast<float*>(smem + kDqSmemP);  // P^T, then dS^T

  for (int kt = 0; kt <= kt_diag; ++kt) {
    const int stage = kt & 1, k0 = kt * kTile;
    // Waits for this step's tiles; the barrier also marks the other stage,
    // the partials and P^T free (every warp is done with the step before)
    // for the copy below.
    cp_async_wait<0>();
    __syncthreads();
    if (kt < kt_diag) load_key_tile(stage ^ 1, kt + 1);
    cp_async_commit();
    const float* ks = fsm + (kDqSmemK + stage * kTileBytes) / 4;
    const float* vs = fsm + (kDqSmemV + stage * kTileBytes) / 4;
    const int* seg_k = reinterpret_cast<const int*>(smem + kDqSmemSeg) + stage * kTile;

    float sp[4][4];  // this half's S or dP, then (group 1) the whole sum
    zero(sp);
    nt_half(sp, a_nt, r, (pr ? vs : ks) + kHalf * g, c);
    if (g == 0) store_partial(xs, sp, r, c);
    __syncthreads();
    if (g == 1) {
      add_partial(sp, xs, r, c);
      if (pr == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r + 8 * i;
          const float m_r = rows[row], rl = rows[kTile + row];
          const int seg_r = reinterpret_cast<const int*>(rows)[3 * kTile + row];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c + 8 * j;
            const bool keep = k0 + col <= q0 + row && seg_k[col] == seg_r;
            pt[col * kLdP + row] = keep ? expf(sp[i][j] * scale - m_r) * rl : 0.f;
          }
        }
      }
      group1_barrier();
      if (pr == 1) {
        // dS^T over P^T: each position is read and written by one thread.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r + 8 * i;
          const float di_r = rows[2 * kTile + row];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* x = pt + (c + 8 * j) * kLdP + row;
            *x = *x * (sp[i][j] - di_r) * scale;
          }
        }
      }
    }
    __syncthreads();
    nn_product<1>(dq_acc, pt, 4 * rq, ks, 4 * cq);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(dq + (base + q0 + 4 * rq + i) * kD + 4 * cq + kHalf * h) =
          make_float4(dq_acc[i][4 * h], dq_acc[i][4 * h + 1], dq_acc[i][4 * h + 2],
                      dq_acc[i][4 * h + 3]);
}

// ---------------------------------------------------------------------------
// F2SW: dK and dV. In the NT products r indexes key rows and c query
// columns. Thread (rk, ck) = (warp % 4, lane) owns dV (group 0) or dK
// (group 1) at key rows 8 rk + i and columns 4 ck + 128 h + j (i < 8, j < 4,
// h < 2).
// ---------------------------------------------------------------------------
constexpr int kStatBytes = 4 * kTile * 4;                  // m, l, di, segment ids
constexpr int kStageBytes = 2 * kTileBytes + kStatBytes;   // Q, dO, statistics: 67,072
// Shared memory, in bytes: K, V, two stages, group 0's partial S^T and
// dP^T, then P and dS (query rows, key columns).
constexpr int kDkvSmemK = 0;
constexpr int kDkvSmemV = kTileBytes;
constexpr int kDkvSmemStages = 2 * kTileBytes;
constexpr int kDkvSmemX = kDkvSmemStages + 2 * kStageBytes;
constexpr int kDkvSmemP = kDkvSmemX + 2 * kXBytes;
constexpr int kDkvSmemDs = kDkvSmemP + kPBytes;
constexpr int kDkvSmemBytes = kDkvSmemDs + kPBytes;  // 220,160
static_assert(kDkvSmemBytes <= 232448, "F2SW shared memory");

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_f32_d256_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const int* __restrict__ seg,
                                  const float* __restrict__ l_in, const float* __restrict__ m_in,
                                  const float* __restrict__ dout, const float* __restrict__ di,
                                  float* __restrict__ dk, float* __restrict__ dv, int H,
                                  int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const float* fsm = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2, pr = (warp >> 1) & 1;
  const int r = 4 * (warp & 1) + (lane >> 3), c = lane & 7;
  const int rk = warp & 3, ck = lane;
  const int bh = blockIdx.x;  // b * H + h
  const int k0 = blockIdx.y * kTile;  // keys near the start see the most queries: first
  const size_t base = static_cast<size_t>(bh) * T_len;
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int n_steps = (T_len - k0) / kTile;

  auto load_step = [&](int stage, int q0) {
    const uint32_t st = s0 + kDkvSmemStages + stage * kStageBytes;
    copy_rows<kTile>(st, q + (base + q0) * kD, tid);
    copy_rows<kTile>(st + kTileBytes, dout + (base + q0) * kD, tid);
    constexpr int kChunks = kTile / 4;  // 16-byte chunks of one statistic
    if (tid < 4 * kChunks) {
      const int which = tid / kChunks, cc = (tid % kChunks) * 4;
      const void* src = which == 0   ? static_cast<const void*>(m_in + base + q0 + cc)
                        : which == 1 ? static_cast<const void*>(l_in + base + q0 + cc)
                        : which == 2 ? static_cast<const void*>(di + base + q0 + cc)
                                     : static_cast<const void*>(segb + q0 + cc);
      cp_async16(st + 2 * kTileBytes + (which * kTile + cc) * 4, src);
    }
  };

  copy_rows<kTile>(s0 + kDkvSmemK, k + (base + k0) * kD, tid);
  copy_rows<kTile>(s0 + kDkvSmemV, v + (base + k0) * kD, tid);
  load_step(0, k0);
  cp_async_commit();

  int seg_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) seg_k[i] = segb[k0 + r + 8 * i];

  float acc[8][8];  // dV (group 0) or dK (group 1)
  zero(acc);
  // This warp's half of K (S^T) or V (dP^T); its product's partial buffer.
  const float* a_nt = fsm + (pr ? kDkvSmemV : kDkvSmemK) / 4 + kHalf * g;
  float* xs = reinterpret_cast<float*>(smem + kDkvSmemX + pr * kXBytes);
  float* ps = reinterpret_cast<float*>(smem + kDkvSmemP);
  float* dss = reinterpret_cast<float*>(smem + kDkvSmemDs);

  for (int it = 0; it < n_steps; ++it) {
    const int stage = it & 1, q0 = k0 + it * kTile;
    // Waits for this step's tiles; the barrier also marks the other stage,
    // the partials, P and dS free (every warp is done with the step before).
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_steps) load_step(stage ^ 1, q0 + kTile);
    cp_async_commit();
    const float* qs = fsm + (kDkvSmemStages + stage * kStageBytes) / 4;
    const float* dos = qs + kTileBytes / 4;
    const float* stats = dos + kTileBytes / 4;  // m, l, di, segment ids
    const int* seg_q = reinterpret_cast<const int*>(stats + 3 * kTile);

    float st[4][4];  // this half's S^T or dP^T, then (group 1) the whole sum
    zero(st);
    nt_half(st, a_nt, r, (pr ? dos : qs) + kHalf * g, c);
    if (g == 0) store_partial(xs, st, r, c);
    __syncthreads();
    if (g == 1) {
      add_partial(st, xs, r, c);
      if (pr == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c + 8 * j;
          const float mq = stats[col], rlq = 1.f / stats[kTile + col];
          const int sq = seg_q[col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool keep = k0 + r + 8 * i <= q0 + col && seg_k[i] == sq;
            ps[col * kLdP + r + 8 * i] = keep ? expf(st[i][j] * scale - mq) * rlq : 0.f;
          }
        }
      }
    }
    __syncthreads();
    if (g == 0) {
      nn_product<2>(acc, ps, 8 * rk, dos, 4 * ck);
    } else {
      if (pr == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c + 8 * j;
          const float diq = stats[2 * kTile + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int at = col * kLdP + r + 8 * i;
            dss[at] = ps[at] * (st[i][j] - diq) * scale;
          }
        }
      }
      group1_barrier();
      nn_product<2>(acc, dss, 8 * rk, qs, 4 * ck);
    }
  }

  float* out = g ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (base + k0 + 8 * rk + i) * kD + 4 * ck;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(out + row + kHalf * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

bool valid_shape(int B, int H, int T_len, int D) {
  return D == kD && B > 0 && H > 0 && T_len > 0 && T_len % kTile == 0 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && T_len / kTile <= 65535;
}

}  // namespace

// q, k, v, dout: fp32 (B, H, T, 256); seg: int32 (B, T); l, m, di: fp32
// (B, H, T); dk, dv: fp32 (B, H, T, 256). Every pointer 16-byte aligned, T a
// multiple of 32. Returns a CUDA error code (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int kf_flash_bwd_dkv_f32_d256(const void* q, const void* k, const void* v,
                                         const void* seg, const void* l, const void* m,
                                         const void* dout, const void* di, void* dk, void* dv,
                                         int B, int H, int T_len, int D, float scale,
                                         void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dkv_f32_d256_kernel<<<grid, kThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(dout), static_cast<const float*>(di), static_cast<float*>(dk),
      static_cast<float*>(dv), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// As kf_flash_bwd_dkv_f32_d256, with dq: fp32 (B, H, T, 256) out.
extern "C" int kf_flash_bwd_dq_f32_d256(const void* q, const void* k, const void* v,
                                        const void* seg, const void* l, const void* m,
                                        const void* dout, const void* di, void* dq, int B, int H,
                                        int T_len, int D, float scale, void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dq_f32_d256_kernel<<<grid, kThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(dout), static_cast<const float*>(di), static_cast<float*>(dq), H,
      T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// For measurement: the registers a thread, the local (spill) bytes a thread
// and the CTAs an SM of F2SW (which 0) or F3SW (which 1) at their shared
// memory.
extern "C" int kf_flash_bwd_f32_d256_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(flash_bwd_dkv_f32_d256_kernel)
                              : reinterpret_cast<const void*>(flash_bwd_dq_f32_d256_kernel);
  const int bytes = which == 0 ? kDkvSmemBytes : kDqSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, bytes));
}
