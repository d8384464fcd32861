// Split flash-attention backward for fp32 (B, H, T, 128) operands, T a
// multiple of 64: F2SH (dK and dV) and F3SH (dQ), two deterministic kernels
// of register-tiled fp32 FMAs.
//
// Replace, for fp32 at D 128, the two TPU kernels of JAX's Pallas flash
// attention backward that kronfluence_tpu/ops/attention.py:_flash_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py, both called
// from the custom VJP :254): `_flash_attention_bwd_dkv` (:941, its
// pallas_call :1121) and `_flash_attention_bwd_dq` (:1287, its pallas_call
// :1456). F2S and F3S (flash_backward_f32.cu) take fp32 at D 64; F2 and F3
// (flash_attention.cu) fp32 and bf16 at D 256 (ops/kernels/flash.py:
// backward_route). Semantics are F2's and F3's: logits = (Q K^T) * scale,
// plus -0.7 * FLT_MAX where the key is above the diagonal or in another
// segment (such a pair's P is exactly 0, here as in the plain version); P =
// exp(logit - m) / l with F1's row max m and row sum l; dS = P * (dP - di) *
// scale with di = rowsum(O * dO) from the caller. Everything is fp32: P and dS
// are not rounded. Every output element is summed by one thread in a fixed
// order, with no atomics: two calls give the same bits.
//
// What bounds it on the H100. At B 16, H 6, T 512, D 128, padded, F2SH's four
// products take 8 D FLOPs a kept query-key pair and F3SH's three 6 D: 9.4 and
// 7.0 GFLOP, 0.140 and 0.105 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores, against 0.045 and 0.038 ms for their bytes at 3.35 TB/s. So the FMA
// units bound both. Both compute every 64 x 64 tile pair up to the diagonal
// (25.4 GFLOP for the pair, 0.38 ms at that peak). An outer product of
// register fragments read from shared memory takes 4 (a + b) bytes for a b
// FMAs on an a x b thread tile, and an SM's shared memory hands its threads
// 128 bytes a clock against the 128 FMA lanes' need: a 4 x 4 tile can run at
// most at half the FMA rate, 8 x 4 at two thirds, 8 x 8 at the full rate.
// F2S's and F3S's 4 x 4 tiles ran at half (D 64), and at D 128 their layouts
// no longer fit: a padded 64-row tile is 33,792 bytes, and F2S's dK and dV
// would take 128 accumulators a thread.
//
// What the design does about it (F2S's and F3S's SGEMM register tiling, each
// CTA split in two groups of 4 warps that compute the step's two NT products
// apart and trade their results through shared memory):
//  * every product is built by outer products of register fragments read as
//    float4 from padded shared tiles (rows of 132 floats, 528 bytes), so one
//    128-bit shared load feeds 8 to 16 FMAs. S = Q K^T and dP = dO V^T (and
//    S^T, dP^T) contract two row-major tiles along D ("NT" form); dQ = dS K,
//    dV = P^T dO and dK = dS^T Q contract along the keys or queries ("NN"
//    form), reading the float4 of a thread's adjacent output rows from dS^T
//    (or P, dS, in rows of 68 floats) and of its output columns from K (or
//    dO, Q);
//  * F3SH: one CTA of 8 warps per (64-query tile, head, batch), the last
//    query tiles (the most keys) launched first, 64-key steps from 0 to the
//    diagonal. Group 0 computes S, 8 x 4 a thread, and writes P^T; group 1
//    computes dP at the same positions, reads P^T back and writes dS^T over
//    it; then all 8 warps add dS K into dQ, 4 x 8 a thread. Q and dO stay
//    in shared memory; K, V and the key segment ids come in by 16-byte
//    cp.async through a two-stage ring. 221,696 bytes: one CTA an SM;
//  * F2SH: one CTA of 8 warps per (64-key tile, head, batch), the first key
//    tiles (the most queries) launched first, 32-query steps from the
//    diagonal to T. Group 0 computes S^T, 4 x 4 a thread, writes P and adds
//    P^T dO into dV; group 1 computes dP^T at the same positions, reads P,
//    writes dS and adds dS^T Q into dK: each group owns one output, 8 x 8 a
//    thread. K and V stay in shared memory; Q, dO, m, l, di and the query
//    segment ids come in by cp.async through a two-stage ring. 153,600
//    bytes: one CTA an SM;
//  * the padding puts the 4 and 8 distinct rows a warp reads at one step of
//    an NT product, and the 32 scalar stores of P (P^T, dS, dS^T), in
//    distinct banks; an NN step reads 2 and 16 adjacent float4;
//  * exp is `expf` on the raw logit minus m (no log2 e prescale, which would
//    overflow the mask value), and the mask is a select, so masked pairs give
//    exactly 0; every CTA-wide barrier is reached by the whole CTA, and F2SH's
//    group 1 alone waits on a named barrier of its 128 threads.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace kf_flash;

constexpr int kD = 128;                      // head dim
constexpr int kTile = 64;                    // F2SH's keys and F3SH's queries a CTA; T's granularity
constexpr int kLd = kD + 4;                  // shared row pitch of Q, K, V, dO in floats: 528 bytes
constexpr int kTileBytes = kTile * kLd * 4;  // 33,792
constexpr int kLdS = kTile + 4;              // shared row pitch of P, dS and their transposes: 272 bytes
constexpr int kThreads = 256;                // 8 warps, two groups of 4
constexpr int kGroupThreads = 128;

// rows x 128 fp32 from device memory (row pitch 128) into a padded shared
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

// Waits for the 128 threads of F2SH's group 1 (warps 4-7) alone.
__device__ __forceinline__ void group1_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kGroupThreads) : "memory");
}

// NT form: acc[i][j] += sum over d < 128 of A[ra + kSA i][d] * B[rb + kSB j][d],
// A and B padded shared tiles of pitch kLd. Each step reads kI float4 of A
// and kJ of B for 4 kI kJ FMAs; each output sums d in order.
template <int kI, int kSA, int kJ, int kSB>
__device__ __forceinline__ void nt_product(float (&acc)[kI][kJ], const float* a, int ra,
                                           const float* b, int rb) {
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 x[kI], y[kJ];
#pragma unroll
    for (int i = 0; i < kI; ++i) x[i] = ld4(a + (ra + kSA * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < kJ; ++j) y[j] = ld4(b + (rb + kSB * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// NN form: acc[4 u + i][4 h + j] += sum over k < kK of A[k][ca + 4 u + i] *
// B[k][cb + 64 h + j] (i, j < 4, u < kA, h < 2), A a shared tile of pitch
// kLdS, B one of pitch kLd. Each step reads kA float4 of A and 2 of B for
// 32 kA FMAs; each output sums k in order.
template <int kK, int kA>
__device__ __forceinline__ void nn_product(float (&acc)[4 * kA][8], const float* a, int ca,
                                           const float* b, int cb) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float xs[4 * kA];
#pragma unroll
    for (int u = 0; u < kA; ++u) {
      const float4 x = ld4(a + k * kLdS + ca + 4 * u);
      xs[4 * u] = x.x;
      xs[4 * u + 1] = x.y;
      xs[4 * u + 2] = x.z;
      xs[4 * u + 3] = x.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 y = ld4(b + k * kLd + cb + 64 * h);
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

// ---------------------------------------------------------------------------
// F3SH: dQ. Group g = warp / 4; its thread (r, c) = (4 (warp % 2) + lane / 8,
// 8 (warp % 4 / 2) + lane % 8), r < 8 and c < 16, owns S (group 0) or dP
// (group 1) at query rows r + 8 i and key columns c + 16 j (i < 8, j < 4).
// Thread (rq, cq) = (tid / 16, tid % 16) owns dQ at rows 4 rq + i and columns
// 4 cq + 64 h + j (i, j < 4, h < 2).
// ---------------------------------------------------------------------------
// Shared memory, in bytes: Q, dO, two stages of K, two of V, P^T (then dS^T;
// key rows, query columns), two stages of the key segment ids, then the
// query rows' m, 1 / l, di and segment ids.
constexpr int kDqSmemQ = 0;
constexpr int kDqSmemDo = kTileBytes;
constexpr int kDqSmemK = 2 * kTileBytes;
constexpr int kDqSmemV = 4 * kTileBytes;
constexpr int kDqSmemX = 6 * kTileBytes;
constexpr int kDqSmemSeg = kDqSmemX + kTile * kLdS * 4;
constexpr int kDqSmemRows = kDqSmemSeg + 2 * kTile * 4;
constexpr int kDqSmemBytes = kDqSmemRows + 4 * kTile * 4;  // 221,696

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ seg,
                                 const float* __restrict__ l_in, const float* __restrict__ m_in,
                                 const float* __restrict__ dout, const float* __restrict__ di,
                                 float* __restrict__ dq, int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const float* fsm = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2;
  const int r = 4 * (warp & 1) + (lane >> 3), c = 8 * ((warp >> 1) & 1) + (lane & 7);
  const int rq = tid >> 4, cq = tid & 15;
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
  const float* a_nt = fsm + (g ? kDqSmemDo : kDqSmemQ) / 4;  // Q (S) or dO (dP)
  float* xs = reinterpret_cast<float*>(smem + kDqSmemX);     // P^T, then dS^T

  for (int kt = 0; kt <= kt_diag; ++kt) {
    const int stage = kt & 1, k0 = kt * kTile;
    // Waits for this step's tiles; the barrier also marks the other stage
    // and P^T free (every warp is done with the step before) for the copy
    // below.
    cp_async_wait<0>();
    __syncthreads();
    if (kt < kt_diag) load_key_tile(stage ^ 1, kt + 1);
    cp_async_commit();
    const float* ks = fsm + (kDqSmemK + stage * kTileBytes) / 4;
    const float* vs = fsm + (kDqSmemV + stage * kTileBytes) / 4;
    const int* seg_k = reinterpret_cast<const int*>(smem + kDqSmemSeg) + stage * kTile;

    float sp[8][4];  // S (group 0) or dP (group 1)
    zero(sp);
    nt_product<8, 8, 4, 16>(sp, a_nt, r, g ? vs : ks, c);
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r + 8 * i;
        const float m_r = rows[row], rl = rows[kTile + row];
        const int seg_r = reinterpret_cast<const int*>(rows)[3 * kTile + row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c + 16 * j;
          const bool keep = k0 + col <= q0 + row && seg_k[col] == seg_r;
          xs[col * kLdS + row] = keep ? expf(sp[i][j] * scale - m_r) * rl : 0.f;
        }
      }
    }
    __syncthreads();
    if (g == 1) {
      // dS^T over P^T: each position is read and written by its own thread.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r + 8 * i;
        const float di_r = rows[2 * kTile + row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* x = xs + (c + 16 * j) * kLdS + row;
          *x = *x * (sp[i][j] - di_r) * scale;
        }
      }
    }
    __syncthreads();
    nn_product<kTile, 1>(dq_acc, xs, 4 * rq, ks, 4 * cq);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(dq + (base + q0 + 4 * rq + i) * kD + 4 * cq + 64 * h) =
          make_float4(dq_acc[i][4 * h], dq_acc[i][4 * h + 1], dq_acc[i][4 * h + 2],
                      dq_acc[i][4 * h + 3]);
}

// ---------------------------------------------------------------------------
// F2SH: dK and dV. Group g = warp / 4; its thread (r, c) = (4 (warp % 4) +
// lane / 8, lane % 8), r < 16 and c < 8, owns S^T (group 0) or dP^T (group 1)
// at key rows r + 16 i and query columns c + 8 j of a step (i, j < 4), and
// its thread (rk, ck) = (tid % 128 / 16, tid % 16) owns dV (group 0) or dK
// (group 1) at key rows 8 rk + i and columns 4 ck + 64 h + j (i < 8, j < 4,
// h < 2).
// ---------------------------------------------------------------------------
constexpr int kDkvQueries = 32;                                // queries a step
constexpr int kStepTileBytes = kDkvQueries * kLd * 4;          // 16,896
constexpr int kStatBytes = 4 * kDkvQueries * 4;                // m, l, di, segment ids
constexpr int kStageBytes = 2 * kStepTileBytes + kStatBytes;   // Q, dO, statistics
constexpr int kStepPBytes = kDkvQueries * kLdS * 4;            // 8,704
// Shared memory, in bytes: K, V, two stages, then P and dS (query rows, key
// columns).
constexpr int kDkvSmemK = 0;
constexpr int kDkvSmemV = kTileBytes;
constexpr int kDkvSmemStages = 2 * kTileBytes;
constexpr int kDkvSmemP = kDkvSmemStages + 2 * kStageBytes;
constexpr int kDkvSmemDs = kDkvSmemP + kStepPBytes;
constexpr int kDkvSmemBytes = kDkvSmemDs + kStepPBytes;  // 153,600
static_assert(kTile % kDkvQueries == 0 && 4 * (kDkvQueries / 4) <= kThreads, "F2SH steps");

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_f32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const int* __restrict__ seg,
                                  const float* __restrict__ l_in, const float* __restrict__ m_in,
                                  const float* __restrict__ dout, const float* __restrict__ di,
                                  float* __restrict__ dk, float* __restrict__ dv, int H,
                                  int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const float* fsm = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2;
  const int r = 4 * (warp & 3) + (lane >> 3), c = lane & 7;
  const int rk = (tid & (kGroupThreads - 1)) >> 4, ck = tid & 15;
  const int bh = blockIdx.x;  // b * H + h
  const int k0 = blockIdx.y * kTile;  // keys near the start see the most queries: first
  const size_t base = static_cast<size_t>(bh) * T_len;
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int n_steps = (T_len - k0) / kDkvQueries;

  auto load_step = [&](int stage, int q0) {
    const uint32_t st = s0 + kDkvSmemStages + stage * kStageBytes;
    copy_rows<kDkvQueries>(st, q + (base + q0) * kD, tid);
    copy_rows<kDkvQueries>(st + kStepTileBytes, dout + (base + q0) * kD, tid);
    constexpr int kChunks = kDkvQueries / 4;  // 16-byte chunks of one statistic
    if (tid < 4 * kChunks) {
      const int which = tid / kChunks, cc = (tid % kChunks) * 4;
      const void* src = which == 0   ? static_cast<const void*>(m_in + base + q0 + cc)
                        : which == 1 ? static_cast<const void*>(l_in + base + q0 + cc)
                        : which == 2 ? static_cast<const void*>(di + base + q0 + cc)
                                     : static_cast<const void*>(segb + q0 + cc);
      cp_async16(st + 2 * kStepTileBytes + (which * kDkvQueries + cc) * 4, src);
    }
  };

  copy_rows<kTile>(s0 + kDkvSmemK, k + (base + k0) * kD, tid);
  copy_rows<kTile>(s0 + kDkvSmemV, v + (base + k0) * kD, tid);
  load_step(0, k0);
  cp_async_commit();

  int seg_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) seg_k[i] = segb[k0 + r + 16 * i];

  float acc[8][8];  // dV (group 0) or dK (group 1)
  zero(acc);
  const float* a_nt = fsm + (g ? kDkvSmemV : kDkvSmemK) / 4;  // K (S^T) or V (dP^T)
  float* ps = reinterpret_cast<float*>(smem + kDkvSmemP);
  float* dss = reinterpret_cast<float*>(smem + kDkvSmemDs);

  for (int it = 0; it < n_steps; ++it) {
    const int stage = it & 1, q0 = k0 + it * kDkvQueries;
    // Waits for this step's tiles; the barrier also marks the other stage,
    // P and dS free (every warp is done with the step before).
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_steps) load_step(stage ^ 1, q0 + kDkvQueries);
    cp_async_commit();
    const float* qs = fsm + (kDkvSmemStages + stage * kStageBytes) / 4;
    const float* dos = qs + kStepTileBytes / 4;
    const float* stats = dos + kStepTileBytes / 4;  // m, l, di, segment ids
    const int* seg_q = reinterpret_cast<const int*>(stats + 3 * kDkvQueries);

    float st[4][4];  // S^T (group 0) or dP^T (group 1)
    zero(st);
    nt_product<4, 16, 4, 8>(st, a_nt, r, g ? dos : qs, c);
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c + 8 * j;
        const float mq = stats[col], rlq = 1.f / stats[kDkvQueries + col];
        const int sq = seg_q[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool keep = k0 + r + 16 * i <= q0 + col && seg_k[i] == sq;
          ps[col * kLdS + r + 16 * i] = keep ? expf(st[i][j] * scale - mq) * rlq : 0.f;
        }
      }
    }
    __syncthreads();
    if (g == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c + 8 * j;
        const float diq = stats[2 * kDkvQueries + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = col * kLdS + r + 16 * i;
          dss[at] = ps[at] * (st[i][j] - diq) * scale;
        }
      }
      group1_barrier();
    }
    nn_product<kDkvQueries, 2>(acc, g ? dss : ps, 8 * rk, g ? qs : dos, 4 * ck);
  }

  float* out = g ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (base + k0 + 8 * rk + i) * kD + 4 * ck;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(out + row + 64 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

bool valid_shape(int B, int H, int T_len, int D) {
  return D == kD && B > 0 && H > 0 && T_len > 0 && T_len % kTile == 0 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && T_len / kTile <= 65535;
}

}  // namespace

// q, k, v, dout: fp32 (B, H, T, 128); seg: int32 (B, T); l, m, di: fp32
// (B, H, T); dk, dv: fp32 (B, H, T, 128). Every pointer 16-byte aligned, T a
// multiple of 64. Returns a CUDA error code (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int kf_flash_bwd_dkv_f32_d128(const void* q, const void* k, const void* v,
                                         const void* seg, const void* l, const void* m,
                                         const void* dout, const void* di, void* dk, void* dv,
                                         int B, int H, int T_len, int D, float scale,
                                         void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32_d128_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dkv_f32_d128_kernel<<<grid, kThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(dout), static_cast<const float*>(di), static_cast<float*>(dk),
      static_cast<float*>(dv), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// As kf_flash_bwd_dkv_f32_d128, with dq: fp32 (B, H, T, 128) out.
extern "C" int kf_flash_bwd_dq_f32_d128(const void* q, const void* k, const void* v,
                                        const void* seg, const void* l, const void* m,
                                        const void* dout, const void* di, void* dq, int B, int H,
                                        int T_len, int D, float scale, void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_d128_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dq_f32_d128_kernel<<<grid, kThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(dout), static_cast<const float*>(di), static_cast<float*>(dq), H,
      T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// For measurement: the registers a thread, the local (spill) bytes a thread
// and the CTAs an SM of F2SH (which 0) or F3SH (which 1) at their shared
// memory.
extern "C" int kf_flash_bwd_f32_d128_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(flash_bwd_dkv_f32_d128_kernel)
                              : reinterpret_cast<const void*>(flash_bwd_dq_f32_d128_kernel);
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
