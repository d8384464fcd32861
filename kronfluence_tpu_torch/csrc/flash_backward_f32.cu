// Split flash-attention backward for fp32 (B, H, T, 64) operands, T a
// multiple of 64: F2S (dK and dV) and F3S (dQ), two deterministic kernels of
// register-tiled fp32 FMAs.
//
// Replace, for fp32 at D 64, the two TPU kernels of JAX's Pallas flash
// attention backward that kronfluence_tpu/ops/attention.py:_flash_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py, both called
// from the custom VJP :254): `_flash_attention_bwd_dkv` (:941, its
// pallas_call :1121) and `_flash_attention_bwd_dq` (:1287, its pallas_call
// :1456). F2SH and F3SH (flash_backward_f32_d128.cu) take fp32 at D 128; F2
// and F3 (flash_attention.cu) fp32 and bf16 at D 256; FB (flash_backward.cu)
// bf16 at D 64; F2H and F3H (flash_backward_d128.cu) bf16 at D 128
// (ops/kernels/flash.py:backward_route). Semantics are F2's and F3's: logits = (Q K^T) * scale,
// plus -0.7 * FLT_MAX where the key is above the diagonal or in another
// segment (such a pair's P is exactly 0, here as in the plain version); P =
// exp(logit - m) / l with F1's row max m and row sum l; dS = P * (dP - di) *
// scale with di = rowsum(O * dO) from the caller. Everything is fp32: P and dS
// are not rounded. Every output element is summed by one thread in a fixed
// order, with no atomics: two calls give the same bits.
//
// What bounds it on the H100. At B 16, H 12, T 512, D 64, padded, F2S's four
// products take 8 D FLOPs a kept query-key pair and F3S's three 6 D: 9.4 and
// 7.0 GFLOP, 0.140 and 0.105 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores, against 0.046 and 0.038 ms for their bytes at 3.35 TB/s. So the FMA
// units bound both. Both compute every 64 x 64 tile pair up to the diagonal
// (25.4 GFLOP for the pair, 0.38 ms at that peak). F2 and F3 ran fp32 through
// mma.sync's 16 x 8 x 16 layout in scalar FMAs: each thread owned 2 x 2
// outputs and read a 32-bit shared word for every FMA, and an SM issues one
// shared load a clock against four warp-FMAs, which held them near a quarter
// of the peak.
//
// What the design does about it (SGEMM's register tiling):
//  * every product is built by outer products of register fragments: each
//    thread owns 4 x 4 outputs of S and dP (F3S) or S^T and dP^T (F2S) and
//    4 x 4 of dQ (F3S) or 4 x 8 of dK and of dV (F2S), read as float4 from
//    shared memory, so one 128-bit shared load feeds 8 or more FMAs;
//  * S = Q K^T and dP = dO V^T (and S^T, dP^T) contract two row-major tiles
//    along D: a thread reads float4 runs of its rows along D ("NT" form,
//    rows r + 16 i of A, rows c + 16 j or c + 8 j of B). dQ = dS K, dV = P^T dO
//    and dK = dS^T Q contract along the keys or queries: a thread reads the
//    float4 of its 4 adjacent output rows from dS^T (or P, dS) and of its
//    output columns from K (or dO, Q) at each step ("NN" form). So K, V, Q and
//    dO are staged as they lie in device memory, and P, dS^T are written to
//    shared memory in the layout their product reads;
//  * rows are padded to 68 floats (272 bytes): the 4 (A) and 8 (B) distinct
//    rows a warp reads at one step of an NT product, and the 32 scalar
//    stores of dS^T (P, dS), fall in distinct banks; an NN step reads 4 and 8
//    adjacent float4. A warp's 4 x 8 threads share fragments, so each load is
//    one shared-memory wavefront;
//  * the streamed tiles come in by 16-byte cp.async through a two-stage ring:
//    K, V and the key segment ids in F3S, Q, dO, m, l, di and the query
//    segment ids in F2S; the next tile's copy overlaps the current tile's
//    products. The CTA's own tile (Q, dO in F3S; K, V in F2S) is loaded
//    once;
//  * F3S: one CTA of 8 warps per (64-query tile, head, batch), the last
//    query tiles (the most keys) launched first; 64-key steps from 0 to the
//    diagonal; dS^T is written over the step's V tile (dP is done with it),
//    so the CTA takes 105,984 bytes of shared memory and two fit an SM;
//  * F2S: one CTA of 4 warps per (64-key tile, head, batch), the first key
//    tiles (the most queries) launched first; 32-query steps from the
//    diagonal to T; 88,064 bytes, two CTAs an SM;
//  * exp is `expf` on the raw logit minus m (no log2 e prescale, which would
//    overflow the mask value), and the mask is a select, so masked pairs give
//    exactly 0; every barrier is reached by the whole CTA.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace kf_flash;

constexpr int kD = 64;                      // head dim
constexpr int kTile = 64;                   // F2S's keys and F3S's queries a CTA; T's granularity
constexpr int kLd = kD + 4;                 // shared row pitch in floats: 272 bytes
constexpr int kTileBytes = kTile * kLd * 4;  // 17,408

// rows x 64 fp32 from device memory (row pitch 64) into a padded shared tile
// at shared address `dst`, by kThreads threads from `tid` on.
template <int kThreads, int kRows>
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

// NT form: acc[i][j] += sum over d < 64 of A[ra + 16 i][d] * B[rb + kSB j][d],
// A and B padded shared tiles. Each step reads 4 float4 of A and 4 of B for 64
// FMAs; each output sums d in order.
template <int kSB>
__device__ __forceinline__ void nt_product(float (&acc)[4][4], const float* a, int ra,
                                           const float* b, int rb) {
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(a + (ra + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(b + (rb + kSB * j) * kLd + d);
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

// NN form: acc[i][4 h + j] += sum over k < kK of A[k][ca + i] * B[k][cb + 32 h + j]
// (i, j < 4, h < kNB), A and B padded shared tiles. Each step reads one float4
// of A and kNB of B for 16 kNB FMAs; each output sums k in order.
template <int kK, int kNB>
__device__ __forceinline__ void nn_product(float (&acc)[4][4 * kNB], const float* a, int ca,
                                           const float* b, int cb) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float4 x = ld4(a + k * kLd + ca);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int h = 0; h < kNB; ++h) {
      const float4 y = ld4(b + k * kLd + cb + 32 * h);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
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
// F3S: dQ. 8 warps; thread (r, c) = (4 (warp % 4) + lane / 8, 8 (warp / 4) +
// lane % 8), each in 0..15, owns S and dP at query rows r + 16 i and key
// columns c + 16 j, and dQ at rows 4 r + i and columns 4 c + j (i, j < 4).
// ---------------------------------------------------------------------------
constexpr int kDqThreads = 256;
// Shared memory, in bytes: Q, dO, two stages of K, two of V (dS^T is written
// over the step's V), two of the key segment ids, then the query rows' m,
// 1 / l, di and segment ids (in shared memory, not registers, so that the
// kernel fits 128 registers without spilling).
constexpr int kDqSmemQ = 0;
constexpr int kDqSmemDo = kTileBytes;
constexpr int kDqSmemK = 2 * kTileBytes;
constexpr int kDqSmemV = 4 * kTileBytes;
constexpr int kDqSmemSeg = 6 * kTileBytes;
constexpr int kDqSmemRows = kDqSmemSeg + 2 * kTile * 4;
constexpr int kDqSmemBytes = kDqSmemRows + 4 * kTile * 4;

__global__ void __launch_bounds__(kDqThreads, 2)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ seg,
                            const float* __restrict__ l_in, const float* __restrict__ m_in,
                            const float* __restrict__ dout, const float* __restrict__ di,
                            float* __restrict__ dq, int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const float* fsm = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = 4 * (warp & 3) + (lane >> 3), c = 8 * (warp >> 2) + (lane & 7);
  const int bh = blockIdx.x;  // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int kt_diag = q0 / kTile;

  auto load_key_tile = [&](int stage, int kt) {
    const size_t k0 = static_cast<size_t>(kt) * kTile;
    copy_rows<kDqThreads, kTile>(s0 + kDqSmemK + stage * kTileBytes, k + (base + k0) * kD, tid);
    copy_rows<kDqThreads, kTile>(s0 + kDqSmemV + stage * kTileBytes, v + (base + k0) * kD, tid);
    if (tid < kTile / 4) cp_async16(s0 + kDqSmemSeg + (stage * kTile + tid * 4) * 4, segb + k0 + tid * 4);
  };

  copy_rows<kDqThreads, kTile>(s0 + kDqSmemQ, q + (base + q0) * kD, tid);
  copy_rows<kDqThreads, kTile>(s0 + kDqSmemDo, dout + (base + q0) * kD, tid);
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

  float dq_acc[4][4];
  zero(dq_acc);
  const float* qs = fsm + kDqSmemQ / 4;
  const float* dos = fsm + kDqSmemDo / 4;

  for (int kt = 0; kt <= kt_diag; ++kt) {
    const int stage = kt & 1, k0 = kt * kTile;
    // Waits for this step's tiles; the barrier also marks the other stage
    // free (every warp is done with the step before) for the copy below.
    cp_async_wait<0>();
    __syncthreads();
    if (kt < kt_diag) load_key_tile(stage ^ 1, kt + 1);
    cp_async_commit();
    const float* ks = fsm + (kDqSmemK + stage * kTileBytes) / 4;
    const float* vs = fsm + (kDqSmemV + stage * kTileBytes) / 4;
    const int* seg_k = reinterpret_cast<const int*>(smem + kDqSmemSeg) + stage * kTile;

    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    nt_product<16>(s, qs, r, ks, c);
    nt_product<16>(dp, dos, r, vs, c);

    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 16 * i;
      const float m_r = rows[row], rl = rows[kTile + row], di_r = rows[2 * kTile + row];
      const int seg_r = reinterpret_cast<const int*>(rows)[3 * kTile + row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = k0 + c + 16 * j <= q0 + row && seg_k[c + 16 * j] == seg_r;
        const float p = keep ? expf(s[i][j] * scale - m_r) * rl : 0.f;
        ds[i][j] = p * (dp[i][j] - di_r) * scale;
      }
    }
    // dS^T over this step's V: every warp has read V first.
    __syncthreads();
    float* dst = reinterpret_cast<float*>(smem + kDqSmemV + stage * kTileBytes);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(c + 16 * j) * kLd + r + 16 * i] = ds[i][j];
    __syncthreads();
    nn_product<kTile, 1>(dq_acc, dst, 4 * r, ks, 4 * c);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dq + (base + q0 + 4 * r + i) * kD + 4 * c) =
        make_float4(dq_acc[i][0], dq_acc[i][1], dq_acc[i][2], dq_acc[i][3]);
}

// ---------------------------------------------------------------------------
// F2S: dK and dV. 4 warps; thread (r, c) = (4 warp + lane / 8, lane % 8) owns
// S^T and dP^T at key rows r + 16 i and query columns c + 8 j of a step, and
// dK and dV at key rows 4 r + i and columns 4 c + 32 h + j (i, j < 4, h < 2).
// ---------------------------------------------------------------------------
constexpr int kDkvThreads = 128;
constexpr int kDkvQueries = 32;  // queries a step
constexpr int kStepTileBytes = kDkvQueries * kLd * 4;           // 8,704
constexpr int kStatBytes = 4 * kDkvQueries * 4;                 // m, l, di, segment ids
constexpr int kStageBytes = 2 * kStepTileBytes + kStatBytes;    // Q, dO, statistics
// Shared memory, in bytes: K, V, two stages, then P and dS (query rows, key
// columns).
constexpr int kDkvSmemK = 0;
constexpr int kDkvSmemV = kTileBytes;
constexpr int kDkvSmemStages = 2 * kTileBytes;
constexpr int kDkvSmemP = kDkvSmemStages + 2 * kStageBytes;
constexpr int kDkvSmemDs = kDkvSmemP + kStepTileBytes;
constexpr int kDkvSmemBytes = kDkvSmemDs + kStepTileBytes;
static_assert(kTile % kDkvQueries == 0 && 4 * (kDkvQueries / 4) <= kDkvThreads, "F2S steps");

__global__ void __launch_bounds__(kDkvThreads, 2)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const int* __restrict__ seg,
                             const float* __restrict__ l_in, const float* __restrict__ m_in,
                             const float* __restrict__ dout, const float* __restrict__ di,
                             float* __restrict__ dk, float* __restrict__ dv, int H, int T_len,
                             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const float* fsm = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = 4 * warp + (lane >> 3), c = lane & 7;
  const int bh = blockIdx.x;  // b * H + h
  const int k0 = blockIdx.y * kTile;  // keys near the start see the most queries: first
  const size_t base = static_cast<size_t>(bh) * T_len;
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int n_steps = (T_len - k0) / kDkvQueries;

  auto load_step = [&](int stage, int q0) {
    const uint32_t st = s0 + kDkvSmemStages + stage * kStageBytes;
    copy_rows<kDkvThreads, kDkvQueries>(st, q + (base + q0) * kD, tid);
    copy_rows<kDkvThreads, kDkvQueries>(st + kStepTileBytes, dout + (base + q0) * kD, tid);
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

  copy_rows<kDkvThreads, kTile>(s0 + kDkvSmemK, k + (base + k0) * kD, tid);
  copy_rows<kDkvThreads, kTile>(s0 + kDkvSmemV, v + (base + k0) * kD, tid);
  load_step(0, k0);
  cp_async_commit();

  int seg_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) seg_k[i] = segb[k0 + r + 16 * i];

  float dk_acc[4][8], dv_acc[4][8];
  zero(dk_acc);
  zero(dv_acc);
  const float* ks = fsm + kDkvSmemK / 4;
  const float* vs = fsm + kDkvSmemV / 4;
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

    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    nt_product<8>(st, ks, r, qs, c);
    nt_product<8>(dpt, vs, r, dos, c);

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c + 8 * j;
      const float mq = stats[col], rlq = 1.f / stats[kDkvQueries + col];
      const float diq = stats[2 * kDkvQueries + col];
      const int sq = seg_q[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool keep = k0 + r + 16 * i <= q0 + col && seg_k[i] == sq;
        const float p = keep ? expf(st[i][j] * scale - mq) * rlq : 0.f;
        ps[col * kLd + r + 16 * i] = p;
        dss[col * kLd + r + 16 * i] = p * (dpt[i][j] - diq) * scale;
      }
    }
    __syncthreads();
    nn_product<kDkvQueries, 2>(dv_acc, ps, 4 * r, dos, 4 * c);
    nn_product<kDkvQueries, 2>(dk_acc, dss, 4 * r, qs, 4 * c);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (base + k0 + 4 * r + i) * kD + 4 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(dk + row + 32 * h) =
          make_float4(dk_acc[i][4 * h], dk_acc[i][4 * h + 1], dk_acc[i][4 * h + 2], dk_acc[i][4 * h + 3]);
      *reinterpret_cast<float4*>(dv + row + 32 * h) =
          make_float4(dv_acc[i][4 * h], dv_acc[i][4 * h + 1], dv_acc[i][4 * h + 2], dv_acc[i][4 * h + 3]);
    }
  }
}

bool valid_shape(int B, int H, int T_len, int D) {
  return D == kD && B > 0 && H > 0 && T_len > 0 && T_len % kTile == 0 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && T_len / kTile <= 65535;
}

}  // namespace

// q, k, v, dout: fp32 (B, H, T, 64); seg: int32 (B, T); l, m, di: fp32
// (B, H, T); dk, dv: fp32 (B, H, T, 64). Every pointer 16-byte aligned, T a
// multiple of 64. Returns a CUDA error code (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int kf_flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* seg,
                                    const void* l, const void* m, const void* dout, const void* di,
                                    void* dk, void* dv, int B, int H, int T_len, int D, float scale,
                                    void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dkv_f32_kernel<<<grid, kDkvThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(dout), static_cast<const float*>(di), static_cast<float*>(dk),
      static_cast<float*>(dv), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// As kf_flash_bwd_dkv_f32, with dq: fp32 (B, H, T, 64) out.
extern "C" int kf_flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* seg,
                                   const void* l, const void* m, const void* dout, const void* di,
                                   void* dq, int B, int H, int T_len, int D, float scale,
                                   void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dq_f32_kernel<<<grid, kDqThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const float*>(dout), static_cast<const float*>(di), static_cast<float*>(dq), H,
      T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// For measurement: the registers a thread, the local (spill) bytes a thread
// and the CTAs an SM of F2S (which 0) or F3S (which 1) at their shared memory.
extern "C" int kf_flash_bwd_f32_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(flash_bwd_dkv_f32_kernel)
                              : reinterpret_cast<const void*>(flash_bwd_dq_f32_kernel);
  const int threads = which == 0 ? kDkvThreads : kDqThreads;
  const int bytes = which == 0 ? kDkvSmemBytes : kDqSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads, bytes));
}
