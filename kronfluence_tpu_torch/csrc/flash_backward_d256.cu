// Split flash-attention backward for bf16 (B, H, T, 256) operands, T a
// multiple of 64: F2W (dK and dV) and F3W (dQ), two deterministic kernels.
//
// Replace, for bf16 at D 256 (the Gemma family's heads), the two TPU kernels
// of JAX's Pallas flash attention backward that kronfluence_tpu/ops/
// attention.py:_flash_attention reaches (jax/experimental/pallas/ops/tpu/
// flash_attention.py, both called from the custom VJP :254):
// `_flash_attention_bwd_dkv` (:941, its pallas_call :1121) and
// `_flash_attention_bwd_dq` (:1287, its pallas_call :1456). The port's first
// split pair, F2 and F3 in flash_attention.cu, took this case before and stays
// callable as the yardstick (ops/kernels/flash.py:backward_route). Semantics
// are F2's and F3's: logits = (Q K^T) * scale, plus -0.7 * FLT_MAX where the
// key is above the diagonal or in another segment (such a pair's P is exactly
// 0, here as in the plain version); P = exp(logit - m) / l with F1's row max m
// and row sum l; dS = P * (dP - di) * scale with di = rowsum(O * dO) from the
// caller; P is rounded to bf16 before P^T dO and dS before dS^T Q and dS K.
// Every output element is summed by one thread in a fixed order, with no
// atomics: two calls give the same bits.
//
// What bounds it on the H100. At Gemma-2B's heads (H 8 after the MQA repeat,
// T 512, D 256, unpadded) each (b, h) pair holds 131,328 kept query-key
// pairs; F2W reads Q, K, V, dO, l, m and di and writes dK and dV, 1.58 MB a
// pair, and does 8 D FLOPs a kept pair (S^T, dP^T, dV, dK), 0.27 GFLOP;
// F3W moves 1.32 MB a pair for 6 D FLOPs a kept pair. At 3.35 TB/s and 989
// TFLOP/s that is 0.47 us against 0.27 us (F2W) and 0.39 against 0.20 (F3W)
// a pair: bytes bound both. What holds an mma.sync design far above that is
// the shared-memory traffic of the operand fragments: every ldmatrix.x4
// feeds two to four m16n8k16 products, so the 128 bytes a clock an SM's
// shared memory hands out, not the tensor cores, set the pace. F2 and F3
// built every fragment from scalar shared loads, loaded each tile
// synchronously between two barriers, paid an expf and a division per
// probability, and at D 256 dropped to 32-row inner tiles.
//
// What the design does about it: F2H's and F3H's design
// (flash_backward_d128.cu) carried to D 256, and no more:
//  * every mma operand comes from shared memory by ldmatrix (.x4; .trans for
//    the B operands of P^T dO, dS^T Q and dS K); rows are padded to 264
//    elements (528 bytes), so each 8-row phase of an ldmatrix touches 32
//    different banks;
//  * exp2 on the MUFU unit with log2 e-scaled m, and 1/l once per row;
//  * tiles come in by cp.async (16-byte .cg copies) into two-stage rings, one
//    barrier a step; that barrier is also a vote (__syncthreads_and) that
//    applies the mask only where the causal diagonal crosses the step or the
//    segment ids of the two tiles are not all one id; 16-row blocks above the
//    diagonal are skipped;
//  * F2W: one CTA of 8 warps per (64-key tile, head, batch), the first key
//    tiles (the most queries) launched first. dK and dV of 16 keys over all of
//    D would take 256 fp32 registers a thread, past the cap of 255, so two
//    warps share each 16-key group, each holding dK and dV for half of D's
//    columns (128 registers). S^T and dP^T need the whole D sum: each warp of
//    the pair forms them for half of the step's 64 queries over all of D,
//    rounds P^T and dS^T to bf16 into shared memory, and after a barrier of
//    the pair both read the step's 64 back by ldmatrix (forming them for all
//    queries in each warp of the pair, in registers, computes them twice and
//    measured slower: PERF.md).
//    K and V stay in shared memory; the CTA walks the query tiles
//    from the diagonal to T, Q, dO, m, l, di and the segment ids of the next
//    tile in flight;
//  * F3W: one CTA of 4 warps per (64-query tile, head, batch), the last query
//    tiles (the most keys) launched first. Q and dO stay in shared memory and
//    their fragments are read again by ldmatrix at each key step, m, l and di
//    in registers; each warp owns 16 query rows over all of D (dQ 128
//    registers a thread), so a step is 32 keys (S and dP 32 registers) and dS
//    goes from the S and dP accumulators straight into the A fragments of dS K
//    (the accumulator layout of two neighbouring 16 x 8 tiles is the
//    A-fragment layout of a 16 x 16 operand). The CTA walks the 32-key steps
//    from 0 to the diagonal, K, V and their segment ids in a two-stage ring;
//  * dK, dV and dQ are staged as bf16 in rows of K, V or Q that only the
//    warp (and its pair) read, and written with 16-byte stores.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace kf_flash;
using bf16 = __nv_bfloat16;

constexpr int kD = 256;       // head dim
constexpr int kTile = 64;     // F2W's keys and F3W's queries a CTA; T's granularity
constexpr int kLd = kD + 8;   // shared row pitch in elements: 528 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowBytes = kLd * 2;
constexpr int kTileBytes = kTile * kRowBytes;

// Byte offset of element (row, col) in a padded shared tile.
__device__ __forceinline__ uint32_t at(int row, int col) {
  return static_cast<uint32_t>((row * kLd + col) * 2);
}

// rows x D bf16 from device memory (row pitch D) into a padded shared tile,
// `threads` threads from `tid` on.
template <int kThreads>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src, int rows, int tid) {
  for (int c = tid; c < rows * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), cc = (c % (kD / 8)) * 8;
    cp_async16(dst + at(r, cc), src + static_cast<size_t>(r) * kD + cc);
  }
}

// Columns c0 .. c0 + kCols - 1 of the warp's 16 rows of a padded shared tile
// (from row `r0`) to device memory (row pitch D) with 16-byte stores.
template <int kCols>
__device__ __forceinline__ void store_rows(bf16* dst, const unsigned char* tile, int r0, int c0,
                                           int lane) {
#pragma unroll
  for (int c = lane; c < 16 * (kCols / 8); c += 32) {
    const int r = c / (kCols / 8), cc = c0 + (c % (kCols / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * kD + cc) =
        *reinterpret_cast<const uint4*>(tile + at(r0 + r, cc));
  }
}

// Accumulators (16 rows x kCols, mma's C layout) as bf16 into rows r0 .. r0 +
// 15, columns c0 .., of a padded shared tile.
template <int kCols>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int r0, int c0,
                                           const float (&acc)[kCols / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    const int col = c0 + n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + at(r0 + g, col)) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(tile + at(r0 + g + 8, col)) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// F2W: dK and dV.
// ---------------------------------------------------------------------------
// 8 warps, two a 16-key group, each holding dK and dV over half of D. 64
// queries a step: each warp forms S^T and dP^T for half of them and the pair
// trades P^T and dS^T through shared memory.
constexpr int kDkvQueries = 64;                    // queries a loop step
constexpr int kDkvStepQueries = kDkvQueries / 2;   // S^T's columns a warp
constexpr int kDkvStages = 2;                      // query tiles in the ring
constexpr int kDkvWarps = 2 * (kTile / 16);
constexpr int kDkvThreads = 32 * kDkvWarps;
constexpr int kDkvCols = kD / 2;  // D columns of dK and dV a warp
// Shared memory, in bytes: K, V (kTile rows each), then kDkvStages stages of
// Q and dO (kDkvQueries rows each) and m, l, di and the segment ids; then
// P^T and dS^T (kTile rows of kDkvQueries + 8, 16 bytes of pad).
constexpr int kDkvQueryBytes = kDkvQueries * kRowBytes;
constexpr int kDkvStatBytes = 4 * kDkvQueries * 4;
constexpr int kDkvStageBytes = 2 * kDkvQueryBytes + kDkvStatBytes;
constexpr int kPtLd = kDkvQueries + 8;
constexpr int kPtBytes = kTile * kPtLd * 2;
constexpr int kDkvSmemK = 0;
constexpr int kDkvSmemV = kTileBytes;
constexpr int kDkvSmemStages = 2 * kTileBytes;
constexpr int kDkvSmemPt = kDkvSmemStages + kDkvStages * kDkvStageBytes;
constexpr int kDkvSmemDst = kDkvSmemPt + kPtBytes;
constexpr int kDkvSmemBytes = kDkvSmemDst + kPtBytes;
static_assert(kDkvSmemBytes <= 232448, "F2W's shared memory");
static_assert(kDkvStages >= 2 && kTile % kDkvQueries == 0, "F2W tiles");
static_assert(4 * (kDkvQueries / 4) <= kDkvThreads, "F2W statistics copy");

// Byte offset of element (row, col) in the P^T or dS^T tile.
__device__ __forceinline__ uint32_t pt_at(int row, int col) {
  return static_cast<uint32_t>((row * kPtLd + col) * 2);
}

// The two warps of a 16-key group wait for each other (named barriers 1-4;
// 0 is __syncthreads').
__device__ __forceinline__ void pair_sync(int kr) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + kr / 16) : "memory");
}

// One query step for one warp's 16 keys: S^T = K Q^T and dP^T = V dO^T over
// the warp's half of the step's queries and all of D, then P^T and dS^T
// traded with the pair through shared memory, dV += P^T dO and dK += dS^T Q
// over the step's queries and the warp's half of D's columns. Query 16-blocks
// before `jp_first` lie wholly above the warp's keys and are skipped. kMasked
// applies the causal and segment mask per element. `half` picks the warp's
// query columns and D columns.
template <bool kMasked>
__device__ __forceinline__ void dkv_step(uint32_t s0, unsigned char* smem, uint32_t qs, uint32_t dos,
                                         const float* stats, int key, int q0, int jp_first,
                                         const int (&seg_k)[2], float scale, float scale_log2,
                                         float (&dk_acc)[kDkvCols / 8][4],
                                         float (&dv_acc)[kDkvCols / 8][4], int kr, int half,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int jq0 = half * (kDkvStepQueries / 16);  // the warp's first query 16-block
  float s[kDkvStepQueries / 8][4], dp[kDkvStepQueries / 8][4];
#pragma unroll
  for (int j = 0; j < kDkvStepQueries / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    // The warp's 16 rows of K and V, columns 16 kk .. 16 kk + 15, as A fragments.
    uint32_t ka[4], va[4];
    const uint32_t off_kv = at(kr + (lane & 15), kk * 16 + (lane >> 4) * 8);
    ldsm_x4(ka, s0 + kDkvSmemK + off_kv);
    ldsm_x4(va, s0 + kDkvSmemV + off_kv);
#pragma unroll
    for (int jp = 0; jp < kDkvStepQueries / 16; ++jp) {
      if (kMasked && jq0 + jp < jp_first) continue;
      // B fragments of query tiles 2 jp and 2 jp + 1: Q and dO rows as stored.
      uint32_t bq[4], bo[4];
      const uint32_t off =
          at((jq0 + jp) * 16 + (lane >> 4) * 8 + (lane & 7), kk * 16 + ((lane >> 3) & 1) * 8);
      ldsm_x4(bq, qs + off);
      ldsm_x4(bo, dos + off);
      mma(s[2 * jp], ka, bq[0], bq[1]);
      mma(s[2 * jp + 1], ka, bq[2], bq[3]);
      mma(dp[2 * jp], va, bo[0], bo[1]);
      mma(dp[2 * jp + 1], va, bo[2], bo[3]);
    }
  }

  // P^T and dS^T, rounded to bf16, into the pair's shared tiles.
  const int* seg_q = reinterpret_cast<const int*>(stats + 3 * kDkvQueries);
#pragma unroll
  for (int j = 0; j < kDkvStepQueries / 8; ++j) {
    const int c = jq0 * 16 + j * 8 + 2 * t;  // the thread's first query column
    const float2 m2 = *reinterpret_cast<const float2*>(stats + c);
    const float2 l2 = *reinterpret_cast<const float2*>(stats + kDkvQueries + c);
    const float2 d2 = *reinterpret_cast<const float2*>(stats + 2 * kDkvQueries + c);
    const float mq[2] = {m2.x * kLog2e, m2.y * kLog2e};
    const float rl[2] = {1.f / l2.x, 1.f / l2.y};
    const float di_q[2] = {d2.x, d2.y};
    int sqv[2] = {0, 0};
    if (kMasked) {
      const int2 sq = *reinterpret_cast<const int2*>(seg_q + c);
      sqv[0] = sq.x;
      sqv[1] = sq.y;
    }
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, col = e & 1;
      const bool keep = !kMasked || (key + g + 8 * i <= q0 + c + col && seg_k[i] == sqv[col]);
      const float pv = keep ? exp2_approx(s[j][e] * scale_log2 - mq[col]) * rl[col] : 0.f;
      p[e] = pv;
      ds[e] = pv * (dp[j][e] - di_q[col]) * scale;
    }
    *reinterpret_cast<uint32_t*>(smem + kDkvSmemPt + pt_at(kr + g, c)) = pack_bf16(p[0], p[1]);
    *reinterpret_cast<uint32_t*>(smem + kDkvSmemPt + pt_at(kr + g + 8, c)) = pack_bf16(p[2], p[3]);
    *reinterpret_cast<uint32_t*>(smem + kDkvSmemDst + pt_at(kr + g, c)) = pack_bf16(ds[0], ds[1]);
    *reinterpret_cast<uint32_t*>(smem + kDkvSmemDst + pt_at(kr + g + 8, c)) = pack_bf16(ds[2], ds[3]);
  }
  pair_sync(kr);

  // dV += P^T dO and dK += dS^T Q: P^T and dS^T over the whole step come back
  // from shared memory as A fragments; B fragments of D tiles 2 np and 2 np + 1
  // of the warp's columns, dO and Q transposed by ldmatrix.
#pragma unroll
  for (int kk = 0; kk < kDkvQueries / 16; ++kk) {
    if (kMasked && kk < jp_first) continue;
    uint32_t ap[4], ads[4];
    const uint32_t off_p = pt_at(kr + (lane & 15), kk * 16 + (lane >> 4) * 8);
    ldsm_x4(ap, s0 + kDkvSmemPt + off_p);
    ldsm_x4(ads, s0 + kDkvSmemDst + off_p);
#pragma unroll
    for (int np = 0; np < kDkvCols / 16; ++np) {
      uint32_t bo[4], bq[4];
      const uint32_t off = at(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                              half * kDkvCols + np * 16 + (lane >> 4) * 8);
      ldsm_x4_t(bo, dos + off);
      ldsm_x4_t(bq, qs + off);
      mma(dv_acc[2 * np], ap, bo[0], bo[1]);
      mma(dv_acc[2 * np + 1], ap, bo[2], bo[3]);
      mma(dk_acc[2 * np], ads, bq[0], bq[1]);
      mma(dk_acc[2 * np + 1], ads, bq[2], bq[3]);
    }
  }
}

__global__ void __launch_bounds__(kDkvThreads)
    flash_bwd_dkv_d256_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const int* __restrict__ seg,
                              const float* __restrict__ l_in, const float* __restrict__ m_in,
                              const bf16* __restrict__ dout, const float* __restrict__ di,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T_len,
                              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int bh = blockIdx.x;  // b * H + h
  const int k0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int n_tiles = (T_len - k0) / kDkvQueries;

  auto load_query_tile = [&](int stage, int q0) {
    const uint32_t st = s0 + kDkvSmemStages + stage * kDkvStageBytes;
    copy_rows<kDkvThreads>(st, q + (base + q0) * kD, kDkvQueries, tid);
    copy_rows<kDkvThreads>(st + kDkvQueryBytes, dout + (base + q0) * kD, kDkvQueries, tid);
    constexpr int kChunks = kDkvQueries / 4;  // 16-byte chunks of one statistic
    if (tid < 4 * kChunks) {
      const int which = tid / kChunks, c = (tid % kChunks) * 4;
      const void* src = which == 0   ? static_cast<const void*>(m_in + base + q0 + c)
                        : which == 1 ? static_cast<const void*>(l_in + base + q0 + c)
                        : which == 2 ? static_cast<const void*>(di + base + q0 + c)
                                     : static_cast<const void*>(segb + q0 + c);
      cp_async16(st + 2 * kDkvQueryBytes + (which * kDkvQueries + c) * 4, src);
    }
  };

  copy_rows<kDkvThreads>(s0 + kDkvSmemK, k + (base + k0) * kD, kTile, tid);
  copy_rows<kDkvThreads>(s0 + kDkvSmemV, v + (base + k0) * kD, kTile, tid);
#pragma unroll
  for (int st = 0; st < kDkvStages - 1; ++st) {
    if (st < n_tiles) load_query_tile(st, k0 + st * kDkvQueries);
    cp_async_commit();
  }

  // The warp's first key in the tile, and its half of D and of the step's
  // queries.
  const int kr = (warp >> 1) * 16, half = warp & 1;
  const int seg_k[2] = {segb[k0 + kr + g], segb[k0 + kr + g + 8]};
  // Whether the key tile holds one segment id, the one of its first key.
  const int seg_first = segb[k0];
  const bool k_one = __syncthreads_and(tid >= kTile || segb[k0 + tid] == seg_first) != 0;

  float dk_acc[kDkvCols / 8][4], dv_acc[kDkvCols / 8][4];
#pragma unroll
  for (int n = 0; n < kDkvCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = k0 + it * kDkvQueries, stage = it % kDkvStages;
    const uint32_t st = s0 + kDkvSmemStages + stage * kDkvStageBytes;
    const float* stats =
        reinterpret_cast<const float*>(smem + kDkvSmemStages + stage * kDkvStageBytes + 2 * kDkvQueryBytes);
    // Waits for this step's tile. The barrier is the vote (does the query
    // tile hold the key tile's one segment id?) and marks the stage read in
    // the step before, and the P^T and dS^T tiles, free again.
    cp_async_wait<kDkvStages - 2>();
    bool one = true;
    constexpr int kSegThread = 3 * (kDkvQueries / 4);  // the first thread that copies segment ids
    if (tid >= kSegThread && tid < kSegThread + kDkvQueries / 4) {
      // The thread's own 16-byte copy is visible to it.
      const int4 s4 = *reinterpret_cast<const int4*>(stats + 3 * kDkvQueries + (tid - kSegThread) * 4);
      one = s4.x == seg_first && s4.y == seg_first && s4.z == seg_first && s4.w == seg_first;
    }
    // Every thread reaches the barrier (no short circuit through k_one).
    const bool q_one = __syncthreads_and(one) != 0;
    const bool uniform = k_one && q_one;
    const int next = it + kDkvStages - 1;
    if (next < n_tiles) load_query_tile(next % kDkvStages, k0 + next * kDkvQueries);
    cp_async_commit();

    // The first query 16-block with a query at or past the warp's first key
    // (the same for both warps of a pair, so both skip or both trade).
    const int jp_first = max(0, (k0 + kr - q0) / 16);
    if (jp_first >= kDkvQueries / 16) continue;  // a step wholly above the 16-key group
    const uint32_t qs = st, dos = st + kDkvQueryBytes;
    if (uniform && q0 >= k0 + kTile)
      dkv_step<false>(s0, smem, qs, dos, stats, k0 + kr, q0, 0, seg_k, scale, scale_log2, dk_acc,
                      dv_acc, kr, half, lane);
    else
      dkv_step<true>(s0, smem, qs, dos, stats, k0 + kr, q0, jp_first, seg_k, scale, scale_log2,
                     dk_acc, dv_acc, kr, half, lane);
  }

  // dK and dV in bf16, staged in the pair's rows of K and V (only this pair
  // reads them; each warp writes its half of the columns once both are done
  // with the last step), then 16-byte stores.
  __syncwarp();
  pair_sync(kr);
  stage_rows<kDkvCols>(smem + kDkvSmemK, kr, half * kDkvCols, dk_acc, lane);
  stage_rows<kDkvCols>(smem + kDkvSmemV, kr, half * kDkvCols, dv_acc, lane);
  __syncwarp();
  store_rows<kDkvCols>(dk + (base + k0 + kr) * kD, smem + kDkvSmemK, kr, half * kDkvCols, lane);
  store_rows<kDkvCols>(dv + (base + k0 + kr) * kD, smem + kDkvSmemV, kr, half * kDkvCols, lane);
}

// ---------------------------------------------------------------------------
// F3W: dQ.
// ---------------------------------------------------------------------------
constexpr int kDqWarps = kTile / 16;
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kDqKeys = 32;  // keys a loop step
constexpr int kDqKeyBytes = kDqKeys * kRowBytes;
// Shared memory, in bytes: Q, dO (kTile rows each), two stages of K, V
// (kDqKeys rows each) and the key segment ids.
constexpr int kSegBytes = kDqKeys * 4;
constexpr int kDqSmemQ = 0;
constexpr int kDqSmemDo = kTileBytes;
constexpr int kDqSmemK = 2 * kTileBytes;
constexpr int kDqSmemV = kDqSmemK + 2 * kDqKeyBytes;
constexpr int kDqSmemSeg = kDqSmemV + 2 * kDqKeyBytes;
constexpr int kDqSmemBytes = kDqSmemSeg + 2 * kSegBytes;
static_assert(kDqSmemBytes <= 232448 && kTile % kDqKeys == 0 && kDqKeys % 16 == 0, "F3W tiles");

// One key step for one warp's 16 query rows: S = Q K^T and dP = dO V^T, dS in
// registers, dQ += dS K. Thread (g, t) holds rows `row` and `row` + 8. Key
// 16-blocks after `jp_last` lie wholly above the warp's rows and are skipped.
// kMasked applies the causal and segment mask per element.
template <bool kMasked>
__device__ __forceinline__ void dq_step(uint32_t qs, uint32_t dos, uint32_t ks, uint32_t vs,
                                        const int* seg_k, int k0, int row, int jp_last,
                                        const int (&seg_r)[2], const float (&m_log2)[2],
                                        const float (&rl)[2], const float (&di_r)[2], float scale,
                                        float scale_log2, float (&dq_acc)[kD / 8][4], int rw,
                                        int lane) {
  const int t = lane & 3;
  float s[kDqKeys / 8][4], dp[kDqKeys / 8][4];
#pragma unroll
  for (int j = 0; j < kDqKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    // The warp's 16 rows of Q and dO, columns 16 kk .. 16 kk + 15, as A fragments.
    uint32_t qa[4], oa[4];
    const uint32_t off_q = at(rw + (lane & 15), kk * 16 + (lane >> 4) * 8);
    ldsm_x4(qa, qs + off_q);
    ldsm_x4(oa, dos + off_q);
#pragma unroll
    for (int jp = 0; jp < kDqKeys / 16; ++jp) {
      if (kMasked && jp > jp_last) continue;
      // B fragments of key tiles 2 jp and 2 jp + 1: K and V rows as stored.
      uint32_t bk[4], bv[4];
      const uint32_t off = at(jp * 16 + (lane >> 4) * 8 + (lane & 7), kk * 16 + ((lane >> 3) & 1) * 8);
      ldsm_x4(bk, ks + off);
      ldsm_x4(bv, vs + off);
      mma(s[2 * jp], qa, bk[0], bk[1]);
      mma(s[2 * jp + 1], qa, bk[2], bk[3]);
      mma(dp[2 * jp], oa, bv[0], bv[1]);
      mma(dp[2 * jp + 1], oa, bv[2], bv[3]);
    }
  }

  // dS, rounded to bf16 and packed as A fragments (16 rows x 16 keys each).
  uint32_t dsa[kDqKeys / 16][4];
#pragma unroll
  for (int j = 0; j < kDqKeys / 8; ++j) {
    const int c = j * 8 + 2 * t;  // the thread's first key column
    int2 sk = make_int2(0, 0);
    if (kMasked) sk = *reinterpret_cast<const int2*>(seg_k + c);
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, col = e & 1;
      const bool keep = !kMasked || (k0 + c + col <= row + 8 * i && (col ? sk.y : sk.x) == seg_r[i]);
      const float p = keep ? exp2_approx(s[j][e] * scale_log2 - m_log2[i]) * rl[i] : 0.f;
      ds[e] = p * (dp[j][e] - di_r[i]) * scale;
    }
    dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
    dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
  }

  // dQ += dS K: B fragments of D tiles 2 np and 2 np + 1, K transposed by ldmatrix.
#pragma unroll
  for (int kk = 0; kk < kDqKeys / 16; ++kk) {
    if (kMasked && kk > jp_last) continue;
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, ks + at(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), np * 16 + (lane >> 4) * 8));
      mma(dq_acc[2 * np], dsa[kk], b[0], b[1]);
      mma(dq_acc[2 * np + 1], dsa[kk], b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_d256_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ seg,
                             const float* __restrict__ l_in, const float* __restrict__ m_in,
                             const bf16* __restrict__ dout, const float* __restrict__ di,
                             bf16* __restrict__ dq, int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int bh = blockIdx.x;  // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int rw = warp * 16;  // the warp's first row in the tile
  const int last = (q0 + kTile) / kDqKeys - 1;  // the last key step: the diagonal's second half

  auto load_key_step = [&](int stage, int kt) {
    const int k0 = kt * kDqKeys;
    copy_rows<kDqThreads>(s0 + kDqSmemK + stage * kDqKeyBytes, k + (base + k0) * kD, kDqKeys, tid);
    copy_rows<kDqThreads>(s0 + kDqSmemV + stage * kDqKeyBytes, v + (base + k0) * kD, kDqKeys, tid);
    if (tid < kDqKeys / 4) cp_async16(s0 + kDqSmemSeg + stage * kSegBytes + tid * 16, segb + k0 + tid * 4);
  };

  copy_rows<kDqThreads>(s0 + kDqSmemQ, q + (base + q0) * kD, kTile, tid);
  copy_rows<kDqThreads>(s0 + kDqSmemDo, dout + (base + q0) * kD, kTile, tid);
  load_key_step(0, 0);
  cp_async_commit();

  // Whether the query tile holds one segment id, the one of its first row.
  const int seg_first = segb[q0];
  const bool q_one = tid >= kTile || segb[q0 + tid] == seg_first;
  const int row = q0 + rw + g;
  const int seg_r[2] = {segb[row], segb[row + 8]};
  float m_log2[2], rl[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = base + row + 8 * i;
    m_log2[i] = m_in[r] * kLog2e;
    rl[i] = 1.f / l_in[r];
    di_r[i] = di[r];
  }
  // Waits for the step in `stage` and returns, for the whole CTA, whether the
  // query tile and that step's keys hold one segment id. The barrier also
  // marks the other stage free: every warp is done with the step before.
  auto arrive = [&](int stage) {
    cp_async_wait<0>();
    bool one = q_one;
    if (tid < kDqKeys / 4) {  // the thread's own 16-byte copy is visible to it
      const int4 s4 = *reinterpret_cast<const int4*>(smem + kDqSmemSeg + stage * kSegBytes + tid * 16);
      one = one && s4.x == seg_first && s4.y == seg_first && s4.z == seg_first && s4.w == seg_first;
    }
    return __syncthreads_and(one) != 0;
  };
  bool uniform = arrive(0);

  float dq_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int kt = 0; kt <= last; ++kt) {
    const int stage = kt & 1, k0 = kt * kDqKeys;
    if (kt < last) load_key_step(stage ^ 1, kt + 1);
    cp_async_commit();
    const uint32_t ks = s0 + kDqSmemK + stage * kDqKeyBytes, vs = s0 + kDqSmemV + stage * kDqKeyBytes;
    const int* seg_k = reinterpret_cast<const int*>(smem + kDqSmemSeg + stage * kSegBytes);
    // The last key 16-block at or below the warp's last row; a step wholly
    // above the warp's rows (the diagonal's second half for the first warps)
    // is skipped.
    const int jp_last = (q0 + rw - k0) >> 4;
    if (uniform && k0 + kDqKeys <= q0)
      dq_step<false>(s0 + kDqSmemQ, s0 + kDqSmemDo, ks, vs, seg_k, k0, row, kDqKeys / 16 - 1,
                     seg_r, m_log2, rl, di_r, scale, scale_log2, dq_acc, rw, lane);
    else if (jp_last >= 0)
      dq_step<true>(s0 + kDqSmemQ, s0 + kDqSmemDo, ks, vs, seg_k, k0, row,
                    min(jp_last, kDqKeys / 16 - 1), seg_r, m_log2, rl, di_r, scale, scale_log2,
                    dq_acc, rw, lane);
    if (kt < last) uniform = arrive(stage ^ 1);
  }

  // dQ in bf16, staged in the warp's own rows of the Q tile (only this warp
  // read them), then 16-byte stores of whole rows.
  __syncwarp();
  stage_rows<kD>(smem + kDqSmemQ, rw, 0, dq_acc, lane);
  __syncwarp();
  store_rows<kD>(dq + (base + q0 + rw) * kD, smem + kDqSmemQ, rw, 0, lane);
}

bool valid_shape(int B, int H, int T_len, int D) {
  return D == kD && B > 0 && H > 0 && T_len > 0 && T_len % kTile == 0 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && T_len / kTile <= 65535;
}

}  // namespace

// q, k, v, dout: bf16 (B, H, T, 256); seg: int32 (B, T); l, m, di: fp32
// (B, H, T); dk, dv: bf16 (B, H, T, 256). Every pointer 16-byte aligned, T a
// multiple of 64. Returns a CUDA error code (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int kf_flash_bwd_dkv_d256(const void* q, const void* k, const void* v, const void* seg,
                                     const void* l, const void* m, const void* dout, const void* di,
                                     void* dk, void* dv, int B, int H, int T_len, int D, float scale,
                                     void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dkv_d256_kernel<<<grid, kDkvThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const bf16*>(dout), static_cast<const float*>(di), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// As kf_flash_bwd_dkv_d256, with dq: bf16 (B, H, T, 256) out.
extern "C" int kf_flash_bwd_dq_d256(const void* q, const void* k, const void* v, const void* seg,
                                    const void* l, const void* m, const void* dout, const void* di,
                                    void* dq, int B, int H, int T_len, int D, float scale,
                                    void* stream) {
  if (!valid_shape(B, H, T_len, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_bwd_dq_d256_kernel<<<grid, kDqThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const bf16*>(dout), static_cast<const float*>(di), static_cast<bf16*>(dq), H,
      T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// For measurement: the registers a thread, the local (spill) bytes a thread
// and the CTAs an SM of F2W (which 0) or F3W (which 1) at their shared memory.
extern "C" int kf_flash_bwd_d256_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(flash_bwd_dkv_d256_kernel)
                              : reinterpret_cast<const void*>(flash_bwd_dq_d256_kernel);
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
