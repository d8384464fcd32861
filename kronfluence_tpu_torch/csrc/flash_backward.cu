// Fused flash-attention backward (FB): dQ, dK and dV of causal,
// segment-masked attention in one launch, for bf16 (B, H, T, 64) operands
// with T a multiple of the key tile.
//
// Replaces, for bf16 at D 64, the two TPU kernels of JAX's Pallas flash
// attention backward that kronfluence_tpu/ops/attention.py:_flash_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py):
// `_flash_attention_bwd_dkv` (:941) and `_flash_attention_bwd_dq` (:1287).
// The port's split kernels of those two, F2 and F3 in flash_attention.cu,
// stay for D 256 (ops/kernels/flash.py:backward_route).
// Semantics are F2's and F3's: logits = (Q K^T) * scale, plus -0.7 * FLT_MAX
// where the key is above the diagonal or in another segment (such a pair's P
// is exactly 0, here as in the plain version); P = exp(logit - m) / l with
// F1's row max m and row sum l; dS = P * (dP - di) * scale with
// di = rowsum(O * dO) from the caller; P is rounded to bf16 before P^T dO and
// dS before dS^T Q and dS K, as the TPU kernels round before their products.
//
// What bounds it on the H100. At GPT-2's shape (B 16, H 12, T 512, D 64,
// padded segments) the function reads Q, K, V, dO (4 x 12.6 MB), l, m, di
// and the segment ids once and writes dQ, dK, dV (3 x 12.6 MB, bf16): about
// 89 MB, 27 us at 3.35 TB/s. Its five products take 10 D FLOPs a kept
// query-key pair, 11.7 GFLOP over 18.3 M pairs: 12 us at 989 TFLOP/s. So
// bytes bound it. This design adds the traffic of its fp32 dQ sum (zeroing,
// atomics, the cast to bf16) on top. The split pair F2 + F3 moves more (both
// read Q, K, V, dO, l, m, di), does 7 products where 5 do, builds every mma
// fragment from scalar shared loads, and loads each tile synchronously.
//
// What the design does about it (FlashAttention-2's backward on mma.sync):
//  * one CTA of kKeyTile / 16 warps per (key tile, head, batch); grid x is
//    batch x head and grid y the key tile, so the CTAs of the first key
//    tiles, which see the most queries, are launched first;
//  * K and V stay in shared memory for the whole loop; each warp owns 16
//    keys and reloads their rows of K and V as mma A fragments (ldmatrix)
//    each step, which keeps 32 registers a thread free for the accumulators;
//  * the CTA walks the query tiles from the diagonal to T. For each it
//    computes S^T = K Q^T and dP^T = V dO^T once, then P^T and dS^T in
//    registers: the accumulator layout of two neighbouring 16 x 8 tiles is
//    the A-fragment layout of a 16 x 16 operand, so dV += P^T dO and
//    dK += dS^T Q take P^T and dS^T straight from registers;
//  * dS^T also goes to shared memory once (bf16); each warp then forms dQ
//    += dS K for 16 query rows and adds it to an fp32 (B, H, T, D) sum in
//    device memory with float2 atomics (sm_90). The wrapper zeroes
//    that sum and casts it to bf16. The atomics of different key tiles land
//    in an order that changes from run to run, so dQ is not bitwise
//    reproducible; dK and dV are;
//  * every shared-memory operand of an mma is loaded with ldmatrix (.x4;
//    .trans for Q and dO as B operands, dS^T as dS, and K as the B of dS K);
//    rows are padded to 72 elements (144 bytes), so each 8-row phase of an
//    ldmatrix, and each bf16x2 store of dS^T, touches 32 different banks;
//  * the next query tile's Q, dO, l, m, di and segment ids come in by
//    cp.async (16-byte .cg copies, commit/wait groups) into the other half
//    of a double buffer while the current tile computes.
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

constexpr int kD = 64;           // head dim
constexpr int kKeyTile = 64;     // keys per CTA (a multiple of 64)
constexpr int kQueryTile = 64;   // queries per loop step
constexpr int kWarps = kKeyTile / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;      // shared row pitch in elements: 144 bytes
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes: K, V, dS^T (kKeyTile rows each), two stages of
// Q and dO (kQueryTile rows each), two stages of m, l, di and segment ids.
constexpr int kKeyRows = kKeyTile * kLd * 2;
constexpr int kQueryRows = kQueryTile * kLd * 2;
constexpr int kStatBytes = 4 * kQueryTile * 4;
constexpr int kSmemK = 0;
constexpr int kSmemV = kSmemK + kKeyRows;
constexpr int kSmemDs = kSmemV + kKeyRows;
constexpr int kSmemQ = kSmemDs + kKeyRows;
constexpr int kSmemDo = kSmemQ + 2 * kQueryRows;
constexpr int kSmemStats = kSmemDo + 2 * kQueryRows;
constexpr int kSmemBytes = kSmemStats + 2 * kStatBytes;

// dQ: the warps split the query tile into 16-row groups and, for tiles of
// more than 64 keys, D into kDqSplit column ranges.
constexpr int kDqSplit = kWarps / (kQueryTile / 16);
constexpr int kDqCols = kD / kDqSplit;

static_assert(kKeyTile % 64 == 0 && kWarps % (kQueryTile / 16) == 0, "tile shape");

// Byte offset of element (row, col) in a padded shared tile.
__device__ __forceinline__ uint32_t at(int row, int col) {
  return static_cast<uint32_t>((row * kLd + col) * 2);
}

// Registers capped at 170 a thread, so that three CTAs (12 warps) share an
// SM: the loop's phases wait on each other within a CTA, and the other CTAs
// fill those waits.
__global__ void __launch_bounds__(kThreads, 3)
    flash_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ seg,
                           const float* __restrict__ l_in, const float* __restrict__ m_in,
                           const bf16* __restrict__ dout, const float* __restrict__ di,
                           float* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;  // b * H + h
  const int k0 = blockIdx.y * kKeyTile;
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int n_tiles = (T_len - k0) / kQueryTile;

  // rows x D bf16 from device memory (row pitch D) into a padded tile.
  auto copy_rows = [&](uint32_t dst, const bf16* src, int rows) {
    for (int c = tid; c < rows * (kD / 8); c += kThreads) {
      const int r = c / (kD / 8), cc = (c % (kD / 8)) * 8;
      cp_async16(dst + at(r, cc), src + static_cast<size_t>(r) * kD + cc);
    }
  };
  auto load_query_tile = [&](int stage, int q0) {
    copy_rows(s0 + kSmemQ + stage * kQueryRows, q + (base + q0) * kD, kQueryTile);
    copy_rows(s0 + kSmemDo + stage * kQueryRows, dout + (base + q0) * kD, kQueryTile);
    constexpr int kChunks = kQueryTile / 4;  // 16-byte chunks of one statistic
    if (tid < 4 * kChunks) {
      const int which = tid / kChunks, c = (tid % kChunks) * 4;
      const void* src = which == 0   ? static_cast<const void*>(m_in + base + q0 + c)
                        : which == 1 ? static_cast<const void*>(l_in + base + q0 + c)
                        : which == 2 ? static_cast<const void*>(di + base + q0 + c)
                                     : static_cast<const void*>(segb + q0 + c);
      cp_async16(s0 + kSmemStats + stage * kStatBytes + (which * kQueryTile + c) * 4, src);
    }
  };

  copy_rows(s0 + kSmemK, k + (base + k0) * kD, kKeyTile);
  copy_rows(s0 + kSmemV, v + (base + k0) * kD, kKeyTile);
  load_query_tile(0, k0);
  cp_async_commit();

  const int kr = warp * 16;  // the warp's first key in the tile
  const int seg_k[2] = {segb[k0 + kr + g], segb[k0 + kr + g + 8]};
  cp_async_wait<0>();
  __syncthreads();

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = k0 + it * kQueryTile, stage = it & 1;
    // The other stage was last read before the previous step's second
    // barrier, so it can be refilled now.
    if (it + 1 < n_tiles) load_query_tile(stage ^ 1, q0 + kQueryTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t qs = s0 + kSmemQ + stage * kQueryRows;
    const uint32_t dos = s0 + kSmemDo + stage * kQueryRows;
    const float* stats = reinterpret_cast<const float*>(smem + kSmemStats + stage * kStatBytes);
    const int* seg_q = reinterpret_cast<const int*>(stats + 3 * kQueryTile);

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries.
    float s[kQueryTile / 8][4], dp[kQueryTile / 8][4];
#pragma unroll
    for (int j = 0; j < kQueryTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      // The warp's 16 rows of K and V, columns 16 ks .. 16 ks + 15, as A fragments.
      uint32_t ka[4], va[4];
      const uint32_t off_kv = at(kr + (lane & 15), ks * 16 + (lane >> 4) * 8);
      ldsm_x4(ka, s0 + kSmemK + off_kv);
      ldsm_x4(va, s0 + kSmemV + off_kv);
#pragma unroll
      for (int jp = 0; jp < kQueryTile / 16; ++jp) {
        // B fragments of query tiles 2 jp and 2 jp + 1: Q rows as stored.
        uint32_t bq[4], bo[4];
        const uint32_t off = at(jp * 16 + (lane >> 4) * 8 + (lane & 7), ks * 16 + ((lane >> 3) & 1) * 8);
        ldsm_x4(bq, qs + off);
        ldsm_x4(bo, dos + off);
        mma(s[2 * jp], ka, bq[0], bq[1]);
        mma(s[2 * jp + 1], ka, bq[2], bq[3]);
        mma(dp[2 * jp], va, bo[0], bo[1]);
        mma(dp[2 * jp + 1], va, bo[2], bo[3]);
      }
    }

    // P^T and dS^T, rounded to bf16 and packed as A fragments (16 keys x 16
    // queries each); dS^T also to shared memory for dQ.
    uint32_t pa[kQueryTile / 16][4], dsa[kQueryTile / 16][4];
    unsigned char* ds_smem = smem + kSmemDs;
#pragma unroll
    for (int j = 0; j < kQueryTile / 8; ++j) {
      const int c = j * 8 + 2 * t;  // the thread's first query column
      const float2 m2 = *reinterpret_cast<const float2*>(stats + c);
      const float2 l2 = *reinterpret_cast<const float2*>(stats + kQueryTile + c);
      const float2 d2 = *reinterpret_cast<const float2*>(stats + 2 * kQueryTile + c);
      const int2 sq = *reinterpret_cast<const int2*>(seg_q + c);
      const float mq[2] = {m2.x * kLog2e, m2.y * kLog2e};
      const float rl[2] = {1.f / l2.x, 1.f / l2.y};
      const float di_q[2] = {d2.x, d2.y};
      const int sqv[2] = {sq.x, sq.y};
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = e & 1;
        const bool keep = k0 + kr + g + 8 * i <= q0 + c + col && seg_k[i] == sqv[col];
        const float pv = keep ? exp2_approx(s[j][e] * scale_log2 - mq[col]) * rl[col] : 0.f;
        p[e] = pv;
        ds[e] = pv * (dp[j][e] - di_q[col]) * scale;
      }
      const int kk = j >> 1, half = (j & 1) * 2;
      pa[kk][half] = pack_bf16(p[0], p[1]);
      pa[kk][half + 1] = pack_bf16(p[2], p[3]);
      dsa[kk][half] = pack_bf16(ds[0], ds[1]);
      dsa[kk][half + 1] = pack_bf16(ds[2], ds[3]);
      *reinterpret_cast<uint32_t*>(ds_smem + at(kr + g, c)) = dsa[kk][half];
      *reinterpret_cast<uint32_t*>(ds_smem + at(kr + g + 8, c)) = dsa[kk][half + 1];
    }

    // dV += P^T dO and dK += dS^T Q: B fragments of D tiles 2 np and
    // 2 np + 1, dO and Q transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kQueryTile / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t bo[4], bq[4];
        const uint32_t off = at(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), np * 16 + (lane >> 4) * 8);
        ldsm_x4_t(bo, dos + off);
        ldsm_x4_t(bq, qs + off);
        mma(dv_acc[2 * np], pa[kk], bo[0], bo[1]);
        mma(dv_acc[2 * np + 1], pa[kk], bo[2], bo[3]);
        mma(dk_acc[2 * np], dsa[kk], bq[0], bq[1]);
        mma(dk_acc[2 * np + 1], dsa[kk], bq[2], bq[3]);
      }
    __syncthreads();  // dS^T is complete

    // dQ (16 query rows x kDqCols of D per warp) = dS K over the key tile,
    // added to the fp32 sum.
    const int qw = (warp % (kQueryTile / 16)) * 16, dw = (warp / (kQueryTile / 16)) * kDqCols;
    float dq_acc[kDqCols / 8][4];
#pragma unroll
    for (int n = 0; n < kDqCols / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, s0 + kSmemDs + at(kk * 16 + (lane >> 4) * 8 + (lane & 7), qw + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int np = 0; np < kDqCols / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, s0 + kSmemK +
                          at(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), dw + np * 16 + (lane >> 4) * 8));
        mma(dq_acc[2 * np], a, bk[0], bk[1]);
        mma(dq_acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    float* dq_rows = dq + (base + q0 + qw + g) * kD + dw + 2 * t;
#pragma unroll
    for (int n = 0; n < kDqCols / 8; ++n) {
      atomicAdd(reinterpret_cast<float2*>(dq_rows + n * 8), make_float2(dq_acc[n][0], dq_acc[n][1]));
      atomicAdd(reinterpret_cast<float2*>(dq_rows + 8 * kD + n * 8),
                make_float2(dq_acc[n][2], dq_acc[n][3]));
    }
    // The next step's first barrier keeps dS^T until every warp has read it.
  }

  bf16* dk_rows = dk + (base + k0 + kr + g) * kD + 2 * t;
  bf16* dv_rows = dv + (base + k0 + kr + g) * kD + 2 * t;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(dk_rows + n * 8) = pack_bf16(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dk_rows + 8 * kD + n * 8) = pack_bf16(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<uint32_t*>(dv_rows + n * 8) = pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dv_rows + 8 * kD + n * 8) = pack_bf16(dv_acc[n][2], dv_acc[n][3]);
  }
}

}  // namespace

// q, k, v, dout: bf16 (B, H, T, 64); seg: int32 (B, T); l, m, di: fp32
// (B, H, T); dq: an fp32 (B, H, T, 64) sum the caller has zeroed; dk, dv:
// bf16 (B, H, T, 64). Every pointer 16-byte aligned. Returns a CUDA error
// code (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int kf_flash_bwd_fused(const void* q, const void* k, const void* v, const void* seg,
                                  const void* l, const void* m, const void* dout, const void* di,
                                  void* dq, void* dk, void* dv, int B, int H, int T_len, int D,
                                  float scale, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || T_len <= 0 || T_len % kKeyTile ||
      static_cast<long long>(B) * H > 0x7fffffffLL || T_len / kKeyTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kKeyTile);
  flash_bwd_fused_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(l), static_cast<const float*>(m),
      static_cast<const bf16*>(dout), static_cast<const float*>(di), static_cast<float*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}
