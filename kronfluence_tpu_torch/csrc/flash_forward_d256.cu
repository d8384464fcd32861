// FFW: the flash-attention forward for bf16 (B, H, T, 256) operands, T a
// multiple of 128: O, and the row max m and row sum l, of causal,
// segment-masked attention in one launch, on wgmma fed by a TMA ring.
//
// Replaces, for bf16 at D 256 (the Gemma family's heads), the TPU kernel of
// JAX's Pallas flash attention forward that
// kronfluence_tpu/ops/attention.py:_flash_attention reaches
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
// `_flash_attention_impl` (:589, its pallas_call :758). F1 in
// flash_attention.cu keeps that work at fp32 D 64 and stays callable at bf16
// D 256 as the yardstick (ops/kernels/flash.py:forward_route). Semantics are
// F1's and FF's: logits = (Q K^T) * scale, plus -0.7 * FLT_MAX where the key
// is above the diagonal or in another segment (such a pair's P is exactly
// 0); O = P V / l with P = exp(logit - m) rounded to bf16 before P V; m and
// l are fp32 in natural-log units, as FB, F2W and F3W read them. Every query
// row keeps its diagonal key, so l > 0. No atomics: each CTA owns its rows,
// so two calls give the same bits.
//
// What bounds it on the H100. At Gemma-2B's attention shape (B 22, H 8 after
// the MQA repeat, T 512, unpadded) the function reads Q, K, V and writes O,
// 4 x 46.1 MB, and l and m: 185 MB, 55 us at 3.35 TB/s; its two products
// take 4 D FLOPs a kept pair, 23.6 GFLOP over 23.1 M pairs, 24 us at 989
// TFLOP/s. So bytes bound it. An mma.sync design at D 256 (F1, or FFH's
// body widened) is held back by shared memory instead: every 16-row warp
// loads each K and V fragment through ldmatrix, 576 KB a 128-query CTA and
// 64-key tile, about 4,600 clocks at 128 bytes a clock against about 2,050
// clocks of tensor work; and a 16-row warp cannot keep O (128 fp32
// registers) beside Q's fragments (64).
//
// What the design does about it:
//  * one CTA of two warpgroups (256 threads) per (128-query tile, head,
//    batch), each warpgroup owning 64 query rows. A one-dimensional grid
//    puts a head's query tiles side by side, the longest rows first, so
//    they run in one wave and share the head's K and V through L2: at
//    Gemma-2B's shape that took 16.5% off the device time of a grid whose x
//    was the head and y the query tile (each head's tiles a wave apart, 67
//    MB of other heads' K and V between them, more than the 50 MB L2);
//  * three tensor maps see Q, K and V as 2-D arrays of shape (D, B H T),
//    with a box of 64 columns (128 bytes) x 64 rows and the 128-byte swizzle:
//    a 64-row tile of D 256 is four boxes (32 KB). One thread issues every
//    load. Q comes in once (64 KB); K, V and the tile's 64 key segment ids
//    (a bulk copy) come into a two-stage ring (2 x 64 KB), each stage
//    completing a "full" mbarrier by its transaction bytes. About 193 KB of
//    shared memory: one CTA an SM;
//  * the CTA walks the key tiles from the diagonal down to 0, and takes one
//    barrier a tile, a vote (__syncthreads_and) on whether the query tile and
//    the next key tile hold one segment id; after it every warp is done with
//    the tile before, so the same thread refills that stage for the tile
//    after: no "empty" barriers and no producer warp;
//  * S = Q K^T is 16 wgmma.m64n64k16 a warpgroup and tile, both operands
//    K-major (D contiguous) from shared memory: B is read once a warpgroup,
//    not once a warp, a quarter of the shared traffic of mma.sync;
//  * after wgmma.wait_group 0 the accumulators hold each warp's 16 rows in
//    mma.sync's C layout, so FF's online softmax carries over: base 2 on the
//    raw scores, one FFMA and one MUFU.EX2 an element, quad shuffles for the
//    row max and sum; the mask only on a warpgroup's diagonal tile and on
//    tiles the vote did not find uniform; the tile above a warpgroup's rows
//    is skipped (warpgroup 0 skips the CTA's last key tile);
//  * O += P V is 8 wgmma.m64n128k16 a warpgroup and tile, P the register A
//    operand, rounded to bf16 and packed straight from S's accumulators; V
//    the MN-major B operand from shared memory (K1's layout, transpose bit
//    1). O's 128 fp32 accumulators a thread stay in registers for the loop;
//  * O / l is staged in the warpgroup's own Q boxes (a 128-byte row XOR
//    swizzle: conflict-free stores and 16-byte loads) and written with
//    16-byte stores; l and m once a row.
// A wgmma.fence precedes each batch of wgmma, whose accumulators or A
// registers ordinary instructions wrote (the rescale by alpha, P's packing).
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError(), or a negative CUresult if a tensor map cannot be
// encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace kf_flash;
using bf16 = __nv_bfloat16;

constexpr int kD = 256;
constexpr int kQueryTile = 128;                  // query rows a CTA
constexpr int kKeyTile = 64;                     // keys a loop step
constexpr int kWgRows = 64;                      // query rows a warpgroup
constexpr int kThreads = 256;                    // two warpgroups
constexpr int kBoxCols = 64;                     // 128 bytes: the swizzle span
constexpr int kBoxes = kD / kBoxCols;            // boxes across D
constexpr int kBoxBytes = 64 * kBoxCols * 2;     // 64 rows x 128 bytes
constexpr int kTileBytes = kBoxes * kBoxBytes;   // 64 rows x D
constexpr int kSegBytes = kKeyTile * 4;
constexpr int kSmemQ = 0;                        // one tile a warpgroup
constexpr int kSmemK = kSmemQ + 2 * kTileBytes;  // two stages
constexpr int kSmemV = kSmemK + 2 * kTileBytes;  // two stages
constexpr int kSmemSeg = kSmemV + 2 * kTileBytes;
constexpr int kSmemBytes = kSmemSeg + 2 * kSegBytes + 1024;  // + slack to align to 1 KB
constexpr int kKStepBytes = 16 * 2;              // a K-major k-step: 16 elements of a row
constexpr int kKeyStepBytes = 16 * kBoxCols * 2; // an MN-major k-step: 16 rows of a box
constexpr uint32_t kStageTx = 2 * kTileBytes + kSegBytes;
constexpr float kLog2e = 1.4426950408889634f;
// A wait on an mbarrier that lasts this many clocks (about 2 s) traps
// instead of hanging the card.
constexpr long long kWaitTrapClocks = 1ll << 32;

static_assert(kQueryTile == 2 * kWgRows && kWgRows == kKeyTile, "tile shape");
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase with this parity has completed; traps after
// kWaitTrapClocks.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitTrapClocks) {
      __trap();
    }
  }
}

// One 64-column x 64-row box at (column c0, row r0) of `map` into shared
// memory; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                             int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory into shared
// memory; they complete a transaction on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset and stride byte offset, each in 16-byte units. The swizzle is
// of address bits, so a k-step inside a box moves the start address alone.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous issue and wait.
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

#define KF_D8(b)                                                                      \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),         \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), both K-major in shared memory:
// S += Q K^T for one 16-wide step of D.
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : KF_D8(0), KF_D8(8), KF_D8(16), KF_D8(24)
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

// d (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, MN-major in shared
// memory): O += P V for 16 keys and half of D.
__device__ __forceinline__ void wgmma_o(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
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
      : KF_D8(0), KF_D8(8), KF_D8(16), KF_D8(24), KF_D8(32), KF_D8(40), KF_D8(48),
        KF_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}
#undef KF_D8

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One key tile for one warpgroup's 64 query rows: S = Q K^T, the online
// softmax, O += P V. qs, ks and vs are the warpgroup's Q tile and the
// stage's K and V tiles (four boxes each). Thread (g, t) of its warp holds
// rows `row` and `row` + 8 (query positions): s[4 j + e] is row row + 8 (e >>
// 1), key k0 + 8 j + 2 t + (e & 1), and o[n][4 j + e] the same rows at
// column 128 n + 8 j + 2 t + (e & 1). m_r is the running max of the raw
// scores. kMasked applies the causal and segment mask per element.
template <bool kMasked>
__device__ __forceinline__ void attend_tile(uint32_t qs, uint32_t ks, uint32_t vs,
                                            const int* seg_k, int k0, int row,
                                            const int (&seg_r)[2], float scale_log2,
                                            float (&o)[2][64], float (&m_r)[2], float (&l_r)[2],
                                            int t) {
  float s[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kBoxes; ++c)
#pragma unroll
    for (int kk = 0; kk < kBoxCols / 16; ++kk)
      wgmma_s(s, smem_desc(qs + c * kBoxBytes + kk * kKStepBytes, 16, 1024),
              smem_desc(ks + c * kBoxBytes + kk * kKStepBytes, 16, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_registers(s);

  // keep: bit 4 j + e for element s[4 j + e].
  uint32_t keep = 0xffffffffu;
  if (kMasked) {
    keep = 0;
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const int2 sk = *reinterpret_cast<const int2*>(seg_k + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = e & 1;
        const bool kept = k0 + c + col <= row + 8 * i && (col ? sk.y : sk.x) == seg_r[i];
        keep |= static_cast<uint32_t>(kept) << (4 * j + e);
      }
    }
  }
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int x = 0; x < 32; ++x)
    if (!kMasked || ((keep >> x) & 1)) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
  float alpha[2], m_log2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    // The first tile a row meets holds its diagonal key, so mx is finite
    // and 2^(-inf) = 0 clears the empty accumulators.
    alpha[i] = exp2_approx((m_r[i] - mx[i]) * scale_log2);
    m_r[i] = mx[i];
    m_log2[i] = mx[i] * scale_log2;
  }

  // P, rounded to bf16 and packed as wgmma's register A operand: for each
  // 16-key step, mma.sync's A fragment of the warp's 16 rows.
  float rs[2] = {0.f, 0.f};
  uint32_t pa[kKeyTile / 16][4];
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2_approx(fmaf(s[4 * j + e], scale_log2, -m_log2[e >> 1]));
      p[e] = (!kMasked || ((keep >> (4 * j + e)) & 1)) ? x : 0.f;
      rs[e >> 1] += p[e];
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int x = 0; x < 64; ++x) o[n][x] *= alpha[(x >> 1) & 1];

  // O += P V: 16 keys a step, each half of D one m64n128k16.
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      wgmma_o(o[n], pa[kk],
              smem_desc(vs + n * 2 * kBoxBytes + kk * kKeyStepBytes, kBoxBytes, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_registers(o[0]);
  fence_registers(o[1]);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_d256_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const int* __restrict__ seg,
                          bf16* __restrict__ o_out, float* __restrict__ l_out,
                          float* __restrict__ m_out, int H, int T_len, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[2];
  __shared__ uint64_t q_full;
  // The 128-byte swizzle repeats every 1 KB: boxes start on 1 KB boundaries.
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int tiles = T_len / kQueryTile;
  const int bh = blockIdx.x / tiles;  // b * H + h
  const int q0 = (tiles - 1 - blockIdx.x % tiles) * kQueryTile;  // longest rows first
  const int row0 = bh * T_len;  // row (b, h, 0) of the tensor maps
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int kt_last = (q0 + kQueryTile - 1) / kKeyTile;
  const int kt_diag = (q0 + wg * kWgRows) / kKeyTile;  // the warpgroup's diagonal tile

  // Thread 0's loads of key tile kt (K, V, its segment ids) into `stage`.
  auto load_key_tile = [&](int stage, int kt) {
    uint64_t* bar = &full[stage];
    mbar_expect_tx(bar, kStageTx);
    const int r = row0 + kt * kKeyTile;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      tma_load_box(s0 + kSmemK + stage * kTileBytes + c * kBoxBytes, &k_map, bar, c * kBoxCols,
                   r);
      tma_load_box(s0 + kSmemV + stage * kTileBytes + c * kBoxBytes, &v_map, bar, c * kBoxCols,
                   r);
    }
    bulk_load(s0 + kSmemSeg + stage * kSegBytes, segb + kt * kKeyTile, kSegBytes, bar);
  };

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const CUtensorMap* maps[3] = {&q_map, &k_map, &v_map};
#pragma unroll
    for (int x = 0; x < 3; ++x)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[x]))
                   : "memory");
    mbar_expect_tx(&q_full, 2 * kTileBytes);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load_box(s0 + kSmemQ + w * kTileBytes + c * kBoxBytes, &q_map, &q_full,
                     c * kBoxCols, row0 + q0 + w * kWgRows);
    load_key_tile(0, kt_last);
  }
  __syncwarp();

  // Whether the query tile holds one segment id, the one of its first row.
  const int seg_first = segb[q0];
  const bool q_one = tid >= kQueryTile || segb[q0 + tid] == seg_first;
  const int rw = wg * kWgRows + (warp & 3) * 16;  // the warp's first row in the tile
  const int seg_r[2] = {segb[q0 + rw + g], segb[q0 + rw + g + 8]};
  // Waits for the tile in `stage` and returns, for the whole CTA, whether the
  // query tile and that key tile hold one segment id. The barrier also marks
  // the other stage free: every warpgroup is done with the tile before.
  auto arrive = [&](int stage, uint32_t parity) {
    mbar_wait(&full[stage], parity);
    bool one = q_one;
    if (tid < kKeyTile / 4) {
      const int4 s4 =
          *reinterpret_cast<const int4*>(smem + kSmemSeg + stage * kSegBytes + tid * 16);
      one = one && s4.x == seg_first && s4.y == seg_first && s4.z == seg_first &&
            s4.w == seg_first;
    }
    return __syncthreads_and(one) != 0;
  };
  mbar_wait(&q_full, 0);
  bool uniform = arrive(0, 0);

  float o[2][64];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int x = 0; x < 64; ++x) o[n][x] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;
  const int row = q0 + rw + g;
  const uint32_t qs = s0 + kSmemQ + wg * kTileBytes;

  for (int kt = kt_last; kt >= 0; --kt) {
    const int i = kt_last - kt, stage = i & 1;
    if (tid == 0 && kt > 0) load_key_tile(stage ^ 1, kt - 1);
    __syncwarp();
    if (kt <= kt_diag) {  // a tile above the warpgroup's rows keeps nothing
      const uint32_t ks = s0 + kSmemK + stage * kTileBytes;
      const uint32_t vs = s0 + kSmemV + stage * kTileBytes;
      const int* seg_k = reinterpret_cast<const int*>(smem + kSmemSeg + stage * kSegBytes);
      if (uniform && kt != kt_diag)
        attend_tile<false>(qs, ks, vs, seg_k, kt * kKeyTile, row, seg_r, scale_log2, o, m_r, l_r,
                           t);
      else
        attend_tile<true>(qs, ks, vs, seg_k, kt * kKeyTile, row, seg_r, scale_log2, o, m_r, l_r,
                          t);
    }
    if (kt > 0) uniform = arrive(stage ^ 1, ((i + 1) >> 1) & 1);
  }

  // O / l in bf16, staged in the warpgroup's own Q tile (only its wgmma read
  // it, and they are done once all four warps reach the warpgroup's
  // barrier), in 128-byte rows whose 16-byte chunks are XOR-swizzled by the
  // row: chunk c of row r sits at chunk c ^ (r % 8) of its box.
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  uint8_t* stage_o = smem + kSmemQ + wg * kTileBytes;
  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
  const int r_warp = (warp & 3) * 16;  // the warp's first row in the warpgroup's tile
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_warp + g + 8 * h;
        const int box = n * 2 + j / 8, chunk = j % 8;
        *reinterpret_cast<uint32_t*>(stage_o + box * kBoxBytes + r * 128 +
                                     ((chunk ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16(o[n][4 * j + 2 * h] * inv[h], o[n][4 * j + 2 * h + 1] * inv[h]);
      }
  __syncwarp();
  bf16* og = o_out + static_cast<size_t>(row0 + q0 + rw) * kD;
  const int box = lane / 8, chunk = lane % 8;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int rr = r_warp + r;
    *reinterpret_cast<uint4*>(og + static_cast<size_t>(r) * kD + lane * 8) =
        *reinterpret_cast<const uint4*>(stage_o + box * kBoxBytes + rr * 128 +
                                        ((chunk ^ (rr & 7)) << 4));
  }
  if (t == 0) {
    const size_t r0 = static_cast<size_t>(row0) + row;
    l_out[r0] = l_r[0];
    m_out[r0] = m_r[0] * scale;
    l_out[r0 + 8] = l_r[1];
    m_out[r0 + 8] = m_r[1] * scale;
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so
// that the library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  static cudaError_t status = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
    if (err == cudaSuccess && found != cudaDriverEntryPointSuccess) err = cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(ptr);
    return err;
  }();
  *fn = cached;
  return status;
}

// A bf16 (rows, D) operand as a tensor map of 64 x 64 boxes, 128-byte swizzle.
CUresult encode_operand(EncodeTiledFn encode, CUtensorMap* map, const void* base,
                        long long rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kD) * 2};
  const cuuint32_t box[2] = {kBoxCols, 64};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// q, k, v: bf16 (B, H, T, D); seg: int32 (B, T); o: bf16 (B, H, T, D); l,
// m: fp32 (B, H, T). Every pointer 16-byte aligned, T a multiple of 128, D
// 256. Returns a CUDA error code (cudaErrorInvalidValue for a shape the
// kernel does not take), or a negative CUresult if a tensor map cannot be
// encoded.
extern "C" int kf_flash_fwd_d256(const void* q, const void* k, const void* v, const void* seg,
                                 void* o, void* l, void* m, int B, int H, int T_len, int D,
                                 float scale, void* stream) {
  const long long rows = static_cast<long long>(B) * H * T_len;
  if (D != kD || B <= 0 || H <= 0 || T_len <= 0 || T_len % kQueryTile || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* pointers[5] = {q, k, v, seg, o};
  for (const void* p : pointers)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode;
  const cudaError_t found = encode_tiled_fn(&encode);
  if (found != cudaSuccess) return static_cast<int>(found);
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int x = 0; x < 3; ++x) {
    const CUresult encoded = encode_operand(encode, &maps[x], bases[x], rows);
    if (encoded != CUDA_SUCCESS) return -static_cast<int>(encoded);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ctas = static_cast<unsigned>(rows / kQueryTile);
  flash_fwd_d256_kernel<<<ctas, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const int*>(seg), static_cast<bf16*>(o),
      static_cast<float*>(l), static_cast<float*>(m), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spill) bytes a thread and CTAs an SM of FFW
// (which 0, its one kernel), as the CUDA runtime reports them.
extern "C" int kf_flash_fwd_d256_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(flash_fwd_d256_kernel);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, kSmemBytes));
}
