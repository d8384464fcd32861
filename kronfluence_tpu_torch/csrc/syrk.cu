// Symmetric rank-k update C = A^T A over lower-triangle output tiles.
//
// Replaces the TPU kernel kronfluence_tpu/ops/pallas/syrk.py:_syrk_kernel
// (plus that wrapper's pad, tril and mirror passes). A is (rows, n) row-major,
// in bf16, fp16 or fp32; C is (n, n) fp32 and comes out exactly symmetric.
//
// What bounds it on the H100. The lower triangle costs about n^2 * rows FLOPs
// (2 * rows * 128^2 per output tile, T(T+1)/2 tiles for T = ceil(n / 128)):
// 77 GFLOP at rows 8192, n 3072, 78 us at the bf16 tensor-core peak. Each CTA
// streams its two 128-column stripes of A through shared memory once, so every
// stripe is re-read once per partner tile (T times): about 1.2 GB at n 3072 in
// bf16, against a 50 MB operand, or 64 FLOP per byte moved into shared memory.
// Those re-reads come from the 50 MB L2, not from HBM, and feeding the tensor
// cores at that ratio is what bounds a 128 x 128 tile.
//
// Three kernels, chosen by the wrapper (ops/kernels/syrk.py:bf16_route) from
// the operand's type, width and alignment, never by a failure. The two
// tensor-core kernels are each built for bf16 and for fp16
// (`syrk_bf16_wgmma_kernel` and `syrk_f16_wgmma_kernel` on one template body,
// `syrk_wmma_kernel<T>`): the same instructions with the other
// 16-bit operand type (wgmma's .f16 for .bf16, f16 wmma fragments, the
// tensor map's FLOAT16 for BFLOAT16); fp16 x fp16 products are exact in fp32
// as bf16 x bf16 ones are.
//
//  * syrk_bf16_wgmma_kernel (syrk_f16_wgmma_kernel): bf16 (fp16) with n % 8
//    == 0 and a 16-byte aligned base, the operands the Tensor Memory
//    Accelerator (TMA) can describe. GPT-2's grams (n 2304, 3072) all take it.
//      - One CTA per lower-triangle 128 x 128 tile (i, j); the pair comes from
//        blockIdx.x (tile_pair), so the upper tiles are never computed.
//      - TMA loads into a ring of kStages stages, each with a "full" and an
//        "empty" mbarrier. One tensor map over A: dims (n, rows), a box of
//        64 columns x 64 rows (128 bytes x 64), 128-byte swizzle. A stage is
//        one 64-row slab of both stripes: four boxes, 32 KB; a diagonal tile
//        loads its one stripe (16 KB) and feeds both operands from it. TMA
//        zero-fills past `rows` and `n`, so no load is masked.
//      - wgmma with both operands MN-major: the tile product is
//        sum_k A[k, i0 + m] A[k, j0 + n], and a slab sits in shared memory as
//        [k][column], so the A operand (M x K) is M-contiguous and the B
//        operand (K x N) N-contiguous; both take wgmma's transpose bit. In the
//        128-byte-swizzled MN-major layout the descriptor's leading byte
//        offset is the step between 64-column boxes (8 KB) and its stride
//        byte offset the step between 8-row groups of k (1 KB).
//      - Warp specialisation, in the form of one producer warp: warps 0-7 are
//        two consumer warpgroups, each owning 64 rows of the tile and issuing
//        four wgmma.m64n128k16 per slab into 64 fp32 accumulators a thread;
//        warp 8's lane 0 keeps the ring full. A consumer frees a stage once
//        wgmma.wait_group 1 says that slab's products are done, so one slab's
//        products overlap the next one's wait. A producer warp and not a
//        producer warpgroup: the 64 accumulators a consumer thread fit in
//        the registers of 288 threads without `setmaxnreg` (90 a thread).
//      - kStages = 4 (128 KB), one CTA an SM. Two CTAs an SM (kStages 3,
//        96 KB, so that one CTA's epilogue overlaps the other's main loop)
//        was slower at 8192 x 3072 and faster at 8192 x 2304 on the H100;
//        over the covariance stage's calls (two at 3072 for each at 2304)
//        one CTA an SM came out ahead (chip_smoke.py --profile-k1; PERF.md).
//      - Epilogue: after the last wgmma.wait_group 0 and a CTA barrier, the
//        fp32 tile is staged in the ring's shared memory (odd row pitch: the
//        row and the column reads are both free of bank conflicts), then
//        written to C[i, j] along rows and to its mirror C[j, i] along rows,
//        both from the same fp32 values. Diagonal tiles write their lower
//        half and mirror it; columns >= n are masked.
//  * syrk_wmma_kernel: 16-bit operands TMA cannot describe (n % 8 != 0, or an
//    unaligned base): wmma (mma.sync m16n16k16) from padded shared memory,
//    32-row slabs staged through registers with one slab prefetched, masked
//    scalar loads.
//  * syrk_f32_ring_kernel: fp32 operands, exact fp32 FFMA (the tensor cores
//    would round them to TF32), so the 67 TFLOP/s FFMA peak bounds it: at
//    the fp32 covariance grams (rows 2352 to 9408) the operations take
//    13-23x the bytes' time. 128 x 128 tiles of 256 threads with 8 x 8
//    outputs each (four LDS.128 for 64 FFMA), a 4-stage cp.async ring, a
//    staged epilogue, and, where the triangle has too few tiles for the
//    card's SMs, a split of the rows whose partial tiles
//    syrk_f32_reduce_kernel sums in a fixed order (details at the kernels).
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (the wgmma launcher returns a negative CUresult if the
// tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;

// Lower-triangle pair p = i(i+1)/2 + j, j <= i, enumerated row by row.
// Mirrored in Python by ops/kernels/syrk.py:tile_pair.
__device__ __forceinline__ void tile_pair(int p, int& ti, int& tj) {
  int i = static_cast<int>((sqrtf(8.0f * static_cast<float>(p) + 1.0f) - 1.0f) * 0.5f);
  while (i > 0 && i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  ti = i;
  tj = p - i * (i + 1) / 2;
}

// ---------------------------------------------------------------------------
// bf16 operands that TMA can describe: wgmma fed by a TMA / mbarrier ring.
// ---------------------------------------------------------------------------
constexpr int kTile = 128;                             // output tile edge
constexpr int kWgSlab = 64;                            // rows of A per ring stage
constexpr int kBoxCols = 64;                           // 64 bf16 = 128 bytes: the swizzle span
constexpr int kBoxBytes = kWgSlab * kBoxCols * 2;      // 8 KB
constexpr int kStripeBytes = 2 * kBoxBytes;            // 128 columns x 64 rows
constexpr int kStageBytes = 2 * kStripeBytes;          // both stripes of one slab
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kWgThreads = (kConsumerWarps + 1) * 32;  // plus the producer warp
constexpr int kKStep = 16;                             // wgmma depth (bf16)
constexpr int kKStepBytes = kKStep * kBoxCols * 2;     // 16 swizzled rows of a box
constexpr int kOutPitch = kTile + 1;                   // fp32 epilogue staging row
constexpr int kWgSmemBytes = kStages * kStageBytes + 1024;  // + slack to align to 1 KB

static_assert(kTile * kOutPitch * 4 <= kStages * kStageBytes, "epilogue staging fits the ring");
static_assert(kWgSlab % kKStep == 0, "a slab holds whole wgmma k-steps");

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 64-column x 64-row box of A at (column c0, row r0) into shared memory;
// its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset and stride byte offset, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 128, fp32) += A (64 x 16, M-major) * B (16 x 128, N-major), for
// operands of the 16-bit type T (__nv_bfloat16 or __half).
#define KF_D8(b)                                                                      \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),         \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define KF_WGMMA_M64N128K16(TYPE)                                                     \
  asm volatile(                                                                       \
      "{\n"                                                                           \
      ".reg .pred p;\n"                                                               \
      "setp.ne.b32 p, %66, 0;\n"                                                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                             \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                        \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                      \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                      \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                      \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                      \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                      \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                                     \
      "%64, %65, p, 1, 1, 1, 1;\n"                                                    \
      "}\n"                                                                           \
      : KF_D8(0), KF_D8(8), KF_D8(16), KF_D8(24), KF_D8(32), KF_D8(40), KF_D8(48),    \
        KF_D8(56)                                                                     \
      : "l"(desc_a), "l"(desc_b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  if constexpr (std::is_same_v<T, __half>) {
    KF_WGMMA_M64N128K16("f16");
  } else {
    KF_WGMMA_M64N128K16("bf16");
  }
}
#undef KF_WGMMA_M64N128K16
#undef KF_D8

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma issue and wait.
__device__ __forceinline__ void fence_accumulators(float (&d)[64]) {
#pragma unroll
  for (int x = 0; x < 64; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

// The wgmma kernel's body for operands of type T; `map` is the kernel's
// __grid_constant__ tensor map.
template <typename T>
__device__ __forceinline__ void syrk_wgmma_body(const CUtensorMap* map, float* __restrict__ c,
                                                int rows, int n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  __shared__ uint64_t empty[kStages];
  // The 128-byte swizzle repeats every 1 KB: stages start on 1 KB boundaries.
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));

  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const bool diag = ti == tj;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slabs = (rows + kWgSlab - 1) / kWgSlab;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.0f;

  if (warp == kConsumerWarps) {
    // Producer: lane 0 keeps every stage of the ring loaded.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
                   : "memory");
      const uint32_t bytes = diag ? kStripeBytes : kStageBytes;
      for (int kt = 0; kt < slabs; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        uint8_t* stage = ring + s * kStageBytes;
        const int r0 = kt * kWgSlab;
        tma_load_box(stage, map, &full[s], i0, r0);
        tma_load_box(stage + kBoxBytes, map, &full[s], i0 + kBoxCols, r0);
        if (!diag) {
          tma_load_box(stage + kStripeBytes, map, &full[s], j0, r0);
          tma_load_box(stage + kStripeBytes + kBoxBytes, map, &full[s], j0 + kBoxCols, r0);
        }
      }
    }
    __syncwarp();
  } else {
    // Consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63, which are
    // columns i0 + 64 wg ... of A: box wg of stripe i.
    const int wg = warp / 4;
    const uint32_t ring_addr = smem_u32(ring);
    for (int kt = 0; kt < slabs; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint32_t stage = ring_addr + s * kStageBytes;
      const uint32_t a_addr = stage + wg * kBoxBytes;
      const uint32_t b_addr = stage + (diag ? 0 : kStripeBytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kWgSlab / kKStep; ++kk) {
        wgmma_m64n128k16_mn<T>(acc, smem_desc(a_addr + kk * kKStepBytes, kBoxBytes, 1024),
                            smem_desc(b_addr + kk * kKStepBytes, kBoxBytes, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // The previous slab's products are done: free its stage.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
      __syncwarp();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_accumulators(acc);
  }

  // Every wgmma has read the ring and no load is in flight: reuse the ring
  // as fp32 staging for the epilogue.
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* out = reinterpret_cast<float*>(ring);
  if (warp < kConsumerWarps) {
    // wgmma's accumulator layout: acc[4 q + 2 h + e] holds row
    // 16 (warp % 4) + lane / 4 + 8 h of the warpgroup's 64, column
    // 8 q + 2 (lane % 4) + e.
    const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int q = 0; q < kTile / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[(row + 8 * h) * kOutPitch + 8 * q + 2 * (lane % 4) + e] = acc[4 * q + 2 * h + e];
  }
  __syncthreads();
  if (warp < kConsumerWarps) {
    // C[i, j] along its rows, then the mirror C[j, i] along its rows.
    for (int r = warp; r < kTile; r += kConsumerWarps) {
      const int gi = i0 + r;
#pragma unroll
      for (int q = 0; q < kTile / 32; ++q) {
        const int col = lane + 32 * q;
        const int gj = j0 + col;
        if (gi < n && gj < n && (!diag || gi >= gj))
          c[static_cast<size_t>(gi) * n + gj] = out[r * kOutPitch + col];
      }
    }
    for (int col = warp; col < kTile; col += kConsumerWarps) {
      const int gj = j0 + col;
#pragma unroll
      for (int q = 0; q < kTile / 32; ++q) {
        const int r = lane + 32 * q;
        const int gi = i0 + r;
        if (gi < n && gj < n && (!diag || gi >= gj))
          c[static_cast<size_t>(gj) * n + gi] = out[r * kOutPitch + col];
      }
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    syrk_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ c,
                           int rows, int n) {
  syrk_wgmma_body<__nv_bfloat16>(&map, c, rows, n);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    syrk_f16_wgmma_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ c,
                          int rows, int n) {
  syrk_wgmma_body<__half>(&map, c, rows, n);
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point so
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

// ---------------------------------------------------------------------------
// bf16 operands TMA cannot describe: wmma (mma.sync), fp32 accumulation.
// ---------------------------------------------------------------------------
constexpr int kSlab = 32;                              // rows of A per slab
constexpr int kLds = kTile + 8;                        // padded smem row (elements)
constexpr int kThreads = 256;                          // 8 warps: 2 x 4 over the tile
constexpr int kWarpM = 64;                             // tile rows per warp
constexpr int kWarpN = 32;                             // tile cols per warp
constexpr int kFragM = kWarpM / 16;
constexpr int kFragN = kWarpN / 16;
constexpr int kChunksPerRow = kTile / 8;               // 8-element chunks per slab row
constexpr int kChunksPerThread = kSlab * kChunksPerRow / kThreads;  // 2
constexpr int kStageLd = 20;                           // padded fp32 staging row

static_assert(kSlab * kChunksPerRow % kThreads == 0, "slab chunks must split evenly");
static_assert(kSlab % 16 == 0, "slab must hold whole mma k-steps");

// Eight consecutive 16-bit values of row gr starting at column gc, zero outside A,
// read element by element (the row stride or the base is not 16-byte aligned).
__device__ __forceinline__ uint4 load_chunk_bf16(const uint16_t* __restrict__ a, int rows, int n,
                                                 int gr, int gc) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (gr >= rows || gc >= n) return v;
  const uint16_t* src = a + static_cast<size_t>(gr) * n + gc;
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = (gc + 2 * e < n) ? src[2 * e] : 0u;
    const uint32_t hi = (gc + 2 * e + 1 < n) ? src[2 * e + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  v.x = w[0];
  v.y = w[1];
  v.z = w[2];
  v.w = w[3];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    syrk_wmma_kernel(const uint16_t* __restrict__ a, float* __restrict__ c, int rows, int n) {
  __shared__ __align__(128) uint16_t sa[kSlab][kLds];
  __shared__ __align__(128) uint16_t sb[kSlab][kLds];
  __shared__ __align__(128) float stage[kThreads / 32][16 * kStageLd];

  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const bool diag = ti == tj;  // both stripes are the same: load and read one
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / (kTile / kWarpN);
  const int wn = warp % (kTile / kWarpN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int x = 0; x < kFragM; ++x)
#pragma unroll
    for (int y = 0; y < kFragN; ++y) wmma::fill_fragment(acc[x][y], 0.0f);

  int lr[kChunksPerThread], lc[kChunksPerThread];
#pragma unroll
  for (int s = 0; s < kChunksPerThread; ++s) {
    const int idx = threadIdx.x + s * kThreads;
    lr[s] = idx / kChunksPerRow;
    lc[s] = (idx % kChunksPerRow) * 8;
  }

  uint4 ra[kChunksPerThread], rb[kChunksPerThread];
#pragma unroll
  for (int s = 0; s < kChunksPerThread; ++s) {
    ra[s] = load_chunk_bf16(a, rows, n, lr[s], i0 + lc[s]);
    rb[s] = diag ? make_uint4(0u, 0u, 0u, 0u) : load_chunk_bf16(a, rows, n, lr[s], j0 + lc[s]);
  }

  for (int r0 = 0; r0 < rows; r0 += kSlab) {
#pragma unroll
    for (int s = 0; s < kChunksPerThread; ++s) {
      *reinterpret_cast<uint4*>(&sa[lr[s]][lc[s]]) = ra[s];
      if (!diag) *reinterpret_cast<uint4*>(&sb[lr[s]][lc[s]]) = rb[s];
    }
    __syncthreads();

    const int next = r0 + kSlab;
    if (next < rows) {
#pragma unroll
      for (int s = 0; s < kChunksPerThread; ++s) {
        ra[s] = load_chunk_bf16(a, rows, n, next + lr[s], i0 + lc[s]);
        if (!diag) rb[s] = load_chunk_bf16(a, rows, n, next + lr[s], j0 + lc[s]);
      }
    }

    const uint16_t(*bs)[kLds] = diag ? sa : sb;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      // A^T tile: element (m, k) = A[r0 + kk + k, i0 + m] sits at sa[kk + k][m],
      // i.e. column-major with leading dimension kLds.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[kFragN];
#pragma unroll
      for (int x = 0; x < kFragM; ++x)
        wmma::load_matrix_sync(
            fa[x], reinterpret_cast<const T*>(&sa[kk][wm * kWarpM + x * 16]), kLds);
#pragma unroll
      for (int y = 0; y < kFragN; ++y)
        wmma::load_matrix_sync(
            fb[y], reinterpret_cast<const T*>(&bs[kk][wn * kWarpN + y * 16]), kLds);
#pragma unroll
      for (int x = 0; x < kFragM; ++x)
#pragma unroll
        for (int y = 0; y < kFragN; ++y) wmma::mma_sync(acc[x][y], fa[x], fb[y], acc[x][y]);
    }
    __syncthreads();
  }

  // Epilogue: stage each 16 x 16 fragment in shared memory, then write it to
  // C[i, j] (lanes along j) and to its mirror C[j, i] (lanes along i), so both
  // stores run along rows of C.
  float* st = stage[warp];
#pragma unroll
  for (int x = 0; x < kFragM; ++x) {
#pragma unroll
    for (int y = 0; y < kFragN; ++y) {
      wmma::store_matrix_sync(st, acc[x][y], kStageLd, wmma::mem_row_major);
      __syncwarp();
      const int bi = i0 + wm * kWarpM + x * 16;
      const int bj = j0 + wn * kWarpN + y * 16;
      for (int e = lane; e < 256; e += 32) {
        const int m = e / 16, q = e % 16;
        const int gi = bi + m, gj = bj + q;
        if (gi < n && gj < n && (!diag || gi >= gj))
          c[static_cast<size_t>(gi) * n + gj] = st[m * kStageLd + q];
      }
      for (int e = lane; e < 256; e += 32) {
        const int q = e / 16, m = e % 16;
        const int gi = bi + m, gj = bj + q;
        if (gi < n && gj < n && (!diag || gi >= gj))
          c[static_cast<size_t>(gj) * n + gi] = st[m * kStageLd + q];
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 operands: register-tiled FFMA on 128 x 128 tiles fed by a cp.async
// ring, with an optional deterministic split of the rows.
//
// What bounds it on the H100. The tensor cores would round fp32 products to
// TF32, so the products are FFMA: 128 a clock an SM, 67 TFLOP/s. Each thread
// holds 8 x 8 outputs, 2 x 2 blocks of 4 x 4 (tile rows 4 ty and 64 + 4 ty,
// columns 4 tx and 64 + 4 tx), so a k-step reads four float4 (LDS.128) for
// 64 FFMA. Within a warp each A read is a broadcast of two addresses and
// each B read one 256-byte row, free of conflicts: 6 shared-memory
// wavefronts for 64 FFMA instructions, 37.5% of the SM's 128 bytes a clock
// at the FFMA peak. The 64 x 64 tiles of 4 x 4 it replaced took 8 wavefronts
// for 16 FFMA instructions, which capped them at 50% of the peak.
//  - Ring: kStagesF stages of kSlabF rows of both 128-column stripes, laid
//    out [k][column] per operand as A is, filled by 16-byte cp.async.cg where
//    n % 4 == 0 and the base is 16-byte aligned (kVec), else by 4-byte
//    cp.async.ca per element. Both zero-fill past the range's last row and
//    past n, so no product is masked. One barrier a slab: the wait for slab
//    kt, the barrier, then the load of slab kt + kStagesF - 1 into the stage
//    slab kt - 1 left. A diagonal tile loads its one stripe and feeds both
//    operands from it.
//  - 256 threads, at most 128 registers (__launch_bounds__(256, 2)) and
//    66 KB of dynamic shared memory, so two CTAs share an SM.
//  - Epilogue: the tile is staged in the ring's shared memory with an odd
//    row pitch (kOutPitch), then C[i, j] and its mirror C[j, i] are written
//    along rows, both from the same fp32 values (write_staged_tile).
//  - Schedule (ops/kernels/syrk.py:f32_plan): with too few tiles for the
//    card's SMs (136 at n 2048, 171 at 2304 on 132 SMs) the slowest SM runs
//    two tiles while most run one. The plan then splits the rows into
//    gridDim.y ranges of `span` rows; CTA (p, r) computes tile p over range r
//    into its own slot of a workspace, and syrk_f32_reduce_kernel sums each
//    tile's partials in range order and writes the tile and its mirror. No
//    atomics: every sum has a fixed order, so two calls give the same bits.
// ---------------------------------------------------------------------------
constexpr int kSlabF = 16;                                   // rows of A per ring stage
constexpr int kStagesF = 4;
constexpr int kThreadsF = 256;                               // 16 x 16 threads of 8 x 8
constexpr int kStripeFloats = kSlabF * kTile;                // one stripe of one slab
constexpr int kStageFloats = 2 * kStripeFloats;              // 16 KB
constexpr int kRingBytesF = kStagesF * kStageFloats * 4;
constexpr int kStagingBytesF = kTile * kOutPitch * 4;
constexpr int kF32SmemBytes = kRingBytesF > kStagingBytesF ? kRingBytesF : kStagingBytesF;
constexpr int kPartialVecs = 16;                             // float4 of one thread's 8 x 8

static_assert(kSlabF * kTile / 4 == 2 * kThreadsF, "two float4 of each stripe a thread");

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Rows r .. r + kSlabF - 1 of the stripes at columns i0 (and j0 unless diag)
// into `stage`, [k][column] per stripe; zeros at rows >= r1 and columns >= n.
// A zero-filled copy reads nothing, so its source is the base pointer.
template <bool kVec>
__device__ __forceinline__ void load_slab_f32(float* stage, const float* __restrict__ a, int n,
                                              int i0, int j0, bool diag, int r, int r1) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * kThreadsF;
    const int row = idx / (kTile / 4);
    const int col = (idx % (kTile / 4)) * 4;
    const int gr = r + row;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 1 && diag) break;
      const int gc = (s == 0 ? i0 : j0) + col;
      float* dst = stage + s * kStripeFloats + row * kTile + col;
      const float* src = a + static_cast<size_t>(gr) * n + gc;
      if constexpr (kVec) {
        const bool valid = gr < r1 && gc < n;
        cp_async_f32x4(dst, valid ? src : a, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = gr < r1 && gc + e < n;
          cp_async_f32(dst + e, valid ? src + e : a, valid);
        }
      }
    }
  }
}

// Stages a thread's 8 x 8 outputs (rows 4 ty + u and 64 + 4 ty + u, columns
// 4 tx + v and 64 + 4 tx + v) in `out` at pitch kOutPitch, then writes the
// tile to C[i, j] along its rows and its mirror C[j, i] along its rows from
// the same values. Diagonal tiles write their lower half and mirror it;
// indices >= n are masked. `out` must be free: the caller's barrier.
__device__ __forceinline__ void write_staged_tile(const float (&acc)[8][8], float* out,
                                                  float* __restrict__ c, int i0, int j0, int n,
                                                  bool diag) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v)
      out[(4 * ty + u % 4 + 64 * (u / 4)) * kOutPitch + 4 * tx + v % 4 + 64 * (v / 4)] = acc[u][v];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kWarps = kThreadsF / 32;
  for (int r = warp; r < kTile; r += kWarps) {
    const int gi = i0 + r;
#pragma unroll
    for (int q = 0; q < kTile / 32; ++q) {
      const int col = lane + 32 * q;
      const int gj = j0 + col;
      if (gi < n && gj < n && (!diag || gi >= gj))
        c[static_cast<size_t>(gi) * n + gj] = out[r * kOutPitch + col];
    }
  }
  for (int col = warp; col < kTile; col += kWarps) {
    const int gj = j0 + col;
#pragma unroll
    for (int q = 0; q < kTile / 32; ++q) {
      const int r = lane + 32 * q;
      const int gi = i0 + r;
      if (gi < n && gj < n && (!diag || gi >= gj))
        c[static_cast<size_t>(gj) * n + gi] = out[r * kOutPitch + col];
    }
  }
}

// CTA (blockIdx.x, blockIdx.y): lower-triangle tile tile_pair(blockIdx.x)
// over rows [blockIdx.y * span, min(rows, (blockIdx.y + 1) * span)). One
// range (gridDim.y == 1) writes C; several write their partial tiles to
// `partial` (gridDim.x * gridDim.y slots of kPartialVecs x kThreadsF float4,
// a thread's float4 side by side so every store is coalesced).
template <bool kVec>
__global__ void __launch_bounds__(kThreadsF, 2)
    syrk_f32_ring_kernel(const float* __restrict__ a, float* __restrict__ c,
                         float4* __restrict__ partial, int rows, int n, int span) {
  extern __shared__ __align__(16) float ring_f[];
  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const bool diag = ti == tj;
  const int r0 = blockIdx.y * span;
  const int r1 = min(rows, r0 + span);
  const int slabs = (r1 - r0 + kSlabF - 1) / kSlabF;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kStagesF - 1; ++s) {
    if (s < slabs)
      load_slab_f32<kVec>(ring_f + s * kStageFloats, a, n, i0, j0, diag, r0 + s * kSlabF, r1);
    kf_flash::cp_async_commit();
  }
  for (int kt = 0; kt < slabs; ++kt) {
    kf_flash::cp_async_wait<kStagesF - 2>();
    __syncthreads();
    const int next = kt + kStagesF - 1;
    if (next < slabs)
      load_slab_f32<kVec>(ring_f + (next % kStagesF) * kStageFloats, a, n, i0, j0, diag,
                          r0 + next * kSlabF, r1);
    kf_flash::cp_async_commit();
    const float* sa = ring_f + (kt % kStagesF) * kStageFloats;
    const float* sb = diag ? sa : sa + kStripeFloats;
#pragma unroll
    for (int k = 0; k < kSlabF; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + k * kTile + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + k * kTile + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + k * kTile + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + k * kTile + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
  }
  // Only empty groups can be pending; every thread is past its last read of
  // the ring before the epilogue reuses it.
  kf_flash::cp_async_wait<0>();
  __syncthreads();
  if (gridDim.y == 1) {
    write_staged_tile(acc, ring_f, c, i0, j0, n, diag);
    return;
  }
  float4* slot = partial + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) *
                               kPartialVecs * kThreadsF;
#pragma unroll
  for (int f = 0; f < kPartialVecs; ++f)
    slot[f * kThreadsF + threadIdx.x] =
        make_float4(acc[f / 2][4 * (f % 2)], acc[f / 2][4 * (f % 2) + 1],
                    acc[f / 2][4 * (f % 2) + 2], acc[f / 2][4 * (f % 2) + 3]);
}

// Tile tile_pair(blockIdx.x): its `splits` partials summed in range order,
// left to right, then written as the ring kernel writes a whole tile.
__global__ void __launch_bounds__(kThreadsF)
    syrk_f32_reduce_kernel(const float4* __restrict__ partial, float* __restrict__ c, int n,
                           int splits) {
  extern __shared__ __align__(16) float staging_f[];
  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const float4* src =
      partial + static_cast<size_t>(blockIdx.x) * splits * kPartialVecs * kThreadsF + threadIdx.x;
  float acc[8][8];
#pragma unroll
  for (int f = 0; f < kPartialVecs; ++f) {
    const float4 p = src[f * kThreadsF];
    acc[f / 2][4 * (f % 2)] = p.x;
    acc[f / 2][4 * (f % 2) + 1] = p.y;
    acc[f / 2][4 * (f % 2) + 2] = p.z;
    acc[f / 2][4 * (f % 2) + 3] = p.w;
  }
  for (int r = 1; r < splits; ++r) {
#pragma unroll
    for (int f = 0; f < kPartialVecs; ++f) {
      const float4 p = src[(static_cast<size_t>(r) * kPartialVecs + f) * kThreadsF];
      acc[f / 2][4 * (f % 2)] += p.x;
      acc[f / 2][4 * (f % 2) + 1] += p.y;
      acc[f / 2][4 * (f % 2) + 2] += p.z;
      acc[f / 2][4 * (f % 2) + 3] += p.w;
    }
  }
  write_staged_tile(acc, staging_f, c, ti * kTile, tj * kTile, n, ti == tj);
}

inline long long triangle_pairs(int n, int tile) {
  const long long t = (n + tile - 1) / tile;
  return t * (t + 1) / 2;
}

}  // namespace

extern "C" int kf_syrk_bf16_wgmma_smem_bytes() { return kWgSmemBytes; }

namespace {

// A 16-bit operand with n % 8 == 0 and a 16-byte aligned base (the wrapper's
// route rule); anything else is refused rather than computed wrongly.
using WgmmaKernel = decltype(&syrk_bf16_wgmma_kernel);

int launch_wgmma(WgmmaKernel kernel, CUtensorMapDataType type, const void* a, void* c, int rows,
                 int n, void* stream) {
  if (rows <= 0 || n <= 0 || n % 8 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode;
  const cudaError_t found = encode_tiled_fn(&encode);
  if (found != cudaSuccess) return static_cast<int>(found);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t box[2] = {kBoxCols, kWgSlab};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult encoded = encode(
      &map, type, 2, const_cast<void*>(a), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (encoded != CUDA_SUCCESS) return -static_cast<int>(encoded);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = triangle_pairs(n, kTile);
  kernel<<<static_cast<unsigned>(pairs), kWgThreads, kWgSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(map, static_cast<float*>(c), rows, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wmma(const void* a, void* c, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = triangle_pairs(n, kTile);
  syrk_wmma_kernel<T><<<static_cast<unsigned>(pairs), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<float*>(c), rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kf_syrk_bf16_wgmma(const void* a, void* c, int rows, int n, void* stream) {
  return launch_wgmma(syrk_bf16_wgmma_kernel, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, c, rows, n,
                      stream);
}

extern "C" int kf_syrk_f16_wgmma(const void* a, void* c, int rows, int n, void* stream) {
  return launch_wgmma(syrk_f16_wgmma_kernel, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a, c, rows, n,
                      stream);
}

extern "C" int kf_syrk_bf16(const void* a, void* c, int rows, int n, void* stream) {
  return launch_wmma<__nv_bfloat16>(a, c, rows, n, stream);
}

extern "C" int kf_syrk_f16(const void* a, void* c, int rows, int n, void* stream) {
  return launch_wmma<__half>(a, c, rows, n, stream);
}

// fp32: the ring kernel over `splits` row ranges of `span` rows (the plan of
// ops/kernels/syrk.py:f32_plan); with one range it writes C, with several
// their partials go to `partial` (triangle tiles x splits x 64 KB) and the
// reduction kernel writes C. `vec` promises n % 4 == 0 and a 16-byte
// aligned base.
extern "C" int kf_syrk_f32(const void* a, void* c, void* partial, int rows, int n, int span,
                           int splits, int vec, void* stream) {
  if (rows <= 0 || n <= 0 || splits <= 0 || span <= 0 ||
      static_cast<long long>(span) * splits < rows || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = vec ? reinterpret_cast<const void*>(syrk_f32_ring_kernel<true>)
                           : reinterpret_cast<const void*>(syrk_f32_ring_kernel<false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32SmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(triangle_pairs(n, kTile)), static_cast<unsigned>(splits));
  auto* s = static_cast<cudaStream_t>(stream);
  if (vec)
    syrk_f32_ring_kernel<true><<<grid, kThreadsF, kF32SmemBytes, s>>>(
        static_cast<const float*>(a), static_cast<float*>(c), static_cast<float4*>(partial), rows,
        n, span);
  else
    syrk_f32_ring_kernel<false><<<grid, kThreadsF, kF32SmemBytes, s>>>(
        static_cast<const float*>(a), static_cast<float*>(c), static_cast<float4*>(partial), rows,
        n, span);
  return static_cast<int>(cudaGetLastError());
}

// The sum of kf_syrk_f32's `splits` partials into C, in range order.
extern "C" int kf_syrk_f32_reduce(const void* partial, void* c, int n, int splits, void* stream) {
  if (n <= 0 || splits <= 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(syrk_f32_reduce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kStagingBytesF);
  if (err != cudaSuccess) return static_cast<int>(err);
  syrk_f32_reduce_kernel<<<static_cast<unsigned>(triangle_pairs(n, kTile)), kThreadsF,
                           kStagingBytesF, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(partial), static_cast<float*>(c), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spill) bytes a thread and CTAs an SM of the ring
// kernel (which 0: 16-byte copies, 1: 4-byte copies) or the reduction (2).
extern "C" int kf_syrk_f32_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  const void* fn = which == 0   ? reinterpret_cast<const void*>(syrk_f32_ring_kernel<true>)
                   : which == 1 ? reinterpret_cast<const void*>(syrk_f32_ring_kernel<false>)
                                : reinterpret_cast<const void*>(syrk_f32_reduce_kernel);
  const int bytes = which == 2 ? kStagingBytesF : kF32SmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreadsF, bytes));
}
