// Symmetric rank-k update C = A^T A over lower-triangle output tiles.
//
// Replaces the TPU kernel kronfluence_tpu/ops/pallas/syrk.py:_syrk_kernel
// (plus that wrapper's pad, tril and mirror passes). A is (rows, n) row-major,
// in bf16 or fp32; C is (n, n) fp32 and comes out exactly symmetric.
//
// What bounds it on the H100. The lower triangle costs about n^2 * rows FLOPs
// (2 * rows * 128^2 per output tile, T(T+1)/2 tiles for T = ceil(n / 128)):
// 80 GFLOP at rows 8192, n 3072. Each CTA streams its two column stripes of A
// through shared memory once, so every stripe is re-read once per partner tile
// (T times): about 1.2 GB of reads at n 3072 in bf16, against a 50 MB operand.
// At 64 FLOP per byte read that is below the card's HBM ridge (~295 FLOP/B),
// so the re-reads must come from the 50 MB L2, and the kernel is bound by
// how fast shared memory is refilled and the tensor cores are fed.
//
// What the design does about it.
//  * One CTA per lower-triangle (i, j) tile; the pair comes from blockIdx.x,
//    so the n^2 / 2 upper tiles are never computed (the TPU grid's scalar-
//    prefetched pair tables become this index arithmetic).
//  * The TPU's sequential K grid axis is a loop over 32-row slabs inside the
//    CTA. The next slab is fetched into registers while the tensor cores work
//    on the current one, so global-load latency overlaps the MMAs.
//  * bf16 operands run on the tensor cores through wmma (mma.sync, m16n16k16,
//    fp32 accumulation). 128 x 128 output tiles halve the stripe re-reads of
//    64 x 64 tiles. fp32 operands take a register-tiled FMA kernel: the
//    tensor cores would round them to TF32.
//  * Ragged rows and columns are masked in the loads and the stores; no padded
//    copy of A is made.
//  * The epilogue writes tile (i, j) and its mirror (j, i) from the same fp32
//    values (diagonal tiles write only their lower half, then mirror it), so
//    no tril / transpose pass follows and C is exactly symmetric.
//  * Later work: wgmma with TMA-fed shared-memory rings and a persistent
//    schedule that walks tiles sharing a stripe back to back.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// Lower-triangle pair p = i(i+1)/2 + j, j <= i, enumerated row by row.
__device__ __forceinline__ void tile_pair(int p, int& ti, int& tj) {
  int i = static_cast<int>((sqrtf(8.0f * static_cast<float>(p) + 1.0f) - 1.0f) * 0.5f);
  while (i > 0 && i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  ti = i;
  tj = p - i * (i + 1) / 2;
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores, fp32 accumulation.
// ---------------------------------------------------------------------------
constexpr int kTile = 128;                             // output tile edge
constexpr int kSlab = 32;                              // rows of A per slab
constexpr int kLds = kTile + 8;                        // padded smem row (elements)
constexpr int kThreads = 256;                          // 8 warps: 2 x 4 over the tile
constexpr int kWarpM = 64;                             // tile rows per warp
constexpr int kWarpN = 32;                             // tile cols per warp
constexpr int kFragM = kWarpM / 16;
constexpr int kFragN = kWarpN / 16;
constexpr int kChunksPerRow = kTile / 8;               // 16-byte chunks per slab row
constexpr int kChunksPerThread = kSlab * kChunksPerRow / kThreads;  // 2
constexpr int kStageLd = 20;                           // padded fp32 staging row

static_assert(kSlab * kChunksPerRow % kThreads == 0, "slab chunks must split evenly");
static_assert(kSlab % 16 == 0, "slab must hold whole mma k-steps");

// Eight consecutive bf16 of row gr starting at column gc, zero outside A.
// `vec` promises n % 8 == 0 and a 16-byte aligned base pointer.
__device__ __forceinline__ uint4 load_chunk_bf16(const uint16_t* __restrict__ a, int rows, int n,
                                                 int gr, int gc, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (gr >= rows || gc >= n) return v;
  const uint16_t* src = a + static_cast<size_t>(gr) * n + gc;
  if (vec) return *reinterpret_cast<const uint4*>(src);
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

__global__ void __launch_bounds__(kThreads)
    syrk_bf16_kernel(const uint16_t* __restrict__ a, float* __restrict__ c, int rows, int n,
                     int vec) {
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
    ra[s] = load_chunk_bf16(a, rows, n, lr[s], i0 + lc[s], vec);
    rb[s] = diag ? make_uint4(0u, 0u, 0u, 0u) : load_chunk_bf16(a, rows, n, lr[s], j0 + lc[s], vec);
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
        ra[s] = load_chunk_bf16(a, rows, n, next + lr[s], i0 + lc[s], vec);
        if (!diag) rb[s] = load_chunk_bf16(a, rows, n, next + lr[s], j0 + lc[s], vec);
      }
    }

    const uint16_t(*bs)[kLds] = diag ? sa : sb;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      // A^T tile: element (m, k) = A[r0 + kk + k, i0 + m] sits at sa[kk + k][m],
      // i.e. column-major with leading dimension kLds.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[kFragN];
#pragma unroll
      for (int x = 0; x < kFragM; ++x)
        wmma::load_matrix_sync(
            fa[x], reinterpret_cast<const __nv_bfloat16*>(&sa[kk][wm * kWarpM + x * 16]), kLds);
#pragma unroll
      for (int y = 0; y < kFragN; ++y)
        wmma::load_matrix_sync(
            fb[y], reinterpret_cast<const __nv_bfloat16*>(&bs[kk][wn * kWarpN + y * 16]), kLds);
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
// fp32 operands: register-tiled FMA, 64 x 64 tiles, 4 x 4 outputs a thread.
// ---------------------------------------------------------------------------
constexpr int kTileF = 64;
constexpr int kSlabF = 16;
constexpr int kThreadsF = 256;

static_assert(kSlabF * kTileF / 4 == kThreadsF, "one float4 of each slab per thread");

// Four consecutive fp32 of row gr from column gc, zero outside A.
// `vec` promises n % 4 == 0 and a 16-byte aligned base pointer.
__device__ __forceinline__ float4 load_chunk_f32(const float* __restrict__ a, int rows, int n,
                                                 int gr, int gc, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (gr >= rows || gc >= n) return v;
  const float* src = a + static_cast<size_t>(gr) * n + gc;
  if (vec) return *reinterpret_cast<const float4*>(src);
  v.x = src[0];
  v.y = (gc + 1 < n) ? src[1] : 0.f;
  v.z = (gc + 2 < n) ? src[2] : 0.f;
  v.w = (gc + 3 < n) ? src[3] : 0.f;
  return v;
}

__global__ void __launch_bounds__(kThreadsF)
    syrk_f32_kernel(const float* __restrict__ a, float* __restrict__ c, int rows, int n, int vec) {
  __shared__ __align__(16) float sa[kSlabF][kTileF];
  __shared__ __align__(16) float sb[kSlabF][kTileF];

  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int i0 = ti * kTileF;
  const int j0 = tj * kTileF;
  const bool diag = ti == tj;
  const int tx = threadIdx.x % 16;  // output columns tx + 16 v
  const int ty = threadIdx.x / 16;  // output rows ty + 16 u
  const int lr = threadIdx.x / (kTileF / 4);
  const int lc = (threadIdx.x % (kTileF / 4)) * 4;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  float4 ra = load_chunk_f32(a, rows, n, lr, i0 + lc, vec);
  float4 rb = diag ? make_float4(0.f, 0.f, 0.f, 0.f) : load_chunk_f32(a, rows, n, lr, j0 + lc, vec);

  for (int r0 = 0; r0 < rows; r0 += kSlabF) {
    *reinterpret_cast<float4*>(&sa[lr][lc]) = ra;
    if (!diag) *reinterpret_cast<float4*>(&sb[lr][lc]) = rb;
    __syncthreads();

    const int next = r0 + kSlabF;
    if (next < rows) {
      ra = load_chunk_f32(a, rows, n, next + lr, i0 + lc, vec);
      if (!diag) rb = load_chunk_f32(a, rows, n, next + lr, j0 + lc, vec);
    }

    const float(*bs)[kTileF] = diag ? sa : sb;
#pragma unroll
    for (int k = 0; k < kSlabF; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) av[u] = sa[k][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = bs[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gi = i0 + ty + 16 * u;
      const int gj = j0 + tx + 16 * v;
      if (gi < n && gj < n && (!diag || gi >= gj)) {
        c[static_cast<size_t>(gi) * n + gj] = acc[u][v];
        c[static_cast<size_t>(gj) * n + gi] = acc[u][v];
      }
    }
  }
}

inline long long triangle_pairs(int n, int tile) {
  const long long t = (n + tile - 1) / tile;
  return t * (t + 1) / 2;
}

}  // namespace

extern "C" int kf_syrk_bf16(const void* a, void* c, int rows, int n, int vec, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = triangle_pairs(n, kTile);
  syrk_bf16_kernel<<<static_cast<unsigned>(pairs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<float*>(c), rows, n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kf_syrk_f32(const void* a, void* c, int rows, int n, int vec, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = triangle_pairs(n, kTileF);
  syrk_f32_kernel<<<static_cast<unsigned>(pairs), kThreadsF, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(c), rows, n, vec);
  return static_cast<int>(cudaGetLastError());
}
