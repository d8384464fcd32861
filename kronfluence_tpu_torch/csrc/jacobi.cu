// Brent-Luk scalar-Jacobi rotations of a batch of symmetric pivot blocks.
//
// Replaces the TPU kernel kronfluence_tpu/ops/pallas/jacobi.py:_jacobi_kernel
// (called through jacobi_pivot_rotations). S is (Y, m, m) fp32, symmetric, m
// even; V is (Y, m, m) fp32 and orthogonal, with V^T S V closer to diagonal.
// The kernel runs sweeps * (m - 1) rounds. A round pairs the adjacent seats
// (2k, 2k+1), computes Rutishauser's (c, s) for each pair with the eps * scale
// skip and c = rsqrt(1 + t^2), rotates rows then columns of A and the columns
// of V, and moves every seat by the Brent-Luk exchange sigma. V comes out in
// the TPU kernel's column layout.
//
// What bounds it on the H100. Per block and round the work is ~9 m^2 fp32
// operations (rows, columns and V, a multiply-multiply-subtract each) and
// 4 m^2 shared-memory accesses: 36,864 operations and 64 KB at m = 64. The
// main path's largest launch (Y = 780 blocks, 2 sweeps, 126 rounds) needs
// 3.6 GFLOP, 0.054 ms at the card's 67 TFLOP/s fp32 peak, and moves
// 25.6 MB through device memory, 0.008 ms at 3.35 TB/s. Neither is the
// limit: the 126 rounds are a dependent chain, each a coefficient step and an
// update step separated by __syncthreads, and every step streams the block
// through shared memory. At 128 B/clk of shared-memory bandwidth per SM and
// 6 resident blocks per SM, one round costs ~6 x 512 = 3,072 SM clocks
// (~1.7 us at 1.75 GHz), so a 780-block launch should take ~0.2-0.3 ms.
//
// What the design does about it.
//  * One CTA per block, A and V resident in shared memory (2 x 16 KB at
//    m = 64) for the whole solve. All rounds are a loop inside the CTA: the
//    TPU kernel needed a grid axis per round (Mosaic's compile time blew up
//    on in-kernel loops), the card does not.
//  * The seats are not moved. A seat table in shared memory says which
//    original index sits at each seat; a round reads its pairs from it, and
//    V's columns are permuted by it once, in the store. A round therefore
//    has two barriers (after the coefficients, after the update), not four.
//  * The row and column rotations of a pair of pairs touch only their 2 x 2
//    tile, so one thread rotates a whole tile (rows first, then columns, the
//    TPU kernel's order) with no barrier between the two.
//  * Every product and sum is an explicitly rounded intrinsic (__fmul_rn,
//    __fsub_rn, ...), so nvcc fuses nothing into FMAs and the kernel repeats
//    the plain PyTorch version's IEEE operations in the same order.
//  * Later work: fuse the pivot extraction and the rotation products of the
//    blocked solver around it. At m = 64 (the solver's default pivot block)
//    the wrapper takes jacobi_m64.cu instead, which keeps A and V in
//    registers and moves the seats by shuffles.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 128;

// After a round, seat i holds what seat sigma(i) held.
__device__ __forceinline__ int seat_source(int i, int m) {
  if (i == 0) return 0;
  if (i == 2 || i == m - 1) return i - 1;
  return (i & 1) ? i + 2 : i - 2;
}

__device__ __forceinline__ void rotation(float app, float aqq, float apq, float eps, float& c,
                                         float& s) {
  const float denom = __fmul_rn(2.0f, apq);
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), denom == 0.0f ? 1.0f : denom);
  const float sign = tau >= 0.0f ? 1.0f : -1.0f;
  const float root = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)));
  float t = __fdiv_rn(sign, __fadd_rn(fabsf(tau), root));
  const float scale =
      __fadd_rn(__fadd_rn(__fsqrt_rn(fabsf(__fmul_rn(app, aqq))), fabsf(app)), fabsf(aqq));
  if (!(fabsf(apq) > __fmul_rn(eps, scale))) t = 0.0f;
  c = rsqrtf(__fadd_rn(1.0f, __fmul_rn(t, t)));
  s = __fmul_rn(t, c);
}

// new = c * x - s * y, rounded like the plain version's separate operations.
__device__ __forceinline__ float rot(float c, float x, float s, float y) {
  return __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
}

__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const float* __restrict__ src, float* __restrict__ dst, int m, int rounds,
                  float eps) {
  extern __shared__ float smem[];
  const int mm = m * m;
  const int half = m / 2;
  float* a = smem;                                   // m x m, by original index
  float* v = a + mm;                                 // m x m, by original index
  float* pc = v + mm;                                // per pair: c
  float* ps = pc + half;                             // per pair: s (the odd seat takes -s)
  int* pp = reinterpret_cast<int*>(ps + half);       // per pair: index at the even seat
  int* pq = pp + half;                               // per pair: index at the odd seat
  int* seat = pq + half;                             // seat -> original index
  int* next = seat + m;

  const float* s_blk = src + static_cast<size_t>(blockIdx.x) * mm;
  for (int e = threadIdx.x; e < mm; e += blockDim.x) {
    a[e] = s_blk[e];
    v[e] = (e / m == e % m) ? 1.0f : 0.0f;
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) seat[i] = i;
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int p = seat[2 * k];
      const int q = seat[2 * k + 1];
      float c, s;
      rotation(a[p * m + p], a[q * m + q], a[p * m + q], eps, c, s);
      pp[k] = p;
      pq[k] = q;
      pc[k] = c;
      ps[k] = s;
    }
    __syncthreads();

    // A: the 2 x 2 tile of rows (p, q) and columns (p2, q2), rows then columns.
    for (int u = threadIdx.x; u < half * half; u += blockDim.x) {
      const int k = u / half;
      const int k2 = u - k * half;
      const int p = pp[k], q = pq[k], p2 = pp[k2], q2 = pq[k2];
      const float c = pc[k], s = ps[k], c2 = pc[k2], s2 = ps[k2];
      const float x00 = a[p * m + p2], x01 = a[p * m + q2];
      const float x10 = a[q * m + p2], x11 = a[q * m + q2];
      const float y00 = rot(c, x00, s, x10), y01 = rot(c, x01, s, x11);
      const float y10 = rot(c, x10, -s, x00), y11 = rot(c, x11, -s, x01);
      a[p * m + p2] = rot(c2, y00, s2, y01);
      a[p * m + q2] = rot(c2, y01, -s2, y00);
      a[q * m + p2] = rot(c2, y10, s2, y11);
      a[q * m + q2] = rot(c2, y11, -s2, y10);
    }
    // V: columns (p, q) of every row.
    for (int u = threadIdx.x; u < m * half; u += blockDim.x) {
      const int i = u / half;
      const int k = u - i * half;
      const int p = pp[k], q = pq[k];
      const float c = pc[k], s = ps[k];
      const float vp = v[i * m + p], vq = v[i * m + q];
      v[i * m + p] = rot(c, vp, s, vq);
      v[i * m + q] = rot(c, vq, -s, vp);
    }
    for (int i = threadIdx.x; i < m; i += blockDim.x) next[i] = seat[seat_source(i, m)];
    __syncthreads();
    int* t = seat;
    seat = next;
    next = t;
  }

  float* v_blk = dst + static_cast<size_t>(blockIdx.x) * mm;
  for (int e = threadIdx.x; e < mm; e += blockDim.x) {
    const int i = e / m;
    v_blk[e] = v[i * m + seat[e - i * m]];
  }
}

}  // namespace

extern "C" int kf_jacobi_pivot_rotations(const void* s, void* v, int y, int m, int sweeps,
                                         float eps, void* stream) {
  if (y <= 0 || m < 4 || m > kMaxM || (m & 1) || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(m) * m * sizeof(float) +
                      2 * static_cast<size_t>(m / 2) * (sizeof(float) + sizeof(int)) +
                      2 * static_cast<size_t>(m) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  jacobi_kernel<<<y, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<float*>(v), m, sweeps * (m - 1), eps);
  return static_cast<int>(cudaGetLastError());
}
