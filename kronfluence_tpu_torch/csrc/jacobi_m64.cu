// Brent-Luk scalar-Jacobi rotations of a batch of 64 x 64 symmetric pivot
// blocks, with A and V held in registers.
//
// Replaces the TPU kernel kronfluence_tpu/ops/pallas/jacobi.py:_jacobi_kernel
// (:66, called through jacobi_pivot_rotations, pallas_call :243) at m = 64,
// the pivot block of the blocked solver's default block_size 32. The function
// is jacobi.cu's: sweeps * 63 rounds; a round pairs the adjacent seats
// (2k, 2k+1), computes each pair's Rutishauser (c, s) once (eps * scale
// skip, c = rsqrt(1 + t^2); the odd seat takes -s), rotates rows then
// columns of A and the columns of V, and moves every seat by the Brent-Luk
// exchange sigma. V comes out in the TPU kernel's column layout. Every
// product and sum is an explicitly rounded intrinsic, so nvcc fuses nothing
// into FMAs and V is the plain PyTorch version's, bit for bit.
//
// What bounds it on the H100. A block needs 9 m^2 = 36,864 fp32 operations a
// round on data that never leaves the SM, so the card's bound is operations
// (0.0204 ms at Y 294, 2 sweeps, 67 TFLOP/s). But the 126 rounds of a block are
// a dependent chain on one SM, and at Y 294 the busiest SMs hold 3 blocks:
// with every product and sum rounded on its own (no FMA) the rotations alone
// are 1,152 warp instructions a block and round, so issue sets the pace, and
// the latency of one round (coefficients -> rotations -> exchange -> barrier)
// hides behind the other blocks. At Y 780 (about 6 blocks an SM) issue does
// too.
//
// What the design does about it.
//  * One CTA of 4 warps per block. Lane k owns seat pair k's two rows; warp w
//    owns column pairs 8w .. 8w + 7. So each thread holds eight 2 x 2 tiles of
//    A and eight of V (64 floats) in registers for all rounds, and a tile's row
//    rotation (pair k's c, s) and column rotation (its column pair's) are both
//    local to the thread. Against 8 warps of 4 tiles, 4 warps issue half the
//    per-warp work (the coefficient chain, the barrier, the edge columns);
//    154 registers, 3 CTAs an SM.
//  * The seats move instead of being looked up: sigma shifts even seats up
//    one pair and odd seats down one. Rows move between lanes (one
//    __shfl_up_sync and one __shfl_down_sync a row element), columns between
//    a thread's registers, and only the edge columns of a warp's slice cross
//    warps, through a small shared buffer. No seat table, no per-element
//    index loads, no integer divides.
//  * One __syncthreads a round. Before it, each thread publishes what the
//    next round's coefficients need (the three entries of a pair's pivot,
//    read where the exchange will put them; every warp writes its own slot
//    with no branch, and lane k reads the slot of the warp that holds the
//    entry) with its edge columns; after it, every warp computes all 32
//    pairs' coefficients redundantly (lane k pair k) and hands a column
//    pair's to its owners by __shfl_sync, so no second barrier sits between
//    the coefficients and the rotations.
//  * The round is a template on the parity of its double buffer, two rounds
//    an iteration, so every shared address is fixed outside the loop.
//  * V trails A by one round: its rotation with round r - 1's coefficients
//    and its exchange are issued while round r's coefficient chain is in
//    flight.
//  * Not wgmma or TMA: rotations are not products, and TF32 would break
//    exactness.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kM = 64;
constexpr int kPairs = kM / 2;     // 32: one lane a seat pair
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = kPairs / kWarps;  // column pairs (tiles) a thread holds
constexpr unsigned kFull = 0xffffffffu;
static_assert(kCols >= 2 && kCols * kWarps == kPairs, "a warp holds at least two column pairs");

// What crosses warps in one round, double-buffered by round parity.
struct Exchange {
  // Each warp's candidates for pair k's next pivot (a_pp, a_qq, a_pq); lane k
  // reads each entry from the warp that holds it.
  float pivot[kWarps][kPairs][3];
  float2 a_up[kWarps][32];             // a warp's last even column, for the warp after it
  float2 a_down[kWarps][32];           // a warp's first odd column, for the warp before it
  float2 v_up[kWarps][32];
  float2 v_down[kWarps][32];
};

// The same arithmetic as jacobi.cu's `rotation`, operation for operation.
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

// A tile is x[0] = (even row, even column), x[1] = (even, odd),
// x[2] = (odd, even), x[3] = (odd, odd) of one seat pair x column pair.

// Columns of one tile by its column pair's (c, s); the odd column takes -s.
__device__ __forceinline__ void rotate_columns(float (&x)[4], float c, float s) {
  const float x0 = x[0], x2 = x[2];
  x[0] = rot(c, x0, s, x[1]);
  x[1] = rot(c, x[1], -s, x0);
  x[2] = rot(c, x2, s, x[3]);
  x[3] = rot(c, x[3], -s, x2);
}

// Element e of tile j, j known per lane only: a chain of selects, no
// local-memory indexing.
__device__ __forceinline__ float pick(const float (&x)[kCols][4], int j, int e) {
  float out = x[0][e];
#pragma unroll
  for (int i = 1; i < kCols; ++i) out = j == i ? x[i][e] : out;
  return out;
}

// The column half of sigma on a warp's slice. New column 2K <- old 2K - 2
// (K >= 2), 2 <- 1, 0 <- 0; new 2K + 1 <- old 2K + 3 (K <= 30), 63 <- 62.
// Inside the slice the columns move between registers; the slice's last even
// column goes to the next warp and its first odd column to the previous one.
__device__ __forceinline__ void send_and_shift_columns(float (&x)[kCols][4], int warp,
                                                       float2& up, float2& down) {
  const float last_even0 = x[kCols - 1][0], last_even1 = x[kCols - 1][2];
  up = make_float2(last_even0, last_even1);
  down = make_float2(x[0][1], x[0][3]);
#pragma unroll
  for (int j = kCols - 1; j >= 2; --j) {
    x[j][0] = x[j - 1][0];
    x[j][2] = x[j - 1][2];
  }
  // Column pair 1's even column takes column 1 (pair 0's odd) in warp 0.
  x[1][0] = warp == 0 ? x[0][1] : x[0][0];
  x[1][2] = warp == 0 ? x[0][3] : x[0][2];
#pragma unroll
  for (int j = 0; j + 1 < kCols; ++j) {
    x[j][1] = x[j + 1][1];
    x[j][3] = x[j + 1][3];
  }
  // Column 63 takes column 62 in the last warp.
  x[kCols - 1][1] = warp == kWarps - 1 ? last_even0 : x[kCols - 1][1];
  x[kCols - 1][3] = warp == kWarps - 1 ? last_even1 : x[kCols - 1][3];
}

// After the barrier: the edge columns from the neighbouring warps (warp 0
// keeps column 0; the last warp took column 62 itself).
__device__ __forceinline__ void receive_columns(float (&x)[kCols][4], int warp, int lane,
                                                const float2 (&up)[kWarps][32],
                                                const float2 (&down)[kWarps][32]) {
  const float2 e = up[warp > 0 ? warp - 1 : 0][lane];
  const float2 o = down[warp < kWarps - 1 ? warp + 1 : warp][lane];
  x[0][0] = warp > 0 ? e.x : x[0][0];
  x[0][2] = warp > 0 ? e.y : x[0][2];
  x[kCols - 1][1] = warp < kWarps - 1 ? o.x : x[kCols - 1][1];
  x[kCols - 1][3] = warp < kWarps - 1 ? o.y : x[kCols - 1][3];
}

// V's columns: rotate with one round's coefficients, then the exchange.
__device__ __forceinline__ void v_round(float (&v)[kCols][4], const float (&c2)[kCols],
                                        const float (&s2)[kCols], int warp, int lane,
                                        Exchange& out) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) rotate_columns(v[j], c2[j], s2[j]);
  send_and_shift_columns(v, warp, out.v_up[warp][lane], out.v_down[warp][lane]);
}

// Where lane k finds the next round's pivot of pair k, after the row exchange
// and before the column exchange: a_pp in column sigma(2k) (pair k - 1's even
// column; pair 0's even or odd for k = 0, 1), a_qq and a_pq in column
// sigma(2k + 1) (pair k + 1's odd column; pair 31's even for k = 31).
struct PivotSource {
  int pp_warp, pp_tile, q_warp, q_tile;
  __device__ explicit PivotSource(int lane) {
    const int pp_pair = lane <= 1 ? 0 : lane - 1;
    const int q_pair = lane == kPairs - 1 ? kPairs - 1 : lane + 1;
    pp_warp = pp_pair / kCols;
    pp_tile = pp_pair % kCols;
    q_warp = q_pair / kCols;
    q_tile = q_pair % kCols;
  }
};

// One round: A's coefficients, rotations and exchange, and V's rotation and
// exchange with the previous round's coefficients (kTrailV). kIn is the
// parity of the buffer the round reads; it writes the other.
template <int kIn, bool kTrailV>
__device__ __forceinline__ void jacobi_round(float (&a)[kCols][4], float (&v)[kCols][4],
                                             float (&c2p)[kCols], float (&s2p)[kCols],
                                             Exchange (&xch)[2], const PivotSource& src,
                                             int warp, int lane, float eps) {
  const Exchange& in = xch[kIn];
  Exchange& out = xch[kIn ^ 1];
  float c, s;
  rotation(in.pivot[src.pp_warp][lane][0], in.pivot[src.q_warp][lane][1],
           in.pivot[src.q_warp][lane][2], eps, c, s);
  if (kTrailV) v_round(v, c2p, s2p, warp, lane, out);
  const int col0 = warp * kCols;
  float c2[kCols], s2[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    c2[j] = __shfl_sync(kFull, c, col0 + j);
    s2[j] = __shfl_sync(kFull, s, col0 + j);
  }

  // A: rows by pair k's (c, s), then columns by each column pair's; then
  // the row half of sigma across lanes: new row 2k <- old 2k - 2 (lane k - 1's
  // even row; lane 1 takes lane 0's odd row, lane 0 keeps its own), new row
  // 2k + 1 <- old 2k + 3 (lane k + 1's odd row; lane 31 takes its own even).
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    float (&x)[4] = a[j];
    const float x0 = x[0], x1 = x[1];
    x[0] = rot(c, x0, s, x[2]);
    x[1] = rot(c, x1, s, x[3]);
    x[2] = rot(c, x[2], -s, x0);
    x[3] = rot(c, x[3], -s, x1);
    rotate_columns(x, c2[j], s2[j]);
    const float up0 = __shfl_up_sync(kFull, lane == 0 ? x[2] : x[0], 1);
    const float up1 = __shfl_up_sync(kFull, lane == 0 ? x[3] : x[1], 1);
    const float down0 = __shfl_down_sync(kFull, x[2], 1);
    const float down1 = __shfl_down_sync(kFull, x[3], 1);
    const float even0 = x[0], even1 = x[1];
    x[0] = lane == 0 ? even0 : up0;
    x[1] = lane == 0 ? even1 : up1;
    x[2] = lane == kPairs - 1 ? even0 : down0;
    x[3] = lane == kPairs - 1 ? even1 : down1;
  }
  // Every warp writes its candidates; lane k reads the holder's.
  float* pivot = out.pivot[warp][lane];
  pivot[0] = lane == 1 ? a[0][1] : pick(a, src.pp_tile, 0);
  pivot[1] = lane == kPairs - 1 ? a[kCols - 1][2] : pick(a, src.q_tile, 3);
  pivot[2] = lane == kPairs - 1 ? a[kCols - 1][0] : pick(a, src.q_tile, 1);
  send_and_shift_columns(a, warp, out.a_up[warp][lane], out.a_down[warp][lane]);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    c2p[j] = c2[j];
    s2p[j] = s2[j];
  }
  __syncthreads();
  receive_columns(a, warp, lane, out.a_up, out.a_down);
  if (kTrailV) receive_columns(v, warp, lane, out.v_up, out.v_down);
}

__global__ void __launch_bounds__(kThreads)
    jacobi_registers_kernel(const float* __restrict__ src, float* __restrict__ dst, int rounds,
                            float eps) {
  __shared__ Exchange xch[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = warp * kCols;  // this warp's first column pair
  const float* s_blk = src + static_cast<size_t>(blockIdx.x) * kM * kM;

  float a[kCols][4], v[kCols][4];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float2 r0 = *reinterpret_cast<const float2*>(s_blk + (2 * lane) * kM + 2 * (col0 + j));
    const float2 r1 = *reinterpret_cast<const float2*>(s_blk + (2 * lane + 1) * kM + 2 * (col0 + j));
    a[j][0] = r0.x;
    a[j][1] = r0.y;
    a[j][2] = r1.x;
    a[j][3] = r1.y;
    const float d = (col0 + j == lane) ? 1.0f : 0.0f;
    v[j][0] = d;
    v[j][1] = 0.0f;
    v[j][2] = 0.0f;
    v[j][3] = d;
  }
  // Round 0's pivots, in every warp's slot.
  xch[0].pivot[warp][lane][0] = s_blk[(2 * lane) * kM + 2 * lane];
  xch[0].pivot[warp][lane][1] = s_blk[(2 * lane + 1) * kM + 2 * lane + 1];
  xch[0].pivot[warp][lane][2] = s_blk[(2 * lane) * kM + 2 * lane + 1];
  __syncthreads();

  const PivotSource ps(lane);
  float c2p[kCols], s2p[kCols];  // V's coefficients, one round behind A
  if (rounds > 0) {
    jacobi_round<0, false>(a, v, c2p, s2p, xch, ps, warp, lane, eps);
    int r = 1;
    for (; r + 1 < rounds; r += 2) {
      jacobi_round<1, true>(a, v, c2p, s2p, xch, ps, warp, lane, eps);
      jacobi_round<0, true>(a, v, c2p, s2p, xch, ps, warp, lane, eps);
    }
    if (r < rounds) jacobi_round<1, true>(a, v, c2p, s2p, xch, ps, warp, lane, eps);
    // V's last round. Not into xch[rounds & 1]: other threads may still read
    // its edge columns.
    Exchange& out = xch[(rounds + 1) & 1];
    v_round(v, c2p, s2p, warp, lane, out);
    __syncthreads();
    receive_columns(v, warp, lane, out.v_up, out.v_down);
  }

  float* v_blk = dst + static_cast<size_t>(blockIdx.x) * kM * kM;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    *reinterpret_cast<float2*>(v_blk + (2 * lane) * kM + 2 * (col0 + j)) =
        make_float2(v[j][0], v[j][1]);
    *reinterpret_cast<float2*>(v_blk + (2 * lane + 1) * kM + 2 * (col0 + j)) =
        make_float2(v[j][2], v[j][3]);
  }
}

}  // namespace

extern "C" int kf_jacobi_pivot_rotations_m64(const void* s, void* v, int y, int sweeps, float eps,
                                             void* stream) {
  if (y <= 0 || sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  jacobi_registers_kernel<<<y, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<float*>(v), sweeps * (kM - 1), eps);
  return static_cast<int>(cudaGetLastError());
}
