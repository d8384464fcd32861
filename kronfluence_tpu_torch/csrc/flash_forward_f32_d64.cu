// Flash-attention forward for fp32 (B, H, T, 64) operands, T a multiple of
// 128: FFS64, one deterministic kernel of fp32 FMAs on register tiles summed
// as outer products.
//
// Replaces, for fp32 at D 64, the TPU kernel of JAX's Pallas flash attention
// forward that kronfluence_tpu/ops/attention.py:_flash_attention reaches
// (jax/experimental/pallas/ops/tpu/flash_attention.py: `_flash_attention_impl`
// :589, its pallas_call :758). F1 (flash_attention.cu) held this route before
// and stays callable as its yardstick. Semantics are F1's and FFS's
// (flash_forward_f32.cu): logits = (Q K^T) * scale, plus -0.7 * FLT_MAX where
// the key is above the diagonal or in another segment (added, so every logit
// stays finite); O = softmax(logits) V, with the row max m (natural-log
// units) and the row sum l of exp(logit - m). Everything is fp32: P is not
// rounded. Every output element is summed by one thread in a fixed order,
// with no atomics: two calls give the same bits.
//
// What bounds it on the H100. At B 16, H 12, T 512, padded, the kept
// query-key pairs take 4 D FLOPs each: 4.69 GFLOP, 0.070 ms at the 67
// TFLOP/s of fp32 outside the tensor cores, against 0.015 ms for the 50 MB of
// Q, K, V and O at 3.35 TB/s. So the FMA units bound it. F1 multiplies in
// mma.sync's fragment layout from scalar shared loads (4 bytes an FMA) on a
// 64-query tile; FFS's 4 x 4 thread tiles load 2 shared bytes an FMA.
//
// What the design does about it:
//  * both products are sums of outer products, as K1's fp32 ring kernel's
//    (syrk.cu:syrk_f32_ring_kernel): S = Q K^T over d from Q^T and K^T, O +=
//    P V over the keys from P^T and V. A step reads kRowsPerThread / 4 + 2
//    float4 for 8 kRowsPerThread FMAs. So Q, K and P sit in shared memory
//    transposed: Q^T is written once from registers, K^T every step from
//    registers whose loads run under the step before's O += P V, and the
//    softmax writes P^T by float4 columns; V comes in by 16-byte cp.async
//    under S = Q K^T, the next step's key segment ids under O += P V;
//  * lane (c, r) = (lane / 4, lane % 4) of warp w holds the query rows 16 w
//    + 4 r + u (u < 4; as built, 4 rows a thread), and the keys 4 c + v and
//    32 + 4 c + v of S (v < 4) and the same columns of O: a 4 x 8 S tile and
//    a 4 x 8 O tile, 64 accumulators, 128 registers. One CTA of 8 warps per
//    (128-query tile, head, batch), the last query tiles (the most keys)
//    launched first, 64-key steps from key 0 to the tile's last row; two
//    CTAs an SM, so four warps a scheduler. With kRowsPerThread 8 the lane
//    holds 8 x 8 tiles (rows 32 w + 4 r + u and 32 w + 16 + 4 r + u, one
//    shared byte an FMA) in 4 warps, but its 128 accumulators take 255
//    registers and leave two warps a scheduler to hide the softmax, the
//    shuffles, the copies and the barriers: on an H100 it lost to the 4 x 8
//    tile (`chip_smoke.py --profile-flash` times the two);
//  * a warp skips the products of a step whose first key lies past its last
//    row (it still meets the barriers): the causal mask would drop every
//    pair of it, and exp gives those keys exactly 0 against a row max that
//    an earlier step set (each row keeps its own key, which came before), so
//    the skip changes no bit. The computed pairs are those of 64-query
//    tiles;
//  * the step's row max is reduced over the row's 8 lanes by shuffles, the
//    softmax a phase at a time over the thread's rows; l stays a partial a
//    thread until the end; O is divided by l once. Every logit takes the
//    mask test: a branch that skipped it where a step and a warp hold one
//    segment below the diagonal cost registers and spills, and was slower;
//  * two CTA-wide barriers a step (K^T stored and V's buffer free; V landed
//    and K^T free). 102,144 bytes of shared memory. Pitches of 132 floats
//    for Q^T and P^T and 68 for K^T put each warp's float4 reads, its float4
//    stores of P^T (the lane order above) and its scalar stores of Q^T and
//    K^T in distinct banks or on one address;
//  * exp is `expf` on the raw logit minus m (no log2 e prescale, which would
//    overflow the mask value).
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace kf_flash;

constexpr int kD = 64;                                 // head dim
// Query rows a thread: 4 (a 4 x 8 tile, as built) or 8 (8 x 8, timed by
// `chip_smoke.py --profile-flash`).
constexpr int kRowsPerThread = 4;
constexpr int kRowBlocks = kRowsPerThread / 4;         // float4 of rows a thread
constexpr int kThreads = 32 * 32 / kRowsPerThread;     // 8 warps (4 at 8 rows)
constexpr int kTile = 128;                             // query rows a CTA; T's granularity
constexpr int kKeys = 64;                              // keys a step
constexpr int kWarpRows = kTile / (kThreads / 32);     // query rows a warp
constexpr int kLdQ = kTile + 4;                        // pitch of Q^T and P^T rows, floats
constexpr int kLdK = kKeys + 4;                        // pitch of K^T rows
constexpr int kLdV = kD;                               // pitch of V rows
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // -0.7 * FLT_MAX, F1's
// Steps of the two products' loops (over d, over the keys) unrolled together.
constexpr int kUnroll = 16;

// Shared memory in bytes: Q^T (d, query), K^T (d, key), V (key, d), P^T
// (key, query), the query and the key segment ids.
constexpr int kSmemQt = 0;
constexpr int kSmemKt = kSmemQt + kD * kLdQ * 4;
constexpr int kSmemV = kSmemKt + kD * kLdK * 4;
constexpr int kSmemPt = kSmemV + kKeys * kLdV * 4;
constexpr int kSmemSegQ = kSmemPt + kKeys * kLdQ * 4;
constexpr int kSmemSegK = kSmemSegQ + kTile * 4;
constexpr int kSmemBytes = kSmemSegK + kKeys * 4;
static_assert((kRowsPerThread == 4 || kRowsPerThread == 8) && kWarpRows == 4 * kRowsPerThread,
              "FFS64 tiles");
static_assert(2 * (kSmemBytes + 1024) <= 233472, "two CTAs an SM");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The tile row of the thread's u-th row from its first.
__device__ __forceinline__ int row_of(int rows, int u) { return rows + (u & 3) + 16 * (u >> 2); }

// acc[u][v] += a[u] b[v] for the thread's tile: rows the float4 at a0 (and a0
// + 16), columns the float4 at b0 and b0 + 32.
__device__ __forceinline__ void outer_product(float (&acc)[kRowsPerThread][8], const float* a0,
                                              const float* b0) {
  float a[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowBlocks; ++i) {
    const float4 x = ld4(a0 + 16 * i);
    a[4 * i] = x.x;
    a[4 * i + 1] = x.y;
    a[4 * i + 2] = x.z;
    a[4 * i + 3] = x.w;
  }
  const float4 y0 = ld4(b0), y1 = ld4(b0 + 32);
  const float b[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
}

__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32_d64_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const int* __restrict__ seg,
                             float* __restrict__ o, float* __restrict__ l_out,
                             float* __restrict__ m_out, int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem + kSmemQt);
  float* kt = reinterpret_cast<float*>(smem + kSmemKt);
  const float* vs = reinterpret_cast<const float*>(smem + kSmemV);
  float* pt = reinterpret_cast<float*>(smem + kSmemPt);
  int* seg_q = reinterpret_cast<int*>(smem + kSmemSegQ);
  int* seg_k = reinterpret_cast<int*>(smem + kSmemSegK);
  const uint32_t v_smem = static_cast<uint32_t>(__cvta_generic_to_shared(smem + kSmemV));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane / 4, r = lane % 4;
  const int bh = blockIdx.x;                             // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int n_steps = (q0 + kTile) / kKeys;  // keys 0 to the tile's last row
  const int rows = warp * kWarpRows + 4 * r;  // the thread's first row in the tile
  const int warp_last = q0 + warp * kWarpRows + kWarpRows - 1;  // the warp's last row

  // Q^T once: thread t transposes a share of query row t % 128 (consecutive
  // lanes, distinct banks).
  {
    constexpr int kParts = kThreads / kTile;
    const int row = tid % kTile, part = tid / kTile;
    const float4* src = reinterpret_cast<const float4*>(q + (base + q0 + row) * kD) + part;
#pragma unroll 4
    for (int n = 0; n < kD / 4 / kParts; ++n) {
      const float4 x = src[kParts * n];
      float* col = qt + 4 * (kParts * n + part) * kLdQ + row;
      col[0] = x.x;
      col[kLdQ] = x.y;
      col[2 * kLdQ] = x.z;
      col[3 * kLdQ] = x.w;
    }
    if (part == 0) seg_q[row] = segb[q0 + row];
  }
  // K of a step into registers: thread t holds the float4 columns
  // kKParts n + t / 64 of key t % 64, stored transposed after the step's
  // last read of K^T. The key segment ids come by cp.async.
  constexpr int kKParts = kThreads / kKeys;
  const int key_t = tid % kKeys, part_t = tid / kKeys;
  float4 k_next[kD / 4 / kKParts];
  auto load_k = [&](int k0) {
    const float4* src = reinterpret_cast<const float4*>(k + (base + k0 + key_t) * kD) + part_t;
#pragma unroll
    for (int n = 0; n < kD / 4 / kKParts; ++n) k_next[n] = src[kKParts * n];
  };
  auto store_kt = [&]() {
#pragma unroll
    for (int n = 0; n < kD / 4 / kKParts; ++n) {
      float* col = kt + 4 * (kKParts * n + part_t) * kLdK + key_t;
      col[0] = k_next[n].x;
      col[kLdK] = k_next[n].y;
      col[2 * kLdK] = k_next[n].z;
      col[3 * kLdK] = k_next[n].w;
    }
  };
  auto load_seg_k = [&](int k0) {
    if (tid < kKeys / 4)
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(seg_k + 4 * tid)),
                 segb + k0 + 4 * tid);
    cp_async_commit();
  };
  load_k(0);
  store_kt();
  load_seg_k(0);

  float acc[kRowsPerThread][8];  // O at the thread's rows, columns 4 c + v and 32 + 4 c + v
  float m_r[kRowsPerThread], l_r[kRowsPerThread];  // running row max; this thread's row sums
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    m_r[u] = -INFINITY;
    l_r[u] = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) acc[u][w] = 0.f;
  }

  for (int it = 0; it < n_steps; ++it) {
    const int k0 = it * kKeys;
    // K^T and the key segment ids of this step are stored; every warp is
    // past the step before's O += P V, so V's buffer is free.
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kKeys * kD / 4 / kThreads; ++n) {
      const int e = tid + n * kThreads;
      const int row = e / (kD / 4), col = (e % (kD / 4)) * 4;
      cp_async16(v_smem + (row * kLdV + col) * 4, v + (base + k0 + row) * kD + col);
    }
    cp_async_commit();
    // Every row of this warp lies before the step's first key: no pair of
    // the step is kept.
    const bool active = k0 <= warp_last;
    if (active) {
      // S = Q K^T: 64 outer products; each logit sums d in order.
      float s[kRowsPerThread][8];
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) s[u][w] = 0.f;
#pragma unroll (kUnroll)
      for (int d = 0; d < kD; ++d) outer_product(s, qt + d * kLdQ + rows, kt + d * kLdK + 4 * c);
      int seg_r[kRowsPerThread], seg_c[8];
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        const int4 x = *reinterpret_cast<const int4*>(seg_q + rows + 16 * i);
        seg_r[4 * i] = x.x;
        seg_r[4 * i + 1] = x.y;
        seg_r[4 * i + 2] = x.z;
        seg_r[4 * i + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int4 x = *reinterpret_cast<const int4*>(seg_k + 32 * i + 4 * c);
        seg_c[4 * i] = x.x;
        seg_c[4 * i + 1] = x.y;
        seg_c[4 * i + 2] = x.z;
        seg_c[4 * i + 3] = x.w;
      }
      // The softmax a phase at a time over the thread's rows, so that their
      // reductions and exps overlap.
      float mx[kRowsPerThread];
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        const int row = q0 + row_of(rows, u);
        mx[u] = m_r[u];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          float x = s[u][w] * scale;
          if (!(k0 + 4 * c + (w & 3) + 32 * (w >> 2) <= row && seg_c[w] == seg_r[u]))
            x += kMaskValue;
          s[u][w] = x;
          mx[u] = fmaxf(mx[u], x);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int u = 0; u < kRowsPerThread; ++u)
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], off));
      float alpha[kRowsPerThread];
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        alpha[u] = expf(m_r[u] - mx[u]);  // 0 at the first step
        m_r[u] = mx[u];
      }
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          s[u][w] = expf(s[u][w] - mx[u]);
          sum += s[u][w];
        }
        l_r[u] = l_r[u] * alpha[u] + sum;
      }
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) acc[u][w] *= alpha[u];
      // P^T: key 4 c + w (+ 32) holds the thread's rows as float4.
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        float* col = pt + (4 * c + (w & 3) + 32 * (w >> 2)) * kLdQ + rows;
#pragma unroll
        for (int i = 0; i < kRowBlocks; ++i)
          st4(col + 16 * i, s[4 * i][w], s[4 * i + 1][w], s[4 * i + 2][w], s[4 * i + 3][w]);
      }
    }
    // The next step's K, in flight under this step's O += P V.
    if (it + 1 < n_steps) load_k(k0 + kKeys);
    // V has landed; every warp is past its S = Q K^T, so K^T and the key
    // segment ids are free, and each warp's P^T stores come before its
    // reads.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_steps) load_seg_k(k0 + kKeys);
    if (active) {
      // O += P V: 64 outer products; each output sums the keys in order.
#pragma unroll (kUnroll)
      for (int kk = 0; kk < kKeys; ++kk)
        outer_product(acc, pt + kk * kLdQ + rows, vs + kk * kLdV + 4 * c);
    }
    if (it + 1 < n_steps) store_kt();
  }

#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    // The row sum over the row's 8 lanes; every lane gets the same bits.
    float l = l_r[u];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const size_t row = base + q0 + row_of(rows, u);
    float* orow = o + row * kD + 4 * c;
    st4(orow, acc[u][0] / l, acc[u][1] / l, acc[u][2] / l, acc[u][3] / l);
    st4(orow + 32, acc[u][4] / l, acc[u][5] / l, acc[u][6] / l, acc[u][7] / l);
    if (c == 0) {
      l_out[row] = l;
      m_out[row] = m_r[u];
    }
  }
}

bool valid_shape(int B, int H, int T_len) {
  return B > 0 && H > 0 && T_len > 0 && T_len % kTile == 0 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && T_len / kTile <= 65535;
}

}  // namespace

// q, k, v: fp32 (B, H, T, D), D 64; seg: int32 (B, T); o: fp32 (B, H, T, D)
// out; l, m: fp32 (B, H, T) out. Every pointer 16-byte aligned, T a multiple
// of 128. Returns a CUDA error code (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int kf_flash_fwd_f32_d64(const void* q, const void* k, const void* v,
                                    const void* seg, void* o, void* l, void* m, int B, int H,
                                    int T_len, int D, float scale, void* stream) {
  if (D != kD || !valid_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_d64_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_fwd_f32_d64_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(l),
      static_cast<float*>(m), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// For measurement: the registers a thread, the local (spill) bytes a thread
// and the CTAs an SM of FFS64 (which 0) at its shared memory.
extern "C" int kf_flash_fwd_f32_d64_occupancy(int which, int* regs, int* local_bytes,
                                              int* ctas) {
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(flash_fwd_f32_d64_kernel);
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
