// Causal, segment-masked flash attention: forward (F1) and backward (F2 dK/dV,
// F3 dQ) for (B, H, T, D) operands in bf16 (tensor cores, fp32 accumulation)
// or fp32 (FMA), D in {64, 128, 256}, T a multiple of 64. The routes
// (ops/kernels/flash.py) send none of them a case: they stay callable as the
// yardstick of the kernels that took their cases, FF, FFH, FFS
// (flash_forward_f32.cu: fp32 at D 128 and 256), FFS64
// (flash_forward_f32_d64.cu: fp32 at D 64), FFW (flash_forward_d256.cu: bf16
// at D 256), FB, F2H + F3H, F2W + F3W (flash_backward_d256.cu: bf16 at D 256),
// F2S + F3S, F2SH + F3SH and F2SW + F3SW (flash_backward_f32_d256.cu: fp32 at
// D 256).
//
// Replaces the TPU kernels of JAX's Pallas flash attention that
// kronfluence_tpu/ops/attention.py:_flash_attention reaches
// (jax/experimental/pallas/ops/tpu/flash_attention.py): `_flash_attention_impl`
// (F1), `_flash_attention_bwd_dkv` (F2) and `_flash_attention_bwd_dq` (F3).
// Semantics are that kernel's: logits = (Q K^T) * scale, plus mask_value =
// -0.7 * FLT_MAX where the key is above the diagonal or its segment id differs
// from the query's; F1 saves the row max m and the row sum l of exp(logit - m);
// the backward recomputes P = exp(logit - m) / l, takes di = rowsum(O * dO)
// from the caller, and forms dS = P * (dP - di) * scale. P (before P V and
// P^T dO) and dS (before dS^T Q and dS K) are rounded to the operand type, as
// the TPU kernel does before its matrix products. Every query row keeps at
// least its diagonal key (same segment, k = q), so no row is ever fully
// masked and l > 0: the kernels do not guard against it.
//
// What bounds it on the H100. At GPT-2's shape (B 16, H 12, T 512, D 64, bf16)
// F1 reads Q, K, V and writes O (4 x 12.6 MB) and does about 6.4 GFLOP under
// the causal bound: 15 us at 3.35 TB/s, 6.5 us at 989 TFLOP/s, so the bytes
// bound it. The backward is similar (dO, l, m, di in; dQ, dK, dV out).
// Attention at D 64 has a low arithmetic intensity per key tile, so what
// limits a simple kernel is the shared-memory traffic of the operand
// fragments and the serial softmax between the two products, not HBM.
//
// What the design does about it (a first, simple design; wgmma with TMA
// rings and warp specialisation are later work):
//  * one CTA per (query tile, head, batch) for F1 and F3 and per (key tile,
//    head, batch) for F2; the TPU grid's sequential key (or query) axis is a
//    loop inside the CTA that stops at the diagonal, so tiles above it are
//    never loaded;
//  * operand tiles are staged in shared memory (rows padded by 16 bytes
//    against bank conflicts); every product is a warp-level 16x8x16 step:
//    `mma.sync` m16n8k16 on bf16, or the same tile shape in fp32 FMAs, so the
//    two types share one code path and the accumulators keep mma's register
//    layout (each thread holds rows g and g + 8 of its warp's 16 rows);
//  * the online softmax keeps the running max and sum per row in registers,
//    reduced across the four threads of a quad with shuffles, and rescales
//    the O accumulators in registers;
//  * F2 gives each 16-key row group two warps: both compute half of the
//    query columns of P^T and dS^T into shared memory, then each accumulates
//    half of D's columns of dK and dV, which halves the accumulator registers
//    (D 256 would need 256 per thread otherwise);
//  * for D * sizeof(T) >= 512 bytes the inner tile is 32 rows instead of 64,
//    so K, V (F1, F3) or Q, dO (F2) fit in shared memory next to the rest.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskValue = -0.7f * 3.40282346638528859812e+38f;
constexpr int kPad = 8;  // elements of padding per shared-memory row

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t bits16(const bf16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

// acc (16 x 8, mma's C layout) += A (16 x 16) * B (16 x 8).
// A(i, k) = a[i * lda + k]; B(k, n) = b[n * ldb + k] when kBNK, else
// b[k * ldb + n].
template <bool kBNK>
__device__ __forceinline__ void mma_tile(float acc[4], const bf16* a, int lda, const bf16* b,
                                         int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ra[4], rb[2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = g + ((r & 1) ? 8 : 0);
    const int k = 2 * t + ((r & 2) ? 8 : 0);
    ra[r] = *reinterpret_cast<const uint32_t*>(a + i * lda + k);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = 2 * t + (r ? 8 : 0);
    if (kBNK) {
      rb[r] = *reinterpret_cast<const uint32_t*>(b + g * ldb + k);
    } else {
      rb[r] = bits16(b + k * ldb + g) | (bits16(b + (k + 1) * ldb + g) << 16);
    }
  }
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "r"(rb[0]), "r"(rb[1]));
}

template <bool kBNK>
__device__ __forceinline__ void mma_tile(float acc[4], const float* a, int lda, const float* b,
                                         int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float a0 = a[g * lda + k];
    const float a1 = a[(g + 8) * lda + k];
    const float b0 = kBNK ? b[(2 * t) * ldb + k] : b[k * ldb + 2 * t];
    const float b1 = kBNK ? b[(2 * t + 1) * ldb + k] : b[k * ldb + 2 * t + 1];
    acc[0] = fmaf(a0, b0, acc[0]);
    acc[1] = fmaf(a0, b1, acc[1]);
    acc[2] = fmaf(a1, b0, acc[2]);
    acc[3] = fmaf(a1, b1, acc[3]);
  }
}

// Copies `rows` rows of D elements (global row stride D) into shared memory
// (row stride D + kPad) in 16-byte chunks.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows, int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int c = tid; c < rows * kChunks; c += nthreads) {
    const int r = c / kChunks, cc = (c % kChunks) * kVec;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + cc) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + cc);
  }
}

template <typename T, int D>
struct Tiles {
  static constexpr int kLd = D + kPad;
  static constexpr int kInner = (D * static_cast<int>(sizeof(T)) >= 512) ? 32 : 64;
  static constexpr int kRows = 64;  // the CTA's own tile (queries or keys)
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// F1: forward. 4 warps, each owns 16 of the CTA's 64 query rows.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(128)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ l_out,
                     float* __restrict__ m_out, int H, int T_len, float scale) {
  using Tl = Tiles<T, D>;
  constexpr int kLd = Tl::kLd, BK = Tl::kInner, BQ = Tl::kRows, kLdp = BK + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BQ * kLd;
  T* vs = ks + BK * kLd;
  T* ps = vs + BK * kLd;  // 4 warps x 16 x kLdp
  int* segq = reinterpret_cast<int*>(ps + 4 * 16 * kLdp);
  int* segk = segq + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int q0 = qt * BQ;
  const T* qg = q + (bh * T_len + q0) * D;
  const T* kg = k + bh * T_len * D;
  const T* vg = v + bh * T_len * D;
  const int* segb = seg + static_cast<size_t>(b) * T_len;

  load_tile<T, D>(qs, qg, BQ, tid, 128);
  if (tid < BQ) segq[tid] = segb[q0 + tid];

  float o_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  T* pw = ps + warp * 16 * kLdp;
  const int rw = warp * 16;  // the warp's first row in the tile

  const int kt_end = (q0 + BQ - 1) / BK;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(ks, kg + static_cast<size_t>(k0) * D, BK, tid, 128);
    load_tile<T, D>(vs, vg + static_cast<size_t>(k0) * D, BK, tid, 128);
    if (tid < BK) segk[tid] = segb[k0 + tid];
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mma_tile<true>(s[j], qs + rw * kLd + d0, kLd, ks + (j * 8) * kLd + d0, kLd, lane);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + g + ((e & 2) ? 8 : 0);
        const int c = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (!(k0 + c <= q0 + r && segk[c] == segq[r])) x += kMaskValue;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_r[i], quad_max(mx[i]));
      alpha[i] = expf(m_r[i] - m_new[i]);
      m_r[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_new[e >> 1]);
        rs[e >> 1] += p;
        pw[(g + ((e & 2) ? 8 : 0)) * kLdp + j * 8 + 2 * t + (e & 1)] = from_f32<T>(p);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];
    __syncwarp();
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += 16)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_tile<false>(o_acc[n], pw + c0, kLdp, vs + c0 * kLd + n * 8, kLd, lane);
    __syncwarp();
  }

  T* og = o + (bh * T_len + q0 + rw) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + ((e & 2) ? 8 : 0);
      og[r * D + n * 8 + 2 * t + (e & 1)] = from_f32<T>(o_acc[n][e] / l_r[e >> 1]);
    }
  if (t == 0) {
    const size_t row = bh * T_len + q0 + rw + g;
    l_out[row] = l_r[0];
    m_out[row] = m_r[0];
    l_out[row + 8] = l_r[1];
    m_out[row + 8] = m_r[1];
  }
}

// ---------------------------------------------------------------------------
// F3: dQ. 4 warps, each owns 16 of the CTA's 64 query rows.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ seg, const float* __restrict__ l_in,
                        const float* __restrict__ m_in, const T* __restrict__ dout,
                        const float* __restrict__ di, T* __restrict__ dq, int H, int T_len,
                        float scale) {
  using Tl = Tiles<T, D>;
  constexpr int kLd = Tl::kLd, BK = Tl::kInner, BQ = Tl::kRows, kLdp = BK + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + BQ * kLd;
  T* ks = dos + BQ * kLd;
  T* vs = ks + BK * kLd;
  T* dss = vs + BK * kLd;  // 4 warps x 16 x kLdp
  int* segq = reinterpret_cast<int*>(dss + 4 * 16 * kLdp);
  int* segk = segq + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int q0 = qt * BQ;
  const int rw = warp * 16;
  const T* kg = k + bh * T_len * D;
  const T* vg = v + bh * T_len * D;
  const int* segb = seg + static_cast<size_t>(b) * T_len;

  load_tile<T, D>(qs, q + (bh * T_len + q0) * D, BQ, tid, 128);
  load_tile<T, D>(dos, dout + (bh * T_len + q0) * D, BQ, tid, 128);
  if (tid < BQ) segq[tid] = segb[q0 + tid];
  float m_r[2], l_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = bh * T_len + q0 + rw + g + 8 * i;
    m_r[i] = m_in[row];
    l_r[i] = l_in[row];
    di_r[i] = di[row];
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  T* dsw = dss + warp * 16 * kLdp;

  const int kt_end = (q0 + BQ - 1) / BK;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(ks, kg + static_cast<size_t>(k0) * D, BK, tid, 128);
    load_tile<T, D>(vs, vg + static_cast<size_t>(k0) * D, BK, tid, 128);
    if (tid < BK) segk[tid] = segb[k0 + tid];
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mma_tile<true>(s[j], qs + rw * kLd + d0, kLd, ks + (j * 8) * kLd + d0, kLd, lane);
        mma_tile<true>(dp[j], dos + rw * kLd + d0, kLd, vs + (j * 8) * kLd + d0, kLd, lane);
      }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = rw + g + 8 * i;
        const int c = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (!(k0 + c <= q0 + r && segk[c] == segq[r])) x += kMaskValue;
        const float p = expf(x - m_r[i]) / l_r[i];
        dsw[(g + 8 * i) * kLdp + c] = from_f32<T>(p * (dp[j][e] - di_r[i]) * scale);
      }
    __syncwarp();
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += 16)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_tile<false>(dq_acc[n], dsw + c0, kLdp, ks + c0 * kLd + n * 8, kLd, lane);
    __syncwarp();
  }

  T* dqg = dq + (bh * T_len + q0 + rw) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dqg[(g + ((e & 2) ? 8 : 0)) * D + n * 8 + 2 * t + (e & 1)] = from_f32<T>(dq_acc[n][e]);
}

// ---------------------------------------------------------------------------
// F2: dK and dV. 8 warps: warp w owns key rows 16 (w / 2) .. + 16 of the
// CTA's 64 keys, and half (w % 2) of the query columns (P^T, dS^T) and then
// of D's columns (dK, dV).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg,
                         const float* __restrict__ l_in, const float* __restrict__ m_in,
                         const T* __restrict__ dout, const float* __restrict__ di,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int T_len, float scale) {
  using Tl = Tiles<T, D>;
  constexpr int kLd = Tl::kLd, BQ = Tl::kInner, BK = Tl::kRows, kLdp = BQ + kPad;
  constexpr int kHalfQ = BQ / 2, kHalfD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BK * kLd;
  T* qs = vs + BK * kLd;
  T* dos = qs + BQ * kLd;
  T* pts = dos + BQ * kLd;   // BK x kLdp
  T* dsts = pts + BK * kLdp;  // BK x kLdp
  float* ms = reinterpret_cast<float*>(dsts + BK * kLdp);
  float* ls = ms + BQ;
  float* dis = ls + BQ;
  int* segq = reinterpret_cast<int*>(dis + BQ);
  int* segk = segq + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;  // keys near the start see the most queries: first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int rw = (warp >> 1) * 16, half = warp & 1;
  const int* segb = seg + static_cast<size_t>(b) * T_len;

  load_tile<T, D>(ks, k + (bh * T_len + k0) * D, BK, tid, 256);
  load_tile<T, D>(vs, v + (bh * T_len + k0) * D, BK, tid, 256);
  if (tid < BK) segk[tid] = segb[k0 + tid];

  float dk_acc[kHalfD / 8][4], dv_acc[kHalfD / 8][4];
#pragma unroll
  for (int n = 0; n < kHalfD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = k0; q0 < T_len; q0 += BQ) {
    __syncthreads();
    load_tile<T, D>(qs, q + (bh * T_len + q0) * D, BQ, tid, 256);
    load_tile<T, D>(dos, dout + (bh * T_len + q0) * D, BQ, tid, 256);
    if (tid < BQ) {
      const size_t row = bh * T_len + q0 + tid;
      ms[tid] = m_in[row];
      ls[tid] = l_in[row];
      dis[tid] = di[row];
      segq[tid] = segb[q0 + tid];
    }
    __syncthreads();

    float st[kHalfQ / 8][4], dpt[kHalfQ / 8][4];
#pragma unroll
    for (int j = 0; j < kHalfQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16)
#pragma unroll
      for (int j = 0; j < kHalfQ / 8; ++j) {
        const int c = half * kHalfQ + j * 8;
        mma_tile<true>(st[j], ks + rw * kLd + d0, kLd, qs + c * kLd + d0, kLd, lane);
        mma_tile<true>(dpt[j], vs + rw * kLd + d0, kLd, dos + c * kLd + d0, kLd, lane);
      }
#pragma unroll
    for (int j = 0; j < kHalfQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + g + ((e & 2) ? 8 : 0);  // key, local
        const int c = half * kHalfQ + j * 8 + 2 * t + (e & 1);  // query, local
        float x = st[j][e] * scale;
        if (!(k0 + r <= q0 + c && segk[r] == segq[c])) x += kMaskValue;
        const float p = expf(x - ms[c]) / ls[c];
        pts[r * kLdp + c] = from_f32<T>(p);
        dsts[r * kLdp + c] = from_f32<T>(p * (dpt[j][e] - dis[c]) * scale);
      }
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += 16)
#pragma unroll
      for (int n = 0; n < kHalfD / 8; ++n) {
        const int col = half * kHalfD + n * 8;
        mma_tile<false>(dv_acc[n], pts + rw * kLdp + c0, kLdp, dos + c0 * kLd + col, kLd, lane);
        mma_tile<false>(dk_acc[n], dsts + rw * kLdp + c0, kLdp, qs + c0 * kLd + col, kLd, lane);
      }
  }

  const size_t base = (bh * T_len + k0 + rw) * D + half * kHalfD;
#pragma unroll
  for (int n = 0; n < kHalfD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t idx = base + (g + ((e & 2) ? 8 : 0)) * D + n * 8 + 2 * t + (e & 1);
      dk[idx] = from_f32<T>(dk_acc[n][e]);
      dv[idx] = from_f32<T>(dv_acc[n][e]);
    }
}

template <typename T, int D>
size_t fwd_smem() {
  using Tl = Tiles<T, D>;
  return (Tl::kRows + 2 * Tl::kInner) * Tl::kLd * sizeof(T) +
         4 * 16 * (Tl::kInner + kPad) * sizeof(T) + (Tl::kRows + Tl::kInner) * sizeof(int);
}

template <typename T, int D>
size_t dq_smem() {
  using Tl = Tiles<T, D>;
  return (2 * Tl::kRows + 2 * Tl::kInner) * Tl::kLd * sizeof(T) +
         4 * 16 * (Tl::kInner + kPad) * sizeof(T) + (Tl::kRows + Tl::kInner) * sizeof(int);
}

template <typename T, int D>
size_t dkv_smem() {
  using Tl = Tiles<T, D>;
  return (2 * Tl::kRows + 2 * Tl::kInner) * Tl::kLd * sizeof(T) +
         2 * Tl::kRows * (Tl::kInner + kPad) * sizeof(T) + 3 * Tl::kInner * sizeof(float) +
         (Tl::kInner + Tl::kRows) * sizeof(int);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* o, float* l,
               float* m, int B, int H, int T_len, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, D>();
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T_len / Tiles<T, D>::kRows, H, B);
  flash_fwd_kernel<T, D><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
      static_cast<T*>(o), l, m, H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const int* seg, const float* l,
              const float* m, const void* dout, const float* di, void* dq, int B, int H,
              int T_len, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<T, D>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T_len / Tiles<T, D>::kRows, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg, l, m,
      static_cast<const T*>(dout), di, static_cast<T*>(dq), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const int* seg, const float* l,
               const float* m, const void* dout, const float* di, void* dk, void* dv, int B,
               int H, int T_len, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<T, D>();
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T_len / Tiles<T, D>::kRows, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg, l, m,
      static_cast<const T*>(dout), di, static_cast<T*>(dk), static_cast<T*>(dv), H, T_len,
      scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int B, int H, int T_len) {
  return B > 0 && H > 0 && T_len > 0 && T_len % 64 == 0 && H <= 65535 && B <= 65535;
}

}  // namespace

// dtype: 0 bf16, 1 fp32. D: 64, 128 or 256. seg: int32 (B, T). l, m, di:
// fp32 (B, H, T). Returns a CUDA error code (cudaErrorInvalidValue for a shape
// or type the kernels do not take).
#define KF_FLASH_DISPATCH(FN, ...)                                            \
  switch (dtype * 1000 + D) {                                                 \
    case 64: return FN<bf16, 64>(__VA_ARGS__);                                \
    case 128: return FN<bf16, 128>(__VA_ARGS__);                              \
    case 256: return FN<bf16, 256>(__VA_ARGS__);                              \
    case 1064: return FN<float, 64>(__VA_ARGS__);                             \
    case 1128: return FN<float, 128>(__VA_ARGS__);                            \
    case 1256: return FN<float, 256>(__VA_ARGS__);                            \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }

extern "C" int kf_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                            const void* seg, void* o, void* l, void* m, int B, int H, int T_len,
                            int D, float scale, void* stream) {
  if (!valid_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  KF_FLASH_DISPATCH(launch_fwd, q, k, v, static_cast<const int*>(seg), o,
                    static_cast<float*>(l), static_cast<float*>(m), B, H, T_len, scale,
                    static_cast<cudaStream_t>(stream))
}

extern "C" int kf_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* seg, const void* l, const void* m, const void* dout,
                                const void* di, void* dk, void* dv, int B, int H, int T_len,
                                int D, float scale, void* stream) {
  if (!valid_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  KF_FLASH_DISPATCH(launch_dkv, q, k, v, static_cast<const int*>(seg),
                    static_cast<const float*>(l), static_cast<const float*>(m), dout,
                    static_cast<const float*>(di), dk, dv, B, H, T_len, scale,
                    static_cast<cudaStream_t>(stream))
}

extern "C" int kf_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* seg, const void* l, const void* m, const void* dout,
                               const void* di, void* dq, int B, int H, int T_len, int D,
                               float scale, void* stream) {
  if (!valid_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  KF_FLASH_DISPATCH(launch_dq, q, k, v, static_cast<const int*>(seg),
                    static_cast<const float*>(l), static_cast<const float*>(m), dout,
                    static_cast<const float*>(di), dq, B, H, T_len, scale,
                    static_cast<cudaStream_t>(stream))
}
