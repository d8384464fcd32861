// Flash-attention forward for fp32 (B, H, T, D) operands at D 128 and D 256,
// T a multiple of 64: FFS, one deterministic kernel of register-tiled fp32
// FMAs, templated over D and the key step.
//
// Replaces, for fp32 at D 128 and D 256, the TPU kernel of JAX's Pallas flash
// attention forward that kronfluence_tpu/ops/attention.py:_flash_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py:
// `_flash_attention_impl` :589, its pallas_call :758). FFS64
// (flash_forward_f32_d64.cu) takes fp32 at D 64 and FFW (flash_forward_d256.cu)
// bf16 at D 256 (ops/kernels/flash.py:forward_route).
// Semantics are F1's: logits = (Q K^T) * scale, plus -0.7 * FLT_MAX where the
// key is above the diagonal or in another segment; O = softmax(logits) V,
// with the row max m (natural-log units) and the row sum l of exp(logit - m).
// Everything is fp32: P is not rounded. The mask value is added, as F1 adds
// it, so every logit stays finite: a padded query row whose first key step
// holds none of its keys (row 100 of an example that keeps 70 tokens, against
// keys 0-63) runs its max at about -0.7 FLT_MAX there, and the next step's
// rescale exp(that - m) is exactly 0. Every output element is summed by one
// thread in a fixed order, with no atomics: two calls give the same bits.
//
// What bounds it on the H100. At B 16, T 512, padded, H 6 at D 128 or H 3 at
// D 256, the kept query-key pairs take 4 D FLOPs each: 4.7 GFLOP, 0.070 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores, against 0.030 ms for the
// 101 MB of Q, K, V and O at 3.35 TB/s. So the FMA units bound it. It
// computes every 64-query by kKeys-key tile pair up to the diagonal, 7.25
// GFLOP, 0.108 ms at that peak. F1 multiplied fp32 tiles in mma.sync's
// fragment layout from scalar shared loads (4 bytes an FMA), ran 2 CTAs of 4
// warps an SM at D 128 and 1 at D 256, and loaded K and V between two
// barriers a step, under no product.
//
// What the design does about it (F2SH's and F3SH's register tiling,
// flash_backward_f32_d128.cu):
//  * one CTA of 8 warps per (64-query tile, head, batch), the last query
//    tiles (the most keys) launched first, key steps of kKeys from key 0 to
//    the tile's last row. Q and the query segment ids stay in shared memory
//    in rows of D + 4 floats; K, V and the key segment ids come in by 16-byte
//    cp.async through a two-stage ring, the next step's copy under this
//    step's products: one CTA-wide barrier a step;
//  * thread (r, c) = (tid / C, tid % C), C = kKeys / 4 the threads that share
//    a query row (lanes of one warp), owns S at query rows r + R i (R = 256 /
//    C, i < 64 / R) and keys c + C j (j < 4), and O at the same rows and the
//    float4 columns c + C h (h < D / 4C). S = Q K^T is an NT product of
//    float4 fragments; the step's row max is reduced over the row's C lanes
//    by shuffles; P goes to shared memory, read back by its own warp alone
//    (a warp barrier); O += P V is an NN product whose P fragments are
//    float4 along the keys. The row sum l stays a partial a thread until the
//    end; O is divided by l once;
//  * at D 128, 64-key steps: a thread holds a 4 x 4 S tile and a 4 x 8 O
//    tile, 190,208 bytes of shared memory, one CTA an SM; at D 256, 32-key
//    steps (64 would take 266 KB): 2 x 4 and 2 x 32, 210,432 bytes, one CTA
//    an SM. Each NT step reads 4 + 4 or 2 + 4 float4 for 64 or 32 FMAs,
//    each NN step kRows + 4 kChunks float4 for 16 kRows kChunks FMAs. On an
//    H100 the 64-key step at D 128 took 18% less device time than a 32-key
//    step (2 x 4 and 2 x 16 tiles, 112,128 bytes, two CTAs an SM, registers
//    capped at 128), which `chip_smoke.py --profile-flash` times;
//  * the pitches put each warp's float4 reads of Q, K, V and P, and its
//    scalar stores of P, in distinct banks or on one address;
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

constexpr int kThreads = 256;                          // 8 warps
constexpr int kTile = 64;                              // query rows a CTA; T's granularity
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // -0.7 * FLT_MAX, F1's
constexpr int kSmemPerSm = 233472;                     // shared memory of an SM, bytes
constexpr int kSmemPerCta = 1024;                      // what the runtime keeps a CTA
// Keys a step at D 128 (at D 256 only 32 fit); the other width is timed by
// `chip_smoke.py --profile-flash`.
constexpr int kD128Keys = 64;

// FFS's shape at head dim D and kKeys keys a step; shared memory in bytes:
// Q, the query segment ids, two stages of K, two of V, two of the key
// segment ids, then P (query rows, key columns).
template <int D, int kKeys>
struct Ffs {
  static constexpr int kLd = D + 4;                  // pitch of Q, K and V rows, floats
  static constexpr int kC = kKeys / 4;               // threads that share a query row
  static constexpr int kR = kThreads / kC;           // stride of a thread's rows
  static constexpr int kRows = kTile / kR;           // query rows a thread
  static constexpr int kChunks = D / (4 * kC);       // O's float4 columns a thread
  static constexpr int kLdP = kKeys + kC;            // pitch of P rows, floats
  static constexpr int kKeyBytes = kKeys * kLd * 4;  // one stage of K or V
  static constexpr int kSmemQ = 0;
  static constexpr int kSmemSegQ = kTile * kLd * 4;
  static constexpr int kSmemK = kSmemSegQ + kTile * 4;
  static constexpr int kSmemV = kSmemK + 2 * kKeyBytes;
  static constexpr int kSmemSegK = kSmemV + 2 * kKeyBytes;
  static constexpr int kSmemP = kSmemSegK + 2 * kKeys * 4;
  static constexpr int kSmemBytes = kSmemP + kTile * kLdP * 4;
  // CTAs an SM the registers are capped for: two where two fit.
  static constexpr int kCtas = 2 * (kSmemBytes + kSmemPerCta) <= kSmemPerSm ? 2 : 1;
  static_assert(32 % kC == 0 && kC * kR == kThreads && kRows * kR == kTile &&
                    kChunks * 4 * kC == D,
                "FFS tiles");
  static_assert(kSmemBytes <= 232448, "FFS shared memory");
};

// rows x D fp32 from device memory (row pitch D) into a padded shared tile
// at shared address `dst`, by kThreads threads from `tid` on.
template <int D, int kRows>
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* src, int tid) {
  constexpr int kPerRow = D / 4;
  static_assert((kRows * kPerRow) % kThreads == 0, "copy_rows split");
#pragma unroll
  for (int n = 0; n < kRows * kPerRow / kThreads; ++n) {
    const int c = tid + n * kThreads;
    const int r = c / kPerRow, cc = (c % kPerRow) * 4;
    cp_async16(dst + (r * (D + 4) + cc) * 4, src + static_cast<size_t>(r) * D + cc);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// NT form: acc[i][j] += sum over d < D of A[ra + kSA i][d] * B[rb + kSB j][d],
// A and B shared tiles of pitch D + 4. Each step reads kI float4 of A and kJ
// of B for 4 kI kJ FMAs; each output sums d in order.
template <int D, int kI, int kSA, int kJ, int kSB>
__device__ __forceinline__ void nt_product(float (&acc)[kI][kJ], const float* a, int ra,
                                           const float* b, int rb) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x[kI], y[kJ];
#pragma unroll
    for (int i = 0; i < kI; ++i) x[i] = ld4(a + (ra + kSA * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < kJ; ++j) y[j] = ld4(b + (rb + kSB * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
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

template <int D, int kKeys>
__global__ void __launch_bounds__(kThreads, Ffs<D, kKeys>::kCtas)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         float* __restrict__ o, float* __restrict__ l_out,
                         float* __restrict__ m_out, int H, int T_len, float scale) {
  using S = Ffs<D, kKeys>;
  constexpr int kC = S::kC, kR = S::kR, kRows = S::kRows, kChunks = S::kChunks;
  constexpr int kLd = S::kLd, kLdP = S::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const float* fsm = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x;
  const int r = tid / kC, c = tid % kC;
  const int bh = blockIdx.x;                             // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int n_steps = (q0 + kTile) / kKeys;  // keys 0 to the tile's last row

  auto load_keys = [&](int stage, int k0) {
    copy_rows<D, kKeys>(s0 + S::kSmemK + stage * S::kKeyBytes, k + (base + k0) * D, tid);
    copy_rows<D, kKeys>(s0 + S::kSmemV + stage * S::kKeyBytes, v + (base + k0) * D, tid);
    if (tid < kKeys / 4)
      cp_async16(s0 + S::kSmemSegK + (stage * kKeys + tid * 4) * 4, segb + k0 + tid * 4);
  };

  copy_rows<D, kTile>(s0 + S::kSmemQ, q + (base + q0) * D, tid);
  if (tid < kTile / 4) cp_async16(s0 + S::kSmemSegQ + tid * 16, segb + q0 + tid * 4);
  load_keys(0, 0);
  cp_async_commit();

  const float* qs = fsm + S::kSmemQ / 4;
  const int* seg_q = reinterpret_cast<const int*>(smem + S::kSmemSegQ);
  float* ps = reinterpret_cast<float*>(smem + S::kSmemP);
  float acc[kRows][4 * kChunks];  // O at rows r + kR i, columns 4 (c + kC h) + e
  zero(acc);
  float m_r[kRows], l_r[kRows];  // running row max; this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }

  for (int it = 0; it < n_steps; ++it) {
    const int stage = it & 1, k0 = it * kKeys;
    // Waits for this step's tiles; the barrier also marks the other stage
    // and P free (every warp is done with the step before) for the copy
    // below.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_steps) load_keys(stage ^ 1, k0 + kKeys);
    cp_async_commit();
    const float* ks = fsm + (S::kSmemK + stage * S::kKeyBytes) / 4;
    const float* vs = fsm + (S::kSmemV + stage * S::kKeyBytes) / 4;
    const int* seg_k = reinterpret_cast<const int*>(smem + S::kSmemSegK) + stage * kKeys;

    float s[kRows][4];
    zero(s);
    nt_product<D, kRows, kR, 4, kC>(s, qs, r, ks, c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = r + kR * i;
      const int seg_r = seg_q[row];
      float mx = m_r[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c + kC * j;
        float x = s[i][j] * scale;
        if (!(k0 + col <= q0 + row && seg_k[col] == seg_r)) x += kMaskValue;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kC / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m_r[i] - mx);  // 0 at the first step
      m_r[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        sum += p;
        ps[row * kLdP + c + kC * j] = p;
      }
      l_r[i] = l_r[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 4 * kChunks; ++e) acc[i][e] *= alpha;
    }
    // A warp reads back only the rows of P its own lanes wrote.
    __syncwarp();
    // O += P V: each step reads kRows float4 of P (4 keys of a row) and 4
    // kChunks of V for 16 kRows kChunks FMAs; each output sums the keys in
    // order.
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pf[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pf[i] = ld4(ps + (r + kR * i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * kLd + 4 * c;
#pragma unroll
        for (int h = 0; h < kChunks; ++h) {
          const float4 y = ld4(vrow + 4 * kC * h);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = lane(pf[i], u);
            acc[i][4 * h + 0] = fmaf(p, y.x, acc[i][4 * h + 0]);
            acc[i][4 * h + 1] = fmaf(p, y.y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(p, y.z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(p, y.w, acc[i][4 * h + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    // The row sum over the row's kC lanes; every lane gets the same bits.
    float l = l_r[i];
#pragma unroll
    for (int off = kC / 2; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const size_t row = base + q0 + r + kR * i;
    float* orow = o + row * D + 4 * c;
#pragma unroll
    for (int h = 0; h < kChunks; ++h)
      *reinterpret_cast<float4*>(orow + 4 * kC * h) =
          make_float4(acc[i][4 * h] / l, acc[i][4 * h + 1] / l, acc[i][4 * h + 2] / l,
                      acc[i][4 * h + 3] / l);
    if (c == 0) {
      l_out[row] = l;
      m_out[row] = m_r[i];
    }
  }
}

template <int D, int kKeys>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o, void* l,
           void* m, int B, int H, int T_len, float scale, cudaStream_t stream) {
  constexpr int kBytes = Ffs<D, kKeys>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, kKeys>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / kTile);
  flash_fwd_f32_kernel<D, kKeys><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(l),
      static_cast<float*>(m), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kKeys>
int occupancy(int* regs, int* local_bytes, int* ctas) {
  const void* fn = reinterpret_cast<const void*>(flash_fwd_f32_kernel<D, kKeys>);
  constexpr int kBytes = Ffs<D, kKeys>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, kBytes));
}

bool valid_shape(int B, int H, int T_len) {
  return B > 0 && H > 0 && T_len > 0 && T_len % kTile == 0 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && T_len / kTile <= 65535;
}

}  // namespace

// q, k, v: fp32 (B, H, T, D), D 128 or 256; seg: int32 (B, T); o: fp32 (B, H,
// T, D) out; l, m: fp32 (B, H, T) out. Every pointer 16-byte aligned, T a
// multiple of 64. Returns a CUDA error code (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int kf_flash_fwd_f32(const void* q, const void* k, const void* v, const void* seg,
                                void* o, void* l, void* m, int B, int H, int T_len, int D,
                                float scale, void* stream) {
  if (!valid_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch<128, kD128Keys>(q, k, v, seg, o, l, m, B, H, T_len, scale, s);
    case 256: return launch<256, 32>(q, k, v, seg, o, l, m, B, H, T_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// For measurement: the registers a thread, the local (spill) bytes a thread
// and the CTAs an SM of FFS at D 128 (which 0) or D 256 (which 1) at its
// shared memory.
extern "C" int kf_flash_fwd_f32_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  return which == 0 ? occupancy<128, kD128Keys>(regs, local_bytes, ctas)
                    : occupancy<256, 32>(regs, local_bytes, ctas);
}
