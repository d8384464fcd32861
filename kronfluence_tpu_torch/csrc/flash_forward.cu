// Pipelined flash-attention forward: O, and the row max m and row sum l, of
// causal, segment-masked attention in one launch, for bf16 (B, H, T, D)
// operands with T a multiple of the query tile. One body, two instances:
// FF at D 64 (GPT-2's heads) and FFH at D 128 (Llama's).
//
// Replaces, for bf16 at D 64 and 128, the TPU kernel of JAX's Pallas flash
// attention forward that kronfluence_tpu/ops/attention.py:_flash_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py):
// `_flash_attention_impl` (:589, its pallas_call :758). The port's generic
// forward, F1 in flash_attention.cu, stays for fp32 and for D 256
// (ops/kernels/flash.py:forward_route). Semantics are F1's: logits =
// (Q K^T) * scale, plus -0.7 * FLT_MAX where the key is above the diagonal
// or in another segment (such a pair's P is exactly 0, here as in the plain
// version); O = P V / l with P = exp(logit - m) rounded to bf16 before P V;
// m and l are fp32 in natural-log units, as FB, F2, F3, F2H and F3H read
// them. Every query row keeps its diagonal key, so l > 0. No atomics: each
// CTA owns its rows, so two calls give the same bits.
//
// What bounds it on the H100. At GPT-2's shape (B 16, H 12, T 512, D 64,
// padded segments) the function reads Q, K, V (3 x 12.6 MB) and the segment
// ids and writes O (12.6 MB), l and m: about 51 MB, 15 us at 3.35 TB/s. Its
// two products take 4 D FLOPs a kept query-key pair, 4.7 GFLOP over 18.3 M
// pairs: 5 us at 989 TFLOP/s. At Llama's heads (B 30, H 32 after the GQA
// repeat, T 512, D 128, unpadded) it reads Q, K, V and writes O, 4 x 125.8
// MB, and l and m: about 507 MB, 151 us; 64.5 GFLOP over 126.1 M pairs, 65
// us. So bytes bound both. F1 builds every mma fragment from scalar shared
// loads, stores P to shared memory and reads it back, re-reads Q every key
// tile, loads each tile synchronously between two barriers, and tests the
// mask on every element.
//
// What the design does about it (FlashAttention-2's forward on mma.sync):
//  * one CTA of kQueryTile / 16 warps per (query tile, head, batch); grid x
//    is batch x head and grid y the query tile, reversed, so the CTAs of the
//    last query tiles, which see the most keys, are launched first;
//  * Q comes in once by cp.async; each warp loads its 16 rows as mma A
//    fragments (ldmatrix) and keeps them in registers for the whole loop;
//  * the CTA walks the key tiles from the diagonal down to 0, so each row
//    meets its own diagonal key, always kept, in its first tile: from then
//    on the running max is a real logit. Tiles above a warp's rows are
//    skipped (a 128-row query tile spans two 64-key diagonal tiles);
//  * K, V and the key segment ids come in by cp.async (16-byte .cg copies)
//    into a two-stage ring: tile k - 1 copies while tile k computes, with
//    one barrier a tile;
//  * that barrier is also a vote (__syncthreads_and, which every thread
//    reaches on every tile): the mask is applied only on a warp's diagonal
//    tile and on tiles where the query tile and the key tile do not all hold
//    one and the same segment id; a masked pair's P is written as exactly 0,
//    never through the mask value;
//  * S = Q K^T takes K as stored through ldmatrix, P V takes V through
//    ldmatrix.trans; rows are padded to D + 8 elements (144 bytes at D 64,
//    272 at D 128), so each 8-row phase of an ldmatrix touches 32 different
//    banks;
//  * the online softmax runs in base 2 on the raw scores: the running max is
//    of Q K^T, P = 2^(s * scale * log2 e - max * scale * log2 e), one FFMA
//    and one MUFU.EX2 an element; the max and sum stay per row in registers,
//    reduced across a quad with shuffles; m = max * scale on the way out;
//  * P is rounded to bf16 and packed into A fragments straight from the S
//    accumulators: two neighbouring 16 x 8 accumulator tiles are the A
//    layout of a 16 x 16 operand;
//  * O / l is staged in the warp's own rows of the Q tile and written with
//    16-byte stores; l and m once a row.
//
// The register budget decides FFH's shape. A thread of a 16-row warp holds
// O's accumulators (D / 2 = 64 registers at D 128), S (32), P's fragments
// (16) and, kept for the loop, Q's fragments (D / 4 = 32): 220 registers,
// no spills, so a CTA of 4 warps leaves room for a second on an SM and one
// of 8 warps for none. FFH takes a 128-query tile of 8 warps (104 KB of
// shared memory, one CTA an SM): each K and V tile is copied into shared
// memory once for 128 queries, half the copies of a 64-query tile of 4
// warps (2 CTAs an SM). That tile took 16% more device time at Llama's
// heads, and as much with Q's fragments reloaded every key tile (168
// registers), on an H100 80GB HBM3 at 700 W (chip_smoke.py --profile-flash,
// which times both copies against FFH as built). kf_flash_fwd_occupancy
// reports each instance's registers, spills and CTAs an SM.
//
// Every launch runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace kf_flash;
using bf16 = __nv_bfloat16;

constexpr int kKeyTile = 64;  // keys per loop step
constexpr float kLog2e = 1.4426950408889634f;

// One instance: head dim, queries per CTA (a multiple of kKeyTile), and
// whether each warp keeps its Q fragments in registers for the whole loop
// (both instances do; --profile-flash times a copy that reloads them).
template <int kD_, int kQueryTile_, bool kQInRegs_>
struct Shape {
  static constexpr int kD = kD_;
  static constexpr int kQueryTile = kQueryTile_;
  static constexpr bool kQInRegs = kQInRegs_;
  static constexpr int kQFrags = kQInRegs ? kD / 16 : 1;
  static constexpr int kWarps = kQueryTile / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = kD + 8;  // shared row pitch in elements
  // Shared memory, in bytes: the Q tile (later O), two stages of K, V and
  // the key segment ids.
  static constexpr int kKeyRows = kKeyTile * kLd * 2;
  static constexpr int kSegBytes = kKeyTile * 4;
  static constexpr int kSmemQ = 0;
  static constexpr int kSmemK = kSmemQ + kQueryTile * kLd * 2;
  static constexpr int kSmemV = kSmemK + 2 * kKeyRows;
  static constexpr int kSmemSeg = kSmemV + 2 * kKeyRows;
  static constexpr int kSmemBytes = kSmemSeg + 2 * kSegBytes;
  static_assert(kQueryTile % kKeyTile == 0 && kThreads >= kQueryTile && kD % 16 == 0,
                "tile shape");

  // Byte offset of element (row, col) in a padded shared tile.
  __device__ static __forceinline__ uint32_t at(int row, int col) {
    return static_cast<uint32_t>((row * kLd + col) * 2);
  }
};

using FF = Shape<64, 64, true>;
using FFH = Shape<128, 128, true>;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One key tile for one warp's 16 query rows: S = Q K^T, the online softmax,
// O += P V. Thread (g, t) holds rows `row` and `row` + 8 (query positions);
// m_r is the running max of the raw scores. Q's fragments come from qa, or
// from the warp's rows at qs when S keeps them in shared memory. kMasked
// applies the causal and segment mask per element.
template <class S, bool kMasked>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[S::kQFrags][4], uint32_t qs,
                                            uint32_t ks, uint32_t vs, const int* seg_k, int k0,
                                            int row, const int (&seg_r)[2], float scale_log2,
                                            float (&o_acc)[S::kD / 8][4], float (&m_r)[2],
                                            float (&l_r)[2], int lane) {
  constexpr int kD = S::kD;
  const int t = lane & 3;
  float s[kKeyTile / 8][4];
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    if constexpr (S::kQInRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
    } else {
      ldsm_x4(a, qs + S::at(lane & 15, kk * 16 + (lane >> 4) * 8));
    }
#pragma unroll
    for (int jp = 0; jp < kKeyTile / 16; ++jp) {
      // B fragments of key tiles 2 jp and 2 jp + 1: K rows as stored.
      uint32_t b[4];
      ldsm_x4(b, ks + S::at(jp * 16 + (lane >> 4) * 8 + (lane & 7),
                            kk * 16 + ((lane >> 3) & 1) * 8));
      mma(s[2 * jp], a, b[0], b[1]);
      mma(s[2 * jp + 1], a, b[2], b[3]);
    }
  }

  // keep: bit 4 j + e for element s[j][e].
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
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!kMasked || ((keep >> (4 * j + e)) & 1)) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
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

  // P, rounded to bf16 and packed as A fragments (16 rows x 16 keys each).
  float rs[2] = {0.f, 0.f};
  uint32_t pa[kKeyTile / 16][4];
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2_approx(fmaf(s[j][e], scale_log2, -m_log2[e >> 1]));
      p[e] = (!kMasked || ((keep >> (4 * j + e)) & 1)) ? x : 0.f;
      rs[e >> 1] += p[e];
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];

  // O += P V: B fragments of D tiles 2 np and 2 np + 1, V transposed by ldmatrix.
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + S::at(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                              np * 16 + (lane >> 4) * 8));
      mma(o_acc[2 * np], pa[kk], b[0], b[1]);
      mma(o_acc[2 * np + 1], pa[kk], b[2], b[3]);
    }
}

template <class S>
__device__ __forceinline__ void flash_fwd(unsigned char* smem, const bf16* __restrict__ q,
                                          const bf16* __restrict__ k, const bf16* __restrict__ v,
                                          const int* __restrict__ seg, bf16* __restrict__ o,
                                          float* __restrict__ l_out, float* __restrict__ m_out,
                                          int H, int T_len, float scale) {
  constexpr int kD = S::kD, kQueryTile = S::kQueryTile, kThreads = S::kThreads;
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;  // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQueryTile;  // longest rows first
  const size_t base = static_cast<size_t>(bh) * T_len;  // row (b, h, 0)
  const int* segb = seg + static_cast<size_t>(bh / H) * T_len;
  const int rw = warp * 16;  // the warp's first row in the tile
  const int kt_last = (q0 + kQueryTile - 1) / kKeyTile;
  const int kt_diag = (q0 + rw) / kKeyTile;  // the key tile holding the warp's diagonal

  // rows x D bf16 from device memory (row pitch D) into a padded tile.
  auto copy_rows = [&](uint32_t dst, const bf16* src, int rows) {
    for (int c = tid; c < rows * (kD / 8); c += kThreads) {
      const int r = c / (kD / 8), cc = (c % (kD / 8)) * 8;
      cp_async16(dst + S::at(r, cc), src + static_cast<size_t>(r) * kD + cc);
    }
  };
  auto load_key_tile = [&](int stage, int kt) {
    const int k0 = kt * kKeyTile;
    copy_rows(s0 + S::kSmemK + stage * S::kKeyRows, k + (base + k0) * kD, kKeyTile);
    copy_rows(s0 + S::kSmemV + stage * S::kKeyRows, v + (base + k0) * kD, kKeyTile);
    if (tid < kKeyTile / 4)
      cp_async16(s0 + S::kSmemSeg + stage * S::kSegBytes + tid * 16, segb + k0 + tid * 4);
  };

  copy_rows(s0 + S::kSmemQ, q + (base + q0) * kD, kQueryTile);
  load_key_tile(0, kt_last);
  cp_async_commit();

  // Whether the query tile holds one segment id, the one of its first row.
  const int seg_first = segb[q0];
  const bool q_one = tid >= kQueryTile || segb[q0 + tid] == seg_first;
  const int seg_r[2] = {segb[q0 + rw + g], segb[q0 + rw + g + 8]};
  // Waits for the tile in `stage` and returns, for the whole CTA, whether the
  // query tile and that key tile hold one segment id. The barrier also marks
  // the other stage free: every warp is done with the tile before.
  auto arrive = [&](int stage) {
    cp_async_wait<0>();
    bool one = q_one;
    if (tid < kKeyTile / 4) {  // the thread's own 16-byte copy is visible to it
      const int4 s4 =
          *reinterpret_cast<const int4*>(smem + S::kSmemSeg + stage * S::kSegBytes + tid * 16);
      one = one && s4.x == seg_first && s4.y == seg_first && s4.z == seg_first &&
            s4.w == seg_first;
    }
    return __syncthreads_and(one) != 0;
  };
  bool uniform = arrive(0);

  const uint32_t qs = s0 + S::kSmemQ + S::at(rw, 0);  // the warp's Q rows
  uint32_t qa[S::kQFrags][4];
  if constexpr (S::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      ldsm_x4(qa[kk], qs + S::at(lane & 15, kk * 16 + (lane >> 4) * 8));
  }

  float o_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;
  const int row = q0 + rw + g;

  for (int kt = kt_last; kt >= 0; --kt) {
    const int stage = (kt_last - kt) & 1;
    if (kt > 0) load_key_tile(stage ^ 1, kt - 1);
    cp_async_commit();
    if (kt <= kt_diag) {  // a tile above the warp's rows keeps nothing
      const uint32_t ks = s0 + S::kSmemK + stage * S::kKeyRows;
      const uint32_t vs = s0 + S::kSmemV + stage * S::kKeyRows;
      const int* seg_k = reinterpret_cast<const int*>(smem + S::kSmemSeg + stage * S::kSegBytes);
      if (uniform && kt != kt_diag)
        attend_tile<S, false>(qa, qs, ks, vs, seg_k, kt * kKeyTile, row, seg_r, scale_log2,
                              o_acc, m_r, l_r, lane);
      else
        attend_tile<S, true>(qa, qs, ks, vs, seg_k, kt * kKeyTile, row, seg_r, scale_log2,
                             o_acc, m_r, l_r, lane);
    }
    if (kt > 0) uniform = arrive(stage ^ 1);
  }

  // O / l in bf16, staged in the warp's own rows of the Q tile (only this
  // warp read them), then 16-byte stores of whole rows.
  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(smem + S::kSmemQ + S::at(rw + g, n * 8 + 2 * t)) =
        pack_bf16(o_acc[n][0] * inv[0], o_acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(smem + S::kSmemQ + S::at(rw + g + 8, n * 8 + 2 * t)) =
        pack_bf16(o_acc[n][2] * inv[1], o_acc[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* og = o + (base + q0 + rw) * kD;
#pragma unroll
  for (int c = lane; c < 16 * (kD / 8); c += 32) {
    const int r = c / (kD / 8), cc = (c % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(og + r * kD + cc) =
        *reinterpret_cast<const uint4*>(smem + S::kSmemQ + S::at(rw + r, cc));
  }
  if (t == 0) {
    const size_t r0 = base + row;
    l_out[r0] = l_r[0];
    m_out[r0] = m_r[0] * scale;
    l_out[r0 + 8] = l_r[1];
    m_out[r0 + 8] = m_r[1] * scale;
  }
}

// FF (D 64) and FFH (D 128): two kernels of their own names, so that
// profiles and SASS listings tell them apart.
__global__ void __launch_bounds__(FF::kThreads)
    flash_fwd_pipelined_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const int* __restrict__ seg,
                               bf16* __restrict__ o, float* __restrict__ l_out,
                               float* __restrict__ m_out, int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash_fwd<FF>(smem, q, k, v, seg, o, l_out, m_out, H, T_len, scale);
}

__global__ void __launch_bounds__(FFH::kThreads)
    flash_fwd_d128_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ seg,
                          bf16* __restrict__ o, float* __restrict__ l_out,
                          float* __restrict__ m_out, int H, int T_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash_fwd<FFH>(smem, q, k, v, seg, o, l_out, m_out, H, T_len, scale);
}

using FwdKernel = void (*)(const bf16*, const bf16*, const bf16*, const int*, bf16*, float*,
                           float*, int, int, float);

template <class S>
int launch(FwdKernel kernel, const void* q, const void* k, const void* v, const void* seg,
           void* o, void* l, void* m, int B, int H, int T_len, int D, float scale,
           void* stream) {
  if (D != S::kD || B <= 0 || H <= 0 || T_len <= 0 || T_len % S::kQueryTile ||
      static_cast<long long>(B) * H > 0x7fffffffLL || T_len / S::kQueryTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, T_len / S::kQueryTile);
  kernel<<<grid, S::kThreads, S::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<bf16*>(o), static_cast<float*>(l),
      static_cast<float*>(m), H, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 (B, H, T, D); seg: int32 (B, T); o: bf16 (B, H, T, D); l,
// m: fp32 (B, H, T). Every pointer 16-byte aligned, T a multiple of the
// query tile (64 for FF, 128 for FFH); D 64 (FF) or 128 (FFH). Returns a
// CUDA error code (cudaErrorInvalidValue for a shape the kernel does not
// take).
extern "C" int kf_flash_fwd_pipelined(const void* q, const void* k, const void* v,
                                      const void* seg, void* o, void* l, void* m, int B, int H,
                                      int T_len, int D, float scale, void* stream) {
  return launch<FF>(flash_fwd_pipelined_kernel, q, k, v, seg, o, l, m, B, H, T_len, D, scale,
                    stream);
}

extern "C" int kf_flash_fwd_d128(const void* q, const void* k, const void* v, const void* seg,
                                 void* o, void* l, void* m, int B, int H, int T_len, int D,
                                 float scale, void* stream) {
  return launch<FFH>(flash_fwd_d128_kernel, q, k, v, seg, o, l, m, B, H, T_len, D, scale,
                     stream);
}

// Registers a thread, local (spill) bytes a thread and CTAs an SM of FF
// (which 0) or FFH (1), as the CUDA runtime reports them.
extern "C" int kf_flash_fwd_occupancy(int which, int* regs, int* local_bytes, int* ctas) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(flash_fwd_pipelined_kernel)
                              : reinterpret_cast<const void*>(flash_fwd_d128_kernel);
  const int threads = which == 0 ? FF::kThreads : FFH::kThreads;
  const int bytes = which == 0 ? FF::kSmemBytes : FFH::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads, bytes));
}
