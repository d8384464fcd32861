// Warp-level building blocks of the flash kernels for sm_90a that stage
// bf16 tiles in shared memory and multiply them with mma.sync: FB
// (flash_backward.cu), FF and FFH (flash_forward.cu), F2H and F3H
// (flash_backward_d128.cu), F2W and F3W (flash_backward_d256.cu). cp.async copies with
// commit/wait groups (whose commit and wait K1's fp32 ring kernel in syrk.cu
// shares), ldmatrix fragment loads, the m16n8k16 bf16 product with fp32
// accumulation, exp2 on the MUFU unit, and bf16 packing.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace kf_flash {

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16), mma's fragment
// layouts: thread (g, t) = (lane / 4, lane % 4) holds acc rows g and g + 8,
// columns 2t and 2t + 1.
__device__ __forceinline__ void mma(float acc[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2, about 2 ulp; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace kf_flash
