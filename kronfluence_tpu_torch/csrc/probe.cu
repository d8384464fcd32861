// Build-and-launch check: dst = src + 1 on a small fp32 buffer.
//
// Replaces the TPU probe kernel in kronfluence_tpu/utils/platform.py
// (pallas_works, the `_copy` kernel). On the TPU the probe decided whether
// Pallas kernels were dispatched at all; here it only proves that the shared
// library was built for this card and that a launch on PyTorch's stream runs.
// A failure raises in the Python wrapper; nothing falls back.

#include <cuda_runtime.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ src, float* __restrict__ dst, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i] + 1.0f;
}

}  // namespace

extern "C" int kf_probe_add_one(const void* src, void* dst, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  add_one_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}
