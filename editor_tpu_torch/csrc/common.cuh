// Helpers shared by the hand-written Hopper kernels of editor_tpu_torch.
//
// Every kernel file exposes a plain C entry point that launches on the
// caller's stream and returns cudaGetLastError() right after the launch, so
// a refused launch (too much shared memory, bad grid) reaches the Python
// wrapper instead of vanishing. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared ...
// by editor_tpu_torch/ops/_build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace editor_kernels {

using bf16 = __nv_bfloat16;
using bf16x2 = __nv_bfloat162;

// Largest token count a block stages in shared memory (k, v and per-warp rows).
constexpr int kMaxTokens = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Launches past the 48 KB default need the opt-in attribute first.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace editor_kernels
