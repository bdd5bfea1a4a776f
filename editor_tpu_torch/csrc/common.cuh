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

// Rows of k and v are staged in shared memory with this many extra bf16
// elements, so that lanes reading 8-byte chunks of 32 different rows hit
// distinct banks (row stride (D + 4) * 2 bytes = an even, non-multiple-of-32
// word count when D % 4 == 0).
constexpr int kRowPad = 4;

// Largest token count a block stages in shared memory (k, v and per-warp rows).
constexpr int kMaxTokens = 512;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q (fp32, broadcast to all lanes from shared memory) . k (bf16 row in shared
// memory), with fp32 accumulation. D % 4 == 0; both pointers 8/16-byte aligned.
__device__ __forceinline__ float dot_q_k(const float* __restrict__ q,
                                         const bf16* __restrict__ k, int D) {
  float s = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(q + d);
    const uint2 raw = *reinterpret_cast<const uint2*>(k + d);
    const float2 k01 = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&raw.x));
    const float2 k23 = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&raw.y));
    s = fmaf(qv.x, k01.x, s);
    s = fmaf(qv.y, k01.y, s);
    s = fmaf(qv.z, k23.x, s);
    s = fmaf(qv.w, k23.y, s);
  }
  return s;
}

// Stage N rows of D elements of k (row stride ldk) and v (row stride ldv)
// into shared memory ([N, D + kRowPad] each), with bf16x2 loads:
// neighbouring threads read neighbouring words of one row. The strides and
// pointers must keep every row 4-byte aligned.
__device__ __forceinline__ void stage_kv_rows(const bf16* __restrict__ ksrc,
                                              const bf16* __restrict__ vsrc, int ldk,
                                              int ldv, bf16* ks, bf16* vs, int N, int D) {
  const int ld = D + kRowPad;
  const int D2 = D / 2;
  for (int i = threadIdx.x; i < N * D2; i += blockDim.x) {
    const int m = i / D2, d2 = i - m * D2;
    reinterpret_cast<bf16x2*>(ks + m * ld)[d2] =
        reinterpret_cast<const bf16x2*>(ksrc + (size_t)m * ldk)[d2];
    reinterpret_cast<bf16x2*>(vs + m * ld)[d2] =
        reinterpret_cast<const bf16x2*>(vsrc + (size_t)m * ldv)[d2];
  }
}

// Load one query row (D bf16 at src) as fp32 into a warp's shared scratch row.
__device__ __forceinline__ void load_q_row(const bf16* __restrict__ src, float* q, int D,
                                           int lane) {
  for (int d = lane; d < D; d += 32) q[d] = __bfloat162float(src[d]);
}

// out[d] = sum_m w[m] * v[m, d] for the d pairs of one lane; w is a
// shared-memory row of N weights (16-byte aligned, zero-padded to a multiple
// of 4). Writes the bf16 result scaled by `post`.
__device__ __forceinline__ void weighted_v_row(const float* __restrict__ w,
                                               const bf16* __restrict__ vs, int N,
                                               int D, float post, bf16* orow,
                                               int lane) {
  const int ld = D + kRowPad;
  const int D2 = D / 2;
  for (int d2 = lane; d2 < D2; d2 += 32) {
    float ax = 0.f, ay = 0.f;
    for (int m = 0; m < N; m += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + m);
      const float wm[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (m + j < N) {
          const float2 vf = __bfloat1622float2(
              reinterpret_cast<const bf16x2*>(vs + (m + j) * ld)[d2]);
          ax = fmaf(wm[j], vf.x, ax);
          ay = fmaf(wm[j], vf.y, ay);
        }
      }
    }
    reinterpret_cast<bf16x2*>(orow)[d2] = __floats2bfloat162_rn(ax * post, ay * post);
  }
}

// Launches past the 48 KB default need the opt-in attribute first.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace editor_kernels
