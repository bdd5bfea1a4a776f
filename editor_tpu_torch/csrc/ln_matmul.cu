// K8: LayerNorm -> matmul + bias -> optional erf-GELU, one kernel.
//
// Replaces the TPU kernel editor_tpu/ops/fused_linear.py::_pallas_ln_matmul
// (_kernel). As in the JAX package it is a library op on no model path (the
// JAX backbone keeps it out: editor_tpu/models/vit.py:379-384).
//
// Contract (same as the plain version ln_matmul_plain,
// editor_tpu_torch/ops/fused_linear.py):
//   x [T, C] bf16, w [O, C] bf16 (torch Linear layout), bias [O] fp32 or
//   null, gamma and beta [C] fp32 -> out [T, O] bf16.
//   Per row: mean and biased variance in fp32, y = (x - mean) rsqrt(var + eps)
//   gamma + beta, rounded to bf16; y . w^T with fp32 accumulation; + bias in
//   fp32; optional GELU with erff (the TPU kernel uses the A&S 7.1.26 rational
//   erf, within 1.5e-7 of it); one rounding to bf16 at the end. Any T: the
//   rows past T of the last row tile are zeros in shared memory and are not
//   written. C % 16 == 0 and O % 16 == 0.
//
// What bounds it on the H100: operations. On the backbone's shapes (T = 384 x
// 129 = 49536, C = 768, O = 2304 or 3072) it does 2 T C O = 175 or 234 GFLOP
// against 0.31 or 0.38 GB of x, w and out: 0.18 or 0.24 ms at the 989 TFLOP/s
// bf16 tensor-core peak, 0.09 or 0.11 ms of HBM traffic. This first version
// uses nvcuda::wmma bf16 16x16x16 fragments (mma.sync underneath) on a 64 x
// 128 output tile with 8 warps, the weight streamed through shared memory in
// 32-wide k slices without double buffering. Left on the table: wgmma with
// TMA-fed multi-stage rings, a persistent grid, and LN computed once per row
// tile rather than once per (row tile, column tile) (1/256 of the FLOP).
//
// Design: a block owns BM = 64 rows and BN = 128 output columns. It stages its
// rows' x in shared memory (C + 8 bf16 per row), normalises them in place (one
// warp per row, fp32 statistics) and keeps y there for the whole k loop, so
// the normalised activations never touch device memory. Warps tile the 64 x
// 128 output 2 x 4, each holding 2 x 2 fp32 accumulator fragments. The
// epilogue stages the accumulators through the same shared memory, adds the
// bias, applies GELU and writes bf16 pairs.
#include <mma.h>

#include "common.cuh"

namespace editor_kernels {
namespace {

constexpr int kLnmBM = 64, kLnmBN = 128, kLnmBK = 32, kLnmWarps = 8;
constexpr int kLnmPad = 8;  // bf16 elements: rows stay 16-byte aligned

size_t ln_matmul_smem_bytes(int C) {
  const size_t y = (size_t)kLnmBM * (C + kLnmPad) * sizeof(bf16);
  const size_t stage = (size_t)kLnmBM * (kLnmBN + 4) * sizeof(float);
  const size_t w = (size_t)kLnmBN * (kLnmBK + kLnmPad) * sizeof(bf16);
  return (y > stage ? y : stage) + w;
}

__global__ void __launch_bounds__(kLnmWarps * 32)
ln_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ out, int T, int C,
                 int O, float eps, int gelu) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldy = C + kLnmPad, ldw = kLnmBK + kLnmPad, lds = kLnmBN + 4;
  const size_t y_bytes = (size_t)kLnmBM * ldy * sizeof(bf16);
  const size_t s_bytes = (size_t)kLnmBM * lds * sizeof(float);
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* stage = reinterpret_cast<float*>(smem);  // reuses ys after the k loop
  bf16* ws = reinterpret_cast<bf16*>(smem + (y_bytes > s_bytes ? y_bytes : s_bytes));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kLnmBM, col0 = blockIdx.y * kLnmBN;
  const int C8 = C / 8;

  // ---- LayerNorm of the block's rows into shared memory (bf16) ----------
  for (int r = warp; r < kLnmBM; r += kLnmWarps) {
    bf16* yr = ys + (size_t)r * ldy;
    const int t = row0 + r;
    if (t >= T) {  // past the last row: zeros, never written out
      for (int i = lane; i < C8; i += 32)
        reinterpret_cast<uint4*>(yr)[i] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)t * C);
    float sum = 0.f;
    for (int i = lane; i < C8; i += 32) {
      const uint4 raw = src[i];
      reinterpret_cast<uint4*>(yr)[i] = raw;
      const bf16x2* p = reinterpret_cast<const bf16x2*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        sum += f.x + f.y;
      }
    }
    const float mu = warp_sum(sum) / C;
    __syncwarp();
    float sq = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = __bfloat162float(yr[k]) - mu;
      sq = fmaf(d, d, sq);
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    for (int k = lane; k < C; k += 32) {
      const float v = (__bfloat162float(yr[k]) - mu) * rstd * gamma[k] + beta[k];
      yr[k] = __float2bfloat16(v);
    }
  }

  // ---- y . w^T on the tensor cores, fp32 accumulators --------------------
  const int wr = warp / 4, wc = warp % 4;  // a 32 x 32 piece of the 64 x 128 tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < C; k0 += kLnmBK) {
    __syncthreads();  // the LN rows are ready, or the previous slice consumed
    // the weight slice [BN, BK]: rows o of w (output columns), 16-byte loads
    for (int i = threadIdx.x; i < kLnmBN * (kLnmBK / 8); i += blockDim.x) {
      const int o = i / (kLnmBK / 8), k8 = i % (kLnmBK / 8);
      const int k = k0 + k8 * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col0 + o < O && k < C)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(col0 + o) * C + k);
      *reinterpret_cast<uint4*>(ws + o * ldw + k8 * 8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kLnmBK; kk += 16) {
      if (k0 + kk >= C) break;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], ys + (size_t)(wr * 32 + i * 16) * ldy + k0 + kk, ldy);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], ws + (wc * 32 + j * 16) * ldw + kk, ldw);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with ys: reuse it as the fp32 stage
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + (wr * 32 + i * 16) * lds + wc * 32 + j * 16,
                              acc[i][j], lds, wmma::mem_row_major);
  __syncthreads();

  // ---- epilogue: + bias, GELU, one rounding to bf16 ---------------------
  for (int i = threadIdx.x; i < kLnmBM * kLnmBN / 2; i += blockDim.x) {
    const int r = i / (kLnmBN / 2), c = (i % (kLnmBN / 2)) * 2;
    const int t = row0 + r, o = col0 + c;
    if (t >= T || o >= O) continue;
    float v0 = stage[r * lds + c], v1 = stage[r * lds + c + 1];
    if (bias != nullptr) {
      v0 += bias[o];
      v1 += bias[o + 1];
    }
    if (gelu) {
      v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
      v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
    }
    reinterpret_cast<bf16x2*>(out + (size_t)t * O + o)[0] = __floats2bfloat162_rn(v0, v1);
  }
}

}  // namespace
}  // namespace editor_kernels

extern "C" int editor_ln_matmul(const void* x, const void* w, const void* bias,
                                const void* gamma, const void* beta, void* out, int T,
                                int C, int O, float eps, int gelu, void* stream) {
  using namespace editor_kernels;
  const size_t smem = ln_matmul_smem_bytes(C);
  cudaError_t err = allow_dynamic_smem(ln_matmul_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kLnmBM - 1) / kLnmBM, (O + kLnmBN - 1) / kLnmBN);
  ln_matmul_kernel<<<grid, kLnmWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), T, C, O, eps, gelu);
  return static_cast<int>(cudaGetLastError());
}
