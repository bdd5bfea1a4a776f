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
//   erf, within 1.5e-7 of it); one rounding to bf16 at the end. Any T; C a
//   multiple of 16 up to kGemmMaxK (1536), O a multiple of 16.
//
// What bounds it on the H100: operations. On the backbone's shapes (T = 384 x
// 129 = 49536, C = 768, O = 2304 or 3072) it does 2 T C O = 175 or 234 GFLOP
// against 0.31 or 0.38 GB of x, w and out: 0.18 or 0.24 ms at the 989 TFLOP/s
// bf16 tensor-core peak, 0.09 or 0.11 ms of HBM traffic. mma.sync reaches
// about 2/3 of that peak at best (the rest is wgmma's).
//
// Design: the body of csrc/ln_gemm_mma.cuh with the LayerNorm and the [O, K]
// weight layout. A block owns BM = 128 rows and walks every output column in
// 256-wide tiles: 8 warps of 64 x 64 fp32 accumulators. A pre-pass
// normalises the block's rows once (x read once from device memory) into
// the scratch ys [T, C], which the wrapper allocates; the products stream
// them back (from L2) beside the weight through a 4-stage cp.async ring of
// 64-deep k slices (16 KB of rows and 32 KB of weight each, 192 KB in all).
// Why a scratch: the block's normalised rows kept in shared memory (128 x
// 768 bf16 = 192 KB) would leave room for a 32 KB ring of 16-deep weight
// slices only, too little in flight and too few products a barrier, and
// normalising each streamed slice as it lands takes as many instruction
// slots as its products (PERF.md, findings).
// One block an SM; 387 blocks at T = 49536 are 2.9 waves. L2 bytes a call:
// the weight once per block, 387 x 3.54 MB = 1.37 GB at O = 2304 and 387 x
// 4.72 MB = 1.83 GB at O = 3072; the normalised rows once per column tile,
// 9 x 76 MB = 0.68 GB and 12 x 76 MB = 0.91 GB (the first version's 64 x 128
// tile read the weight 774 times and x 18 or 24 times). mma.sync alone
// reaches about 2/3 of the 989 TFLOP/s peak (tools/mma_peak.py); the body
// stays under it, its shared-memory traffic (ldmatrix reads of each operand
// by 2 or 4 warps, the copies) and the epilogues beside the products. Left
// on the table: wgmma (the rows are flat: 49536 = 774 x 64, no padding),
// TMA, a persistent grid that overlaps a tile's epilogue with the next
// one's products.
#include "ln_gemm_mma.cuh"

namespace editor_kernels {
namespace {

// 4 16-row tiles and 8 n8 tiles a warp, 2 x 4 warps (128 x 256), 64-deep
// slices, 4 stages
using K8Cfg = GemmCfg<4, 8, 2, 4, 64, 4, WLayout::kOK>;

template <bool kGelu>
__global__ void __launch_bounds__(K8Cfg::THREADS, 1)
ln_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ out, bf16* ys, int T,
                 int C, int O, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * K8Cfg::BM;
  ln_gemm_chunk<K8Cfg, true, kGelu>(x + (size_t)row0 * C, min(K8Cfg::BM, T - row0), C, w, O,
                                    bias, out + (size_t)row0 * O, gamma, beta, eps,
                                    ys + (size_t)row0 * C, smem);
}

}  // namespace
}  // namespace editor_kernels

// C % 16 == 0 up to kGemmMaxK, O % 16 == 0, T >= 1; x, w, ys, gamma and beta
// 16-byte aligned (the pre-pass reads gamma and beta with 16-byte loads),
// bias 4-byte aligned; ys: a [T, C] bf16 scratch for the normalised rows
extern "C" int editor_ln_matmul(const void* x, const void* w, const void* bias,
                                const void* gamma, const void* beta, void* out, void* ys,
                                int T, int C, int O, float eps, int gelu, void* stream) {
  using namespace editor_kernels;
  if (T < 1 || C < 16 || C % 16 || C > kGemmMaxK || O < 16 || O % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = gemm_smem_bytes<K8Cfg>();
  auto kernel = gelu ? ln_matmul_kernel<true> : ln_matmul_kernel<false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(T + K8Cfg::BM - 1) / K8Cfg::BM, K8Cfg::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<bf16*>(out),
      static_cast<bf16*>(ys), T, C, O, eps);
  return static_cast<int>(cudaGetLastError());
}
