// K5 and K7: the VJPs of K3 and K6, masked attention from the raw qkv
// projection (fill -65504 where mask_q * mask_k == 0, query rows re-masked).
//
// Replaces the TPU kernels editor_tpu/ops/masked_attention.py::_pallas_masked_full_bwd
// (_qkv_masked_full_bwd_kernel, K5) and ::_pallas_masked_qkv_bwd
// (_qkv_masked_bwd_kernel, K7); K5 with 8 warps per block is the backward
// half of T6, tools/bench_full_kernel.py:72 (_qkv_masked_full_bwd_kernel at
// other group sizes). K5 runs the CUDA-core body of csrc/attention_bwd.cuh;
// K7 the tensor-core body of csrc/attention_bwd_mma.cuh, masked.
//
// Contract (same as the plain versions masked_attention_qkv_bwd_plain and
// masked_attention_tiled_bwd_plain, editor_tpu_torch/ops/masked_attention.py):
//   qkv [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep), g [B, N, C] bf16
//   -> dqkv [B, N, 3C] bf16. The mask gets no gradient.
// The rounding points: K5's in csrc/attention_bwd.cuh (every weight rounded
// to bf16), K7's in csrc/attention_bwd_mma.cuh (each tile's cls key in fp32).
//
// What bounds K7 on the H100: 10 H N^2 D FLOP a sequence over the valid
// pairs against qkv + g + dqkv = 14 N C bytes: 0.53 GB at [384, 129] and at
// [128, 387], 0.16 ms each at 3.35 TB/s, against 50 GFLOP of valid pairs for
// the two (0.05 ms on the bf16 tensor cores): bytes. Its scratch of the
// rounded attn and dl (0.98 GB each way at [128, 387]) is not counted.
//
// Design: K7 is the masked instance of the tensor-core body in
// csrc/attention_bwd_mma.cuh, which K4 shares unmasked; K5 keeps the
// CUDA-core body of csrc/attention_bwd.cuh.
#include "attention_bwd.cuh"
#include "attention_bwd_mma.cuh"

// K5; warps: 4 (the model paths) or 8
extern "C" int editor_masked_attention_bwd(const void* qkv, const void* mask,
                                           const void* g, void* dqkv, void* pst,
                                           void* dlst, int B, int N, int H, int D,
                                           float scale, float fill, int warps,
                                           void* stream) {
  using editor_kernels::launch_attention_bwd;
  if (warps == 4)
    return launch_attention_bwd<4>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale, fill,
                                   stream);
  if (warps == 8)
    return launch_attention_bwd<8>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale, fill,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7: `tile` tokens per tile (129 on the model path; at least 16), N % tile
// == 0, N <= kMaxTokens; head dims 16, 32, ..., 128 (the wrapper refuses
// others). pst and dlst: [B H, Np, Np] bf16, Np = N rounded up to 16.
extern "C" int editor_masked_attention_tiled_bwd(const void* qkv, const void* mask,
                                                 const void* g, void* dqkv, void* pst,
                                                 void* dlst, int B, int N, int H, int D,
                                                 float scale, float fill, int tile,
                                                 void* stream) {
  using namespace editor_kernels;
  if (N < 1 || N > kMaxTokens || tile < 16 || N % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention_bwd_mma_d<true>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale,
                                          fill, tile, stream);
}
