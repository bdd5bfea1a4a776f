// K4: the VJP of K1, d(softmax(q k^T * scale) v)/d(qkv) from the raw qkv
// projection and the output's cotangent; the probs output of K1 gets no
// gradient (it only feeds the rollout's top-k).
//
// Replaces the TPU kernel editor_tpu/ops/fused_attention.py::_pallas_attention_qkv_bwd
// (_qkv_bwd_kernel).
//
// Contract (same as the plain version attention_qkv_bwd_plain,
// editor_tpu_torch/ops/fused_attention.py):
//   qkv [B, N, 3C] bf16, g [B, N, C] bf16 -> dqkv [B, N, 3C] bf16, written
//   straight into the q, k and v column slices (no head transposes).
//   As on the TPU: patch-key probabilities (m >= 1) are rounded to bf16 before
//   p^T g, the logit cotangents to bf16 before dq and dk; the cls key's
//   (m = 0) stay fp32; every sum is fp32.
//
// What bounds it on the H100: at the flagship shape (B = 384, N = 129,
// H = 12, D = 64) it does 10 B H N^2 D = 49 GFLOP and must move 0.53 GB (qkv,
// g, dqkv): 0.16 ms of HBM traffic at 3.35 TB/s, 0.05 ms at the 989 TFLOP/s
// bf16 tensor-core peak. This first version runs the products on the CUDA
// cores in fp32, so FMA issue and shared-memory reads bound it.
//
// Design: csrc/attention_bwd.cuh (row pass for dq, column pass for dk and dv,
// the rounded p and dl of each row kept in a per-(b, h) global scratch that
// stays in L2 between the passes).
#include "attention_bwd.cuh"

extern "C" int editor_attention_qkv_bwd(const void* qkv, const void* g, void* dqkv,
                                        void* pst, void* dlst, int B, int N, int H,
                                        int D, float scale, void* stream) {
  return editor_kernels::launch_attention_bwd<false>(qkv, nullptr, g, dqkv, pst, dlst,
                                                     B, N, H, D, scale, 0.f, stream);
}
