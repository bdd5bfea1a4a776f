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
//   (m = 0) stay fp32; every sum is fp32. The TPU body forms r = sum dp p
//   from the normalised p, this one r = (sum dp e) / sum e: only the order of
//   the fp32 operations differs.
//
// What bounds it on the H100: at the flagship shape (B = 384, N = 129,
// H = 12, D = 64) it does 10 B H N^2 D = 49 GFLOP and must move 0.53 GB (qkv,
// g, dqkv): 0.16 ms of HBM traffic at 3.35 TB/s, 0.05 ms at the 989 TFLOP/s
// bf16 tensor-core peak: bytes. There the rounded attn and dl stay in shared
// memory; the chunked instance's global scratch of them is traffic the bound
// does not count.
//
// Design: the unmasked instance of the tensor-core body in
// csrc/attention_bwd_mma.cuh (K7's and K5's, masked): mma.sync m16n8k16 for
// all five products; one cls key, key 0, in column 0 of key tile 0, so any
// N >= 1.
// N <= 144 (D <= 96) or N <= 80 (wider heads): the resident instance, a
// row's logits in registers and the rounded attn and dl in shared memory (one
// block of up to 9 warps an SM at N = 129, with no scratch traffic; 10%
// faster than K7's global scratch there). Past that up to kMaxTokens: the
// chunked instance, with the global scratch, k and q alone in shared memory
// and v and g read from global memory, so that every N fits at every head
// dim.
#include "attention_bwd_mma.cuh"

// pst and dlst: [B H, Np, Np] bf16 where editor_attention_qkv_bwd_scratch
// gives Np > 0, else unused (may be null); head dims 16, 32, ..., 128
extern "C" int editor_attention_qkv_bwd(const void* qkv, const void* g, void* dqkv,
                                        void* pst, void* dlst, int B, int N, int H,
                                        int D, float scale, void* stream) {
  using namespace editor_kernels;
  if (N < 1 || N > kMaxTokens) return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention_bwd_mma_d<BwdForm::kQkv>(qkv, nullptr, g, dqkv, pst, dlst, B, N, H,
                                                   D, scale, 0.f, N, 0, stream);
}

// The side Np of the two [B H, Np, Np] scratch maps that K4's launch for N
// tokens at head dim D needs, into *np: N rounded up to 16 for the chunked
// instance, 0 for the resident one (its scratch is in shared memory)
extern "C" int editor_attention_qkv_bwd_scratch(int N, int D, int* np) {
  using namespace editor_kernels;
  const int side = bwd_scratch_side<BwdForm::kQkv>(N, D);
  if (side < 0) return static_cast<int>(cudaErrorInvalidValue);
  *np = side;
  return 0;
}
