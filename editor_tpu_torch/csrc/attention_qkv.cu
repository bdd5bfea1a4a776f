// K1: multi-head softmax attention straight from the raw qkv projection,
// optionally writing the post-softmax probabilities for the attention rollout;
// and its design variants T1 and T2.
//
// Replaces the TPU kernels editor_tpu/ops/fused_attention.py::_pallas_attention_qkv
// (_qkv_kernel, math in _head_split_softmax_av; K1),
// tools/bench_attn.py::headgrid_attn (_headgrid_kernel; T1) and
// tools/bench_attn2.py::nomax_attn (_kernel_nomax; T2).
//
// Contract (same as the plain versions: attention_qkv_plain in
// editor_tpu_torch/ops/fused_attention.py, headgrid_attn_plain and
// nomax_attn_plain in editor_tpu_torch/tools/bench_attn{,2}.py):
//   qkv   [B, N, 3C] bf16, laid out [q_h0..q_hH | k_h0.. | v_h0..], C = H * D
//         (T1: separate q, k, v [B, N, C], each with its own row stride)
//   out   [B, N, C]  bf16 = softmax(q k^T * scale) v, heads at columns h*D
//   probs [B, H, N, N] bf16 post-softmax rows (may be null)
// The math and rounding points: csrc/attention_rows.cuh. T2 drops the row
// max (exp of the raw logits), valid only while |logit| < ~80.
//
// What bounds it on the H100: at the flagship shape (B = 384, N = 129, H = 12,
// D = 64) one call reads 228 MB of qkv and writes 76 MB of output plus 153 MB
// of probs: about 0.14 ms of HBM traffic at 3.35 TB/s, against 19.6 GFLOP of
// q.k and p.v products. This first version does the products on the CUDA
// cores in fp32 (no mma/wgmma yet), so the FMA throughput and shared-memory
// reads bound it, not the bytes.
//
// Design: one block per (head, sequence) pair, 4 warps. The block stages that
// head's k and v slices (read in place from the [N, 3C] rows with stride 3C,
// so no head transpose is ever materialised) in dynamic shared memory, padded
// so 8-byte row reads are bank-conflict free; 2 x 129 x 68 x 2 B = 35 KB at the
// flagship shape, 139 KB at N = 512. Each warp owns one query row at a time:
// lanes spread over keys for the logits (fp32 q broadcast from shared memory
// as float4) and over head-dim pairs for p.v, so the probs row store and the
// output store are both coalesced. Logits are row-max stabilised, so
// |logit| ~ 1e3 stays finite.
//
// The variants (editor_attention_variant) change the block's shape, not the
// math: q, k and v as three pointers with row strides (T1 reads separate
// head-contiguous tensors, or the q/k/v column views of the packed qkv with
// no copy), 1 or 2 heads per block (4 warps per head, 70 KB of k/v at N = 129
// for 2 heads), g sequences per block one after another, and kNoMax (T2).
// K1 is the instantiation <packed, 1 head, 1 sequence, max> under its own
// symbol.
#include "attention_rows.cuh"

namespace editor_kernels {
namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
attention_qkv_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     bf16* __restrict__ probs, int N, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = H * D;
  attention_block<kWarps, 1, false>(qkv, qkv + C, qkv + 2 * C, 3 * C, 3 * C, 3 * C, out,
                                    probs, blockIdx.y, 1, blockIdx.x, N, H, D, scale, smem);
}

// T1, T2 and K1's block-shape sweep: kHeads heads of `seqs` sequences per block
template <int kHeads, bool kNoMax>
__global__ void __launch_bounds__(kWarps * kHeads * 32)
attention_variant_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ldq, int ldk, int ldv,
                         bf16* __restrict__ out, bf16* __restrict__ probs, int B, int N,
                         int H, int D, float scale, int seqs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b0 = blockIdx.y * seqs;
  const int nseq = min(seqs, B - b0);
  attention_block<kWarps, kHeads, kNoMax>(q, k, v, ldq, ldk, ldv, out, probs, b0, nseq,
                                          blockIdx.x * kHeads, N, H, D, scale, smem);
}

template <int kHeads, bool kNoMax>
int launch_variant(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
                   void* out, void* probs, int B, int N, int H, int D, float scale,
                   int seqs, void* stream) {
  const size_t smem = attention_smem_bytes(N, D, kHeads, kWarps * kHeads);
  cudaError_t err = allow_dynamic_smem(attention_variant_kernel<kHeads, kNoMax>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H / kHeads, (B + seqs - 1) / seqs);
  attention_variant_kernel<kHeads, kNoMax><<<grid, kWarps * kHeads * 32, smem,
                                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      ldq, ldk, ldv, static_cast<bf16*>(out), static_cast<bf16*>(probs), B, N, H, D, scale,
      seqs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace editor_kernels

extern "C" int editor_attention_qkv(const void* qkv, void* out, void* probs, int B,
                                    int N, int H, int D, float scale, void* stream) {
  using namespace editor_kernels;
  const size_t smem = attention_smem_bytes(N, D, 1, kWarps);
  cudaError_t err = allow_dynamic_smem(attention_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_qkv_kernel<<<dim3(H, B), kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<bf16*>(probs), N, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

// T1/T2: q, k, v with row strides ldq, ldk, ldv (elements); heads per block 1
// or 2 (H even for 2); seqs >= 1 sequences per block; nomax 0 or 1.
extern "C" int editor_attention_variant(const void* q, const void* k, const void* v,
                                        int ldq, int ldk, int ldv, void* out, void* probs,
                                        int B, int N, int H, int D, float scale,
                                        int heads, int seqs, int nomax, void* stream) {
  using namespace editor_kernels;
  if (seqs < 1 || (heads == 2 && H % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (heads == 1 && !nomax)
    return launch_variant<1, false>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                    seqs, stream);
  if (heads == 1 && nomax)
    return launch_variant<1, true>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                   seqs, stream);
  if (heads == 2 && !nomax)
    return launch_variant<2, false>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                    seqs, stream);
  if (heads == 2 && nomax)
    return launch_variant<2, true>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                   seqs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
