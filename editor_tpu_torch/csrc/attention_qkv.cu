// K1: multi-head softmax attention straight from the raw qkv projection,
// optionally writing the post-softmax probabilities for the attention rollout.
// Its design variants T1 and T2 are csrc/attention_variants.cu.
//
// Replaces the TPU kernel editor_tpu/ops/fused_attention.py::_pallas_attention_qkv
// (_qkv_kernel, math in _head_split_softmax_av).
//
// Contract (the plain versions: attention_qkv_tpu_plain, in the kernel's
// rounding form, and attention_qkv_plain in editor_tpu_torch/ops/fused_attention.py):
//   qkv   [B, N, 3C] bf16, laid out [q_h0..q_hH | k_h0.. | v_h0..], C = H * D
//   out   [B, N, C]  bf16 = softmax(q k^T * scale) v, heads at columns h*D
//   probs [B, H, N, N] bf16 post-softmax rows (may be null)
// Rounding points, as the TPU body: fp32 logits (bf16 products are exact)
// times scale; fp32 row max, exp and sum, p = e * (1 / sum); probs = bf16(p);
// the patch keys' (m >= 1) p rounded to bf16 before p.v, the cls key's p_0
// kept in fp32 and p_0 v_0 added to the fp32 sum; out rounded once. Only
// the order of the sums differs from the TPU body.
//
// What bounds K1 on the H100: at the flagship shape (B = 384, N = 129, H =
// 12, D = 64) one call reads 228 MB of qkv and writes 76 MB of output plus
// 153 MB of probs: 0.137 ms at 3.35 TB/s, against 19.6 GFLOP of q.k and p.v
// products (0.02 ms on the bf16 tensor cores): bytes.
//
// K1's design: the unmasked instance of the tensor-core forward
// attention_fwd_mma_kernel<FwdForm::kQkv, DK, KT, resident> in
// csrc/attention_fwd_mma.cuh, whose masked instances are K3's and K6's
// (csrc/masked_attention.cu). One block per (head, sequence), 3 warps at
// N = 129 (9 query tiles of 16 rows, 3 rounds; at most 4 warps), 54 KB of
// shared memory and at most 168 registers a thread, so that 4 blocks (12
// warps) share an SM: occupancy is what hides the latency of each warp's
// chain of loads, products and exps (PERF.md, findings). mma.sync m16n8k16
// with ldmatrix, k and v staged with 16-byte cp.async, the logits of the
// whole row in registers (72 floats a thread at N = 129), p re-packed in
// registers as the A operand of p.v, key 0's entry zeroed there and p_0 v_0
// added in fp32. The probs tile is staged in shared memory at its global
// address modulo 16 bytes and written with 16-byte stores in the aligned
// middle of its span (a map starts only 2-byte aligned at odd N) and 2-byte
// stores at the ends. Past 16 KT keys (144 at D <= 96, 80 above) the keys
// come in chunks, each pass (max, sum, normalise + store + p.v) loading each
// chunk of k (and v) anew and making its logits again; every N <=
// kMaxTokens and every D a multiple of 16 up to 128 is one template instance
// per D.
#include "attention_fwd_mma.cuh"

namespace editor_kernels {
namespace {

template <int DK>
int launch_k1(const bf16* qkv, bf16* out, bf16* probs, int B, int N, int H, float scale,
              cudaStream_t stream) {
  constexpr int KT = k1_key_tiles(DK), D = 16 * DK, KC = 16 * KT;
  const int npad = (N + 15) & ~15, ntiles = npad / 16;
  const int nch = (npad + KC - 1) / KC;
  const bool resident = nch == 1;
  const int max_warps = resident ? kK1ResidentWarps : kK1MaxWarps;
  const int rounds = (ntiles + max_warps - 1) / max_warps;
  const int warps = (ntiles + rounds - 1) / rounds;  // the fewest warps for those rounds
  const int rows_kv = resident ? npad : KC;
  const int se = resident ? (16 * N + 8 + 7) & ~7 : 16 * (KC + 8);
  const size_t smem = (2 * (size_t)rows_kv * (D + 8) + (size_t)warps * se) * sizeof(bf16);
  auto kernel = resident ? attention_fwd_mma_kernel<FwdForm::kQkv, DK, KT, true>
                         : attention_fwd_mma_kernel<FwdForm::kQkv, DK, KT, false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), warps * 32, smem, stream>>>(qkv, nullptr, out, probs, N, H, scale, 0.f,
                                                    nch, se, ntiles, 0, 0, FwdWalk{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace editor_kernels

// K1: head dims 16, 32, ..., 128 (the wrapper refuses others), N <= kMaxTokens
extern "C" int editor_attention_qkv(const void* qkv, void* out, void* probs, int B,
                                    int N, int H, int D, float scale, void* stream) {
  using namespace editor_kernels;
  if (N < 1 || N > kMaxTokens) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  bf16* p = static_cast<bf16*>(probs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_k1<1>(q, o, p, B, N, H, scale, st);
    case 32: return launch_k1<2>(q, o, p, B, N, H, scale, st);
    case 48: return launch_k1<3>(q, o, p, B, N, H, scale, st);
    case 64: return launch_k1<4>(q, o, p, B, N, H, scale, st);
    case 80: return launch_k1<5>(q, o, p, B, N, H, scale, st);
    case 96: return launch_k1<6>(q, o, p, B, N, H, scale, st);
    case 112: return launch_k1<7>(q, o, p, B, N, H, scale, st);
    case 128: return launch_k1<8>(q, o, p, B, N, H, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
