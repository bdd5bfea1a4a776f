// T1 and T2, the design variants of K1 (csrc/attention_qkv.cu): K1's
// tensor-core forward body in two more forms.
//
// Replaces the TPU kernels tools/bench_attn.py::headgrid_attn
// (_headgrid_kernel, math in _split_softmax_av; T1) and
// tools/bench_attn2.py::nomax_attn (_kernel_nomax; T2).
//
// Contract (the plain versions headgrid_attn_plain and nomax_attn_plain in
// editor_tpu_torch/tools/bench_attn{,2}.py):
//   T1: q, k, v [B, N, C] bf16, each with its own row stride (separate
//       tensors: C; the column views of a packed qkv: 3C), a multiple of 8
//       elements, and a 16-byte aligned base; out [B, N, C] bf16, heads at
//       columns h * D; probs [B, H, N, N] bf16 post-softmax rows (may be null).
//   T2: qkv [B, N, 3C] bf16 as K1's, 16-byte aligned; out [B, N, C]; no probs.
//   Both round as K1 does (and as their TPU bodies): fp32 logits times scale,
//   fp32 exp and sum, p = e (1 / sum) normalised before it is rounded, the
//   patch keys' (m >= 1) p rounded to bf16 before p.v, the cls key's p_0 kept
//   in fp32 and p_0 v_0 added to the fp32 sum; out rounded once. T2 takes the
//   exp of the raw logits (no row max): valid only while |logit| < ~80.
//   D a multiple of 16 up to 128, N <= kMaxTokens.
//
// What bounds them on the H100, as K1: the bytes. At [384, 129] with C = 768
// one call reads 228 MB of q, k and v and writes 76 MB of output (0.091 ms
// at 3.35 TB/s), T1 with probs 153 MB more (0.137 ms), against 19.6 GFLOP of
// q.k and p.v products (0.02 ms on the bf16 tensor cores).
//
// Design: the forms kSplit (T1) and kNoMax (T2) of
// attention_fwd_mma_kernel<FwdForm, DK, KT, resident> (csrc/attention_fwd_mma.cuh).
// kSplit is K1's kQkv form, probs included, with q, k and v read through
// three row-strided pointers (no copy of a packed qkv's column views).
// kNoMax is kQkv without the row max, launched without probs: no pass 1, so
// past one key chunk it makes two passes over the keys, not three. A block walks
// `heads` heads (T1: 1 or 2; T2: 1) of `seqs` sequences one pair after
// another, each pair as K1's block does it in the same shared memory; the
// launcher picks the resident or chunked instance and the warps from N and
// D as K1's launch_k1 does, and stages no probs where none are written.
#include "attention_fwd_mma.cuh"

namespace editor_kernels {
namespace {

template <FwdForm kForm, int DK>
int launch_walk(const FwdWalk& walk, bf16* out, bf16* probs, int N, int H, float scale,
                cudaStream_t stream) {
  constexpr int KT = k1_key_tiles(DK), D = 16 * DK, KC = 16 * KT;
  const int npad = (N + 15) & ~15, ntiles = npad / 16;
  const int nch = (npad + KC - 1) / KC;
  const bool resident = nch == 1;
  const int max_warps = resident ? kK1ResidentWarps : kK1MaxWarps;
  const int rounds = (ntiles + max_warps - 1) / max_warps;
  const int warps = (ntiles + rounds - 1) / rounds;  // the fewest warps for those rounds
  const int rows_kv = resident ? npad : KC;
  const int se = !probs ? 0 : resident ? (16 * N + 8 + 7) & ~7 : 16 * (KC + 8);
  const size_t smem = (2 * (size_t)rows_kv * (D + 8) + (size_t)warps * se) * sizeof(bf16);
  auto kernel = resident ? attention_fwd_mma_kernel<kForm, DK, KT, true>
                         : attention_fwd_mma_kernel<kForm, DK, KT, false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H / walk.hps, (walk.B + walk.seqs - 1) / walk.seqs);
  kernel<<<grid, warps * 32, smem, stream>>>(walk.q, nullptr, out, probs, N, H, scale, 0.f,
                                             nch, se, ntiles, 0, 0, walk);
  return static_cast<int>(cudaGetLastError());
}

template <FwdForm kForm>
int launch_walk_d(const FwdWalk& walk, void* out, void* probs, int N, int H, int D,
                  float scale, void* stream) {
  bf16* o = static_cast<bf16*>(out);
  bf16* p = static_cast<bf16*>(probs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_walk<kForm, 1>(walk, o, p, N, H, scale, st);
    case 32: return launch_walk<kForm, 2>(walk, o, p, N, H, scale, st);
    case 48: return launch_walk<kForm, 3>(walk, o, p, N, H, scale, st);
    case 64: return launch_walk<kForm, 4>(walk, o, p, N, H, scale, st);
    case 80: return launch_walk<kForm, 5>(walk, o, p, N, H, scale, st);
    case 96: return launch_walk<kForm, 6>(walk, o, p, N, H, scale, st);
    case 112: return launch_walk<kForm, 7>(walk, o, p, N, H, scale, st);
    case 128: return launch_walk<kForm, 8>(walk, o, p, N, H, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace editor_kernels

// T2: qkv [B, N, 3C] as K1's; seqs >= 1 sequences a block
extern "C" int editor_attention_nomax(const void* qkv, void* out, int B, int N, int H, int D,
                                      float scale, int seqs, void* stream) {
  using namespace editor_kernels;
  if (B < 1 || N < 1 || N > kMaxTokens || seqs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdWalk walk{static_cast<const bf16*>(qkv), nullptr, nullptr, 0, 0, 0, B, 1, seqs};
  return launch_walk_d<FwdForm::kNoMax>(walk, out, nullptr, N, H, D, scale, stream);
}

// T1: q, k, v with row strides ldq, ldk, ldv (elements, multiples of 8),
// bases 16-byte aligned; heads 1 or 2 a block (H % heads == 0); seqs >= 1
// sequences a block
extern "C" int editor_attention_split(const void* q, const void* k, const void* v, int ldq,
                                      int ldk, int ldv, void* out, void* probs, int B, int N,
                                      int H, int D, float scale, int heads, int seqs,
                                      void* stream) {
  using namespace editor_kernels;
  if (B < 1 || N < 1 || N > kMaxTokens || seqs < 1 || (heads != 1 && heads != 2) ||
      H % heads || (ldq | ldk | ldv) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdWalk walk{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), ldq, ldk, ldv, B, heads, seqs};
  return launch_walk_d<FwdForm::kSplit>(walk, out, probs, N, H, D, scale, stream);
}
