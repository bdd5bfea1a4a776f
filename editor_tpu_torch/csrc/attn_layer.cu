// T3: the attention half-layer in one kernel, mid = proj(attention(LN(x))).
//
// Replaces the TPU kernel tools/bench_attn_layer.py::attn_layer
// (_attn_layer_kernel), a design probe: the JAX backbone runs the same math
// as LayerNorm, two matmuls and K1.
//
// Contract (same as the plain version attn_layer_plain,
// editor_tpu_torch/tools/bench_attn_layer.py):
//   x [B, N, C] bf16; LayerNorm weight and bias [C], bqkv [3C], bp [C] bf16;
//   wqkv [C, 3C] and wp [C, C] bf16, stored in x out (y = x . w).
//   out [B, N, C] bf16; probs [B, H, N, N] bf16 (may be null).
//   D = C / H a multiple of 16 up to 128 (K1's), C up to kGemmMaxK (1536),
//   N <= kMaxTokens; every pointer 16-byte aligned.
// Rounding points of _attn_layer_kernel: y = LN(x) (fp32 statistics, eps)
// rounded to bf16; qkv = y . wqkv + bqkv with fp32 accumulation, rounded to
// bf16; attention as K1 (the patch probabilities rounded to bf16 before p.v,
// the cls key's kept in fp32), each head's output bf16; out = att . wp + bp,
// fp32 accumulation, one rounding to bf16.
//
// What bounds it on the H100: operations. At B = 384, N = 129, C = 768 the
// two products take 2 B N C (3C + C) = 233.7 GFLOP and the attention 19.6, so
// 0.26 ms at the 989 TFLOP/s bf16 tensor-core peak, against 0.15 GB of x,
// weights and out (0.2 GB with probs).
//
// Design: one block per g sequences (M = g N rows), three phases:
//  1. qkv = LN(x) . wqkv + bqkv: the body of csrc/ln_gemm_mma.cuh with the
//     LayerNorm and the [K, O] weight layout, in chunks of 144 rows (a
//     sequence of 129 rows is one chunk: 9 16-row tiles), 128-column tiles:
//     the chunk's rows normalised once into the attention workspace (free
//     until phase 2), then those rows and the weight streamed together
//     through a cp.async ring, into a global qkv workspace [B, N, 3C];
//  2. the attention of each (head, sequence) pair by K1's tensor-core forward,
//     attention_fwd_mma_pair<FwdForm::kQkv, ...> (csrc/attention_fwd_mma.cuh)
//     from that workspace (K1's input layout) into a second one [B, N, C], and
//     the probs: on the same qkv, K1's output and probs, bit for bit;
//  3. out = att . wp + bp: the body without the LayerNorm, the chunk's rows
//     streamed from the second workspace.
// Block size: 12 warps where phase 2 is K1's resident instance at D <= 64
// (the flagship's), so that its 9 query tiles at N = 129 take one round, with
// 3 x 4 warps of 48 x 32 tiles in the products (168 registers); else 8 warps
// (1 x 8 of 144 x 16; 255 registers, which K1's chunked and wide instances
// need). 12 warps of 48 x 64 tiles (a 144 x 256 tile) spilled.
// The workspaces are written and read back by the block that owns their rows
// (they stay in L2 only in part: 132 blocks hold 105 MB of them at g = 1).
// L2 bytes a call: each chunk streams wqkv and wp once, ceil(B / g) ceil(g
// N / 144) (4 C^2) 2 bytes: 384 x 4.72 MB = 1.81 GB at g = 1, 2 and 4 (the
// first version streamed both per 48-row chunk: 5.4 GB), and its rows once
// per 128-column tile (24 x 221 KB a chunk: 2.0 GB). Shared memory: the ring
// (4 x 34 KB with 12 warps, 6 x 17 KB with 8) or phase 2's 73 KB, so one
// block an SM: 384 blocks at g = 1 are 2.9 waves, 192 at g = 2 1.45, 96 at g
// = 4 0.73. A chunk is a whole sequence because each chunk streams both
// weight matrices: 80 normalised rows resident beside the ring would take
// two chunks a sequence (3.62 GB of weights; PERF.md, findings).
#include <type_traits>

#include "attention_fwd_mma.cuh"
#include "ln_gemm_mma.cuh"

namespace editor_kernels {
namespace {

// The products' tile, 144 x 128 (a sequence of 129 rows is one chunk), 64-deep
// slices, 4 stages. Where the attention is K1's resident instance at D <= 64
// (N up to 144; 168 registers, as K1's 4 blocks an SM allow) 12 warps, 3 x 4
// with 3 16-row tiles and 4 n8 tiles each, so that the attention's query
// tiles take one round (9 at N = 129); else (the chunked instances, and the
// resident ones of the wide heads, up to 255 registers) 8 warps, 1 x 8 with
// 9 and 2.
using T3Cfg12 = GemmCfg<3, 4, 3, 4, 64, 4, WLayout::kKO>;
using T3Cfg8 = GemmCfg<9, 2, 1, 8, 32, 6, WLayout::kKO>;
template <int DK, bool kResident>
using T3Cfg = std::conditional_t<kResident && DK <= 4, T3Cfg12, T3Cfg8>;

// The block's first sequence, from a fresh read of the block index: each
// phase derives its rows from it anew, so that no value stays live in a
// register across the attention (with them, ptxas spilled the chunked
// instances)
__device__ __forceinline__ int t3_first_seq(int seqs) {
  int bx;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(bx));
  return bx * seqs;
}

// One block per `seqs` sequences [b0, b1); qkv_ws [B, N, 3C] and att_ws [B,
// N, C] are workspaces that only the block owning their rows writes and
// reads. nch, se: K1's key chunks and probs staging (as launch_k1 sets them).
template <int DK, int KT, bool kResident>
__global__ void __launch_bounds__(T3Cfg<DK, kResident>::THREADS, 1)
attn_layer_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                  const bf16* __restrict__ lnb, const bf16* __restrict__ wqkv,
                  const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
                  const bf16* __restrict__ bp, bf16* __restrict__ out, bf16* probs,
                  bf16* qkv_ws, bf16* att_ws, int B, int N, int H, float scale, float eps,
                  int seqs, int nch, int se) {
  using Cfg = T3Cfg<DK, kResident>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = H * 16 * DK;
  {  // 1. qkv = LN(x) . wqkv + bqkv
    const int b0 = t3_first_seq(seqs), M = (min(B, b0 + seqs) - b0) * N;
    const size_t row0 = (size_t)b0 * N;
    for (int r0 = 0; r0 < M; r0 += Cfg::BM)
      ln_gemm_chunk<Cfg, true, false, bf16>(x + (row0 + r0) * C, min(Cfg::BM, M - r0), C,
                                              wqkv, 3 * C, bqkv, qkv_ws + (row0 + r0) * 3 * C,
                                              lnw, lnb, eps, att_ws + (row0 + r0) * C, smem);
  }
  __syncthreads();  // every row of the block's qkv is written
  {  // 2. K1's attention, pair by pair (each pair's load of k and v opens
     // with a barrier: the last pair's are consumed). Two loop forms, each
     // the one that left its instances free of spills: heads outside the
     // sequences with 12 warps (168 registers), one counter over the pairs
     // with 8
    const int b0 = t3_first_seq(seqs), b1 = min(B, b0 + seqs);
    if constexpr (Cfg::THREADS == T3Cfg12::THREADS) {
#pragma unroll 1
      for (int h = 0; h < H; ++h)
#pragma unroll 1
        for (int b = b0; b < b1; ++b)
          attention_fwd_mma_pair<FwdForm::kQkv, DK, KT, kResident>(
              qkv_ws, nullptr, att_ws, probs, N, H, scale, 0.f, nch, se, (N + 15) >> 4, 0, 0,
              FwdWalk{}, h, b);
    } else {
      const int pairs = (b1 - b0) * H;
#pragma unroll 1
      for (int i = 0; i < pairs; ++i)
        attention_fwd_mma_pair<FwdForm::kQkv, DK, KT, kResident>(
            qkv_ws, nullptr, att_ws, probs, N, H, scale, 0.f, nch, se, (N + 15) >> 4, 0, 0,
            FwdWalk{}, i % H, b0 + i / H);
    }
  }
  {  // 3. out = att . wp + bp (the chunk opens with a barrier: every head's
     // output is written)
    const int b0 = t3_first_seq(seqs), M = (min(B, b0 + seqs) - b0) * N;
    const size_t row0 = (size_t)b0 * N;
    for (int r0 = 0; r0 < M; r0 += Cfg::BM)
      ln_gemm_chunk<Cfg, false, false, bf16>(att_ws + (row0 + r0) * C, min(Cfg::BM, M - r0),
                                               C, wp, C, bp, out + (row0 + r0) * C, nullptr,
                                               nullptr, 0.f, nullptr, smem);
  }
}

template <int DK>
int launch_t3(const bf16* x, const bf16* lnw, const bf16* lnb, const bf16* wqkv,
              const bf16* bqkv, const bf16* wp, const bf16* bp, bf16* out, bf16* probs,
              bf16* qkv_ws, bf16* att_ws, int B, int N, int H, float scale, float eps,
              int seqs, cudaStream_t stream) {
  constexpr int KT = k1_key_tiles(DK), D = 16 * DK, KC = 16 * KT;
  const int npad = (N + 15) & ~15, nch = (npad + KC - 1) / KC;
  const bool resident = nch == 1;
  const int rows_kv = resident ? npad : KC;
  const int se = !probs ? 0 : resident ? (16 * N + 8 + 7) & ~7 : 16 * (KC + 8);
  const int threads = resident ? T3Cfg<DK, true>::THREADS : T3Cfg<DK, false>::THREADS;
  const size_t attn = (2 * (size_t)rows_kv * (D + 8) + (size_t)(threads / 32) * se) *
                      sizeof(bf16);
  const size_t gemm = resident ? gemm_smem_bytes<T3Cfg<DK, true>>()
                               : gemm_smem_bytes<T3Cfg<DK, false>>();
  const size_t smem = gemm > attn ? gemm : attn;
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = resident ? attn_layer_kernel<DK, KT, true> : attn_layer_kernel<DK, KT, false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + seqs - 1) / seqs, threads, smem, stream>>>(
      x, lnw, lnb, wqkv, bqkv, wp, bp, out, probs, qkv_ws, att_ws, B, N, H, scale, eps, seqs,
      nch, se);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace editor_kernels

// seqs >= 1 sequences per block; D a multiple of 16 up to 128, C = H D up to
// kGemmMaxK, N <= kMaxTokens; every pointer 16-byte aligned.
extern "C" int editor_attn_layer(const void* x, const void* lnw, const void* lnb,
                                 const void* wqkv, const void* bqkv, const void* wp,
                                 const void* bp, void* out, void* probs, void* qkv_ws,
                                 void* att_ws, int B, int N, int H, int D, float scale,
                                 float eps, int seqs, void* stream) {
  using namespace editor_kernels;
  if (B < 1 || N < 1 || N > kMaxTokens || seqs < 1 || H < 1 || H * D > kGemmMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D < 16 || D > 128 || D % 16) return static_cast<int>(cudaErrorInvalidValue);
  using Launch = decltype(&launch_t3<1>);
  constexpr Launch by_dk[] = {launch_t3<1>, launch_t3<2>, launch_t3<3>, launch_t3<4>,
                              launch_t3<5>, launch_t3<6>, launch_t3<7>, launch_t3<8>};
  auto b = [](const void* ptr) { return static_cast<const bf16*>(ptr); };
  return by_dk[D / 16 - 1](b(x), b(lnw), b(lnb), b(wqkv), b(bqkv), b(wp), b(bp),
                           static_cast<bf16*>(out), static_cast<bf16*>(probs),
                           static_cast<bf16*>(qkv_ws), static_cast<bf16*>(att_ws), B, N, H,
                           scale, eps, seqs, static_cast<cudaStream_t>(stream));
}
