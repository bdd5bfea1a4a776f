// The body of K1 (csrc/attention_qkv.cu) as a template, shared by K1, its
// design variants T1 and T2 (the same file) and the attention phase of T3
// (csrc/attn_layer.cu): softmax(q k^T * scale) v of `kHeads` heads of a run
// of sequences, one query row per warp.
//
// Contract: q, k and v point at the first row of head 0 of sequence 0, with
// row strides ldq, ldk, ldv (elements; 3C for the packed [B, N, 3C] qkv with
// k = qkv + C and v = qkv + 2C, C for separate [B, N, C] tensors); sequence
// b starts N rows further on per sequence. out [B, N, C] bf16; probs
// [B, H, N, N] bf16 post-softmax rows (may be null). Logits, row max, exp
// and sum are fp32; the patch keys' (m >= 1) probabilities are rounded to
// bf16 before the p.v product, the cls key's (m = 0) stays fp32, as in the
// TPU kernels (_head_split_softmax_av, _split_softmax_av).
//
// kNoMax (T2, tools/bench_attn2.py::_kernel_nomax): the exps of the raw
// logits, without the row max; valid only while |logit| < ~80.
//
// Layout: kHeads x (k, v) slices of [N, D + kRowPad] bf16, then one
// (D + Np) fp32 scratch row per warp. kWarps warps serve each head.
#pragma once

#include "common.cuh"

namespace editor_kernels {

__host__ __device__ inline size_t attention_smem_bytes(int N, int D, int heads, int warps) {
  const int Np = (N + 3) & ~3;
  return 2 * (size_t)heads * N * (D + kRowPad) * sizeof(bf16) +
         (size_t)warps * (D + Np) * sizeof(float);
}

// One block: heads [h0, h0 + kHeads) of sequences [b0, b0 + nseq), one
// sequence after another; the block has kWarps * kHeads warps. `smem` is
// the block's dynamic shared memory (attention_smem_bytes).
template <int kWarps, int kHeads, bool kNoMax>
__device__ __forceinline__ void attention_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldq, int ldk, int ldv, bf16* __restrict__ out, bf16* __restrict__ probs, int b0,
    int nseq, int h0, int N, int H, int D, float scale, unsigned char* smem) {
  const int C = H * D;
  const int ld = D + kRowPad;
  const int Np = (N + 3) & ~3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hl = warp / kWarps;  // the head of the block this warp serves
  const int h = h0 + hl;
  bf16* base = reinterpret_cast<bf16*>(smem);
  const bf16* ks = base + (size_t)hl * 2 * N * ld;
  const bf16* vs = ks + (size_t)N * ld;
  float* scratch = reinterpret_cast<float*>(base + (size_t)kHeads * 2 * N * ld);
  float* qr = scratch + warp * (D + Np);
  float* p = qr + D;

  for (int s = 0; s < nseq; ++s) {
    const int b = b0 + s;
    if (s > 0) __syncthreads();  // every warp is done with the last sequence's k, v
#pragma unroll
    for (int j = 0; j < kHeads; ++j) {
      bf16* kj = base + (size_t)j * 2 * N * ld;
      stage_kv_rows(k + (size_t)b * N * ldk + (h0 + j) * D,
                    v + (size_t)b * N * ldv + (h0 + j) * D, ldk, ldv, kj, kj + (size_t)N * ld,
                    N, D);
    }
    __syncthreads();
    const bf16* qs = q + (size_t)b * N * ldq + h * D;
    for (int n = warp % kWarps; n < N; n += kWarps) {
      load_q_row(qs + (size_t)n * ldq, qr, D, lane);
      __syncwarp();
      float mx = kNoMax ? 0.f : -INFINITY;
      for (int m = lane; m < N; m += 32) {
        const float sc = dot_q_k(qr, ks + m * ld, D) * scale;
        p[m] = sc;
        if (!kNoMax) mx = fmaxf(mx, sc);
      }
      if (!kNoMax) mx = warp_max(mx);
      float sum = 0.f;
      for (int m = lane; m < N; m += 32) {
        const float e = expf(p[m] - mx);
        p[m] = e;
        sum += e;
      }
      // with the max: the max element gives e = 1, so sum >= 1
      const float inv = 1.f / warp_sum(sum);
      bf16* prow = probs ? probs + (((size_t)b * H + h) * N + n) * N : nullptr;
      for (int m = lane; m < N; m += 32) {
        const float pm = p[m] * inv;
        const bf16 pb = __float2bfloat16(pm);
        if (prow) prow[m] = pb;
        p[m] = m == 0 ? pm : __bfloat162float(pb);
      }
      __syncwarp();
      weighted_v_row(p, vs, N, D, 1.f, out + ((size_t)b * N + n) * C + h * D, lane);
      __syncwarp();  // q and p are rewritten for the next row
    }
  }
}

}  // namespace editor_kernels
