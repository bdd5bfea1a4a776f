// The CUDA-core attention body of the attention phase of T3
// (csrc/attn_layer.cu; K1's body, and T1's and T2's, until their tensor-core
// forms): softmax(q k^T * scale) v of one head of a run of sequences, one
// query row per warp.
//
// Contract: q, k and v point at the first row of head 0 of sequence 0, with
// row strides ldq, ldk, ldv (elements; 3C for the packed [B, N, 3C] qkv with
// k = qkv + C and v = qkv + 2C); sequence b starts N rows further on per
// sequence. out [B, N, C] bf16; probs [B, H, N, N] bf16 post-softmax rows
// (may be null). Logits, row max, exp and sum are fp32; the patch keys'
// (m >= 1) probabilities are rounded to bf16 before the p.v product, the cls
// key's (m = 0) stays fp32, as in the TPU kernels (_head_split_softmax_av,
// _split_softmax_av).
//
// Layout: the head's (k, v) slices of [N, D + kRowPad] bf16, then one
// (D + Np) fp32 scratch row per warp.
#pragma once

#include "common.cuh"

namespace editor_kernels {

__host__ __device__ inline size_t attention_smem_bytes(int N, int D, int warps) {
  const int Np = (N + 3) & ~3;
  return 2 * (size_t)N * (D + kRowPad) * sizeof(bf16) + (size_t)warps * (D + Np) * sizeof(float);
}

// One block: head h of sequences [b0, b0 + nseq), one sequence after
// another, with kWarps warps. `smem` is the block's dynamic shared memory
// (attention_smem_bytes).
template <int kWarps>
__device__ __forceinline__ void attention_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldq, int ldk, int ldv, bf16* __restrict__ out, bf16* __restrict__ probs, int b0,
    int nseq, int h, int N, int H, int D, float scale, unsigned char* smem) {
  const int C = H * D;
  const int ld = D + kRowPad;
  const int Np = (N + 3) & ~3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)N * ld;
  float* scratch = reinterpret_cast<float*>(vs + (size_t)N * ld);
  float* qr = scratch + warp * (D + Np);
  float* p = qr + D;

  for (int s = 0; s < nseq; ++s) {
    const int b = b0 + s;
    if (s > 0) __syncthreads();  // every warp is done with the last sequence's k, v
    stage_kv_rows(k + (size_t)b * N * ldk + h * D, v + (size_t)b * N * ldv + h * D, ldk, ldv,
                  ks, vs, N, D);
    __syncthreads();
    const bf16* qs = q + (size_t)b * N * ldq + h * D;
    for (int n = warp; n < N; n += kWarps) {
      load_q_row(qs + (size_t)n * ldq, qr, D, lane);
      __syncwarp();
      float mx = -INFINITY;
      for (int m = lane; m < N; m += 32) {
        const float sc = dot_q_k(qr, ks + m * ld, D) * scale;
        p[m] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int m = lane; m < N; m += 32) {
        const float e = expf(p[m] - mx);
        p[m] = e;
        sum += e;
      }
      // the max element gives e = 1, so sum >= 1
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
