// K1: multi-head softmax attention straight from the raw qkv projection,
// optionally writing the post-softmax probabilities for the attention rollout.
//
// Replaces the TPU kernel editor_tpu/ops/fused_attention.py::_pallas_attention_qkv
// (_qkv_kernel, math in _head_split_softmax_av).
//
// Contract (same as the plain version, editor_tpu_torch/ops/fused_attention.py):
//   qkv   [B, N, 3C] bf16, laid out [q_h0..q_hH | k_h0.. | v_h0..], C = H * D
//   out   [B, N, C]  bf16 = softmax(q k^T * scale) v, heads at columns h*D
//   probs [B, H, N, N] bf16 post-softmax rows (may be null)
// Logits, row max, exp and sum are fp32. As on the TPU, the probabilities of
// the patch keys (m >= 1) are rounded to bf16 before the p.v product and the
// cls key's (m = 0) stays fp32.
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
#include "common.cuh"

namespace editor_kernels {
namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
attention_qkv_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     bf16* __restrict__ probs, int N, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * D;
  const int ld = D + kRowPad;
  const int Np = (N + 3) & ~3;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)N * ld;
  float* scratch = reinterpret_cast<float*>(vs + (size_t)N * ld);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q = scratch + warp * (D + Np);
  float* p = q + D;

  const bf16* seq = qkv + (size_t)b * N * 3 * C;
  stage_kv(seq, ks, vs, N, C, h, D);
  __syncthreads();

  for (int n = warp; n < N; n += kWarps) {
    load_q(seq, q, n, C, h, D, lane);
    __syncwarp();
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) {
      const float s = dot_q_k(q, ks + m * ld, D) * scale;
      p[m] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float e = expf(p[m] - mx);
      p[m] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);  // the max element gives e = 1: sum >= 1
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

}  // namespace
}  // namespace editor_kernels

extern "C" int editor_attention_qkv(const void* qkv, void* out, void* probs, int B,
                                    int N, int H, int D, float scale, void* stream) {
  using namespace editor_kernels;
  const int Np = (N + 3) & ~3;
  const size_t smem = 2 * (size_t)N * (D + kRowPad) * sizeof(bf16) +
                      (size_t)kWarps * (D + Np) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(attention_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_qkv_kernel<<<dim3(H, B), kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<bf16*>(probs), N, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}
