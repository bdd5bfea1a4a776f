// K3: masked multi-head attention from the raw qkv projection (full logits,
// any N <= 512), the hot op of the HMA fusion block.
//
// Replaces the TPU kernel editor_tpu/ops/masked_attention.py::_pallas_masked_full
// (_qkv_masked_full_kernel).
//
// Contract (same as the plain version, editor_tpu_torch/ops/masked_attention.py):
//   qkv  [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep), out [B, N, C] bf16.
//   A logit whose pair mask mask[n] * mask[m] is 0 is REPLACED by `fill`
//   (-65504), as the plain version does; the TPU kernel adds `fill` as a bias
//   instead. Both give exactly 0 weight to every masked key of a row that has a
//   valid key. Output rows are multiplied by the query mask, so a fully masked
//   query row is written as exact zeros (this kernel skips its work).
//   As on the TPU: the row-max-stabilised exps are rounded to bf16 before the
//   e.v product and the 1/sum normalisation (times the query mask) scales the
//   [N, D] output row ("lazy normalisation"), not the [N, N] weights.
//
// What bounds it on the H100: at the flagship shapes ([384, 88, 2304] per
// modality and [128, 264, 2304] joint) the bytes are small (~100 MB per call);
// the fp32 products on the CUDA cores bound this first version.
//
// Design: one block per (head, sequence) pair, 4 warps, the same layout as K1
// (csrc/attention_qkv.cu): the head's k and v slices staged in padded dynamic
// shared memory (72 KB at N = 264, 139 KB at N = 512, hence the opt-in
// attribute), one query row per warp, lanes over keys for the logits and over
// head-dim pairs for e.v. The key mask sits in shared memory beside k and v.
#include "common.cuh"

namespace editor_kernels {
namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
masked_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                        bf16* __restrict__ out, int N, int H, int D, float scale,
                        float fill) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * D;
  const int ld = D + kRowPad;
  const int Np = (N + 3) & ~3;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)N * ld;
  float* mk = reinterpret_cast<float*>(vs + (size_t)N * ld);
  float* scratch = mk + Np;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q = scratch + warp * (D + Np);
  float* e = q + D;

  const bf16* seq = qkv + (size_t)b * N * 3 * C;
  stage_kv(seq, ks, vs, N, C, h, D);
  for (int m = threadIdx.x; m < N; m += blockDim.x) mk[m] = mask[(size_t)b * N + m];
  __syncthreads();

  for (int n = warp; n < N; n += kWarps) {
    bf16* orow = out + ((size_t)b * N + n) * C + h * D;
    const float mq = mk[n];
    if (mq == 0.f) {  // fully masked query row: the re-mask makes it exactly 0
      for (int d = lane; d < D; d += 32) orow[d] = __float2bfloat16(0.f);
      continue;
    }
    load_q(seq, q, n, C, h, D, lane);
    __syncwarp();
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) {
      const float s = mq * mk[m] == 0.f ? fill : dot_q_k(q, ks + m * ld, D) * scale;
      e[m] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float em = expf(e[m] - mx);
      sum += em;
      e[m] = __bfloat162float(__float2bfloat16(em));
    }
    const float rw = mq / warp_sum(sum);  // the max element gives 1: sum >= 1
    __syncwarp();
    weighted_v_row(e, vs, N, D, rw, orow, lane);
    __syncwarp();  // q and e are rewritten for the next row
  }
}

}  // namespace
}  // namespace editor_kernels

extern "C" int editor_masked_attention(const void* qkv, const void* mask, void* out,
                                       int B, int N, int H, int D, float scale,
                                       float fill, void* stream) {
  using namespace editor_kernels;
  const int Np = (N + 3) & ~3;
  const size_t smem = 2 * (size_t)N * (D + kRowPad) * sizeof(bf16) +
                      (size_t)Np * sizeof(float) +
                      (size_t)kWarps * (D + Np) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(masked_attention_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_attention_kernel<<<dim3(H, B), kWarps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
      static_cast<bf16*>(out), N, H, D, scale, fill);
  return static_cast<int>(cudaGetLastError());
}
