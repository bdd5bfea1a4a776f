// K3 and K6: masked multi-head attention from the raw qkv projection, the
// hot op of the HMA fusion block. K3 takes any N <= 512 with full logits (the
// compacted tail, N = 88 and 264); K6 takes sequences made of 1 + 128-token
// tiles (the uncompacted tail, TPU.COMPACT_TAIL off: N = 129, 258, 387).
//
// Replaces the TPU kernels editor_tpu/ops/masked_attention.py::_pallas_masked_full
// (_qkv_masked_full_kernel, K3) and ::_pallas_masked_from_qkv
// (_qkv_masked_kernel, K6); with 8 or 16 warps per block, the forward half of
// T6, tools/bench_full_kernel.py:54 (_qkv_masked_full_kernel at other group
// sizes).
//
// Contract (same as the plain versions masked_attention_qkv_plain and
// masked_attention_tiled_plain, editor_tpu_torch/ops/masked_attention.py):
//   qkv  [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep), out [B, N, C] bf16.
//   K3: a logit whose pair mask mask[n] * mask[m] is 0 is REPLACED by `fill`
//   (-65504), as its plain version does; its TPU kernel adds `fill` instead.
//   K6: `fill` is ADDED to such a logit (lp + pair_bias), as its TPU kernel
//   does. Both forms give exactly 0 weight to every masked key of a row that
//   has a valid key (its own). Output rows are multiplied by the query mask, so
//   a fully masked query row is written as exact zeros (this kernel skips its
//   work).
//   As on the TPU: the row-max-stabilised exps are rounded to bf16 before the
//   e.v product and the 1/sum normalisation (times the query mask) scales the
//   [N, D] output row ("lazy normalisation"), not the [N, N] weights. K6 keeps
//   the exp of each tile's cls key (m % tile == 0) in fp32 in the e.v sum, as
//   the TPU kernel's separate fp32 cls-key column does; every other exp is
//   rounded.
//
// What bounds it on the H100: the bytes are small (qkv read once, out written
// once: ~0.1 GB per call at [384, 88, 2304] and [128, 264, 2304], 0.3 GB at
// [384, 129, 2304] and [128, 387, 2304], ~0.1 ms at 3.35 TB/s); the q.k and
// e.v products run on the CUDA cores in fp32 in this first version, so FMA
// issue and shared-memory reads bound it, not the bytes. Left on the table:
// tensor cores (mma/wgmma over 64-row query tiles), and at N = 387 a block per
// head does 3x the work of N = 129 with the same 4 warps.
//
// Design: one block per (head, sequence) pair, 4 warps on the model paths
// (a compile-time parameter: 8 and 16 for the block-shape sweeps of T6,
// tools/bench_full_kernel.py, and of tools/bench_attn2.py), the same layout as K1
// (csrc/attention_qkv.cu): the head's k and v slices staged in padded dynamic
// shared memory (72 KB at N = 264, 114 KB at N = 387, 139 KB at N = 512, hence
// the opt-in attribute), one query row per warp, lanes over keys for the
// logits and over head-dim pairs for e.v. The key mask sits in shared memory
// beside k and v. The TPU's split into per-tile patch logits plus cls columns
// (a 128-lane layout artefact) is gone: one row of N logits per warp, with the
// cls keys recognised by their index.
#include "common.cuh"

namespace editor_kernels {
namespace {

size_t masked_smem_bytes(int N, int D, int warps) {
  const int Np = (N + 3) & ~3;
  return 2 * (size_t)N * (D + kRowPad) * sizeof(bf16) + (size_t)Np * sizeof(float) +
         (size_t)warps * (D + Np) * sizeof(float);
}

// tile == 0: K3 (fill replaces the logit, every exp rounded); tile > 0: K6
// (fill added, the exps of the keys m % tile == 0 kept in fp32).
template <int kW>
__device__ __forceinline__ void masked_attention_body(
    const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out,
    int N, int H, int D, float scale, float fill, int tile) {
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

  for (int n = warp; n < N; n += kW) {
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
      float s;
      if (tile > 0)
        s = dot_q_k(q, ks + m * ld, D) * scale + (mq * mk[m] == 0.f ? fill : 0.f);
      else
        s = mq * mk[m] == 0.f ? fill : dot_q_k(q, ks + m * ld, D) * scale;
      e[m] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float em = expf(e[m] - mx);
      sum += em;
      const bool cls_key = tile > 0 && m % tile == 0;
      e[m] = cls_key ? em : __bfloat162float(__float2bfloat16(em));
    }
    const float rw = mq / warp_sum(sum);  // the max element gives 1: sum >= 1
    __syncwarp();
    weighted_v_row(e, vs, N, D, rw, orow, lane);
    __syncwarp();  // q and e are rewritten for the next row
  }
}

template <int kW>
__global__ void __launch_bounds__(kW * 32)
masked_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                        bf16* __restrict__ out, int N, int H, int D, float scale,
                        float fill) {
  masked_attention_body<kW>(qkv, mask, out, N, H, D, scale, fill, 0);
}

template <int kW>
__global__ void __launch_bounds__(kW * 32)
masked_attention_tiled_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                              bf16* __restrict__ out, int N, int H, int D, float scale,
                              float fill, int tile) {
  masked_attention_body<kW>(qkv, mask, out, N, H, D, scale, fill, tile);
}

// tile == 0: K3, else K6, with kW warps per block
template <int kW>
int launch_masked(const void* qkv, const void* mask, void* out, int B, int N, int H, int D,
                  float scale, float fill, int tile, void* stream) {
  const size_t smem = masked_smem_bytes(N, D, kW);
  cudaError_t err = tile ? allow_dynamic_smem(masked_attention_tiled_kernel<kW>, smem)
                         : allow_dynamic_smem(masked_attention_kernel<kW>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (tile)
    masked_attention_tiled_kernel<kW><<<dim3(H, B), kW * 32, smem, st>>>(q, m, o, N, H, D,
                                                                        scale, fill, tile);
  else
    masked_attention_kernel<kW><<<dim3(H, B), kW * 32, smem, st>>>(q, m, o, N, H, D, scale,
                                                                  fill);
  return static_cast<int>(cudaGetLastError());
}

int launch_masked_warps(const void* qkv, const void* mask, void* out, int B, int N, int H,
                        int D, float scale, float fill, int tile, int warps, void* stream) {
  switch (warps) {
    case 4: return launch_masked<4>(qkv, mask, out, B, N, H, D, scale, fill, tile, stream);
    case 8: return launch_masked<8>(qkv, mask, out, B, N, H, D, scale, fill, tile, stream);
    case 16: return launch_masked<16>(qkv, mask, out, B, N, H, D, scale, fill, tile, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace editor_kernels

// warps: 4 (the model paths), 8 or 16
extern "C" int editor_masked_attention(const void* qkv, const void* mask, void* out,
                                       int B, int N, int H, int D, float scale,
                                       float fill, int warps, void* stream) {
  return editor_kernels::launch_masked_warps(qkv, mask, out, B, N, H, D, scale, fill, 0,
                                             warps, stream);
}

// K6: `tile` tokens per tile (129 on the model path), N % tile == 0.
extern "C" int editor_masked_attention_tiled(const void* qkv, const void* mask, void* out,
                                             int B, int N, int H, int D, float scale,
                                             float fill, int tile, int warps, void* stream) {
  return editor_kernels::launch_masked_warps(qkv, mask, out, B, N, H, D, scale, fill, tile,
                                             warps, stream);
}
