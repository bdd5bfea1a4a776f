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
// Contract (the plain versions masked_attention_qkv_tpu_plain and
// masked_attention_tiled_plain, editor_tpu_torch/ops/masked_attention.py):
//   qkv  [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep), out [B, N, C] bf16.
//   `fill` (-65504) is ADDED to a logit whose pair mask mask[n] * mask[m] is
//   0, as the TPU kernels do; that gives exactly 0 weight to every masked key
//   of a row that has a valid key (its own). Output rows are multiplied by
//   the query mask, so a fully masked query row is written as exact zeros.
//   As on the TPU: the row-max-stabilised exps are rounded to bf16 before the
//   e.v product and the 1/sum normalisation (times the query mask) scales the
//   [N, D] output row ("lazy normalisation"), not the [N, N] weights. K3
//   rounds every exp; K6 keeps the exp of each tile's cls key (m % tile == 0)
//   in fp32 in the e.v sum, as the TPU kernel's separate fp32 cls-key column
//   does.
//
// What bounds K3 and K6 on the H100: the bytes (qkv read once, out written
// once: 0.42 GB for K3's [384, 88, 2304] and [128, 264, 2304] together, 0.12
// ms at 3.35 TB/s; 0.61 GB, 0.18 ms for K6's [384, 129] and [128, 387])
// against the q.k and e.v products over the valid pairs of phase 2's masks
// (9.3 and 20 GFLOP, 0.01 and 0.02 ms on the bf16 tensor cores): bytes.
//
// K3 and K6 (the model paths' 4 warps): the masked instances kFull and
// kTiled of the tensor-core forward attention_fwd_mma_kernel<form, DK, KT,
// resident> in csrc/attention_fwd_mma.cuh, K1's body: mma.sync m16n8k16 for
// q.k and e.v, k and v staged with cp.async, the key mask turned into a
// per-key bias in shared memory; K6 also keeps the exps of the cls keys in
// fp32 (e_c v_c with FMAs, their bf16 entries cleared). N <= 144 (D <= 96;
// 80 above): the resident instance, a row's logits in registers, one pass
// over them. Past that the chunked instance: pass 1 makes each key chunk's
// logits for the row max, pass 2 makes them again for the exps, their sum,
// the bf16 rounding and e.v, with k and v of the head staged whole once
// where they fit in shared memory (115 KB at K6's N = 387, D = 64: one block
// an SM, so K6 takes 8 warps a block there in place of 4). The grid: one
// block per (head, sequence) and chunk of query tiles; the chunks are as few
// as fill the card twice over (launch_k36, from N and B H): one at the
// model's batch, 5 at the batch-1 joint shape [1, 264] (60 blocks in place of
// 12). D a multiple of 16 up to 128; qkv 16-byte aligned; K6's tile at least
// 16 tokens (the wrapper refuses what K7, the backward, refuses).
//
// T6's forward half and K6 at 8 and 16 warps (the block-shape sweep of
// tools/bench_attn2.py) keep this file's CUDA-core body
// (masked_attention_body): one block per (head, sequence) pair, the head's k
// and v slices staged in padded dynamic shared memory (72 KB at N = 264, 114
// KB at N = 387, 139 KB at N = 512, hence the opt-in attribute), one query
// row per warp, lanes over keys for the logits and over head-dim pairs for
// e.v, q.k and e.v in fp32 on the CUDA cores. The key mask sits in shared
// memory beside k and v. The TPU's split into per-tile patch logits plus cls
// columns (a 128-lane layout artefact) is gone: one row of N logits per
// warp, with the cls keys recognised by their index. tile == 0 is T6's
// forward half, K3's CUDA-core body until its tensor-core redesign.
#include "attention_fwd_mma.cuh"

namespace editor_kernels {
namespace {

size_t masked_smem_bytes(int N, int D, int warps) {
  const int Np = (N + 3) & ~3;
  return 2 * (size_t)N * (D + kRowPad) * sizeof(bf16) + (size_t)Np * sizeof(float) +
         (size_t)warps * (D + Np) * sizeof(float);
}

// tile == 0: T6's forward (fill replaces the logit, every exp rounded);
// tile > 0: K6's sweep (fill added, the exps of the keys m % tile == 0 kept
// in fp32).
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
      else  // replaced, where the TPU body adds it: the same weights, since a
            // valid query's own key is valid, so its row max is a real logit
            // and exp(fill - max) and exp(l + fill - max) are both 0 in fp32
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

// kTiled: K6's sweep (tile > 0), else T6's forward; kW warps per block
template <int kW, bool kTiled>
int launch_masked(const void* qkv, const void* mask, void* out, int B, int N, int H, int D,
                  float scale, float fill, int tile, void* stream) {
  const size_t smem = masked_smem_bytes(N, D, kW);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (kTiled) {
    err = allow_dynamic_smem(masked_attention_tiled_kernel<kW>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_attention_tiled_kernel<kW><<<dim3(H, B), kW * 32, smem, st>>>(q, m, o, N, H, D,
                                                                        scale, fill, tile);
  } else {
    err = allow_dynamic_smem(masked_attention_kernel<kW>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_attention_kernel<kW><<<dim3(H, B), kW * 32, smem, st>>>(q, m, o, N, H, D, scale,
                                                                  fill);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 and K6: kv staged whole once where k, v and the key bias take at most
// this much shared memory (the most a block may have)
constexpr size_t kK3WholeKvBytes = 232448;
// blocks an SM the query chunks aim at where B H blocks alone are fewer
constexpr int kK3BlocksPerSm = 2;

// K3 (kFull) and K6 (kTiled, `tile` tokens a tile)
template <FwdForm kForm, int DK>
int launch_k36(const bf16* qkv, const float* mask, bf16* out, int B, int N, int H, float scale,
               float fill, int tile, cudaStream_t stream) {
  constexpr int KT = k1_key_tiles(DK), D = 16 * DK, LD = D + 8, KC = 16 * KT;
  const int npad = (N + 15) & ~15, ntiles = npad / 16;
  const int nch = (npad + KC - 1) / KC;
  const bool resident = nch == 1;
  const size_t bias = (size_t)npad * sizeof(float);
  const size_t kv_whole = 2 * (size_t)npad * LD * sizeof(bf16);
  const bool whole = resident || kv_whole + bias <= kK3WholeKvBytes;
  const size_t smem = (whole ? kv_whole : 2 * (size_t)KC * LD * sizeof(bf16)) + bias;
  // query chunks: as few as give kK3BlocksPerSm blocks an SM, at most one
  // round of warps each
  int dev = 0, sms = 0, smem_sm = 0, smem_reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K6: more warps where the shared memory leaves room for one block an SM
  const bool one_block = 2 * (smem + smem_reserved) > (size_t)smem_sm;
  const int max_warps = resident                                 ? kK1ResidentWarps
                        : kForm == FwdForm::kTiled && one_block ? kK6OneBlockWarps
                                                                 : kK1MaxWarps;
  const int want = (kK3BlocksPerSm * sms + B * H - 1) / (B * H);
  const int chunks = max(1, min(want, (ntiles + max_warps - 1) / max_warps));
  const int tpb = (ntiles + chunks - 1) / chunks;  // query tiles a block
  const int rounds = (tpb + max_warps - 1) / max_warps;
  const int warps = (tpb + rounds - 1) / rounds;  // the fewest warps for those rounds
  auto kernel = resident ? attention_fwd_mma_kernel<kForm, DK, KT, true>
                         : attention_fwd_mma_kernel<kForm, DK, KT, false>;
  err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B, (ntiles + tpb - 1) / tpb), warps * 32, smem, stream>>>(
      qkv, mask, out, nullptr, N, H, scale, fill, nch, 0, tpb, whole, tile, FwdWalk{});
  return static_cast<int>(cudaGetLastError());
}

template <FwdForm kForm>
int launch_k36_d(const void* qkv, const void* mask, void* out, int B, int N, int H, int D,
                 float scale, float fill, int tile, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_k36<kForm, 1>(q, m, o, B, N, H, scale, fill, tile, st);
    case 32: return launch_k36<kForm, 2>(q, m, o, B, N, H, scale, fill, tile, st);
    case 48: return launch_k36<kForm, 3>(q, m, o, B, N, H, scale, fill, tile, st);
    case 64: return launch_k36<kForm, 4>(q, m, o, B, N, H, scale, fill, tile, st);
    case 80: return launch_k36<kForm, 5>(q, m, o, B, N, H, scale, fill, tile, st);
    case 96: return launch_k36<kForm, 6>(q, m, o, B, N, H, scale, fill, tile, st);
    case 112: return launch_k36<kForm, 7>(q, m, o, B, N, H, scale, fill, tile, st);
    case 128: return launch_k36<kForm, 8>(q, m, o, B, N, H, scale, fill, tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace editor_kernels

// warps: 4 (the model paths: K3 on the tensor cores; head dims 16, 32, ...,
// 128, the wrapper refuses others), 8 or 16 (T6: the CUDA-core body)
extern "C" int editor_masked_attention(const void* qkv, const void* mask, void* out,
                                       int B, int N, int H, int D, float scale,
                                       float fill, int warps, void* stream) {
  using namespace editor_kernels;
  if (N < 1 || N > kMaxTokens) return static_cast<int>(cudaErrorInvalidValue);
  switch (warps) {
    case 4:
      return launch_k36_d<FwdForm::kFull>(qkv, mask, out, B, N, H, D, scale, fill, 0, stream);
    case 8: return launch_masked<8, false>(qkv, mask, out, B, N, H, D, scale, fill, 0, stream);
    case 16:
      return launch_masked<16, false>(qkv, mask, out, B, N, H, D, scale, fill, 0, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6: `tile` tokens per tile (129 on the model path), N % tile == 0; warps
// 4 (the model path: K6 on the tensor cores; head dims 16, 32, ..., 128 and
// tiles of at least 16 tokens, the wrapper refuses others), 8 or 16 (the
// CUDA-core body)
extern "C" int editor_masked_attention_tiled(const void* qkv, const void* mask, void* out,
                                             int B, int N, int H, int D, float scale,
                                             float fill, int tile, int warps, void* stream) {
  using namespace editor_kernels;
  if (tile < 1 || N < 1 || N > kMaxTokens || N % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (warps) {
    case 4:
      return launch_k36_d<FwdForm::kTiled>(qkv, mask, out, B, N, H, D, scale, fill, tile,
                                           stream);
    case 8:
      return launch_masked<8, true>(qkv, mask, out, B, N, H, D, scale, fill, tile, stream);
    case 16:
      return launch_masked<16, true>(qkv, mask, out, B, N, H, D, scale, fill, tile, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
