// K3 and K6: masked multi-head attention from the raw qkv projection, the
// hot op of the HMA fusion block. K3 takes any N <= 512 with full logits (the
// compacted tail, N = 88 and 264); K6 takes sequences made of 1 + 128-token
// tiles (the uncompacted tail, TPU.COMPACT_TAIL off: N = 129, 258, 387).
//
// Replaces the TPU kernels editor_tpu/ops/masked_attention.py::_pallas_masked_full
// (_qkv_masked_full_kernel, K3) and ::_pallas_masked_from_qkv
// (_qkv_masked_kernel, K6); K3 walking g sequences a block is the forward
// half of T6, tools/bench_full_kernel.py:54 (_qkv_masked_full_kernel at g
// sequences a grid step), and K6 walking them its group sweep
// (tools/bench_attn2.py:103-128, _pallas_masked_from_qkv(group=g)).
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
// K3 and K6: the masked instances kFull and kTiled of the tensor-core
// forward attention_fwd_mma_kernel<form, DK, KT, resident> in
// csrc/attention_fwd_mma.cuh, K1's body: mma.sync m16n8k16 for
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
// `group` g >= 1 (T6, K6's sweep; 0 on the model paths): the same block
// shape and choices, each block walking g sequences one after another
// (attention_fwd_mma_walk_kernel), grid (H, ceil(B / g), chunks); the query
// chunks aim at the same blocks an SM over these H ceil(B / g) blocks. Each
// pair is computed as K3's or K6's own block computes it, so the output is
// theirs bit for bit.
#include "attention_fwd_mma.cuh"

namespace editor_kernels {
namespace {

// K3 and K6: kv staged whole once where k, v and the key bias take at most
// this much shared memory (the most a block may have)
constexpr size_t kK3WholeKvBytes = 232448;
// blocks an SM the query chunks aim at where B H blocks alone are fewer
constexpr int kK3BlocksPerSm = 2;

// K3 (kFull) and K6 (kTiled, `tile` tokens a tile)
template <FwdForm kForm, int DK>
int launch_k36(const bf16* qkv, const float* mask, bf16* out, int B, int N, int H, float scale,
               float fill, int tile, int group, cudaStream_t stream) {
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
  const int seqs = group > 0 ? group : 1;  // sequences a block walks
  const int bys = (B + seqs - 1) / seqs, blocks = H * bys;
  const int want = (kK3BlocksPerSm * sms + blocks - 1) / blocks;
  const int chunks = max(1, min(want, (ntiles + max_warps - 1) / max_warps));
  const int tpb = (ntiles + chunks - 1) / chunks;  // query tiles a block
  const int rounds = (tpb + max_warps - 1) / max_warps;
  const int warps = (tpb + rounds - 1) / rounds;  // the fewest warps for those rounds
  auto kernel = group ? (resident ? attention_fwd_mma_walk_kernel<kForm, DK, KT, true>
                                  : attention_fwd_mma_walk_kernel<kForm, DK, KT, false>)
               : resident ? attention_fwd_mma_kernel<kForm, DK, KT, true>
                          : attention_fwd_mma_kernel<kForm, DK, KT, false>;
  FwdWalk walk{};
  walk.B = B;
  walk.seqs = seqs;
  err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, bys, (ntiles + tpb - 1) / tpb), warps * 32, smem, stream>>>(
      qkv, mask, out, nullptr, N, H, scale, fill, nch, 0, tpb, whole, tile, walk);
  return static_cast<int>(cudaGetLastError());
}

template <FwdForm kForm>
int launch_k36_d(const void* qkv, const void* mask, void* out, int B, int N, int H, int D,
                 float scale, float fill, int tile, int group, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_k36<kForm, 1>(q, m, o, B, N, H, scale, fill, tile, group, st);
    case 32: return launch_k36<kForm, 2>(q, m, o, B, N, H, scale, fill, tile, group, st);
    case 48: return launch_k36<kForm, 3>(q, m, o, B, N, H, scale, fill, tile, group, st);
    case 64: return launch_k36<kForm, 4>(q, m, o, B, N, H, scale, fill, tile, group, st);
    case 80: return launch_k36<kForm, 5>(q, m, o, B, N, H, scale, fill, tile, group, st);
    case 96: return launch_k36<kForm, 6>(q, m, o, B, N, H, scale, fill, tile, group, st);
    case 112: return launch_k36<kForm, 7>(q, m, o, B, N, H, scale, fill, tile, group, st);
    case 128: return launch_k36<kForm, 8>(q, m, o, B, N, H, scale, fill, tile, group, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace editor_kernels

// K3: head dims 16, 32, ..., 128 (the wrapper refuses others); group 0 (the
// model paths: one sequence a block) or g >= 1 (T6: g sequences a block)
extern "C" int editor_masked_attention(const void* qkv, const void* mask, void* out,
                                       int B, int N, int H, int D, float scale,
                                       float fill, int group, void* stream) {
  using namespace editor_kernels;
  if (B < 1 || N < 1 || N > kMaxTokens || group < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_k36_d<FwdForm::kFull>(qkv, mask, out, B, N, H, D, scale, fill, 0, group,
                                      stream);
}

// K6: `tile` tokens per tile (129 on the model path; at least 16, the
// wrapper refuses fewer), N % tile == 0; head dims 16, 32, ..., 128; group
// 0 (the model path) or g >= 1 (the group sweep: g sequences a block)
extern "C" int editor_masked_attention_tiled(const void* qkv, const void* mask, void* out,
                                             int B, int N, int H, int D, float scale,
                                             float fill, int tile, int group, void* stream) {
  using namespace editor_kernels;
  if (B < 1 || tile < 1 || N < 1 || N > kMaxTokens || N % tile || group < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_k36_d<FwdForm::kTiled>(qkv, mask, out, B, N, H, D, scale, fill, tile, group,
                                       stream);
}
