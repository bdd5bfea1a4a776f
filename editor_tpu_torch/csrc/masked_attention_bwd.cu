// K5 and K7: the VJPs of K3 and K6, masked attention from the raw qkv
// projection (fill -65504 added where mask_q * mask_k == 0, query rows
// re-masked).
//
// Replaces the TPU kernels editor_tpu/ops/masked_attention.py::_pallas_masked_full_bwd
// (_qkv_masked_full_bwd_kernel, K5) and ::_pallas_masked_qkv_bwd
// (_qkv_masked_bwd_kernel, K7); K5 walking g sequences a block is the
// backward half of T6, tools/bench_full_kernel.py:72
// (_qkv_masked_full_bwd_kernel at g sequences a grid step). K5, T6 and K7 run
// the tensor-core body of csrc/attention_bwd_mma.cuh.
//
// Contract (same as the plain versions masked_attention_qkv_bwd_plain and
// masked_attention_tiled_bwd_plain, editor_tpu_torch/ops/masked_attention.py):
//   qkv [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep), g [B, N, C] bf16
//   -> dqkv [B, N, 3C] bf16. The mask gets no gradient.
// The rounding points (those of the TPU bodies; csrc/attention_bwd_mma.cuh):
// logits (q . k) scale plus the fill, the fp32 row max and exp sum, attn = e
// mask_q / sum e, dl = attn (dat - r0) scale; K5 rounds every key's attn and
// dl to bf16 before dq = dl k, dk = dl^T q and dv = attn^T g, K7 keeps each
// tile's cls key (m % tile == 0) in fp32.
//
// What bounds them on the H100: 10 H N^2 D FLOP a sequence over the valid
// pairs against qkv + g + dqkv = 14 N C bytes a sequence. K5 at [384, 88] +
// [128, 264] (the compact tail): 0.73 GB, 0.22 ms at 3.35 TB/s, against
// 23 GFLOP of valid pairs (0.02 ms on the bf16 tensor cores); K7 at
// [384, 129] + [128, 387]: 1.07 GB, 0.32 ms, against 50 GFLOP: bytes. The
// global scratch of the rounded attn and dl (K7; K5 past 144 keys: 0.23 GB
// each way at [128, 264]) is not counted.
//
// Design: K7 and K5 are the masked instances of the tensor-core body, K7 with
// a cls key a tile and its scratch in global memory, K5 without one; K5's
// form follows from N as K4's does: the resident instance (N <= 144 at D <=
// 96, <= 80 above; the per-modality N = 88) keeps the scratch on chip (on an
// H100 0.274 ms at [384, 88] against 0.344 with K7's global scratch, PERF.md
// section 6), the chunked one (the joint N = 264) stages k, v, then q, g and
// keeps the scratch in global memory, reading v and g from global memory
// past D = 80. T6 (`group` g >= 1): the same instances' body walking g
// sequences a block (attention_bwd_mma_walk_kernel, grid (H, ceil(B / g))),
// each pair computed as K5's block computes it: K5's dqkv bit for bit.
#include "attention_bwd_mma.cuh"

// K5: head dims 16, 32, ..., 128 (the wrapper refuses others); pst and dlst
// [B H, Np, Np] bf16 where editor_masked_attention_bwd_scratch gives Np > 0,
// else unused; group 0 (the model paths: one sequence a block) or g >= 1
// (T6: g sequences a block)
extern "C" int editor_masked_attention_bwd(const void* qkv, const void* mask,
                                           const void* g, void* dqkv, void* pst,
                                           void* dlst, int B, int N, int H, int D,
                                           float scale, float fill, int group,
                                           void* stream) {
  using namespace editor_kernels;
  if (N < 1 || N > kMaxTokens || group < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention_bwd_mma_d<BwdForm::kFull>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D,
                                                    scale, fill, 0, group, stream);
}

// The side Np of the two [B H, Np, Np] scratch maps that K5's launch (any
// group) for N tokens at head dim D needs, into *np: N rounded up to 16 for the
// chunked instance, 0 for the resident one (its scratch is in shared memory)
extern "C" int editor_masked_attention_bwd_scratch(int N, int D, int* np) {
  using namespace editor_kernels;
  const int side = bwd_scratch_side<BwdForm::kFull>(N, D);
  if (side < 0) return static_cast<int>(cudaErrorInvalidValue);
  *np = side;
  return 0;
}

// K7: `tile` tokens per tile (129 on the model path; at least 16), N % tile
// == 0, N <= kMaxTokens; head dims 16, 32, ..., 128 (the wrapper refuses
// others). pst and dlst: [B H, Np, Np] bf16, Np = N rounded up to 16.
extern "C" int editor_masked_attention_tiled_bwd(const void* qkv, const void* mask,
                                                 const void* g, void* dqkv, void* pst,
                                                 void* dlst, int B, int N, int H, int D,
                                                 float scale, float fill, int tile,
                                                 void* stream) {
  using namespace editor_kernels;
  if (N < 1 || N > kMaxTokens || tile < 16 || N % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention_bwd_mma_d<BwdForm::kTiled>(qkv, mask, g, dqkv, pst, dlst, B, N, H,
                                                     D, scale, fill, tile, 0, stream);
}
