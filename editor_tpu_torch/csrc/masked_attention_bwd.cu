// K5: the VJP of K3, masked attention from the raw qkv projection (full
// logits, fill -65504 where mask_q * mask_k == 0, query rows re-masked).
//
// Replaces the TPU kernel editor_tpu/ops/masked_attention.py::_pallas_masked_full_bwd
// (_qkv_masked_full_bwd_kernel).
//
// Contract (same as the plain version masked_attention_qkv_bwd_plain,
// editor_tpu_torch/ops/masked_attention.py):
//   qkv [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep), g [B, N, C] bf16
//   -> dqkv [B, N, 3C] bf16. The mask gets no gradient.
//   As in the TPU kernel: r0 = sum_m dat_m e_m / sum_m e_m over the row,
//   dl = attn (dat - r0) scale with attn already multiplied by the query mask;
//   attn and dl are rounded to bf16 before the products. So a fully masked
//   query row, and a masked key of a valid row, get exactly zero gradient.
//
// What bounds it on the H100: 10 B H N^2 D FLOP against 8 B N C bytes: 18 GFLOP
// and 0.36 GB at [384, 88], 55 GFLOP and 0.35 GB at [128, 264]; the bytes take
// ~0.1 ms at 3.35 TB/s. This first version runs the products on the CUDA cores
// in fp32, so FMA issue and shared-memory reads bound it.
//
// Design: csrc/attention_bwd.cuh. At N = 264, q, k, v and g of one head plus
// fp32 dk/dv would need 270 KB of shared memory (the block limit is 227 KB), so
// K4's one-block layout with resident accumulators does not fit: the row pass
// writes the rounded attn and dl rows to a global scratch and the column pass
// reads them back in 32-column tiles, with k/v and then q/g in shared memory.
#include "attention_bwd.cuh"

extern "C" int editor_masked_attention_bwd(const void* qkv, const void* mask,
                                           const void* g, void* dqkv, void* pst,
                                           void* dlst, int B, int N, int H, int D,
                                           float scale, float fill, void* stream) {
  return editor_kernels::launch_attention_bwd<true>(qkv, mask, g, dqkv, pst, dlst, B,
                                                    N, H, D, scale, fill, stream);
}
