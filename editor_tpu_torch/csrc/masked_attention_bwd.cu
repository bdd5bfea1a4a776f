// K5 and K7: the VJPs of K3 and K6, masked attention from the raw qkv
// projection (fill -65504 where mask_q * mask_k == 0, query rows re-masked).
//
// Replaces the TPU kernels editor_tpu/ops/masked_attention.py::_pallas_masked_full_bwd
// (_qkv_masked_full_bwd_kernel, K5) and ::_pallas_masked_qkv_bwd
// (_qkv_masked_bwd_kernel, K7); K5 with 8 warps per block is the backward
// half of T6, tools/bench_full_kernel.py:72 (_qkv_masked_full_bwd_kernel at
// other group sizes).
//
// Contract (same as the plain versions masked_attention_qkv_bwd_plain and
// masked_attention_tiled_bwd_plain, editor_tpu_torch/ops/masked_attention.py):
//   qkv [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep), g [B, N, C] bf16
//   -> dqkv [B, N, 3C] bf16. The mask gets no gradient.
//   As in the TPU kernels: r0 = sum_m dat_m e_m / sum_m e_m over the row,
//   dl = attn (dat - r0) scale with attn already multiplied by the query mask;
//   attn and dl are rounded to bf16 before the products. So a fully masked
//   query row, and a masked key of a valid row, get exactly zero gradient.
//   K7 keeps the attn and dl of each tile's cls key (m % tile == 0) in fp32,
//   as _qkv_masked_bwd_kernel's cls columns do, and adds the fill to a masked
//   logit as its forward does.
//
// What bounds it on the H100: 10 B H N^2 D FLOP against 8 B N C bytes: 18 GFLOP
// and 0.36 GB at [384, 88], 55 GFLOP and 0.35 GB at [128, 264]; K7 49 GFLOP and
// 0.53 GB at [384, 129], 147 GFLOP and 0.53 GB at [128, 387]; the bytes take
// 0.1-0.16 ms at 3.35 TB/s. This first version runs the products on the CUDA
// cores in fp32, so FMA issue and shared-memory reads bound it. Left on the
// table: tensor cores for the four products, and the [B H, N, N] global
// scratch round trip (0.92 GB at [128, 387]).
//
// Design: csrc/attention_bwd.cuh. At N = 264, q, k, v and g of one head plus
// fp32 dk/dv would need 270 KB of shared memory (the block limit is 227 KB), so
// K4's one-block layout with resident accumulators does not fit: the row pass
// writes the rounded attn and dl rows to a global scratch and the column pass
// reads them back in 32-column tiles, with k/v and then q/g in shared memory.
// K7's cls keys get fp32 p and dl columns in shared memory (one per tile), and
// their dk and dv are reduced at the end, one tile per warp. K7 runs 4 or 8
// warps per block, whichever the occupancy API says keeps more warps resident
// (8 at N = 129 and 387, 4 at N = 258).
#include "attention_bwd.cuh"

namespace editor_kernels {
namespace {

// K7 (masked, cls keys every `tile` tokens) with kWarps warps per block
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
masked_attention_tiled_bwd_kernel(const bf16* __restrict__ qkv,
                                  const float* __restrict__ mask,
                                  const bf16* __restrict__ g, bf16* __restrict__ dqkv,
                                  bf16* __restrict__ pst, bf16* __restrict__ dlst, int N,
                                  int H, int D, float scale, float fill, int tile) {
  attention_bwd_body<true, true, kWarps>(qkv, mask, g, dqkv, pst, dlst, N, H, D, scale,
                                         fill, tile);
}

// Warps of one SM that blocks of this size keep resident (0 if none fits).
template <int kWarps>
int resident_warps(size_t smem) {
  if (allow_dynamic_smem(masked_attention_tiled_bwd_kernel<kWarps>, smem) != cudaSuccess) {
    cudaGetLastError();  // too much shared memory for this block size: not a fault
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, masked_attention_tiled_bwd_kernel<kWarps>, kWarps * 32, smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return blocks * kWarps;
}

template <int kWarps>
int launch_tiled_bwd(const void* qkv, const void* mask, const void* g, void* dqkv,
                     void* pst, void* dlst, int B, int N, int H, int D, float scale,
                     float fill, int tile, size_t smem, void* stream) {
  cudaError_t err = allow_dynamic_smem(masked_attention_tiled_bwd_kernel<kWarps>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_attention_tiled_bwd_kernel<kWarps><<<dim3(H, B), kWarps * 32, smem,
                                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
      static_cast<const bf16*>(g), static_cast<bf16*>(dqkv), static_cast<bf16*>(pst),
      static_cast<bf16*>(dlst), N, H, D, scale, fill, tile);
  return static_cast<int>(cudaGetLastError());
}

// 4 or 8 warps per block, whichever keeps more warps resident on an SM (4 on
// a tie). The shared memory grows with N, so this is the occupancy the
// sequence length leaves: at N = 387 one block fits, and 4 warps left the SM
// idle on latency (on an H100 80GB HBM3 at 700 W: 23.0 ms at [128, 387],
// 15.5 ms with 8); at N = 258 two 4-warp blocks fit and 8 warps were slower
// (6.7 against 7.6 ms).
inline int launch_masked_attention_tiled_bwd(const void* qkv, const void* mask,
                                             const void* g, void* dqkv, void* pst,
                                             void* dlst, int B, int N, int H, int D,
                                             float scale, float fill, int tile,
                                             void* stream) {
  const size_t s4 = bwd_smem_layout(N, D, N / tile, 4).total;
  const size_t s8 = bwd_smem_layout(N, D, N / tile, 8).total;
  if (resident_warps<8>(s8) > resident_warps<4>(s4))
    return launch_tiled_bwd<8>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale, fill,
                               tile, s8, stream);
  return launch_tiled_bwd<4>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale, fill, tile,
                             s4, stream);
}

}  // namespace
}  // namespace editor_kernels

// warps: 4 (the model paths) or 8
extern "C" int editor_masked_attention_bwd(const void* qkv, const void* mask,
                                           const void* g, void* dqkv, void* pst,
                                           void* dlst, int B, int N, int H, int D,
                                           float scale, float fill, int warps,
                                           void* stream) {
  using editor_kernels::launch_attention_bwd;
  if (warps == 4)
    return launch_attention_bwd<true, 4>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale,
                                         fill, stream);
  if (warps == 8)
    return launch_attention_bwd<true, 8>(qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale,
                                         fill, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7: `tile` tokens per tile (129 on the model path), N % tile == 0.
extern "C" int editor_masked_attention_tiled_bwd(const void* qkv, const void* mask,
                                                 const void* g, void* dqkv, void* pst,
                                                 void* dlst, int B, int N, int H, int D,
                                                 float scale, float fill, int tile,
                                                 void* stream) {
  return editor_kernels::launch_masked_attention_tiled_bwd(
      qkv, mask, g, dqkv, pst, dlst, B, N, H, D, scale, fill, tile, stream);
}
