// K2: attention rollout, the cls row of the chain product of the per-layer
// attention maps, as a reverse vector chain v <- v . A_l.
//
// Replaces the TPU kernel editor_tpu/ops/rollout.py::_pallas_chain_split
// (_chain_kernel).
//
// Contract (same as the plain version, editor_tpu_torch/ops/rollout.py):
//   probs [L, Z, N, N] bf16: per-layer post-softmax maps, Z = B * H (b, h)
//   pairs, row = query. out [Z, N - 1] fp32: v[1:] where v is seeded with row 0
//   of the last layer's map and v <- v . A_l for l = L-2 .. 0 (the reference
//   chain order, last_map = att[i] @ last_map).
//
// What bounds it on the H100: bytes. Every layer's map is read exactly once:
// L x Z x N x N x 2 B = 1.84 GB at the flagship shape (L = 12, Z = 4608,
// N = 129), about 0.55 ms at 3.35 TB/s, against only 2 L Z N^2 = 1.8 GFLOP.
//
// Design: one block per (b, h) pair, one thread per output column m (N rounded
// up to whole warps), so a warp reads 32 neighbouring bf16 of one row per step
// and the block streams each contiguous N x N map front to back. The layer
// loop runs inside the block (the TPU kernel's sequential grid axis has no
// Hopper counterpart); v lives in fp32 in shared memory, double-buffered so
// one __syncthreads per layer suffices.
#include "common.cuh"

namespace editor_kernels {
namespace {

__global__ void rollout_chain_kernel(const bf16* __restrict__ probs,
                                     float* __restrict__ out, int L, int Z, int N) {
  __shared__ float buf[2][kMaxTokens];
  float* cur = buf[0];
  float* nxt = buf[1];
  const int z = blockIdx.x;
  const int m = threadIdx.x;
  const size_t map = (size_t)N * N;
  const size_t layer = (size_t)Z * map;
  if (m < N) cur[m] = __bfloat162float(probs[(size_t)(L - 1) * layer + z * map + m]);
  __syncthreads();
  for (int l = L - 2; l >= 0; --l) {
    if (m < N) {
      const bf16* col = probs + (size_t)l * layer + z * map + m;
      float acc = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) acc = fmaf(cur[n], __bfloat162float(col[(size_t)n * N]), acc);
      nxt[m] = acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (m >= 1 && m < N) out[(size_t)z * (N - 1) + m - 1] = cur[m];
}

}  // namespace
}  // namespace editor_kernels

extern "C" int editor_rollout_chain(const void* probs, void* out, int L, int Z, int N,
                                    void* stream) {
  using namespace editor_kernels;
  const int threads = (N + 31) / 32 * 32;
  rollout_chain_kernel<<<Z, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(probs), static_cast<float*>(out), L, Z, N);
  return static_cast<int>(cudaGetLastError());
}
