// The CUDA-core attention backward of T6's backward half (K5 at 8 warps,
// csrc/masked_attention_bwd.cu; K5's body until its tensor-core redesign):
// for one (head, sequence) pair, d(softmax(l) v)/d(qkv) in the raw qkv
// layout, l the masked logits. K4, K5 and K7 run the tensor-core body of
// csrc/attention_bwd_mma.cuh.
//
// Contract (the plain version is masked_attention_qkv_bwd_plain in
// editor_tpu_torch/ops/masked_attention.py):
//   qkv  [B, N, 3C] bf16, mask [B, N] fp32, g [B, N, C] bf16 (cotangent of
//   the [B, N, C] output)
//   dqkv [B, N, 3C] bf16, written in place into the q, k and v column slices
//   pst, dlst [B * H, N, N] bf16 global scratch: the rounded probabilities and
//   logit cotangents of every row, written by the row pass and read back by
//   the column pass of the same block (the caller allocates them).
// Math per query row n (fp32 sums):
//   p = softmax(l), l = q_n . k_m * scale, or the fill where mask_m == 0 (the
//   TPU body adds the fill; a masked key of a valid row exps to 0 either way)
//   dp_m = g_n . v_m, r = sum_m dp_m p_m, dl_m = p_m (dp_m - r) scale
//   dq_n = sum_m dl_m k_m;  dk_m = sum_n dl_{n,m} q_n;  dv_m = sum_n p_{n,m} g_n
// Rounding points of the TPU kernel _qkv_masked_full_bwd_kernel: p and dl are
// rounded to bf16 before the three products (no cls key keeps fp32). A query
// row with mask 0 gets exactly zero gradient and contributes nothing; a
// masked key of a valid row gets p = 0 exactly (exp underflow), hence zero
// dk and dv.
//
// What bounds it on the H100: 10 B H N^2 D FLOP (the recomputed logits, dp,
// dq, dk, dv) against qkv + g + dqkv = 14 B N C bytes; 23 GFLOP and 0.73 GB
// at [384, 88] + [128, 264]. This body runs every product on the CUDA cores
// in fp32 (no mma/wgmma), so FMA issue and shared-memory reads bound it, not
// the bytes.
//
// Design: one block per (head, sequence) pair, kWarps warps, two passes.
//  * Row pass: the head's k and v slices are staged in padded shared memory
//    (as in K1/K3). Each warp owns one query row at a time: lanes over keys
//    for the logits, the softmax and dp (fp32 q and g rows broadcast from the
//    warp's scratch), then over head-dim pairs for dq = dl . k, written
//    straight into dqkv. The row's rounded p and dl go to the global scratch,
//    coalesced along the row.
//  * Column pass: q and g of the head replace k and v in shared memory. The
//    block loads 8 columns per warp of p and dl at a time (all N rows, bf16)
//    into a shared tile; each warp owns 8 of those columns and, with lanes
//    over head-dim pairs, accumulates dk and dv for all 8 at once, so each q
//    and g pair read from shared memory feeds 32 FMAs.
// The scratch of one block (2 N^2 bf16: 279 KB at N = 264) is written and
// read back by that block while it is still in the 50 MB L2: q, k, v, g plus
// fp32 dk/dv of one head would take 270 KB of shared memory at N = 264, over
// the 227 KB a block may have. Shared memory here is 2 N (D + 4) bf16 + N
// fp32 (the key mask) + max(row scratch, column tile).
#pragma once

#include "common.cuh"

namespace editor_kernels {

constexpr int kBwdColsPerWarp = 8;  // column-pass tile: 8 columns per warp

__host__ __device__ inline size_t bwd_align16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

struct BwdSmem {
  size_t buf, vec, scratch, tile, total;
};

// warps: the block's warps (each has a row of scratch and 8 tile columns)
__host__ __device__ inline BwdSmem bwd_smem_layout(int N, int D, int warps) {
  const int Np = (N + 3) & ~3;
  BwdSmem s;
  s.buf = bwd_align16((size_t)N * (D + kRowPad) * sizeof(bf16));
  s.vec = bwd_align16((size_t)Np * sizeof(float));
  s.scratch = (size_t)warps * (2 * D + 2 * Np) * sizeof(float);
  s.tile = 2 * (size_t)N * warps * kBwdColsPerWarp * sizeof(bf16);
  const size_t un = s.scratch > s.tile ? s.scratch : s.tile;
  s.total = 2 * s.buf + s.vec + bwd_align16(un);
  return s;
}

// Stage the [N, D] slice at column offset `col` of rows with stride `row_stride`
// into shared memory [N, D + kRowPad], bf16 pairs.
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, bf16* dst,
                                           int N, int row_stride, int col, int D) {
  const int ld = D + kRowPad;
  const int D2 = D / 2;
  for (int i = threadIdx.x; i < N * D2; i += blockDim.x) {
    const int m = i / D2, d2 = i - m * D2;
    reinterpret_cast<bf16x2*>(dst + m * ld)[d2] =
        reinterpret_cast<const bf16x2*>(src + (size_t)m * row_stride + col)[d2];
  }
}

// T6's backward: masked (fill replaces a masked logit), kWarps warps per block.
template <int kWarps>
__device__ __forceinline__ void attention_bwd_body(
    const bf16* __restrict__ qkv, const float* __restrict__ mask,
    const bf16* __restrict__ g, bf16* __restrict__ dqkv, bf16* __restrict__ pst,
    bf16* __restrict__ dlst, int N, int H, int D, float scale, float fill) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * D, C3 = 3 * C;
  const int ld = D + kRowPad;
  const int Np = (N + 3) & ~3;
  const int D2 = D / 2;
  constexpr int kCols = kWarps * kBwdColsPerWarp;  // columns per column-pass tile
  const BwdSmem lay = bwd_smem_layout(N, D, kWarps);
  bf16* buf0 = reinterpret_cast<bf16*>(smem);              // k, then q
  bf16* buf1 = reinterpret_cast<bf16*>(smem + lay.buf);    // v, then g
  float* mk = reinterpret_cast<float*>(smem + 2 * lay.buf);
  unsigned char* un = smem + 2 * lay.buf + lay.vec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const bf16* seq = qkv + (size_t)b * N * C3;
  const bf16* gseq = g + (size_t)b * N * C;
  bf16* dseq = dqkv + (size_t)b * N * C3;
  const size_t bh = (size_t)b * H + h;
  bf16* P = pst + bh * N * N;
  bf16* DL = dlst + bh * N * N;

  // ---- row pass: p, dp, dl and dq of every query row -------------------
  stage_rows(seq, buf0, N, C3, C + h * D, D);
  stage_rows(seq, buf1, N, C3, 2 * C + h * D, D);
  for (int m = threadIdx.x; m < N; m += blockDim.x)
    mk[m] = mask[(size_t)b * N + m];
  __syncthreads();

  float* qr = reinterpret_cast<float*>(un) + warp * (2 * D + 2 * Np);
  float* gr = qr + D;
  float* pr = gr + D;
  float* wr = pr + Np;
  for (int n = warp; n < N; n += kWarps) {
    bf16* dq_row = dseq + (size_t)n * C3 + h * D;
    if (mk[n] == 0.f) {  // re-masked row: exactly zero gradient
      for (int d = lane; d < D; d += 32) dq_row[d] = __float2bfloat16(0.f);
      continue;
    }
    load_q(seq, qr, n, C, h, D, lane);
    for (int d = lane; d < D; d += 32)
      gr[d] = __bfloat162float(gseq[(size_t)n * C + h * D + d]);
    __syncwarp();
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) {
      float s;
      if (mk[m] == 0.f)
        s = fill;
      else
        s = dot_q_k(qr, buf0 + m * ld, D) * scale;
      pr[m] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float e = expf(pr[m] - mx);
      pr[m] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);  // the max element gives 1: sum >= 1
    float r = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float p = pr[m] * inv;
      const float dp = dot_q_k(gr, buf1 + m * ld, D);
      pr[m] = p;
      wr[m] = dp;
      r = fmaf(dp, p, r);
    }
    r = warp_sum(r);
    bf16* prow = P + (size_t)n * N;
    bf16* dlrow = DL + (size_t)n * N;
    for (int m = lane; m < N; m += 32) {
      const float p = pr[m];
      const bf16 db = __float2bfloat16(p * (wr[m] - r) * scale);
      prow[m] = __float2bfloat16(p);
      dlrow[m] = db;
      wr[m] = __bfloat162float(db);
    }
    __syncwarp();
    weighted_v_row(wr, buf0, N, D, 1.f, dq_row, lane);  // dq = dl . k
    __syncwarp();  // the row scratch is rewritten for the next row
  }
  __syncthreads();  // k, v no longer needed; every row's p and dl written

  // ---- column pass: dk = dl^T q, dv = p^T g -------------------------------
  stage_rows(seq, buf0, N, C3, h * D, D);
  stage_rows(gseq, buf1, N, C, h * D, D);
  bf16* tp = reinterpret_cast<bf16*>(un);
  bf16* tl = tp + (size_t)N * kCols;
  for (int m0 = 0; m0 < N; m0 += kCols) {
    __syncthreads();  // staging done, or the previous tile consumed
    for (int i = threadIdx.x; i < N * kCols; i += blockDim.x) {
      const int n = i / kCols, c = i - n * kCols;
      const int m = m0 + c;
      // masked rows were never written: load zeros in their place
      const bool ok = m < N && mk[n] != 0.f;
      tp[i] = ok ? P[(size_t)n * N + m] : __float2bfloat16(0.f);
      tl[i] = ok ? DL[(size_t)n * N + m] : __float2bfloat16(0.f);
    }
    __syncthreads();
    const int c0 = warp * kBwdColsPerWarp;
    for (int d2 = lane; d2 < D2; d2 += 32) {
      float av[8][2], ak[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) av[j][0] = av[j][1] = ak[j][0] = ak[j][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float2 qf = __bfloat1622float2(reinterpret_cast<const bf16x2*>(buf0 + n * ld)[d2]);
        const float2 gf = __bfloat1622float2(reinterpret_cast<const bf16x2*>(buf1 + n * ld)[d2]);
        const uint4 pv = *reinterpret_cast<const uint4*>(tp + n * kCols + c0);
        const uint4 lv = *reinterpret_cast<const uint4*>(tl + n * kCols + c0);
        const unsigned pw[4] = {pv.x, pv.y, pv.z, pv.w};
        const unsigned lw[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          const float2 p2 = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&pw[j2]));
          const float2 l2 = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&lw[j2]));
          av[2 * j2][0] = fmaf(p2.x, gf.x, av[2 * j2][0]);
          av[2 * j2][1] = fmaf(p2.x, gf.y, av[2 * j2][1]);
          av[2 * j2 + 1][0] = fmaf(p2.y, gf.x, av[2 * j2 + 1][0]);
          av[2 * j2 + 1][1] = fmaf(p2.y, gf.y, av[2 * j2 + 1][1]);
          ak[2 * j2][0] = fmaf(l2.x, qf.x, ak[2 * j2][0]);
          ak[2 * j2][1] = fmaf(l2.x, qf.y, ak[2 * j2][1]);
          ak[2 * j2 + 1][0] = fmaf(l2.y, qf.x, ak[2 * j2 + 1][0]);
          ak[2 * j2 + 1][1] = fmaf(l2.y, qf.y, ak[2 * j2 + 1][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = m0 + c0 + j;
        if (m >= N) continue;
        bf16* row = dseq + (size_t)m * C3 + h * D;
        reinterpret_cast<bf16x2*>(row + C)[d2] = __floats2bfloat162_rn(ak[j][0], ak[j][1]);
        reinterpret_cast<bf16x2*>(row + 2 * C)[d2] = __floats2bfloat162_rn(av[j][0], av[j][1]);
      }
    }
  }
}

// T6's backward with kWarps warps per block: 8 (tools/bench_full_kernel.py:72
// at another group size)
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                     const bf16* __restrict__ g, bf16* __restrict__ dqkv,
                     bf16* __restrict__ pst, bf16* __restrict__ dlst, int N, int H,
                     int D, float scale, float fill) {
  attention_bwd_body<kWarps>(qkv, mask, g, dqkv, pst, dlst, N, H, D, scale, fill);
}

template <int kWarps>
inline int launch_attention_bwd(const void* qkv, const void* mask, const void* g,
                                void* dqkv, void* pst, void* dlst, int B, int N, int H,
                                int D, float scale, float fill, void* stream) {
  const size_t smem = bwd_smem_layout(N, D, kWarps).total;
  cudaError_t err = allow_dynamic_smem(attention_bwd_kernel<kWarps>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_kernel<kWarps><<<dim3(H, B), kWarps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
      static_cast<const bf16*>(g), static_cast<bf16*>(dqkv), static_cast<bf16*>(pst),
      static_cast<bf16*>(dlst), N, H, D, scale, fill);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace editor_kernels
