// T3: the attention half-layer in one kernel, mid = proj(attention(LN(x))).
//
// Replaces the TPU kernel tools/bench_attn_layer.py::attn_layer
// (_attn_layer_kernel), a design probe: the JAX backbone runs the same math
// as LayerNorm, two matmuls and K1.
//
// Contract (same as the plain version attn_layer_plain,
// editor_tpu_torch/tools/bench_attn_layer.py):
//   x [B, N, C] bf16; LayerNorm weight and bias [C], bqkv [3C], bp [C] bf16;
//   wqkv [C, 3C] and wp [C, C] bf16, stored in x out (y = x . w).
//   out [B, N, C] bf16; probs [B, H, N, N] bf16 (may be null).
// Rounding points of _attn_layer_kernel: y = LN(x) (fp32 statistics, eps)
// rounded to bf16; qkv = y . wqkv + bqkv with fp32 accumulation, rounded to
// bf16; attention as K1 (csrc/attention_rows.cuh: the patch probabilities
// rounded to bf16 before p.v, the cls key's fp32), each head's output bf16;
// out = att . wp + bp, fp32 accumulation, one rounding to bf16.
//
// What bounds it on the H100: operations. At B = 384, N = 129, C = 768 the
// two products take 2 B N C (3C + C) = 233.7 GFLOP and the attention 19.6, so
// 0.26 ms at the 989 TFLOP/s bf16 tensor-core peak, against 0.15 GB of x,
// weights and out (0.2 GB with probs).
//
// Design: the TPU kernel keeps both weight matrices resident in VMEM; 4.7 MB of
// bf16 weights cannot sit in the 227 KB of a block, so this first version
// streams them. One block of 8 warps per g sequences (g N rows), three phases
// separated by __syncthreads:
//  1. per 48-row chunk: LayerNorm of x into shared memory (bf16, the chunk
//     stays resident), then for each 256-column tile the weight streamed
//     through shared memory in 32-row k slices and multiplied with nvcuda::wmma
//     bf16 16x16x16 fragments (fp32 accumulators, 3 x 2 per warp), + bias,
//     bf16, into a global qkv workspace [B, N, 3C];
//  2. K1's attention (one query row per warp, k and v of a head staged in
//     shared memory) from the workspace into a second one [B, N, C];
//  3. the projection as in 1, the chunk copied from that workspace.
// The workspaces are written and read back by the same block. Shared memory:
// 48 (C + 8) + 32 x 264 bf16 + a 16x16 fp32 stage per warp = 97 KB at
// C = 768 (phase 2 needs 40 KB of it), so two blocks run per SM. Left on the
// table: wgmma with TMA-fed rings, keeping the workspaces on chip, and a
// chunk height that divides N (48 leaves 15 of 144 rows idle at N = 129).
#include <mma.h>

#include "attention_rows.cuh"

namespace editor_kernels {
namespace {

constexpr int kAlWarps = 8;
constexpr int kAlBM = 48, kAlBN = 256, kAlBK = 32;
constexpr int kAlPad = 8;                          // bf16: rows stay 16-byte aligned
constexpr int kAlRowFrags = kAlBM / 16;             // 3
constexpr int kAlColFrags = kAlBN / 16 / kAlWarps;  // 2 per warp

size_t attn_layer_smem_bytes(int N, int H, int D) {
  const int C = H * D;
  const size_t gemm = (size_t)kAlBM * (C + kAlPad) * sizeof(bf16) +
                      (size_t)kAlBK * (kAlBN + kAlPad) * sizeof(bf16) +
                      (size_t)kAlWarps * 16 * 16 * sizeof(float);
  const size_t attn = attention_smem_bytes(N, D, kAlWarps);
  return gemm > attn ? gemm : attn;
}

// out[r, o] = bf16(sum_k A[r, k] w[k, o] + bias[o]) for the M rows of the
// block, A [M, K] and out [M, O] row-major. kLN: A = bf16(LN(a)) with
// weight lnw and bias lnb, computed here; else A = a. K % 32 == 0,
// O % 16 == 0, 16-byte aligned rows.
template <bool kLN>
__device__ void al_gemm(const bf16* a, int M, int K, const bf16* __restrict__ w,
                        const bf16* __restrict__ bias, bf16* out, int O,
                        const bf16* __restrict__ lnw, const bf16* __restrict__ lnb, float eps,
                        unsigned char* smem) {
  using namespace nvcuda;
  const int lda = K + kAlPad, ldw = kAlBN + kAlPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* ws = as + (size_t)kAlBM * lda;
  float* stage = reinterpret_cast<float*>(ws + (size_t)kAlBK * ldw) + warp * 256;
  const int K8 = K / 8;
  for (int r0 = 0; r0 < M; r0 += kAlBM) {
    __syncthreads();  // the previous chunk is no longer read
    for (int r = warp; r < kAlBM; r += kAlWarps) {
      bf16* ar = as + (size_t)r * lda;
      const int t = r0 + r;
      if (t >= M) {  // past the last row: zeros, never written out
        for (int i = lane; i < K8; i += 32)
          reinterpret_cast<uint4*>(ar)[i] = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const uint4* src = reinterpret_cast<const uint4*>(a + (size_t)t * K);
      if constexpr (!kLN) {
        for (int i = lane; i < K8; i += 32) reinterpret_cast<uint4*>(ar)[i] = src[i];
      } else {
        float sum = 0.f;
        for (int i = lane; i < K8; i += 32) {
          const uint4 raw = src[i];
          reinterpret_cast<uint4*>(ar)[i] = raw;
          const bf16x2* p = reinterpret_cast<const bf16x2*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(p[j]);
            sum += f.x + f.y;
          }
        }
        const float mu = warp_sum(sum) / K;
        __syncwarp();
        float sq = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = __bfloat162float(ar[k]) - mu;
          sq = fmaf(d, d, sq);
        }
        const float rstd = rsqrtf(warp_sum(sq) / K + eps);
        for (int k = lane; k < K; k += 32) {
          const float y = (__bfloat162float(ar[k]) - mu) * rstd * __bfloat162float(lnw[k]) +
                          __bfloat162float(lnb[k]);
          ar[k] = __float2bfloat16(y);
        }
      }
    }
    for (int c0 = 0; c0 < O; c0 += kAlBN) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kAlRowFrags][kAlColFrags];
#pragma unroll
      for (int i = 0; i < kAlRowFrags; ++i)
#pragma unroll
        for (int j = 0; j < kAlColFrags; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int k0 = 0; k0 < K; k0 += kAlBK) {
        __syncthreads();  // the chunk is ready, or the previous slice consumed
        // the weight slice [BK, BN]: rows k0.. of w, columns c0..; 16-byte loads
        for (int i = threadIdx.x; i < kAlBK * (kAlBN / 8); i += blockDim.x) {
          const int kr = i / (kAlBN / 8), c8 = i % (kAlBN / 8);
          const int o = c0 + c8 * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (o < O) val = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kr) * O + o);
          *reinterpret_cast<uint4*>(ws + kr * ldw + c8 * 8) = val;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kAlBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[kAlRowFrags];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[kAlColFrags];
#pragma unroll
          for (int i = 0; i < kAlRowFrags; ++i)
            wmma::load_matrix_sync(af[i], as + (size_t)(i * 16) * lda + k0 + kk, lda);
#pragma unroll
          for (int j = 0; j < kAlColFrags; ++j)
            wmma::load_matrix_sync(bfr[j], ws + kk * ldw + (warp * kAlColFrags + j) * 16, ldw);
#pragma unroll
          for (int i = 0; i < kAlRowFrags; ++i)
#pragma unroll
            for (int j = 0; j < kAlColFrags; ++j)
              wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
        }
      }
      // epilogue through the warp's 16x16 stage: + bias, one rounding, 16-byte stores
      const int rr = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
      for (int i = 0; i < kAlRowFrags; ++i) {
#pragma unroll
        for (int j = 0; j < kAlColFrags; ++j) {
          wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          const int t = r0 + i * 16 + rr;
          const int o = c0 + (warp * kAlColFrags + j) * 16 + cc;
          if (t < M && o < O) {
            uint4 packed;
            bf16x2* pk = reinterpret_cast<bf16x2*>(&packed);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v0 = stage[rr * 16 + cc + 2 * e] + __bfloat162float(bias[o + 2 * e]);
              const float v1 =
                  stage[rr * 16 + cc + 2 * e + 1] + __bfloat162float(bias[o + 2 * e + 1]);
              pk[e] = __floats2bfloat162_rn(v0, v1);
            }
            *reinterpret_cast<uint4*>(out + (size_t)t * O + o) = packed;
          }
          __syncwarp();  // the stage is rewritten by the next fragment
        }
      }
    }
  }
}

// One block per `seqs` sequences; qkv_ws [B, N, 3C] and att_ws [B, N, C] are
// workspaces that only the block owning their rows writes and reads.
__global__ void __launch_bounds__(kAlWarps * 32)
attn_layer_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                  const bf16* __restrict__ lnb, const bf16* __restrict__ wqkv,
                  const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
                  const bf16* __restrict__ bp, bf16* __restrict__ out, bf16* probs,
                  bf16* qkv_ws, bf16* att_ws, int B, int N, int H, int D, float scale,
                  float eps, int seqs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = H * D;
  const int b0 = blockIdx.x * seqs;
  const int nseq = min(seqs, B - b0);
  const int M = nseq * N;
  const size_t row0 = (size_t)b0 * N;
  // 1. qkv = LN(x) . wqkv + bqkv
  al_gemm<true>(x + row0 * C, M, C, wqkv, bqkv, qkv_ws + row0 * 3 * C, 3 * C, lnw, lnb, eps,
                smem);
  // 2. attention, head by head over the block's sequences
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the workspace rows are written; the last head's k, v consumed
    attention_block<kAlWarps>(qkv_ws, qkv_ws + C, qkv_ws + 2 * C, 3 * C, 3 * C, 3 * C, att_ws,
                              probs, b0, nseq, h, N, H, D, scale, smem);
  }
  // 3. out = att . wp + bp (al_gemm starts with __syncthreads)
  al_gemm<false>(att_ws + row0 * C, M, C, wp, bp, out + row0 * C, C, nullptr, nullptr, 0.f,
                 smem);
}

}  // namespace
}  // namespace editor_kernels

// seqs >= 1 sequences per block; C = H * D with C % 32 == 0, D % 4 == 0,
// N <= 512; every pointer 16-byte aligned.
extern "C" int editor_attn_layer(const void* x, const void* lnw, const void* lnb,
                                 const void* wqkv, const void* bqkv, const void* wp,
                                 const void* bp, void* out, void* probs, void* qkv_ws,
                                 void* att_ws, int B, int N, int H, int D, float scale,
                                 float eps, int seqs, void* stream) {
  using namespace editor_kernels;
  if (seqs < 1 || (H * D) % 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = attn_layer_smem_bytes(N, H, D);
  cudaError_t err = allow_dynamic_smem(attn_layer_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_layer_kernel<<<(B + seqs - 1) / seqs, kAlWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(lnw),
      static_cast<const bf16*>(lnb), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bp), static_cast<bf16*>(out), static_cast<bf16*>(probs),
      static_cast<bf16*>(qkv_ws), static_cast<bf16*>(att_ws), B, N, H, D, scale, eps, seqs);
  return static_cast<int>(cudaGetLastError());
}
