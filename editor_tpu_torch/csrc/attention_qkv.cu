// K1: multi-head softmax attention straight from the raw qkv projection,
// optionally writing the post-softmax probabilities for the attention rollout;
// and its design variants T1 and T2.
//
// Replaces the TPU kernels editor_tpu/ops/fused_attention.py::_pallas_attention_qkv
// (_qkv_kernel, math in _head_split_softmax_av; K1),
// tools/bench_attn.py::headgrid_attn (_headgrid_kernel; T1) and
// tools/bench_attn2.py::nomax_attn (_kernel_nomax; T2).
//
// Contract (K1's plain versions: attention_qkv_tpu_plain, in the kernel's
// rounding form, and attention_qkv_plain in editor_tpu_torch/ops/fused_attention.py;
// T1/T2: headgrid_attn_plain and nomax_attn_plain in editor_tpu_torch/tools/bench_attn{,2}.py):
//   qkv   [B, N, 3C] bf16, laid out [q_h0..q_hH | k_h0.. | v_h0..], C = H * D
//         (T1: separate q, k, v [B, N, C], each with its own row stride)
//   out   [B, N, C]  bf16 = softmax(q k^T * scale) v, heads at columns h*D
//   probs [B, H, N, N] bf16 post-softmax rows (may be null)
// Rounding points, as the TPU body: fp32 logits (bf16 products are exact)
// times scale; fp32 row max, exp and sum, p = e * (1 / sum); probs = bf16(p);
// the patch keys' (m >= 1) p rounded to bf16 before p.v, the cls key's p_0
// kept in fp32 and p_0 v_0 added to the fp32 sum; out rounded once. Only
// the order of the sums differs from the TPU body. T2 drops the row max (exp
// of the raw logits), valid only while |logit| < ~80.
//
// What bounds K1 on the H100: at the flagship shape (B = 384, N = 129, H =
// 12, D = 64) one call reads 228 MB of qkv and writes 76 MB of output plus
// 153 MB of probs: 0.137 ms at 3.35 TB/s, against 19.6 GFLOP of q.k and p.v
// products (0.02 ms on the bf16 tensor cores): bytes.
//
// K1's design (attention_qkv_kernel): one block per (head, sequence), 3 warps
// at N = 129 (9 query tiles of 16 rows, 3 rounds; at most 4 warps), 54 KB of
// shared memory and at most 168 registers a thread, so that 4 blocks (12
// warps) share an SM: occupancy is what hides the latency of each warp's
// chain of loads, products and exps (PERF.md, findings). The head's
// k and v rows (128 contiguous bytes each in a 4608-byte qkv row) go to
// shared memory with 16-byte cp.async, rows padded by 16 bytes so that
// ldmatrix reads 8 rows in 8 distinct bank groups; keys past N (129 -> 144)
// are zero. Each warp loads its 16 q rows straight from global memory as the
// A operand of mma.sync m16n8k16 (bf16 in, fp32 sums); S = q k^T takes k
// through ldmatrix (k stored [key][d] is already the "col" operand). The
// logits of the whole row stay in registers (72 floats a thread at N = 129);
// row max and sum reduce over the 4 lanes of a quad. The accumulator tiles of
// p are re-packed in registers as the A operand of p.v (v through
// ldmatrix.trans), key 0's entry zeroed there and p_0 v_0 added in fp32. The
// probs tile is staged in shared memory at its global address modulo 16
// bytes and written with 16-byte stores in the aligned middle of its span
// (a map starts only 2-byte aligned at odd N) and 2-byte stores at the ends.
// Padded keys are -inf before the max (exp gives 0, not NaN, at |logit| ~
// 1e3); query rows past N are never stored. Past 16 KT keys (144 at D <= 96,
// 80 above: the registers of one chunk of logits) the keys come in chunks,
// each pass (max, sum, normalise + store + p.v) loading each chunk of k (and
// v) anew and making its logits again; every N <= kMaxTokens and every D a
// multiple of 16 up to 128 is one template instance per D.
//
// The variants (editor_attention_variant) keep the CUDA-core body of
// csrc/attention_rows.cuh, one query row per warp: q, k and v as three
// pointers with row strides (T1 reads separate head-contiguous tensors, or
// the q/k/v column views of the packed qkv with no copy), 1 or 2 heads per
// block (4 warps per head, 70 KB of k/v at N = 129 for 2 heads), g sequences
// per block one after another, and kNoMax (T2).
#include "attention_rows.cuh"
#include "mma.cuh"

namespace editor_kernels {
namespace {

constexpr int kWarps = 4;  // T1/T2: warps per head

// ---------------------------------------------------------------------------
// K1 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kK1MaxWarps = 4;
constexpr int kK1ResidentWarps = 3;   // 9 query tiles at N = 129: 3 rounds
// resident blocks an SM that the register budget must allow: 4 x 54 KB of
// shared memory at D <= 64 (ptxas budgets a 3-warp block as 4 warps: 168
// registers a thread); wider heads, on no model path, take what the
// compiler gives
__host__ __device__ constexpr int k1_resident_blocks(int DK) { return DK <= 4 ? 4 : 1; }

// 16-key tiles of one key chunk: the logits of a chunk stay in registers
// (2 KT x 4 floats a thread), so fewer for the wide heads
__host__ __device__ constexpr int k1_key_tiles(int DK) { return DK <= 6 ? 9 : 5; }

// x rounded to bf16, stored at a 32-bit shared-memory address
__device__ __forceinline__ void st_shared_bf16(unsigned a, float x) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"(__bfloat16_as_ushort(
                   __float2bfloat16_rn(x))) : "memory");
}

// Rows [key0, key0 + rows) of the head's k (and v) into shared memory ([rows,
// D + 8] each) with 16-byte cp.async; keys >= N are zero-filled (a padded v
// row meets a zero probability, and 0 x NaN would not be 0). The block's
// threads all call it: it waits for the copies and synchronises on both sides.
template <int D>
__device__ __forceinline__ void k1_load_kv(const bf16* __restrict__ seq, int ldq, int koff,
                                           int voff, bf16* ks, bf16* vs, int key0, int rows,
                                           int N, bool with_v) {
  constexpr int LD = D + 8, SEG = D / 8;
  __syncthreads();  // every warp is done with the last chunk
  for (int i = threadIdx.x; i < rows * SEG; i += blockDim.x) {
    const int m = i / SEG, sg = i - m * SEG;
    bf16* kd = ks + m * LD + sg * 8;
    bf16* vd = vs + m * LD + sg * 8;
    if (key0 + m < N) {
      const bf16* src = seq + (size_t)(key0 + m) * ldq + sg * 8;
      cp_async16(kd, src + koff);
      if (with_v) cp_async16(vd, src + voff);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
      if (with_v) *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// The scaled logits of one warp's 16 query rows against the chunk's keys
// [key0, key0 + 16 KT): s[j] is the accumulator tile of keys key0 + 8j..+7
// (rows g, g + 8; keys 2t, 2t + 1). Keys >= N are -inf.
template <int DK, int KT>
__device__ __forceinline__ void k1_logits(const uint32_t (&qa)[DK][4], const bf16* ks,
                                          int key0, int N, float scale,
                                          float (&s)[2 * KT][4], int lane) {
  constexpr int LD = 16 * DK + 8;
  const int t = lane & 3;
  // ldmatrix rows: lanes 0-7 keys 0-7 at d 0, 8-15 keys 0-7 at d 8,
  // 16-23 keys 8-15 at d 0, 24-31 keys 8-15 at d 8 -> b0, b1 of two key tiles
  const unsigned kl = smem_addr(ks + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                                (((lane >> 3) & 1) << 3));
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    const bool live = key0 + 16 * kk < N;
    if (live) {
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        uint32_t b[4];
        ldmatrix_x4(b, kl + (16 * kk * LD + 16 * d) * 2);
        mma_bf16(c0, qa[d], b[0], b[1]);
        mma_bf16(c1, qa[d], b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + 16 * kk + 2 * t + (i & 1);
      s[2 * kk][i] = live && key < N ? c0[i] * scale : -INFINITY;
      s[2 * kk + 1][i] = live && key + 8 < N ? c1[i] * scale : -INFINITY;
    }
  }
}

// n bf16 from shared memory to global memory, src and dst equal modulo 16
// bytes: 2-byte stores up to dst's first 16-byte boundary, 16-byte stores in
// the aligned middle, 2-byte stores for the rest.
__device__ __forceinline__ void k1_store_span(bf16* dst, const bf16* src, int n, int lane) {
  const int head = min(n, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u))
                                            & 15u) >> 1));
  if (lane < head) dst[lane] = src[lane];
  const int nv = (n - head) >> 3;
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (int i = lane; i < nv; i += 32) dv[i] = sv[i];
  for (int i = head + nv * 8 + lane; i < n; i += 32) dst[i] = src[i];
}

// K1: one block per (head, sequence), `blockDim.x / 32` warps, each warp one
// 16-row query tile at a time. The keys come in chunks of 16 KT. kResident
// (N <= 16 KT, the backbone's 129 tokens): the head's k and v are loaded
// once and the logits are made once; at most 3 warps and a register budget
// that lets 4 blocks share an SM. Else (`nch` chunks, at most 4 warps) each
// pass (row max; exp sum; normalise, store, p.v) makes each chunk's logits
// anew from a chunk of k (and v) loaded for it. `se`: bf16 elements of each
// warp's probs staging buffer.
template <int DK, int KT, bool kResident>
__global__ void __launch_bounds__(kResident ? kK1ResidentWarps * 32 : kK1MaxWarps * 32,
                                  kResident ? k1_resident_blocks(DK) : 1)
attention_qkv_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     bf16* __restrict__ probs, int N, int H, float scale, int nch, int se) {
  constexpr int D = 16 * DK, LD = D + 8, KC = 16 * KT;
  if (kResident) nch = 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * D, ldq = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int npad = (N + 15) & ~15, ntiles = npad >> 4;
  constexpr bool resident = kResident;
  const int rows_kv = resident ? npad : KC;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + rows_kv * LD;
  bf16* stage = vs + rows_kv * LD + warp * se;
  const bf16* seq = qkv + (size_t)b * N * ldq;
  bf16* pmap = probs ? probs + ((size_t)b * H + h) * N * N : nullptr;
  const int koff = C + h * D, voff = 2 * C + h * D;

  if (resident) k1_load_kv<D>(seq, ldq, koff, voff, ks, vs, 0, npad, N, true);
  for (int r0w = 0; r0w < ntiles; r0w += nwarps) {  // the same trip count in every warp
    const int tile = r0w + warp;
    const bool active = tile < ntiles;  // warp-uniform
    const int r0 = tile * 16;
    const bool row_g = r0 + g < N, row_g8 = r0 + g + 8 < N;
    // q as the A operand, straight from global memory (rows >= N are 0)
    uint32_t qa[DK][4];
    if (active) {
      const bf16* q0 = seq + (size_t)(r0 + g) * ldq + h * D + 2 * t;
      const bf16* q8 = q0 + 8 * (size_t)ldq;
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        qa[d][0] = row_g ? *reinterpret_cast<const uint32_t*>(q0 + 16 * d) : 0u;
        qa[d][1] = row_g8 ? *reinterpret_cast<const uint32_t*>(q8 + 16 * d) : 0u;
        qa[d][2] = row_g ? *reinterpret_cast<const uint32_t*>(q0 + 16 * d + 8) : 0u;
        qa[d][3] = row_g8 ? *reinterpret_cast<const uint32_t*>(q8 + 16 * d + 8) : 0u;
      }
    }
    float s[2 * KT][4];
    // pass 1: the row max (rows g, g + 8)
    float mx0 = -INFINITY, mx8 = -INFINITY;
    for (int c = 0; c < nch; ++c) {
      if (!resident) k1_load_kv<D>(seq, ldq, koff, voff, ks, vs, c * KC, min(KC, npad - c * KC),
                                   N, false);
      if (active) {
        k1_logits<DK, KT>(qa, ks, c * KC, N, scale, s, lane);
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx8 = fmaxf(mx8, fmaxf(s[j][2], s[j][3]));
        }
      }
    }
    mx0 = quad_max(mx0);
    mx8 = quad_max(mx8);
    // pass 2: the exp sum (the max element gives exp(0) = 1, so sum >= 1;
    // a padded key's exp(-inf) is 0)
    float sum0 = 0.f, sum8 = 0.f;
    for (int c = 0; c < nch; ++c) {
      if (!resident) {
        k1_load_kv<D>(seq, ldq, koff, voff, ks, vs, c * KC, min(KC, npad - c * KC), N, false);
        if (active) k1_logits<DK, KT>(qa, ks, c * KC, N, scale, s, lane);
      }
      if (active) {
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) {
          s[j][0] = expf(s[j][0] - mx0);
          s[j][1] = expf(s[j][1] - mx0);
          s[j][2] = expf(s[j][2] - mx8);
          s[j][3] = expf(s[j][3] - mx8);
          sum0 += s[j][0] + s[j][1];
          sum8 += s[j][2] + s[j][3];
        }
      }
    }
    const float inv0 = 1.f / quad_sum(sum0), inv8 = 1.f / quad_sum(sum8);
    // pass 3: p = e * inv; probs = bf16(p); out = sum_m bf16(p_m) v_m over the
    // patch keys (m >= 1) on the tensor cores + p_0 v_0 in fp32
    float o[2 * DK][4];
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int key0 = c * KC;
      if (!resident) {
        k1_load_kv<D>(seq, ldq, koff, voff, ks, vs, key0, min(KC, npad - key0), N, true);
        if (active) {
          k1_logits<DK, KT>(qa, ks, key0, N, scale, s, lane);
#pragma unroll
          for (int j = 0; j < 2 * KT; ++j) {
            s[j][0] = expf(s[j][0] - mx0);
            s[j][1] = expf(s[j][1] - mx0);
            s[j][2] = expf(s[j][2] - mx8);
            s[j][3] = expf(s[j][3] - mx8);
          }
        }
      }
      if (!active) continue;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        s[j][0] *= inv0;
        s[j][1] *= inv0;
        s[j][2] *= inv8;
        s[j][3] *= inv8;
      }
      if (pmap) {
        // stage the tile's rows so that each lies at its global address
        // modulo 16 bytes, then store them with 16-byte stores: one span of
        // whole rows when the chunk is the whole row, else row by row
        const int cols = min(KC, N - key0);
        const int sr = resident ? N : KC + 8;  // staging row stride
        const int a = resident ? static_cast<int>(
            (reinterpret_cast<uintptr_t>(pmap + (size_t)r0 * N) & 15u) >> 1) : 0;
        auto base = [&](int r) {
          return resident ? a + r * sr
                          : r * sr + static_cast<int>((reinterpret_cast<uintptr_t>(
                                pmap + (size_t)(r0 + r) * N + key0) & 15u) >> 1);
        };
        const unsigned sg = smem_addr(stage + base(g)), sg8 = smem_addr(stage + base(g + 8));
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) {
          const int kl = 8 * j + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (kl + e < cols) {
              if (row_g) st_shared_bf16(sg + 2 * (kl + e), s[j][e]);
              if (row_g8) st_shared_bf16(sg8 + 2 * (kl + e), s[j][2 + e]);
            }
          }
        }
        __syncwarp();
        const int rows = min(16, N - r0);
        if (resident) {
          k1_store_span(pmap + (size_t)r0 * N, stage + a, rows * N, lane);
        } else {
          for (int r = 0; r < rows; ++r)
            k1_store_span(pmap + (size_t)(r0 + r) * N + key0, stage + base(r), cols, lane);
        }
        __syncwarp();  // the staging buffer is rewritten for the next tile
      }
      if (key0 == 0) {  // the cls key: p_0 (fp32, held by lane t = 0 of the quad) x v_0
        const float p0 = __shfl_sync(kFull, s[0][0], lane & ~3);
        const float p8 = __shfl_sync(kFull, s[0][2], lane & ~3);
#pragma unroll
        for (int j = 0; j < 2 * DK; ++j) {
          const float2 v0 = __bfloat1622float2(
              *reinterpret_cast<const bf16x2*>(vs + 8 * j + 2 * t));
          o[j][0] = fmaf(p0, v0.x, o[j][0]);
          o[j][1] = fmaf(p0, v0.y, o[j][1]);
          o[j][2] = fmaf(p8, v0.x, o[j][2]);
          o[j][3] = fmaf(p8, v0.y, o[j][3]);
        }
      }
      // ldmatrix.trans rows: lanes 0-7 keys 0-7 at d 0, 8-15 keys 8-15 at d 0,
      // 16-23 keys 0-7 at d 8, 24-31 keys 8-15 at d 8 -> b0, b1 of two d tiles
      const unsigned vl = smem_addr(vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                    ((lane >> 4) << 3));
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (key0 + 16 * kk >= N) continue;
        // the accumulator tiles of keys 16kk..+7 and +8..+15 are the A
        // operand's two column halves
        uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        if (key0 == 0 && kk == 0 && t == 0) {  // key 0 went in above, in fp32
          pa[0] &= 0xffff0000u;
          pa[1] &= 0xffff0000u;
        }
#pragma unroll
        for (int d = 0; d < DK; ++d) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vl + (16 * kk * LD + 16 * d) * 2);
          mma_bf16(o[2 * d], pa, bv[0], bv[1]);
          mma_bf16(o[2 * d + 1], pa, bv[2], bv[3]);
        }
      }
    }
    if (active) {
      bf16* o0 = out + ((size_t)b * N + r0 + g) * C + h * D + 2 * t;
      bf16* o8 = o0 + 8 * (size_t)C;
#pragma unroll
      for (int j = 0; j < 2 * DK; ++j) {
        if (row_g)
          *reinterpret_cast<bf16x2*>(o0 + 8 * j) = __floats2bfloat162_rn(o[j][0], o[j][1]);
        if (row_g8)
          *reinterpret_cast<bf16x2*>(o8 + 8 * j) = __floats2bfloat162_rn(o[j][2], o[j][3]);
      }
    }
  }
}

template <int DK>
int launch_k1(const bf16* qkv, bf16* out, bf16* probs, int B, int N, int H, float scale,
              cudaStream_t stream) {
  constexpr int KT = k1_key_tiles(DK), D = 16 * DK, KC = 16 * KT;
  const int npad = (N + 15) & ~15, ntiles = npad / 16;
  const int nch = (npad + KC - 1) / KC;
  const bool resident = nch == 1;
  const int max_warps = resident ? kK1ResidentWarps : kK1MaxWarps;
  const int rounds = (ntiles + max_warps - 1) / max_warps;
  const int warps = (ntiles + rounds - 1) / rounds;  // the fewest warps for those rounds
  const int rows_kv = resident ? npad : KC;
  const int se = resident ? (16 * N + 8 + 7) & ~7 : 16 * (KC + 8);
  const size_t smem = (2 * (size_t)rows_kv * (D + 8) + (size_t)warps * se) * sizeof(bf16);
  auto kernel = resident ? attention_qkv_kernel<DK, KT, true>
                         : attention_qkv_kernel<DK, KT, false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), warps * 32, smem, stream>>>(qkv, out, probs, N, H, scale, nch, se);
  return static_cast<int>(cudaGetLastError());
}

// T1, T2 and K1's block-shape sweep: kHeads heads of `seqs` sequences per block
template <int kHeads, bool kNoMax>
__global__ void __launch_bounds__(kWarps * kHeads * 32)
attention_variant_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ldq, int ldk, int ldv,
                         bf16* __restrict__ out, bf16* __restrict__ probs, int B, int N,
                         int H, int D, float scale, int seqs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b0 = blockIdx.y * seqs;
  const int nseq = min(seqs, B - b0);
  attention_block<kWarps, kHeads, kNoMax>(q, k, v, ldq, ldk, ldv, out, probs, b0, nseq,
                                          blockIdx.x * kHeads, N, H, D, scale, smem);
}

template <int kHeads, bool kNoMax>
int launch_variant(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
                   void* out, void* probs, int B, int N, int H, int D, float scale,
                   int seqs, void* stream) {
  const size_t smem = attention_smem_bytes(N, D, kHeads, kWarps * kHeads);
  cudaError_t err = allow_dynamic_smem(attention_variant_kernel<kHeads, kNoMax>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H / kHeads, (B + seqs - 1) / seqs);
  attention_variant_kernel<kHeads, kNoMax><<<grid, kWarps * kHeads * 32, smem,
                                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      ldq, ldk, ldv, static_cast<bf16*>(out), static_cast<bf16*>(probs), B, N, H, D, scale,
      seqs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace editor_kernels

// K1: head dims 16, 32, ..., 128 (the wrapper refuses others), N <= kMaxTokens
extern "C" int editor_attention_qkv(const void* qkv, void* out, void* probs, int B,
                                    int N, int H, int D, float scale, void* stream) {
  using namespace editor_kernels;
  if (N < 1 || N > kMaxTokens) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  bf16* p = static_cast<bf16*>(probs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_k1<1>(q, o, p, B, N, H, scale, st);
    case 32: return launch_k1<2>(q, o, p, B, N, H, scale, st);
    case 48: return launch_k1<3>(q, o, p, B, N, H, scale, st);
    case 64: return launch_k1<4>(q, o, p, B, N, H, scale, st);
    case 80: return launch_k1<5>(q, o, p, B, N, H, scale, st);
    case 96: return launch_k1<6>(q, o, p, B, N, H, scale, st);
    case 112: return launch_k1<7>(q, o, p, B, N, H, scale, st);
    case 128: return launch_k1<8>(q, o, p, B, N, H, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// T1/T2: q, k, v with row strides ldq, ldk, ldv (elements); heads per block 1
// or 2 (H even for 2); seqs >= 1 sequences per block; nomax 0 or 1.
extern "C" int editor_attention_variant(const void* q, const void* k, const void* v,
                                        int ldq, int ldk, int ldv, void* out, void* probs,
                                        int B, int N, int H, int D, float scale,
                                        int heads, int seqs, int nomax, void* stream) {
  using namespace editor_kernels;
  if (seqs < 1 || (heads == 2 && H % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (heads == 1 && !nomax)
    return launch_variant<1, false>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                    seqs, stream);
  if (heads == 1 && nomax)
    return launch_variant<1, true>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                   seqs, stream);
  if (heads == 2 && !nomax)
    return launch_variant<2, false>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                    seqs, stream);
  if (heads == 2 && nomax)
    return launch_variant<2, true>(q, k, v, ldq, ldk, ldv, out, probs, B, N, H, D, scale,
                                   seqs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
