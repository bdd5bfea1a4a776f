// The tensor-core attention forward shared by K1 (csrc/attention_qkv.cu), K3
// and K6 (csrc/masked_attention.cu) and the design variants T1 and T2
// (csrc/attention_variants.cu): softmax(q k^T scale) v of one (head,
// sequence) pair from the raw qkv projection, every product on mma.sync
// m16n8k16 (bf16 in, fp32 sums). One compile-time switch, FwdForm, makes the
// five:
//  * kQkv (K1): p = e (1 / sum e) normalised before it is rounded; the probs
//    written when asked for; the cls key's p_0 kept in fp32 (p_0 v_0 added
//    with FMAs), every other p rounded to bf16 before p.v. Three passes over
//    the keys past one chunk (row max; exp sum; normalise, store, p.v).
//  * kFull (K3): the mask's fill added to a logit where mask_q * mask_k == 0
//    (as a per-key bias in shared memory: 0 for a valid key, `fill` for a
//    masked one, -inf past N); every exp rounded to bf16 before e.v, the
//    unrounded exps summed beside it, and the [16, D] accumulator scaled once
//    by mask_q / sum at the end (lazy normalisation); no probs and no fp32
//    key. Two passes past one chunk (row max; exp, sum and e.v), since the
//    final max must be known before any exp is rounded. A query row with mask
//    0 is written as exact zeros, and a warp whose 16 rows all have mask 0
//    does no products. The block takes `tpb` query tiles from blockIdx.z.
//  * kTiled (K6): kFull with the exp of every cls key (m % tile == 0, 0, 129
//    and 258 at the model's tile) kept in fp32: e_c v_c added with FMAs, as
//    K1 does for key 0, and the key's entry of the bf16 A operand cleared.
//  * kNoMax (T2): kQkv without the row max: no pass 1, the exps of the raw
//    logits (valid only while |logit| < ~80); given no probs. Two passes over
//    the keys past one chunk.
//  * kSplit (T1): kQkv with q, k and v read through three pointers, each
//    with its own row stride (FwdWalk): separate [B, N, C] tensors, or the
//    column views of a packed qkv with no copy.
// T1 and T2 walk `hps` heads of `seqs` sequences a block, one pair after
// another, each as K1's block does it (FwdWalk); T6's forward half and K6's
// group sweep walk `seqs` sequences a block through K3's and K6's forms
// (attention_fwd_mma_walk_kernel), so each pair's output is K3's or K6's.
//
// Contract (the plain versions: attention_qkv_tpu_plain,
// masked_attention_qkv_tpu_plain and masked_attention_tiled_plain,
// editor_tpu_torch/ops/): qkv [B, N, 3C] bf16, laid out [q_h0..q_hH | k_h0.. |
// v_h0..], C = H * D, 16-byte aligned; out [B, N, C] bf16, heads at columns
// h * D; K1: probs [B, H, N, N] bf16 (may be null); K3 and K6: mask [B, N]
// fp32 (1 = keep); K6: N a multiple of `cls_tile`. N <= kMaxTokens, D a multiple
// of 16 up to 128, one template instance per D. T1 and T2: the plain versions
// headgrid_attn_plain and nomax_attn_plain (editor_tpu_torch/tools/); T1's q,
// k and v with 16-byte aligned bases and row strides.
//
// Layout (attention_fwd_mma_kernel): one block per (head, sequence) (K3, K6:
// per query chunk of one too), each warp one 16-row query tile at a time. The
// head's k and v rows (128 contiguous bytes each at D = 64 in a 4608-byte qkv
// row) go to shared memory with 16-byte cp.async, rows padded by 16 bytes so
// that ldmatrix reads 8 rows in 8 distinct bank groups; keys past N are zero.
// q comes straight from global memory as the A operand; S = q k^T takes k
// through ldmatrix (k stored [key][d] is already the "col" operand). Up to
// 16 KT keys (144 at D <= 96, 80 above) a row's logits stay in registers and
// are made once (the resident instance, k and v staged once); past that the
// keys come in chunks of 16 KT and each pass makes a chunk's logits anew
// (the chunked instance). K1's chunked instance loads each chunk of k (and v)
// anew in each pass; K3's and K6's stage the head's k and v whole once when
// they fit in shared memory (`kvw`; 78 KB at N = 264, 115 KB at N = 387, D =
// 64) and chunk by chunk otherwise (N = 512 at D >= 112). Row max and sum
// reduce over the 4 lanes of a quad. The accumulator tiles of p (or e) are
// re-packed in registers as the A operand of p.v, with v through
// ldmatrix.trans. Padded keys are -inf before the max (exp gives 0, not NaN,
// at |logit| ~ 1e3); query rows past N are never stored.
//
// Included by the two sources that instantiate it; the kernels have internal
// linkage, each source its own.
#pragma once

#include "mma.cuh"

namespace editor_kernels {
namespace {

// The five instances of the body: K1 (no mask, probs, the cls key 0 in
// fp32), K3 (mask, every exp rounded), K6 (mask, a cls key every `cls_tile`
// tokens in fp32), T2 (K1 without the row max or probs), T1 (K1 from three
// row-strided pointers)
enum class FwdForm { kQkv, kFull, kTiled, kNoMax, kSplit };

// T1 and T2: the pairs a block walks, heads [blockIdx.x hps, + hps) of
// sequences [blockIdx.y seqs, + seqs) below B; T1's q, k and v and their row
// strides (elements). K1, K3 and K6 take one pair a block and ignore it; the
// walk kernel of K3's and K6's forms reads B and seqs.
struct FwdWalk {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int ldq, ldk, ldv;
  int B, hps, seqs;
};

// warps a block, K1's, K3's and K6's: 8 in the chunked instance were slower
// for K3 at N = 264 (PERF.md, findings)
constexpr int kK1MaxWarps = 4;
// K6's chunked instance where its k and v, staged whole, leave room for one
// block an SM (N = 387 at D = 64: 115 KB): 8 warps, so that the SM still has
// 8 (7 at N = 387: 0.68 ms against 0.97 with 4 at [128, 387]; where two
// blocks fit, as at N = 258, 4 stay faster: PERF.md, findings)
constexpr int kK6OneBlockWarps = 8;
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
// k's row m at seq + m ldq + koff; v's at seq + m ldq + voff, or with kSplit
// (T1) at vseq + m ldv + voff.
template <int D, bool kSplit>
__device__ __forceinline__ void k1_load_kv(const bf16* __restrict__ seq, int ldq, int koff,
                                           int voff, bf16* ks, bf16* vs, int key0, int rows,
                                           int N, bool with_v, const bf16* vseq, int ldv) {
  constexpr int LD = D + 8, SEG = D / 8;
  __syncthreads();  // every warp is done with the last chunk
  for (int i = threadIdx.x; i < rows * SEG; i += blockDim.x) {
    const int m = i / SEG, sg = i - m * SEG;
    bf16* kd = ks + m * LD + sg * 8;
    bf16* vd = vs + m * LD + sg * 8;
    if (key0 + m < N) {
      const bf16* src = seq + (size_t)(key0 + m) * ldq + sg * 8;
      cp_async16(kd, src + koff);
      if (with_v)
        cp_async16(vd, kSplit ? vseq + (size_t)(key0 + m) * ldv + sg * 8 + voff : src + voff);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
      if (with_v) *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// The scaled logits of one warp's 16 query rows against the chunk's keys
// [key0, key0 + 16 KT), whose k rows start at ks: s[j] is the accumulator
// tile of keys key0 + 8j..+7 (rows g, g + 8; keys 2t, 2t + 1). Keys >= N are
// -inf; kMasked adds the key bias kb[key] (indexed from key 0; -inf past N).
template <bool kMasked, int DK, int KT>
__device__ __forceinline__ void k1_logits(const uint32_t (&qa)[DK][4], const bf16* ks,
                                          int key0, int N, float scale,
                                          float (&s)[2 * KT][4], int lane,
                                          const float* kb = nullptr) {
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
    if constexpr (kMasked) {
      float2 b0 = make_float2(-INFINITY, -INFINITY), b8 = b0;
      if (live) {
        b0 = *reinterpret_cast<const float2*>(kb + key0 + 16 * kk + 2 * t);
        b8 = *reinterpret_cast<const float2*>(kb + key0 + 16 * kk + 8 + 2 * t);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[2 * kk][i] = c0[i] * scale + ((i & 1) ? b0.y : b0.x);
        s[2 * kk + 1][i] = c1[i] * scale + ((i & 1) ? b8.y : b8.x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + 16 * kk + 2 * t + (i & 1);
        s[2 * kk][i] = live && key < N ? c0[i] * scale : -INFINITY;
        s[2 * kk + 1][i] = live && key + 8 < N ? c1[i] * scale : -INFINITY;
      }
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

// The (head h, sequence b) pair of attention_fwd_mma_kernel's block (K3, K6:
// its chunk of `tpb` query tiles, blockIdx.z), `blockDim.x / 32` warps, each
// warp one 16-row query tile at a time. The keys come in chunks of 16 KT.
// kResident (N <= 16 KT): the head's k and v are loaded once and the logits
// are made once; at most 3 warps and a register budget that lets 4 blocks
// share an SM at D <= 64. Else (`nch` chunks, at most 4 warps; K6 8) each
// pass makes each chunk's logits anew; K1 loads each chunk of k (and v) for
// it, K3 and K6 too unless `kvw` (k and v staged whole once). `se`: bf16
// elements of each warp's probs staging buffer (K1, T1); `cls_tile`: tokens a
// tile, whose first is a cls key (K6).
template <FwdForm kForm, int DK, int KT, bool kResident>
__device__ __forceinline__ void attention_fwd_mma_pair(
    const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out,
    bf16* __restrict__ probs, int N, int H, float scale, float fill, int nch, int se, int tpb,
    int kvw, int cls_tile, FwdWalk walk, int h, int b) {
  constexpr bool kMasked = kForm == FwdForm::kFull || kForm == FwdForm::kTiled;
  constexpr bool kSplit = kForm == FwdForm::kSplit;
  constexpr int D = 16 * DK, LD = D + 8, KC = 16 * KT;
  if (kResident) nch = 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = H * D, ldq = kSplit ? walk.ldq : 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int npad = (N + 15) & ~15, ntiles = npad >> 4;
  constexpr bool resident = kResident;
  // k and v staged whole once (else a chunk at a time, in each pass)
  const bool whole = kMasked ? kResident || kvw != 0 : kResident;
  const int rows_kv = whole ? npad : KC;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + rows_kv * LD;
  bf16* stage = vs + rows_kv * LD + warp * se;
  // K3, K6: the key bias, npad floats after k and v
  float* kb = reinterpret_cast<float*>(vs + rows_kv * LD);
  // q's rows (seq, ldq); k's and v's: in the packed qkv at koff and voff, or
  // (T1) through their own pointers and strides
  const bf16* seq = (kSplit ? walk.q : qkv) + (size_t)b * N * ldq;
  const bf16* kseq = kSplit ? walk.k + (size_t)b * N * walk.ldk : seq;
  const bf16* vseq = kSplit ? walk.v + (size_t)b * N * walk.ldv : nullptr;
  const int ldk = kSplit ? walk.ldk : ldq;
  // T2 is given no probs, but its instances keep K1's store of them: without
  // that code ptxas schedules the resident one into spills, and slower
  // (PERF.md, findings)
  bf16* pmap = probs ? probs + ((size_t)b * H + h) * N * N : nullptr;
  const int koff = kSplit ? h * D : C + h * D, voff = kSplit ? h * D : 2 * C + h * D;
  int tbeg = 0, tend = ntiles;
  if constexpr (kMasked) {
    tbeg = blockIdx.z * tpb;
    tend = min(ntiles, tbeg + tpb);
    // published by the barriers of the first k1_load_kv
    for (int m = threadIdx.x; m < npad; m += blockDim.x)
      kb[m] = m < N ? (mask[(size_t)b * N + m] == 0.f ? fill : 0.f) : -INFINITY;
  }

  if (whole)
    k1_load_kv<D, kSplit>(kseq, ldk, koff, voff, ks, vs, 0, npad, N, true, vseq, walk.ldv);
  for (int r0w = tbeg; r0w < tend; r0w += nwarps) {  // the same trip count in every warp
    const int tile = r0w + warp;
    const bool in_range = tile < tend;  // warp-uniform
    const int r0 = tile * 16;
    const bool row_g = r0 + g < N, row_g8 = r0 + g + 8 < N;
    // K3, K6: the query mask of rows g and g + 8 (0 past N); a warp with no
    // valid row does no products and writes zeros
    float mq0 = 0.f, mq8 = 0.f;
    bool active = in_range;
    if constexpr (kMasked) {
      if (in_range && row_g) mq0 = mask[(size_t)b * N + r0 + g];
      if (in_range && row_g8) mq8 = mask[(size_t)b * N + r0 + g + 8];
      active = __any_sync(kFull, mq0 != 0.f || mq8 != 0.f);
    }
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
    float mx0 = -INFINITY, mx8 = -INFINITY;
    if constexpr (kForm == FwdForm::kNoMax) {
      // T2: no pass 1, exp(l - 0); the resident instance makes its logits
      // here, the chunked one in each of its two passes
      mx0 = mx8 = 0.f;
      if (resident && active) k1_logits<false, DK, KT>(qa, ks, 0, N, scale, s, lane);
    } else {
      // pass 1: the row max (rows g, g + 8)
      for (int c = 0; c < nch; ++c) {
        if (!whole)
          k1_load_kv<D, kSplit>(kseq, ldk, koff, voff, ks, vs, c * KC, min(KC, npad - c * KC),
                                N, false, vseq, walk.ldv);
        if (active) {
          k1_logits<kMasked, DK, KT>(qa, kMasked && whole ? ks + (size_t)c * KC * LD : ks,
                                     c * KC, N, scale, s, lane, kb);
#pragma unroll
          for (int j = 0; j < 2 * KT; ++j) {
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx8 = fmaxf(mx8, fmaxf(s[j][2], s[j][3]));
          }
        }
      }
      mx0 = quad_max(mx0);
      mx8 = quad_max(mx8);
    }
    // K1, pass 2: the exp sum (the max element gives exp(0) = 1, so sum >= 1;
    // a padded key's exp(-inf) is 0). K3 and K6 sum the exps in their last
    // pass.
    float sum0 = 0.f, sum8 = 0.f, inv0 = 0.f, inv8 = 0.f;
    if constexpr (!kMasked) {
      for (int c = 0; c < nch; ++c) {
        if (!resident) {
          k1_load_kv<D, kSplit>(kseq, ldk, koff, voff, ks, vs, c * KC, min(KC, npad - c * KC),
                                N, false, vseq, walk.ldv);
          if (active) k1_logits<kMasked, DK, KT>(qa, ks, c * KC, N, scale, s, lane);
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
      inv0 = 1.f / quad_sum(sum0);
      inv8 = 1.f / quad_sum(sum8);
    }
    // last pass. K1: p = e * inv; probs = bf16(p); out = sum_m bf16(p_m) v_m
    // over the patch keys (m >= 1) on the tensor cores + p_0 v_0 in fp32.
    // K3: e = exp(l - max), sum += e, out = sum_m bf16(e_m) v_m. K6: as K3
    // over the patch keys + e_c v_c in fp32 over the cls keys.
    float o[2 * DK][4];
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int key0 = c * KC;
      if constexpr (kMasked) {
        if (!whole)
          k1_load_kv<D, kSplit>(kseq, ldk, koff, voff, ks, vs, key0, min(KC, npad - key0), N,
                                true, vseq, walk.ldv);
        if (active) {
          if (!resident)
            k1_logits<kMasked, DK, KT>(qa, whole ? ks + (size_t)key0 * LD : ks, key0, N, scale,
                                       s, lane, kb);
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
      } else if (!resident) {
        k1_load_kv<D, kSplit>(kseq, ldk, koff, voff, ks, vs, key0, min(KC, npad - key0), N,
                              true, vseq, walk.ldv);
        if (active) {
          k1_logits<kMasked, DK, KT>(qa, ks, key0, N, scale, s, lane);
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
      if constexpr (!kMasked) {
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
      }
      if constexpr (kForm == FwdForm::kTiled) {
        // the chunk's cls keys m (a warp-uniform loop): e_m (fp32, held by
        // lane t = tc of the quad) times v_m with FMAs, and e_m's entry of
        // the accumulator tiles cleared so that the bf16 e.v below skips it
        const int kend = min(key0 + KC, N);
        for (int m = (key0 + cls_tile - 1) / cls_tile * cls_tile; m < kend; m += cls_tile) {
          const int kl = m - key0, jc = kl >> 3, tc = (kl & 7) >> 1, hi = kl & 1;
          float e0 = 0.f, e8 = 0.f;
#pragma unroll
          for (int j = 0; j < 2 * KT; ++j) {
            if (j == jc) {
              e0 = hi ? s[j][1] : s[j][0];
              e8 = hi ? s[j][3] : s[j][2];
              if (t == tc && hi) s[j][1] = s[j][3] = 0.f;
              if (t == tc && !hi) s[j][0] = s[j][2] = 0.f;
            }
          }
          e0 = __shfl_sync(kFull, e0, (lane & ~3) | tc);
          e8 = __shfl_sync(kFull, e8, (lane & ~3) | tc);
          // v's row m: in the head's whole v, or in the chunk's
          const bf16* vc = vs + (size_t)(whole ? m : kl) * LD + 2 * t;
#pragma unroll
          for (int j = 0; j < 2 * DK; ++j) {
            const float2 v0 = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(vc + 8 * j));
            o[j][0] = fmaf(e0, v0.x, o[j][0]);
            o[j][1] = fmaf(e0, v0.y, o[j][1]);
            o[j][2] = fmaf(e8, v0.x, o[j][2]);
            o[j][3] = fmaf(e8, v0.y, o[j][3]);
          }
        }
      }
      // ldmatrix.trans rows: lanes 0-7 keys 0-7 at d 0, 8-15 keys 8-15 at d 0,
      // 16-23 keys 0-7 at d 8, 24-31 keys 8-15 at d 8 -> b0, b1 of two d tiles
      const unsigned vl = smem_addr((kMasked && whole ? vs + (size_t)key0 * LD : vs) +
                                    ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
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
        if constexpr (!kMasked) {
          if (key0 == 0 && kk == 0 && t == 0) {  // key 0 went in above, in fp32
            pa[0] &= 0xffff0000u;
            pa[1] &= 0xffff0000u;
          }
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
    if constexpr (kMasked) {
      // out = bf16(o mask_q / sum e); rw is 0 in a row with mask 0 and in a
      // warp that did no products: exact zeros
      sum0 = quad_sum(sum0);
      sum8 = quad_sum(sum8);
      const float rw0 = mq0 != 0.f ? mq0 / sum0 : 0.f, rw8 = mq8 != 0.f ? mq8 / sum8 : 0.f;
      if (in_range) {
        bf16* o0 = out + ((size_t)b * N + r0 + g) * C + h * D + 2 * t;
        bf16* o8 = o0 + 8 * (size_t)C;
#pragma unroll
        for (int j = 0; j < 2 * DK; ++j) {
          if (row_g)
            *reinterpret_cast<bf16x2*>(o0 + 8 * j) = __floats2bfloat162_rn(
                rw0 != 0.f ? o[j][0] * rw0 : 0.f, rw0 != 0.f ? o[j][1] * rw0 : 0.f);
          if (row_g8)
            *reinterpret_cast<bf16x2*>(o8 + 8 * j) = __floats2bfloat162_rn(
                rw8 != 0.f ? o[j][2] * rw8 : 0.f, rw8 != 0.f ? o[j][3] * rw8 : 0.f);
        }
      }
    } else if (active) {
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

// One block per (head, sequence) pair: blockIdx.x, blockIdx.y (K3, K6: and
// per chunk of query tiles, blockIdx.z). T1 and T2 walk `walk.hps` heads of
// `walk.seqs` sequences a block, one pair after another (the staged k and v
// of a pair are rewritten after the barrier that opens the next one's load).
template <FwdForm kForm, int DK, int KT, bool kResident>
__global__ void __launch_bounds__(kResident                   ? kK1ResidentWarps * 32
                                  : kForm == FwdForm::kTiled ? kK6OneBlockWarps * 32
                                                              : kK1MaxWarps * 32,
                                  kResident ? k1_resident_blocks(DK) : 1)
attention_fwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                         bf16* __restrict__ out, bf16* __restrict__ probs, int N, int H,
                         float scale, float fill, int nch, int se, int tpb, int kvw,
                         int cls_tile, FwdWalk walk) {
  if constexpr (kForm == FwdForm::kNoMax || kForm == FwdForm::kSplit) {
    // T2 walks sequences only: with hps a constant 1, ptxas keeps its
    // resident instances at D = 32 and 48 free of spills
    const int hps = kForm == FwdForm::kNoMax ? 1 : walk.hps;
    for (int pair = 0; pair < hps * walk.seqs; ++pair) {
      const int b = blockIdx.y * walk.seqs + pair / hps;
      if (b >= walk.B) break;  // block-uniform
      attention_fwd_mma_pair<kForm, DK, KT, kResident>(
          qkv, mask, out, probs, N, H, scale, fill, nch, se, tpb, kvw, cls_tile, walk,
          blockIdx.x * hps + pair % hps, b);
    }
  } else {
    attention_fwd_mma_pair<kForm, DK, KT, kResident>(qkv, mask, out, probs, N, H, scale, fill,
                                                     nch, se, tpb, kvw, cls_tile, walk,
                                                     blockIdx.x, blockIdx.y);
  }
}

// T6's forward half and K6's group sweep: K3's and K6's block (head
// blockIdx.x, query chunk blockIdx.z) walking `walk.seqs` sequences from
// blockIdx.y seqs below walk.B, one after another, each as K3's or K6's own
// block does it. A kernel of its own, so that K3's and K6's instances keep
// their code. The barrier between pairs: every warp is done with the last
// pair's key bias, k and v before the next pair writes them.
template <FwdForm kForm, int DK, int KT, bool kResident>
__global__ void __launch_bounds__(kResident                   ? kK1ResidentWarps * 32
                                  : kForm == FwdForm::kTiled ? kK6OneBlockWarps * 32
                                                              : kK1MaxWarps * 32,
                                  kResident ? k1_resident_blocks(DK) : 1)
attention_fwd_mma_walk_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                              bf16* __restrict__ out, bf16* __restrict__ probs, int N, int H,
                              float scale, float fill, int nch, int se, int tpb, int kvw,
                              int cls_tile, FwdWalk walk) {
  static_assert(kForm == FwdForm::kFull || kForm == FwdForm::kTiled, "K3's and K6's forms");
  // the sequences [b0, b1): a loop of this form left every walk instance free
  // of spills, one counting pairs from 0 did not (PERF.md, findings)
  const int b0 = blockIdx.y * walk.seqs, b1 = min(walk.B, b0 + walk.seqs);
#pragma unroll 1
  for (int b = b0; b < b1; ++b) {
    if (b != b0) __syncthreads();
    attention_fwd_mma_pair<kForm, DK, KT, kResident>(qkv, mask, out, probs, N, H, scale, fill,
                                                     nch, se, tpb, kvw, cls_tile, walk,
                                                     blockIdx.x, b);
  }
}

}  // namespace
}  // namespace editor_kernels
