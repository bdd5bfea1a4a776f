// The tensor-core attention backward shared by K4 (csrc/attention_qkv_bwd.cu,
// the VJP of K1), K7 and K5 (csrc/masked_attention_bwd.cu, the VJPs of K6 and
// K3): for one (head, sequence) pair, d(softmax(l) v)/d(qkv) in the raw qkv
// layout, every product on mma.sync m16n8k16 (bf16 in, fp32 sums). One
// compile-time form, BwdForm, makes the three:
//  * kTiled (K7): reads the mask, adds the fill where mask_q * mask_k == 0,
//    and keeps a cls key every `tile` tokens (tile >= 16, so that a 16-key
//    tile holds at most one);
//  * kQkv (K4): reads no mask and adds no fill; one cls key, m = 0, which
//    sits in column 0 of key tile 0 at any N >= 1. Padded query rows >= N
//    count as masked (row < N in place of the mask);
//  * kFull (K5): the mask and the added fill of K7, and no cls key: every
//    key's attn and dl is rounded.
//
// Contract (the plain versions are masked_attention_tiled_bwd_plain,
// attention_qkv_bwd_plain and masked_attention_qkv_bwd_plain,
// editor_tpu_torch/ops/):
//   qkv [B, N, 3C] bf16, mask [B, N] fp32 (1 = keep; K7 and K5), g [B, N, C]
//   bf16 -> dqkv [B, N, 3C] bf16. pst, dlst: [B H, Np, Np] bf16 scratch,
//   Np = N rounded up to 16 (not used by the resident instances of K4 and
//   K5; bwd_scratch_side says which launch needs them).
// Rounding points of the TPU bodies (_qkv_masked_bwd_kernel for K7,
// _qkv_bwd_kernel for K4, _qkv_masked_full_bwd_kernel for K5; only the order
// of the fp32 sums differs): logits l = (q . k) scale (K7, K5: plus the
// fill); the fp32 row max, e = exp(l - max), inv = 1 / sum e, attn = e
// (mask_q inv); dat = g . v, r0 = (sum dat e) inv; dl = attn (dat - r0)
// scale. The patch keys' attn and dl are rounded to bf16 before dq = dl k,
// dk = dl^T q and dv = attn^T g; the cls keys (K7, K4) keep an fp32 attn and
// dl, and their products are fp32 sums; K5 has none. A query row with mask 0
// (or past N) gets exactly zero gradient; a masked key of a valid row gets
// attn = 0 exactly (exp underflow), hence zero dk and dv.
//
// What bounds it on the H100: 10 H N^2 D FLOP a sequence (the logits, dat,
// dq, dk, dv; K7 and K5 over the valid pairs) against qkv + g + dqkv = 14 N C
// bytes a sequence: at [384, 129, 2304] 0.53 GB, 0.16 ms at 3.35 TB/s,
// against 49 GFLOP (0.05 ms on the bf16 tensor cores): bytes. The global
// form also writes and reads back the [B H, Np, Np] scratch of the rounded
// attn and dl (0.76 GB each way at [384, 129]), which the bound does not
// count.
//
// Design (attention_bwd_mma_kernel): one block per (head, sequence), two
// passes; the body is attention_bwd_mma_pair, which T6's
// attention_bwd_mma_walk_kernel calls for g sequences a block in turn.
//  * Row pass: the head's k and v, all Np rows, go to shared memory ([Np,
//    D + 8] each, 16-byte cp.async, rows >= N zero). Each warp owns 16-row
//    query tiles; q and g come from global memory as A operands. S = q k^T and
//    dat = g v^T take k and v through ldmatrix. Up to 16 KT keys (144 at D
//    <= 96: N = 129) a row's logits stay in registers and are made once
//    (the resident instance); past that the three passes over the keys (row
//    max; exp sum and sum of dat e; attn, dl and dq) make each chunk's
//    logits anew (the chunked instance). dat is made twice. The rounded attn
//    and dl go to the scratch (bf16 pairs) and dl, re-packed as the A
//    operand, times k through ldmatrix.trans gives dq.
//  * The cls keys (K7, K4) fall anywhere in a 16-key tile (K7's key 129 is
//    column 1 of tile 8; K4's key 0 column 0 of tile 0): their entries are
//    zeroed in the scratch and in the packed A operand, their fp32 attn and
//    dl go to shared columns pc/dlc, dl_c k_c is added to dq with FMAs, and
//    their dk and dv are reduced at the end from the fp32 columns. No mma
//    result for a cls key is stored. K5 compiles none of this.
//  * Column pass: q and g replace k and v in shared memory. Each warp owns
//    16-key tiles and walks the query rows in 16-row steps: the scratch
//    tiles of attn and dl [16 rows, 16 keys] go through ldmatrix.trans as
//    the A operands of dv = attn^T g and dk = dl^T q, g and q through
//    ldmatrix.trans as B; dk and dv stay in registers. Query rows >= N and
//    masked rows hold zeros in the scratch (attn = 0 there), so the sums
//    need no masks.
//  * The scratch: global ([B H, Np, Np], read back through a 2-stage
//    cp.async ring of each warp's own) for K7 and the chunked instances; in
//    shared memory ([Np, Np + 8] each for attn and dl: 87.6 KB at N = 129,
//    one block of 9 warps an SM in place of 4 blocks of 3, and no scratch
//    traffic) for the resident instances of K4 and K5, faster than the
//    global form on the H100 by 10% for K4 at N = 129 and by 20% for K5 at
//    N = 88 (PERF.md section 6).
//  * The half-staged chunked instances (K4's, and K5's at D >= 96) stage
//    only k, then q, and read the B operands of v, then g, from global
//    memory (pairs of bf16, 0 past N): k and v of 512 rows at D = 128 would
//    take 272 KB of shared memory, k alone 136 KB, so every N up to
//    kMaxTokens fits at every head dim. K5's chunked instance at D <= 80
//    stages all four, as K7's does (184 KB at N = 512, D = 64).
// No atomics: every element of dqkv is written by one thread after sums in a
// fixed order, so two runs give the same bytes.
//
// Included by the two sources that instantiate it; the kernels have internal
// linkage, each source its own.
#pragma once

#include "mma.cuh"

namespace editor_kernels {
namespace {

// 16-key tiles whose logits stay in registers: the whole row up to 16 KT
// keys (9 at D <= 96, as K1), and chunks of 2 tiles past that
__host__ __device__ constexpr int bwd_key_tiles(int DK) { return DK <= 6 ? 9 : 5; }
constexpr int kBwdChunkTiles = 2;

// The three instances of the body: K4 (no mask, the cls key 0), K7 (mask, a
// cls key every `tile` tokens), K5 (mask, no cls key)
enum class BwdForm { kQkv, kTiled, kFull };
__host__ __device__ constexpr bool bwd_masked(BwdForm f) { return f != BwdForm::kQkv; }
__host__ __device__ constexpr bool bwd_cls(BwdForm f) { return f != BwdForm::kFull; }
// The forms K7 has neither of: the resident instances of K4 and K5 keep the
// scratch of the rounded attn and dl in shared memory (on chip); K4's
// chunked instance, and K5's past D = 80, stage k and q alone and read v and
// g from global memory
__host__ __device__ constexpr bool bwd_onchip(BwdForm f, bool resident) {
  return f != BwdForm::kTiled && resident;
}
__host__ __device__ constexpr bool bwd_half_staged(BwdForm f, int DK, bool resident) {
  return !resident && (f == BwdForm::kQkv || (f == BwdForm::kFull && DK > 5));
}

// warps per block at most: 3 with the logits of a whole row in registers (9
// tiles at N = 129, 3 rounds; 4 blocks an SM at D <= 64, 168 registers a
// thread), else 12 at D <= 64 (9 warps at N = 258, 264 and 387; 168
// registers: 16 warps capped them at 128, and the D = 64 instance spilled),
// 8 for the wide heads and for the half-staged instances (255 registers:
// their global B loads need more); the on-chip form: one warp per query
// tile, 9 at most up to D = 80 (ptxas budgets 9 warps as 12: 168
// registers), 8 above (255: at 168 K4's D = 96 instance spilled)
__host__ __device__ constexpr int bwd_max_warps(BwdForm f, int DK, bool resident) {
  return bwd_onchip(f, resident) ? (DK <= 5 ? 9 : 8)
         : resident              ? 3
         : bwd_masked(f) && DK <= 4 ? 12
                                    : 8;
}
__host__ __device__ constexpr int bwd_min_blocks(BwdForm f, int DK, bool resident) {
  return resident && DK <= 4 && !bwd_onchip(f, resident) ? 4 : 1;
}

// a column-pass stage: the attn and dl scratch tiles [16 rows, 16 keys], rows
// padded to 24 bf16 (48 bytes) so that ldmatrix reads 8 rows in distinct banks
constexpr int kStLd = 24;
constexpr int kStageElems = 2 * 16 * kStLd;

struct BwdMmaSmem {
  size_t buf, mk, cls, stage, total;
};

// The row stride of the on-chip scratch: Np + 8 bf16, so that ldmatrix reads
// 8 rows in distinct banks ((Np + 8) * 2 bytes is an odd multiple of 16)
__host__ __device__ inline int onchip_ld(int np) { return np + 8; }

// k then q [Np, D + 8]; v then g [Np, D + 8] (not in the half-staged
// instances); the mask [Np] fp32 (K7, K5); the fp32 attn and dl of each
// tile's cls key for every row [2, n_tiles, Np] (K7, K4); two stages a warp,
// or the on-chip scratch of attn and dl [2, Np, Np + 8] (the resident
// instances of K4 and K5)
template <BwdForm kForm, int DK, bool kResident>
__host__ __device__ inline BwdMmaSmem bwd_mma_smem_layout(int N, int n_tiles, int warps) {
  const size_t np = (N + 15) & ~15;
  BwdMmaSmem s;
  s.buf = np * (16 * DK + 8) * sizeof(bf16);
  s.mk = bwd_masked(kForm) ? np * sizeof(float) : 0;
  s.cls = 2 * (size_t)n_tiles * np * sizeof(float);
  s.stage = bwd_onchip(kForm, kResident) ? 2 * np * onchip_ld(np) * sizeof(bf16)
                                         : (size_t)warps * 2 * kStageElems * sizeof(bf16);
  s.total = (bwd_half_staged(kForm, DK, kResident) ? 1 : 2) * s.buf + s.mk + s.cls + s.stage;
  return s;
}

// The thread's index in the block. kWalk (the walk kernel): read anew at
// each use with a volatile move, so that the compiler cannot hoist what the
// pair derives from it out of the walk's loop and hold it across the pairs
// (K5's own block recomputes it at each use; held, the walk's D = 64
// chunked instance spilled 8 bytes at its 168 registers)
template <bool kWalk>
__device__ __forceinline__ unsigned bwd_thread() {
  if constexpr (kWalk) {
    unsigned t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
  } else {
    return threadIdx.x;
  }
}

// Rows [0, np) of one head's [N, D] slice (row stride ld, column offset off)
// into shared memory [np, D + 8] with 16-byte cp.async; rows >= N are zero
// (0 x NaN would not be 0). The caller waits for the copies.
template <int D, bool kWalk>
__device__ __forceinline__ void stage_head(const bf16* __restrict__ src, int ld, int off,
                                           bf16* dst, int np, int N) {
  constexpr int LD = D + 8, SEG = D / 8;
  for (int i = bwd_thread<kWalk>(); i < np * SEG; i += blockDim.x) {
    const int m = i / SEG, sg = i - m * SEG;
    bf16* d = dst + m * LD + sg * 8;
    if (m < N)
      cp_async16(d, src + (size_t)m * ld + off + sg * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The logits of one warp's 16 query rows against keys [key0, key0 + 16 KT):
// s[j] is the accumulator tile of keys key0 + 8j..+7 (rows g, g + 8; keys 2t,
// 2t + 1): (q . k) scale, plus (kMasked) the fill where mask_q * mask_k ==
// 0. Keys >= N are -inf; tiles at or past np are not read.
template <bool kMasked, int DK, int KT>
__device__ __forceinline__ void bwd_logits(const uint32_t (&qa)[DK][4], const bf16* ks,
                                           const float* mk, int key0, int N, int np,
                                           float scale, float fill, float mq0, float mq8,
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
    const bool live = key0 + 16 * kk < np;
    if (live) {
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        uint32_t b[4];
        ldmatrix_x4(b, kl + ((key0 + 16 * kk) * LD + 16 * d) * 2);
        mma_bf16(c0, qa[d], b[0], b[1]);
        mma_bf16(c1, qa[d], b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + 16 * kk + 2 * t + (i & 1);
      if constexpr (kMasked) {
        const float mq = i < 2 ? mq0 : mq8;
        s[2 * kk][i] = live && key < N
                           ? c0[i] * scale + (mq * mk[key] == 0.f ? fill : 0.f) : -INFINITY;
        s[2 * kk + 1][i] = live && key + 8 < N
                               ? c1[i] * scale + (mq * mk[key + 8] == 0.f ? fill : 0.f)
                               : -INFINITY;
      } else {
        s[2 * kk][i] = live && key < N ? c0[i] * scale : -INFINITY;
        s[2 * kk + 1][i] = live && key + 8 < N ? c1[i] * scale : -INFINITY;
      }
    }
  }
}

// dat = g . v^T of the 16 keys from `key`: c0 keys +0..7, c1 keys +8..15
template <int DK>
__device__ __forceinline__ void bwd_dat(const uint32_t (&ga)[DK][4], unsigned vl, int key,
                                        float (&c0)[4], float (&c1)[4]) {
  constexpr int LD = 16 * DK + 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) c0[i] = c1[i] = 0.f;
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    uint32_t b[4];
    ldmatrix_x4(b, vl + (key * LD + 16 * d) * 2);
    mma_bf16(c0, ga[d], b[0], b[1]);
    mma_bf16(c1, ga[d], b[2], b[3]);
  }
}

// bwd_dat with v's rows read from global memory (row stride ld): a lane's B
// fragments are the pairs at d 2t and 2t + 8 of keys key + g and key + g + 8,
// 0 for keys >= N (0 x NaN would not be 0)
template <int DK>
__device__ __forceinline__ void bwd_dat_global(const uint32_t (&ga)[DK][4],
                                               const bf16* __restrict__ v, int ld, int key,
                                               int N, float (&c0)[4], float (&c1)[4],
                                               int lane) {
  const int gr = lane >> 2, t = lane & 3;
  const bool in0 = key + gr < N, in8 = key + 8 + gr < N;
  const uint32_t* v0 = reinterpret_cast<const uint32_t*>(v + (size_t)(key + gr) * ld + 2 * t);
  const uint32_t* v8 = v0 + 4 * (size_t)ld;  // 8 rows on, in bf16 pairs
#pragma unroll
  for (int i = 0; i < 4; ++i) c0[i] = c1[i] = 0.f;
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    mma_bf16(c0, ga[d], in0 ? v0[8 * d] : 0u, in0 ? v0[8 * d + 4] : 0u);
    mma_bf16(c1, ga[d], in8 ? v8[8 * d] : 0u, in8 ? v8[8 * d + 4] : 0u);
  }
}

// Rows r and r + 1 of one column of a [N, ld] bf16 matrix in global memory,
// packed (row r in the low half; 0 past N): a B fragment of the column pass
// as ldmatrix.trans gives it from shared memory
__device__ __forceinline__ uint32_t bwd_column_pair(const bf16* __restrict__ col, int ld, int r,
                                                    int N) {
  const unsigned short* c = reinterpret_cast<const unsigned short*>(col);
  const uint32_t lo = r < N ? c[(size_t)r * ld] : 0u;
  const uint32_t hi = r + 1 < N ? c[(size_t)(r + 1) * ld] : 0u;
  return lo | hi << 16;
}

// The (head h, sequence b) pair of a block of `blockDim.x / 32` warps.
// kResident (Np <= 16 KT): a row's logits are made once and kept; else in
// chunks of KT key tiles, made anew in each pass. kForm: K7 (mask, fill, cls
// keys every `tile` tokens), K4 (one cls key at m = 0; mask, fill and tile
// unused) or K5 (mask, fill, no cls key; tile unused). The on-chip instances
// keep the attn and dl scratch in shared memory (pst and dlst unused), the
// half-staged ones read v and g from global memory; else pst and dlst are
// [B H, Np, Np], the pair's at b H + h. kWalk: called in the walk kernel's
// loop (bwd_thread).
template <BwdForm kForm, int DK, int KT, bool kResident, bool kWalk>
__device__ __forceinline__ void attention_bwd_mma_pair(
    const bf16* __restrict__ qkv, const float* __restrict__ mask, const bf16* __restrict__ g,
    bf16* __restrict__ dqkv, bf16* __restrict__ pst, bf16* __restrict__ dlst, int N, int H,
    float scale, float fill, int tile, int h, int b) {
  constexpr bool kMasked = bwd_masked(kForm), kCls = bwd_cls(kForm);
  constexpr bool kOnChip = bwd_onchip(kForm, kResident);
  constexpr bool kHalf = bwd_half_staged(kForm, DK, kResident);
  constexpr int kStaged = kHalf ? 1 : 2;  // [Np, D + 8] buffers in shared memory
  constexpr int D = 16 * DK, LD = D + 8, KC = 16 * KT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = H * D, ldq = 3 * C;
  const int warp = bwd_thread<kWalk>() >> 5, lane = bwd_thread<kWalk>() & 31;
  const int nwarps = blockDim.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int np = (N + 15) & ~15, ntiles = np >> 4;
  const int n_tiles = kForm == BwdForm::kTiled ? N / tile : kCls ? 1 : 0;
  const int nch = kResident ? 1 : (np + KC - 1) / KC;
  const BwdMmaSmem lay = bwd_mma_smem_layout<kForm, DK, kResident>(N, n_tiles, nwarps);
  bf16* buf0 = reinterpret_cast<bf16*>(smem);            // k, then q
  bf16* buf1 = reinterpret_cast<bf16*>(smem + lay.buf);  // v, then g (not kHalf)
  float* mk = reinterpret_cast<float*>(smem + kStaged * lay.buf);
  // fp32 attn and dl of tile tt's cls key for every row n: pc[tt * np + n]
  float* pc = reinterpret_cast<float*>(smem + kStaged * lay.buf + lay.mk);
  float* dlc = pc + (size_t)n_tiles * np;
  bf16* stage = reinterpret_cast<bf16*>(smem + kStaged * lay.buf + lay.mk + lay.cls) +
                warp * 2 * kStageElems;

  const bf16* seq = qkv + (size_t)b * N * ldq;
  const bf16* gseq = g + (size_t)b * N * C;
  bf16* dseq = dqkv + (size_t)b * N * ldq;
  const size_t bh = (size_t)b * H + h;
  // the scratch rows: global [Np, Np] of this (b, h), or on chip [Np, Np + 8]
  const int sld = kOnChip ? onchip_ld(np) : np;
  bf16* P = kOnChip ? reinterpret_cast<bf16*>(smem + kStaged * lay.buf + lay.mk + lay.cls)
                    : pst + bh * np * np;
  bf16* DL = kOnChip ? P + (size_t)np * sld : dlst + bh * np * np;

  // ---- row pass: attn, dl and dq of every query tile ---------------------
  stage_head<D, kWalk>(seq, ldq, C + h * D, buf0, np, N);
  if constexpr (!kHalf) stage_head<D, kWalk>(seq, ldq, 2 * C + h * D, buf1, np, N);
  if constexpr (kMasked) {
    for (int m = bwd_thread<kWalk>(); m < np; m += blockDim.x)
      mk[m] = m < N ? mask[(size_t)b * N + m] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int qt = warp; qt < ntiles; qt += nwarps) {
    const int rg = qt * 16 + gr, rg8 = rg + 8;  // both < np
    // the query rows' mask: 0 past N
    const float mq0 = kMasked ? mk[rg] : (rg < N ? 1.f : 0.f);
    const float mq8 = kMasked ? mk[rg8] : (rg8 < N ? 1.f : 0.f);
    // q and g as A operands, straight from global memory (rows >= N are 0)
    uint32_t qa[DK][4], ga[DK][4];
    {
      const bool in0 = rg < N, in8 = rg8 < N;
      const bf16* q0 = seq + (size_t)rg * ldq + h * D + 2 * t;
      const bf16* q8 = q0 + 8 * (size_t)ldq;
      const bf16* g0 = gseq + (size_t)rg * C + h * D + 2 * t;
      const bf16* g8 = g0 + 8 * (size_t)C;
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        qa[d][0] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + 16 * d) : 0u;
        qa[d][1] = in8 ? *reinterpret_cast<const uint32_t*>(q8 + 16 * d) : 0u;
        qa[d][2] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + 16 * d + 8) : 0u;
        qa[d][3] = in8 ? *reinterpret_cast<const uint32_t*>(q8 + 16 * d + 8) : 0u;
        ga[d][0] = in0 ? *reinterpret_cast<const uint32_t*>(g0 + 16 * d) : 0u;
        ga[d][1] = in8 ? *reinterpret_cast<const uint32_t*>(g8 + 16 * d) : 0u;
        ga[d][2] = in0 ? *reinterpret_cast<const uint32_t*>(g0 + 16 * d + 8) : 0u;
        ga[d][3] = in8 ? *reinterpret_cast<const uint32_t*>(g8 + 16 * d + 8) : 0u;
      }
    }
    // v as the B operand of dat (as k of the logits); k as the B operand of
    // dq through ldmatrix.trans: lanes 0-7 keys 0-7 at d 0, 8-15 keys 8-15
    // at d 0, 16-23 keys 0-7 at d 8, 24-31 keys 8-15 at d 8
    const unsigned vl = smem_addr(buf1 + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                                  (((lane >> 3) & 1) << 3));
    float s[2 * KT][4];
    // pass 1: the row max (rows g, g + 8)
    float mx0 = -INFINITY, mx8 = -INFINITY;
    for (int c = 0; c < nch; ++c) {
      bwd_logits<kMasked, DK, KT>(qa, buf0, mk, c * KC, N, np, scale, fill, mq0, mq8, s, lane);
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx8 = fmaxf(mx8, fmaxf(s[j][2], s[j][3]));
      }
    }
    mx0 = quad_max(mx0);
    mx8 = quad_max(mx8);
    // pass 2: the exp sum and sum dat e (the max element gives exp(0) = 1,
    // so sum >= 1; a padded key's exp(-inf) is 0)
    float sum0 = 0.f, sum8 = 0.f, ra0 = 0.f, ra8 = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int key0 = c * KC;
      if (!kResident)
        bwd_logits<kMasked, DK, KT>(qa, buf0, mk, key0, N, np, scale, fill, mq0, mq8, s,
                                    lane);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (key0 + 16 * kk >= np) continue;
        float c0[4], c1[4];
        if constexpr (kHalf)
          bwd_dat_global<DK>(ga, seq + 2 * C + h * D, ldq, key0 + 16 * kk, N, c0, c1, lane);
        else
          bwd_dat<DK>(ga, vl, key0 + 16 * kk, c0, c1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mx = i < 2 ? mx0 : mx8;
          const float e0 = expf(s[2 * kk][i] - mx), e1 = expf(s[2 * kk + 1][i] - mx);
          s[2 * kk][i] = e0;
          s[2 * kk + 1][i] = e1;
          if (i < 2) {
            sum0 += e0 + e1;
            ra0 = fmaf(c0[i], e0, fmaf(c1[i], e1, ra0));
          } else {
            sum8 += e0 + e1;
            ra8 = fmaf(c0[i], e0, fmaf(c1[i], e1, ra8));
          }
        }
      }
    }
    const float inv0 = 1.f / quad_sum(sum0), inv8 = 1.f / quad_sum(sum8);
    const float r00 = quad_sum(ra0) * inv0, r08 = quad_sum(ra8) * inv8;
    const float rw0 = mq0 * inv0, rw8 = mq8 * inv8;  // attn = e rw
    // pass 3: attn and dl; the scratch; dq = dl . k
    float dq[2 * DK][4];
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    const unsigned kt = smem_addr(buf0 + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                  ((lane >> 4) << 3));
    for (int c = 0; c < nch; ++c) {
      const int key0 = c * KC;
      if (!kResident) {
        bwd_logits<kMasked, DK, KT>(qa, buf0, mk, key0, N, np, scale, fill, mq0, mq8, s,
                                    lane);
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) {
          s[j][0] = expf(s[j][0] - mx0);
          s[j][1] = expf(s[j][1] - mx0);
          s[j][2] = expf(s[j][2] - mx8);
          s[j][3] = expf(s[j][3] - mx8);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const int kb = key0 + 16 * kk;
        if (kb >= np) continue;
        float dat[2][4];
        if constexpr (kHalf)
          bwd_dat_global<DK>(ga, seq + 2 * C + h * D, ldq, kb, N, dat[0], dat[1], lane);
        else
          bwd_dat<DK>(ga, vl, kb, dat[0], dat[1]);
        // this key tile's cls key, as a column 0-15 (-1 without one; one at
        // most: K7's tile >= 16, K4's only cls key is key 0, K5 has none)
        int cc = -1;
        if constexpr (kForm == BwdForm::kTiled) {
          const int first = (kb + tile - 1) / tile * tile;
          cc = first < N && first - kb < 16 ? first - kb : -1;
        } else if constexpr (kForm == BwdForm::kQkv) {
          cc = kb == 0 ? 0 : -1;
        }
        float a[2][4], l[2][4];
        float ac0 = 0.f, lc0 = 0.f, ac8 = 0.f, lc8 = 0.f;  // the cls key's, fp32
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float at = s[2 * kk + hh][i] * (i < 2 ? rw0 : rw8);
            const float dl = at * (dat[hh][i] - (i < 2 ? r00 : r08)) * scale;
            if (kCls && 8 * hh + 2 * t + (i & 1) == cc) {  // out of the bf16 products
              if (i < 2) {
                ac0 = at;
                lc0 = dl;
              } else {
                ac8 = at;
                lc8 = dl;
              }
              a[hh][i] = l[hh][i] = 0.f;
            } else {
              a[hh][i] = at;
              l[hh][i] = dl;
            }
          }
        }
        // the accumulator tiles of keys kb..+7 and +8..+15 as the A operand's
        // two column halves; the same pairs go to the scratch rows rg, rg8
        const uint32_t pa[4] = {pack_bf16(a[0][0], a[0][1]), pack_bf16(a[0][2], a[0][3]),
                                pack_bf16(a[1][0], a[1][1]), pack_bf16(a[1][2], a[1][3])};
        const uint32_t la[4] = {pack_bf16(l[0][0], l[0][1]), pack_bf16(l[0][2], l[0][3]),
                                pack_bf16(l[1][0], l[1][1]), pack_bf16(l[1][2], l[1][3])};
        uint32_t* p0 = reinterpret_cast<uint32_t*>(P + (size_t)rg * sld + kb + 2 * t);
        uint32_t* p8 = reinterpret_cast<uint32_t*>(P + (size_t)rg8 * sld + kb + 2 * t);
        uint32_t* l0 = reinterpret_cast<uint32_t*>(DL + (size_t)rg * sld + kb + 2 * t);
        uint32_t* l8 = reinterpret_cast<uint32_t*>(DL + (size_t)rg8 * sld + kb + 2 * t);
        p0[0] = pa[0];
        p0[4] = pa[2];
        p8[0] = pa[1];
        p8[4] = pa[3];
        l0[0] = la[0];
        l0[4] = la[2];
        l8[0] = la[1];
        l8[4] = la[3];
#pragma unroll
        for (int d = 0; d < DK; ++d) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, kt + (kb * LD + 16 * d) * 2);
          mma_bf16(dq[2 * d], la, bk[0], bk[1]);
          mma_bf16(dq[2 * d + 1], la, bk[2], bk[3]);
        }
        if (kCls && cc >= 0) {  // warp-uniform: the fp32 columns and dl_c k_c
          const int tc = (cc & 7) >> 1;  // the quad lane that holds the key
          const int tt = kForm == BwdForm::kTiled ? (kb + cc) / tile : 0;
          if (t == tc) {
            pc[tt * np + rg] = ac0;
            dlc[tt * np + rg] = lc0;
            pc[tt * np + rg8] = ac8;
            dlc[tt * np + rg8] = lc8;
          }
          const float d0 = __shfl_sync(kFull, lc0, (lane & ~3) | tc);
          const float d8 = __shfl_sync(kFull, lc8, (lane & ~3) | tc);
          const bf16* kc = buf0 + (kb + cc) * LD + 2 * t;
#pragma unroll
          for (int j = 0; j < 2 * DK; ++j) {
            const float2 kf = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(kc + 8 * j));
            dq[j][0] = fmaf(d0, kf.x, dq[j][0]);
            dq[j][1] = fmaf(d0, kf.y, dq[j][1]);
            dq[j][2] = fmaf(d8, kf.x, dq[j][2]);
            dq[j][3] = fmaf(d8, kf.y, dq[j][3]);
          }
        }
      }
    }
    bf16* o0 = dseq + (size_t)rg * ldq + h * D + 2 * t;
    bf16* o8 = o0 + 8 * (size_t)ldq;
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) {
      if (rg < N)
        *reinterpret_cast<bf16x2*>(o0 + 8 * j) = __floats2bfloat162_rn(dq[j][0], dq[j][1]);
      if (rg8 < N)
        *reinterpret_cast<bf16x2*>(o8 + 8 * j) = __floats2bfloat162_rn(dq[j][2], dq[j][3]);
    }
  }
  __syncthreads();  // the scratch and the cls columns written; k, v done

  // ---- column pass: dk = dl^T q, dv = attn^T g -----------------------------
  stage_head<D, kWalk>(seq, ldq, h * D, buf0, np, N);
  if constexpr (!kHalf) stage_head<D, kWalk>(gseq, C, h * D, buf1, np, N);
  cp_async_wait_all();
  __syncthreads();

  // the cls keys from their fp32 attn and dl (rows >= N and masked rows hold
  // 0 there); nothing else writes these rows' k and v columns
  if constexpr (kCls) {
    for (int i = bwd_thread<kWalk>(); i < n_tiles * (D / 2); i += blockDim.x) {
      const int tt = i / (D / 2), d2 = i - tt * (D / 2);
      const float* pt = pc + tt * np;
      const float* lt = dlc + tt * np;
      float v0 = 0.f, v1 = 0.f, k0 = 0.f, k1 = 0.f;
      for (int n = 0; n < (kHalf ? N : np); ++n) {
        const float2 qf =
            __bfloat1622float2(reinterpret_cast<const bf16x2*>(buf0 + n * LD)[d2]);
        const bf16* gn = kHalf ? gseq + (size_t)n * C + h * D : buf1 + n * LD;
        const float2 gf = __bfloat1622float2(reinterpret_cast<const bf16x2*>(gn)[d2]);
        v0 = fmaf(pt[n], gf.x, v0);
        v1 = fmaf(pt[n], gf.y, v1);
        k0 = fmaf(lt[n], qf.x, k0);
        k1 = fmaf(lt[n], qf.y, k1);
      }
      bf16* row = dseq + (size_t)tt * (kMasked ? tile : 0) * ldq + h * D;
      reinterpret_cast<bf16x2*>(row + C)[d2] = __floats2bfloat162_rn(k0, k1);
      reinterpret_cast<bf16x2*>(row + 2 * C)[d2] = __floats2bfloat162_rn(v0, v1);
    }
  }

  for (int mt = warp; mt < ntiles; mt += nwarps) {
    const int m0 = mt * 16;
    // one stage: rows [16 ks, +16) of the attn and dl scratch at keys
    // [m0, m0 + 16), two 16-byte pieces a row, one piece a lane and tensor
    auto fetch = [&](int ks) {
      bf16* sp = stage + (ks & 1) * kStageElems;
      const int r = lane >> 1, seg = lane & 1;
      const size_t src = (size_t)(16 * ks + r) * np + m0 + seg * 8;
      cp_async16(sp + r * kStLd + seg * 8, P + src);
      cp_async16(sp + (16 + r) * kStLd + seg * 8, DL + src);
      cp_async_commit();
    };
    float dk[2 * DK][4], dv[2 * DK][4];
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) {
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    if (!kOnChip) fetch(0);
    for (int ks = 0; ks < ntiles; ++ks) {
      // ldmatrix.trans rows (the A operand attn^T from attn [rows][keys]):
      // lanes 0-7 rows 0-7 at key 0, 8-15 rows 0-7 at key 8, 16-23 rows 8-15
      // at key 0, 24-31 rows 8-15 at key 8
      uint32_t pa[4], la[4];
      if constexpr (kOnChip) {  // straight from the scratch rows
        const int off = (16 * ks + (lane & 7) + ((lane >> 4) << 3)) * sld + m0 +
                        (((lane >> 3) & 1) << 3);
        ldmatrix_x4_trans(pa, smem_addr(P + off));
        ldmatrix_x4_trans(la, smem_addr(DL + off));
      } else {  // through the warp's stage
        if (ks + 1 < ntiles) {
          fetch(ks + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();  // every lane's pieces of stage ks have landed
        const bf16* sp = stage + (ks & 1) * kStageElems;
        const unsigned al = smem_addr(sp + ((lane & 7) + ((lane >> 4) << 3)) * kStLd +
                                      (((lane >> 3) & 1) << 3));
        ldmatrix_x4_trans(pa, al);
        ldmatrix_x4_trans(la, al + 16 * kStLd * 2);
      }
      // g and q [rows][d] through ldmatrix.trans as B, as k in the row pass
      const int rrow = 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3);
      const unsigned ql = smem_addr(buf0 + rrow * LD + ((lane >> 4) << 3));
      const unsigned gl = smem_addr(buf1 + rrow * LD + ((lane >> 4) << 3));
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        uint32_t bg[4], bq[4];
        if constexpr (kHalf) {  // what ldmatrix.trans gives, from global memory
          const bf16* gc = gseq + h * D + 16 * d + gr;
          bg[0] = bwd_column_pair(gc, C, 16 * ks + 2 * t, N);
          bg[1] = bwd_column_pair(gc, C, 16 * ks + 2 * t + 8, N);
          bg[2] = bwd_column_pair(gc + 8, C, 16 * ks + 2 * t, N);
          bg[3] = bwd_column_pair(gc + 8, C, 16 * ks + 2 * t + 8, N);
        } else {
          ldmatrix_x4_trans(bg, gl + 16 * d * 2);
        }
        mma_bf16(dv[2 * d], pa, bg[0], bg[1]);
        mma_bf16(dv[2 * d + 1], pa, bg[2], bg[3]);
        ldmatrix_x4_trans(bq, ql + 16 * d * 2);
        mma_bf16(dk[2 * d], la, bq[0], bq[1]);
        mma_bf16(dk[2 * d + 1], la, bq[2], bq[3]);
      }
      if (!kOnChip) __syncwarp();  // the stage is refilled two steps on
    }
    // keys m0 + g (c0, c1) and m0 + g + 8 (c2, c3); not past N, not a cls key
    const int ma = m0 + gr, mb = ma + 8;
    bf16* ra = dseq + (size_t)ma * ldq + h * D + 2 * t;
    bf16* rb = ra + 8 * (size_t)ldq;
    const bool oka = ma < N && (kForm == BwdForm::kTiled ? ma % tile != 0
                                : kForm == BwdForm::kQkv ? ma != 0
                                                         : true);
    const bool okb = mb < N && (kForm == BwdForm::kTiled ? mb % tile != 0
                                : kForm == BwdForm::kQkv ? mb != 0
                                                         : true);
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) {
      if (oka) {
        *reinterpret_cast<bf16x2*>(ra + C + 8 * j) = __floats2bfloat162_rn(dk[j][0], dk[j][1]);
        *reinterpret_cast<bf16x2*>(ra + 2 * C + 8 * j) =
            __floats2bfloat162_rn(dv[j][0], dv[j][1]);
      }
      if (okb) {
        *reinterpret_cast<bf16x2*>(rb + C + 8 * j) = __floats2bfloat162_rn(dk[j][2], dk[j][3]);
        *reinterpret_cast<bf16x2*>(rb + 2 * C + 8 * j) =
            __floats2bfloat162_rn(dv[j][2], dv[j][3]);
      }
    }
  }
}

// One block per (head, sequence): blockIdx.x, blockIdx.y
template <BwdForm kForm, int DK, int KT, bool kResident>
__global__ void __launch_bounds__(bwd_max_warps(kForm, DK, kResident) * 32,
                                  bwd_min_blocks(kForm, DK, kResident))
attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                         const bf16* __restrict__ g, bf16* __restrict__ dqkv,
                         bf16* __restrict__ pst, bf16* __restrict__ dlst, int N, int H,
                         float scale, float fill, int tile) {
  attention_bwd_mma_pair<kForm, DK, KT, kResident, false>(qkv, mask, g, dqkv, pst, dlst, N, H,
                                                          scale, fill, tile, blockIdx.x,
                                                          blockIdx.y);
}

// T6's backward half: K5's block (head blockIdx.x) walking `seqs` sequences
// from blockIdx.y seqs below B, one after another, each as K5's own block
// does it. A kernel of its own, so that K4's, K5's and K7's instances keep
// their code. The barrier between pairs: every warp is done with the last
// pair's staged q and g, mask, on-chip scratch and column stages before the
// next pair writes them.
template <BwdForm kForm, int DK, int KT, bool kResident>
__global__ void __launch_bounds__(bwd_max_warps(kForm, DK, kResident) * 32,
                                  bwd_min_blocks(kForm, DK, kResident))
attention_bwd_mma_walk_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                              const bf16* __restrict__ g, bf16* __restrict__ dqkv,
                              bf16* __restrict__ pst, bf16* __restrict__ dlst, int N, int H,
                              float scale, float fill, int tile, int B, int seqs) {
  static_assert(kForm == BwdForm::kFull, "K5's form");
  const int b0 = blockIdx.y * seqs, b1 = min(B, b0 + seqs);  // as the forward's walk
#pragma unroll 1
  for (int b = b0; b < b1; ++b) {
    if (b != b0) __syncthreads();
    attention_bwd_mma_pair<kForm, DK, KT, kResident, true>(qkv, mask, g, dqkv, pst, dlst, N, H,
                                                           scale, fill, tile, blockIdx.x, b);
  }
}

// Launch K7 (`tile` tokens per tile), K4 (one cls key) or K5 (no cls key)
// with the fewest warps for the rounds the block's query tiles need; K5 with
// `group` g >= 1 (T6) walks g sequences a block, grid (H, ceil(B / g))
template <BwdForm kForm, int DK>
int launch_attention_bwd_mma(const bf16* qkv, const float* mask, const bf16* g, bf16* dqkv,
                             bf16* pst, bf16* dlst, int B, int N, int H, float scale,
                             float fill, int tile, int group, cudaStream_t stream) {
  constexpr int KT = bwd_key_tiles(DK);
  const int np = (N + 15) & ~15, ntiles = np / 16;
  const bool resident = np <= 16 * KT;
  if (!bwd_onchip(kForm, resident) && (!pst || !dlst))
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_warps = bwd_max_warps(kForm, DK, resident);
  const int rounds = (ntiles + max_warps - 1) / max_warps;
  const int warps = (ntiles + rounds - 1) / rounds;  // the fewest warps for those rounds
  const int n_tiles = kForm == BwdForm::kTiled ? N / tile : bwd_cls(kForm) ? 1 : 0;
  const size_t smem = resident ? bwd_mma_smem_layout<kForm, DK, true>(N, n_tiles, warps).total
                               : bwd_mma_smem_layout<kForm, DK, false>(N, n_tiles, warps).total;
  if constexpr (kForm == BwdForm::kFull) {
    if (group > 0) {
      auto walk = resident ? attention_bwd_mma_walk_kernel<kForm, DK, KT, true>
                           : attention_bwd_mma_walk_kernel<kForm, DK, kBwdChunkTiles, false>;
      cudaError_t err = allow_dynamic_smem(walk, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      walk<<<dim3(H, (B + group - 1) / group), warps * 32, smem, stream>>>(
          qkv, mask, g, dqkv, pst, dlst, N, H, scale, fill, tile, B, group);
      return static_cast<int>(cudaGetLastError());
    }
  }
  auto kernel = resident ? attention_bwd_mma_kernel<kForm, DK, KT, true>
                         : attention_bwd_mma_kernel<kForm, DK, kBwdChunkTiles, false>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), warps * 32, smem, stream>>>(qkv, mask, g, dqkv, pst, dlst, N, H, scale,
                                                   fill, tile);
  return static_cast<int>(cudaGetLastError());
}

// The head-dim switch of the C entry points: D = 16, 32, ..., 128
template <BwdForm kForm>
int launch_attention_bwd_mma_d(const void* qkv, const void* mask, const void* g, void* dqkv,
                               void* pst, void* dlst, int B, int N, int H, int D, float scale,
                               float fill, int tile, int group, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* d = static_cast<bf16*>(dqkv);
  bf16* p = static_cast<bf16*>(pst);
  bf16* l = static_cast<bf16*>(dlst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_attention_bwd_mma<kForm, 1>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    case 32:
      return launch_attention_bwd_mma<kForm, 2>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    case 48:
      return launch_attention_bwd_mma<kForm, 3>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    case 64:
      return launch_attention_bwd_mma<kForm, 4>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    case 80:
      return launch_attention_bwd_mma<kForm, 5>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    case 96:
      return launch_attention_bwd_mma<kForm, 6>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    case 112:
      return launch_attention_bwd_mma<kForm, 7>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    case 128:
      return launch_attention_bwd_mma<kForm, 8>(q, m, gp, d, p, l, B, N, H, scale, fill, tile,
                                                group, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The side Np of the two [B H, Np, Np] scratch maps that a launch of form
// kForm for N tokens at head dim D needs: N rounded up to 16, 0 where the
// instance keeps its scratch on chip; -1 for a shape no instance takes
template <BwdForm kForm>
int bwd_scratch_side(int N, int D) {
  if (N < 1 || N > kMaxTokens || D < 16 || D > 128 || D % 16) return -1;
  const int side = (N + 15) & ~15;
  return bwd_onchip(kForm, side <= 16 * bwd_key_tiles(D / 16)) ? 0 : side;
}

}  // namespace
}  // namespace editor_kernels
