// The tensor-core GEMM body of K8 (csrc/ln_matmul.cu) and of T3's two
// products (csrc/attn_layer.cu): for the rows of one chunk,
//   out[r, o] = bf16(epi(sum_k A[r, k] W[k, o] + bias[o]))
// with fp32 sums, where
//  * A is bf16(LN(x)) (kLN: fp32 mean and biased variance of each row, y =
//    (x - mean) rsqrt(var + eps) gamma + beta rounded to bf16 once, as the TPU
//    kernels do: editor_tpu/ops/fused_linear.py:56-60,
//    tools/bench_attn_layer.py:36-41), or a plain bf16 input;
//  * W is [K, O] row-major (WLayout::kKO: T3's wqkv and wp, y = x . w) or
//    [O, K] (kOK: K8's torch Linear weight);
//  * epi adds the bias in fp32, then (kGelu) the erf-GELU with erff, then
//    rounds once to bf16; bias and the LayerNorm's gamma and beta are fp32
//    (K8) or bf16 (T3), read as fp32.
//
// Layout. A block of WM x WN warps owns a chunk of BM = 16 MT WM rows and
// walks the output columns in tiles of BN = 8 NT WN; each warp holds an
// (16 MT) x (8 NT) tile of fp32 accumulators in registers (mma.sync
// m16n8k16, bf16 in, fp32 sums). With the LayerNorm, a pre-pass normalises
// the chunk's rows (a warp a row, fp32 statistics from the row held in
// registers) into a global scratch that the block alone writes and reads
// back; its rows stay in L2 for the products. A and the weight stream
// together through a ring of STAGES shared-memory slices (BM x BK of A, BK x
// BN of W), filled with 16-byte cp.async STAGES - 1 slices ahead of the
// products: the loads of slice s + STAGES - 1 (also across column tiles)
// overlap the products of slice s, one barrier a slice. The A fragments
// come through ldmatrix, the weight's through ldmatrix (kOK: the rows are
// output columns, the "col" operand as stored) or ldmatrix.trans (kKO),
// each 16-row tile's A fragment loaded before the products of the tile
// before. Every shared tile is XOR-swizzled in 16-byte chunks (swz), so the
// 8 rows of an ldmatrix 8x8 matrix fall in 8 distinct bank groups without
// row padding. The epilogue works on the accumulator registers: + bias,
// GELU, one rounding, then the four lanes of a quad swap their bf16 pairs
// so that each stores 16 consecutive bytes; no staging pass through shared
// memory. A ragged chunk's rows past its last are zero and computed (the
// tiles stay free of predicates), not stored.
//
// Shared memory (gemm_smem_bytes): STAGES (BM + BN) BK bf16.
// Requirements: K % 16 == 0 up to kGemmMaxK, O % 16 == 0, A rows and W
// 16-byte aligned with row strides that are multiples of 8 elements, gamma
// and beta 16-byte aligned (load8).
#pragma once

#include "mma.cuh"

namespace editor_kernels {
namespace {

// W [K, O] row-major (T3) or [O, K] (K8, the torch Linear layout)
enum class WLayout { kKO, kOK };

// Largest K the body takes: a lane holds its share of a row (K / 256 16-byte
// chunks) in registers while it normalises the row
constexpr int kGemmMaxK = 1536;

constexpr size_t kMaxSmemBytes = 232448;  // a block's shared memory on the H100

template <int MT_, int NT_, int WM_, int WN_, int BK_, int STAGES_, WLayout kW_>
struct GemmCfg {
  static constexpr int MT = MT_, NT = NT_, WM = WM_, WN = WN_, BK = BK_, STAGES = STAGES_;
  static constexpr WLayout kW = kW_;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN, THREADS = 32 * WM * WN;
  // bf16 elements of one ring slice: A's BM x BK, then W's BK x BN
  static constexpr int A_STAGE = BM * BK, STAGE = A_STAGE + BK * BN;
  // 16-byte chunks of A and of W a slice
  static constexpr int A_CHUNKS = A_STAGE / 8, W_CHUNKS = BK * BN / 8;
  static_assert(NT % 2 == 0 && BK % 16 == 0 && STAGES >= 3, "");
};

template <class Cfg>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return (size_t)Cfg::STAGES * Cfg::STAGE * sizeof(bf16);
}

// Where 16-byte chunk c of row r sits in a tile whose rows hold R chunks
// (2, 4 or a multiple of 8): the 8 rows of an 8x8 ldmatrix matrix land in 8
// distinct 16-byte bank groups
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (R >= 8) return c ^ (r & 7);
  else if constexpr (R == 4) return c ^ ((r >> 1) & 3);
  else return c ^ ((r >> 2) & 1);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// 8 consecutive parameters (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const float* __restrict__ p, float (&o)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  o[0] = lo.x, o[1] = lo.y, o[2] = lo.z, o[3] = lo.w;
  o[4] = hi.x, o[5] = hi.y, o[6] = hi.z, o[7] = hi.w;
}

__device__ __forceinline__ void load8(const bf16* __restrict__ p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16x2* h = reinterpret_cast<const bf16x2*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    o[2 * e] = f.x, o[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void zero16(bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// One slice of the stream, output columns [n0, n0 + BN) and k [k0, k0 + BK),
// into the ring stage at as: rows [0, rows) of A's k slice and the weight's;
// rows past them, columns past O and k past K (a last slice of 16) zero
template <class Cfg>
__device__ __forceinline__ void gemm_load_slice(const bf16* __restrict__ a, int rows,
                                                const bf16* __restrict__ w, int K, int O,
                                                int n0, int k0, bf16* as) {
  constexpr bool kKO = Cfg::kW == WLayout::kKO;
  constexpr int RA = Cfg::BK / 8, R = kKO ? Cfg::BN / 8 : Cfg::BK / 8;  // chunks a row
  bf16* ws = as + Cfg::A_STAGE;
#pragma unroll
  for (int j = 0; j < (Cfg::A_CHUNKS + Cfg::THREADS - 1) / Cfg::THREADS; ++j) {
    const int i = threadIdx.x + j * Cfg::THREADS;
    if (Cfg::A_CHUNKS % Cfg::THREADS != 0 && i >= Cfg::A_CHUNKS) break;
    const int r = i / RA, c = i % RA;
    bf16* dst = as + r * Cfg::BK + 8 * swz<RA>(r, c);
    if (r < rows && k0 + 8 * c < K) cp_async16(dst, a + (size_t)r * K + k0 + 8 * c);
    else zero16(dst);
  }
#pragma unroll
  for (int j = 0; j < (Cfg::W_CHUNKS + Cfg::THREADS - 1) / Cfg::THREADS; ++j) {
    const int i = threadIdx.x + j * Cfg::THREADS;
    if (Cfg::W_CHUNKS % Cfg::THREADS != 0 && i >= Cfg::W_CHUNKS) break;
    const int row = i / R, c = i % R;
    bf16* dst = ws + row * (8 * R) + 8 * swz<R>(row, c);
    // kKO: row = k, chunk c = 8 output columns; kOK: row = output column, c = 8 k
    const bool ok = kKO ? n0 + 8 * c < O && k0 + row < K : n0 + row < O && k0 + 8 * c < K;
    const bf16* src = kKO ? w + (size_t)(k0 + row) * O + n0 + 8 * c
                          : w + (size_t)(n0 + row) * K + k0 + 8 * c;
    if (ok) cp_async16(dst, src);
    else zero16(dst);
  }
}

// The LayerNorm pre-pass: y = (x - mean) rsqrt(var + eps) gamma + beta of
// rows [0, rows) of a, rounded to bf16, into ys (row stride K), a warp a
// row, the loads of kRows rows of a warp in flight: the lane's chunks in
// registers, the mean, then the biased variance from the deviations, then y
template <class Cfg, typename P>
__device__ __forceinline__ void gemm_layernorm_rows(const bf16* __restrict__ a, int rows, int K,
                                                    const P* __restrict__ gamma,
                                                    const P* __restrict__ beta, float eps,
                                                    bf16* __restrict__ ys) {
  constexpr int J = kGemmMaxK / 256, kRows = 2, kWarps = Cfg::THREADS / 32;
  const int kc = K >> 3, lane = threadIdx.x & 31;
  for (int r0 = (threadIdx.x >> 5) * kRows; r0 < rows; r0 += kWarps * kRows) {
    uint4 v[kRows][J];  // packed bf16
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (r0 + q < rows && lane + 32 * j < kc)
          v[q][j] = *reinterpret_cast<const uint4*>(a + (size_t)(r0 + q) * K +
                                                    8 * (lane + 32 * j));
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (r0 + q >= rows) break;  // warp-uniform
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j < kc) {
          const bf16x2* h = reinterpret_cast<const bf16x2*>(&v[q][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            sum += f.x + f.y;
          }
        }
      }
      const float m = warp_sum(sum) / K;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j < kc) {
          const bf16x2* h = reinterpret_cast<const bf16x2*>(&v[q][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            sq = fmaf(f.x - m, f.x - m, sq);
            sq = fmaf(f.y - m, f.y - m, sq);
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(sq) / K + eps);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < kc) {
          float gm[8], bt[8];
          load8(gamma + 8 * c, gm);
          load8(beta + 8 * c, bt);
          uint32_t* h = reinterpret_cast<uint32_t*>(&v[q][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&h[e]));
            h[e] = pack_bf16((f.x - m) * rstd * gm[2 * e] + bt[2 * e],
                             (f.y - m) * rstd * gm[2 * e + 1] + bt[2 * e + 1]);
          }
          *reinterpret_cast<uint4*>(ys + (size_t)(r0 + q) * K + 8 * c) = v[q][j];
        }
      }
    }
  }
}

// The weight fragments of one 16-deep step kk of a slice (shared-memory
// address wst): b0, b1 of the warp's NT n8 tiles, two tiles an ldmatrix
template <class Cfg>
__device__ __forceinline__ void gemm_load_b(uint32_t (&b)[Cfg::NT / 2][4], unsigned wst, int kk,
                                            int wn, int lane) {
#pragma unroll
  for (int jj = 0; jj < Cfg::NT / 2; ++jj) {
    const int nb = wn * Cfg::NT * 8 + 16 * jj;  // columns nb..nb + 15
    if constexpr (Cfg::kW == WLayout::kKO) {
      // lanes 0-7 k 0-7 at n 0, 8-15 k 8-15 at n 0, 16-23 k 0-7 at n 8,
      // 24-31 k 8-15 at n 8 (the stage rows are k)
      const int kr = kk + (lane & 7) + (((lane >> 3) & 1) << 3);
      const int c = swz<Cfg::BN / 8>(kr, (nb >> 3) + (lane >> 4));
      ldmatrix_x4_trans(b[jj], wst + 2u * (kr * Cfg::BN + 8 * c));
    } else {
      // lanes 0-7 n 0-7 at k 0, 8-15 n 0-7 at k 8, 16-23 n 8-15 at k 0,
      // 24-31 n 8-15 at k 8 (the stage rows are output columns)
      const int nr = nb + (lane & 7) + ((lane >> 4) << 3);
      const int c = swz<Cfg::BK / 8>(nr, (kk >> 3) + ((lane >> 3) & 1));
      ldmatrix_x4(b[jj], wst + 2u * (nr * Cfg::BK + 8 * c));
    }
  }
}

// The A fragment of 16-row tile i at step kk of a slice (address st):
// ldmatrix rows: lanes 0-15 rows 0-15 at k 0, lanes 16-31 rows 0-15 at k 8
// -> a0..a3 of the m16k16 fragment (a row's swizzle depends on the row % 8
// only, the same in every 16-row tile)
template <class Cfg>
__device__ __forceinline__ void gemm_load_a(uint32_t (&a)[4], unsigned st, int kk, int i, int wm,
                                            int lane) {
  const int ar = wm * Cfg::MT * 16 + (lane & 15);
  ldmatrix_x4(a, st + 2u * ((ar + 16 * i) * Cfg::BK +
                            8 * swz<Cfg::BK / 8>(ar, (kk >> 3) + (lane >> 4))));
}

// The products of one ring slice (shared-memory address st) into the warp's
// accumulators: per 16-deep step the weight fragments, then the 16-row tiles
// of A, each tile's fragment loaded before the products of the tile before
// (two buffers, in program order: the asm statements are volatile and keep
// it), so that the ldmatrix latency overlaps the mma.sync.
template <class Cfg>
__device__ __forceinline__ void gemm_mma_slice(float (&acc)[Cfg::MT][Cfg::NT][4], unsigned st,
                                               int wm, int wn) {
  constexpr int KS = Cfg::BK / 16;
  const int lane = threadIdx.x & 31;
  const unsigned wst = st + 2u * Cfg::A_STAGE;
  uint32_t a[2][4];
  gemm_load_a<Cfg>(a[0], st, 0, 0, wm, lane);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[Cfg::NT / 2][4];
    gemm_load_b<Cfg>(b, wst, 16 * ks, wn, lane);
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i) {
      const int q = ks * Cfg::MT + i;  // this tile's A buffer: q & 1
      if (i + 1 < Cfg::MT) gemm_load_a<Cfg>(a[(q + 1) & 1], st, 16 * ks, i + 1, wm, lane);
      else if (ks + 1 < KS) gemm_load_a<Cfg>(a[(q + 1) & 1], st, 16 * (ks + 1), 0, wm, lane);
#pragma unroll
      for (int jj = 0; jj < Cfg::NT / 2; ++jj) {
        mma_bf16(acc[i][2 * jj], a[q & 1], b[jj][0], b[jj][1]);
        mma_bf16(acc[i][2 * jj + 1], a[q & 1], b[jj][2], b[jj][3]);
      }
    }
  }
}

// The value of q[k] for k = idx (0..3) without indexing a register array at
// a run-time position
__device__ __forceinline__ uint32_t pick4(const uint32_t (&q)[4], int idx) {
  return idx == 0 ? q[0] : idx == 1 ? q[1] : idx == 2 ? q[2] : q[3];
}

// out[r, n0 + col] for the warp's accumulators: + bias (fp32), GELU, one
// rounding to bf16, stores of rows < rows and columns < O. For each four n8
// tiles the four lanes of a quad swap their bf16 pairs (a 4 x 4 transpose,
// 3 shuffles), so that each lane stores 8 consecutive columns of its row
// with one 16-byte store; the last NT % 4 tiles (and a 32-column group that
// O cuts) store each lane's bf16 pairs.
template <class Cfg, bool kGelu, typename P>
__device__ __forceinline__ void gemm_epilogue(const float (&acc)[Cfg::MT][Cfg::NT][4], int n0,
                                              int rows, int O, const P* __restrict__ bias,
                                              bf16* __restrict__ out, int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int c0 = n0 + wn * Cfg::NT * 8;  // the warp's first column
  float b[Cfg::NT][2];
#pragma unroll
  for (int j = 0; j < Cfg::NT; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    b[j][0] = bias && col < O ? to_f(bias[col]) : 0.f;
    b[j][1] = bias && col < O ? to_f(bias[col + 1]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the 16-row tile
      const int r = 16 * (wm * Cfg::MT + i) + g + 8 * h;
      uint32_t p[Cfg::NT];  // bf16 pairs: columns c0 + 8 j + 2 t, + 1
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j) {
        float v0 = acc[i][j][2 * h] + b[j][0], v1 = acc[i][j][2 * h + 1] + b[j][1];
        if constexpr (kGelu) {
          v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
          v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
        }
        p[j] = pack_bf16(v0, v1);
      }
#pragma unroll
      for (int j0 = 0; j0 < Cfg::NT; j0 += 4) {
        if (j0 + 4 <= Cfg::NT && c0 + 8 * j0 + 32 <= O) {
          // lane t gets tile j0 + t's pair of every lane l of the quad:
          // columns c0 + 8 (j0 + t) + 2 l, l = 0..3
          const uint32_t q[4] = {p[j0], p[j0 + 1], p[j0 + 2], p[j0 + 3]};
          uint32_t o[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)  // receive from lane t ^ x its pair of tile j0 + t
            o[x] = __shfl_xor_sync(kFull, pick4(q, t ^ x), x);
          uint4 packed;
          packed.x = pick4(o, t), packed.y = pick4(o, t ^ 1);
          packed.z = pick4(o, t ^ 2), packed.w = pick4(o, t ^ 3);
          if (r < rows)
            *reinterpret_cast<uint4*>(out + (size_t)r * O + c0 + 8 * (j0 + t)) = packed;
        } else {
#pragma unroll
          for (int j = j0; j < j0 + 4 && j < Cfg::NT; ++j) {
            const int col = c0 + 8 * j + 2 * t;
            if (r < rows && col < O)
              *reinterpret_cast<uint32_t*>(out + (size_t)r * O + col) = p[j];
          }
        }
      }
    }
  }
}

// One chunk of rows [0, rows), rows <= BM: out [rows, O] (row stride O) from
// a [rows, K] (row stride K); kLN: the rows are normalised first, with gamma
// and beta, into the global scratch ys [rows, K] (row stride K), and the
// products stream them from there (L2). The block's threads all call it; it
// opens with a barrier (the last user of the shared memory is done with it)
// and drains its copies before it returns.
template <class Cfg, bool kLN, bool kGelu, typename P>
__device__ __forceinline__ void ln_gemm_chunk(const bf16* __restrict__ a, int rows, int K,
                                              const bf16* __restrict__ w, int O,
                                              const P* __restrict__ bias,
                                              bf16* __restrict__ out,
                                              const P* __restrict__ gamma,
                                              const P* __restrict__ beta, float eps,
                                              bf16* ys, unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / Cfg::WN, wn = warp % Cfg::WN;
  const int total = (K + Cfg::BK - 1) / Cfg::BK * ((O + Cfg::BN - 1) / Cfg::BN);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const unsigned rsm = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  if constexpr (kLN) {
    gemm_layernorm_rows<Cfg>(a, rows, K, gamma, beta, eps, ys);
    a = ys;
  }
  __syncthreads();  // kLN: every normalised row is stored; the shared memory is free
  // the next slice to load: its output columns, k and ring stage (counters,
  // no division in the loop)
  int ln0 = 0, lk0 = 0, lst = 0;
  auto load_next = [&]() {
    gemm_load_slice<Cfg>(a, rows, w, K, O, ln0, lk0, ring + lst * Cfg::STAGE);
    lst = lst + 1 == Cfg::STAGES ? 0 : lst + 1;
    if ((lk0 += Cfg::BK) >= K) lk0 = 0, ln0 += Cfg::BN;
  };
#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < total) load_next();
    cp_async_commit();
  }
  int s = 0, st = 0;  // the slice of the products and its ring stage
  for (int n0 = 0; n0 < O; n0 += Cfg::BN) {
    float acc[Cfg::MT][Cfg::NT][4];
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += Cfg::BK, ++s) {
      cp_async_wait<Cfg::STAGES - 2>();  // this thread's copies of slice s have landed
      __syncthreads();  // ... every thread's; every warp is done with slice s - 1
      if (s + Cfg::STAGES - 1 < total) load_next();
      cp_async_commit();
      gemm_mma_slice<Cfg>(acc, rsm + 2u * (st * Cfg::STAGE), wm, wn);
      st = st + 1 == Cfg::STAGES ? 0 : st + 1;
    }
    gemm_epilogue<Cfg, kGelu>(acc, n0, rows, O, bias, out, wm, wn, lane);
  }
  cp_async_wait<0>();
}

}  // namespace
}  // namespace editor_kernels
