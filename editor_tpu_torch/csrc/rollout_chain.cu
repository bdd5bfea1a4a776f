// K2: attention rollout, the cls row of the chain product of the per-layer
// attention maps, as a reverse vector chain v <- v . A_l; and its design
// variants T4 and T5.
//
// Replaces the TPU kernels editor_tpu/ops/rollout.py::_pallas_chain_split
// (_chain_kernel; K2), tools/bench_rollout.py::chain (variant_kernel; T4) and
// tools/bench_rollout2.py::chain_multi (multi_kernel; T5).
//
// Contract (same as the plain versions: rollout_from_probs_plain in
// editor_tpu_torch/ops/rollout.py, chain_plain and chain_multi_plain in
// editor_tpu_torch/tools/bench_rollout{,2}.py):
//   probs [L, Z, N, N] bf16: per-layer post-softmax maps, Z = B * H (b, h)
//   pairs, row = query. out [Z, N - 1] fp32: v[1:] where v is seeded with row 0
//   of the last layer's map and v <- v . A_l for l = L-2 .. 0 (the reference
//   chain order, last_map = att[i] @ last_map).
// Variants (T4's `how`, tools/bench_rollout.py:50-66):
//   f32  (K2, f32dot): fp32 products of the bf16 map and the fp32 v;
//   bf16 (bf16dot):    each patch column m >= 1 takes v[n >= 1] rounded to
//                      bf16 (the TPU's bf16 MXU operand), while v[0] and the
//                      cls column m = 0 stay fp32 (variant_kernel :56-61);
//   rows (vpu):        f32's math, each warp summing a slice of the rows and
//                      a block reduction over the warps (another order).
// T5 (multi_kernel) is bf16's math with T maps in flight.
//
// What bounds it on the H100: bytes. Every layer's map is read exactly once:
// L x Z x N x N x 2 B = 1.84 GB at the flagship shape (L = 12, Z = 4608,
// N = 129), about 0.55 ms at 3.35 TB/s, against only 2 L Z N^2 = 1.8 GFLOP.
//
// Design (K2): one block per (b, h) pair, one thread per output column m (N
// rounded up to whole warps), so a warp reads 32 neighbouring bf16 of one row
// per step and the block streams each contiguous N x N map front to back. The
// layer loop runs inside the block (the TPU kernel's sequential grid axis has
// no Hopper counterpart); v lives in fp32 in shared memory, double-buffered
// so one __syncthreads per layer suffices.
// T4: the same with g pairs per block (each thread keeps g independent
// sums, so g loads are in flight per step) and the bf16 rounding; `rows`
// maps 4 warps over rows and lanes over columns instead.
// T5: one thread per column, the block walks its g pairs' L maps in order
// through a ring of T map slots in shared memory filled by cp.async (T - 1
// maps in flight while one is consumed; one [129, 129] bf16 map is 33 KB, so
// T <= 6 fits the 227 KB of a block). Maps start at odd 2-byte offsets, so each
// copy covers the 16-byte-aligned span around its map and the slot remembers
// the map's offset.
#include "common.cuh"

namespace editor_kernels {
namespace {

constexpr int kRowWarps = 4;  // T4 `rows`: warps per block

// cols mapping: g pairs [z0, z0 + kPairs), thread m owns column m. kBf16:
// patch columns take bf16-rounded v[n >= 1].
template <bool kBf16, int kPairs>
__device__ __forceinline__ void rollout_cols_body(const bf16* __restrict__ probs,
                                                  float* __restrict__ out, int L, int Z,
                                                  int N, int z0) {
  __shared__ float buf[2][kPairs][kMaxTokens];
  __shared__ float bufb[kBf16 ? 2 : 1][kBf16 ? kPairs : 1][kBf16 ? kMaxTokens : 1];
  int c = 0;  // the current buffer
  const int m = threadIdx.x;
  const size_t map = (size_t)N * N;
  const size_t layer = (size_t)Z * map;
  const int np = min(kPairs, Z - z0);
  if (m < N) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      if (j < np) {
        const float s = __bfloat162float(probs[(size_t)(L - 1) * layer + (z0 + j) * map + m]);
        buf[0][j][m] = s;
        if constexpr (kBf16) bufb[0][j][m] = m == 0 ? s : __bfloat162float(__float2bfloat16(s));
      }
    }
  }
  __syncthreads();
  for (int l = L - 2; l >= 0; --l) {
    if (m < N) {
      float acc[kPairs];
      const bf16* col[kPairs];
      const float* w[kPairs];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        acc[j] = 0.f;
        col[j] = probs + (size_t)l * layer + (size_t)(z0 + min(j, np - 1)) * map + m;
        if constexpr (kBf16) w[j] = m != 0 ? bufb[c][j] : buf[c][j];
        else w[j] = buf[c][j];
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j)
          acc[j] = fmaf(w[j][n], __bfloat162float(col[j][(size_t)n * N]), acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        buf[c ^ 1][j][m] = acc[j];
        if constexpr (kBf16)
          bufb[c ^ 1][j][m] = m == 0 ? acc[j] : __bfloat162float(__float2bfloat16(acc[j]));
      }
    }
    __syncthreads();
    c ^= 1;
  }
  if (m >= 1 && m < N) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j)
      if (j < np) out[(size_t)(z0 + j) * (N - 1) + m - 1] = buf[c][j][m];
  }
}

__global__ void rollout_chain_kernel(const bf16* __restrict__ probs,
                                     float* __restrict__ out, int L, int Z, int N) {
  rollout_cols_body<false, 1>(probs, out, L, Z, N, blockIdx.x);
}

// T4 f32 and bf16 with kPairs pairs per block
template <bool kBf16, int kPairs>
__global__ void rollout_variant_kernel(const bf16* __restrict__ probs,
                                       float* __restrict__ out, int L, int Z, int N) {
  rollout_cols_body<kBf16, kPairs>(probs, out, L, Z, N, blockIdx.x * kPairs);
}

// T4 `rows`: kRowWarps warps, warp w sums rows n = w, w + kRowWarps, ...; lane
// owns columns lane + 32 t; the warps' partial sums are added in warp order.
template <int kPairs>
__global__ void __launch_bounds__(kRowWarps * 32)
rollout_rows_kernel(const bf16* __restrict__ probs, float* __restrict__ out, int L, int Z,
                    int N) {
  constexpr int kCols = kMaxTokens / 32;
  __shared__ float v[kPairs][kMaxTokens];
  __shared__ float part[kRowWarps][kPairs][kMaxTokens];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int z0 = blockIdx.x * kPairs;
  const int np = min(kPairs, Z - z0);
  const size_t map = (size_t)N * N;
  const size_t layer = (size_t)Z * map;
  const int nt = (N + 31) / 32;
  for (int i = threadIdx.x; i < kPairs * N; i += blockDim.x) {
    const int j = i / N, m = i - j * N;
    v[j][m] = j < np ? __bfloat162float(probs[(size_t)(L - 1) * layer + (z0 + j) * map + m])
                     : 0.f;
  }
  __syncthreads();
  for (int l = L - 2; l >= 0; --l) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const bf16* a = probs + (size_t)l * layer + (size_t)(z0 + min(j, np - 1)) * map;
      float acc[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) acc[t] = 0.f;
      for (int n = warp; n < N; n += kRowWarps) {
        const float vn = v[j][n];
        const bf16* row = a + (size_t)n * N;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int m = lane + 32 * t;
          if (t < nt && m < N) acc[t] = fmaf(vn, __bfloat162float(row[m]), acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int m = lane + 32 * t;
        if (t < nt && m < N) part[warp][j][m] = acc[t];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kPairs * N; i += blockDim.x) {
      const int j = i / N, m = i - j * N;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) s += part[w][j][m];
      v[j][m] = s;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < np * (N - 1); i += blockDim.x) {
    const int j = i / (N - 1), m = i - j * (N - 1) + 1;
    out[(size_t)(z0 + j) * (N - 1) + m - 1] = v[j][m];
  }
}

// ---- T5: a cp.async ring of T maps ------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gsrc),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// bytes of one ring slot: the map and the 16-byte-aligned span around it
__host__ __device__ inline size_t multi_slot_bytes(int N) {
  return ((size_t)N * N * sizeof(bf16) + 32 + 15) / 16 * 16;
}

// Start the copy of map `idx` of the block's sequence (pair j = idx / L,
// layer L-1 - idx % L) into a slot; the consumer finds the map at the start
// address's offset within its 16 bytes.
__device__ __forceinline__ void multi_issue(const bf16* probs, size_t total_bytes,
                                            unsigned char* slot, int idx, int L, int Z,
                                            int N, int z0) {
  const int j = idx / L, l = L - 1 - idx % L;
  const size_t map = (size_t)N * N;
  const uintptr_t base = reinterpret_cast<uintptr_t>(probs);
  const uintptr_t start = base + ((size_t)l * Z + z0 + j) * map * sizeof(bf16);
  const uintptr_t a0 = start & ~uintptr_t(15);
  const uintptr_t a1 = (start + map * sizeof(bf16) + 15) & ~uintptr_t(15);
  const uintptr_t end = base + total_bytes;
  for (uintptr_t a = a0 + threadIdx.x * 16; a < a1; a += blockDim.x * 16) {
    const uintptr_t left = end - a;
    cp_async16(slot + (a - a0), reinterpret_cast<const void*>(a),
               left < 16 ? static_cast<int>(left) : 16);
  }
}

template <int kT>
__global__ void rollout_multi_kernel(const bf16* __restrict__ probs, float* __restrict__ out,
                                     int L, int Z, int N, int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float v[2][kMaxTokens];
  __shared__ float vb[2][kMaxTokens];
  const size_t slot_bytes = multi_slot_bytes(N);
  const size_t total_bytes = (size_t)L * Z * N * N * sizeof(bf16);
  const int z0 = blockIdx.x * pairs;
  const int np = min(pairs, Z - z0);
  const int S = np * L;  // maps this block reads, in chain order
  const int m = threadIdx.x;
  const uintptr_t base = reinterpret_cast<uintptr_t>(probs);
  const size_t map = (size_t)N * N;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kT - 1; ++i) {
    if (i < S) multi_issue(probs, total_bytes, smem + i * slot_bytes, i, L, Z, N, z0);
    cp_async_commit();
  }
  for (int i = 0; i < S; ++i) {
    const int nxt = i + kT - 1;  // refills the slot map i - 1 used
    if (nxt < S) multi_issue(probs, total_bytes, smem + (nxt % kT) * slot_bytes, nxt, L, Z, N, z0);
    cp_async_commit();
    cp_async_wait<kT - 1>();  // map i has landed (this thread's part)
    __syncthreads();          // and every thread's part
    const int j = i / L, l = L - 1 - i % L;
    const uintptr_t start = base + ((size_t)l * Z + z0 + j) * map * sizeof(bf16);
    const bf16* a = reinterpret_cast<const bf16*>(smem + (i % kT) * slot_bytes +
                                                  (start & uintptr_t(15)));
    if (m < N) {
      if (l == L - 1) {  // seed: row 0 of the last layer's map
        const float s = __bfloat162float(a[m]);
        v[c][m] = s;
        vb[c][m] = m == 0 ? s : __bfloat162float(__float2bfloat16(s));
      } else {
        const float* w = m != 0 ? vb[c] : v[c];
        float acc = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) acc = fmaf(w[n], __bfloat162float(a[n * N + m]), acc);
        v[c ^ 1][m] = acc;
        vb[c ^ 1][m] = m == 0 ? acc : __bfloat162float(__float2bfloat16(acc));
      }
    }
    if (l != L - 1) c ^= 1;
    if (l == 0 && m >= 1 && m < N) out[(size_t)(z0 + j) * (N - 1) + m - 1] = v[c][m];
    __syncthreads();  // the slot of map i and v[c ^ 1] are free again
  }
  cp_async_wait<0>();
}

template <bool kBf16>
int launch_cols(const void* probs, void* out, int L, int Z, int N, int pairs, void* stream) {
  const int threads = (N + 31) / 32 * 32;
  const auto* p = static_cast<const bf16*>(probs);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pairs) {
    case 1: rollout_variant_kernel<kBf16, 1><<<Z, threads, 0, st>>>(p, o, L, Z, N); break;
    case 2: rollout_variant_kernel<kBf16, 2><<<(Z + 1) / 2, threads, 0, st>>>(p, o, L, Z, N); break;
    case 4: rollout_variant_kernel<kBf16, 4><<<(Z + 3) / 4, threads, 0, st>>>(p, o, L, Z, N); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const void* probs, void* out, int L, int Z, int N, int pairs, void* stream) {
  const auto* p = static_cast<const bf16*>(probs);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = kRowWarps * 32;
  switch (pairs) {
    case 1: rollout_rows_kernel<1><<<Z, kThreads, 0, st>>>(p, o, L, Z, N); break;
    case 2: rollout_rows_kernel<2><<<(Z + 1) / 2, kThreads, 0, st>>>(p, o, L, Z, N); break;
    case 4: rollout_rows_kernel<4><<<(Z + 3) / 4, kThreads, 0, st>>>(p, o, L, Z, N); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kT>
int launch_multi(const void* probs, void* out, int L, int Z, int N, int pairs, void* stream) {
  const size_t smem = kT * multi_slot_bytes(N);
  cudaError_t err = allow_dynamic_smem(rollout_multi_kernel<kT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rollout_multi_kernel<kT><<<(Z + pairs - 1) / pairs, (N + 31) / 32 * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(probs), static_cast<float*>(out), L, Z, N, pairs);
  return static_cast<int>(cudaGetLastError());
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

// T4: how 0 = f32, 1 = bf16, 2 = rows; pairs per block 1, 2 or 4
extern "C" int editor_rollout_variant(const void* probs, void* out, int L, int Z, int N,
                                      int how, int pairs, void* stream) {
  using namespace editor_kernels;
  if (how == 0) return launch_cols<false>(probs, out, L, Z, N, pairs, stream);
  if (how == 1) return launch_cols<true>(probs, out, L, Z, N, pairs, stream);
  if (how == 2) return launch_rows(probs, out, L, Z, N, pairs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// T5: maps in flight T = 2, 3, 4 or 6; pairs >= 1 per block; bf16 rounding.
// probs must be 16-byte aligned.
extern "C" int editor_rollout_multi(const void* probs, void* out, int L, int Z, int N,
                                    int T, int pairs, void* stream) {
  using namespace editor_kernels;
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (T) {
    case 2: return launch_multi<2>(probs, out, L, Z, N, pairs, stream);
    case 3: return launch_multi<3>(probs, out, L, Z, N, pairs, stream);
    case 4: return launch_multi<4>(probs, out, L, Z, N, pairs, stream);
    case 6: return launch_multi<6>(probs, out, L, Z, N, pairs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
