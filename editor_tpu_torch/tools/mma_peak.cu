// The mma.sync throughput of the card: each warp runs `iters` rounds of 32
// independent mma.sync.m16n8k16 (bf16 in, fp32 sums; or f16 in and out) on
// register operands, with no memory traffic, one block of `warps` warps an SM.
// Built and run by tools/mma_peak.py.
#include <cuda_bf16.h>
#include <stdint.h>

#include <cstdio>

namespace {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(uint32_t (&c)[2], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 {%0, %1}, {%2, %3, %4, %5}, "
      "{%6, %7}, {%0, %1};\n"
      : "+r"(c[0]), "+r"(c[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kAcc = 32;  // independent accumulators a warp

__global__ void mma_loop_f32(float* out, int iters) {
  float acc[kAcc][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) mma_bf16(acc[j], a, b0, b1);
  }
  float s = 0.f;
  for (int j = 0; j < kAcc; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void mma_loop_f16(float* out, int iters) {
  uint32_t acc[kAcc][2] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) mma_f16(acc[j], a, b0, b1);
  }
  uint32_t s = 0u;
  for (int j = 0; j < kAcc; ++j) s ^= acc[j][0] ^ acc[j][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(s);
}

}  // namespace

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * sms * 512);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  for (int f16 = 0; f16 < 2; ++f16) {
    for (int warps : {4, 8, 12}) {
      auto run = [&](int n) {
        if (f16) mma_loop_f16<<<sms, warps * 32>>>(out, n);
        else mma_loop_f32<<<sms, warps * 32>>>(out, n);
      };
      run(16);
      cudaEventRecord(e0);
      run(iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double flops = 2.0 * 16 * 8 * 16 * kAcc * (double)iters * warps * sms;
      std::printf("{\"sums\": \"%s\", \"warps_per_sm\": %d, \"ms\": %.4f, \"tflops\": %.1f}\n",
                  f16 ? "f16" : "f32", warps, ms, flops / ms / 1e9);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::printf("%s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
