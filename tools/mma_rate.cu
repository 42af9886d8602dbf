// The issue rate of mma.sync on this card: every warp runs CHAINS
// independent accumulators through `iters` rounds of one instruction, so
// the tensor cores, not the dependencies, set the time.  Built and run by
// tools/mma_rate.py, which turns the time into TFLOP/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

template <bool TF32>
__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  const uint32_t a[4] = {seed, seed ^ 1u, seed ^ 2u, seed ^ 3u};
  const uint32_t b0 = seed * 3u, b1 = seed * 5u;
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Launches blocks x threads threads, each warp issuing iters * 8 mma.sync:
// m16n8k8 TF32 (2,048 flops each) with tf32 set, else m16n8k16 bf16
// (4,096).  `out` holds blocks * threads floats.  Returns cudaError_t.
extern "C" int mma_rate(int tf32, float* out, int blocks, int threads,
                        int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tf32)
    mma_loop<true><<<blocks, threads, 0, s>>>(out, iters, 12345u);
  else
    mma_loop<false><<<blocks, threads, 0, s>>>(out, iters, 12345u);
  return (int)cudaGetLastError();
}
