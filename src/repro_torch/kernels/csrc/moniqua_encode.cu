// Moniqua encode (Algorithm 1 line 3) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moniqua_encode.py::encode
// (_encode_kernel).  Per element:
//   r    = cmod(x / B, 1)                       in [-1/2, 1/2)
//   lat  = (r + 1/2) * 2^bits - 1/2             midpoint lattice
//   code = clip(floor(lat + u), 0, 2^bits - 1)  u = murmur3(seed, idx) or 1/2
// and 8/bits codes pack into one byte: the code of column b*vpb + s lands in
// bits [s*bits, (s+1)*bits) of byte b.
//
// Layout: x is [rows, cols] row-major, rows = workers * rows_per_worker; the
// output is [rows, ceil(cols / vpb)] uint8.  A row's columns past `cols`
// encode as x = 0 (the reference zero-pads the last dim to values-per-byte).
// The counter index of column c of row r is
//   idx_base + (r % rows_per_worker) * ceil(cols / vpb) * vpb + c   (uint32)
// so it restarts for every worker: all workers draw the same uniform for the
// same element (shared randomness, paper Supp. C).
//
// Bound: device memory.  Each element is read once (4 bytes f32 or 2 bf16)
// and bits/8 bytes are written, with a few dozen integer and float
// operations per element, far below the card's compute rate.
//
// Design: one launch covers the whole buffer, one thread per 4 output bytes
// (4 * vpb contiguous elements of one row), stored as one 32-bit word where
// the address is aligned.  Blocks are independent: the hash replaces the
// TPU's sequential PRNG state, so there is nothing to carry between blocks.
// The float math uses the _rn intrinsics (and the build passes -fmad=false)
// so no multiply-add is contracted: the bytes are those of the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// murmur3 finalizer of (seed, idx) -> uniform in [0, 1), as
// repro.core.quantizers._counter_uniform computes it in uint32.
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t idx) {
  uint32_t h = (idx * 0x9E3779B9u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
}

template <int BITS>
__device__ __forceinline__ uint32_t code_of(float x, float B, bool stochastic,
                                            uint32_t seed, uint32_t idx) {
  const float levels = (float)(1 << BITS);
  float r = __fdiv_rn(x, B);
  r = __fsub_rn(r, floorf(__fadd_rn(r, 0.5f)));  // cmod(r, 1)
  const float lat = __fsub_rn(__fmul_rn(__fadd_rn(r, 0.5f), levels), 0.5f);
  const float u = stochastic ? hash_uniform(seed, idx) : 0.5f;
  float c = floorf(__fadd_rn(lat, u));
  c = fminf(fmaxf(c, 0.0f), levels - 1.0f);
  return (uint32_t)c;
}

template <typename T, int BITS>
__global__ void encode_kernel(const T* __restrict__ x,
                              uint8_t* __restrict__ out, int64_t rows,
                              int64_t rows_per_worker, int64_t cols,
                              int64_t pcols, int64_t words_per_row,
                              const float* __restrict__ B_ptr, uint32_t seed,
                              uint32_t idx_base, int stochastic) {
  constexpr int VPB = 8 / BITS;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * words_per_row) return;
  const int64_t row = t / words_per_row;
  const int64_t b0 = (t - row * words_per_row) * 4;
  const float B = *B_ptr;
  const T* xr = x + row * cols;
  const uint32_t row_base =
      (uint32_t)((row % rows_per_worker) * pcols * VPB);
  const int nb = pcols - b0 < 4 ? (int)(pcols - b0) : 4;
  uint32_t word = 0;
  for (int k = 0; k < nb; ++k) {
    uint32_t byte = 0;
#pragma unroll
    for (int s = 0; s < VPB; ++s) {
      const int64_t c = (b0 + k) * VPB + s;
      const float xv = c < cols ? load_f32(xr, c) : 0.0f;
      const uint32_t idx = idx_base + row_base + (uint32_t)c;
      byte |= code_of<BITS>(xv, B, stochastic != 0, seed, idx) << (s * BITS);
    }
    word |= byte << (8 * k);
  }
  uint8_t* dst = out + row * pcols + b0;
  if (nb == 4 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else {
    for (int k = 0; k < nb; ++k) dst[k] = (uint8_t)(word >> (8 * k));
  }
}

template <typename T>
int launch(const T* x, uint8_t* out, int64_t rows, int64_t rows_per_worker,
           int64_t cols, const float* B, uint32_t seed, uint32_t idx_base,
           int bits, int stochastic, cudaStream_t stream) {
  const int vpb = 8 / bits;
  const int64_t pcols = (cols + vpb - 1) / vpb;
  const int64_t words = (pcols + 3) / 4;
  const int64_t total = rows * words;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  switch (bits) {
    case 1:
      encode_kernel<T, 1><<<blocks, threads, 0, stream>>>(
          x, out, rows, rows_per_worker, cols, pcols, words, B, seed,
          idx_base, stochastic);
      break;
    case 2:
      encode_kernel<T, 2><<<blocks, threads, 0, stream>>>(
          x, out, rows, rows_per_worker, cols, pcols, words, B, seed,
          idx_base, stochastic);
      break;
    case 4:
      encode_kernel<T, 4><<<blocks, threads, 0, stream>>>(
          x, out, rows, rows_per_worker, cols, pcols, words, B, seed,
          idx_base, stochastic);
      break;
    case 8:
      encode_kernel<T, 8><<<blocks, threads, 0, stream>>>(
          x, out, rows, rows_per_worker, cols, pcols, words, B, seed,
          idx_base, stochastic);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `x` is float32 or, with
// x_is_bf16, bfloat16; `B` points to one float32 on the device.
extern "C" int moniqua_encode(const void* x, int x_is_bf16, void* out,
                              int64_t rows, int64_t rows_per_worker,
                              int64_t cols, const float* B, uint32_t seed,
                              uint32_t idx_base, int bits, int stochastic,
                              void* stream) {
  if (rows_per_worker < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (x_is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), o, rows,
                  rows_per_worker, cols, B, seed, idx_base, bits, stochastic,
                  s);
  return launch(static_cast<const float*>(x), o, rows, rows_per_worker, cols,
                B, seed, idx_base, bits, stochastic, s);
}
