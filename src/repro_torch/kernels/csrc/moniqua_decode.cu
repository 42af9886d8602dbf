// Moniqua single-payload decode (Algorithm 1 lines 4 and 5) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/moniqua_decode.py::decode (_decode_kernel).  Per
// element, with qb = ((c + 1/2) / 2^bits - 1/2) * B the payload's value:
//   remote: d = qb - y;  out = (d - B * floor(d / B + 1/2)) + y   (line 5)
//   self:   ymod = y - B * floor(y / B + 1/2);  out = (qb - ymod) + y (line 4)
// in exactly that operation order.
//
// Layout: y and out are [rows, cols] row-major (float32 or bfloat16, out in
// y's type); packed is [rows, pcols] uint8, pcols = ceil(cols / vpb), value
// s of byte b being column b * vpb + s.  Columns past a row's end are not
// written.
//
// Bound: device memory.  Each element reads bits/8 bytes of payload and one
// value of y and writes one value: bits/8 + 8 bytes for float32.  The
// arithmetic (two divisions) stays well below the card's float32 rate.
//
// Design: one launch over the whole buffer, one thread per packed byte, as
// the decode-reduce kernel does with one payload and no reduce.  The _rn
// intrinsics (and -fmad=false) keep every multiply and add separately
// rounded, so the result equals the plain PyTorch version bit for bit.
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
__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// v - B * floor(v / B + 1/2): the centered modulo into [-B/2, B/2)
__device__ __forceinline__ float cmod(float v, float B) {
  return __fsub_rn(v, __fmul_rn(B, floorf(__fadd_rn(__fdiv_rn(v, B), 0.5f))));
}

template <typename T, int BITS, bool SELF>
__global__ void decode_kernel(const uint8_t* __restrict__ packed,
                              const T* __restrict__ y, T* __restrict__ out,
                              int64_t rows, int64_t cols, int64_t pcols,
                              const float* __restrict__ B_ptr) {
  constexpr int VPB = 8 / BITS;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * pcols) return;
  const int64_t row = t / pcols;
  const int64_t b = t - row * pcols;
  const float B = *B_ptr;
  const float levels = (float)(1 << BITS);
  const uint32_t p = packed[t];
#pragma unroll
  for (int s = 0; s < VPB; ++s) {
    const int64_t c = b * VPB + s;
    if (c >= cols) break;
    const int64_t i = row * cols + c;
    const uint32_t code = (p >> (s * BITS)) & ((1u << BITS) - 1u);
    const float qb = __fmul_rn(
        __fsub_rn(__fdiv_rn(__fadd_rn((float)code, 0.5f), levels), 0.5f), B);
    const float yv = load_f32(y, i);
    float o;
    if (SELF) {
      o = __fadd_rn(__fsub_rn(qb, cmod(yv, B)), yv);
    } else {
      o = __fadd_rn(cmod(__fsub_rn(qb, yv), B), yv);
    }
    store(out, i, o);
  }
}

template <typename T, bool SELF>
int launch_mode(const uint8_t* packed, const T* y, T* out, int64_t rows,
                int64_t cols, const float* B, int bits, cudaStream_t stream) {
  const int vpb = 8 / bits;
  const int64_t pcols = (cols + vpb - 1) / vpb;
  const int64_t total = rows * pcols;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  switch (bits) {
    case 1:
      decode_kernel<T, 1, SELF><<<blocks, threads, 0, stream>>>(
          packed, y, out, rows, cols, pcols, B);
      break;
    case 2:
      decode_kernel<T, 2, SELF><<<blocks, threads, 0, stream>>>(
          packed, y, out, rows, cols, pcols, B);
      break;
    case 4:
      decode_kernel<T, 4, SELF><<<blocks, threads, 0, stream>>>(
          packed, y, out, rows, cols, pcols, B);
      break;
    case 8:
      decode_kernel<T, 8, SELF><<<blocks, threads, 0, stream>>>(
          packed, y, out, rows, cols, pcols, B);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const uint8_t* packed, const T* y, T* out, int64_t rows,
           int64_t cols, const float* B, int bits, int self_mode,
           cudaStream_t stream) {
  if (self_mode)
    return launch_mode<T, true>(packed, y, out, rows, cols, B, bits, stream);
  return launch_mode<T, false>(packed, y, out, rows, cols, B, bits, stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `y` and `out` are
// float32 or, with y_is_bf16, bfloat16; `B` points to one float32 on the
// device; self_mode selects line 4 (else line 5).
extern "C" int moniqua_decode(const void* packed, const void* y,
                              int y_is_bf16, void* out, int64_t rows,
                              int64_t cols, const float* B, int bits,
                              int self_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  if (y_is_bf16)
    return launch(p, static_cast<const __nv_bfloat16*>(y),
                  static_cast<__nv_bfloat16*>(out), rows, cols, B, bits,
                  self_mode, s);
  return launch(p, static_cast<const float*>(y), static_cast<float*>(out),
                rows, cols, B, bits, self_mode, s);
}
