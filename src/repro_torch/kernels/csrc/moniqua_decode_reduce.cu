// Moniqua fused decode-reduce (Algorithm 1 lines 4-6) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/moniqua_decode_reduce.py::decode_reduce
// (_decode_reduce_kernel; math in unpack_values and decode_reduce_values).
// Per element, with q(c) = ((c + 1/2) / 2^bits - 1/2) * B:
//   xhat_self = q(c_self) - cmod(y, B) + y                  (line 4)
//   xhat_s    = cmod(q(c_s) - y, B) + y     for each of m neighbors (line 5)
//   out       = y + sum_s w_s * (xhat_s - xhat_self)        (line 6)
// with the neighbors accumulated in offset order, as the reference does.
//
// Layout: y and out are [rows, cols] row-major (float32 or bfloat16, out in
// y's type); p_self is [rows, pcols] uint8 and p_nbrs [m, rows, pcols] uint8,
// pcols = ceil(cols / vpb), neighbor s being the payload rolled by offset s.
//
// Bound: device memory.  Each element reads (m + 1) * bits/8 bytes of
// payload and one value of y, and writes one value: (m+1)*bits/8 + 8 bytes
// for float32.  The arithmetic (one division per neighbor) stays well below
// the card's float32 rate.
//
// Design: one launch over the whole buffer, one thread per packed byte
// column.  It reads the m+1 payload bytes once, then for each of the vpb
// values of that byte reads y, runs the reduction in registers and writes the
// output; no intermediate touches device memory.  The m <= 8 float32 weights
// are passed by value in a small struct (the TPU kernel compiled them in as
// constants).  The _rn intrinsics (and -fmad=false) keep every multiply and
// add separately rounded: they replace the TPU kernel's _shield select, whose
// only job was to stop multiply-add contraction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNeighbors = 8;

struct Weights {
  float w[kMaxNeighbors];
};

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

template <int BITS>
__device__ __forceinline__ float value_of(uint32_t packed, int s, float B) {
  const uint32_t code = (packed >> (s * BITS)) & ((1u << BITS) - 1u);
  const float levels = (float)(1 << BITS);
  return __fmul_rn(
      __fsub_rn(__fdiv_rn(__fadd_rn((float)code, 0.5f), levels), 0.5f), B);
}

template <typename T, int BITS>
__global__ void decode_reduce_kernel(const uint8_t* __restrict__ p_self,
                                     const uint8_t* __restrict__ p_nbrs,
                                     const T* __restrict__ y,
                                     T* __restrict__ out, int64_t rows,
                                     int64_t cols, int64_t pcols, int m,
                                     Weights w,
                                     const float* __restrict__ B_ptr) {
  constexpr int VPB = 8 / BITS;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * pcols) return;
  const int64_t row = t / pcols;
  const int64_t b = t - row * pcols;
  const int64_t plane = rows * pcols;
  const float B = *B_ptr;
  const uint32_t ps = p_self[t];
  uint32_t pn[kMaxNeighbors];
#pragma unroll
  for (int k = 0; k < kMaxNeighbors; ++k)
    pn[k] = k < m ? p_nbrs[k * plane + t] : 0u;
#pragma unroll
  for (int s = 0; s < VPB; ++s) {
    const int64_t c = b * VPB + s;
    if (c >= cols) break;
    const int64_t i = row * cols + c;
    const float yv = load_f32(y, i);
    const float xs =
        __fadd_rn(__fsub_rn(value_of<BITS>(ps, s, B), cmod(yv, B)), yv);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxNeighbors; ++k) {
      if (k >= m) break;
      const float d = __fsub_rn(value_of<BITS>(pn[k], s, B), yv);
      const float xh = __fadd_rn(cmod(d, B), yv);
      acc = __fadd_rn(acc, __fmul_rn(w.w[k], __fsub_rn(xh, xs)));
    }
    store(out, i, __fadd_rn(yv, acc));
  }
}

template <typename T>
int launch(const uint8_t* p_self, const uint8_t* p_nbrs, const T* y, T* out,
           int64_t rows, int64_t cols, int m, const Weights& w,
           const float* B, int bits, cudaStream_t stream) {
  const int vpb = 8 / bits;
  const int64_t pcols = (cols + vpb - 1) / vpb;
  const int64_t total = rows * pcols;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  switch (bits) {
    case 1:
      decode_reduce_kernel<T, 1><<<blocks, threads, 0, stream>>>(
          p_self, p_nbrs, y, out, rows, cols, pcols, m, w, B);
      break;
    case 2:
      decode_reduce_kernel<T, 2><<<blocks, threads, 0, stream>>>(
          p_self, p_nbrs, y, out, rows, cols, pcols, m, w, B);
      break;
    case 4:
      decode_reduce_kernel<T, 4><<<blocks, threads, 0, stream>>>(
          p_self, p_nbrs, y, out, rows, cols, pcols, m, w, B);
      break;
    case 8:
      decode_reduce_kernel<T, 8><<<blocks, threads, 0, stream>>>(
          p_self, p_nbrs, y, out, rows, cols, pcols, m, w, B);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `weights` points to m
// float32 values on the host; they travel to the kernel by value.  `y` and
// `out` are float32 or, with y_is_bf16, bfloat16; `B` points to one float32
// on the device.
extern "C" int moniqua_decode_reduce(const void* p_self, const void* p_nbrs,
                                     const void* y, int y_is_bf16, void* out,
                                     int64_t rows, int64_t cols, int m,
                                     const float* weights, const float* B,
                                     int bits, void* stream) {
  if (m < 1 || m > kMaxNeighbors) return (int)cudaErrorInvalidValue;
  Weights w;
  for (int k = 0; k < kMaxNeighbors; ++k) w.w[k] = k < m ? weights[k] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* ps = static_cast<const uint8_t*>(p_self);
  const uint8_t* pn = static_cast<const uint8_t*>(p_nbrs);
  if (y_is_bf16)
    return launch(ps, pn, static_cast<const __nv_bfloat16*>(y),
                  static_cast<__nv_bfloat16*>(out), rows, cols, m, w, B, bits,
                  s);
  return launch(ps, pn, static_cast<const float*>(y), static_cast<float*>(out),
                rows, cols, m, w, B, bits, s);
}
