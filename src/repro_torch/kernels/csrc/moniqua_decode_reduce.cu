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
// for float32.  The arithmetic (one division per payload) stays below the
// card's issue rate.
//
// Design: a streaming pass built for the memory system.
// - Grid: blockIdx.y is the row (rows past 65,535 loop), blockIdx.x and the
//   warp pick a tile of the row, at a 32-bit offset.  Nothing on the
//   per-element path divides but the cmod's division by B, which stays an
//   IEEE division (__fdiv_rn) as in the plain version.  The neighbor count
//   m is a template parameter, so a lane holds exactly m + 1 payload words.
// - Vector body: a warp reads y in steps of 128 elements, each lane 4
//   consecutive ones with one 16-byte (float32) or 8-byte (bfloat16) load,
//   consecutive lanes on consecutive pieces, and writes out the same way.
//   A super-step is vpb steps, 128 * vpb elements, whose codes fill 128
//   bytes of each payload: the warp reads them as one 4-byte word per lane
//   and payload, consecutive lanes on consecutive words.  At 8 bits a
//   lane's word holds the codes of its own 4 elements; below, each step
//   fetches the lane's 4 codes from the lane that loaded them (a shuffle).
//   A lane issues all loads of its warp tile (2 steps at 8 bits, one
//   super-step of 2, 4 or 8 steps below) before it computes.
// - Alignment: the body starts at the first column where y (and out) is
//   aligned for the vector access.  A payload may start anywhere, even
//   inside a byte (rows of any length, neighbor planes of any size): each
//   lane loads the aligned word holding its first code, takes the next one
//   from its neighbour lane (lane 31 loads it), and funnel-shifts the two.
//   Head and tail columns, and rows whose out is aligned unlike y, take a
//   scalar path: one thread per element.
// - Arithmetic: a code's value is one of 2^bits floats, so each CTA builds
//   them in shared memory from B, multiplying by 2^-bits where the plain
//   version divides by 2^bits (the same float: the quotient is exact).  The
//   _rn intrinsics (and the build's -fmad=false) keep every multiply and add
//   separately rounded, as the plain version rounds them; they replace the
//   TPU kernel's _shield select, whose only job was to stop multiply-add
//   contraction.  The m <= 8 float32 weights are passed by value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNeighbors = 8;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int64_t kMaxCols = (int64_t)1 << 31;

struct Weights {
  float w[kMaxNeighbors];
};

// Four consecutive elements: one 16-byte (float32) or 8-byte (bfloat16)
// access of an address aligned to it.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xFFFF0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xFFFF0000u);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                 bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
}
__device__ __forceinline__ float load1(const float* p, uint32_t i) {
  return p[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p, uint32_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, uint32_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, uint32_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// v - B * floor(v / B + 1/2): the centered modulo into [-B/2, B/2)
__device__ __forceinline__ float cmod(float v, float B) {
  return __fsub_rn(v, __fmul_rn(B, floorf(__fadd_rn(__fdiv_rn(v, B), 0.5f))));
}

// ((code + 1/2) * 2^-bits - 1/2) * B: the plain version's value of a code
template <int BITS>
__device__ __forceinline__ float value_of(uint32_t code, float B) {
  constexpr float kInvLevels = 1.0f / (float)(1 << BITS);
  return __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn((float)code, 0.5f), kInvLevels), 0.5f), B);
}

// Lines 4-6 for one element: qs is its own payload's value, qn[k] the k-th
// neighbor's
template <int M>
__device__ __forceinline__ float mix(float yv, float qs, const float* qn,
                                     const Weights& w, float B) {
  const float xs = __fadd_rn(__fsub_rn(qs, cmod(yv, B)), yv);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float xh = __fadd_rn(cmod(__fsub_rn(qn[k], yv), B), yv);
    acc = __fadd_rn(acc, __fmul_rn(w.w[k], __fsub_rn(xh, xs)));
  }
  return __fadd_rn(yv, acc);
}

// A super-step is 128 * vpb elements: 128 bytes of each payload, one
// 4-byte word per lane.  A warp tile is the super-steps whose loads a lane
// issues before it computes: 2 steps at 8 bits, one super-step below.
template <int BITS>
struct Shape {
  static constexpr uint32_t VPB = 8 / BITS;
  static constexpr uint32_t SSE = 128 * VPB;      // elements a super-step
  static constexpr uint32_t SPT = VPB == 1 ? 2 : 1;  // super-steps a tile
};

// Payload k's row: the aligned word holding the body's first code, and
// that code's bit offset in it
struct PayloadRow {
  const uint32_t* words;
  uint32_t shift;
};

template <int BITS>
__device__ __forceinline__ PayloadRow payload_row(const uint8_t* row,
                                                  uint32_t head) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  const uint32_t bit0 = (uint32_t)(a & 3u) * 8u + head * BITS;
  return {reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3) + (bit0 >> 5),
          bit0 & 31u};
}

// Four CTAs of 256 threads on an SM (at most 64 registers), three at 1 bit,
// where a tile holds 32 values of y a lane
template <typename T, int BITS, int M>
__global__ void __launch_bounds__(kThreads, BITS == 1 ? 3 : 4)
    decode_reduce_kernel(const uint8_t* __restrict__ p_self,
                         const uint8_t* __restrict__ p_nbrs,
                         const T* __restrict__ y, T* __restrict__ out,
                         int64_t rows, uint32_t cols, uint32_t pcols,
                         Weights w, const float* __restrict__ B_ptr) {
  using S = Shape<BITS>;
  constexpr uint32_t VPB = S::VPB, SSE = S::SSE, SPT = S::SPT;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float table[1 << BITS];
  const float B = *B_ptr;
  for (uint32_t c = threadIdx.x; c < (1u << BITS); c += blockDim.x)
    table[c] = value_of<BITS>(c, B);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t nwarps = blockDim.x >> 5;
  const uint32_t gwarp = blockIdx.x * nwarps + (threadIdx.x >> 5);
  const uint32_t wstride = gridDim.x * nwarps;
  const int64_t plane = rows * (int64_t)pcols;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* yr = y + row * cols;
    T* outr = out + row * cols;
    auto prow = [&](int k) {
      return (k == 0 ? p_self : p_nbrs + (k - 1) * plane) + row * pcols;
    };
    // body: from the first column where y and out are 4-element aligned,
    // whole super-steps
    const uint32_t ymis =
        (uint32_t)(reinterpret_cast<uintptr_t>(yr) / sizeof(T)) & 3u;
    const uint32_t omis =
        (uint32_t)(reinterpret_cast<uintptr_t>(outr) / sizeof(T)) & 3u;
    uint32_t head = (4u - ymis) & 3u;
    uint32_t nss = 0;
    if (ymis == omis && head < cols) nss = (cols - head) / SSE;
    if (nss == 0) head = 0;
    const uint32_t body_end = head + nss * SSE;

    for (uint32_t t = gwarp; t * SPT < nss; t += wstride) {
      // every load of the tile first: y, and each payload's word
      float yv[SPT][VPB][4];
      uint32_t pw[SPT][M + 1];
#pragma unroll
      for (uint32_t s = 0; s < SPT; ++s) {
        const uint32_t ss = t * SPT + s;
        if (ss < nss) {
#pragma unroll
          for (int k = 0; k <= M; ++k)
            pw[s][k] =
                __ldg(payload_row<BITS>(prow(k), head).words + 32 * ss + lane);
          const T* ys = yr + head + ss * SSE + 4 * lane;
#pragma unroll
          for (uint32_t j = 0; j < VPB; ++j) load4(ys + 128 * j, yv[s][j]);
        }
      }
#pragma unroll
      for (uint32_t s = 0; s < SPT; ++s) {
        const uint32_t ss = t * SPT + s;
        if (ss >= nss) break;
        // a payload whose codes do not start on a word boundary: the lane's
        // 32 bits straddle its word and the next (lane 31 loads that one)
#pragma unroll
        for (int k = 0; k <= M; ++k) {
          const PayloadRow pr = payload_row<BITS>(prow(k), head);
          if (pr.shift != 0) {
            uint32_t hi = __shfl_down_sync(kFull, pw[s][k], 1);
            if (lane == 31) hi = __ldg(pr.words + 32 * ss + 32);
            pw[s][k] = __funnelshift_r(pw[s][k], hi, pr.shift);
          }
        }
#pragma unroll
        for (uint32_t j = 0; j < VPB; ++j) {
          // this lane's 4 codes of each payload, in the low 4 * BITS bits
          uint32_t cw[M + 1];
#pragma unroll
          for (int k = 0; k <= M; ++k) {
            if constexpr (VPB == 1) {
              cw[k] = pw[s][k];
            } else {
              cw[k] = __shfl_sync(kFull, pw[s][k], 4 * BITS * j + lane / VPB)
                      >> (4 * BITS * (lane % VPB));
            }
          }
          float o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float qn[M];
#pragma unroll
            for (int k = 0; k < M; ++k)
              qn[k] = table[(cw[k + 1] >> (i * BITS)) & MASK];
            o[i] = mix<M>(yv[s][j][i], table[(cw[0] >> (i * BITS)) & MASK],
                          qn, w, B);
          }
          store4(outr + head + ss * SSE + 128 * j + 4 * lane, o);
        }
      }
    }

    // scalar path: head and tail columns, one thread per element
    const uint32_t nscalar = head + (cols - body_end);
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < nscalar;
         i += gridDim.x * blockDim.x) {
      const uint32_t c = i < head ? i : body_end + (i - head);
      const uint32_t b = c / VPB, sh = (c % VPB) * BITS;
      float qn[M];
#pragma unroll
      for (int k = 0; k < M; ++k) qn[k] = table[(prow(k + 1)[b] >> sh) & MASK];
      store1(outr, c,
             mix<M>(load1(yr, c), table[(prow(0)[b] >> sh) & MASK], qn, w, B));
    }
  }
}

template <typename T, int BITS, int M>
int launch_m(const uint8_t* p_self, const uint8_t* p_nbrs, const T* y,
             T* out, int64_t rows, int64_t cols, const Weights& w,
             const float* B, cudaStream_t stream) {
  using S = Shape<BITS>;
  const int64_t pcols = (cols + S::VPB - 1) / S::VPB;
  const int64_t tiles = (cols / S::SSE + S::SPT - 1) / S::SPT;  // at most
  int threads = kThreads;
  if (tiles == 0)  // a short row: only scalar elements, one thread each
    for (threads = 32; threads < cols && threads < kThreads;) threads *= 2;
  const int64_t warps = threads / 32;
  const int64_t bx = tiles > 0 ? (tiles + warps - 1) / warps : 1;
  const dim3 grid((unsigned)bx, (unsigned)(rows < 65535 ? rows : 65535));
  decode_reduce_kernel<T, BITS, M><<<grid, threads, 0, stream>>>(
      p_self, p_nbrs, y, out, rows, (uint32_t)cols, (uint32_t)pcols, w, B);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
int launch_bits(const uint8_t* p_self, const uint8_t* p_nbrs, const T* y,
                T* out, int64_t rows, int64_t cols, int m, const Weights& w,
                const float* B, cudaStream_t stream) {
  switch (m) {
#define CASE(M)                                                           \
  case M:                                                                 \
    return launch_m<T, BITS, M>(p_self, p_nbrs, y, out, rows, cols, w, B, \
                                stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const uint8_t* p_self, const uint8_t* p_nbrs, const T* y, T* out,
           int64_t rows, int64_t cols, int m, const Weights& w,
           const float* B, int bits, cudaStream_t stream) {
  if (rows == 0 || cols == 0) return 0;
  switch (bits) {
    case 1:
      return launch_bits<T, 1>(p_self, p_nbrs, y, out, rows, cols, m, w, B,
                               stream);
    case 2:
      return launch_bits<T, 2>(p_self, p_nbrs, y, out, rows, cols, m, w, B,
                               stream);
    case 4:
      return launch_bits<T, 4>(p_self, p_nbrs, y, out, rows, cols, m, w, B,
                               stream);
    case 8:
      return launch_bits<T, 8>(p_self, p_nbrs, y, out, rows, cols, m, w, B,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `weights` points to m
// float32 values on the host; they travel to the kernel by value.  `y` and
// `out` are float32 or, with y_is_bf16, bfloat16; `B` points to one float32
// on the device.  A row holds fewer than 2^31 columns (offsets inside a row
// are 32-bit).
extern "C" int moniqua_decode_reduce(const void* p_self, const void* p_nbrs,
                                     const void* y, int y_is_bf16, void* out,
                                     int64_t rows, int64_t cols, int m,
                                     const float* weights, const float* B,
                                     int bits, void* stream) {
  if (m < 1 || m > kMaxNeighbors || rows < 0 || cols < 0 ||
      cols >= kMaxCols)
    return (int)cudaErrorInvalidValue;
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
