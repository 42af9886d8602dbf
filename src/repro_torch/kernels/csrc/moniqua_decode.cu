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
// arithmetic (one IEEE division by B) stays below the card's issue rate.
//
// Design: the one-payload case of the decode-reduce kernel
// (moniqua_decode_reduce.cu), a streaming pass built for the memory system.
// - Grid: blockIdx.y is the row (rows past 65,535 loop), blockIdx.x and the
//   warp pick a tile of the row, at a 32-bit offset (a row holds fewer than
//   2^31 columns; kernels/ops.py cuts longer rows into windows).  Nothing on
//   the per-element path divides but the cmod's division by B, which stays
//   an IEEE division (__fdiv_rn) as in the plain version.
// - Vector body: a warp reads y in steps of 128 elements, each lane 4
//   consecutive ones with one 16-byte (float32) or 8-byte (bfloat16) load,
//   consecutive lanes on consecutive pieces, and writes out the same way.
//   A super-step is vpb steps, 128 * vpb elements, whose codes fill 128
//   bytes of the payload: the warp reads them as one 4-byte word per lane,
//   consecutive lanes on consecutive words.  At 8 bits a lane's word holds
//   the codes of its own 4 elements; below, each step fetches the lane's 4
//   codes from the lane that loaded them (a shuffle).  A warp tile is 4
//   steps (8 at 1 bit): a lane issues all its loads of the tile, 64 bytes
//   of y in float32, before it computes.
// - Alignment: the body starts at the first column where y (and out) is
//   aligned for the vector access.  A payload row may start anywhere, even
//   inside a byte or a word (rows of any length, a payload 1-3 bytes into
//   its buffer): each lane loads the aligned word holding its first code,
//   takes the next one from its neighbour lane (lane 31 loads it), and
//   funnel-shifts the two.  Head and tail columns, and rows whose out is
//   aligned unlike y, take a scalar path: one thread per element.
// - Arithmetic: a code's value is one of 2^bits floats, so each CTA builds
//   them in shared memory from B, multiplying by 2^-bits where the plain
//   version divides by 2^bits (the same float: the quotient is exact).  The
//   _rn intrinsics (and the build's -fmad=false) keep every multiply and add
//   separately rounded, so the result equals the plain PyTorch version bit
//   for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int64_t kMaxCols = (int64_t)1 << 31;

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

// Line 5 (remote) or line 4 (self) for one element of value qb
template <bool SELF>
__device__ __forceinline__ float decode1(float yv, float qb, float B) {
  if (SELF) return __fadd_rn(__fsub_rn(qb, cmod(yv, B)), yv);
  return __fadd_rn(cmod(__fsub_rn(qb, yv), B), yv);
}

// A super-step is 128 * vpb elements: 128 bytes of payload, one 4-byte
// word per lane.  A warp tile is the super-steps whose loads a lane issues
// before it computes: 4 steps (8 at 1 bit).
template <int BITS>
struct Shape {
  static constexpr uint32_t VPB = 8 / BITS;
  static constexpr uint32_t SSE = 128 * VPB;  // elements a super-step
  // super-steps a tile
  static constexpr uint32_t SPT = VPB >= 4 ? 1 : 4 / VPB;
};

// Four CTAs of 256 threads on an SM (at most 64 registers), three at 1 bit,
// where a tile holds 32 values of y a lane
template <typename T, int BITS, bool SELF>
__global__ void __launch_bounds__(kThreads, BITS == 1 ? 3 : 4)
    decode_kernel(const uint8_t* __restrict__ packed,
                  const T* __restrict__ y, T* __restrict__ out, int64_t rows,
                  uint32_t cols, uint32_t pcols,
                  const float* __restrict__ B_ptr) {
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
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* yr = y + row * cols;
    T* outr = out + row * cols;
    const uint8_t* pr = packed + row * pcols;
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
    // the aligned word holding the body's first code, and that code's bit
    // offset in it
    const uintptr_t pa = reinterpret_cast<uintptr_t>(pr);
    const uint32_t bit0 = (uint32_t)(pa & 3u) * 8u + head * BITS;
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(pa & ~(uintptr_t)3) + (bit0 >> 5);
    const uint32_t shift = bit0 & 31u;

    for (uint32_t t = gwarp; t * SPT < nss; t += wstride) {
      // every load of the tile first: y, and the payload's word
      float yv[SPT][VPB][4];
      uint32_t pw[SPT];
#pragma unroll
      for (uint32_t s = 0; s < SPT; ++s) {
        const uint32_t ss = t * SPT + s;
        if (ss < nss) {
          pw[s] = __ldg(words + 32 * ss + lane);
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
        if (shift != 0) {
          uint32_t hi = __shfl_down_sync(kFull, pw[s], 1);
          if (lane == 31) hi = __ldg(words + 32 * ss + 32);
          pw[s] = __funnelshift_r(pw[s], hi, shift);
        }
#pragma unroll
        for (uint32_t j = 0; j < VPB; ++j) {
          // this lane's 4 codes, in the low 4 * BITS bits
          uint32_t cw;
          if constexpr (VPB == 1) {
            cw = pw[s];
          } else {
            cw = __shfl_sync(kFull, pw[s], 4 * BITS * j + lane / VPB) >>
                 (4 * BITS * (lane % VPB));
          }
          float o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[i] = decode1<SELF>(yv[s][j][i], table[(cw >> (i * BITS)) & MASK],
                                 B);
          store4(outr + head + ss * SSE + 128 * j + 4 * lane, o);
        }
      }
    }

    // scalar path: head and tail columns, one thread per element
    const uint32_t nscalar = head + (cols - body_end);
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < nscalar;
         i += gridDim.x * blockDim.x) {
      const uint32_t c = i < head ? i : body_end + (i - head);
      const uint32_t code = (pr[c / VPB] >> ((c % VPB) * BITS)) & MASK;
      store1(outr, c, decode1<SELF>(load1(yr, c), table[code], B));
    }
  }
}

template <typename T, int BITS, bool SELF>
int launch_bits(const uint8_t* packed, const T* y, T* out, int64_t rows,
                int64_t cols, const float* B, cudaStream_t stream) {
  using S = Shape<BITS>;
  const int64_t pcols = (cols + S::VPB - 1) / S::VPB;
  const int64_t tiles = (cols / S::SSE + S::SPT - 1) / S::SPT;  // at most
  int threads = kThreads;
  if (tiles == 0)  // a short row: only scalar elements, one thread each
    for (threads = 32; threads < cols && threads < kThreads;) threads *= 2;
  const int64_t warps = threads / 32;
  const int64_t bx = tiles > 0 ? (tiles + warps - 1) / warps : 1;
  const dim3 grid((unsigned)bx, (unsigned)(rows < 65535 ? rows : 65535));
  decode_kernel<T, BITS, SELF><<<grid, threads, 0, stream>>>(
      packed, y, out, rows, (uint32_t)cols, (uint32_t)pcols, B);
  return (int)cudaGetLastError();
}

template <typename T, bool SELF>
int launch_mode(const uint8_t* packed, const T* y, T* out, int64_t rows,
                int64_t cols, const float* B, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1:
      return launch_bits<T, 1, SELF>(packed, y, out, rows, cols, B, stream);
    case 2:
      return launch_bits<T, 2, SELF>(packed, y, out, rows, cols, B, stream);
    case 4:
      return launch_bits<T, 4, SELF>(packed, y, out, rows, cols, B, stream);
    case 8:
      return launch_bits<T, 8, SELF>(packed, y, out, rows, cols, B, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const uint8_t* packed, const T* y, T* out, int64_t rows,
           int64_t cols, const float* B, int bits, int self_mode,
           cudaStream_t stream) {
  if (rows == 0 || cols == 0) return 0;
  if (self_mode)
    return launch_mode<T, true>(packed, y, out, rows, cols, B, bits, stream);
  return launch_mode<T, false>(packed, y, out, rows, cols, B, bits, stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `y` and `out` are
// float32 or, with y_is_bf16, bfloat16; `B` points to one float32 on the
// device; self_mode selects line 4 (else line 5).  A row holds fewer than
// 2^31 columns (offsets inside a row are 32-bit).
extern "C" int moniqua_decode(const void* packed, const void* y,
                              int y_is_bf16, void* out, int64_t rows,
                              int64_t cols, const float* B, int bits,
                              int self_mode, void* stream) {
  if (rows < 0 || cols < 0 || cols >= kMaxCols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  if (y_is_bf16)
    return launch(p, static_cast<const __nv_bfloat16*>(y),
                  static_cast<__nv_bfloat16*>(out), rows, cols, B, bits,
                  self_mode, s);
  return launch(p, static_cast<const float*>(y), static_cast<float*>(out),
                rows, cols, B, bits, self_mode, s);
}
