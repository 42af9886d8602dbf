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
// The counter index of column c of row r is, with w = r % rows_per_worker,
//   idx_base + (w / rows_per_block) * block_stride
//            + (w % rows_per_block) * idx_row_stride + c        (uint32)
// so it restarts for every worker: all workers draw the same uniform for the
// same element (shared randomness, paper Supp. C).  The caller's stride is
// ceil(cols / vpb) * vpb for a whole leaf, with one block of every row
// (rows_per_block = rows_per_worker, block_stride 0); a shard of a leaf
// split on one of its dims passes the whole leaf's row step, and one split
// on two dims also blocks of rows with the whole leaf's step between them
// (a layer of a stacked leaf), so that it hashes the indices the whole leaf
// hashes.
//
// Bound: device memory.  Each element is read once (4 bytes f32 or 2 bf16)
// and bits/8 bytes are written, with a few dozen integer and float
// operations per element, below the card's issue rate.
//
// Design: a streaming pass built for the memory system.
// - Grid: blockIdx.y is the row (rows past 65,535 loop), blockIdx.x and the
//   warp pick a tile of the row, at a 32-bit offset; the worker's counter
//   base is computed once per row.  Nothing on the per-element path divides
//   but x / B, which stays an IEEE division (__fdiv_rn) as in the plain
//   version.
// - Vector body: a warp reads x in steps of 128 elements, each lane 4
//   consecutive ones with one 16-byte (float32) or 8-byte (bfloat16) load,
//   consecutive lanes on consecutive pieces.  A super-step is vpb steps:
//   128 * vpb elements whose 128 payload bytes the warp writes as one
//   4-byte word per lane, also consecutive.  At 8 bits a lane's 4 codes are
//   its word; below, the lanes of a group of vpb OR their codes together
//   with shuffles and the word moves to the lane that stores it.  A lane
//   issues all loads of its warp tile (2 steps at 8 bits, one super-step of
//   2, 4 or 8 steps below) before it computes, and four CTAs share an SM.
// - Alignment: the body starts at the first column where x is aligned for
//   the vector load and a byte starts.  If the payload is not 4-byte
//   aligned there, each lane stores the aligned word spanning its
//   neighbour's and its own bytes (a funnel shift), and the two ragged ends
//   of each super-step go out as bytes.  Head and tail columns, and rows
//   whose x alignment and byte boundaries cannot meet (a row start that is
//   not a multiple of 4 elements, below 8 bits), take a scalar path: one
//   thread per payload byte.
// - Arithmetic: the _rn intrinsics (and the build's -fmad=false) keep every
//   multiply and add separately rounded, so the bytes are those of the plain
//   version.  The payload is written once and not read back by this pass:
//   the word stores are streaming (st.global.cs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int64_t kMaxCols = (int64_t)1 << 31;

// Four consecutive elements: one 16-byte (float32) or 8-byte (bfloat16)
// load of an address aligned to it.
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
__device__ __forceinline__ float load1(const float* p, uint32_t i) {
  return p[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p, uint32_t i) {
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

// Store one super-step's 128 payload bytes, lane l holding bytes [4l, 4l+4)
// of it in `word`; `k` is the misalignment of `dst` within a 4-byte word.
__device__ __forceinline__ void store_words(uint8_t* dst, int lane,
                                            uint32_t word, uint32_t k) {
  uint8_t* a = dst + 4 * lane;
  if (k == 0) {
    __stcs(reinterpret_cast<unsigned int*>(a), word);
    return;
  }
  // the aligned word at a - k holds the last k bytes of lane l-1's word and
  // the first 4-k of lane l's; lane 0's first and lane 31's last bytes are
  // the ragged ends
  const uint32_t prev = __shfl_up_sync(kFull, word, 1);
  if (lane > 0)
    __stcs(reinterpret_cast<unsigned int*>(a - k),
           __funnelshift_r(prev, word, 8 * (4 - k)));
  if (lane == 0)
    for (uint32_t b = 0; b < 4 - k; ++b) a[b] = (uint8_t)(word >> (8 * b));
  if (lane == 31)
    for (uint32_t b = 4 - k; b < 4; ++b) a[b] = (uint8_t)(word >> (8 * b));
}

// A super-step is 128 * vpb elements, whose 128 payload bytes a warp writes
// as one 4-byte word per lane.  A warp tile is the super-steps whose loads a
// lane issues before it computes: 2 steps at 8 bits, one super-step below.
template <int BITS>
struct Shape {
  static constexpr uint32_t VPB = 8 / BITS;
  static constexpr uint32_t SSE = 128 * VPB;      // elements a super-step
  static constexpr uint32_t SPT = VPB == 1 ? 2 : 1;  // super-steps a tile
};

// Four CTAs of 256 threads on an SM: at most 64 registers
template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads, 4)
    encode_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                  int64_t rows, int64_t rows_per_worker, uint32_t cols,
                  uint32_t pcols, const float* __restrict__ B_ptr,
                  uint32_t seed, uint32_t idx_base, uint32_t idx_row_stride,
                  int64_t rows_per_block, uint32_t block_stride,
                  int stochastic) {
  using S = Shape<BITS>;
  constexpr uint32_t VPB = S::VPB, SSE = S::SSE, SPT = S::SPT;
  constexpr uint32_t GROUPS = 32 / VPB;               // words a step makes
  const float B = *B_ptr;
  const bool st = stochastic != 0;
  const int lane = threadIdx.x & 31;
  const uint32_t nwarps = blockDim.x >> 5;
  const uint32_t gwarp = blockIdx.x * nwarps + (threadIdx.x >> 5);
  const uint32_t wstride = gridDim.x * nwarps;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + row * cols;
    uint8_t* outr = out + row * pcols;
    const int64_t wrow = row % rows_per_worker;
    const uint32_t ibase =
        idx_base + (uint32_t)(wrow / rows_per_block) * block_stride +
        (uint32_t)(wrow % rows_per_block) * idx_row_stride;
    // body: from the first column where x is 4-element aligned and a byte
    // starts, whole super-steps
    const uint32_t xmis =
        (uint32_t)(reinterpret_cast<uintptr_t>(xr) / sizeof(T)) & 3u;
    uint32_t head = (4u - xmis) & 3u;
    uint32_t nss = 0;
    if ((head & (VPB - 1)) == 0 && head < cols) nss = (cols - head) / SSE;
    if (nss == 0) head = 0;
    const uint32_t body_end = head + nss * SSE;
    uint8_t* pbody = outr + head / VPB;
    const uint32_t k = (uint32_t)reinterpret_cast<uintptr_t>(pbody) & 3u;

    for (uint32_t t = gwarp; t * SPT < nss; t += wstride) {
      // every load of the tile first
      float xv[SPT][VPB][4];
#pragma unroll
      for (uint32_t s = 0; s < SPT; ++s) {
        if (t * SPT + s < nss) {
          const T* xs = xr + head + (t * SPT + s) * SSE + 4 * lane;
#pragma unroll
          for (uint32_t j = 0; j < VPB; ++j) load4(xs + 128 * j, xv[s][j]);
        }
      }
#pragma unroll
      for (uint32_t s = 0; s < SPT; ++s) {
        const uint32_t ss = t * SPT + s;
        if (ss >= nss) break;
        uint32_t word = 0;
#pragma unroll
        for (uint32_t j = 0; j < VPB; ++j) {
          const uint32_t c0 = head + ss * SSE + 128 * j + 4 * lane;
          uint32_t p = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p |= code_of<BITS>(xv[s][j][i], B, st, seed, ibase + c0 + i)
                 << (i * BITS);
          if constexpr (VPB == 1) {
            word = p;
          } else {
            // the vpb lanes of a group hold one word's codes: OR them, then
            // hand word g of step j to lane j * GROUPS + g
            p <<= 4 * BITS * (lane % VPB);
#pragma unroll
            for (uint32_t o = 1; o < VPB; o <<= 1)
              p |= __shfl_xor_sync(kFull, p, o);
            const uint32_t v = __shfl_sync(kFull, p, (lane % GROUPS) * VPB);
            if (lane / GROUPS == j) word = v;
          }
        }
        store_words(pbody + ss * 128, lane, word, k);
      }
    }

    // scalar path: head and tail bytes, one thread per byte
    const uint32_t hb = head / VPB, tb = body_end / VPB;
    const uint32_t nscalar = hb + (pcols - tb);
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < nscalar;
         i += gridDim.x * blockDim.x) {
      const uint32_t b = i < hb ? i : tb + (i - hb);
      uint32_t byte = 0;
#pragma unroll
      for (uint32_t s = 0; s < VPB; ++s) {
        const uint32_t c = b * VPB + s;
        const float xv = c < cols ? load1(xr, c) : 0.0f;
        byte |= code_of<BITS>(xv, B, st, seed, ibase + c) << (s * BITS);
      }
      outr[b] = (uint8_t)byte;
    }
  }
}

template <typename T, int BITS>
int launch_bits(const T* x, uint8_t* out, int64_t rows,
                int64_t rows_per_worker, int64_t cols, const float* B,
                uint32_t seed, uint32_t idx_base, uint32_t idx_row_stride,
                int64_t rows_per_block, uint32_t block_stride, int stochastic,
                cudaStream_t stream) {
  using S = Shape<BITS>;
  const int64_t pcols = (cols + S::VPB - 1) / S::VPB;
  const int64_t tiles = (cols / S::SSE + S::SPT - 1) / S::SPT;  // at most
  int threads = kThreads;
  if (tiles == 0)  // a short row: only scalar bytes, one thread each
    for (threads = 32; threads < pcols && threads < kThreads;) threads *= 2;
  const int64_t warps = threads / 32;
  const int64_t bx = tiles > 0 ? (tiles + warps - 1) / warps : 1;
  const dim3 grid((unsigned)bx, (unsigned)(rows < 65535 ? rows : 65535));
  encode_kernel<T, BITS><<<grid, threads, 0, stream>>>(
      x, out, rows, rows_per_worker, (uint32_t)cols, (uint32_t)pcols, B, seed,
      idx_base, idx_row_stride, rows_per_block, block_stride, stochastic);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, uint8_t* out, int64_t rows, int64_t rows_per_worker,
           int64_t cols, const float* B, uint32_t seed, uint32_t idx_base,
           uint32_t idx_row_stride, int64_t rows_per_block,
           uint32_t block_stride, int bits, int stochastic,
           cudaStream_t stream) {
  if (rows == 0 || cols == 0) return 0;
  switch (bits) {
    case 1:
      return launch_bits<T, 1>(x, out, rows, rows_per_worker, cols, B, seed,
                               idx_base, idx_row_stride, rows_per_block,
                               block_stride, stochastic, stream);
    case 2:
      return launch_bits<T, 2>(x, out, rows, rows_per_worker, cols, B, seed,
                               idx_base, idx_row_stride, rows_per_block,
                               block_stride, stochastic, stream);
    case 4:
      return launch_bits<T, 4>(x, out, rows, rows_per_worker, cols, B, seed,
                               idx_base, idx_row_stride, rows_per_block,
                               block_stride, stochastic, stream);
    case 8:
      return launch_bits<T, 8>(x, out, rows, rows_per_worker, cols, B, seed,
                               idx_base, idx_row_stride, rows_per_block,
                               block_stride, stochastic, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `x` is float32 or, with
// x_is_bf16, bfloat16; `B` points to one float32 on the device.  A row holds
// fewer than 2^31 columns (offsets inside a row are 32-bit).  The counter
// index of column c of row r is, with w = r % rows_per_worker,
// idx_base + (w / rows_per_block) * block_stride + (w % rows_per_block) *
// idx_row_stride + c, mod 2^32.
extern "C" int moniqua_encode(const void* x, int x_is_bf16, void* out,
                              int64_t rows, int64_t rows_per_worker,
                              int64_t cols, const float* B, uint32_t seed,
                              uint32_t idx_base, uint32_t idx_row_stride,
                              int64_t rows_per_block, uint32_t block_stride,
                              int bits, int stochastic, void* stream) {
  if (rows_per_worker < 1 || rows_per_block < 1 || rows < 0 || cols < 0 ||
      cols >= kMaxCols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (x_is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), o, rows,
                  rows_per_worker, cols, B, seed, idx_base, idx_row_stride,
                  rows_per_block, block_stride, bits, stochastic, s);
  return launch(static_cast<const float*>(x), o, rows, rows_per_worker, cols,
                B, seed, idx_base, idx_row_stride, rows_per_block,
                block_stride, bits, stochastic, s);
}
