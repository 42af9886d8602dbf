// Flash-attention forward in float32 on Hopper's tensor cores (3xTF32
// mma.sync), sm_90a: the float32 route at every head dim 1..256.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_fa_kernel) where
// the inputs are float32; bfloat16 takes flash_attention_tc.cu.  q [BH,
// Sq, d], k/v [BH/g, Sk, d], row-major float32, out [BH, Sq, d] float32,
// with d a multiple of 8 (the wrapper pads any other d to one with zero
// columns); query row block bh reads KV block bh / g (grouped-query
// attention without a copy).  The kernel is instantiated at D = 64, 96,
// 128, 192 and 256, and d runs at the smallest D >= d: columns d..D-1 of
// the staged tiles are zero-filled like rows past Sq or Sk, so they add
// exact zeros to every score, and only columns < d are stored.  Per query row i and key j, as the reference computes:
//   s_ij = (q_i . k_j) * scale in float32; valid: i < Sq, j < Sk and, when
//   causal, j + k0 <= i and (window == 0 or j + k0 > i - window), where
//   k0 >= 0 is the absolute position of key 0 (0 for a whole sequence; a
//   context-parallel rank's first key of its share); masked scores are
//   the finite sentinel -1e30; running max m, denominator l and numerator
//   acc, rescaled by alpha at each key tile; out = acc / max(l, 1e-30).
//   (A row's first live tile may be fully masked: it adds exp(0) = 1
//   garbage that the next valid tile wipes with alpha = 0.)  The softmax is
//   taken in base 2, on s_ij * log2(e), which is the same function.  A row
//   with no valid key at all (possible only at k0 > 0) gets out = 0.
//   With `lse` given, the kernel also writes lse[bh, i], float32, the
//   natural-log log-sum-exp of the row's valid scaled scores,
//   ln sum_j exp(s_ij) = m2 ln 2 + ln l from the base-2 running max m2 and
//   sum l; -inf for a row with no valid key: what a merge of the shares of
//   the keys needs (out = sum_r exp(lse_r - lse) out_r).  At k0 = 0
//   without lse the kernel computes what it computed before either
//   existed, bit for bit.
//
// Precision.  One TF32 product keeps 11 significant bits of each operand,
// which cannot meet float32's rtol = atol = 2e-5.  3xTF32 does: each operand
// x splits as hi = tf32(x) (cvt.rna's rounding: to nearest, ties away) and
// lo = tf32(x - hi), and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b,
// three mma.sync with float32 accumulation, the small terms first.  What is
// dropped (lo_a lo_b and the rounding of each lo) is about 2^-21 of |a b|.
// Both products, S = Q K^T and O += P V, are taken this way.
//
// Bound: operations.  Causal attention at BH = 48, S = 4096, D = 128 does
// 4 * D flops for each of the ~403 M causal (i, j) pairs, 206 GFLOP; 3xTF32
// issues three times that on the tensor cores: 1.25 ms at the dense TF32
// peak (495 TFLOP/s, which only wgmma reaches; mma.sync tops out near 320
// TFLOP/s on an NVIDIA H100 80GB HBM3 at 700 W, tools/mma_rate.py).
// Q + K + V + O are 402 MB.
//
// Design (right and simple first; wgmma is a later step).
// - A CTA is BM / 16 warps and takes BM query rows of one bh, 16 rows a
//   warp, and walks the live key tiles of BN keys: BM = BN = 64 (4 warps)
//   up to D = 128.  Past it Q, K and V tiles of 64 rows leave room for one
//   CTA of 4 warps an SM, so BM = 128 (8 warps, each K and V tile read by
//   twice the rows): BN = 64 at D = 192 (196 KB), BN = 32 at D = 256
//   (195 KB; 64 keys would not fit).  Measured at [16, 4096, D] causal
//   (PERF.md): at 192, 1.994 ms against 2.19 with BN = 32 and 2.42 with
//   BM = BN = 64; at 256, 2.886 against 3.30 with BM = BN = 64 and 3.70
//   with BM = 64, BN = 32.  Key tiles past the causal
//   frontier or wholly before the window are skipped; the CTAs with the
//   most live tiles (the last query tiles, at every k0) are launched first.
// - Q (once) and each K and V tile are staged in shared memory with
//   cp.async (16-byte copies, rows past Sq or Sk and columns past d
//   zero-filled), one stage:
//   at D = 128 a CTA holds 101 KB (77 KB at D = 96), so two CTAs share an
//   SM and one computes while the other loads (two stages would leave room
//   for one CTA).  Rows are padded to D + 4 floats, so that every fragment
//   load below hits 32 different banks: D + 4 is 4 mod 32 at each head dim
//   (68, 100, 132, 196, 260), so K's (row g, column t) lands in bank 4 g + t
//   and V's
//   (row 2 t, column g) in bank 8 t + g.
// - Fragments are read from shared memory with plain 32-bit loads, as
//   mma.sync m16n8k8 lays them out, and split as they are loaded.  (Split
//   once a tile at staging, the four warps would split each value once,
//   not four times, but read twice the bytes, and the doubled tiles leave
//   room for one CTA an SM: that was slower on the card, PERF.md.)
// - S's C fragments stay in registers for the online softmax: a thread
//   holds two rows, and the row max reduces over the 4 lanes of a quad (the
//   row sum once, at the end).
// - P V without a round trip: the C fragment of an n-block of S holds keys
//   2t and 2t + 1 of the block in thread t of a quad, and the A fragment of
//   m16n8k8 wants k indices t and t + 4.  So P V takes the block's keys in
//   the order (0, 2, 4, 6, 1, 3, 5, 7): k index t is key 2t, k index t + 4
//   key 2t + 1, and the V fragment reads rows 2t and 2t + 1.  P's C
//   fragment is then its A fragment, register for register.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// head dim D, BM query rows (BM / 16 warps), BN keys a tile
template <int D, int BM, int BN>
struct Tile {
  static constexpr int kThreads = 2 * BM;           // 16 rows a warp
  static constexpr int ST = D + 4;                  // row stride, floats
  static constexpr int QT = BM * ST;                // the Q tile
  static constexpr int MAT = BN * ST;               // one K or V tile
  static constexpr size_t SMEM = sizeof(float) * (QT + 2 * MAT);  // Q, K, V
  // CTAs an SM can hold by shared memory (227 KB a block, 228 KB an SM)
  static constexpr int kMinBlocks = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
};

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, to 10
// mantissa bits) done on the bits: adding half of the 13 dropped bits
// carries into the kept ones exactly when the dropped part is at least
// half.  The same value for every finite x and for infinities, in two
// integer instructions; the instruction itself compiles to more (a NaN
// test and a select besides), and the kernel rounds twice for every value
// it splits.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b on one m16n8k8 tile, TF32 operands, float32 accumulation
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += (ah + al)(bh + bl) without al bl, the small products first
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma(c, al, bh[0], bh[1]);
  mma(c, ah, bl[0], bl[1]);
  mma(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ROWS rows from row r0 of a [rows, d] matrix into a tile of D + 4 columns
// a row; rows at or past `limit` and columns at or past d are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int limit, int d,
                                          int tid) {
  for (int c = tid; c < ROWS * D / 4; c += THREADS) {
    const int r = c / (D / 4), c4 = c % (D / 4);
    const bool ok = r0 + r < limit && 4 * c4 < d;
    cp_async16(dst + r * (D + 4) + 4 * c4,
               src + (ok ? (int64_t)(r0 + r) * d + 4 * c4 : 0), ok);
  }
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(Tile<D, BM, BN>::kThreads,
                                  Tile<D, BM, BN>::kMinBlocks)
    fa_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int64_t bh_count, int64_t group,
                    int64_t sq, int64_t sk, int d, float scale, int causal,
                    int64_t window, int k0, int64_t nq_blocks) {
  using T = Tile<D, BM, BN>;
  constexpr int ST = T::ST;
  constexpr int KS = D / 8;        // k-steps of S = Q K^T
  constexpr int NB = BN / 8;       // n-blocks of S, k-steps of P V
  constexpr int ND = D / 8;        // n-blocks of O
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + T::QT;
  float* sV = sK + T::MAT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // heaviest query tiles (most live key tiles under causal) first
  const int64_t qblk = nq_blocks - 1 - (int64_t)blockIdx.x / bh_count;
  const int64_t bh = (int64_t)blockIdx.x % bh_count;
  const int q0 = (int)(qblk * BM);
  const int sq32 = (int)sq, sk32 = (int)sk, w32 = (int)window;
  const float* kg = k + (bh / group) * sk * d;  // GQA: this head's KV head
  const float* vg = v + (bh / group) * sk * d;

  // the CTA's query rows q_lo..q_hi, its rows below Sq and this warp's
  // rows g and g + 8 of its 16 (row0, row1) in key coordinates, less
  // k0: key j (at position j + k0) is valid for a row at r when j <= r
  // (and j > r - window), so the loop below is the kernel's loop without
  // an offset
  const int q_lo = q0 - k0, q_hi = q_lo + BM - 1, sq_k = sq32 - k0;
  // the live key tiles [j_begin, j_end)
  const int nk = (sk32 + BN - 1) / BN;
  int j_begin = 0, j_end = nk;
  if (causal) {
    j_end = q_hi < 0 ? 0 : (q_hi / BN + 1 < nk ? q_hi / BN + 1 : nk);
    const int first = q_lo - w32 + 1;  // the first key row q_lo sees
    if (w32 && first > 0) j_begin = first / BN;
  }

  load_rows<D, BM, T::kThreads>(sQ, q + bh * sq * d, q0, sq32, d, tid);
  const int row0 = q_lo + warp * 16 + g, row1 = row0 + 8;
  const float* qw = sQ + (warp * 16 + g) * ST + t;
  const float scale2 = scale * kLog2e;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int j = j_begin; j < j_end; ++j) {
    const int k_lo = j * BN;
    load_rows<D, BN, T::kThreads>(sK, kg, k_lo, sk32, d, tid);
    load_rows<D, BN, T::kThreads>(sV, vg, k_lo, sk32, d, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T: A fragment (m = g, g + 8; k = t, t + 4) is Q[g][8 kk + t],
    // B fragment (k = t, t + 4; n = g) is K[8 n + g][8 kk + t]
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      split(qw[8 * kk], ah[0], al[0]);
      split(qw[8 * ST + 8 * kk], ah[1], al[1]);
      split(qw[8 * kk + 4], ah[2], al[2]);
      split(qw[8 * ST + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int i = (8 * n + g) * ST + 8 * kk + t;
        uint32_t bh[2], bl[2];
        split(sK[i], bh[0], bl[0]);
        split(sK[i + 4], bh[1], bl[1]);
        mma3(s[n], ah, al, bh, bl);
      }
    }

    // scale (into base 2) and mask; element e of block n is row
    // (e < 2 ? row0 : row1), key k_lo + 8 n + 2 t + (e & 1)
    const bool whole = k_lo + BN <= sk32 && q_hi < sq_k &&
                       (!causal || (k_lo + BN - 1 <= q_lo &&
                                    (!w32 || k_lo > q_hi - w32)));
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool valid = true;
        if (!whole) {
          const int iq = e < 2 ? row0 : row1;
          const int jk = k_lo + 8 * n + 2 * t + (e & 1);
          valid = iq < sq_k && jk < sk32;
          if (causal) {
            valid = valid && jk <= iq;
            if (w32) valid = valid && jk > iq - w32;
          }
        }
        s[n][e] = valid ? s[n][e] * scale2 : kNegInf;
      }

    // online softmax on rows row0 (r = 0) and row1 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = kNegInf;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        mt = fmaxf(mt, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - m_new);
          rs += s[n][e];
        }
      l[r] = l[r] * alpha + rs;  // this thread's share; the quad sums later
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // acc += P V, key block n as k-step: k index t is key 8 n + 2 t, k index
    // t + 4 key 8 n + 2 t + 1, so P's C fragment is its A fragment
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint32_t ah[4], al[4];
      split(s[n][0], ah[0], al[0]);
      split(s[n][2], ah[1], al[1]);
      split(s[n][1], ah[2], al[2]);
      split(s[n][3], ah[3], al[3]);
      const int i0 = (8 * n + 2 * t) * ST + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bh[2], bl[2];
        split(sV[i0 + 8 * nd], bh[0], bl[0]);
        split(sV[i0 + ST + 8 * nd], bh[1], bl[1]);
        mma3(acc[nd], ah, al, bh, bl);
      }
    }
    __syncthreads();  // every read of K and V is done before their refill
  }
  cp_async_wait_all();  // Q's copy, when no key tile was live

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int iq = (r ? row1 : row0) + k0;  // back to the query's row
    if (iq >= sq32) continue;
    // a row whose max is still the sentinel saw no valid key: out = 0
    const float den = m[r] == kNegInf ? INFINITY : fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[bh * sq + iq] = m[r] == kNegInf
                              ? -INFINITY
                              : m[r] * 0.6931471805599453f + logf(l[r]);
    float* orow = o + (bh * sq + iq) * d + 2 * t;
    // columns 8 n + 2 t and + 1 lie both below d or both past it (8 | d)
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (8 * n + 2 * t < d)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

template <int D, int BM, int BN>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int64_t bh, int64_t group, int64_t sq, int64_t sk,
           int d, float scale, int causal, int64_t window, int k0,
           cudaStream_t stream) {
  using T = Tile<D, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32tc_kernel<D, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int64_t nq = (sq + BM - 1) / BM;
  const int64_t blocks = nq * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fa_f32tc_kernel<D, BM, BN><<<(unsigned)blocks, T::kThreads, T::SMEM,
                               stream>>>(q, k, v, o, lse, bh, group, sq, sk,
                                         d, scale, causal, window, k0, nq);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  q, k, v, o are float32,
// 16-byte aligned; q, o [bh, sq, d], k, v [bh_kv, sk, d] with bh_kv dividing
// bh; d is a multiple of 8 up to 256.  `window` and `k0` (key 0's position,
// >= 0) are read only when `causal` is set.  `lse` is null or float32
// [bh, sq].
extern "C" int flash_attention_f32tc(const void* q, const void* k,
                                     const void* v, void* o, int64_t bh,
                                     int64_t bh_kv, int64_t sq, int64_t sk,
                                     int d, float scale, int causal,
                                     int64_t window, int64_t k0, void* lse,
                                     void* stream) {
  // rows and key indices are 32-bit inside the kernel (int64_t ones took
  // the registers that the D = 256 instantiation spilled)
  constexpr int64_t kMaxRows = 0x7fffffffLL - 2 * 128;
  if (bh < 0 || sq < 0 || sk < 0 || bh_kv < 1 || bh % bh_kv ||
      sq > kMaxRows || sk > kMaxRows || window < 0 || k0 < 0 ||
      k0 > kMaxRows - sk || k0 > kMaxRows - sq)
    return (int)cudaErrorInvalidValue;
  if (d < 8 || d > 256 || d % 8) return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  // a window wider than every query row's reach masks nothing more (key
  // positions are >= 0)
  const int64_t w = causal && window ? (window < sq + 1 ? window : sq + 1)
                                     : 0;
  const int kk0 = causal ? (int)k0 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(o);
  float* lt = static_cast<float*>(lse);
  const int64_t g = bh / bh_kv;
  // <D, query rows, key tile> at the smallest D >= d
  if (d <= 64)
    return launch<64, 64, 64>(qt, kt, vt, ot, lt, bh, g, sq, sk, d, scale,
                              causal, w, kk0, s);
  if (d <= 96)
    return launch<96, 64, 64>(qt, kt, vt, ot, lt, bh, g, sq, sk, d, scale,
                              causal, w, kk0, s);
  if (d <= 128)
    return launch<128, 64, 64>(qt, kt, vt, ot, lt, bh, g, sq, sk, d, scale,
                               causal, w, kk0, s);
  if (d <= 192)
    return launch<192, 128, 64>(qt, kt, vt, ot, lt, bh, g, sq, sk, d, scale,
                                causal, w, kk0, s);
  return launch<256, 128, 32>(qt, kt, vt, ot, lt, bh, g, sq, sk, d, scale,
                              causal, w, kk0, s);
}
