// Flash-attention forward (online softmax) on CUDA cores, sm_90a: the
// route of every head dim that the tensor-core kernels do not instantiate
// (float32 and bfloat16 at head dims other than 64, 96 and 128).  No
// config of the model zoo has such a head dim (its attention runs at 64,
// 96 and 128); the reference's kernel takes any D <= 256, and so does this.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_fa_kernel) where
// the tensor-core kernels do not: at head dims 64, 96 and 128, bfloat16
// runs in flash_attention_tc.cu and float32 in flash_attention_f32tc.cu,
// whose 3xTF32 products (each operand split into two TF32 parts) keep
// float32's rtol = atol = 2e-5, which one TF32 pass cannot.  q [BH, Sq, D],
// k/v [BH/g, Sk, D], row-major, float32 or bfloat16 (all three the same), out
// [BH, Sq, D] in q's type; query row block bh reads KV block bh / g
// (grouped-query attention without a copy).  Per query row i and key j:
//   s_ij = (q_i . k_j) * scale in float32 from inputs upcast to float32,
//   valid: i < Sq, j < Sk and, when causal, j <= i and (window == 0 or
//   j > i - window); masked scores are the finite sentinel -1e30;
//   out_i = sum_j softmax_j(s_i) v_j, computed as the reference does:
//   running max m, denominator l and numerator acc, rescaled by
//   alpha = exp(m_old - m_new) at each key tile, then acc / max(l, 1e-30).
// The sentinel is finite on purpose: a row's first live tile may be fully
// masked (sliding window); it then adds p = exp(0) = 1 garbage, which the
// next valid tile wipes with alpha = exp(-1e30 - m) = 0.  -INFINITY would
// give NaN there.
//
// Bound: operations.  Causal attention at BH = 48, S = 4096, D = 128 does
// 4 * D flops for each of the ~403 M causal (i, j) pairs, 206 GFLOP: 3.1 ms
// at the float32 peak outside the tensor cores, and moves Q + K + V + O
// (402 MB in float32).
//
// Design (simple and right first): one CTA of 256 threads takes 64 query
// rows of one bh and walks the key tiles of 64 rows.  Q, K and V tiles are
// staged in dynamic shared memory as float32 (zero-padded past Sq, Sk and
// D; D is padded to 64, 128 or 256); the K tile's 16-byte chunks are
// XOR-swizzled by row so that the score loop reads it without bank
// conflicts.  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and,
// for the scores, keys tx + 16 j (i, j < 4): a 4 x 4 register tile.  Row
// max and sum reduce over the 16 lanes of a row with warp shuffles.  The
// probabilities go through shared memory to the P.V product, where the
// same thread owns the same 4 rows and columns 4 tx + 64 c of acc, so m, l
// and acc stay in registers for the whole sweep.  Key tiles past the causal
// frontier or wholly before the window are skipped, as the reference skips
// its blocks; ragged edges are masked in the kernel with no padded copies,
// and query rows past Sq are never written.  The CTAs with the most live
// tiles (the last query tiles) are launched first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockN + 1;  // probability tile row stride
constexpr float kNegInf = -1e30f;

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

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBlockM * DP + kBlockM * kPStride);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int64_t bh_count,
              int64_t group, int64_t sq, int64_t sk, int d, float scale,
              int causal, int64_t window, int64_t nq_blocks) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [64][DP]
  float* sK = sQ + kBlockM * DP;                // [64][DP], chunks swizzled
  float* sV = sK + kBlockN * DP;                // [64][DP]
  float* sP = sV + kBlockN * DP;                // [64][kPStride]
  constexpr int DC = DP / 64;                   // acc float4s per row

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // heaviest query tiles (most live key tiles under causal) first
  const int64_t qblk = nq_blocks - 1 - (int64_t)blockIdx.x / bh_count;
  const int64_t bh = (int64_t)blockIdx.x % bh_count;
  const int64_t q0 = qblk * kBlockM;
  const T* qg = q + bh * sq * d;
  const T* kg = k + (bh / group) * sk * d;  // GQA: this head's KV head
  const T* vg = v + (bh / group) * sk * d;

  for (int e = tid; e < kBlockM * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const int64_t iq = q0 + r;
    sQ[e] = (iq < sq && c < d) ? load_f32(qg, iq * d + c) : 0.0f;
  }

  float m[4], l[4], acc[4][DC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  const int64_t q_lo = q0, q_hi = q0 + kBlockM - 1;
  const int64_t nk = (sk + kBlockN - 1) / kBlockN;
  for (int64_t j = 0; j < nk; ++j) {
    const int64_t k_lo = j * kBlockN, k_hi = k_lo + kBlockN - 1;
    if (causal) {
      if (k_lo > q_hi) break;  // every later tile lies past the frontier
      if (window && k_hi <= q_lo - window) continue;
    }
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int e = tid; e < kBlockN * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      const int64_t jk = k_lo + r;
      const bool ok = jk < sk && c < d;
      sK[r * DP + (((c >> 2) ^ (r & 7)) << 2) + (c & 3)] =
          ok ? load_f32(kg, jk * d + c) : 0.0f;
      sV[e] = ok ? load_f32(vg, jk * d + c) : 0.0f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
    for (int c4 = 0; c4 < DP / 4; ++c4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * DP)[c4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = tx + 16 * jj;
        kv[jj] = reinterpret_cast<const float4*>(sK + r * DP)[c4 ^ (r & 7)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float a = s[i][jj];
          a = fmaf(qv[i].x, kv[jj].x, a);
          a = fmaf(qv[i].y, kv[jj].y, a);
          a = fmaf(qv[i].z, kv[jj].z, a);
          a = fmaf(qv[i].w, kv[jj].w, a);
          s[i][jj] = a;
        }
    }

    // mask, online softmax update, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t iq = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int64_t jk = k_lo + tx + 16 * jj;
        bool valid = iq < sq && jk < sk;
        if (causal) {
          valid = valid && jk <= iq;
          if (window) valid = valid && jk > iq - window;
        }
        s[i][jj] = valid ? s[i][jj] * scale : kNegInf;
        mt = fmaxf(mt, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        rs += p;
        sP[(ty + 16 * i) * kPStride + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    // acc += P V over the tile's 64 keys
#pragma unroll 4
    for (int kk = 0; kk < kBlockN; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 vv =
            reinterpret_cast<const float4*>(sV + kk * DP + 64 * c)[tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(p[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t iq = q0 + ty + 16 * i;
    if (iq >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * sq + iq) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < d) store(orow, col, acc[i][c][e] / den);
      }
  }
}

template <typename T, int DP>
int launch(const T* q, const T* k, const T* v, T* o, int64_t bh,
           int64_t group, int64_t sq, int64_t sk, int d, float scale,
           int causal, int64_t window, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_kernel<T, DP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int64_t nq = (sq + kBlockM - 1) / kBlockM;
  const int64_t blocks = nq * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fa_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, o, bh, group, sq, sk, d, scale, causal, window, nq);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t bh,
             int64_t group, int64_t sq, int64_t sk, int d, float scale,
             int causal, int64_t window, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (d <= 64)
    return launch<T, 64>(qt, kt, vt, ot, bh, group, sq, sk, d, scale, causal,
                         window, s);
  if (d <= 128)
    return launch<T, 128>(qt, kt, vt, ot, bh, group, sq, sk, d, scale, causal,
                          window, s);
  return launch<T, 256>(qt, kt, vt, ot, bh, group, sq, sk, d, scale, causal,
                        window, s);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  q, k, v, o are float32
// or, with is_bf16, bfloat16; q, o [bh, sq, d], k, v [bh_kv, sk, d] with
// bh_kv dividing bh; 1 <= d <= 256.  `window` is read only when `causal`
// is set.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int is_bf16, int64_t bh,
                               int64_t bh_kv, int64_t sq, int64_t sk, int d,
                               float scale, int causal, int64_t window,
                               void* stream) {
  if (d < 1 || d > 256 || bh < 0 || sq < 0 || sk < 0 || bh_kv < 1 ||
      bh % bh_kv)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, bh / bh_kv, sq, sk, d,
                                   scale, causal, window, s);
  return dispatch<float>(q, k, v, o, bh, bh / bh_kv, sq, sk, d, scale, causal,
                         window, s);
}
