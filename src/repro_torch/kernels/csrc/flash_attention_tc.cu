// Flash-attention forward on Hopper's tensor cores (wgmma, TMA), sm_90a:
// the bfloat16 route at every head dim 1..256.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_fa_kernel) where
// the inputs are bfloat16; float32 inputs take flash_attention_f32tc.cu.
// q [BH, Sq, d], k/v [BH/g, Sk, d], row-major bfloat16, out [BH, Sq, D]
// bfloat16 (below), with d a multiple of 8 (the wrapper pads any other d
// to one with zero columns).  Query row block bh reads
// KV block bh / g: with heads folded (lead..., H) that is the reference's
// jnp.repeat of the KV heads, done here without a copy.  Per query row i
// and key j, as the reference computes:
//   s_ij = (q_i . k_j) * scale in float32 (exact bf16 products, float32
//   sums); valid: j < Sk and, when causal, j + k0 <= i and (window == 0 or
//   j + k0 > i - window), where k0 >= 0 is the absolute position of key 0
//   (0 for a whole sequence; a context-parallel rank's first key of its
//   share); masked scores are the finite sentinel -1e30; running
//   max m, denominator l and numerator acc, rescaled by
//   alpha = exp(m_old - m_new) at each key tile; out = acc / max(l, 1e-30).
//   A row with no valid key (possible only at k0 > 0) gets out = 0.
//   With `lse` given, the kernel also writes lse[bh, i], float32, the
//   natural-log log-sum-exp of the row's valid scaled scores:
//   ln sum_j exp(s_ij), from the base-2 running max and sum below as
//   m2 ln 2 + ln l; -inf for a row with no valid key.  These are what a
//   merge of the shares of the keys needs (out = sum_r exp(lse_r - lse)
//   out_r).  At k0 = 0 without lse the kernel computes what it computed
//   before either existed, bit for bit.
//
// Head dims.  The kernel is instantiated at D = 64, 96, 128, 192 and 256;
// d runs at the smallest D >= d.  The tensor maps span d columns, so TMA
// zero-fills the columns d..D-1 of every box as it does rows past Sq or
// Sk: the padded columns add exact zeros to every score, and the output's
// columns d..D-1 come out zero.  The output has D columns; the wrapper
// keeps the first d.  (Storing only columns < d, with d as the row stride,
// made the kernel 3.5% slower at D = 64 and 96 where d = D, PERF.md.)
//
// Bound: operations.  Causal attention at BH = 48, S = 4096, D = 128 does
// 4 * D flops for each of the ~403 M causal (i, j) pairs: 206 GFLOP, 0.21 ms
// at the bf16 tensor-core peak; Q + K + V + O are 134 MB with 16 KV heads
// (0.04 ms).  At phi-3-vision-4.2b's [32, 4096, 96]: 103 GFLOP, 0.104 ms;
// at [16, 4096, 256]: 137.5 GFLOP, 0.139 ms.
//
// Design.  A CTA takes 128 query rows of one bh (the reference's block) and
// walks the live key tiles of BN rows, heaviest query blocks first (under
// causal a query block's live tiles grow with its index at every k0, so
// the last blocks are the heaviest).
// The CTA is two warpgroups, 64 query rows each.  Thread 0 starts every
// load with TMA (3-D tensor maps over [heads, rows, d], rows past Sq or Sk
// and columns past d zero-filled): Q once, then K and V into a ring of
// STAGES stages with full/empty mbarriers, STAGES - 1 tiles ahead; it
// refills a stage at the end of a tile, once both warpgroups have released
// the stage's previous tile, so one warpgroup may trail the other by a tile.
// There is no
// producer warp: with one (384 threads, setmaxnreg 24 / 240) ptxas still
// compiles the whole kernel to 168 registers a thread, spills and
// serialises the wgmmas; 256 threads leave each up to 255.
// Tiles: BN = 128 keys with 4 stages at D = 64 and 96, 3 at 128; BN = 64
// past 128, where a thread holds O in D / 2 float32 registers (128 at
// D = 256) beside S (BN / 2) and P's hi and lo halves (BN / 4 each): at
// 128 keys S and P alone would take 128 and the kernel would spill.  In
// shared memory Q is 128 x D x 2 B and a stage of K and V 2 x BN x D x 2 B:
// 48 + 3 x 48 KB at D = 192, 64 + 2 x 64 KB at D = 256.
// Each tile is held as D / PC panels of [rows][PC columns], each swizzled
// by TMA: PC = 64 (128-byte rows, 128-byte swizzle) where 64 divides D,
// else PC = 32 (64-byte rows, 64-byte swizzle), so D = 96 is three exact
// panels.  (Two 128-byte panels with columns 96-127 zero-filled would pad
// P V, two thirds of the tensor work with P's hi/lo split, to N = 128.)
// Each warpgroup computes, per key tile,
//   S = Q K^T    wgmma m64nBNk16, Q and K from shared memory, K-major,
//                PC / 16 k-steps a panel;
//   softmax      in registers on S's accumulator fragment, float32, with
//                the mask computed only on ragged, diagonal and window-edge
//                tiles; l sums the float32 P;
//   O += P V     wgmma m64nNk16 with P as the A operand from registers (S's
//                fragment is already the A fragment's layout) and V from
//                shared memory, MN-major (transposed), N = D up to 128,
//                and past 128 one N = 128 product and one of D - 128 on
//                O's two column ranges.
// P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both go
// through the tensor cores into O: one bf16 rounding of P would err by up
// to 2^-9 per weight, which over a 4096-key row adds a large share of an
// output ulp; the split leaves ~2^-17, at 1.5x the algorithm's flops.
// The output is written from registers, rows past Sq skipped.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // fetched at run time through the runtime, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;               // query rows of a CTA
constexpr int kThreads = 256;              // two warpgroups
constexpr float kNegInf = -1e30f;

// bf16 columns of a panel at head dim D: a 128-byte row under the 128-byte
// swizzle where 64 divides D, else a 64-byte row under the 64-byte swizzle
template <int D>
constexpr int panel_cols() {
  static_assert(D == 64 || D == 96 || D == 128 || D == 192 || D == 256,
                "head dim 64, 96, 128, 192 or 256");
  return D % 64 == 0 ? 64 : 32;
}

template <int D, int BN, int STAGES>
struct Smem {
  static constexpr int PC = panel_cols<D>();
  // each [rows][PC] panel is swizzled by TMA; panels of 16 or 8 KB keep
  // every panel 1024-byte aligned, a multiple of either swizzle's period
  __nv_bfloat16 q[D / PC][kBlockM * PC];
  __nv_bfloat16 k[STAGES][D / PC][BN * PC];
  __nv_bfloat16 v[STAGES][D / PC][BN * PC];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t q_full;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  The wait
// is bounded (2^34 cycles, ~9 s, where a real wait takes microseconds): a
// barrier that never completes traps, so the launch fails with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of an operand in panels of PC bf16
// columns: start address, leading and stride byte offsets (16-byte units),
// layout type 1 (128-byte swizzle, PC = 64) or 2 (64-byte swizzle, PC = 32).
template <int PC>
__device__ __forceinline__ uint64_t sw_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  constexpr uint64_t layout = PC == 64 ? 1 : 2;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T with A and B K-major in
// shared memory (swizzled panels); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, as above at 64 keys
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S = Q K^T over one 16-column step at BN = 128 or 64 keys
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(BN == 64 || BN == 128, "key tile 64 or 128");
  if constexpr (BN == 128) {
    wgmma_ss_n128(s, da, db, scale_d);
  } else {
    wgmma_ss_n64(s, da, db, scale_d);
  }
}

// d[64 x 128] += A[64 x 16] . B[16 x 128] with A in registers (bf16 pairs
// in the accumulator's layout) and B MN-major in shared memory (swizzled
// panels, transposed); likewise at N = 96 and 64 below.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The N columns of O from column OFF on, as a wgmma accumulator of its own
// (the fragment's layout repeats every 8 columns: chunk i of the slice is
// chunk OFF / 8 + i of O)
template <int OFF, int N, int M>
__device__ __forceinline__ float (&cols(float (&acc)[M]))[N / 2] {
  static_assert(OFF % 8 == 0 && (OFF + N) / 2 <= M, "slice of O");
  return *reinterpret_cast<float(*)[N / 2]>(&acc[OFF / 2]);
}

// O += P V over one 16-key step.  D = 128, 96 or 64 output columns in one
// wgmma; past 128, columns 0..127 in one and 128..D-1 in another, whose
// V descriptor starts two panels (of panel_bytes, 64 columns) further.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t* a, uint64_t db,
                                         uint32_t panel_bytes) {
  if constexpr (D == 256 || D == 192) {
    wgmma_rs_n128(cols<0, 128>(acc), a, db);
    const uint64_t db_hi = db + ((2 * panel_bytes) >> 4);  // two panels on
    if constexpr (D == 256) {
      wgmma_rs_n128(cols<128, 128>(acc), a, db_hi);
    } else {
      wgmma_rs_n64(cols<128, 64>(acc), a, db_hi);
    }
  } else if constexpr (D == 128) {
    wgmma_rs_n128(acc, a, db);
  } else if constexpr (D == 96) {
    wgmma_rs_n96(acc, a, db);
  } else {
    static_assert(D == 64, "head dim 64, 96, 128, 192 or 256");
    wgmma_rs_n64(acc, a, db);
  }
}

// Thread 0 loads key tile j, the CTA's t-th, into stage t % STAGES once
// both warpgroups have released the stage's previous tile.
template <int D, int BN, int STAGES>
__device__ __forceinline__ void load_kv(Smem<D, BN, STAGES>& sm,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, int t,
                                        int j, int kvh) {
  constexpr int PC = Smem<D, BN, STAGES>::PC;
  const int st = t % STAGES;
  if (t >= STAGES) mbar_wait(&sm.empty[st], ((t / STAGES) - 1) & 1);
  mbar_expect_tx(&sm.full[st], 2 * BN * D * 2);
#pragma unroll
  for (int p = 0; p < D / PC; ++p) {
    tma_load(sm.k[st][p], k_map, &sm.full[st], p * PC, j * BN, kvh);
    tma_load(sm.v[st][p], v_map, &sm.full[st], p * PC, j * BN, kvh);
  }
}

template <int D, int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    fa_kernel_tc(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int bh_count, int group, int sq, int sk, float scale,
                 int causal, int window, int k0, int nq_blocks) {
  using Sm = Smem<D, BN, STAGES>;
  constexpr int PC = Sm::PC;           // columns of a panel
  constexpr int P = D / PC;            // panels of a row
  constexpr uint32_t kAtom = 16 * PC;  // bytes of 8 swizzled rows
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // heaviest query blocks (most live key tiles under causal) first
  const int qblk = nq_blocks - 1 - (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int q0 = qblk * kBlockM;
  // the CTA's live key tiles [j_begin, j_end), as the reference skips its
  // blocks: past the causal frontier, or wholly before the window (key j
  // sits at position j + k0)
  const int nk = (sk + BN - 1) / BN;
  int j_begin = 0, j_end = nk;
  if (causal) {
    const int last = q0 + kBlockM - 1 - k0;  // the last key row q0 + 127 sees
    j_end = last < 0 ? 0 : min(nk, last / BN + 1);
    if (window) j_begin = max(0, q0 - window + 1 - k0) / BN;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kvh = bh / group;  // GQA: the KV head of this query head
  const int n_tiles = j_end - j_begin;
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.q_full, kBlockM * D * 2);
#pragma unroll
    for (int p = 0; p < P; ++p)
      tma_load(sm.q[p], &q_map, &sm.q_full, p * PC, q0, bh);
    for (int t = 0; t < STAGES - 1 && t < n_tiles; ++t)
      load_kv(sm, &k_map, &v_map, t, j_begin + t, kvh);
  }

  // warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread owns
  // two rows and, of each 8-column chunk i of S and O, columns 8 i + col0
  // and + 1 (the wgmma accumulator's layout).  qa, qb, row_a and row_b are
  // those rows in key coordinates, less k0: key j is valid for a row at
  // qa when j <= qa (and j > qa - window), so the loop below is the
  // kernel's loop without an offset (an offset added in the loop made it
  // 9% slower at [48, 4096, 128], PERF.md)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qa = q0 + wg * 64 - k0, qb = qa + 63;
  const int row_a = qa + warp * 16 + lane / 4, row_b = row_a + 8;
  const int col0 = 2 * (lane % 4);
  const __nv_bfloat16* q_wg = &sm.q[0][wg * 64 * PC];

  float acc[D / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  const float scale2 = scale * 1.4426950408889634f;  // scale * log2(e)
  uint32_t p_hi[BN / 4], p_lo[BN / 4];

  mbar_wait(&sm.q_full, 0);
  for (int j = j_begin, t = 0; j < j_end; ++j, ++t) {
    const int st = t % STAGES;
    mbar_wait(&sm.full[st], (t / STAGES) & 1);
    const int k_lo = j * BN, k_hi = k_lo + BN - 1;
    const bool live =
        !causal || (k_lo <= qb && (!window || k_hi > qa - window));
    if (live) {
      // S = Q K^T over D in steps of 16, PC / 16 of them a panel; groups
      // of 8 rows lie kAtom bytes apart (stride offset)
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int p = ks / (PC / 16), c = (ks % (PC / 16)) * 16;
        wgmma_qk<BN>(s, sw_desc<PC>(q_wg + p * kBlockM * PC + c, 16, kAtom),
                     sw_desc<PC>(&sm.k[st][p][c], 16, kAtom), ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask where some key of the tile is invalid for some row,
      // online softmax in float32, in base 2: scores times scale * log2(e),
      // so exp(s - m) is one exp2 (the sentinel is still -1e30)
      const bool edge =
          k_hi >= sk ||
          (causal && (k_hi > qa || (window && k_lo <= qb - window)));
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float va = s[4 * i + e] * scale2, vb = s[4 * i + 2 + e] * scale2;
          if (edge) {
            const int jk = k_lo + 8 * i + col0 + e;
            bool ok_a = jk < sk, ok_b = jk < sk;
            if (causal) {
              ok_a = ok_a && jk <= row_a && (!window || jk > row_a - window);
              ok_b = ok_b && jk <= row_b && (!window || jk > row_b - window);
            }
            va = ok_a ? va : kNegInf;
            vb = ok_b ? vb : kNegInf;
          }
          s[4 * i + e] = va;
          s[4 * i + 2 + e] = vb;
          mx_a = fmaxf(mx_a, va);
          mx_b = fmaxf(mx_b, vb);
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
      float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * i + e] = exp2f(s[4 * i + e] - mn_a);
          s[4 * i + 2 + e] = exp2f(s[4 * i + 2 + e] - mn_b);
          rs_a += s[4 * i + e];
          rs_b += s[4 * i + 2 + e];
        }
      // l_a, l_b are this thread's share of the row's denominator; the
      // four lanes of a row are summed once, at the end
      l_a = l_a * alpha_a + rs_a;
      l_b = l_b * alpha_b + rs_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= alpha_a;
        acc[4 * i + 1] *= alpha_a;
        acc[4 * i + 2] *= alpha_b;
        acc[4 * i + 3] *= alpha_b;
      }
      // P = P_hi + P_lo in bf16, in the A fragment's layout: for key step
      // kk, registers 4 kk .. 4 kk + 3 hold S chunks 2 kk and 2 kk + 1
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        const float x0 = s[2 * i], x1 = s[2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 h = __bfloat1622float2(hi);
        p_hi[i] = bf16x2_bits(hi);
        p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(x0 - h.x, x1 - h.y));
      }

      // O += P_hi V + P_lo V over the tile's keys in steps of 16; V is
      // MN-major: the PC-column panels lie BN * PC * 2 bytes apart
      // (leading offset), groups of 8 keys kAtom bytes apart (stride offset)
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = sw_desc<PC>(&sm.v[st][0][kk * 16 * PC],
                                        BN * PC * 2, kAtom);
        wgmma_pv<D>(acc, &p_hi[4 * kk], db, BN * PC * 2);
        wgmma_pv<D>(acc, &p_lo[4 * kk], db, BN * PC * 2);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    if (threadIdx.x == 0 && t + STAGES - 1 < n_tiles)
      load_kv(sm, &k_map, &v_map, t + STAGES - 1, j + STAGES - 1, kvh);
    __syncwarp();
    mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // a row whose max is still the sentinel saw no valid key: its l and acc
  // hold only the masked scores' exp2(0) terms, so its output is 0
  const float den_a = m_a == kNegInf ? INFINITY : fmaxf(l_a, 1e-30f);
  const float den_b = m_b == kNegInf ? INFINITY : fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (h ? row_b : row_a) + k0;  // back to the query's row
    const float den = h ? den_b : den_a;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + ((int64_t)bh * sq + row) * D + col0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] / den,
                                acc[4 * i + 2 * h + 1] / den);
    if (lse != nullptr && col0 == 0) {
      const float m = h ? m_b : m_a, l = h ? l_b : l_a;
      lse[(int64_t)bh * sq + row] =
          m == kNegInf ? -INFINITY : m * 0.6931471805599453f + logf(l);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no
// -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over [heads, rows, d] bf16 (dims listed innermost first)
// whose box is one [box_rows][pc columns] panel, 128-byte swizzled at
// pc = 64, 64-byte swizzled at pc = 32.  Box columns at or past d, like
// rows at or past `rows`, arrive as zeros.
bool make_map(CUtensorMap* map, const void* base, int64_t heads,
              int64_t rows, int d, int pc, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)pc, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            pc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Q boxes are kBlockM rows, K and V boxes BN rows; all span d columns.
template <int D, int BN, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t bh, int64_t bh_kv, int64_t sq, int64_t sk, int d,
           float scale, int causal, int window, int k0, cudaStream_t stream) {
  using Sm = Smem<D, BN, STAGES>;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, bh, sq, d, Sm::PC, kBlockM) ||
      !make_map(&k_map, k, bh_kv, sk, d, Sm::PC, BN) ||
      !make_map(&v_map, v, bh_kv, sk, d, Sm::PC, BN))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Sm) + 1024;  // + alignment slack
  const cudaError_t err = cudaFuncSetAttribute(
      fa_kernel_tc<D, BN, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t nq = (sq + kBlockM - 1) / kBlockM;
  if (nq * bh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fa_kernel_tc<D, BN, STAGES>
      <<<(unsigned)(nq * bh), kThreads, smem, stream>>>(
          q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, (int)bh,
          (int)(bh / bh_kv), (int)sq, (int)sk, scale, causal, window, k0,
          (int)nq);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  q [bh, sq, d] and
// k, v [bh_kv, sk, d] bfloat16, o [bh, sq, D] bfloat16 with D the
// instantiation d runs at (its columns d..D-1 come out zero), all
// contiguous and 16-byte aligned; bh_kv divides bh; d is a multiple of 8
// up to 256; sk >= 1.  `window` and `k0` (key 0's position, >= 0) are read
// only when `causal` is set.  `lse` is null or float32 [bh, sq].
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* o, int64_t bh,
                                  int64_t bh_kv, int64_t sq, int64_t sk,
                                  int d, float scale, int causal,
                                  int64_t window, int64_t k0, void* lse,
                                  void* stream) {
  constexpr int64_t kMaxRows = 0x7fffffffLL - 2 * kBlockM;
  if (bh < 0 || bh > 0x7fffffffLL || bh_kv < 1 || bh % bh_kv || sq < 0 ||
      sk < 1 || sq > kMaxRows || sk > kMaxRows || window < 0 || d < 8 ||
      d > 256 || d % 8 || k0 < 0 || k0 > kMaxRows - sk ||
      k0 > kMaxRows - sq)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
      15)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  // a window wider than every query row's reach masks nothing more (key
  // positions are >= 0)
  const int w = causal && window ? (int)(window < sq + 1 ? window : sq + 1)
                                 : 0;
  const int kk0 = causal ? (int)k0 : 0;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // <D, key tile, stages> at the smallest D >= d
  if (d <= 64)
    return launch<64, 128, 4>(q, k, v, o, l, bh, bh_kv, sq, sk, d, scale,
                              causal, w, kk0, s);
  if (d <= 96)
    return launch<96, 128, 4>(q, k, v, o, l, bh, bh_kv, sq, sk, d, scale,
                              causal, w, kk0, s);
  if (d <= 128)
    return launch<128, 128, 3>(q, k, v, o, l, bh, bh_kv, sq, sk, d, scale,
                               causal, w, kk0, s);
  if (d <= 192)
    return launch<192, 64, 3>(q, k, v, o, l, bh, bh_kv, sq, sk, d, scale,
                              causal, w, kk0, s);
  return launch<256, 64, 2>(q, k, v, o, l, bh, bh_kv, sq, sk, d, scale,
                            causal, w, kk0, s);
}
