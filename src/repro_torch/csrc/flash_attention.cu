// Flash attention (online softmax, GQA, optional causal mask) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_kernel (body _flash_kernel)
// of src/repro/kernels/flash_attention/kernel.py.  The LM trunk reaches it
// from _attention with attn_impl "cuda", no KV cache and no key mask, as the
// reference reaches the Pallas kernel with attn_impl "pallas".
//
// What it computes.  q (B, H, S, d) and k, v (B, KV, T, d), f32 or bf16,
// give o (B, H, S, d) in q's type.  Query head h reads KV head h / (H / KV).
// Scores are q . k / sqrt(d) with exact products and f32 sums; keys at
// kpos >= t_valid, and with causal set at kpos > qpos (top-left aligned),
// are masked; the softmax is online with the row max m, the normaliser l
// and the accumulator in f32, and the output is rounded once.
//
// bf16: flash_fwd_bf16, on tensor cores.
//   * Why p is split.  The TPU body keeps p = exp(s - m) in f32 for p . v.
//     Rounding p to bf16 (the usual fast kernel) puts the output up to
//     ~2e-3 outside half a bf16 ulp of the f32 result, the gate this port
//     holds the kernel to.  So p is split into p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi), whose sum is p to ~8e-6 relative, and p . v runs as
//     p_hi . v + p_lo . v into one f32 accumulator: three bf16 products
//     (q . k, p_hi . v, p_lo . v), each exact in its products.
//   * What bounds it.  Those three products: at the LM path's shape (B=4,
//     H=14, KV=2, S=T=2048, d=64, causal) 3 x 15.0 GFLOP at the bf16
//     tensor-core peak, 0.046 ms, against 34 MB of inputs and output
//     (0.010 ms at the HBM rate).  Operations bound it.
//   * Design.  One block owns (b, h, a tile of BQ = 128 query rows): a
//     producer warpgroup, whose one thread issues TMA loads (the Q tile
//     once, then K and V tiles of BK keys through a two-stage ring with
//     full / empty mbarriers), and two consumer warpgroups of 64 query rows
//     each, which get the registers (setmaxnreg).  Per K/V tile a consumer
//     runs S = Q . K^T as wgmma from shared memory (f32 accumulators),
//     masks only tiles that cross t_valid or its diagonal, takes the row
//     max and sum with quad shuffles, rescales the accumulator by
//     exp2(m_old - m_new), and issues p_hi . V and p_lo . V as wgmma with A
//     in registers: the accumulator layout of S is the A-fragment layout,
//     so p never goes through shared memory.  1/sqrt(d) (with log2 e) is
//     applied to the f32 scores, not to bf16 q.
//   * TMA reads the strided views as they are: 4-D tensor maps (d, seq,
//     head, batch) over the tensors' own strides, built on the host by
//     cuTensorMapEncodeTiled (found through cudaGetDriverEntryPoint, so the
//     library does not link libcuda).  The wrapper computes their geometry
//     and raises on what TMA refuses.  Rows past S or T come back as zeros;
//     for d = 8 a 16-wide box zero-pads the contraction to wgmma's k16.
//     Rows are swizzled by their width (32, 64 or 128 bytes; d = 128 loads
//     two 64-column boxes).  d = 128 takes 64-key tiles to keep the
//     accumulators in registers; every other d takes 128.
//   * Causal tiles wholly above the diagonal are never loaded, and the
//     heaviest query tiles are scheduled first.
//
// f32: flash_fwd_f32, on tensor cores as split-TF32 ("3xTF32") products.
//   * Why operands are split.  The tensor cores' f32 path is TF32, which
//     keeps 10 mantissa bits: one TF32 product rounds each operand by up to
//     2^-11 relative, so row 0 of a causal output (v_0 itself) would be off
//     by ~2e-3 for |v| ~ 4, far outside the 1e-4 gate this port holds the
//     f32 kernel to.  So each f32 operand x is split into x_hi = tf32(x)
//     and x_lo = tf32(x - x_hi) (cvt.rna.tf32.f32: round to nearest, ties
//     away from zero; a NaN stays a NaN), and a . b is taken as a_hi .
//     b_hi + a_hi . b_lo + a_lo . b_hi with f32 sums.  The dropped a_lo .
//     b_lo and the rounding of x_lo are near 2^-22 relative, two orders
//     under the gate.
//   * What bounds it.  Six TF32 products (three for q . k, three for
//     p . v): at the LM path's shape 6 x 15.0 GFLOP at the 495 TFLOP/s
//     TF32 peak, 0.182 ms, against 67 MB of inputs and output (0.020 ms).
//     Operations bound it (two FMA products at 67 TFLOP/s would be 0.449).
//   * Design.  The bf16 kernel's skeleton with one more stage between TMA
//     and wgmma.  One block owns (b, h, BQ = 128 query rows).  Warp 0 of
//     the first warpgroup issues TMA loads: Q once, then raw K and V tiles
//     of BK keys (64 at d <= 64, 32 at d = 128) into one landing buffer
//     each.  Warps 1-3 of that warpgroup are converters: they split Q in
//     place (q_hi over the raw tile, q_lo beside it; it stays in shared
//     memory, as a d = 128 pair in registers would spill), and each landed
//     K / V tile into hi and lo tiles in a ring of split stages (2 at
//     d <= 64, 1 at d = 128, so every instantiation fits 227 KB), freeing
//     the landing buffer as soon as it is read; full / empty mbarriers
//     link the three roles.  Two consumer warpgroups of 64 query rows run
//     S = q . k^T as three wgmma from shared memory (q_hi k_hi, q_hi k_lo,
//     q_lo k_hi, k8 steps), mask only tiles that cross t_valid or the
//     diagonal, apply 1/sqrt(d) log2 e to the f32 scores (so q's split
//     sees q as it is), and take the online softmax with ex2 in f32; p is
//     split in registers and p . v runs as three wgmma with A in registers.
//   * Layouts.  wgmma takes TF32 operands K-major only.  q and k have d
//     contiguous, so q . k^T reads them as TMA lands them (the split keeps
//     every element at its swizzled offset).  For p . v the B operand is V,
//     stored with d contiguous (MN-major), so the converters write v_hi and
//     v_lo transposed: d rows of BK keys, 128-byte rows swizzled as TMA
//     would, keys of a warp's store in one row (no bank conflicts).  The S
//     accumulator holds columns {2t, 2t+1} of each 8 columns in thread t of
//     a quad, where a TF32 A fragment holds {t, t + 4}; the remedy taken is
//     to permute keys inside each 8-key group of V^T (key 2t at column t,
//     key 2t + 1 at column t + 4), so p goes from the accumulator to the A
//     fragment with no shuffle.
//   * Causal tiles wholly above the diagonal are never loaded, a consumer
//     warpgroup skips tiles above its own rows, and the heaviest query
//     tiles are scheduled first.  Tiles are assigned to warpgroups
//     statically, with no atomics and no split across blocks, so a result
//     does not change from run to run.
//
// Every d in {8, 16, 32, 64, 128} has its own instantiation of each.  Each
// entry point returns cudaGetLastError() after its launch; it allocates
// nothing and launches on the stream it is given.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Element strides of the batch, head and sequence axes of one tensor.
struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: wgmma tensor-core products fed by a TMA ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;         // query rows per block
constexpr int STAGES = 2;       // depth of the K / V ring
constexpr int THREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;  // arrivals that free a ring slot
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int DP = D < 16 ? 16 : D;              // d padded to k16
  static constexpr int SW = DP * 2 < 128 ? DP * 2 : 128;  // row bytes = swizzle
  static constexpr int CB = SW / 2;                       // columns per box
  static constexpr int BK = D > 64 ? 64 : 128;            // keys per tile
  // wgmma descriptor layout type and TMA swizzle of an SW-byte row
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  // tiles aligned to the 1024-byte swizzle period, then the 1 + 4 * STAGES
  // mbarriers
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D map (d, seq, head, batch) into shared memory; its
// bytes complete a transaction of ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (swizzle) in the top two bits.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for A fragments, which an issued product reads until its wait:
// fenced after the wait, their registers are not reused before it.
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) asm volatile("" : "+r"(r[i][u])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The consumers' masks, online softmax and epilogue, shared by both kernels.
// A consumer warpgroup owns the 64 query rows from wq0; in the wgmma
// accumulator layout thread (warp, g = lane / 4, c = lane % 4) holds rows
// row0 = wq0 + 16 warp + g and row0 + 8, columns 8j + 2c and 8j + 2c + 1 of
// each 8 columns j: s[4j + 2r + e] is row row0 + 8r, column 8j + c2 + e
// (c2 = 2c).  Scores are NS = BK / 2 values a thread, the accumulator NO =
// DP / 2.
// ---------------------------------------------------------------------------

// Keys at kpos >= t_valid, and with causal at kpos > qpos, of the tile at
// k0 get -inf; only a tile that crosses t_valid or the diagonal is looked
// at.
template <int NS>
__device__ __forceinline__ void mask_tile(float (&sc)[NS], int k0, int wq0,
                                          int row0, int c2, int t_valid,
                                          int causal) {
  constexpr int BK = 2 * NS;
  if (k0 + BK <= t_valid && !(causal && k0 + BK - 1 > wq0)) return;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + c2 + e;
        if (kpos >= t_valid || (causal && kpos > row0 + 8 * r))
          sc[4 * j + 2 * r + e] = -INFINITY;
      }
}

// One step of the online softmax in the log2 domain: the raw scores become
// p = 2^(s * scale_log2 - m) with m the new row max (row max and sum over
// the quad by shuffles), and l and the accumulator are rescaled by
// 2^(m_old - m) before p's row sums are added to l.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&sc)[NS], float (&acc)[NO],
                                             float (&m)[2], float (&l)[2],
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(mx[r], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
  float base[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    // a row with no valid key yet keeps p = 0 instead of exp(nan)
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = exp2_approx(m[r] - base[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = exp2_approx(fmaf(x, scale_log2, -base[r]));
        sum[r] += x;
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
  for (int j = 0; j < NO / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[4 * j + 2 * r] *= corr[r];
      acc[4 * j + 2 * r + 1] *= corr[r];
    }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The epilogue: acc / l in f32, rounded once to o's type, through o's
// strides; l is summed over the quad first, and a row with no valid key
// (l = 0) keeps acc = 0.
template <int D, int NO, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ o,
                                           const Strides& so, int b, int h,
                                           int row0, int c2, int S,
                                           const float (&acc)[NO],
                                           const float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float safe = lt > 0.f ? lt : 1.f;
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    T* orow = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + c2;
      if (col < D)
        store2(orow + col, acc[4 * j + 2 * r] / safe,
               acc[4 * j + 2 * r + 1] / safe);
    }
  }
}

// wgmma wrappers, one per accumulator shape: FN(d, a, b[, scale_d]) with
// d (64 x N) f32 accumulators in registers, TYPE the k step and operand
// types, TAIL the immediates (scale-a, scale-b and, for 16-bit operands,
// the transpose bits of A and B).
#define WG_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_REGS16 WG_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_REGS32                                                        \
  WG_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, "                 \
            "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64                                                        \
  WG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, "                 \
            "%40, %41, %42, %43, %44, %45, %46, %47, "                   \
            "%48, %49, %50, %51, %52, %53, %54, %55, "                   \
            "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_ACC8(o)                                                       \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_OUT8 WG_ACC8(0)
#define WG_OUT16 WG_OUT8, WG_ACC8(8)
#define WG_OUT32 WG_OUT16, WG_ACC8(16), WG_ACC8(24)
#define WG_OUT64 WG_OUT32, WG_ACC8(32), WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)

// d = (scale_d ? d : 0) + A . B, A and B in shared memory (descriptors)
#define WGMMA_SS(FN, TYPE, TAIL, N, NR, A, B, P)                           \
  __device__ __forceinline__ void FN(float(&d)[NR], uint64_t a,            \
                                     uint64_t b, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N TYPE " "           \
                 "{" WG_REGS##NR "}, " A ", " B ", p, " TAIL ";\n}\n"     \
                 : WG_OUT##NR                                              \
                 : "l"(a), "l"(b), "r"(scale_d));                          \
  }

// d += A . B, A in registers (four 32-bit registers a thread), B in
// shared memory
#define WGMMA_RS(FN, TYPE, TAIL, N, NR, A0, A1, A2, A3, B, P)              \
  __device__ __forceinline__ void FN(float(&d)[NR], const uint32_t(&a)[4], \
                                     uint64_t b) {                         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N TYPE " "           \
                 "{" WG_REGS##NR "}, {" A0 ", " A1 ", " A2 ", " A3 "}, " B \
                 ", p, " TAIL ";\n}\n"                                     \
                 : WG_OUT##NR                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                   "r"(1));                                                \
  }

// bf16, k16: A and B K-major for q . k^T; for p . v, B (V) MN-major (the
// transpose bit of B set)
#define BF16 "k16.f32.bf16.bf16"
WGMMA_SS(wgmma_ss, BF16, "1, 1, 0, 0", 64, 32, "%32", "%33", "%34")
WGMMA_SS(wgmma_ss, BF16, "1, 1, 0, 0", 128, 64, "%64", "%65", "%66")
WGMMA_RS(wgmma_rs, BF16, "1, 1, 1", 16, 8, "%8", "%9", "%10", "%11", "%12",
         "%13")
WGMMA_RS(wgmma_rs, BF16, "1, 1, 1", 32, 16, "%16", "%17", "%18", "%19",
         "%20", "%21")
WGMMA_RS(wgmma_rs, BF16, "1, 1, 1", 64, 32, "%32", "%33", "%34", "%35",
         "%36", "%37")
WGMMA_RS(wgmma_rs, BF16, "1, 1, 1", 128, 64, "%64", "%65", "%66", "%67",
         "%68", "%69")
#undef BF16

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, Strides so, int BH, int H,
               int group, int S, int t_valid, int causal, float scale_log2) {
  using G = Geo<D>;
  constexpr int BK = G::BK, DP = G::DP, SW = G::SW, CB = G::CB;
  constexpr int NS = BK / 2;  // S accumulators per thread (64 x BK)
  constexpr int NO = DP / 2;  // output accumulators per thread (64 x DP)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + G::Q_BYTES;             // STAGES x KV_BYTES
  const uint32_t sV = sK + STAGES * G::KV_BYTES;   // STAGES x KV_BYTES
  const uint32_t q_full = sV + STAGES * G::KV_BYTES;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * STAGES + s); };

  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // heaviest causal tiles first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  int kend = t_valid;
  if (causal) kend = min(kend, min(q0 + BQ, S));  // last row's qpos + 1
  const int n_kt = (kend + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS);
      mbar_init(v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, G::Q_BYTES);
      for (int c = 0; c < DP / CB; ++c)
        tma_load(sQ + c * BQ * SW, &tq, q_full, c * CB, q0, h, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), G::KV_BYTES);
        for (int c = 0; c < DP / CB; ++c)
          tma_load(sK + s * G::KV_BYTES + c * BK * SW, &tk, k_full(s),
                   c * CB, i * BK, kvh, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), G::KV_BYTES);
        for (int c = 0; c < DP / CB; ++c)
          tma_load(sV + s * G::KV_BYTES + c * BK * SW, &tv, v_full(s),
                   c * CB, i * BK, kvh, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows wq0 .. wq0 + 63 (the layout of
  // their accumulators is set out above mask_tile)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c2 = 2 * (lane % 4);
  const int wq0 = q0 + 64 * cw;
  const int row0 = wq0 + 16 * warp + g;
  const uint32_t qa = sQ + cw * 64 * SW;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_kt; ++i) {
    const int s = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const int k0 = i * BK;
    if (causal && k0 > wq0 + 63) {
      // wholly above this warpgroup's diagonal: only free the slot
      mbar_wait(k_full(s), parity);
      mbar_arrive(k_empty(s));
      mbar_wait(v_full(s), parity);
      mbar_arrive(v_empty(s));
      continue;
    }

    // S = Q . K^T (raw scores, f32)
    float sc[NS];
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t box = ks * 16 / CB, off = ks * 16 % CB * 2;
      wgmma_ss(sc,
               smem_desc(qa + box * BQ * SW + off, 16, 8 * SW, G::LAYOUT),
               smem_desc(sK + s * G::KV_BYTES + box * BK * SW + off, 16,
                         8 * SW, G::LAYOUT),
               ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    mbar_arrive(k_empty(s));

    mask_tile(sc, k0, wq0, row0, c2, t_valid, causal);
    softmax_step(sc, acc, m, l, scale_log2);

    // p = p_hi + p_lo as bf16 A fragments: for keys 16ks .. 16ks + 15 the
    // fragment is (row g, keys c2..), (row g + 8, c2..), (g, 8 + c2..),
    // (g + 8, 8 + c2..) = accumulators 8ks + 0..7 in pairs
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x0 = sc[8 * ks + 2 * u], x1 = sc[8 * ks + 2 * u + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h2);
        hi[ks][u] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[ks][u] = pack_bf16(x0 - hf.x, x1 - hf.y);
      }

    // acc += p_hi . V + p_lo . V
    mbar_wait(v_full(s), parity);
    reg_fence(acc);
    wgmma_fence();
    const uint32_t vb = sV + s * G::KV_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_rs(acc, hi[ks],
               smem_desc(vb + ks * 16 * SW, BK * SW, 8 * SW, G::LAYOUT));
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_rs(acc, lo[ks],
               smem_desc(vb + ks * 16 * SW, BK * SW, 8 * SW, G::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    reg_fence(hi);
    reg_fence(lo);
    mbar_arrive(v_empty(s));
  }

  store_rows<D>(o, so, b, h, row0, c2, S, acc, l);
}

// ---------------------------------------------------------------------------
// f32: split-TF32 wgmma products fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int CONVERTERS = 96;  // warps 1-3 of the producer warpgroup
constexpr int IN_FLIGHT = 4;    // 16-byte loads a converter keeps in flight

template <int D>
struct GeoF32 {
  static constexpr int DP = D < 16 ? 16 : D;              // d padded to 16
  static constexpr int SW = DP * 4 < 128 ? DP * 4 : 128;  // row bytes = swizzle
  static constexpr int CB = SW / 4;                       // columns per box
  static constexpr int BK = D > 64 ? 32 : 64;             // keys per tile
  static constexpr int STAGES = D > 64 ? 1 : 2;           // split-tile ring
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = BQ * DP * 4;
  static constexpr uint32_t KV_BYTES = BK * DP * 4;
  // q_hi (Q lands there) and q_lo, raw K and V, STAGES x (k_hi, k_lo,
  // v^T_hi, v^T_lo), all aligned to the 1024-byte swizzle period, then the
  // 6 + 4 * STAGES mbarriers
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES +
                                 (2 + 4 * STAGES) * KV_BYTES +
                                 8 * (6 + 4 * STAGES);
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
  static_assert(BK % 32 == 0, "V^T rows are 128-byte boxes of 32 keys");
};

// Shared-memory offset of logical byte o of a tile whose rows are swizzled
// by their width SW, as TMA writes them and wgmma reads them: bits 4.. (the
// 16-byte chunk) XOR bits 7.. of the offset from a 1024-byte boundary.
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ ((o >> 3) & ((SW / 16 - 1) << 4));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as an f32 with its low 13 bits zero; a NaN stays a NaN.  (Adding
// half a unit to the bits and clearing the low 13 is the same rounding on
// every other input, and faster, but its carry turns NaNs into zeros or
// infinities, and guarding it costs more than cvt.rna: see PERF.md.)
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

// The converters' shared-memory writes become visible to wgmma (the async
// proxy) before they signal a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// hi and lo of each f32 of [src, src + bytes) at the same offsets (hi may
// be src): the swizzled layout is kept as it is.  IN_FLIGHT loads are
// issued before the first store.
__device__ __forceinline__ void split_tile(uint32_t src, uint32_t hi,
                                           uint32_t lo, uint32_t bytes,
                                           int ct) {
  constexpr uint32_t STEP = 16 * CONVERTERS;
  for (uint32_t o0 = 16 * ct; o0 < bytes; o0 += STEP * IN_FLIGHT) {
    float4 x[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u)
      if (o0 + u * STEP < bytes) x[u] = lds128(src + o0 + u * STEP);
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const uint32_t o = o0 + u * STEP;
      if (o >= bytes) break;
      float4 h, l;
      h.x = tf32_rna(x[u].x);
      h.y = tf32_rna(x[u].y);
      h.z = tf32_rna(x[u].z);
      h.w = tf32_rna(x[u].w);
      l.x = tf32_rna(x[u].x - h.x);
      l.y = tf32_rna(x[u].y - h.y);
      l.z = tf32_rna(x[u].z - h.z);
      l.w = tf32_rna(x[u].w - h.w);
      sts128(hi + o, h);
      sts128(lo + o, l);
    }
  }
}

// V (BK keys x DP columns, SW-byte rows in boxes of SW / 4 columns) into
// V^T hi and lo: DP rows of BK keys, 128-byte swizzled rows in boxes of 32
// keys (DP x 128 bytes each), K-major for wgmma.  Inside each 8-key group
// key 2t goes to column t and key 2t + 1 to column t + 4: the S
// accumulator's columns in the TF32 A fragment's places.  A warp handles 32
// consecutive keys of one 4-column chunk, so each of its stores fills one
// 128-byte row.
template <int DP, int SW, int BK>
__device__ __forceinline__ void split_v(uint32_t src, uint32_t hi,
                                        uint32_t lo, int ct) {
  constexpr int CB = SW / 4, N = BK * DP / 4;
  for (int e0 = ct; e0 < N; e0 += CONVERTERS * IN_FLIGHT) {
    float4 x[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int e = e0 + u * CONVERTERS;
      const int r = e % BK, c = e / BK * 4;  // key, first of four columns
      if (e < N)
        x[u] = lds128(src + swz<SW>(c / CB * BK * SW + r * SW + c % CB * 4));
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int e = e0 + u * CONVERTERS;
      if (e >= N) break;
      const int r = e % BK, c = e / BK * 4;
      const int kk = (r & ~7) | (r & 7) >> 1 | (r & 1) << 2;
      const uint32_t col = kk / 32 * DP * 128 + kk % 32 * 4;
      const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t a = swz<128>(col + (c + i) * 128);
        const float h = tf32_rna(xs[i]);
        sts32(hi + a, h);
        sts32(lo + a, tf32_rna(xs[i] - h));
      }
    }
  }
}

// TF32, k8: K-major operands only (TF32 has no transpose bits)
#define TF32 "k8.f32.tf32.tf32"
WGMMA_SS(wgmma_tf32_ss, TF32, "1, 1", 32, 16, "%16", "%17", "%18")
WGMMA_SS(wgmma_tf32_ss, TF32, "1, 1", 64, 32, "%32", "%33", "%34")
WGMMA_RS(wgmma_tf32_rs, TF32, "1, 1", 16, 8, "%8", "%9", "%10", "%11", "%12",
         "%13")
WGMMA_RS(wgmma_tf32_rs, TF32, "1, 1", 32, 16, "%16", "%17", "%18", "%19",
         "%20", "%21")
WGMMA_RS(wgmma_tf32_rs, TF32, "1, 1", 64, 32, "%32", "%33", "%34", "%35",
         "%36", "%37")
WGMMA_RS(wgmma_tf32_rs, TF32, "1, 1", 128, 64, "%64", "%65", "%66", "%67",
         "%68", "%69")
#undef TF32

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
              Strides so, int BH, int H, int group, int S, int t_valid,
              int causal, float scale_log2) {
  using G = GeoF32<D>;
  constexpr int BK = G::BK, DP = G::DP, SW = G::SW, CB = G::CB;
  constexpr int ST = G::STAGES;
  constexpr uint32_t KVB = G::KV_BYTES;
  constexpr int NS = BK / 2;  // S accumulators per thread (64 x BK)
  constexpr int NO = DP / 2;  // output accumulators per thread (64 x DP)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;  // q_hi
  const uint32_t sQl = sQ + G::Q_BYTES;                        // q_lo
  const uint32_t sKr = sQl + G::Q_BYTES;                       // raw K
  const uint32_t sVr = sKr + KVB;                              // raw V
  const uint32_t sS = sVr + KVB;  // ST x (k_hi, k_lo, v^T_hi, v^T_lo)
  auto k_hi = [&](int s) { return sS + (4 * s) * KVB; };
  auto k_lo = [&](int s) { return sS + (4 * s + 1) * KVB; };
  auto v_hi = [&](int s) { return sS + (4 * s + 2) * KVB; };
  auto v_lo = [&](int s) { return sS + (4 * s + 3) * KVB; };
  const uint32_t q_full = sS + 4 * ST * KVB, q_ready = q_full + 8;
  const uint32_t kr_full = q_full + 16, kr_empty = q_full + 24;
  const uint32_t vr_full = q_full + 32, vr_empty = q_full + 40;
  auto ks_full = [&](int s) { return q_full + 8 * (6 + s); };
  auto ks_empty = [&](int s) { return q_full + 8 * (6 + ST + s); };
  auto vs_full = [&](int s) { return q_full + 8 * (6 + 2 * ST + s); };
  auto vs_empty = [&](int s) { return q_full + 8 * (6 + 3 * ST + s); };

  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // heaviest causal tiles first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  int kend = t_valid;
  if (causal) kend = min(kend, min(q0 + BQ, S));  // last row's qpos + 1
  const int n_kt = (kend + BK - 1) / BK;
  // the warpgroup, broadcast so that the compiler knows it is the same in
  // every lane: otherwise ptxas finds the consumers' wgmma on a divergent
  // path and serialises them (its C7520 remark)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, CONVERTERS);
    mbar_init(kr_full, 1);
    mbar_init(kr_empty, CONVERTERS);
    mbar_init(vr_full, 1);
    mbar_init(vr_empty, CONVERTERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(ks_full(s), CONVERTERS);
      mbar_init(ks_empty(s), CONSUMERS);
      mbar_init(vs_full(s), CONVERTERS);
      mbar_init(vs_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x < 32) {
      // producer: one thread keeps the landing buffers full
      if (threadIdx.x == 0) {
        const int kvh = h / group;
        mbar_expect_tx(q_full, G::Q_BYTES);
        for (int c = 0; c < DP / CB; ++c)
          tma_load(sQ + c * BQ * SW, &tq, q_full, c * CB, q0, h, b);
        for (int i = 0; i < n_kt; ++i) {
          const uint32_t free_parity = (i & 1) ^ 1;
          mbar_wait(kr_empty, free_parity);
          mbar_expect_tx(kr_full, KVB);
          for (int c = 0; c < DP / CB; ++c)
            tma_load(sKr + c * BK * SW, &tk, kr_full, c * CB, i * BK, kvh,
                     b);
          mbar_wait(vr_empty, free_parity);
          mbar_expect_tx(vr_full, KVB);
          for (int c = 0; c < DP / CB; ++c)
            tma_load(sVr + c * BK * SW, &tv, vr_full, c * CB, i * BK, kvh,
                     b);
        }
      }
      return;
    }
    // converters: split Q once, then each landed K / V tile into the ring
    const int ct = threadIdx.x - 32;
    mbar_wait(q_full, 0);
    split_tile(sQ, sQ, sQl, G::Q_BYTES, ct);
    fence_proxy_async();
    mbar_arrive(q_ready);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % ST;
      const uint32_t raw_parity = i & 1;
      const uint32_t free_parity = ((i / ST) & 1) ^ 1;
      mbar_wait(kr_full, raw_parity);
      mbar_wait(ks_empty(s), free_parity);
      split_tile(sKr, k_hi(s), k_lo(s), KVB, ct);
      fence_proxy_async();
      mbar_arrive(kr_empty);
      mbar_arrive(ks_full(s));
      mbar_wait(vr_full, raw_parity);
      mbar_wait(vs_empty(s), free_parity);
      split_v<DP, SW, BK>(sVr, v_hi(s), v_lo(s), ct);
      fence_proxy_async();
      mbar_arrive(vr_empty);
      mbar_arrive(vs_full(s));
    }
    return;
  }

  // consumers: warpgroup cw owns query rows wq0 .. wq0 + 63 (the layout of
  // their accumulators is set out above mask_tile)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c2 = 2 * (lane % 4);
  const int wq0 = q0 + 64 * cw;
  const int row0 = wq0 + 16 * warp + g;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_ready, 0);

  // causal: the tiles at or below this warpgroup's diagonal are a prefix
  const int n_mine = causal ? min(n_kt, (wq0 + 63) / BK + 1) : n_kt;
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % ST;
    const uint32_t parity = (i / ST) & 1;
    const int k0 = i * BK;

    // S = q_hi k_hi + q_hi k_lo + q_lo k_hi (raw scores, f32 sums)
    float sc[NS];
    mbar_wait(ks_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      const uint32_t qo =
          ks * 8 / CB * BQ * SW + cw * 64 * SW + ks * 8 % CB * 4;
      const uint32_t ko = ks * 8 / CB * BK * SW + ks * 8 % CB * 4;
      const uint64_t qh = smem_desc(sQ + qo, 16, 8 * SW, G::LAYOUT);
      const uint64_t ql = smem_desc(sQl + qo, 16, 8 * SW, G::LAYOUT);
      const uint64_t kh = smem_desc(k_hi(s) + ko, 16, 8 * SW, G::LAYOUT);
      const uint64_t kl = smem_desc(k_lo(s) + ko, 16, 8 * SW, G::LAYOUT);
      wgmma_tf32_ss(sc, qh, kh, ks > 0);
      wgmma_tf32_ss(sc, qh, kl, 1);
      wgmma_tf32_ss(sc, ql, kh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    mbar_arrive(ks_empty(s));

    mask_tile(sc, k0, wq0, row0, c2, t_valid, causal);
    softmax_step(sc, acc, m, l, scale_log2);

    // p = p_hi + p_lo as TF32 A fragments of keys 8j .. 8j + 7: (row g,
    // column c), (g + 8, c), (g, c + 4), (g + 8, c + 4) for c = lane % 4,
    // where column c holds key 2c and column c + 4 key 2c + 1 (V^T's order).
    // A fragments are built in the iteration that reads them: ptxas does
    // not keep one live across the loop (q_lo fragments loaded once before
    // it were overwritten by the softmax; chip_smoke.py checks the SASS).
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float x[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                          sc[4 * j + 3]};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float ph = tf32_rna(x[u]);
        hi[j][u] = __float_as_uint(ph);
        lo[j][u] = __float_as_uint(tf32_rna(x[u] - ph));
      }
    }

    // acc += p_hi v_hi + p_hi v_lo + p_lo v_hi
    mbar_wait(vs_full(s), parity);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t vo = j * 8 / 32 * DP * 128 + j * 8 % 32 * 4;
      const uint64_t vh = smem_desc(v_hi(s) + vo, 16, 1024, 1);
      const uint64_t vl = smem_desc(v_lo(s) + vo, 16, 1024, 1);
      wgmma_tf32_rs(acc, hi[j], vh);
      wgmma_tf32_rs(acc, hi[j], vl);
      wgmma_tf32_rs(acc, lo[j], vh);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    reg_fence(hi);
    reg_fence(lo);
    mbar_arrive(vs_empty(s));
  }
  // tiles wholly above this warpgroup's diagonal: only free their slots
  for (int i = n_mine; i < n_kt; ++i) {
    const int s = i % ST;
    const uint32_t parity = (i / ST) & 1;
    mbar_wait(ks_full(s), parity);
    mbar_arrive(ks_empty(s));
    mbar_wait(vs_full(s), parity);
    mbar_arrive(vs_empty(s));
  }

  store_rows<D>(o, so, b, h, row0, c2, S, acc, l);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes besides cudaError_t: cuTensorMapEncodeTiled was not found,
// or it refused a map (-CUresult).
constexpr int NO_ENCODER = -999;

// The tensor maps of q, k and v.  geo: for each in turn 12 values: dims (d,
// seq, head, batch), byte strides of seq, head, batch, box (columns, rows,
// 1, 1), swizzle bytes; they must be those of a kernel whose boxes are cb
// columns by bq (q) or bk (k, v) rows, swizzled by sw bytes.
int encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k,
                const void* v, const long long* geo, int d, int cb, int bq,
                int bk, int sw, CUtensorMapDataType type) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return NO_ENCODER;
  const void* base[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* g = geo + 12 * i;
    if (g[0] != d || g[7] != cb || g[8] != (i == 0 ? bq : bk) ||
        g[9] != 1 || g[10] != 1 || g[11] != sw)
      return cudaErrorInvalidValue;  // the wrapper's geometry disagrees
    const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                                (cuuint64_t)g[2], (cuuint64_t)g[3]};
    const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                   (cuuint64_t)g[6]};
    const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8], 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult res = encode(
        &maps[i], type, 4, const_cast<void*>(base[i]), dims, strides, box,
        unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
        : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads zeros
    if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  }
  return 0;
}

// One kernel launch over (b, h, query tiles of BQ rows) for head dim D:
// bf16 (Geo) or f32 (GeoF32).
template <int D, bool F32>
int run(const void* q, const void* k, const void* v, void* o,
        const long long* so, const long long* geo, int B, int H, int KV,
        int S, int t_valid, int causal, float scale, cudaStream_t stream) {
  using G = typename std::conditional<F32, GeoF32<D>, Geo<D>>::type;
  CUtensorMap maps[3];
  const int rc = encode_maps(
      maps, q, k, v, geo, D, G::CB, BQ, G::BK, G::SW,
      F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (rc != 0) return rc;
  const int BH = B * H;
  const int n_qt = (S + BQ - 1) / BQ;
  const Strides st{so[0], so[1], so[2]};
  cudaError_t err;
  if constexpr (F32) {
    err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G::SMEM);
    if (err != cudaSuccess) return err;
    flash_fwd_f32<D><<<BH * n_qt, THREADS, G::SMEM, stream>>>(
        maps[0], maps[1], maps[2], static_cast<float*>(o), st, BH, H, H / KV,
        S, t_valid, causal, scale * LOG2E);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G::SMEM);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16<D><<<BH * n_qt, THREADS, G::SMEM, stream>>>(
        maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), st, BH, H,
        H / KV, S, t_valid, causal, scale * LOG2E);
  }
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Both entry points.  o_strides: the element strides (batch, head,
// sequence) of o; geo: the tensor-map geometry of q, k and v (see
// tc::encode_maps).  Returns a cudaError_t, or a negative value when no
// tensor map could be encoded.
#define ENTRY(name, f32)                                                   \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      const long long* o_strides, const long long* geo,    \
                      int B, int H, int KV, int S, int D, int t_valid,     \
                      int causal, float scale, void* stream) {             \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                   \
    switch (D) {                                                           \
      case 8:                                                              \
        return tc::run<8, f32>(q, k, v, o, o_strides, geo, B, H, KV, S,    \
                               t_valid, causal, scale, st);                \
      case 16:                                                             \
        return tc::run<16, f32>(q, k, v, o, o_strides, geo, B, H, KV, S,   \
                                t_valid, causal, scale, st);               \
      case 32:                                                             \
        return tc::run<32, f32>(q, k, v, o, o_strides, geo, B, H, KV, S,   \
                                t_valid, causal, scale, st);               \
      case 64:                                                             \
        return tc::run<64, f32>(q, k, v, o, o_strides, geo, B, H, KV, S,   \
                                t_valid, causal, scale, st);               \
      case 128:                                                            \
        return tc::run<128, f32>(q, k, v, o, o_strides, geo, B, H, KV, S,  \
                                 t_valid, causal, scale, st);              \
      default:                                                             \
        return cudaErrorInvalidValue;                                      \
    }                                                                      \
  }
ENTRY(flash_attention_f32, true)
ENTRY(flash_attention_bf16, false)
