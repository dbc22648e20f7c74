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
// f32: flash_fwd_f32, f32 FMA on the CUDA cores.  At the path's shape the
// two products run at the 67 TFLOP/s non-tensor f32 rate (0.45 ms).  One
// block of four warps owns (b, h, BQ = 32 query rows) and walks the kv axis
// in a loop, so the TPU grid's m, l, acc carry lives in registers: each
// warp owns 8 query rows, with m, l and the row's output dims spread over
// its lanes.  Per kv tile of BK = 64 keys K and V go to shared memory (K
// rows padded to d + 1 floats so the lanes' reads of 32 different keys hit
// 32 banks); lane j scores keys j and j + 32 for the warp's 8 rows; the row
// max and sum are warp shuffles; p goes to shared memory, where the warp
// reads it back as broadcast float4s for p . v.  Causal tiles above the
// diagonal are skipped and the heaviest query tiles go first.  Strides are
// taken as given (the last dimension contiguous).
//
// Every d in {8, 16, 32, 64, 128} has its own instantiation of each.  Each
// entry point returns cudaGetLastError() after its launch; it allocates
// nothing and launches on the stream it is given.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Element strides of the batch, head and sequence axes of one tensor.
struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;              // query rows per warp
constexpr int BQ = WARPS * ROWS;     // query rows per block
constexpr int BK = 64;               // keys per shared-memory tile
constexpr unsigned FULL = 0xffffffffu;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides sq,
              Strides sk, Strides sv, Strides so, int BH, int H, int group,
              int S, int T, int t_valid, int causal, float scale) {
  constexpr int NT = (D + 31) / 32;  // output dims per lane
  constexpr int KS = D + 1;          // padded row stride of the K tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // BQ x D: q * scale
  float* Ks = Qs + BQ * D;           // BK x KS
  float* Vs = Ks + BK * KS;          // BK x D
  float* Ps = Vs + BK * D;           // BQ x BK

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // heaviest causal tiles first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + (h / group) * sk.h;
  const float* vb = v + b * sv.b + (h / group) * sv.h;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, i = e % D;
    Qs[e] = q0 + r < S ? qb[(q0 + r) * sq.s + i] * scale : 0.f;
  }
  int kend = t_valid;
  if (causal) kend = min(kend, min(q0 + BQ, S));  // last row's qpos + 1

  float m[ROWS], l[ROWS], acc[ROWS][NT];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[rr][t] = 0.f;
  }
  const float* Qw = Qs + warp * ROWS * D;
  float* Pw = Ps + warp * ROWS * BK;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // Qs is written / the previous tile is consumed
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, i = e % D;
      const bool in = k0 + r < T;
      Ks[r * KS + i] = in ? kb[(k0 + r) * sk.s + i] : 0.f;
      Vs[r * D + i] = in ? vb[(k0 + r) * sv.s + i] : 0.f;
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 2
    for (int i = 0; i < D; i += 4) {
      float ka[4], kc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ka[u] = Ks[lane * KS + i + u];
        kc[u] = Ks[(lane + 32) * KS + i + u];
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + rr * D + i);
        s[rr][0] = fmaf(qv.x, ka[0], s[rr][0]);
        s[rr][0] = fmaf(qv.y, ka[1], s[rr][0]);
        s[rr][0] = fmaf(qv.z, ka[2], s[rr][0]);
        s[rr][0] = fmaf(qv.w, ka[3], s[rr][0]);
        s[rr][1] = fmaf(qv.x, kc[0], s[rr][1]);
        s[rr][1] = fmaf(qv.y, kc[1], s[rr][1]);
        s[rr][1] = fmaf(qv.z, kc[2], s[rr][1]);
        s[rr][1] = fmaf(qv.w, kc[3], s[rr][1]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int qpos = q0 + warp * ROWS + rr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        if (kpos >= t_valid || (causal && kpos > qpos)) s[rr][j] = -INFINITY;
      }
      float mx = fmaxf(s[rr][0], s[rr][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      // a row with no valid key yet keeps p = 0 instead of exp(nan)
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(s[rr][0] - base), p1 = expf(s[rr][1] - base);
      const float corr = expf(m[rr] - base);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[rr] = l[rr] * corr + sum;
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[rr][t] *= corr;
      Pw[rr * BK + lane] = p0;
      Pw[rr * BK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float vv[4][NT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int j = lane + 32 * t;
          vv[u][t] = j < D ? Vs[(kk + u) * D + j] : 0.f;
        }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float4 pv = *reinterpret_cast<const float4*>(Pw + rr * BK + kk);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          acc[rr][t] = fmaf(pv.x, vv[0][t], acc[rr][t]);
          acc[rr][t] = fmaf(pv.y, vv[1][t], acc[rr][t]);
          acc[rr][t] = fmaf(pv.z, vv[2][t], acc[rr][t]);
          acc[rr][t] = fmaf(pv.w, vv[3][t], acc[rr][t]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = q0 + warp * ROWS + rr;
    if (r >= S) continue;
    const float safe = l[rr] > 0.f ? l[rr] : 1.f;
    float* orow = o + b * so.b + h * so.h + r * so.s;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      if (j < D) orow[j] = acc[rr][t] / safe;
    }
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, void* o,
        const long long* st, int B, int H, int KV, int S, int T, int t_valid,
        int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_f32<D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  const int n_qt = (S + BQ - 1) / BQ;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kernel<<<BH * n_qt, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
      BH, H, H / KV, S, T, t_valid, causal, scale);
  return cudaGetLastError();
}

}  // namespace f32

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

// d (64 x 64) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 64), f32 sums;
// A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 128), f32 sums;
// A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 16) += A (64 x 16, bf16 in registers) . B (16 x 16), f32 sums;
// B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 16, bf16 in registers) . B (16 x 32), f32 sums;
// B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, bf16 in registers) . B (16 x 64), f32 sums;
// B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16 in registers) . B (16 x 128), f32 sums;
// B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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

  // consumers: warpgroup cw owns query rows wq0 .. wq0 + 63; in the wgmma
  // accumulator layout thread (warp, g = lane / 4, c = lane % 4) holds rows
  // row0 and row0 + 8, columns 8j + 2c and 8j + 2c + 1 of each 8 columns j
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

    // masks, only where the tile crosses t_valid or the diagonal
    if (k0 + BK > t_valid || (causal && k0 + BK - 1 > wq0)) {
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

    // online softmax in the log2 domain: p = 2^(s * scale_log2 - m)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
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
    for (int j = 0; j < BK / 8; ++j)
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
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * j + 2 * r] *= corr[r];
        acc[4 * j + 2 * r + 1] *= corr[r];
      }

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

  // epilogue: acc / l in f32, rounded once, through o's strides
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float safe = lt > 0.f ? lt : 1.f;
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] / safe, acc[4 * j + 2 * r + 1] / safe);
    }
  }
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

// geo: for q, k, v in turn 12 values: dims (d, seq, head, batch), byte
// strides of seq, head, batch, box (columns, rows, 1, 1), swizzle bytes.
template <int D>
int run(const void* q, const void* k, const void* v, void* o,
        const long long* so, const long long* geo, int B, int H, int KV,
        int S, int t_valid, int causal, float scale, cudaStream_t stream) {
  using G = Geo<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return NO_ENCODER;
  const void* base[3] = {q, k, v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const long long* g = geo + 12 * i;
    if (g[0] != D || g[7] != G::CB || g[8] != (i == 0 ? BQ : G::BK) ||
        g[9] != 1 || g[10] != 1 || g[11] != G::SW)
      return cudaErrorInvalidValue;  // the wrapper's geometry disagrees
    const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                                (cuuint64_t)g[2], (cuuint64_t)g[3]};
    const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                   (cuuint64_t)g[6]};
    const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8], 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult res = encode(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
        const_cast<void*>(base[i]), dims, strides, box, unit,
        CU_TENSOR_MAP_INTERLEAVE_NONE,
        G::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
        : G::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads zeros
    if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  }
  auto kernel = flash_fwd_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  const int n_qt = (S + BQ - 1) / BQ;
  kernel<<<BH * n_qt, THREADS, G::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o),
      Strides{so[0], so[1], so[2]}, BH, H, H / KV, S, t_valid, causal,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// f32.  strides: 12 element strides (batch, head, sequence) of q, k, v and
// o, in that order; the last dimension of each is contiguous.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int KV, int S, int T, int D, int t_valid,
                                   int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define CASE(d)                                                          \
  case d:                                                                \
    return f32::run<d>(q, k, v, o, strides, B, H, KV, S, T, t_valid,     \
                       causal, scale, st);
    CASE(8) CASE(16) CASE(32) CASE(64) CASE(128)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16.  o_strides: the element strides (batch, head, sequence) of o; geo:
// the tensor-map geometry of q, k and v (see tc::run).  Returns a
// cudaError_t, or a negative value when no tensor map could be encoded.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* o_strides,
                                    const long long* geo, int B, int H,
                                    int KV, int S, int D, int t_valid,
                                    int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define CASE(d)                                                          \
  case d:                                                                \
    return tc::run<d>(q, k, v, o, o_strides, geo, B, H, KV, S, t_valid,  \
                      causal, scale, st);
    CASE(8) CASE(16) CASE(32) CASE(64) CASE(128)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}
