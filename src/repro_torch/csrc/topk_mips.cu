// Exact top-k maximum inner product search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/topk_mips/kernel.py:
//   * topk_mips_kernel      (body _mips_kernel)      -> topk_mips_f32 / topk_mips_bf16
//   * topk_mips_kernel_int8 (body _mips_kernel_int8) -> topk_mips_int8
// and adds topk_mips_scan_f32 for f32 calls of few query rows (below).
//
// Each call returns the top k_out of [carry (kc) || the window's N corpus
// rows] per query row, in a total order: score descending, then rank
// ascending, where carry entry j has rank j and corpus row c has rank kc + c
// (lax.top_k's order over the concatenation: the carry wins ties, and within
// the window the lower row wins).  Corpus rows come back as base + c.
//
// What bounds it on this card.  At the engine's shape (Q = 256 queries, a
// chunk of N = 1024 rows, D = 768, k = 100) the product is 0.4 GFLOP on at
// most 4 MB: f32 is bound by the 67 TFLOP/s non-tensor f32 rate (no TF32:
// f32 products and sums are required), bf16 and int8 by their bytes on
// paper, but a call is so small (0.4-6 us of bound) that latency and the
// selection decide its time, not the product.
//
// Design: two launches.
//   pass 1  one block per (64 query rows) x (32 corpus rows) tile scores the
//           tile and writes only its survivors.  TMA brings the tile in
//           128-byte slabs of the feature axis (2-D tensor maps, 128-byte
//           swizzle) through a ring of STAGES slabs on mbarriers.  bf16 and
//           int8 run on the tensor cores: wgmma m64n32k16 (bf16, f32 sums)
//           or m64n32k32 (s8 . s8 -> exact s32 sums, then (raw * q_scale) *
//           c_scale as the reference rounds it).  f32 runs as a register-
//           tiled FMA product: eight warps split each slab, each lane owns
//           an 8 x 8 micro-tile (16 float4 shared loads per 256 FMAs), a
//           producer warp refills the ring as the warps release it, and the
//           eight partial tiles are summed in a fixed order.  The survivor
//           filter is exact: when the carry already
//           holds k_out entries, a corpus score can enter the output only if
//           it is strictly greater than the carry's k_out-th score tau (an
//           equal score loses to the carry on rank).  Each tile row writes
//           its survivors, compacted by a warp ballot, to its own segment of
//           32 slots with their count: no atomics, so the scratch is the
//           same on every run.
//   pass 2  one block per query row.  The carry is in the output order, so
//           its keys (an order-preserving 32-bit image of the score, then
//           the complement of the rank: unique, and larger means earlier)
//           already descend, and the output is the merge of the carry with
//           the sorted survivors, cut at k_out.  When more survive than
//           the sort's own size, max(next_pow2(k_out), RANK_MAX), a radix
//           select (8-bit digits, histograms in shared memory, warp-
//           aggregated atomics, stopping as soon as the boundary digit
//           holds exactly the keys still needed) first cuts them to their
//           best k_out.  Up to RANK_MAX keys are sorted by counting (a key's
//           place is the number of larger keys); more by a bitonic sort
//           with the keys in registers, where strides within a thread or a
//           warp need no shared memory and no barrier.  In the merge with
//           the carry each entry's place is its index in its own list plus
//           a binary search in the other.
// In the engine's steady state about k of the N columns survive, so pass 2
// sorts about k keys and need not select; with no informative carry (the
// first chunk, or the standalone top-k) every column survives and pass 2
// selects from all of them.
//
// The scan (scan_f32), a second f32 pass 1 for few query rows.  A served
// micro-batch (Q = 8 queries against MS MARCO's N = 8.8 M rows of D = 768)
// does 2 Q = 16 FLOP for every 4 bytes of corpus it reads: 4 FLOP a byte, a
// fifth of the 20 at which the f32 FMA rate (67 TFLOP/s) and HBM (3.35
// TB/s) meet, so reading the 27 GB once (8.1 ms) bounds it.  The tiled
// pass above pads such a batch to 64 query rows, runs a block per 32 rows
// and, at 16,384 candidates a window, cuts the corpus into 541 windows of
// two launches each.  The scan instead reads the corpus once in one
// persistent launch of a block per SM: every block owns a contiguous span
// of rows, holds the queries in shared memory, streams its rows through
// per-warp TMA rings of boxes of 32 rows x 384 contiguous bytes, scores a
// row a lane with the tiled pass's exact arithmetic (the same fmaf chains
// and the same sum of eight partials, so the scores are bit-equal), and
// keeps an exact running top k_out per query; it writes that list as its
// pass-1 segment, and pass 2 (unchanged) takes the top k_out of the
// blocks' lists.  The wrapper takes the scan only where the tiled pass
// would need more than one window, the call has no carry, Q <= 16, k_out
// <= 32 and the queries fit its shared memory (topk_mips_scan_f32).
//
// The carry must be in the output order (the previous call's output, or a
// constant fill): tau is read as its k_out-th entry, and pass 2 merges it
// as a sorted list.
//
// Both launches use programmatic dependent launch, so each kernel is set up
// (and pass 2 reads the carry) while the previous one drains.
//
// Rows must be 16-byte multiples (the wrapper pads D with zeros where they
// are not) and 16-byte aligned.  Every entry point returns
// cudaGetLastError() after its launches; it allocates nothing and launches
// on the stream it is given.  topk_mips_init() sets the kernels' shared-
// memory limits once.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int BM = 64;             // query rows per pass-1 tile
constexpr int BN = 32;             // corpus rows per pass-1 tile (= warp)
constexpr int SLAB = 128;          // bytes of a feature row per TMA box
constexpr int STAGES = 8;          // depth of the TMA ring
constexpr int STAGE_BYTES = (BM + BN) * SLAB;
constexpr int RING_SMEM = 1024 + STAGES * STAGE_BYTES;
constexpr int F32_WARPS = 8;       // one per 16-byte column chunk of a slab
constexpr int F32_THREADS = 32 * (F32_WARPS + 1);   // + a producer warp
constexpr int F32_PART = BM * (BN + 1);   // one warp's partial tile (floats)
static_assert(4 * F32_WARPS * F32_PART <= STAGES * STAGE_BYTES,
              "the partial tiles reuse the ring");
constexpr int SEL_THREADS = 256;   // one thread per radix bin
constexpr int RANK_MAX = 256;      // survivors sorted by counting
constexpr int MAX_CAND = 16384;    // pass-2 keys per row (carry + window)
constexpr int MAX_K = 4096;
constexpr unsigned FULL = 0xffffffffu;

struct __align__(8) Survivor {  // one pass-1 survivor: score and window row
  float s;
  int col;
};

// Programmatic dependent launch: a kernel launched with it is set up while
// the previous kernel of the stream drains, and waits here before it reads
// what that kernel may have written.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---------------------------------------------------------------------------
// pass 1, shared tail: mask, filter, compact
// ---------------------------------------------------------------------------

// tau[r] of each tile row: the carry's k_out-th score when the carry holds
// k_out entries (filtering on), else unused.
__device__ __forceinline__ void load_tau(float* tau, const float* carry_s,
                                         int row0, int Q, int kc, int k_out) {
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const int gr = row0 + r;
    tau[r] = (kc >= k_out && gr < Q)
                 ? carry_s[(size_t)gr * kc + k_out - 1]
                 : -INFINITY;
  }
}

// Each warp takes tile rows in turn; lane j holds column col0 + j.  A row's
// survivors go to its segment (row, tile) of BN slots, in column order, and
// their number to cnt.
__device__ __forceinline__ void emit_survivors(const float (*tile)[BN + 1],
                                               const float* tau, int row0,
                                               int col0, int Q, int N,
                                               bool filter, int n_tiles,
                                               Survivor* seg, int* cnt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = col0 + lane;
  for (int r = warp; r < BM && row0 + r < Q; r += blockDim.x / 32) {
    const float s = tile[r][lane];
    const bool keep = col < N && (!filter || s > tau[r]);
    const unsigned m = __ballot_sync(FULL, keep);
    const size_t slot = (size_t)(row0 + r) * n_tiles + col0 / BN;
    if (keep) seg[slot * BN + __popc(m & ((1u << lane) - 1))] = {s, col};
    if (lane == 0) cnt[slot] = __popc(m);
  }
}

// ---------------------------------------------------------------------------
// pass 1: a TMA ring of feature slabs, then wgmma (bf16, int8) or FMA (f32)
// ---------------------------------------------------------------------------

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

// One TMA box of a 2-D map (feature, row) into shared memory; its bytes
// complete a transaction of ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Slab i (128 bytes of every row's features) of the q tile and of the
// corpus tile into ring slot i % STAGES, completing that slot's barrier.
__device__ __forceinline__ void load_slab(const CUtensorMap* tq,
                                          const CUtensorMap* tcor,
                                          uint32_t ring, uint32_t full0, int i,
                                          int cols, int row0, int col0) {
  const int s = i % STAGES;
  const uint32_t dst = ring + s * STAGE_BYTES, bar = full0 + 8 * s;
  mbar_expect_tx(bar, STAGE_BYTES);
  tma_load(dst, tq, bar, i * cols, row0);
  tma_load(dst + BM * SLAB, tcor, bar, i * cols, col0);
}

// Before the kernel's first TMA load: fetch the two tensor maps and set up
// the ring's full barriers (one arrival each: the producer's) and, when
// given, its empty barriers.
__device__ __forceinline__ void ring_setup(const CUtensorMap* tq,
                                           const CUtensorMap* tcor,
                                           uint32_t full0, uint32_t empty0,
                                           int consumers) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tq))
               : "memory");
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(tcor))
               : "memory");
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(full0 + 8 * s, 1);
    if (consumers) mbar_init(empty0 + 8 * s, consumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte swizzled
// rows: start address, stride of 8 rows = 1024 bytes, layout 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
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

// d (64 x 32) += A (64 x 16) . B (16 x 32), bf16 in, f32 sums; A and B
// K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 32) . B (32 x 32), s8 in, exact s32 sums; A and B
// K-major in shared memory
__device__ __forceinline__ void wgmma(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product's issue and wait.
__device__ __forceinline__ void reg_fence(float (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void reg_fence(int (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One warpgroup.  A slab is 128 bytes of every row's features: 64 bf16 or
// 128 int8 columns, i.e. four wgmma k-steps of 32 bytes.  Thread 0 keeps
// STAGES slabs in flight and refills a slot once every warp's product has
// read it.  Accumulator layout: thread (warp w, lane l) holds rows
// 16w + l/4 (+8) and columns 8j + 2(l%4) (+1), j < 4.
template <typename Acc>
__global__ void __launch_bounds__(128)
score_tc(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tcor,
         const float* __restrict__ q_scale, const float* __restrict__ c_scale,
         int Q, int N, int n_slabs, const float* __restrict__ carry_s, int kc,
         int k_out, int n_tiles, Survivor* __restrict__ seg,
         int* __restrict__ cnt) {
  constexpr bool INT8 = std::is_same<Acc, int>::value;
  constexpr int SLAB_COLS = INT8 ? SLAB : SLAB / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float tile[BM][BN + 1];
  __shared__ float tau[BM];
  __shared__ __align__(8) uint64_t bars[STAGES];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar0 = smem_addr(bars);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);

  if (tid == 0) ring_setup(&tq, &tcor, bar0, 0, 0);
  wait_for_previous();
  if (tid == 0)
    for (int i = 0; i < n_slabs && i < STAGES; ++i)
      load_slab(&tq, &tcor, ring, bar0, i, SLAB_COLS, row0, col0);
  load_tau(tau, carry_s, row0, Q, kc, k_out);
  // int8: this thread's two row scales and eight column scales
  float qsc[2] = {1.f, 1.f}, csc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) csc[i] = 1.f;
  if (INT8) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + r_lo + 8 * r < Q) qsc[r] = q_scale[row0 + r_lo + 8 * r];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = col0 + 8 * j + c_lo + e;
        if (gc < N) csc[2 * j + e] = c_scale[gc];
      }
  }
  __syncthreads();

  Acc acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  for (int i = 0; i < n_slabs; ++i) {
    const int s = i % STAGES;
    mbar_wait(bar0 + 8 * s, (i / STAGES) & 1);
    const uint32_t a = ring + s * STAGE_BYTES, b = a + BM * SLAB;
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < SLAB / 32; ++ks)
      wgmma(acc, smem_desc(a + 32 * ks), smem_desc(b + 32 * ks));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    if (i + STAGES < n_slabs) {
      __syncthreads();          // every warp's product has read slot s
      if (tid == 0)
        load_slab(&tq, &tcor, ring, bar0, i + STAGES, SLAB_COLS, row0, col0);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = static_cast<float>(acc[4 * j + 2 * r + e]);
        // int8: dequantize exactly as the reference, (float(raw) * qs) * cs
        if (INT8) v = __fmul_rn(__fmul_rn(v, qsc[r]), csc[2 * j + e]);
        tile[r_lo + 8 * r][8 * j + c_lo + e] = v;
      }
  __syncthreads();
  emit_survivors(tile, tau, row0, col0, Q, N, kc >= k_out, n_tiles, seg, cnt);
}

// f32: eight consumer warps split each slab's 32 features, warp w taking
// the 16-byte chunk w of every row, and each lane keeps an 8 x 8 micro-tile
// (rows l % 8 + 8 i, columns l / 8 + 4 j): one warp's 16 float4 shared
// loads feed 256 FMAs.  The 128-byte swizzle stores chunk w of row r at
// chunk w ^ (r % 8), so a quarter warp's eight q rows hit eight distinct
// bank groups and its one c row is a broadcast.  A producer warp keeps the
// ring full; a slot is refilled once all eight warps have arrived on its
// empty barrier, so the warps drift apart and one warp's loads overlap
// another's FMAs.  The eight partial tiles are summed in a fixed order, so
// every run gives the same scores.
__global__ void __launch_bounds__(F32_THREADS)
score_f32(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tcor, int Q, int N, int n_slabs,
          const float* __restrict__ carry_s, int kc, int k_out, int n_tiles,
          Survivor* __restrict__ seg, int* __restrict__ cnt) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float tile[BM][BN + 1];
  __shared__ float tau[BM];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;
  float* ring_f = reinterpret_cast<float*>(smem_raw + (ring - base));
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rq = lane % 8, rc = lane / 8;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  if (tid == 0) ring_setup(&tq, &tcor, full0, empty0, F32_WARPS);
  wait_for_previous();
  load_tau(tau, carry_s, row0, Q, kc, k_out);
  __syncthreads();

  float acc[8][8] = {};
  if (warp == F32_WARPS) {
    if (lane == 0)
      for (int i = 0; i < n_slabs; ++i) {
        if (i >= STAGES)
          mbar_wait(empty0 + 8 * (i % STAGES), (i / STAGES - 1) & 1);
        load_slab(&tq, &tcor, ring, full0, i, SLAB / 4, row0, col0);
      }
  } else {
    for (int i = 0; i < n_slabs; ++i) {
      const int s = i % STAGES;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const float* qs = ring_f + s * (STAGE_BYTES / 4);
      const float* cs = qs + BM * (SLAB / 4);
      float4 a[8], b[8];
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
        a[i8] = *reinterpret_cast<const float4*>(
            qs + (rq + 8 * i8) * (SLAB / 4) + 4 * (warp ^ rq));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = rc + 4 * j;
        b[j] = *reinterpret_cast<const float4*>(cs + r * (SLAB / 4) +
                                                4 * (warp ^ (r % 8)));
      }
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i8][j] = fmaf(a[i8].x, b[j].x, acc[i8][j]);
          acc[i8][j] = fmaf(a[i8].y, b[j].y, acc[i8][j]);
          acc[i8][j] = fmaf(a[i8].z, b[j].z, acc[i8][j]);
          acc[i8][j] = fmaf(a[i8].w, b[j].w, acc[i8][j]);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
  }
  __syncthreads();              // every slab is consumed: reuse the ring
  if (warp < F32_WARPS) {
    float* part = ring_f + warp * F32_PART;
#pragma unroll
    for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[(rq + 8 * i8) * (BN + 1) + rc + 4 * j] = acc[i8][j];
  }
  __syncthreads();
  for (int r = warp; r < BM; r += F32_WARPS + 1) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < F32_WARPS; ++w)
      v += ring_f[w * F32_PART + r * (BN + 1) + lane];
    tile[r][lane] = v;
  }
  __syncthreads();
  emit_survivors(tile, tau, row0, col0, Q, N, kc >= k_out, n_tiles, seg, cnt);
}

// ---------------------------------------------------------------------------
// pass 2: radix select of the k_out-th key, then a sort of k_out keys
// ---------------------------------------------------------------------------

// Order-preserving 64-bit key: the score's bits flipped so that unsigned
// order is float order (-0 taken as +0), then ~rank, so that a larger key
// comes first in the output order.
__device__ __forceinline__ uint64_t make_key(float s, uint32_t rank) {
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return static_cast<uint64_t>(u) << 32 | (0xFFFFFFFFu - rank);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// Warp-wide inclusive prefix sum.
__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// How many of the n keys of the descending array a are larger than key.
__device__ __forceinline__ int count_larger(const uint64_t* a, int n,
                                            uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool LARGER>
__device__ __forceinline__ uint64_t pick(uint64_t a, uint64_t b) {
  return LARGER == (a > b) ? a : b;
}

// Bitonic sort of keys[0 .. N2) in shared memory, descending, by the whole
// block.  Thread t holds keys E t .. E t + E - 1 in registers: strides
// below E are swaps in registers, strides below 32 E are warp shuffles,
// and only the longer ones go through shared memory.
template <int LOG2N>
__device__ __forceinline__ void block_sort(uint64_t* keys) {
  constexpr int N2 = 1 << LOG2N;
  constexpr int E = N2 > SEL_THREADS ? N2 / SEL_THREADS : 1;
  const int t = threadIdx.x;
  const bool active = t * E < N2;
  uint64_t x[E];
#pragma unroll
  for (int r = 0; r < E; ++r) x[r] = active ? keys[t * E + r] : 0;
#pragma unroll
  for (int ls = 1; ls <= LOG2N; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride < E) {
#pragma unroll
        for (int r = 0; r < E; ++r)
          if ((r & stride) == 0) {
            const bool desc = ((t * E + r) & size) == 0;
            const uint64_t a = x[r], b = x[r + stride];
            x[r] = desc ? pick<true>(a, b) : pick<false>(a, b);
            x[r + stride] = desc ? pick<false>(a, b) : pick<true>(a, b);
          }
      } else {
        if (stride >= 32 * E) {
          __syncthreads();        // every read of the last round is done
          if (active)
#pragma unroll
            for (int r = 0; r < E; ++r) keys[t * E + r] = x[r];
          __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int i = t * E + r;
          const uint64_t y = stride < 32 * E
                                 ? __shfl_xor_sync(FULL, x[r], stride / E)
                                 : (active ? keys[i ^ stride] : 0);
          // the lower of a pair keeps the larger key in a descending run
          const bool larger = ((i & stride) == 0) == ((i & size) == 0);
          x[r] = larger ? pick<true>(x[r], y) : pick<false>(x[r], y);
        }
      }
    }
  }
  __syncthreads();
  if (active)
#pragma unroll
    for (int r = 0; r < E; ++r) keys[t * E + r] = x[r];
  __syncthreads();
}

// One block per query row.  The carry is already in the output order (its
// keys descend), so the row's output is the merge of the carry with the
// sorted survivors, cut at k_out.  Shared memory: kc carry keys, n_tiles *
// BN survivor keys (gathered in any order), sort_n = max(next_pow2(k_out),
// RANK_MAX) keys for the survivors' sort, kc carry indices.
__global__ void __launch_bounds__(SEL_THREADS)
select_topk(const Survivor* __restrict__ seg, const int* __restrict__ cnt,
            int n_tiles, const float* __restrict__ carry_s,
            const int* __restrict__ carry_i, int kc, int base, int k_out,
            int sort_n, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) uint64_t carry_keys[];
  __shared__ int hist[2][256];
  __shared__ int fill, taken;
  __shared__ int sel_bin, sel_need, sel_done;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t row = blockIdx.x;
  uint64_t* surv = carry_keys + kc;
  uint64_t* best = surv + (size_t)n_tiles * BN;
  int* cidx = reinterpret_cast<int*>(best + sort_n);
  const int kc_used = min(kc, k_out);   // later carry entries never enter

  // the carry predates pass 1: read it while pass 1 may still run
  for (int e = tid; e < kc_used; e += SEL_THREADS) {
    carry_keys[e] = make_key(carry_s[row * kc + e], e);
    cidx[e] = carry_i[row * kc + e];
  }
  if (tid == 0) fill = taken = 0;
  hist[0][tid] = 0;
  __syncthreads();
  wait_for_previous();

  // survivors: warp w takes tiles w, w + 8, ...; lane j of a group of 32
  // such tiles reads one count, and the warp copies each tile's survivors,
  // one per lane.  Slots are read four tiles at a time whatever their
  // counts, so that the first four are in flight beside the counts.
  constexpr int WARPS = SEL_THREADS / 32;
  for (int t0 = warp; t0 < n_tiles; t0 += 32 * WARPS) {
    const int groups = min(32, (n_tiles - t0 + WARPS - 1) / WARPS);
    const Survivor* first = seg + (row * n_tiles + t0) * BN + lane;
    Survivor v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < groups) v[u] = first[u * WARPS * BN];
    const int t = t0 + WARPS * lane;
    const int n = t < n_tiles ? cnt[row * n_tiles + t] : 0;
    const int incl = warp_incl_sum(n, lane);
    int at = 0;
    if (lane == 31) at = atomicAdd(&fill, incl);
    at = __shfl_sync(FULL, at, 31) + incl - n;
    for (int j0 = 0; j0 < groups; j0 += 4) {
      if (j0 > 0)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j0 + u < groups) v[u] = first[(j0 + u) * WARPS * BN];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < groups) {
          const int nj = __shfl_sync(FULL, n, j0 + u);
          const int aj = __shfl_sync(FULL, at, j0 + u);
          if (lane < nj) surv[aj + lane] = make_key(v[u].s, kc + v[u].col);
        }
    }
  }
  __syncthreads();
  const int S = fill;

  // more survivors than the sort takes: radix-select the leading digits of
  // their k_out-th largest key, until the boundary digit holds exactly the
  // keys still needed.  Two histograms alternate so that the next one is
  // cleared while this one is read.
  uint64_t prefix = 0, mask = 0;
  int need = k_out;
  for (int pass = 0, shift = 56; S > sort_n && shift >= 0;
       ++pass, shift -= 8) {
    int* h = hist[pass & 1];
    for (int e0 = 0; e0 < S; e0 += SEL_THREADS) {
      const int e = e0 + tid;
      const bool in = e < S && (surv[e] & mask) == prefix;
      const int d = in ? static_cast<int>((surv[e] >> shift) & 0xFF)
                       : 256 + lane;
      const unsigned same = __match_any_sync(FULL, d);
      if (in && lane == __ffs(same) - 1) atomicAdd(&h[d], __popc(same));
    }
    hist[(pass + 1) & 1][tid] = 0;
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = h[255 - 8 * lane - i];
        sum += c[i];
      }
      const int incl = warp_incl_sum(sum, lane);
      int before = incl - sum;
      if (before < need && need <= incl) {
        int bin = -1, left = 0, in_bin = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (bin < 0 && before + c[i] >= need) {
            bin = 255 - 8 * lane - i;
            left = need - before;
            in_bin = c[i];
          }
          before += c[i];
        }
        sel_bin = bin;
        sel_need = left;
        sel_done = in_bin == left;
      }
    }
    __syncthreads();
    prefix |= static_cast<uint64_t>(sel_bin) << shift;
    mask |= static_cast<uint64_t>(0xFF) << shift;
    need = sel_need;
    if (sel_done) break;
  }

  // the R survivors at or above the boundary (all of them when they fit)
  for (int e0 = 0; e0 < S; e0 += SEL_THREADS) {
    const int e = e0 + tid;
    const bool in = e < S && (surv[e] & mask) >= prefix;
    const unsigned m = __ballot_sync(FULL, in);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&taken, __popc(m));
    at = __shfl_sync(FULL, at, 0);
    if (in) best[at + __popc(m & ((1u << lane) - 1))] = surv[e];
  }
  __syncthreads();
  const int R = S > sort_n ? k_out : S;

  // sort them, descending: a few by counting (a key's place is the number
  // of larger keys), more by a bitonic sort padded to a power of two
  const uint64_t* sorted = best;
  if (R <= RANK_MAX) {
    for (int e = tid; e < R; e += SEL_THREADS) {
      const uint64_t key = best[e];
      int larger = 0;
#pragma unroll 4
      for (int j = 0; j < R; ++j) larger += best[j] > key;
      surv[larger] = key;
    }
    sorted = surv;
    __syncthreads();
  } else {
    const int n2 = 1 << (32 - __clz(R - 1));
    for (int e = R + tid; e < n2; e += SEL_THREADS) best[e] = 0;
    __syncthreads();
    switch (31 - __clz(n2)) {
      case 9: block_sort<9>(best); break;
      case 10: block_sort<10>(best); break;
      case 11: block_sort<11>(best); break;
      default: block_sort<12>(best); break;
    }
  }

  // merge: an entry's place is its place in its own list plus the number
  // of larger keys in the other; places past k_out are dropped
  float* os = out_s + row * k_out;
  int* oi = out_i + row * k_out;
  for (int e = tid; e < min(R, k_out); e += SEL_THREADS) {
    const uint64_t key = sorted[e];
    const int at = e + count_larger(carry_keys, kc_used, key);
    if (at < k_out) {
      os[at] = key_score(key);
      oi[at] = base + static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(
                                                          key) - kc);
    }
  }
  for (int e = tid; e < kc_used; e += SEL_THREADS) {
    const uint64_t key = carry_keys[e];
    const int at = e + count_larger(sorted, R, key);
    if (at < k_out) {
      os[at] = key_score(key);
      oi[at] = cidx[e];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 scan for few query rows: one persistent pass over the whole corpus
// ---------------------------------------------------------------------------

constexpr int SCAN_WARPS = 4;      // warps of a block, each with its own ring
constexpr int SCAN_SB = 3;         // slabs of a row per TMA box (odd: below)
constexpr int SCAN_STAGES = 3;     // boxes in flight per warp
constexpr int SCAN_BOX = 32 * SCAN_SB * SLAB;   // 32 rows, one per lane
constexpr int SCAN_RING = SCAN_WARPS * SCAN_STAGES * SCAN_BOX;
constexpr int SCAN_MAX_Q = 16;
constexpr int SCAN_MAX_K = BN;     // a block's list fills one pass-1 segment
constexpr int SCAN_QUERY_BYTES = 48 * 1024;     // the queries' shared memory
constexpr int SCAN_SMEM = 1024 + SCAN_RING + SCAN_QUERY_BYTES +
                          SCAN_WARPS * SCAN_MAX_Q * BN * 8;

// Insert into a warp's descending list (lane j holds its j-th key) the key
// of each lane of m that beats the list's k_out-th key, lowest lane first.
// Keys are unique, so the place of x is the number of larger keys.
__device__ __forceinline__ uint64_t insert_keys(uint64_t list, uint64_t key,
                                                unsigned m, int k_out,
                                                int lane) {
  while (m) {
    const int src = __ffs(m) - 1;
    const uint64_t x = __shfl_sync(FULL, key, src);
    const int at = __popc(__ballot_sync(FULL, list > x));
    const uint64_t up = __shfl_up_sync(FULL, list, 1);
    list = lane < at ? list : lane == at ? x : up;
    const uint64_t kth = __shfl_sync(FULL, list, k_out - 1);
    m = __ballot_sync(FULL, key > kth) & (src == 31 ? 0u : ~0u << (src + 1));
  }
  return list;
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Few query rows (Q <= QB <= 16): the corpus streams through once, in a
// persistent grid.  Block b owns the contiguous span of 32-row tiles
// [b T / G, (b + 1) T / G); its warp w takes tiles w, w + SCAN_WARPS, ...
// of the span, one row a lane.  Each warp feeds its own ring: lane 0 asks
// TMA for box it + SCAN_STAGES once every lane has arrived on the empty
// barrier of box it.  A box is sb 128-byte slabs of its 32 rows (sb =
// SCAN_SB through a 3-D map when D is a multiple of 32 floats, else 1
// through a 2-D one), swizzled on 128-byte rows: the 128-byte row lane * sb
// + y holds chunk w at w ^ ((lane * sb + y) % 8), so with sb odd a quarter
// warp's eight rows hit eight distinct bank groups.  The queries sit in
// shared memory (zero past Q and D) and each read is a broadcast.  A lane
// scores its row as score_f32 does, bit for bit: partial w is the fmaf
// chain over features 32 i + 4 w + {0, 1, 2, 3} in slab order, and the
// score is 0.f + partial 0 + ... + partial 7.  Each warp keeps an exact
// descending list of keys per query; a key enters only if it beats the
// list's k_out-th, so after the first rows almost none does.  At the end the
// lists of a query are merged into the first warp's and the block writes
// it as pass-1 segment (query, block): pass 2 takes the top k_out of the
// union of exact per-span lists, which is the corpus's.
template <int QB>
__global__ void __launch_bounds__(32 * SCAN_WARPS, 1)
scan_f32(const __grid_constant__ CUtensorMap tcor, const float* __restrict__ q,
         int Q, int N, int D, int n_slabs, int sb, int k_out,
         Survivor* __restrict__ seg, int* __restrict__ cnt) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * SCAN_WARPS * SCAN_STAGES];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t ring0 = (base + 1023) & ~1023u;
  const uint8_t* ring_p = smem_raw + (ring0 - base) +
                          warp * SCAN_STAGES * SCAN_BOX;
  const uint32_t ring = ring0 + warp * SCAN_STAGES * SCAN_BOX;
  float* qsm = reinterpret_cast<float*>(smem_raw + (ring0 - base) + SCAN_RING);
  const int q_row = n_slabs * 32;                 // floats per query row
  uint64_t* lists = reinterpret_cast<uint64_t*>(qsm + QB * q_row);
  const uint32_t full = smem_addr(bars) + 8 * SCAN_STAGES * warp;
  const uint32_t empty = full + 8 * SCAN_STAGES * SCAN_WARPS;

  const int tiles = (N + 31) / 32;
  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int mine = t1 - t0 > warp
                       ? (t1 - t0 - warp + SCAN_WARPS - 1) / SCAN_WARPS
                       : 0;
  const int boxes = (n_slabs + sb - 1) / sb;      // a tile's boxes
  const int loads = mine * boxes;
  auto load = [&](int it) {
    const int s = it % SCAN_STAGES;
    const int row0 = (t0 + warp + it / boxes * SCAN_WARPS) * 32;
    const int slab0 = it % boxes * sb;
    mbar_expect_tx(full + 8 * s, 32 * sb * SLAB);
    if (sb > 1)
      tma_load3(ring + s * SCAN_BOX, &tcor, full + 8 * s, 0, slab0, row0);
    else
      tma_load(ring + s * SCAN_BOX, &tcor, full + 8 * s, slab0 * 32, row0);
  };

  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&tcor))
                 : "memory");
    for (int s = 0; s < SCAN_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  wait_for_previous();
  if (lane == 0)
    for (int it = 0; it < SCAN_STAGES && it < loads; ++it) load(it);
  for (int i = tid; i < QB * q_row; i += blockDim.x) {
    const int r = i / q_row, f = i % q_row;
    qsm[i] = r < Q && f < D ? q[(size_t)r * D + f] : 0.f;
  }
  for (int i = tid; i < SCAN_WARPS * QB * BN; i += blockDim.x) lists[i] = 0;
  __syncthreads();

  for (int j = 0, it = 0; j < mine; ++j) {
    float acc[QB][8];
#pragma unroll
    for (int qi = 0; qi < QB; ++qi)
#pragma unroll
      for (int w = 0; w < 8; ++w) acc[qi][w] = 0.f;
    for (int bx = 0; bx < boxes; ++bx, ++it) {
      const int s = it % SCAN_STAGES;
      mbar_wait(full + 8 * s, (it / SCAN_STAGES) & 1);
      const int ns = min(sb, n_slabs - bx * sb);
      for (int y = 0; y < ns; ++y) {
        const int r128 = lane * sb + y;           // the box's 128-byte row
        const uint8_t* src = ring_p + s * SCAN_BOX + r128 * SLAB;
        float4 b[8];
#pragma unroll
        for (int w = 0; w < 8; ++w)
          b[w] = *reinterpret_cast<const float4*>(src + 16 * (w ^ (r128 & 7)));
        const float* qs = qsm + (bx * sb + y) * 32;
#pragma unroll
        for (int qi = 0; qi < QB; ++qi)
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            const float4 a =
                *reinterpret_cast<const float4*>(qs + qi * q_row + 4 * w);
            acc[qi][w] = fmaf(a.x, b[w].x, acc[qi][w]);
            acc[qi][w] = fmaf(a.y, b[w].y, acc[qi][w]);
            acc[qi][w] = fmaf(a.z, b[w].z, acc[qi][w]);
            acc[qi][w] = fmaf(a.w, b[w].w, acc[qi][w]);
          }
      }
      mbar_arrive(empty + 8 * s);
      if (lane == 0 && it + SCAN_STAGES < loads) {
        mbar_wait(empty + 8 * s, (it / SCAN_STAGES) & 1);
        load(it + SCAN_STAGES);
      }
    }
    const int row = (t0 + warp + j * SCAN_WARPS) * 32 + lane;
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) {
      if (qi >= Q) break;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += acc[qi][w];
      const uint64_t key = row < N ? make_key(v, row) : 0;
      uint64_t* list = lists + (warp * QB + qi) * BN;
      const unsigned m = __ballot_sync(FULL, key > list[k_out - 1]);
      if (m) {
        list[lane] = insert_keys(list[lane], key, m, k_out, lane);
        __syncwarp();
      }
    }
  }

  // merge the warps' lists of a query into the first warp's; a list past
  // its k_out-th key holds nothing the union's top k_out can take
  __syncthreads();
  for (int qi = warp; qi < Q; qi += SCAN_WARPS) {
    uint64_t list = lists[qi * BN + lane];
    for (int w2 = 1; w2 < SCAN_WARPS; ++w2) {
      const uint64_t key = lists[(w2 * QB + qi) * BN + lane];
      const uint64_t kth = __shfl_sync(FULL, list, k_out - 1);
      list = insert_keys(list, key,
                         __ballot_sync(FULL, lane < k_out && key > kth), k_out,
                         lane);
    }
    const int n = __popc(__ballot_sync(FULL, lane < k_out && list != 0));
    const size_t at = (size_t)qi * gridDim.x + blockIdx.x;
    if (lane < n)
      seg[at * BN + lane] = {key_score(list),
                             static_cast<int>(0xFFFFFFFFu -
                                              static_cast<uint32_t>(list))};
    if (lane == 0) cnt[at] = n;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled = nullptr;

// Error codes besides cudaError_t: cuTensorMapEncodeTiled was not found,
// or it refused a map (-CUresult).
constexpr int NO_ENCODER = -999;

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

size_t select_smem(int kc, int n_tiles, int sort_n) {
  return sizeof(uint64_t) * ((size_t)kc + (size_t)n_tiles * BN + sort_n) +
         sizeof(int) * (size_t)kc;
}



// Launch with programmatic stream serialization: the kernel may start
// while the previous one drains, and waits (griddepcontrol.wait) before it
// reads what that one wrote.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Pass 1 wrote seg / cnt; pass 2 over them.
int select_pass(const Survivor* seg, const int* cnt, int Q, int n_tiles,
                const float* carry_s, const int* carry_i, int kc, int base,
                int k_out, float* out_s, int* out_i, cudaStream_t st) {
  const int sort_n = max(next_pow2(k_out), RANK_MAX);
  const cudaError_t err =
      launch(select_topk, dim3(Q), SEL_THREADS,
             select_smem(kc, n_tiles, sort_n), st, seg, cnt, n_tiles, carry_s,
             carry_i, kc, base, k_out, sort_n, out_s, out_i);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// What every entry point checks: the window fits pass 2, k_out fits the
// sort, rows are 16-byte multiples.
bool bad_shape(int Q, int N, int D, int row_bytes, int kc, int k_out) {
  const int n_tiles = (N + BN - 1) / BN;
  return Q <= 0 || N <= 0 || D <= 0 || row_bytes % 16 || k_out <= 0 ||
         k_out > MAX_K || k_out > kc + N ||
         kc + n_tiles * BN > MAX_CAND;
}

// A 2-D map (feature, row) over a row-major (rows, D) tensor in 128-byte
// boxes of box_rows rows, 128-byte swizzle; out-of-bounds reads are zeros.
// With box_slabs > 0 (D a multiple of 128 bytes) the map is 3-D (feature
// in a slab, slab, row) and a box holds box_slabs consecutive slabs of each
// of its rows.  A map only describes an address and a geometry, so the last
// few are kept and reused for the same (address, rows, D, type, box).
struct MapEntry {
  CUtensorMap map;
  const void* p;
  int rows, D, es, box_rows, box_slabs;
};
constexpr int MAP_CACHE = 16;
MapEntry map_cache[MAP_CACHE];
int map_next = 0;
std::mutex map_lock;

int encode(CUtensorMap* map, int es, const void* p, int rows, int D,
           int box_rows, int box_slabs = 0) {
  std::lock_guard<std::mutex> guard(map_lock);
  for (const MapEntry& m : map_cache)
    if (m.p == p && m.rows == rows && m.D == D && m.es == es &&
        m.box_rows == box_rows && m.box_slabs == box_slabs) {
      *map = m.map;
      return 0;
    }
  const cuuint32_t cols = SLAB / es;
  const cuuint64_t dims2[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t dims3[3] = {cols, (cuuint64_t)D / cols, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {box_slabs ? (cuuint64_t)SLAB
                                           : (cuuint64_t)D * es,
                                 (cuuint64_t)D * es};
  const cuuint32_t box2[2] = {cols, (cuuint32_t)box_rows};
  const cuuint32_t box3[3] = {cols, (cuuint32_t)box_slabs,
                              (cuuint32_t)box_rows};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode_tiled(
      map,
      es == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      box_slabs ? 3 : 2, const_cast<void*>(p), box_slabs ? dims3 : dims2,
      strides, box_slabs ? box3 : box2, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  map_cache[map_next] = {*map, p, rows, D, es, box_rows, box_slabs};
  map_next = (map_next + 1) % MAP_CACHE;
  return 0;
}

size_t scan_smem(int qb, int n_slabs) {
  return 1024 + SCAN_RING + (size_t)qb * n_slabs * SLAB +
         (size_t)SCAN_WARPS * qb * BN * 8;
}

// The scan's pass 1, then pass 2 over its blocks' lists.
int scan(const void* q, const void* c, int Q, int N, int D, int k_out,
         int blocks, Survivor* seg, int* cnt, float* out_s, int* out_i,
         cudaStream_t st) {
  const int n_slabs = (D * 4 + SLAB - 1) / SLAB;
  const int qb = next_pow2(Q);
  if (Q <= 0 || Q > SCAN_MAX_Q || N <= 0 || D <= 0 || D % 4 ||
      k_out <= 0 || k_out > SCAN_MAX_K || k_out > N || blocks <= 0 ||
      blocks * BN > MAX_CAND || qb * n_slabs * SLAB > SCAN_QUERY_BYTES)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled == nullptr) return NO_ENCODER;
  const int sb = D % 32 == 0 ? SCAN_SB : 1;
  CUtensorMap tcor;
  const int rc = encode(&tcor, 4, c, N, D, 32, sb > 1 ? sb : 0);
  if (rc != 0) return rc;
  const size_t smem = scan_smem(qb, n_slabs);
  cudaError_t err;
#define SCAN_LAUNCH(QB)                                                      \
  launch(scan_f32<QB>, dim3(blocks), 32 * SCAN_WARPS, smem, st, tcor,        \
         static_cast<const float*>(q), Q, N, D, n_slabs, sb, k_out, seg, cnt)
  switch (qb) {
    case 1: err = SCAN_LAUNCH(1); break;
    case 2: err = SCAN_LAUNCH(2); break;
    case 4: err = SCAN_LAUNCH(4); break;
    case 8: err = SCAN_LAUNCH(8); break;
    default: err = SCAN_LAUNCH(16); break;
  }
#undef SCAN_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return select_pass(seg, cnt, Q, blocks, nullptr, nullptr, 0, 0, k_out,
                     out_s, out_i, st);
}

// Both passes for elements of ES bytes: 4 (f32), 2 (bf16) or 1 (int8).
template <int ES>
int run(const void* q, const void* c, const float* q_scale,
        const float* c_scale, int Q, int N, int D, const float* carry_s,
        const int* carry_i, int kc, int base, int k_out, void* seg, int* cnt,
        float* out_s, int* out_i, void* stream) {
  if (bad_shape(Q, N, D, D * ES, kc, k_out))
    return (int)cudaErrorInvalidValue;
  if (encode_tiled == nullptr) return NO_ENCODER;
  CUtensorMap tq, tcor;
  int rc = encode(&tq, ES, q, Q, D, BM);
  if (rc == 0) rc = encode(&tcor, ES, c, N, D, BN);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + BN - 1) / BN;
  const int n_slabs = (D * ES + SLAB - 1) / SLAB;
  const dim3 grid(n_tiles, (Q + BM - 1) / BM);
  Survivor* s = static_cast<Survivor*>(seg);
  cudaError_t err;
  if constexpr (ES == 4)
    err = launch(score_f32, grid, F32_THREADS, RING_SMEM, st, tq, tcor, Q, N,
                 n_slabs, carry_s, kc, k_out, n_tiles, s, cnt);
  else
    err = launch(score_tc<typename std::conditional<ES == 1, int, float>::type>,
                 grid, 128, RING_SMEM, st, tq, tcor, q_scale, c_scale, Q, N,
                 n_slabs, carry_s, kc, k_out, n_tiles, s, cnt);
  if (err != cudaSuccess) return (int)err;
  return select_pass(s, cnt, Q, n_tiles, carry_s, carry_i, kc, base, k_out,
                     out_s, out_i, st);
}

}  // namespace

extern "C" {

// Geometry the Python wrapper needs to size scratch and windows.
int topk_mips_block_cols() { return BN; }
int topk_mips_max_candidates() { return MAX_CAND; }

// Once per device, before any launch: the kernels' shared-memory limits
// and the tensor-map encoder.  Returns a cudaError_t, or NO_ENCODER.
int topk_mips_init() {
  cudaError_t err = cudaFuncSetAttribute(
      score_tc<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        score_tc<int>, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        score_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        select_topk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)select_smem(MAX_K, (MAX_CAND - MAX_K) / BN, MAX_K));
  decltype(&scan_f32<1>) scans[] = {scan_f32<1>, scan_f32<2>, scan_f32<4>,
                                    scan_f32<8>, scan_f32<16>};
  for (auto kernel : scans)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM);
  if (err != cudaSuccess) return (int)err;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                              &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return NO_ENCODER;
  encode_tiled = reinterpret_cast<EncodeTiled>(p);
  return 0;
}

// q (Q, D) and c (N, D) row-major f32, every one of the N rows eligible.
// carry_s / carry_i: (Q, kc) running top-k in the output order, or kc = 0.
// seg: scratch of Q * ceil(N / 32) * 32 (score, row) pairs; cnt: of
// Q * ceil(N / 32) ints.  out: (Q, k_out), k_out <= kc + N.  Returned
// indices are base + row for corpus rows, carry_i's for carry rows.
// Returns a cudaError_t, or a negative value when no tensor map could be
// encoded.
int topk_mips_f32(const void* q, const void* c, int Q, int N, int D,
                  const float* carry_s, const int* carry_i, int kc, int base,
                  int k_out, void* seg, int* cnt, float* out_s, int* out_i,
                  void* stream) {
  return run<4>(q, c, nullptr, nullptr, Q, N, D, carry_s, carry_i, kc, base,
                k_out, seg, cnt, out_s, out_i, stream);
}

// Blocks of the scan on the current device: one per SM.  Returns a
// negative cudaError_t when the device cannot be read.
int topk_mips_scan_blocks() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err != cudaSuccess ? -(int)err : min(sms, MAX_CAND / BN);
}

// The scan for few query rows: q (Q, D) and c (N, D) row-major f32, every
// one of the N rows eligible, Q <= 16, k_out <= min(32, N), next_pow2(Q)
// rows of ceil(D / 32) * 32 floats within 48 KB.  One pass over c by
// ``blocks`` blocks (topk_mips_scan_blocks()), then pass 2 over their lists.
// seg: scratch of Q * blocks * 32 (score, row) pairs; cnt: of Q * blocks
// ints.  out: (Q, k_out), rows of c.  Returns a cudaError_t, or a negative
// value when no tensor map could be encoded.
int topk_mips_scan_f32(const void* q, const void* c, int Q, int N, int D,
                       int k_out, int blocks, void* seg, int* cnt,
                       float* out_s, int* out_i, void* stream) {
  return scan(q, c, Q, N, D, k_out, blocks, static_cast<Survivor*>(seg), cnt,
              out_s, out_i, static_cast<cudaStream_t>(stream));
}

// Same contract with bf16 q and c; products and sums are f32.
int topk_mips_bf16(const void* q, const void* c, int Q, int N, int D,
                   const float* carry_s, const int* carry_i, int kc, int base,
                   int k_out, void* seg, int* cnt, float* out_s, int* out_i,
                   void* stream) {
  return run<2>(q, c, nullptr, nullptr, Q, N, D, carry_s, carry_i, kc, base,
                k_out, seg, cnt, out_s, out_i, stream);
}

// int8 q and c with per-row f32 scales q_scale (Q,) and c_scale (N,).
int topk_mips_int8(const int8_t* q, const int8_t* c, const float* q_scale,
                   const float* c_scale, int Q, int N, int D,
                   const float* carry_s, const int* carry_i, int kc, int base,
                   int k_out, void* seg, int* cnt, float* out_s, int* out_i,
                   void* stream) {
  return run<1>(q, c, q_scale, c_scale, Q, N, D, carry_s, carry_i, kc, base,
                k_out, seg, cnt, out_s, out_i, stream);
}

}  // extern "C"
