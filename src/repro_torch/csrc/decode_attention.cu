// Decode attention (one query token per sequence against a KV cache, GQA,
// online softmax over a split valid prefix) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_kernel (body
// _decode_kernel) of src/repro/kernels/decode_attention/kernel.py.  The LM
// trunk reaches it from _attention with attn_impl "cuda" on the cached,
// single-token step: the call site the reference's comment names for it.
//
// What it computes.  q (B, KV, G, d) and k, v (B, KV, T, d), f32 or bf16,
// give o (B, KV, G, d) in q's type: the G query rows of KV head h attend to
// the keys t < length of that head, scale 1/sqrt(d), f32 products and sums
// (bf16 products are exact in f32), an online softmax with m, l and the
// accumulator in f32, and p kept at f32 precision for p . v, as in the TPU
// body.  The output is rounded once.
//
// What bounds it on this card.  Bytes: K and V of the valid prefix are read
// once (at decode_32k on qwen2-0.5b, 2.15 GB of bf16 per layer, 0.64 ms at
// 3.35 TB/s) against 2 G d multiply-adds per key and product.  The design
// keeps the instructions per byte low so that the memory rate, not the
// issue rate, sets the pace.
//
// Design.  The valid prefix [0, length) -- never the capacity -- is cut
// into splits of `chunk` keys (a multiple of the tile BK), about one wave of
// resident blocks in all (the wrapper's plan).  Pass 1 has one block per
// (split, b, h):
//   * a producer warp keeps a ring of STAGES (K, V) tiles of BK keys in
//     flight: one lane issues TMA loads through 4-D tensor maps (d, seq,
//     head, batch) over the views' own strides (the wrapper computes their
//     geometry, the maps are encoded once per address and geometry and
//     cached), tracked by full / empty mbarriers.  Rows are swizzled by
//     their width (32, 64 or 128 bytes; wider rows load as several boxes);
//     d = 8 is padded to 16 columns by the box, which reads zeros there.
//     A tile that crosses `length` (the prefix's ragged end, at most one per
//     (b, h)) is copied by the producer's lanes instead, keys past `length`
//     and padded columns written as zeros, so no key at or past `length` is
//     ever read;
//   * NC consumer warps take the tiles in turn (tile i to warp i % NC), each
//     with its own m, l and accumulator in registers;
//   * bf16 runs q . k and p . v as mma.sync.m16n8k16 (bf16 x bf16 -> f32).
//     The G <= 16 query rows of the KV head are the M = 16 side (zero rows
//     pad G); q's fragments are loaded once into registers; K and V come
//     from the swizzled tiles by ldmatrix (V transposed).  1/sqrt(d) (times
//     log2 e) is applied to the f32 scores, not to bf16 q, since at d = 128
//     it is not a power of two.  The score accumulators are p . v's A
//     fragments, so p never goes through shared memory; p is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi) and p . v runs as p_hi . v +
//     p_lo . v into one f32 accumulator, which keeps p at f32 precision
//     (bf16 p alone misses the half-ulp gate by ~1e-3);
//   * f32 keeps FMA products on the CUDA cores (tensor-core f32 would change
//     what the kernel computes): q * 1/sqrt(d) sits in shared memory as f32,
//     lane j scores key j of a 32-key tile for every row (G padded to GT, a
//     template power of two), p goes to shared memory and each lane
//     accumulates d / 32 output dims of every row;
//   * the warps' (m, l, acc) merge in shared memory; a single split writes o
//     directly, otherwise the block writes its partial to f32 scratch.
// Pass 2 (only with more than one split) merges the partials of each
// (b, h, g) over a slice of 32 output dims per block, splits in order, so
// the result does not depend on the order in which blocks finish:
// M = max m_i, L = sum l_i 2^(m_i - M), o = sum acc_i 2^(m_i - M) / L (m in
// log2 units).  Both passes are launched with programmatic dependent
// launch: a pass is set up while the previous kernel of the stream drains
// and waits for it before it reads global memory.
//
// Strides are taken as given (the last dimension contiguous, K and V rows on
// 16-byte boundaries, as TMA needs), so the trunk's transposed (B, T, KV, d)
// cache slices are read without a copy.  Each entry point returns the CUDA
// error of its launches (or a negative value when no tensor map could be
// encoded); it allocates nothing and launches on the stream it is given.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int GMAX = 16;           // most query rows per KV head
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_DIMS = 32;     // output dims per pass-2 block
constexpr int RING_BYTES = 160 * 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {  // element strides of the batch, head and row axes
  long long b, h, s;
};

template <typename Elem, int D>
struct Geo {
  static constexpr int ES = sizeof(Elem);
  static constexpr bool TC = ES == 2;                    // bf16: mma.sync
  static constexpr int DP = D < 16 ? 16 : D;             // row as the box pads it
  static constexpr int SW = DP * ES < 128 ? DP * ES : 128;  // box row = swizzle
  static constexpr int CB = SW / ES;                     // columns per box
  static constexpr int BOXES = DP / CB;
  static constexpr int CHUNKS = DP * ES / 16;            // 16-byte chunks a row
  static constexpr int REAL = D * ES / 16;               // of them holding values
  static constexpr int BK = TC && DP <= 64 ? 64 : 32;    // keys per tile
  static constexpr int TILE = BK * DP * ES;              // one K or V tile
  static constexpr int FIT =
      RING_BYTES / (2 * TILE) < 8 ? RING_BYTES / (2 * TILE) : 8;
  // consumer warps: 4 at bf16; 8 at f32 where 8 stages fit, else 4
  static constexpr int NC = TC || FIT < 8 ? 4 : 8;
  static constexpr int THREADS = 32 * (NC + 1);
  // a multiple of NC, so that stage s is always read by warp s % NC: a
  // parity wait then never sees a phase two tiles old
  static constexpr int STAGES = FIT / NC * NC;
  static constexpr int RING = STAGES * 2 * TILE;
  // the warps' partials after the loop: m, l and acc of 16 rows each
  static constexpr int MERGE = NC * 16 * (DP + 2) * 4;
  static constexpr int AREA = RING > MERGE ? RING : MERGE;
  static_assert(STAGES >= NC, "every consumer warp needs a stage");
  static_assert(TILE % 1024 == 0, "tiles keep the swizzle's alignment");
};

// ---------------------------------------------------------------------------
// barriers, TMA, fragments
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
// A wait of more than ~2^34 cycles (seconds) can only be a broken ring: it
// traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
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

// Programmatic dependent launch: wait for the previous kernel of the stream
// before reading what it may have written (a no-op without the attribute).
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Byte offset of 16-byte chunk c of key row r in a tile as TMA swizzles it:
// the row lies in box c / (SW / 16); within a box, address bits 4.. are
// XORed with bits 7.. (SW = 32, 64 or 128 bytes; the box is 1024-aligned).
template <class G>
__device__ __forceinline__ int tile_off(int r, int c) {
  constexpr int PER = G::SW / 16;
  const int off = r * G::SW + (c % PER) * 16;
  return (c / PER) * G::BK * G::SW + (off ^ (((off >> 7) & (PER - 1)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8) += A (16 x 16, row) . B (16 x 8, col): bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// pass 1, shared parts: the block's split, the producer, the block's merge
// ---------------------------------------------------------------------------

struct Split {
  int b, h, start, end, n_tiles;
};

template <class G>
__device__ __forceinline__ Split split_of(int KV, int length, int chunk) {
  Split s;
  s.b = blockIdx.y / KV;
  s.h = blockIdx.y % KV;
  s.start = blockIdx.x * chunk;
  s.end = min(s.start + chunk, length);
  s.n_tiles = (s.end - s.start + G::BK - 1) / G::BK;
  return s;
}

// barrier addresses: full(s) at bars + 8 s, empty(s) after them
template <class G>
__device__ __forceinline__ void init_barriers(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                       // the producer
      mbar_init(bars + 8 * (G::STAGES + s), 32);        // one consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// The producer warp: tile i of the split into stage i % STAGES, by TMA, or
// by the lanes when it crosses the split's end.
template <typename Elem, class G>
__device__ void produce(const CUtensorMap* tk, const CUtensorMap* tv,
                        const Elem* kb, const Elem* vb, long long ks,
                        long long vs, unsigned char* ring, uint32_t bars,
                        const Split& sp) {
  const int lane = threadIdx.x % 32;
  const uint32_t ring_a = smem_addr(ring);
  for (int i = 0; i < sp.n_tiles; ++i) {
    const int s = i % G::STAGES;
    const uint32_t full = bars + 8 * s, empty = bars + 8 * (G::STAGES + s);
    mbar_wait(empty, ((i / G::STAGES) & 1) ^ 1);
    const int t0 = sp.start + i * G::BK;
    unsigned char* kt = ring + s * 2 * G::TILE;
    unsigned char* vt = kt + G::TILE;
    if (t0 + G::BK <= sp.end) {
      if (lane == 0) {
        mbar_expect_tx(full, 2 * G::TILE);
        for (int c = 0; c < G::BOXES; ++c)
          tma_load(ring_a + s * 2 * G::TILE + c * G::BK * G::SW, tk, full,
                   c * G::CB, t0, sp.h, sp.b);
        for (int c = 0; c < G::BOXES; ++c)
          tma_load(ring_a + s * 2 * G::TILE + G::TILE + c * G::BK * G::SW,
                   tv, full, c * G::CB, t0, sp.h, sp.b);
      }
    } else {
      // the prefix's ragged end: keys < end as they are, the rest zeros
      for (int e = lane; e < G::BK * G::CHUNKS; e += 32) {
        const int r = e / G::CHUNKS, c = e % G::CHUNKS;
        int4 kx = make_int4(0, 0, 0, 0), vx = kx;
        if (t0 + r < sp.end && c < G::REAL) {
          const long long t = t0 + r;
          kx = *reinterpret_cast<const int4*>(kb + t * ks + c * (16 / G::ES));
          vx = *reinterpret_cast<const int4*>(vb + t * vs + c * (16 / G::ES));
        }
        const int at = tile_off<G>(r, c);
        *reinterpret_cast<int4*>(kt + at) = kx;
        *reinterpret_cast<int4*>(vt + at) = vx;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
  }
}

// After every warp has put its partial (m, l, acc of 16 rows) at area:
// merge them per (row g < G, dim i < D) and write o (one split) or the
// split's partial.
template <typename Elem, class G>
__device__ void merge_warps(const float* area, int G_rows, int D,
                            const Split& sp, int n_splits, Elem* o,
                            Strides so, float* part_m, float* part_l,
                            float* part_acc) {
  const float* Ms = area;
  const float* Ls = Ms + G::NC * 16;
  const float* As = Ls + G::NC * 16;
  const size_t part = (size_t)blockIdx.y * n_splits + blockIdx.x;
  for (int e = threadIdx.x; e < G_rows * D; e += G::THREADS) {
    const int g = e / D, i = e % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < G::NC; ++w) M = fmaxf(M, Ms[w * 16 + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < G::NC; ++w) {
      const float wgt = exp2f(Ms[w * 16 + g] - M);  // 0 for an idle warp
      L += Ls[w * 16 + g] * wgt;
      A += As[(w * 16 + g) * G::DP + i] * wgt;
    }
    if (n_splits == 1) {
      store(o + sp.b * so.b + sp.h * so.h + g * so.s + i, A / L);
    } else {
      part_acc[(part * G_rows + g) * D + i] = A;
      if (i == 0) {
        part_m[part * G_rows + g] = M;
        part_l[part * G_rows + g] = L;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1, bf16: mma.sync on tensor cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Geo<__nv_bfloat16, D>::THREADS, 1)
decode_split_tc(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk,
                Strides sv, __nv_bfloat16* __restrict__ o, Strides so, int KV,
                int G_rows, int length, int chunk, float scale_log2,
                float* __restrict__ part_m, float* __restrict__ part_l,
                float* __restrict__ part_acc) {
  using G = Geo<__nv_bfloat16, D>;
  constexpr int BK = G::BK, DP = G::DP, NC = G::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t ring_a = smem_addr(ring);
  const uint32_t bars = ring_a + G::AREA;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Split sp = split_of<G>(KV, length, chunk);

  init_barriers<G>(bars);
  __syncthreads();
  wait_for_previous();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // mma fragment coordinates: thread (g = lane / 4, c = lane % 4) holds
  // rows g and g + 8, columns 2c, 2c + 1 (and 2c + 8, 2c + 9 of A)
  const int g = lane / 4, c2 = 2 * (lane % 4);

  if (warp == NC) {
    produce<__nv_bfloat16, G>(&tk, &tv, k + sp.b * sk.b + sp.h * sk.h,
                              v + sp.b * sv.b + sp.h * sv.h, sk.s, sv.s, ring,
                              bars, sp);
  } else {
    // q's A fragments, rows past G and columns past d zero
    const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) + sp.b * sq.b +
                         sp.h * sq.h;
    uint32_t qa[DP / 16][4];
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = g + 8 * (u & 1), col = 16 * t + c2 + 8 * (u >> 1);
        qa[t][u] = 0;
        if (row < G_rows && col < D) {
          const uint16_t* p = qb + row * sq.s + col;
          qa[t][u] = (uint32_t)p[0] | ((uint32_t)p[1] << 16);
        }
      }
    // ldmatrix row addresses: lane L gives row L % 8 of matrix L / 8
    const int mi = lane / 8, mr = lane % 8;

    for (int i = warp; i < sp.n_tiles; i += NC) {
      const int s = i % G::STAGES;
      const uint32_t kt = ring_a + s * 2 * G::TILE, vt = kt + G::TILE;
      const int t0 = sp.start + i * BK;
      mbar_wait(bars + 8 * s, (i / G::STAGES) & 1);

      // S = q . K^T: n-block j holds keys 8j .. 8j + 7
      float sc[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int t = 0; t < DP / 16; ++t)
#pragma unroll
        for (int j = 0; j < BK / 8; j += 2) {
          uint32_t b[4];
          ldsm_x4(kt + tile_off<G>(8 * (j + mi / 2) + mr, 2 * t + mi % 2), b);
          mma(sc[j], qa[t], b[0], b[1]);
          mma(sc[j + 1], qa[t], b[2], b[3]);
        }

      if (t0 + BK > sp.end) {  // the ragged end: keys past it get no weight
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (t0 + 8 * j + c2 + (e & 1) >= sp.end) sc[j][e] = -INFINITY;
      }

      // online softmax in log2 units: p = 2^(s * scale log2 e - m)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= scale_log2;
          mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);  // key t0 is valid: finite
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(sc[j][e] - m[e / 2]);
          sum[e / 2] += sc[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

      // acc += p_hi . V + p_lo . V; the A fragment of keys 16t .. 16t + 15
      // is the score accumulators of n-blocks 2t and 2t + 1
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* x = &sc[2 * t + u / 2][2 * (u % 2)];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[0], x[1]);
          const float2 hf = __bfloat1622float2(h2);
          hi[u] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[u] = pack_bf16(x[0] - hf.x, x[1] - hf.y);
        }
#pragma unroll
        for (int n = 0; n < DP / 8; n += 2) {
          uint32_t b[4];
          ldsm_x4_t(vt + tile_off<G>(16 * t + 8 * (mi % 2) + mr, n + mi / 2),
                    b);
          mma(acc[n], hi, b[0], b[1]);
          mma(acc[n], lo, b[0], b[1]);
          mma(acc[n + 1], hi, b[2], b[3]);
          mma(acc[n + 1], lo, b[2], b[3]);
        }
      }
      mbar_arrive(bars + 8 * (G::STAGES + s));  // every lane: the stage is free
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
  }

  __syncthreads();  // every tile is consumed: the ring holds the partials
  float* area = reinterpret_cast<float*>(ring);
  if (warp < NC) {
    float* Ms = area + warp * 16;
    float* Ls = area + NC * 16 + warp * 16;
    float* As = area + 2 * NC * 16 + warp * 16 * DP;
    if (c2 == 0) {
      Ms[g] = m[0], Ms[g + 8] = m[1];
      Ls[g] = l[0], Ls[g + 8] = l[1];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        As[(g + 8 * (e / 2)) * DP + 8 * n + c2 + (e & 1)] = acc[n][e];
  }
  __syncthreads();
  merge_warps<__nv_bfloat16, G>(area, G_rows, D, sp, gridDim.x, o, so,
                                part_m, part_l, part_acc);
}

// ---------------------------------------------------------------------------
// pass 1, f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

template <int D, int GT>
struct GeoF32 : Geo<float, D> {
  using Base = Geo<float, D>;
  static constexpr int QS = GT * D * 4;                  // q * scale
  static constexpr int PW = GT * Base::BK * 4;           // a warp's p rows
  static constexpr size_t SMEM =
      1024 + Base::AREA + QS + Base::NC * PW + 16 * Base::STAGES;
};

template <int D, int GT>
__global__ void __launch_bounds__(Geo<float, D>::THREADS, 1)
decode_split_f32(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, Strides sq, Strides sk,
                 Strides sv, float* __restrict__ o, Strides so, int KV,
                 int G_rows, int length, int chunk, float scale,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc) {
  using G = Geo<float, D>;
  using F = GeoF32<D, GT>;
  constexpr int BK = G::BK, DP = G::DP, NC = G::NC;
  constexpr int NT = D >= 32 ? D / 32 : 1;  // output dims per lane
  static_assert(BK == 32, "lane j scores key j");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  float* Qs = reinterpret_cast<float*>(ring + G::AREA);  // GT x D
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Pw = reinterpret_cast<float*>(ring + G::AREA + F::QS) +
              warp * GT * BK;                             // GT x BK
  const uint32_t bars = smem_addr(ring) + G::AREA + F::QS + NC * F::PW;
  const Split sp = split_of<G>(KV, length, chunk);

  init_barriers<G>(bars);
  wait_for_previous();
  const float* qb = q + sp.b * sq.b + sp.h * sq.h;
  for (int e = threadIdx.x; e < GT * D; e += G::THREADS)
    Qs[e] = e < G_rows * D ? qb[(e / D) * sq.s + e % D] * scale : 0.f;
  __syncthreads();

  float m[GT], l[GT], acc[GT][NT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;  // this lane's part of the sum
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[g][t] = 0.f;
  }
  const int dl = lane * NT;  // this lane's first output dim

  if (warp == NC) {
    produce<float, G>(&tk, &tv, k + sp.b * sk.b + sp.h * sk.h,
                      v + sp.b * sv.b + sp.h * sv.h, sk.s, sv.s, ring, bars,
                      sp);
  } else {
    for (int i = warp; i < sp.n_tiles; i += NC) {
      const int s = i % G::STAGES;
      const unsigned char* kt = ring + s * 2 * G::TILE;
      const unsigned char* vt = kt + G::TILE;
      const int t0 = sp.start + i * BK;
      mbar_wait(bars + 8 * s, (i / G::STAGES) & 1);

      // scores of key t0 + lane for every row
      float sc[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) sc[g] = 0.f;
#pragma unroll 2
      for (int c = 0; c < G::REAL; ++c) {
        const float4 kf =
            *reinterpret_cast<const float4*>(kt + tile_off<G>(lane, c));
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + g * D + 4 * c);
          sc[g] = fmaf(qv.x, kf.x, sc[g]);
          sc[g] = fmaf(qv.y, kf.y, sc[g]);
          sc[g] = fmaf(qv.z, kf.z, sc[g]);
          sc[g] = fmaf(qv.w, kf.w, sc[g]);
        }
      }

      // online softmax in log2 units; key t0 is valid, so the max is finite
      const bool valid = t0 + lane < sp.end;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float x = valid ? sc[g] * LOG2E : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float corr = exp2f(m[g] - m_new);
        const float p = exp2f(x - m_new);
        l[g] = l[g] * corr + p;
        m[g] = m_new;
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[g][t] *= corr;
        Pw[g * BK + lane] = p;
      }
      __syncwarp();

      // p . v over the tile's valid keys (zero rows past them)
      const int nk = min(BK, sp.end - t0);
      const int cl = dl * 4 / 16, within = dl * 4 % 16;
#pragma unroll 2
      for (int kk = 0; kk < nk; kk += 4) {
        float vv[4][NT];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* p =
              reinterpret_cast<const float*>(vt + tile_off<G>(kk + u, cl) +
                                             within);
#pragma unroll
          for (int t = 0; t < NT; ++t) vv[u][t] = dl < D ? p[t] : 0.f;
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float4 pv = *reinterpret_cast<const float4*>(Pw + g * BK + kk);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            acc[g][t] = fmaf(pv.x, vv[0][t], acc[g][t]);
            acc[g][t] = fmaf(pv.y, vv[1][t], acc[g][t]);
            acc[g][t] = fmaf(pv.z, vv[2][t], acc[g][t]);
            acc[g][t] = fmaf(pv.w, vv[3][t], acc[g][t]);
          }
        }
      }
      __syncwarp();  // Pw is free for the next tile
      mbar_arrive(bars + 8 * (G::STAGES + s));
    }
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l[g] += __shfl_xor_sync(FULL, l[g], off);
  }

  __syncthreads();  // every tile is consumed: the ring holds the partials
  float* area = reinterpret_cast<float*>(ring);
  if (warp < NC) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        area[warp * 16 + g] = m[g];
        area[NC * 16 + warp * 16 + g] = l[g];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
        if (dl + t < D)
          area[2 * NC * 16 + (warp * 16 + g) * DP + dl + t] = acc[g][t];
    }
  }
  __syncthreads();
  merge_warps<float, G>(area, G_rows, D, sp, gridDim.x, o, so, part_m,
                        part_l, part_acc);
}

// ---------------------------------------------------------------------------
// pass 2: merge the splits
// ---------------------------------------------------------------------------

// all-thread max / sum of one value per thread, in a fixed order
__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(FULL, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < MERGE_THREADS / 32; ++w)
    x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// One block per (b, h, g) and slice of MERGE_DIMS output dims; the split
// weights 2^(m_i - M) go to shared memory once.
template <typename Elem>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge(const float* __restrict__ part_m,
             const float* __restrict__ part_l,
             const float* __restrict__ part_acc, Elem* __restrict__ o,
             Strides so, int KV, int G_rows, int D, int n_splits) {
  __shared__ float red[MERGE_THREADS];
  extern __shared__ float wgt[];  // n_splits
  wait_for_previous();
  const int g = blockIdx.x % G_rows, bh = blockIdx.x / G_rows;
  const int b = bh / KV, h = bh % KV;
  const size_t base = (size_t)bh * n_splits;
  float M = -INFINITY;
  for (int s = threadIdx.x; s < n_splits; s += MERGE_THREADS)
    M = fmaxf(M, part_m[(base + s) * G_rows + g]);
  M = block_reduce(M, true, red);
  float L = 0.f;
  for (int s = threadIdx.x; s < n_splits; s += MERGE_THREADS) {
    const float w = exp2f(part_m[(base + s) * G_rows + g] - M);
    wgt[s] = w;
    L += part_l[(base + s) * G_rows + g] * w;
  }
  L = block_reduce(L, false, red);  // its barriers publish wgt
  const int i = blockIdx.y * MERGE_DIMS + threadIdx.x % MERGE_DIMS;
  const int j = threadIdx.x / MERGE_DIMS;
  constexpr int SLICES = MERGE_THREADS / MERGE_DIMS;
  float A = 0.f;
  if (i < D) {
#pragma unroll 4
    for (int s = j; s < n_splits; s += SLICES)
      A += part_acc[((base + s) * G_rows + g) * D + i] * wgt[s];
  }
  __syncthreads();  // red is free
  red[threadIdx.x] = A;
  __syncthreads();
  if (j == 0 && i < D) {
    for (int jj = 1; jj < SLICES; ++jj) A += red[jj * MERGE_DIMS + threadIdx.x];
    store(o + b * so.b + h * so.h + g * so.s + i, A / L);
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

// Error codes besides cudaError_t: cuTensorMapEncodeTiled was not found,
// or it refused a map (-CUresult).
constexpr int NO_ENCODER = -999;

// A map only describes an address and a geometry, so the last MAP_CACHE
// are kept and reused for the same (address, element size, geometry): the
// LM trunk passes the same cache tensors at every step.
struct MapEntry {
  CUtensorMap map;
  const void* p;
  long long geo[12];
  int es;
};
constexpr int MAP_CACHE = 128;
MapEntry map_cache[MAP_CACHE];
int map_count = 0, map_next = 0;
std::mutex map_lock;

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

// geo: dims (d, seq, head, batch), byte strides of seq, head, batch, box
// (columns, rows, 1, 1), swizzle bytes
int encode(CUtensorMap* map, const void* p, const long long* geo, int es) {
  std::lock_guard<std::mutex> guard(map_lock);
  for (int e = 0; e < map_count; ++e) {
    const MapEntry& m = map_cache[e];
    bool same = m.p == p && m.es == es;
    for (int i = 0; same && i < 12; ++i) same = m.geo[i] == geo[i];
    if (same) {
      *map = m.map;
      return 0;
    }
  }
  const EncodeTiled encode_tiled = encoder();
  if (encode_tiled == nullptr) return NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)geo[0], (cuuint64_t)geo[1],
                              (cuuint64_t)geo[2], (cuuint64_t)geo[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)geo[4], (cuuint64_t)geo[5],
                                 (cuuint64_t)geo[6]};
  const cuuint32_t box[4] = {(cuuint32_t)geo[7], (cuuint32_t)geo[8], 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode_tiled(
      map,
      es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      geo[11] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : geo[11] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  MapEntry& slot = map_cache[map_next];
  slot.map = *map;
  slot.p = p;
  slot.es = es;
  for (int i = 0; i < 12; ++i) slot.geo[i] = geo[i];
  map_next = (map_next + 1) % MAP_CACHE;
  if (map_count < MAP_CACHE) ++map_count;
  return 0;
}

// Launch with programmatic stream serialization: the kernel may start
// while the previous one drains, and waits (griddepcontrol.wait) before it
// reads global memory.
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
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// pass 1's kernel, block size and shared memory for (Elem, D, GT)
template <typename Elem, int D, int GT>
struct Pass1;

template <int D, int GT>
struct Pass1<__nv_bfloat16, D, GT> {
  using G = Geo<__nv_bfloat16, D>;
  static constexpr size_t SMEM = 1024 + G::AREA + 16 * G::STAGES;
  static constexpr auto kernel() { return decode_split_tc<D>; }
  static float scale_arg(float scale) { return scale * LOG2E; }
};

template <int D, int GT>
struct Pass1<float, D, GT> {
  using G = Geo<float, D>;
  static constexpr size_t SMEM = GeoF32<D, GT>::SMEM;
  static constexpr auto kernel() { return decode_split_f32<D, GT>; }
  static float scale_arg(float scale) { return scale; }
};

template <typename Elem, int D, int GT>
cudaError_t allow_smem() {
  using P = Pass1<Elem, D, GT>;
  return cudaFuncSetAttribute(P::kernel(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)P::SMEM);
}

template <typename Elem, int D, int GT>
int slots(int* out) {
  using P = Pass1<Elem, D, GT>;
  cudaError_t err = allow_smem<Elem, D, GT>();
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, P::kernel(), P::G::THREADS, P::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  return cudaSuccess;
}

// geo: the tensor-map geometry of k, then of v (12 values each)
template <typename Elem, int D, int GT>
int run(const void* q, const void* k, const void* v, void* o,
        const long long* st, const long long* geo, int B, int KV, int G_rows,
        int length, int n_splits, int chunk, float scale, float* scratch,
        cudaStream_t stream) {
  using P = Pass1<Elem, D, GT>;
  using G = typename P::G;
  if (chunk % G::BK || n_splits < 1 || (long long)(n_splits - 1) * chunk >=
      length || (long long)n_splits * chunk < length)
    return cudaErrorInvalidValue;  // the wrapper's plan disagrees
  CUtensorMap maps[2];
  const void* base[2] = {k, v};
  for (int i = 0; i < 2; ++i) {
    const long long* g = geo + 12 * i;
    if (g[0] != D || g[7] != G::CB || g[8] != G::BK || g[11] != G::SW)
      return cudaErrorInvalidValue;  // the wrapper's geometry disagrees
    const int rc = encode(&maps[i], base[i], g, G::ES);
    if (rc != 0) return rc;
  }
  cudaError_t err = allow_smem<Elem, D, GT>();
  if (err != cudaSuccess) return err;
  const int BKV = B * KV;
  const size_t n = (size_t)BKV * n_splits * G_rows;
  float *pm = scratch, *pl = scratch + n, *pa = scratch + 2 * n;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  err = launch(P::kernel(), dim3(n_splits, BKV), G::THREADS, P::SMEM, stream,
               maps[0], maps[1], static_cast<const Elem*>(q),
               static_cast<const Elem*>(k), static_cast<const Elem*>(v), sq,
               sk, sv, static_cast<Elem*>(o), so, KV, G_rows, length, chunk,
               P::scale_arg(scale), pm, pl, pa);
  if (err != cudaSuccess) return err;
  if (n_splits == 1) return cudaGetLastError();
  err = launch(decode_merge<Elem>,
               dim3(BKV * G_rows, (D + MERGE_DIMS - 1) / MERGE_DIMS),
               MERGE_THREADS, n_splits * sizeof(float), stream, pm, pl, pa,
               static_cast<Elem*>(o), so, KV, G_rows, D, n_splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// F<GT>() for the least GT in {1, 2, 4, 8, 16} that holds G rows (f32);
// bf16 pads every G to the mma's 16 rows and has one instantiation
template <typename Elem, typename F>
int by_group(int G, F f) {
  if (G < 1 || G > GMAX) return cudaErrorInvalidValue;
  if constexpr (sizeof(Elem) == 2) {
    return f.template operator()<GMAX>();
  } else {
    if (G == 1) return f.template operator()<1>();
    if (G == 2) return f.template operator()<2>();
    if (G <= 4) return f.template operator()<4>();
    if (G <= 8) return f.template operator()<8>();
    return f.template operator()<16>();
  }
}

template <typename Elem, int D>
struct SlotsFor {
  int* out;
  template <int GT>
  int operator()() const { return slots<Elem, D, GT>(out); }
};

template <typename Elem, int D>
struct RunFor {
  const void *q, *k, *v;
  void* o;
  const long long *st, *geo;
  int B, KV, G, length, n_splits, chunk;
  float scale;
  float* scratch;
  cudaStream_t stream;
  template <int GT>
  int operator()() const {
    return run<Elem, D, GT>(q, k, v, o, st, geo, B, KV, G, length, n_splits,
                            chunk, scale, scratch, stream);
  }
};

template <typename Elem>
int dispatch_slots(int D, int G, int* out) {
  switch (D) {
    case 8: return by_group<Elem>(G, SlotsFor<Elem, 8>{out});
    case 16: return by_group<Elem>(G, SlotsFor<Elem, 16>{out});
    case 32: return by_group<Elem>(G, SlotsFor<Elem, 32>{out});
    case 64: return by_group<Elem>(G, SlotsFor<Elem, 64>{out});
    case 128: return by_group<Elem>(G, SlotsFor<Elem, 128>{out});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Elem>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* st, const long long* geo, int B, int KV, int G,
             int D, int length, int n_splits, int chunk, float scale,
             void* scratch, void* stream) {
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(DD)                                                            \
  by_group<Elem>(G, RunFor<Elem, DD>{q, k, v, o, st, geo, B, KV, G, length, \
                                     n_splits, chunk, scale, sc, s})
  switch (D) {
    case 8: return RUN(8);
    case 16: return RUN(16);
    case 32: return RUN(32);
    case 64: return RUN(64);
    case 128: return RUN(128);
    default: return cudaErrorInvalidValue;
  }
#undef RUN
}

}  // namespace

// Blocks of pass 1 that the device holds at once (SMs x blocks per SM) for
// head dim D and G query rows per KV head, for the wrapper's plan.
extern "C" int decode_attention_slots_f32(int D, int G, int* out) {
  return dispatch_slots<float>(D, G, out);
}
extern "C" int decode_attention_slots_bf16(int D, int G, int* out) {
  return dispatch_slots<__nv_bfloat16>(D, G, out);
}

// strides: 12 element strides (batch, head, row) of q, k, v and o, in that
// order; geo: the tensor-map geometry of k and of v, 12 values each (dims
// (d, seq, head, batch), byte strides of seq, head, batch, box (columns,
// rows, 1, 1), swizzle bytes), whose box rows are the kernel's tile; scratch:
// with n_splits > 1, (2 + D) * B * KV * n_splits * G f32 values, laid out as
// m and l (B * KV * n_splits * G each), then acc (D times as many), else
// unused.  Keys [s * chunk, min((s + 1) * chunk, length)) form split s;
// chunk is a multiple of the tile.  Returns a cudaError_t, or a negative
// value when no tensor map could be encoded.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides,
                                    const long long* geo, int B, int KV,
                                    int G, int D, int length, int n_splits,
                                    int chunk, float scale, void* scratch,
                                    void* stream) {
  return dispatch<float>(q, k, v, o, strides, geo, B, KV, G, D, length,
                         n_splits, chunk, scale, scratch, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides,
                                     const long long* geo, int B, int KV,
                                     int G, int D, int length, int n_splits,
                                     int chunk, float scale, void* scratch,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, geo, B, KV, G, D,
                                 length, n_splits, chunk, scale, scratch,
                                 stream);
}
