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
// the keys t < length of that head.  Scores are (q * 1/sqrt(d)) . k with q
// scaled in f32 and f32 products and sums (bf16 values are widened, so every
// product is exact); the softmax is online with m, l and the accumulator in
// f32; p stays f32 for p . v, as in the TPU body.
//
// What bounds it on this card.  Bytes: K and V of the valid prefix are read
// once (at decode_32k on qwen2-0.5b, 2.15 GB of bf16 per layer, 0.64 ms at
// 3.35 TB/s), against about 2 G d FMA per key (G = 7: 3.5 FMA per byte of
// bf16, a third of the card's f32 FMA rate at full bandwidth).
//
// Design (simple, but it fills the card; no tensor cores and no TMA).  The
// TPU grid walks the cache blocks of one (b, h) in order and carries m, l,
// acc in VMEM, skipping blocks past length.  Here the valid prefix
// [0, length) -- never the capacity -- is cut into splits of `chunk` keys,
// so that B * KV * splits blocks fill the 132 SMs even at B * KV = 2
// (long_500k); no block touches a key at or past length, and every split
// is non-empty.  Pass 1 has one block per (split, b, h):
//   * the G query rows, times the scale, sit in shared memory as f32, padded
//     with zero rows to GT (1, 2, 4, 8 or 16, a template argument), so the
//     loops over rows have no branches and their FMA chains interleave;
//   * each warp streams sub-tiles of 32 keys of the split (sub-tile w, w + W,
//     ... for warp w of W) through its own two-stage shared-memory ring of
//     K and V rows, filled by 16-byte cp.async copies along d (rows past the
//     split are zero-filled, not read), so one sub-tile loads while the
//     warp computes the previous one and no block barrier is needed;
//   * lane j scores key j for all rows (the K row read as 16-byte chunks
//     whose order is XOR-swizzled by the row against bank conflicts, q as
//     broadcasts), the row max is a warp shuffle, p goes to shared memory,
//     and for p . v each lane owns d / 32 output dims of every row;
//   * the warps' (m, l, acc) merge in shared memory into the block's
//     partial, written to f32 scratch that the wrapper allocates.
// Pass 2 has one block per (b, h, query row) and merges the splits:
// M = max m_i, L = sum l_i e^(m_i - M), o = sum acc_i e^(m_i - M) / L.
//
// Strides are taken as given: the last dimension must be contiguous, and
// the rows of k and v start on 16-byte boundaries (the wrapper checks), so
// the trunk's transposed (B, T, KV, d) cache slices are read without a
// copy.  Each entry point returns the CUDA error of its launches; it
// allocates nothing and launches on the stream it is given.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KEYS = 32;  // keys per warp sub-tile: one per lane
constexpr int GMAX = 16;  // most query rows per KV head
constexpr int MERGE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {  // element strides of the batch, head and row axes
  long long b, h, s;
};

template <typename Elem, int D, int GT>
struct Geometry {
  static constexpr int ELEM = sizeof(Elem);
  static constexpr int CH = D * ELEM / 16;      // 16-byte chunks per row
  static constexpr int EPC = 16 / ELEM;         // elements per chunk
  static constexpr int SW = CH < 8 ? CH : 8;    // chunks the swizzle permutes
  static constexpr int RS = D * ELEM;           // shared row stride, bytes
  static constexpr int TILE = KEYS * RS;        // one K or V sub-tile
  // two stages of (K, V) and the warp's p rows
  static constexpr int WARP_BYTES = 4 * TILE + GT * KEYS * 4;
  static constexpr int WARPS = 4 * WARP_BYTES <= 160 * 1024 ? 4 : 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NT = D >= 32 ? D / 32 : 1;  // output dims per lane
  static constexpr size_t SMEM = GT * D * 4 + WARPS * WARP_BYTES;
  static_assert(NT * ELEM <= 16, "a lane's dims lie in one chunk");
  static_assert(GT * (D + 2) * 4 <= WARP_BYTES,
                "the warps' partials must fit in their rings");
};

// byte offset of logical chunk c of row r in a swizzled sub-tile
template <typename Geo>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * Geo::RS + ((c ^ (r & (Geo::SW - 1))) << 4);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16-byte copy global -> shared; src_bytes = 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N consecutive values at p (shared memory, aligned to N * sizeof(Elem))
template <typename Elem, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float* out) {
  if constexpr (sizeof(Elem) == 4) {
    if constexpr (N == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
    } else if constexpr (N == 2) {
      const float2 x = *reinterpret_cast<const float2*>(p);
      out[0] = x.x, out[1] = x.y;
    } else {
      out[0] = *reinterpret_cast<const float*>(p);
    }
  } else {
    if constexpr (N == 1) {
      out[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
    } else {
      constexpr int W = N * 2 / 4;  // 32-bit words
      uint32_t w[W];
      if constexpr (W == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
      } else if constexpr (W == 2) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        w[0] = x.x, w[1] = x.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        out[2 * i] = f.x, out[2 * i + 1] = f.y;
      }
    }
  }
}

template <typename Elem, int D, int GT>
__global__ void __launch_bounds__(Geometry<Elem, D, GT>::THREADS)
decode_split(const Elem* __restrict__ q, const Elem* __restrict__ k,
             const Elem* __restrict__ v, Strides sq, Strides sk, Strides sv,
             int KV, int G, int length, int chunk, float scale,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc) {
  using Geo = Geometry<Elem, D, GT>;
  constexpr int CH = Geo::CH, EPC = Geo::EPC, NT = Geo::NT;
  constexpr int TILE = Geo::TILE, WARPS = Geo::WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // GT x D: q * scale, then 0

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.x, n_splits = gridDim.x, bh = blockIdx.y;
  const int b = bh / KV, h = bh % KV;
  const int start = split * chunk, end = min(start + chunk, length);
  const Elem* qb = q + b * sq.b + h * sq.h;
  const Elem* kb = k + b * sk.b + h * sk.h;
  const Elem* vb = v + b * sv.b + h * sv.h;

  unsigned char* ring = smem + GT * D * 4 + warp * Geo::WARP_BYTES;
  float* Pw = reinterpret_cast<float*>(ring + 4 * TILE);  // GT x KEYS

  for (int e = threadIdx.x; e < GT * D; e += Geo::THREADS)
    Qs[e] = e < G * D ? widen(qb[(e / D) * sq.s + e % D]) * scale : 0.f;
  __syncthreads();

  // sub-tile st of the split -> stage buf of this warp's ring
  auto load = [&](int st, int buf) {
    unsigned char* ks = ring + buf * 2 * TILE;
    unsigned char* vs = ks + TILE;
    const int t0 = start + st * KEYS;
#pragma unroll
    for (int i = lane; i < KEYS * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      const bool in = t0 + r < end;
      const long long t = in ? t0 + r : start;
      const int at = chunk_at<Geo>(r, c);
      cp_async16(ks + at, kb + t * sk.s + c * EPC, in ? 16 : 0);
      cp_async16(vs + at, vb + t * sv.s + c * EPC, in ? 16 : 0);
    }
    cp_async_commit();
  };

  float m[GT], l[GT], acc[GT][NT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;  // this lane's part of the sum
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[g][t] = 0.f;
  }
  const int dl = lane * NT;  // this lane's first output dim
  const int n_sub = (end - start + KEYS - 1) / KEYS;

  if (warp < n_sub) load(warp, 0);
  for (int st = warp, it = 0; st < n_sub; st += WARPS, ++it) {
    const int buf = it & 1;
    if (st + WARPS < n_sub) {
      load(st + WARPS, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned char* ks = ring + buf * 2 * TILE;
    const unsigned char* vs = ks + TILE;
    const int t0 = start + st * KEYS;

    // scores of key t0 + lane for every query row
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
#pragma unroll 2
    for (int c = 0; c < CH; ++c) {
      float kf[EPC];
      load_vals<Elem, EPC>(ks + chunk_at<Geo>(lane, c), kf);
#pragma unroll
      for (int u = 0; u < EPC; u += 4) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float4 qv =
              *reinterpret_cast<const float4*>(Qs + g * D + c * EPC + u);
          s[g] = fmaf(qv.x, kf[u], s[g]);
          s[g] = fmaf(qv.y, kf[u + 1], s[g]);
          s[g] = fmaf(qv.z, kf[u + 2], s[g]);
          s[g] = fmaf(qv.w, kf[u + 3], s[g]);
        }
      }
    }

    // online softmax; lane 0's key is always valid, so the max is finite
    const bool valid = t0 + lane < end;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float x = valid ? s[g] : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      const float p = expf(x - m_new);
      l[g] = l[g] * corr + p;
      m[g] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[g][t] *= corr;
      Pw[g * KEYS + lane] = p;
    }
    __syncwarp();

    // p . v over the sub-tile's valid keys (zero-filled rows past them)
    const int nk = min(KEYS, end - t0);
    const int cl = dl * Geo::ELEM / 16, within = dl * Geo::ELEM % 16;
#pragma unroll 2
    for (int kk = 0; kk < nk; kk += 4) {
      float vv[4][NT];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (dl < D) {
          load_vals<Elem, NT>(vs + chunk_at<Geo>(kk + u, cl) + within, vv[u]);
        } else {
#pragma unroll
          for (int t = 0; t < NT; ++t) vv[u][t] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float4 pv = *reinterpret_cast<const float4*>(Pw + g * KEYS + kk);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          acc[g][t] = fmaf(pv.x, vv[0][t], acc[g][t]);
          acc[g][t] = fmaf(pv.y, vv[1][t], acc[g][t]);
          acc[g][t] = fmaf(pv.z, vv[2][t], acc[g][t]);
          acc[g][t] = fmaf(pv.w, vv[3][t], acc[g][t]);
        }
      }
    }
    __syncwarp();  // the stage and Pw are free for the next sub-tile
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l[g] += __shfl_xor_sync(FULL, l[g], off);
  }

  // merge the warps' partials (a warp without a sub-tile has m = -inf,
  // l = 0, acc = 0 and weight 0; warp 0 always has one)
  __syncthreads();  // every warp is done with its ring
  float* Ms = reinterpret_cast<float*>(smem + GT * D * 4);  // WARPS x GT
  float* Ls = Ms + WARPS * GT;
  float* As = Ls + WARPS * GT;  // WARPS x GT x D
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      Ms[warp * GT + g] = m[g];
      Ls[warp * GT + g] = l[g];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (dl + t < D) As[(warp * GT + g) * D + dl + t] = acc[g][t];
  }
  __syncthreads();
  const size_t part = (size_t)bh * n_splits + split;
  for (int e = threadIdx.x; e < G * D; e += Geo::THREADS) {
    const int g = e / D, i = e % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Ms[w * GT + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wgt = expf(Ms[w * GT + g] - M);
      L += Ls[w * GT + g] * wgt;
      A += As[(w * GT + g) * D + i] * wgt;
    }
    part_acc[(part * G + g) * D + i] = A;
    if (i == 0) {
      part_m[part * G + g] = M;
      part_l[part * G + g] = L;
    }
  }
}

// all-thread max / sum of one value per thread
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

template <typename Elem>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge(const float* __restrict__ part_m,
             const float* __restrict__ part_l,
             const float* __restrict__ part_acc, Elem* __restrict__ o,
             Strides so, int KV, int G, int D, int n_splits) {
  __shared__ float red[MERGE_THREADS];
  const int g = blockIdx.x % G, bh = blockIdx.x / G;
  const int b = bh / KV, h = bh % KV;
  const size_t base = (size_t)bh * n_splits;
  float M = -INFINITY;
  for (int s = threadIdx.x; s < n_splits; s += MERGE_THREADS)
    M = fmaxf(M, part_m[(base + s) * G + g]);
  M = block_reduce(M, true, red);
  float L = 0.f;
  for (int s = threadIdx.x; s < n_splits; s += MERGE_THREADS)
    L += part_l[(base + s) * G + g] * expf(part_m[(base + s) * G + g] - M);
  L = block_reduce(L, false, red);
  assert(L > 0.f);  // every split is non-empty
  // thread -> (dim i, slice j of the splits); D divides MERGE_THREADS
  const int i = threadIdx.x % D, j = threadIdx.x / D;
  const int slices = MERGE_THREADS / D;
  float A = 0.f;
#pragma unroll 4
  for (int s = j; s < n_splits; s += slices)
    A += part_acc[((base + s) * G + g) * D + i] *
         expf(part_m[(base + s) * G + g] - M);
  __syncthreads();  // red is free
  red[threadIdx.x] = A;
  __syncthreads();
  if (j == 0) {
    for (int jj = 1; jj < slices; ++jj) A += red[jj * D + i];
    store(o + b * so.b + h * so.h + g * so.s + i, A / L);
  }
}

template <typename Elem, int D, int GT>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(decode_split<Elem, D, GT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Geometry<Elem, D, GT>::SMEM);
}

template <typename Elem, int D, int GT>
int slots(int* out) {
  using Geo = Geometry<Elem, D, GT>;
  cudaError_t err = allow_smem<Elem, D, GT>();
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_split<Elem, D, GT>, Geo::THREADS, Geo::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <typename Elem, int D, int GT>
int run(const void* q, const void* k, const void* v, void* o,
        const long long* st, int B, int KV, int G, int length, int n_splits,
        int chunk, float scale, float* scratch, cudaStream_t stream) {
  using Geo = Geometry<Elem, D, GT>;
  cudaError_t err = allow_smem<Elem, D, GT>();
  if (err != cudaSuccess) return err;
  const int BKV = B * KV;
  const size_t n = (size_t)BKV * n_splits * G;
  float *pm = scratch, *pl = scratch + n, *pa = scratch + 2 * n;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  decode_split<Elem, D, GT><<<dim3(n_splits, BKV), Geo::THREADS, Geo::SMEM,
                              stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), sq, sk, sv, KV, G, length, chunk, scale,
      pm, pl, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<Elem><<<BKV * G, MERGE_THREADS, 0, stream>>>(
      pm, pl, pa, static_cast<Elem*>(o), so, KV, G, D, n_splits);
  return cudaGetLastError();
}

// F<GT>() for the least GT in {1, 2, 4, 8, 16} that holds G rows
template <typename F>
int by_group(int G, F f) {
  if (G < 1 || G > GMAX) return cudaErrorInvalidValue;
  if (G == 1) return f.template operator()<1>();
  if (G == 2) return f.template operator()<2>();
  if (G <= 4) return f.template operator()<4>();
  if (G <= 8) return f.template operator()<8>();
  return f.template operator()<16>();
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
  const long long* st;
  int B, KV, G, length, n_splits, chunk;
  float scale;
  float* scratch;
  cudaStream_t stream;
  template <int GT>
  int operator()() const {
    return run<Elem, D, GT>(q, k, v, o, st, B, KV, G, length, n_splits,
                            chunk, scale, scratch, stream);
  }
};

template <typename Elem>
int dispatch_slots(int D, int G, int* out) {
  switch (D) {
    case 8: return by_group(G, SlotsFor<Elem, 8>{out});
    case 16: return by_group(G, SlotsFor<Elem, 16>{out});
    case 32: return by_group(G, SlotsFor<Elem, 32>{out});
    case 64: return by_group(G, SlotsFor<Elem, 64>{out});
    case 128: return by_group(G, SlotsFor<Elem, 128>{out});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Elem>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* st, int B, int KV, int G, int D, int length,
             int n_splits, int chunk, float scale, void* scratch,
             void* stream) {
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(DD)                                                              \
  by_group(G, RunFor<Elem, DD>{q, k, v, o, st, B, KV, G, length, n_splits, \
                               chunk, scale, sc, s})
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
// head dim D and G query rows per KV head, for the wrapper's choice of
// splits.
extern "C" int decode_attention_slots_f32(int D, int G, int* out) {
  return dispatch_slots<float>(D, G, out);
}
extern "C" int decode_attention_slots_bf16(int D, int G, int* out) {
  return dispatch_slots<__nv_bfloat16>(D, G, out);
}

// strides: 12 element strides (batch, head, row) of q, k, v and o, in that
// order; scratch: (2 + D) * B * KV * n_splits * G f32 values, laid out as
// m and l (B * KV * n_splits * G each), then acc (D times as many).  Keys
// [s * chunk, min((s + 1) * chunk, length)) form split s.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int B, int KV,
                                    int G, int D, int length, int n_splits,
                                    int chunk, float scale, void* scratch,
                                    void* stream) {
  return dispatch<float>(q, k, v, o, strides, B, KV, G, D, length, n_splits,
                         chunk, scale, scratch, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int KV,
                                     int G, int D, int length, int n_splits,
                                     int chunk, float scale, void* scratch,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, KV, G, D, length,
                                 n_splits, chunk, scale, scratch, stream);
}
