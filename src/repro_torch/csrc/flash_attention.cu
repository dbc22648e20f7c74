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
// Scores are (q * 1/sqrt(d)) . k with f32 products and sums (bf16 values are
// widened, so every product is exact); keys at kpos >= t_valid, and with
// causal set at kpos > qpos (top-left aligned), are masked; the softmax is
// online with the row max m, the normaliser l and the accumulator in f32;
// p stays f32 for p . v, as in the TPU body.
//
// What bounds it on this card.  At the LM path's shape (B=4, H=14, KV=2,
// S=T=2048, d=64, causal) the two products are 15 GFLOP each against 34 MB
// of inputs and output, so operations bound it.  q . k of bf16 values could
// run on bf16 tensor cores (exact products), but p . v with f32 p runs at
// the 67 TFLOP/s non-tensor f32 rate: about 0.24 ms.  This kernel runs both
// products as f32 FMA, so its floor is about 0.45 ms.
//
// Design (a first kernel that is right; wgmma, TMA and bf16 p are later
// work).  The TPU grid (batch, head, q block, kv block) carries m, l and acc
// in VMEM across its sequential kv axis.  Here one block of four warps owns
// (b, h, a tile of BQ = 32 query rows) and walks the kv axis in a loop, so
// the carry lives in registers: each warp owns 8 query rows, with m, l and
// the row's output dims spread over its lanes.  Per kv tile of BK = 64 keys:
//   * K and V are widened to f32 in shared memory (K rows padded to d + 1
//     floats so the lanes' reads of 32 different keys hit 32 banks);
//   * lane j scores keys j and j + 32 of the tile for the warp's 8 rows;
//   * the row max and sum are warp shuffles; p goes to shared memory, where
//     the warp reads it back as broadcast float4s for p . v, lane j owning
//     output dims j, j + 32, ....
// Causal tiles wholly above the diagonal are never visited (the kv loop
// ends at the tile's last query row), and the heaviest query tiles are
// scheduled first.  d is not padded: every d the reference's kernel tests
// use (16, 32, 64, 128) and the qwen2-0.5b smoke config's 8 has its own
// instantiation.  Strides are taken as given (the
// last dimension must be contiguous), so the trunk's (B, S, H, d) layout is
// read without a copy.
//
// Each entry point returns cudaGetLastError() after its launch; it allocates
// nothing and launches on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;              // query rows per warp
constexpr int BQ = WARPS * ROWS;     // query rows per block
constexpr int BK = 64;               // keys per shared-memory tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element strides of the batch, head and sequence axes of one tensor.
struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}

template <typename Elem, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const Elem* __restrict__ q, const Elem* __restrict__ k,
          const Elem* __restrict__ v, Elem* __restrict__ o, Strides sq,
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
  const Elem* qb = q + b * sq.b + h * sq.h;
  const Elem* kb = k + b * sk.b + (h / group) * sk.h;
  const Elem* vb = v + b * sv.b + (h / group) * sv.h;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, i = e % D;
    Qs[e] = q0 + r < S ? widen(qb[(q0 + r) * sq.s + i]) * scale : 0.f;
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
      Ks[r * KS + i] = in ? widen(kb[(k0 + r) * sk.s + i]) : 0.f;
      Vs[r * D + i] = in ? widen(vb[(k0 + r) * sv.s + i]) : 0.f;
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
    Elem* orow = o + b * so.b + h * so.h + r * so.s;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      if (j < D) store(orow + j, acc[rr][t] / safe);
    }
  }
}

template <typename Elem, int D>
int run(const void* q, const void* k, const void* v, void* o,
        const long long* st, int B, int H, int KV, int S, int T, int t_valid,
        int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd<Elem, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  const int n_qt = (S + BQ - 1) / BQ;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kernel<<<BH * n_qt, THREADS, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(o), sq, sk, sv, so, BH,
      H, H / KV, S, T, t_valid, causal, scale);
  return cudaGetLastError();
}

template <typename Elem>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* strides, int B, int H, int KV, int S, int T,
             int D, int t_valid, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return run<Elem, 8>(q, k, v, o, strides, B, H, KV, S, T, t_valid,
                          causal, scale, s);
    case 16:
      return run<Elem, 16>(q, k, v, o, strides, B, H, KV, S, T, t_valid,
                           causal, scale, s);
    case 32:
      return run<Elem, 32>(q, k, v, o, strides, B, H, KV, S, T, t_valid,
                           causal, scale, s);
    case 64:
      return run<Elem, 64>(q, k, v, o, strides, B, H, KV, S, T, t_valid,
                           causal, scale, s);
    case 128:
      return run<Elem, 128>(q, k, v, o, strides, B, H, KV, S, T, t_valid,
                            causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides (batch, head, sequence) of q, k, v and o, in
// that order; the last dimension of each is contiguous.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int KV, int S, int T, int D, int t_valid,
                                   int causal, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, strides, B, H, KV, S, T, D, t_valid,
                         causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int B, int H,
                                    int KV, int S, int T, int D, int t_valid,
                                    int causal, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, H, KV, S, T, D,
                                 t_valid, causal, scale, stream);
}
