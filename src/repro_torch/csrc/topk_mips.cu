// Exact top-k maximum inner product search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/topk_mips/kernel.py:
//   * topk_mips_kernel      (body _mips_kernel)      -> topk_mips_f32 / topk_mips_bf16
//   * topk_mips_kernel_int8 (body _mips_kernel_int8) -> topk_mips_int8
//
// What bounds it on this card.  At the engine's shape (Q=256 queries,
// a corpus chunk of N=1024 rows, D=768) the f32 variant does 2*Q*N*D =
// 0.4 GFLOP on 4 MB of input, so it is bound by arithmetic (no TF32 is
// allowed: f32 products and sums are required, so the tensor cores are out
// and the 67 TFLOP/s non-tensor f32 rate is the ceiling).  bf16 and int8
// read half and a quarter of the bytes and are bound by memory on paper.
//
// Design.  The TPU kernel runs its corpus grid axis in order on one core and
// carries a (bq, k) running top-k in VMEM from one corpus tile to the next.
// Blocks on a GPU run in no order, so that carry becomes two passes:
//   pass 1  grid (query tile of BQ rows) x (corpus split of CN columns).
//           Each block scores its BQ x CN tile with plain FMA (bf16 values
//           widened to f32; int8 through __dp4a into an exact int32 sum),
//           masks columns >= n_valid to -inf, sorts every row of the tile in
//           shared memory (bitonic) and writes the row's best kk entries to
//           scratch.  The score tile never leaves shared memory.
//   pass 2  one block per query row merges the row's partial lists and the
//           optional engine carry with one bitonic sort in shared memory
//           (this replaces ops.py::_merge_carry of the reference).
// Order is total: score descending, then rank ascending, where a carry entry
// j has rank j and a corpus column c has rank kc + c.  That is the order
// lax.top_k gives [carry || chunk]: on equal scores the carry wins, and
// within a chunk the lower column wins.  Many more blocks than the TPU's
// q-tiles alone fill the 132 SMs.  wgmma / TMA are left to later work.
//
// Every entry point returns cudaGetLastError() after its launches; it
// allocates nothing and launches on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;           // query rows per pass-1 block
constexpr int CN = 128;          // corpus columns per pass-1 block (= threads)
constexpr int TD = 32;           // feature elements per shared-memory stage
constexpr int MAX_CAND = 16384;  // pass-2 candidates per row (128 KiB smem)

// a comes strictly before b in the output order
__device__ __forceinline__ bool before(float sa, int ra, float sb, int rb) {
  return sa > sb || (sa == sb && ra < rb);
}

// Bitonic sort of `rows` independent rows of length n (a power of two),
// laid out back to back in shared memory, into the order of before().
__device__ void sort_rows(float* s, int* r, int rows, int n) {
  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < rows * half; p += blockDim.x) {
        const int row = p / half, j = p % half;
        const int lo = 2 * stride * (j / stride) + (j % stride);
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const int a = row * n + lo, b = row * n + hi;
        const bool swap = up ? before(s[b], r[b], s[a], r[a])
                             : before(s[a], r[a], s[b], r[b]);
        if (swap) {
          const float ts = s[a]; s[a] = s[b]; s[b] = ts;
          const int tr = r[a]; r[a] = r[b]; r[b] = tr;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sort the BQ x CN tile held in key_s / key_r and write each real row's best
// kk entries to its slot of the partial lists.
__device__ void emit_partials(float* key_s, int* key_r, int row0, int Q,
                              int split, int n_splits, int kk, float* part_s,
                              int* part_i) {
  sort_rows(key_s, key_r, BQ, CN);
  for (int e = threadIdx.x; e < BQ * kk; e += blockDim.x) {
    const int r = e / kk, j = e % kk, gr = row0 + r;
    if (gr < Q) {
      const size_t o = ((size_t)gr * n_splits + split) * kk + j;
      part_s[o] = key_s[r * CN + j];
      part_i[o] = key_r[r * CN + j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CN)
mips_tile_topk(const T* __restrict__ q, const T* __restrict__ c, int Q, int N,
               int D, int n_valid, int kk, int n_splits,
               float* __restrict__ part_s, int* __restrict__ part_i) {
  __shared__ float q_s[BQ][TD];
  __shared__ float c_s[CN][TD + 1];     // +1: conflict-free column reads
  __shared__ float key_s[BQ * CN];
  __shared__ int key_r[BQ * CN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BQ, split = blockIdx.y, col0 = split * CN;
  float acc[BQ];
#pragma unroll
  for (int r = 0; r < BQ; ++r) acc[r] = 0.f;
  for (int d0 = 0; d0 < D; d0 += TD) {
    for (int e = tid; e < BQ * TD; e += CN) {
      const int r = e / TD, j = e % TD, gr = row0 + r, gd = d0 + j;
      q_s[r][j] = (gr < Q && gd < D) ? widen(q[(size_t)gr * D + gd]) : 0.f;
    }
    for (int e = tid; e < CN * TD; e += CN) {
      const int r = e / TD, j = e % TD, gc = col0 + r, gd = d0 + j;
      c_s[r][j] = (gc < N && gd < D) ? widen(c[(size_t)gc * D + gd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < TD; ++j) {
      const float cv = c_s[tid][j];
#pragma unroll
      for (int r = 0; r < BQ; ++r) acc[r] = fmaf(q_s[r][j], cv, acc[r]);
    }
    __syncthreads();
  }
  const int col = col0 + tid;
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    key_s[r * CN + tid] = col < n_valid ? acc[r] : -INFINITY;
    key_r[r * CN + tid] = col;
  }
  __syncthreads();
  emit_partials(key_s, key_r, row0, Q, split, n_splits, kk, part_s, part_i);
}

__global__ void __launch_bounds__(CN)
mips_tile_topk_int8(const int8_t* __restrict__ q, const int8_t* __restrict__ c,
                    const float* __restrict__ q_scale,
                    const float* __restrict__ c_scale, int Q, int N, int D,
                    int n_valid, int kk, int n_splits,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
  // TD int8 values per row and stage = TD/4 32-bit words for __dp4a; the
  // column rows are padded by one word so a warp reads 32 distinct banks
  __shared__ __align__(16) int8_t q_b[BQ][TD];
  __shared__ __align__(16) int8_t c_b[CN][TD + 4];
  __shared__ float key_s[BQ * CN];
  __shared__ int key_r[BQ * CN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BQ, split = blockIdx.y, col0 = split * CN;
  int acc[BQ];
#pragma unroll
  for (int r = 0; r < BQ; ++r) acc[r] = 0;
  for (int d0 = 0; d0 < D; d0 += TD) {
    for (int e = tid; e < BQ * TD; e += CN) {
      const int r = e / TD, j = e % TD, gr = row0 + r, gd = d0 + j;
      q_b[r][j] = (gr < Q && gd < D) ? q[(size_t)gr * D + gd] : (int8_t)0;
    }
    for (int e = tid; e < CN * TD; e += CN) {
      const int r = e / TD, j = e % TD, gc = col0 + r, gd = d0 + j;
      c_b[r][j] = (gc < N && gd < D) ? c[(size_t)gc * D + gd] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < TD / 4; ++w) {
      const int cw = reinterpret_cast<const int*>(c_b[tid])[w];
#pragma unroll
      for (int r = 0; r < BQ; ++r)
        acc[r] = __dp4a(reinterpret_cast<const int*>(q_b[r])[w], cw, acc[r]);
    }
    __syncthreads();
  }
  const int col = col0 + tid;
  const float cs = col < N ? c_scale[col] : 1.f;
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    const int gr = row0 + r;
    const float qs = gr < Q ? q_scale[gr] : 1.f;
    // dequantize exactly as the reference: (float(raw) * q_scale) * c_scale
    const float v = __fmul_rn(__fmul_rn((float)acc[r], qs), cs);
    key_s[r * CN + tid] = col < n_valid ? v : -INFINITY;
    key_r[r * CN + tid] = col;
  }
  __syncthreads();
  emit_partials(key_s, key_r, row0, Q, split, n_splits, kk, part_s, part_i);
}

// One block per query row: top k_out of [carry (kc) || partials (n_part)].
__global__ void merge_topk(const float* __restrict__ part_s,
                           const int* __restrict__ part_i, int n_part,
                           const float* __restrict__ carry_s,
                           const int* __restrict__ carry_i, int kc, int base,
                           int k_out, int m, float* __restrict__ out_s,
                           int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  int* r = reinterpret_cast<int*>(smem + (size_t)m * sizeof(float));
  const size_t row = blockIdx.x;
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    if (e < kc) {
      s[e] = carry_s[row * kc + e];
      r[e] = e;
    } else if (e < kc + n_part) {
      s[e] = part_s[row * n_part + (e - kc)];
      r[e] = kc + part_i[row * n_part + (e - kc)];
    } else {
      s[e] = -INFINITY;
      r[e] = 0x7fffffff;
    }
  }
  __syncthreads();
  sort_rows(s, r, 1, m);
  for (int j = threadIdx.x; j < k_out; j += blockDim.x) {
    const int rank = r[j];
    out_s[row * k_out + j] = s[j];
    out_i[row * k_out + j] =
        rank < kc ? carry_i[row * kc + rank] : base + (rank - kc);
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Shared tail of every variant: pass 2 over the partials pass 1 wrote.
int merge(const float* part_s, const int* part_i, int Q, int n_part,
          const float* carry_s, const int* carry_i, int kc, int base,
          int k_out, float* out_s, int* out_i, cudaStream_t stream) {
  const int m = next_pow2(kc + n_part);
  if (m > MAX_CAND) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      merge_topk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = m / 2;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  merge_topk<<<Q, threads, smem, stream>>>(part_s, part_i, n_part, carry_s,
                                           carry_i, kc, base, k_out, m, out_s,
                                           out_i);
  return (int)cudaGetLastError();
}

template <typename T>
int topk_float(const void* q, const void* c, int Q, int N, int D, int n_valid,
               int kk, const float* carry_s, const int* carry_i, int kc,
               int base, int k_out, float* part_s, int* part_i, float* out_s,
               int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_splits = (N + CN - 1) / CN;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  mips_tile_topk<T><<<grid, CN, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), Q, N, D, n_valid,
      kk, n_splits, part_s, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge(part_s, part_i, Q, n_splits * kk, carry_s, carry_i, kc, base,
               k_out, out_s, out_i, st);
}

}  // namespace

extern "C" {

// Geometry the Python wrapper needs to size scratch and windows.
int topk_mips_block_cols() { return CN; }
int topk_mips_max_candidates() { return MAX_CAND; }

// q (Q, D) and c (N, D) row-major f32.  Columns >= n_valid are masked.
// part_s / part_i: scratch of Q * ceil(N / CN) * kk entries.  carry_s /
// carry_i: (Q, kc) running top-k, or kc = 0.  out: (Q, k_out), k_out <=
// kc + min(n_valid, N).  Returned indices are base + column for corpus rows.
int topk_mips_f32(const void* q, const void* c, int Q, int N, int D,
                  int n_valid, int kk, const float* carry_s,
                  const int* carry_i, int kc, int base, int k_out,
                  float* part_s, int* part_i, float* out_s, int* out_i,
                  void* stream) {
  return topk_float<float>(q, c, Q, N, D, n_valid, kk, carry_s, carry_i, kc,
                           base, k_out, part_s, part_i, out_s, out_i, stream);
}

// Same contract with bf16 q and c; products and sums are f32.
int topk_mips_bf16(const void* q, const void* c, int Q, int N, int D,
                   int n_valid, int kk, const float* carry_s,
                   const int* carry_i, int kc, int base, int k_out,
                   float* part_s, int* part_i, float* out_s, int* out_i,
                   void* stream) {
  return topk_float<__nv_bfloat16>(q, c, Q, N, D, n_valid, kk, carry_s,
                                   carry_i, kc, base, k_out, part_s, part_i,
                                   out_s, out_i, stream);
}

// int8 q and c with per-row f32 scales q_scale (Q,) and c_scale (N,).
int topk_mips_int8(const int8_t* q, const int8_t* c, const float* q_scale,
                   const float* c_scale, int Q, int N, int D, int n_valid,
                   int kk, const float* carry_s, const int* carry_i, int kc,
                   int base, int k_out, float* part_s, int* part_i,
                   float* out_s, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_splits = (N + CN - 1) / CN;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  mips_tile_topk_int8<<<grid, CN, 0, st>>>(q, c, q_scale, c_scale, Q, N, D,
                                           n_valid, kk, n_splits, part_s,
                                           part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge(part_s, part_i, Q, n_splits * kk, carry_s, carry_i, kc, base,
               k_out, out_s, out_i, st);
}

}  // extern "C"
