// Re-ranking's two hot loops: the k-reciprocal Jaccard min-sum and the GNN
// propagation.
//
// Replaces no Pallas kernel. The JAX package leaves both to XLA:
//   jaccard_minsum: ieee_tpu/ops/rerank_device.py `_rerank_core`, the
//       blocked broadcast-min-sum (:103-121) over the membership vectors V
//       (n x n, rows summing to 1):
//         m[i, c] = sum_k min(V[i, k], V[c, k]),  out = 1 - m / (2 - m)
//       for the query rows i against the gallery rows c (the JAX program
//       computes all n columns and keeps the gallery's; only those are
//       computed here). V in f32, or bf16 under `rerank_bf16` (:103-106),
//       always summed in f32.
//   gnn_propagate: ieee_tpu/ops/gnn_rerank.py `_gnn_rerank_scores`, the
//       k2-term gather-sum and its row normalisation (:98-108), the
//       reference's `gnn_propagate_kernel.cu`:
//         a[i, :] = sum_{j<k2} S[i, j] * C[rank[i, j], :],
//         out[i, :] = a[i, :] / max(|a[i, :]|, 1e-12)
//       with C = A + A^T (n x n f32) and rank, S the k2 nearest of each row.
//
// What bounds them on an H100:
//   jaccard_minsum is a reduction shaped like a GEMM with min in place of
//   the product, so the tensor cores cannot run it: each (min, add) pair is
//   two instructions on the CUDA cores. The CUDA C programming guide's
//   throughput table (compute capability 9.0, per SM and clock) gives 128
//   FP32 adds and 64 compares/min/max, and an SM issues 4 warp
//   instructions a clock, so 64 pairs an SM a clock: 16.7e12 pairs/s at
//   132 SMs and 1.98 GHz, a quarter of the card's 67 TFLOP/s f32 rate. At
//   Market-1501 (q 3368, g 15913, n 19281) the dense form is 1.03e12 pairs,
//   62 ms, while V's 1.49 GB is read in 0.44 ms. V holds a few hundred
//   non-zeros a row, so the pairs the data needs are far fewer: the sparse
//   form is a later redesign.
//   gnn_propagate moves bytes: k2 gathered rows and one written row per
//   output row, (k2 + 1) n^2 4 bytes if every gathered row comes from HBM
//   (11.9 GB at Market, 3.6 ms at 3.35 TB/s), against k2 n^2 multiply-adds.
//
// Design (simple kernels that are right first):
//   jaccard_minsum: 64 x 64 output tiles, 256 threads as 16 x 16, each a
//   4 x 4 block of sums in registers. K runs in steps of 32: each thread
//   loads 8 consecutive k of one query row and of one gallery row as
//   single values (any row stride: V's rows at n = 19281 start anywhere),
//   converts them to f32 and stores them transposed into shared memory
//   (k-major, rows padded to 68 floats), so that each k step reads 4 query
//   and 4 gallery values as two float4. A warp reads 32 consecutive k of 8
//   rows a step, whose sectors its 8 loads a thread share in L1; the loads
//   are 16 of a thread's ~1100 instructions a step (the kernel issues
//   (min, add) pairs, it does not wait on bytes). Rows beyond the matrix
//   and k >= K stage as 0 (min(0, 0) adds nothing). Every sum adds its k
//   in order, so two runs agree bit for bit.
//   gnn_propagate: one block of 512 threads per output row. The row's k2
//   source pointers and weights sit in shared memory; each thread walks the
//   columns 512 apart with up to 8 gathered loads in flight, adds the
//   products in j order (multiply and add rounded each, as the plain
//   version's two tensor ops) into the row, kept whole in shared memory
//   (4 n bytes: 77 KB at n = 19281, two blocks an SM), and into its sum of
//   squares; the block reduces the squares in a fixed order (warp
//   shuffles, then one warp), and the row is divided by its norm and
//   written once. Rows are read as single floats (an odd n leaves them
//   unaligned), 128 coalesced bytes a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;        // output tile: 64 query x 64 gallery rows
constexpr int kStep = 32;        // k staged per step
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 sums each
constexpr int kLds = kTile + 4;  // padded shared row, floats

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one thread's share of a step: 8 k of one tile row into shared memory,
// transposed; rows beyond the matrix and k beyond K as 0
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ld,
                                      int rows, int k, int row0, int k0,
                                      float (*dst)[kLds]) {
  const int r = threadIdx.x >> 2;
  const int kk = (threadIdx.x & 3) * 8;
  const T* p = src + (long long)(row0 + r) * ld + k0 + kk;
  const bool live = row0 + r < rows;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[kk + e][r] = live && k0 + kk + e < k ? to_f32(__ldg(p + e)) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
minsum_kernel(const T* __restrict__ a, long long lda, const T* __restrict__ b,
              long long ldb, float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) float as[kStep][kLds];
  __shared__ __align__(16) float bs[kStep][kLds];
  const int tx = threadIdx.x & 15;  // 4 gallery columns of the tile
  const int ty = threadIdx.x >> 4;  // 4 query rows of the tile
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kStep) {
    stage(a, lda, m, k, row0, k0, as);
    stage(b, ldb, n, k, col0, k0, bs);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float x[4] = {av.x, av.y, av.z, av.w};
      const float y[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += fminf(x[i], y[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < n) {
        const float s = acc[i][j];
        out[(long long)r * n + c] = 1.f - s / (2.f - s);
      }
    }
  }
}

constexpr int kPropThreads = 512;
constexpr int kMaxK2 = 64;   // neighbours a row may gather (the wrapper checks)
constexpr int kInFlight = 8; // gathered loads a thread keeps in flight

__global__ void __launch_bounds__(kPropThreads, 2)
propagate_kernel(const float* __restrict__ c, long long ldc,
                 const int64_t* __restrict__ idx,
                 const float* __restrict__ vals, float* __restrict__ out,
                 int f, int k2) {
  extern __shared__ float row[];  // f floats
  __shared__ const float* src[kMaxK2];
  __shared__ float w[kMaxK2];
  __shared__ float red[kPropThreads / 32];
  __shared__ float norm;
  const long long i = blockIdx.x;
  if (threadIdx.x < k2) {
    src[threadIdx.x] = c + idx[i * k2 + threadIdx.x] * ldc;
    w[threadIdx.x] = vals[i * k2 + threadIdx.x];
  }
  __syncthreads();

  float ss = 0.f;
  for (int col = threadIdx.x; col < f; col += kPropThreads) {
    float acc = 0.f;
    for (int j0 = 0; j0 < k2; j0 += kInFlight) {
      float x[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        x[u] = j0 + u < k2 ? __ldg(src[j0 + u] + col) : 0.f;
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (j0 + u < k2) acc = __fadd_rn(acc, __fmul_rn(w[j0 + u], x[u]));
    }
    row[col] = acc;
    ss = __fadd_rn(ss, __fmul_rn(acc, acc));
  }
  // the sum of squares in a fixed order: each warp's lanes, then the warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kPropThreads / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) norm = fmaxf(sqrtf(t), 1e-12f);
  }
  __syncthreads();
  const float nrm = norm;
  float* o = out + i * f;
  for (int col = threadIdx.x; col < f; col += kPropThreads)
    o[col] = row[col] / nrm;
}

}  // namespace

// out (m, n) f32 = 1 - s / (2 - s), s[i, c] = sum_{k<K} min(a[i, k], b[c, k]);
// a (m, K) and b (n, K) f32 (is_bf16 0) or bf16 (1), unit column stride,
// rows lda and ldb >= K elements apart.
extern "C" int ieee_jaccard_minsum(const void* a, const void* b, void* out,
                                   int m, int n, int k, int lda, int ldb,
                                   int is_bf16, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || lda < k || ldb < k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    minsum_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), lda,
        static_cast<const __nv_bfloat16*>(b), ldb, o, m, n, k);
  else
    minsum_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
        o, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// out (m, f) f32: row i = sum_{j<k2} vals[i, j] * c[idx[i, j], :], divided
// by max(its norm, 1e-12); c rows ldc floats apart, idx (m, k2) int64 and
// vals (m, k2) f32 contiguous, k2 <= 64, f <= the shared-memory row.
extern "C" int ieee_gnn_propagate(const void* c, const void* idx,
                                  const void* vals, void* out, int m, int f,
                                  int ldc, int k2, void* stream) {
  if (m <= 0 || f <= 0) return 0;
  if (k2 < 1 || k2 > kMaxK2 || ldc < f)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)f;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  propagate_kernel<<<m, kPropThreads, smem, st>>>(
      static_cast<const float*>(c), ldc, static_cast<const int64_t*>(idx),
      static_cast<const float*>(vals), static_cast<float*>(out), f, k2);
  return static_cast<int>(cudaGetLastError());
}
