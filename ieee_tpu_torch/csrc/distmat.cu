// Query x gallery squared-euclidean distance matrix, full float32.
//
// Replaces: ieee_tpu/ops/pallas/distmat.py `euclidean_sq_pallas` (Pallas body
// `_distmat_kernel`): out[i, j] = |q_i|^2 + |g_j|^2 - 2 q_i . g_j with an f32
// product at HIGHEST precision and the norms fused into the same pass.
//
// What bounds it on an H100: arithmetic. At the eval shapes (K = 2304, m and n
// in the hundreds to tens of thousands) the product needs 2*m*n*K flops against
// 4*(m+n)*K + 4*m*n bytes, far above the f32 CUDA-core ridge (~67 TFLOP/s over
// 3.35 TB/s, ~20 flop/byte). Ranking is sensitive to distance error, so the
// tensor cores (TF32 at best for f32 inputs) are not used: every product is an
// f32 FMA.
//
// Design: a classic register-blocked SGEMM. One block of 256 threads owns a
// 128x128 output tile and walks K in steps of 8, staging the q and g slices
// transposed in shared memory; each thread keeps an 8x8 accumulator tile in
// registers, so each shared-memory load feeds 8 FMAs. The norms ride the same
// loop: each thread also squares the 8 q values and 8 g values it already
// holds, which costs 16 FMAs next to the 64 of the product instead of a second
// pass over the inputs. Ragged edges (any m, n, K) are masked with zero-filled
// loads and guarded stores, so no input is padded and every shape runs here.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
distmat_kernel(const float* __restrict__ q, const float* __restrict__ g,
               float* __restrict__ out, int m, int n, int k) {
  __shared__ float qs[BK][BM];
  __shared__ float gs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15: column group
  const int ty = tid / (BN / TN);  // 0..15: row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
  float qn[TM];
  float gn[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    qn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) gn[j] = 0.f;

  // each thread loads 4 elements of each 128x8 slice: row = tid / 2,
  // k-offset = (tid % 2) * 4
  const int lrow = tid >> 1;
  const int lk = (tid & 1) * 4;

  for (int k0 = 0; k0 < k; k0 += BK) {
    {
      const int r = row0 + lrow;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + lk + e;
        qs[lk + e][lrow] =
            (r < m && kk < k) ? q[(size_t)r * k + kk] : 0.f;
      }
      const int c = col0 + lrow;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + lk + e;
        gs[lk + e][lrow] =
            (c < n && kk < k) ? g[(size_t)c * k + kk] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
      // rows ty + 16*i and columns tx + 16*j: consecutive threads read
      // consecutive shared-memory words (no bank conflicts)
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = gs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i) qn[i] = fmaf(a[i], a[i], qn[i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) gn[j] = fmaf(b[j], b[j], gn[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * (BM / TM);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * (BN / TN);
      if (c < n) out[(size_t)r * n + c] = qn[i] + gn[j] - 2.f * acc[i][j];
    }
  }
}

}  // namespace

extern "C" int ieee_distmat_f32(const void* q, const void* g, void* out, int m,
                                int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  distmat_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(g),
      static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
