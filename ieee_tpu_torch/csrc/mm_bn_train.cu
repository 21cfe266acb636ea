// Train-mode 1x1 conv + BatchNorm as three matmul kernels: the forward with
// the batch statistics in its epilogue, and the two backward products with
// the BN backward recomputed in their operand loads.
//
// Replaces: ieee_tpu/ops/pallas/matmul_bn.py
//   `_mm_stats` (body `_mm_stats_kernel`): y = A @ W with A (N, K) and W (K, C)
//       in bf16, the product accumulated in f32, y stored as bf16, and the
//       per-channel sums S1 = sum_n y and S2 = sum_n y^2 taken from the f32
//       accumulator before the bf16 rounding;
//   `_da` (body `_da_kernel`): dA = dy @ W^T, (N, K) bf16;
//   `_dw` (body `_dw_kernel`): dW = A^T @ dy, (K, C) f32.
// In both backward products dy is recomputed per tile from the incoming
// cotangent d (N, C) bf16, the stored y (N, C) bf16 and six f32 rows
// [inv, shift, mean, rstd, S1/N, S2/N] (JAX `_dy_tile`):
//   g  = relu ? (y*inv + shift > 0 ? d : 0) : d
//   dy = bf16(inv * ((g - S1/N) - ((y - mean)*rstd) * S2/N))
// dy never touches device memory. Each of those products is rounded as in
// the plain PyTorch version (`ops/kernels/matmul_bn.py`, no FMA contraction),
// so the ReLU mask and dy agree bit for bit with it.
//
// What bounds them on an H100: the tensor cores. At the layer4 and CIM sites
// of the 256x128 train step (N = B*16*8 = 16384 rows at batch 128, K and C in
// {512, 1024, 2048}) each kernel does 2*N*K*C flops over 2*(N*K + K*C + N*C)
// bytes (plus the d and y reads of the backward), 300-1000 flop/byte, above
// the bf16 ridge of ~295. The reduce site (N = 128 or 768 rows) is small and
// bound by launch and weight reads.
//
// Design (simple first; the mainloop is mm_affine.cu's): a block of 256
// threads (8 warps, 2 x 4) owns a 128x128 output tile; each warp owns 64x32
// of it as 4x2 WMMA 16x16x16 bf16 fragments with f32 accumulators; the
// reduction dimension is walked in steps of 32 through padded shared tiles
// filled with 16-byte loads. Loads are synchronous; cp.async/TMA pipelining
// and wgmma are later work.
//   - Deterministic statistics: no float atomics. Each block writes the sums
//     of its 128 rows for its 128 channels to a (row blocks, 2, C) buffer,
//     summed over its fragments and warps in a fixed order, and a second
//     small kernel adds the row blocks in order. Two runs agree bit for bit.
//   - dW occupancy: at (1024 -> 512) the (K, C) output has only 32 tiles for
//     132 SMs, each reducing over all N rows. The wrapper splits N into S
//     contiguous ranges (grid z), each block writes an f32 partial, and a
//     second kernel adds the S partials in order (S = 1 writes dW directly).
//   - Layouts: W^T in dA and A^T in dW are never materialised; the tiles are
//     read in the stored layout and handed to WMMA as column-major fragments.
// Rows past N and columns past C are masked, so any N runs (the reduce site
// has N = 8 at batch 8); K and C must be multiples of 8 (the wrapper checks).

#include "wmma_tile.cuh"

namespace {

// dy for 8 consecutive channels gc..gc+7 of row r: d and y point at the row's
// first element, vecs is the (6, c) f32 row block. Returns 8 bf16 as a uint4.
__device__ __forceinline__ uint4 dy8(const __nv_bfloat16* __restrict__ d,
                                     const __nv_bfloat16* __restrict__ y,
                                     const float* __restrict__ vecs, int c,
                                     int gc, int relu) {
  const uint4 dv = *reinterpret_cast<const uint4*>(d + gc);
  const uint4 yv = *reinterpret_cast<const uint4*>(y + gc);
  const __nv_bfloat16* db = reinterpret_cast<const __nv_bfloat16*>(&dv);
  const __nv_bfloat16* yb = reinterpret_cast<const __nv_bfloat16*>(&yv);
  float inv[8], shift[8], mean[8], rstd[8], s1[8], s2[8];
  load_vec8(vecs + gc, inv);
  load_vec8(vecs + c + gc, shift);
  load_vec8(vecs + 2 * c + gc, mean);
  load_vec8(vecs + 3 * c + gc, rstd);
  load_vec8(vecs + 4 * c + gc, s1);
  load_vec8(vecs + 5 * c + gc, s2);
  __align__(16) __nv_bfloat16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float yf = __bfloat162float(yb[e]);
    float g = __bfloat162float(db[e]);
    if (relu) {
      const float pre = __fadd_rn(__fmul_rn(yf, inv[e]), shift[e]);
      if (!(pre > 0.f)) g = 0.f;
    }
    const float xhat = __fmul_rn(__fsub_rn(yf, mean[e]), rstd[e]);
    const float t = __fsub_rn(__fsub_rn(g, s1[e]), __fmul_rn(xhat, s2[e]));
    o[e] = __float2bfloat16(__fmul_rn(inv[e], t));
  }
  return *reinterpret_cast<const uint4*>(o);
}

// ---------------------------------------------------------------------------
// forward: y = A @ W (bf16 out) + per-row-block channel sums of y and y^2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
mm_stats_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                int n, int k, int c) {
  __shared__ __align__(128) __nv_bfloat16 as[BM][BK + PAD];
  __shared__ __align__(128) __nv_bfloat16 ws[BK][BN + PAD];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];
  __shared__ float red[2][2][BN];  // [warp row][sum, sumsq][column]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  frag_acc acc[FM][FN];
  zero_acc(acc);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BK / 8);
      const int cv = (v % (BK / 8)) * 8;
      const int gr = row0 + r;
      const int gk = k0 + cv;
      uint4 val = zero;
      if (gr < n && gk < k)
        val = *reinterpret_cast<const uint4*>(a + (size_t)gr * k + gk);
      *reinterpret_cast<uint4*>(&as[r][cv]) = val;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BN / 8);
      const int cv = (v % (BN / 8)) * 8;
      const int gk = k0 + r;
      const int gc = col0 + cv;
      uint4 val = zero;
      if (gk < k && gc < c)
        val = *reinterpret_cast<const uint4*>(w + (size_t)gk * c + gc);
      *reinterpret_cast<uint4*>(&ws[r][cv]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &as[wm * WM + i * 16][kk], BK + PAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &ws[kk][wn * WN + j * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment goes through a per-warp 16x16 f32 scratch; the
  // 8 bf16 of a lane are stored, and lanes 0-15 (16-31) add the column sums
  // (sums of squares) of the fragment's 16 rows. Rows past N hold zeros.
  float* sc = scratch[warp];
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
  const int sc_col = lane % 16;
  const bool squares = lane >= 16;
  float colsum[FN] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wm * WM + i * 16 + er;
      const int gc = col0 + wn * WN + j * 16 + ec;
      if (gr < n && gc < c) {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(sc[er * 16 + ec + e]);
        *reinterpret_cast<uint4*>(y + (size_t)gr * c + gc) =
            *reinterpret_cast<const uint4*>(o);
      }
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float v = sc[r * 16 + sc_col];
        s += squares ? v * v : v;
      }
      colsum[j] += s;
      __syncwarp();
    }
  }
#pragma unroll
  for (int j = 0; j < FN; ++j)
    red[wm][squares ? 1 : 0][wn * WN + j * 16 + sc_col] = colsum[j];
  __syncthreads();
  const int which = tid / BN;  // 0: sum, 1: sum of squares
  const int col = tid % BN;
  if (col0 + col < c)
    part[((size_t)blockIdx.y * 2 + which) * c + col0 + col] =
        red[0][which][col] + red[1][which][col];
}

// ---------------------------------------------------------------------------
// backward: dA = dy @ W^T, dy recomputed per tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
mm_bn_da_kernel(const __nv_bfloat16* __restrict__ d,
                const __nv_bfloat16* __restrict__ y,
                const float* __restrict__ vecs,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int n, int k, int c,
                int relu) {
  __shared__ __align__(128) __nv_bfloat16 ds[BM][BK + PAD];  // dy tile
  __shared__ __align__(128) __nv_bfloat16 ws[BN][BK + PAD];  // W rows (K)
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM;  // rows of N
  const int col0 = blockIdx.x * BN;  // columns of K

  frag_acc acc[FM][FN];
  zero_acc(acc);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c0 = 0; c0 < c; c0 += BK) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BK / 8);
      const int cv = (v % (BK / 8)) * 8;
      const int gr = row0 + r;
      const int gc = c0 + cv;
      uint4 val = zero;
      if (gr < n && gc < c)
        val = dy8(d + (size_t)gr * c, y + (size_t)gr * c, vecs, c, gc, relu);
      *reinterpret_cast<uint4*>(&ds[r][cv]) = val;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BK / 8);
      const int cv = (v % (BK / 8)) * 8;
      const int gk = col0 + r;
      const int gc = c0 + cv;
      uint4 val = zero;
      if (gk < k && gc < c)
        val = *reinterpret_cast<const uint4*>(w + (size_t)gk * c + gc);
      *reinterpret_cast<uint4*>(&ws[r][cv]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      // W^T (c, k) is W (k, c) read column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &ds[wm * WM + i * 16][kk], BK + PAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &ws[wn * WN + j * 16][kk], BK + PAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sc = scratch[warp];
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wm * WM + i * 16 + er;
      const int gk = col0 + wn * WN + j * 16 + ec;
      if (gr < n && gk < k) {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(sc[er * 16 + ec + e]);
        *reinterpret_cast<uint4*>(out + (size_t)gr * k + gk) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dW = A^T @ dy over rows [z*rows, (z+1)*rows), f32 partial per z
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
mm_bn_dw_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ d,
                const __nv_bfloat16* __restrict__ y,
                const float* __restrict__ vecs, float* __restrict__ part,
                int n, int k, int c, int relu, int rows) {
  __shared__ __align__(128) __nv_bfloat16 as[BK][BM + PAD];  // A rows (N)
  __shared__ __align__(128) __nv_bfloat16 ds[BK][BN + PAD];  // dy rows (N)
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM;  // rows of K
  const int col0 = blockIdx.x * BN;  // columns of C
  const int n_begin = blockIdx.z * rows;
  const int n_end = min(n, n_begin + rows);

  frag_acc acc[FM][FN];
  zero_acc(acc);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int n0 = n_begin; n0 < n_end; n0 += BK) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BM / 8);
      const int cv = (v % (BM / 8)) * 8;
      const int gn = n0 + r;
      const int gk = row0 + cv;
      uint4 val = zero;
      if (gn < n_end && gk < k)
        val = *reinterpret_cast<const uint4*>(a + (size_t)gn * k + gk);
      *reinterpret_cast<uint4*>(&as[r][cv]) = val;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BN / 8);
      const int cv = (v % (BN / 8)) * 8;
      const int gn = n0 + r;
      const int gc = col0 + cv;
      uint4 val = zero;
      if (gn < n_end && gc < c)
        val = dy8(d + (size_t)gn * c, y + (size_t)gn * c, vecs, c, gc, relu);
      *reinterpret_cast<uint4*>(&ds[r][cv]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A^T (k, n) is A (n, k) read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &as[kk][wm * WM + i * 16], BM + PAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &ds[kk][wn * WN + j * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * k * c;
  float* sc = scratch[warp];
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gk = row0 + wm * WM + i * 16 + er;
      const int gc = col0 + wn * WN + j * 16 + ec;
      if (gk < k && gc < c) {
        float* dst = out + (size_t)gk * c + gc;
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(&sc[er * 16 + ec]);
        *reinterpret_cast<float4*>(dst + 4) =
            *reinterpret_cast<const float4*>(&sc[er * 16 + ec + 4]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// y (n, c) bf16 and stats (2, c) f32 [sum, sum of squares]; part is scratch
// of (ceil(n / 128), 2, c) f32.
extern "C" int ieee_mm_stats_bf16(const void* a, const void* w, void* y,
                                  void* stats, void* part, int n, int k,
                                  int c, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + BM - 1) / BM;
  dim3 grid((c + BN - 1) / BN, row_blocks);
  mm_stats_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(part), n, k, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_reduce_kernel<<<(2 * c + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(stats), row_blocks,
      c);
  return static_cast<int>(cudaGetLastError());
}

// da (n, k) bf16 from d, y (n, c) bf16, vecs (6, c) f32, w (k, c) bf16.
extern "C" int ieee_mm_bn_da_bf16(const void* d, const void* y,
                                  const void* vecs, const void* w, void* da,
                                  int n, int k, int c, int relu,
                                  void* stream) {
  if (n <= 0 || k <= 0) return 0;
  dim3 grid((k + BN - 1) / BN, (n + BM - 1) / BM);
  mm_bn_da_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(vecs),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(da),
      n, k, c, relu);
  return static_cast<int>(cudaGetLastError());
}

// dw (k, c) f32 from a (n, k) bf16, d, y (n, c) bf16, vecs (6, c) f32. With
// splits > 1, part is scratch of (splits, k, c) f32 and each split reduces
// `rows` rows (a multiple of 32); with splits == 1 part may be null.
extern "C" int ieee_mm_bn_dw_bf16(const void* a, const void* d, const void* y,
                                  const void* vecs, void* dw, void* part,
                                  int n, int k, int c, int relu, int splits,
                                  int rows, void* stream) {
  if (k <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(dw);
  dim3 grid((c + BN - 1) / BN, (k + BM - 1) / BM, splits);
  mm_bn_dw_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(vecs),
      dst, n, k, c, relu, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const size_t size = (size_t)k * c;
  split_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, size);
  return static_cast<int>(cudaGetLastError());
}
