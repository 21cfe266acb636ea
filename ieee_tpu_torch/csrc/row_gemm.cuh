// The row GEMM of the block backward (block_bwd.cu; probes.cu shares its
// bf16 helpers): out (n, cols) = A (n, kdim) times B^T, bf16 operands
// through loaders, f32 WMMA accumulation on the tiling of wmma_tile.cuh,
// and an epilogue per output row block. A loader
// returns 8 bf16 of a logical matrix, so a BN (+ReLU) can be applied to an
// operand as it is loaded; an epilogue stores the f32 accumulators and may
// return the values for per-block channel sums (added in a fixed order by
// stats_reduce_kernel: no float atomics).
#pragma once

#include "wmma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void unpack8(const bf16* p, float f[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(b[e]);
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(f[e]);
  return *reinterpret_cast<const uint4*>(o);
}

// h = bf16(relu(a * inv + shift)) for channels gc..gc+7 of one row; vf is
// a (rows, c) block whose first two rows are inv and shift
__device__ __forceinline__ uint4 h8(const bf16* __restrict__ a,
                                    const float* __restrict__ vf, int c,
                                    int gc) {
  float af[8], inv[8], shift[8];
  unpack8(a + gc, af);
  load_vec8(vf + gc, inv);
  load_vec8(vf + c + gc, shift);
  float o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float pre = __fadd_rn(__fmul_rn(af[e], inv[e]), shift[e]);
    o[e] = pre > 0.f ? pre : 0.f;
  }
  return pack8(o);
}

// ---------------------------------------------------------------------------
// operand loaders: load8(r, k) returns the 8 bf16 at (r, k..k+7) of a
// logical matrix; the caller keeps r and k in range, a loader returns zero
// where its logical matrix is padding
// ---------------------------------------------------------------------------

struct Plain {  // a row-major (rows, ld) bf16 matrix
  const bf16* t;
  int ld;
  __device__ __forceinline__ uint4 load8(int r, int k) const {
    return *reinterpret_cast<const uint4*>(t + (size_t)r * ld + k);
  }
};

// ---------------------------------------------------------------------------
// out (n, cols) = A (n, kdim) @ B (cols, kdim)^T, with the epilogue; with
// Epi::kStats each block writes its channel sums to spart (row blocks, 2,
// cols).
// ---------------------------------------------------------------------------

template <class LA, class LB, class Epi>
__global__ void __launch_bounds__(THREADS)
rows_gemm_kernel(LA la, LB lb, Epi epi, float* __restrict__ spart, int n,
                 int cols, int kdim) {
  __shared__ __align__(128) bf16 as[BM][BK + PAD];
  __shared__ __align__(128) bf16 bs[BN][BK + PAD];  // BN rows of B
  __shared__ __align__(128) float scratch[THREADS / 32][2][16 * 16];
  __shared__ float red[2][2][BN];  // [warp row][sum, sum*xhat][column]

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
  for (int k0 = 0; k0 < kdim; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BK / 8);
      const int kv = (v % (BK / 8)) * 8;
      const int gk = k0 + kv;
      const int gr = row0 + r;
      *reinterpret_cast<uint4*>(&as[r][kv]) =
          (gr < n && gk < kdim) ? la.load8(gr, gk) : zero;
      const int gc = col0 + r;
      *reinterpret_cast<uint4*>(&bs[r][kv]) =
          (gc < cols && gk < kdim) ? lb.load8(gc, gk) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[FM];
      // B^T (kdim, cols) is B (cols, kdim) read column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &as[wm * WM + i * 16][kk], BK + PAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &bs[wn * WN + j * 16][kk], BK + PAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // each fragment goes through a per-warp 16x16 f32 scratch; a lane
  // applies the epilogue to 8 of its values, then lanes 0-15 (16-31) add
  // the column sums of the values (of their products with x-hat) over the
  // fragment's 16 rows. Rows and columns out of range hold zeros.
  float* sc = scratch[warp][0];
  float* sx = scratch[warp][1];
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
  const int sc_col = lane % 16;
  const bool second = lane >= 16;
  float colsum[FN] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wm * WM + i * 16 + er;
      const int gc = col0 + wn * WN + j * 16 + ec;
      float v[8], vx[8];
      float a8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a8[e] = sc[er * 16 + ec + e];
      if (gr < n && gc < cols) {
        epi.apply(gr, gc, a8, v, vx);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = vx[e] = 0.f;
      }
      if constexpr (Epi::kStats) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[er * 16 + ec + e] = v[e];
          sx[er * 16 + ec + e] = vx[e];
        }
        __syncwarp();
        const float* src = second ? sx : sc;
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < 16; ++r) s += src[r * 16 + sc_col];
        colsum[j] += s;
      }
      __syncwarp();
    }
  }
  if constexpr (Epi::kStats) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
      red[wm][second ? 1 : 0][wn * WN + j * 16 + sc_col] = colsum[j];
    __syncthreads();
    const int which = tid / BN;  // 0: sum, 1: sum with x-hat
    const int col = tid % BN;
    if (col0 + col < cols)
      spart[((size_t)blockIdx.y * 2 + which) * cols + col0 + col] =
          red[0][which][col] + red[1][which][col];
  }
}

template <class LA, class LB, class Epi>
cudaError_t launch_rows(LA la, LB lb, Epi epi, float* spart, float* sums,
                        int n, int cols, int kdim, cudaStream_t s) {
  const int row_blocks = (n + BM - 1) / BM;
  dim3 grid((cols + BN - 1) / BN, row_blocks);
  rows_gemm_kernel<<<grid, THREADS, 0, s>>>(la, lb, epi, spart, n, cols,
                                            kdim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (Epi::kStats) {
    stats_reduce_kernel<<<(2 * cols + 255) / 256, 256, 0, s>>>(
        spart, sums, row_blocks, cols);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
