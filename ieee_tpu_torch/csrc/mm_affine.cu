// Eval-mode 1x1 conv + folded BatchNorm [+ ReLU] as one matmul kernel.
//
// Replaces: ieee_tpu/ops/pallas/matmul_bn.py `mm_affine_act` (Pallas body
// `_mm_affine_kernel`): out = [relu]((A @ W) * inv + shift), A (N, K) and
// W (K, C) in bf16, the product accumulated in f32, the affine and ReLU on the
// f32 accumulator, the result stored as bf16. A residual, when the caller has
// one, is added outside (models/common.py), exactly as in the JAX package.
//
// What bounds it on an H100: the tensor cores. At the layer4 sites of the
// 256x128 eval (N = 100*16*8 = 12800 rows, K in {512, 1024, 2048}, C in
// {512, 2048}) the arithmetic intensity is 2*N*K*C / (2*(N*K + K*C + N*C))
// = 300-700 flop/byte, at or above the bf16 ridge of ~295.
//
// Design (simple first): one block of 256 threads (8 warps, 2 x 4) owns a
// 128x128 output tile; each warp owns 64x32 of it as 4x2 WMMA 16x16x16 bf16
// fragments with f32 accumulators. K is walked in steps of 32 through padded
// shared-memory tiles loaded with 16-byte vectors (rows padded by 8 elements
// so WMMA's strided fragment loads spread over the banks). The epilogue goes
// fragment by fragment through a 1 KB per-warp scratch, applies the folded BN
// and ReLU in f32 and writes 8 bf16 per lane. Rows past N and columns past C
// are masked, so any N runs; K and C must be multiples of 8 (the wrapper
// checks). Loads are synchronous: cp.async/TMA pipelining and wgmma are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PAD = 8;
constexpr int THREADS = 256;
constexpr int WARPS_N = 4;   // warp grid 2 (rows) x 4 (cols)
constexpr int WM = 64;       // rows per warp
constexpr int WN = 32;       // cols per warp
constexpr int FM = WM / 16;  // 4 fragments down
constexpr int FN = WN / 16;  // 2 fragments across

__global__ void __launch_bounds__(THREADS)
mm_affine_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ inv, const float* __restrict__ shift,
                 __nv_bfloat16* __restrict__ out, int n, int k, int c,
                 int relu) {
  __shared__ __align__(128) __nv_bfloat16 as[BM][BK + PAD];
  __shared__ __align__(128) __nv_bfloat16 ws[BK][BN + PAD];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: 128 rows x 32 cols = 512 vectors of 8 bf16, 2 per thread
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
    // W tile: 32 rows x 128 cols = 512 vectors, 2 per thread
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
                     wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[FN];
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

  // epilogue: fragment -> per-warp scratch -> affine, relu, bf16 -> global
  float* sc = scratch[warp];
  const int er = lane / 2;       // row within the 16x16 fragment
  const int ec = (lane % 2) * 8;  // first of 8 columns
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
        for (int e = 0; e < 8; ++e) {
          float x = sc[er * 16 + ec + e] * inv[gc + e] + shift[gc + e];
          if (relu) x = fmaxf(x, 0.f);
          o[e] = __float2bfloat16(x);
        }
        *reinterpret_cast<uint4*>(out + (size_t)gr * c + gc) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int ieee_mm_affine_bf16(const void* a, const void* w,
                                   const void* inv, const void* shift,
                                   void* out, int n, int k, int c, int relu,
                                   void* stream) {
  if (n <= 0 || c <= 0) return 0;
  dim3 grid((c + BN - 1) / BN, (n + BM - 1) / BM);
  mm_affine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out), n, k,
      c, relu);
  return static_cast<int>(cudaGetLastError());
}
