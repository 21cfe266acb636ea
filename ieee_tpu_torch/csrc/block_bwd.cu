// Whole-block backward of the stride-1 bottleneck without downsample: the
// first of its four kernels, `_reduce3`, which has no product (the other
// three, `_bn3_apply`, `_conv2_bwd` and `_bn1_apply`, are matrix products
// on Hopper's wgmma: bn_gemm_sm90.cu and block_bwd_sm90.cu, with their
// shared bodies in bn_gemm_sm90.cuh).
//
// Replaces: ieee_tpu/ops/pallas/block_bwd.py `_reduce3` (:316, body
//   `_k_reduce3`): d3 = dy * [y > 0] (bf16 out) and the channel sums
//   S31 = sum d3, S32 = sum d3 * xhat3 (f32).
// Activations are (N, C) rows, N = B*H*W, of channels_last maps; xhat3 =
// (a3 - mean3) * rstd3 with each operation rounded on its own (no FMA
// contraction), as the plain PyTorch version (`ops/kernels/block_bwd.py`)
// rounds, so d3 agrees with it bit for bit.
//
// What bounds it on an H100 (batch 128 at 256x128: N = 262144, 65536, 16384
// rows at C = 256, 512, 1024): `_reduce3` moves 8 N C bytes for no product:
// bytes (2.28 ms over the 30 blocks of a step).
//
// Design: a block streams `rows` rows of 256 channels, 8 channels (one
// 16-byte vector) a thread across and 8 row lanes down; its channel sums go
// through shared memory to one partial per block, and stats_reduce_kernel
// adds the blocks' partials in a fixed order: no float atomics, so two runs
// agree bit for bit. Channel counts must be multiples of 8 (the wrapper
// checks); any N runs.

#include "wmma_tile.cuh"  // unpack8, pack8, load_vec8, stats_reduce_kernel

namespace {

__device__ __forceinline__ float xhat(float a, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(a, mean), rstd);
}

// ---------------------------------------------------------------------------
// _reduce3: d3 = dy * [y > 0] and the channel sums of `rows` rows per block
// (y of the grid) over 256 channels (x of the grid); threads (32, 8): 8
// channels per thread across, 8 row lanes down
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
reduce3_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
               const bf16* __restrict__ a3, const float* __restrict__ vec,
               bf16* __restrict__ d3, float* __restrict__ part, int n, int c,
               int rows) {
  __shared__ float red[8][2][256];  // [row lane][sum, sum*xhat][channel]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int cbase = blockIdx.x * 256;
  const int gc = cbase + tx * 8;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(n, r0 + rows);
  float s[8], sx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = sx[e] = 0.f;
  if (gc < c) {
    float mean[8], rstd[8];
    load_vec8(vec + gc, mean);
    load_vec8(vec + c + gc, rstd);
    for (int r = r0 + ty; r < r1; r += 8) {
      const size_t off = (size_t)r * c + gc;
      float g[8], yf[8], af[8];
      unpack8(dy + off, g);
      unpack8(y + off, yf);
      unpack8(a3 + off, af);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!(yf[e] > 0.f)) g[e] = 0.f;
        s[e] += g[e];
        sx[e] += __fmul_rn(g[e], xhat(af[e], mean[e], rstd[e]));
      }
      *reinterpret_cast<uint4*>(d3 + off) = pack8(g);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[ty][0][tx * 8 + e] = s[e];
    red[ty][1][tx * 8 + e] = sx[e];
  }
  __syncthreads();
  const int tid = ty * 32 + tx;
  for (int o = tid; o < 512; o += 256) {
    const int which = o / 256;
    const int col = o % 256;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += red[q][which][col];
    if (cbase + col < c)
      part[((size_t)blockIdx.y * 2 + which) * c + cbase + col] = t;
  }
}

}  // namespace

// d3 (n, c) bf16 and s3 (2, c) f32 from dy, y, a3 (n, c) bf16 and vec (2, c)
// f32 [mean3, rstd3]; part is scratch of (ceil(n / rows), 2, c) f32.
extern "C" int ieee_block_reduce3(const void* dy, const void* y,
                                  const void* a3, const void* vec, void* d3,
                                  void* s3, void* part, int n, int c,
                                  int rows, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + rows - 1) / rows;
  dim3 grid((c + 255) / 256, row_blocks);
  reduce3_kernel<<<grid, dim3(32, 8), 0, s>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
      static_cast<const bf16*>(a3), static_cast<const float*>(vec),
      static_cast<bf16*>(d3), static_cast<float*>(part), n, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_reduce_kernel<<<(2 * c + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(s3), row_blocks,
      c);
  return static_cast<int>(cudaGetLastError());
}
