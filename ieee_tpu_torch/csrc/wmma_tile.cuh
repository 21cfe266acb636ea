// The WMMA tiling of mm_stats (mm_bn_train.cu), the 8-wide bf16/f32 vector
// helpers of the streaming kernels (block_bwd.cu's reduce3, probes.cu's
// scale), and the deterministic-sum kernels that every kernel with sums
// across blocks shares. The tiling: a block of 256 threads (8 warps, 2 x 4)
// owns a 128x128 output tile, each warp 64x32 of it as 4x2 WMMA 16x16x16
// bf16 fragments with f32 accumulators, the reduction walked in steps of 32
// through padded shared tiles. Sums across blocks are per-block partials
// added in a fixed order by a second small kernel (no float atomics), so
// two runs agree bit for bit.
#pragma once

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

using frag_acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void load_vec8(const float* p, float v[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

using bf16 = __nv_bfloat16;

// the 8 bf16 at p (16-byte aligned) as f32
__device__ __forceinline__ void unpack8(const bf16* p, float f[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(b[e]);
}

// 8 f32 rounded to nearest-even bf16, as one 16-byte vector
__device__ __forceinline__ uint4 pack8(const float f[8]) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(f[e]);
  return *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ void zero_acc(frag_acc (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// stats[which][col] = sum over row blocks of part[block][which][col], in
// order (which: the two sums of a (2, c) result)
__global__ void stats_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ stats, int blocks,
                                    int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * c) return;
  const int which = i / c;
  const int col = i % c;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[((size_t)b * 2 + which) * c + col];
  stats[i] = s;
}

// out[i] = sum over splits s of part[s][i], in order
__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int splits,
                                    size_t size) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * size + i];
  out[i] = s;
}

}  // namespace
