// What the streaming kernels and the kernels with sums across blocks share:
// the 8-wide bf16/f32 vector helpers (block_bwd.cu's reduce3,
// block_bwd_sm90.cu's operand pass, probes.cu's scale) and the two in-order
// sum kernels. Sums across blocks are per-block partials added in a fixed
// order by a second small kernel (no float atomics), so two runs agree bit
// for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void load_vec8(const float* p, float v[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

using bf16 = __nv_bfloat16;

// the 8 bf16 of a 16-byte vector as f32
__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(b[e]);
}

// the 8 bf16 at p (16-byte aligned) as f32
__device__ __forceinline__ void unpack8(const bf16* p, float f[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

// 8 f32 rounded to nearest-even bf16, as one 16-byte vector
__device__ __forceinline__ uint4 pack8(const float f[8]) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(f[e]);
  return *reinterpret_cast<const uint4*>(o);
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
