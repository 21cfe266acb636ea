// Fused global + part pooling -> 2048->768 reduce -> folded BN -> ReLU.
//
// Replaces: ieee_tpu/ops/pallas/partpool.py `fused_partpool_project` (Pallas
// body `_kernel`): for each sample, pooled = pool @ x in f32, where pool is the
// (P+1, H*W) matrix of `_pool_matrix` (row 0 the global mean, rows 1..P the
// adaptive stripes, which overlap when P does not divide H: H = 16, P = 6 at
// 256x128); then relu((bf16(pooled) @ W_bf16) * s + t) in f32.
// Rounding points follow the TPU kernel: the map is streamed as bf16 (an f32
// map is rounded to bf16 on load, as `stream_bf16` does before the call),
// pooling accumulates in f32, the pooled rows are rounded to bf16 before the
// product, W is bf16, the product accumulates in f32 and the output is f32.
//
// What bounds it on an H100: bytes. Each call reads the whole map once
// (100 x 128 x 2048 values, 105 MB as f32) and does 2*(P+1)*C*(HW+F) flops per
// sample, ~0.3 flop/byte: memory-bound by two orders of magnitude.
//
// Design: one block per sample, so the pooled (P+1, C) rows never leave the
// SM. Phase 1 streams the sample's (HW, C) map with consecutive threads on
// consecutive channel pairs (coalesced), keeps the P+1 pooled sums of its two
// channels in registers (P+1 is a template parameter) and reads the pooling
// weights from shared memory, so overlapping stripes cost nothing extra.
// The bf16-rounded pooled rows go to shared memory as f32: (P+1)*C*4 = 57 KB
// for C = 2048, above the 48 KB default, hence cudaFuncSetAttribute. Phase 2
// gives each thread two output columns for all P+1 rows and walks C, reading
// W (3 MB, shared by all blocks through L2) with coalesced bf16x2 loads and
// the pooled rows as shared-memory broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return make_float2(round_bf16(v.x), round_bf16(v.y));
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int R>
__global__ void partpool_kernel(const T* __restrict__ x,
                                const float* __restrict__ pool,
                                const __nv_bfloat16* __restrict__ w,
                                const float* __restrict__ s,
                                const float* __restrict__ t,
                                float* __restrict__ out, int hw, int c,
                                int f) {
  extern __shared__ float smem[];
  float* pool_s = smem;          // (R, hw)
  float* pooled_s = smem + R * hw;  // (R, c), bf16-rounded values

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < R * hw; i += nt) pool_s[i] = pool[i];
  __syncthreads();

  // phase 1: pooled[r, ch] = sum_hw pool[r, hw] * bf16(x[b, hw, ch])
  const T* xb = x + (size_t)b * hw * c;
  for (int cp = tid; cp < c / 2; cp += nt) {
    float acc0[R];
    float acc1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.f;
    for (int i = 0; i < hw; ++i) {
      const float2 v = load_pair(xb + (size_t)i * c + 2 * cp);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pw = pool_s[r * hw + i];
        acc0[r] = fmaf(pw, v.x, acc0[r]);
        acc1[r] = fmaf(pw, v.y, acc1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pooled_s[r * c + 2 * cp] = round_bf16(acc0[r]);
      pooled_s[r * c + 2 * cp + 1] = round_bf16(acc1[r]);
    }
  }
  __syncthreads();

  // phase 2: out[b, r, col] = relu((pooled[r] . W[:, col]) * s + t)
  float* ob = out + (size_t)b * R * f;
  for (int fp = tid; fp < f / 2; fp += nt) {
    float acc0[R];
    float acc1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float2 wv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(w + (size_t)ch * f + 2 * fp));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pooled_s[r * c + ch];
        acc0[r] = fmaf(p, wv.x, acc0[r]);
        acc1[r] = fmaf(p, wv.y, acc1[r]);
      }
    }
    const int col = 2 * fp;
    const float s0 = s[col], s1 = s[col + 1];
    const float t0 = t[col], t1 = t[col + 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ob[r * f + col] = fmaxf(acc0[r] * s0 + t0, 0.f);
      ob[r * f + col + 1] = fmaxf(acc1[r] * s1 + t1, 0.f);
    }
  }
}

template <typename T, int R>
int launch(const void* x, const void* pool, const void* w, const void* s,
           const void* t, void* out, int b, int hw, int c, int f,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * (hw + c);
  auto kern = partpool_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((f / 2 + 31) / 32) * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  kern<<<b, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(pool),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<float*>(out), hw, c, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_rows(int rows, const void* x, const void* pool, const void* w,
                  const void* s, const void* t, void* out, int b, int hw,
                  int c, int f, cudaStream_t stream) {
  switch (rows) {
#define IEEE_PARTPOOL_ROWS(R) \
  case R:                     \
    return launch<T, R>(x, pool, w, s, t, out, b, hw, c, f, stream);
    IEEE_PARTPOOL_ROWS(2)
    IEEE_PARTPOOL_ROWS(3)
    IEEE_PARTPOOL_ROWS(4)
    IEEE_PARTPOOL_ROWS(5)
    IEEE_PARTPOOL_ROWS(6)
    IEEE_PARTPOOL_ROWS(7)
    IEEE_PARTPOOL_ROWS(8)
    IEEE_PARTPOOL_ROWS(9)
#undef IEEE_PARTPOOL_ROWS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x_is_bf16: 1 for a bf16 map, 0 for an f32 map (rounded to bf16 on load).
extern "C" int ieee_partpool(const void* x, int x_is_bf16, const void* pool,
                             const void* w, const void* s, const void* t,
                             void* out, int b, int rows, int hw, int c, int f,
                             void* stream) {
  if (b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return dispatch_rows<__nv_bfloat16>(rows, x, pool, w, s, t, out, b, hw, c,
                                        f, st);
  return dispatch_rows<float>(rows, x, pool, w, s, t, out, b, hw, c, f, st);
}
