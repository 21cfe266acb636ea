// The measurement probes' kernels: a bf16 streaming scale (the HBM probe)
// and a matmul whose A operand is normalised and rectified as it is loaded
// (the fused-consumer probe).
//
// Replaces:
//   tools/bw_probe.py `pallas_scale` (:66) and `pallas_scale_b` (:89), one
//       body `kern`: o = x * bf16(1.0001) on a bf16 (rows, cols) array, in
//       blocks of 512 and of 2048 rows. bf16(1.0001) is exactly 1.0, so the
//       output equals the input; the kernel still reads and writes every
//       byte, as the TPU kernel does (it measures bandwidth).
//   tools/fusion_probe.py `pallas_bn_mm` (:129, body `bn_mm_kernel`):
//       o = bf16(h @ W2), h = bf16(relu(y * inv + sh)) with y (N, K) bf16,
//       inv and sh (K,) f32, W2 (K, C) bf16, f32 accumulation.
// (`pallas_mm_stats`, the probe's third kernel, is the prototype of
// matmul_bn.py `_mm_stats`: the port runs it on mm_bn_train.cu's mm_stats.)
//
// What bounds them on an H100: the scale moves 2 bytes in and 2 out per
// element and does one multiply: bytes, 2 * 134 MB over 3.35 TB/s = 0.080
// ms at (8192, 8192). bn_mm at the probe's shape (16384 x 2048 x 2048) does
// 137 GFLOP over 0.15 GB, ~900 flop per byte, above the bf16 ridge of
// ~295: the tensor cores (0.139 ms at 989 TFLOP/s).
//
// Design (simple first):
//   - scale: the JAX block height stays the unit of work, a template
//     parameter (512 or 2048 rows). Tiles are taken in order, and every
//     block of the grid (8 per SM) takes a share of each tile's 16-byte
//     vectors, grid-strided, so all SMs stream even when a tile count is 4.
//     Each element is multiplied in f32 and rounded once to bf16, which is
//     the plain version's (and JAX's) bf16 multiply.
//   - bn_mm: row_gemm.cuh's WMMA mainloop (the block backward's) with the
//     ReluBn loader on A, which computes h with explicit round-to-nearest
//     operations (no FMA contraction), bit for bit the plain version's h,
//     and W2 read as stored (kdim, cols) rows; the epilogue rounds the f32
//     accumulators to bf16. y * inv + sh never touches device memory.
// The scale needs cols % 8 == 0 and bn_mm K and C % 8 == 0 (the wrappers
// check); any row count runs.

#include "row_gemm.cuh"

namespace {

constexpr int SCALE_THREADS = 256;

template <int TILE_ROWS>
__global__ void __launch_bounds__(SCALE_THREADS)
scale_kernel(const uint4* __restrict__ x, uint4* __restrict__ o, float s,
             int rows, int vecs_per_row) {
  const size_t stride = (size_t)gridDim.x * SCALE_THREADS;
  for (int r0 = 0; r0 < rows; r0 += TILE_ROWS) {
    const size_t begin = (size_t)r0 * vecs_per_row;
    const size_t end = (size_t)min(rows, r0 + TILE_ROWS) * vecs_per_row;
    for (size_t i = begin + (size_t)blockIdx.x * SCALE_THREADS + threadIdx.x;
         i < end; i += stride) {
      float f[8];
      unpack8(reinterpret_cast<const bf16*>(x + i), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], s);
      o[i] = pack8(f);
    }
  }
}

struct Store {  // out = bf16(acc), (N, cols)
  bf16* out;
  int cols;
  static constexpr bool kStats = false;
  __device__ __forceinline__ void apply(int r, int k, const float* acc,
                                        float v[8], float vx[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = acc[e];
    *reinterpret_cast<uint4*>(out + (size_t)r * cols + k) = pack8(v);
  }
};

}  // namespace

// o (rows, cols) = x * s, bf16, s a bf16 value given as f32; tile_rows 512
// or 2048; blocks: the grid.
extern "C" int ieee_scale_bf16(const void* x, void* o, float s, int rows,
                               int cols, int tile_rows, int blocks,
                               void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(o);
  const int vecs = cols / 8;
  if (tile_rows == 512)
    scale_kernel<512><<<blocks, SCALE_THREADS, 0, st>>>(xv, ov, s, rows, vecs);
  else if (tile_rows == 2048)
    scale_kernel<2048><<<blocks, SCALE_THREADS, 0, st>>>(xv, ov, s, rows,
                                                          vecs);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// o (n, c) bf16 = bf16(relu(y * inv + sh)) @ w2 from y (n, k) bf16, vf
// (2, k) f32 [inv, sh] and w2 (k, c) bf16.
extern "C" int ieee_bn_mm_bf16(const void* y, const void* vf, const void* w2,
                               void* o, int n, int k, int c, void* stream) {
  if (n <= 0) return 0;
  const ReluBn h{static_cast<const bf16*>(y), static_cast<const float*>(vf),
                 k};
  const PlainT w{static_cast<const bf16*>(w2), c};
  const Store epi{static_cast<bf16*>(o), c};
  return static_cast<int>(launch_rows(h, w, epi, nullptr, nullptr, n, c, k,
                                      static_cast<cudaStream_t>(stream)));
}
