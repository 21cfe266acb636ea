// The bandwidth probe's kernel: a bf16 streaming scale.
//
// Replaces:
//   tools/bw_probe.py `pallas_scale` (:66) and `pallas_scale_b` (:89), one
//       body `kern`: o = x * bf16(1.0001) on a bf16 (rows, cols) array, in
//       blocks of 512 and of 2048 rows. bf16(1.0001) is exactly 1.0, so the
//       output equals the input; the kernel still reads and writes every
//       byte, as the TPU kernel does (it measures bandwidth).
// (`pallas_mm_stats`, the fusion probe's prototype of matmul_bn.py
// `_mm_stats`, runs on mm_bn_train.cu's mm_stats; its `pallas_bn_mm` on
// bn_gemm_sm90.cu's bn_mm.)
//
// What bounds it on an H100: 2 bytes in and 2 out per element and one
// multiply: bytes, 2 * 134 MB over 3.35 TB/s = 0.080 ms at (8192, 8192).
//
// Design: the JAX block height stays the unit of work, a template
// parameter (512 or 2048 rows). Tiles are taken in order, and every block
// of the grid takes a share of each tile: rounds of 1024 16-byte vectors,
// each thread four of them, 256 apart, so a warp's loads stay contiguous.
// The wrapper sizes the grid so that every block takes the same whole
// number of rounds of a tile (512 blocks at 512 rows of 8192, 1024 at 2048
// rows: one and two rounds), up to 8 blocks an SM. A thread issues its four loads
// (ld.global.nc.L1::no_allocate: read once, kept out of L1) before any
// store (st.global.cs: streamed, evict first), so 64 bytes a thread are in
// flight, not 16: enough to cover the memory's latency at the card's rate
// even at 512-row tiles, where about four blocks run per SM. Each element
// is multiplied in f32 and rounded once to bf16, which is the plain
// version's (and JAX's) bf16 multiply. cols % 8 == 0 (the wrapper checks);
// any row count runs.

#include "vec8_sums.cuh"  // unpack8, pack8, load_stream, store_stream

namespace {

constexpr int SCALE_THREADS = 256;
constexpr int kLoads = 4;  // 16-byte loads in flight per thread

template <int TILE_ROWS>
__global__ void __launch_bounds__(SCALE_THREADS)
scale_kernel(const uint4* __restrict__ x, uint4* __restrict__ o, float s,
             int rows, int vecs_per_row) {
  constexpr int kRound = SCALE_THREADS * kLoads;  // a block's vectors
  const size_t stride = (size_t)gridDim.x * kRound;
  for (int r0 = 0; r0 < rows; r0 += TILE_ROWS) {
    const size_t end = (size_t)min(rows, r0 + TILE_ROWS) * vecs_per_row;
    for (size_t i0 = (size_t)r0 * vecs_per_row +
                     (size_t)blockIdx.x * kRound + threadIdx.x;
         i0 < end; i0 += stride) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const size_t i = i0 + u * SCALE_THREADS;
        if (i < end) v[u] = load_stream(x + i);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const size_t i = i0 + u * SCALE_THREADS;
        if (i < end) {
          float f[8];
          unpack8(v[u], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], s);
          store_stream(o + i, pack8(f));
        }
      }
    }
  }
}

}  // namespace

// o (rows, cols) = x * s, bf16, s a bf16 value given as f32; tile_rows 512
// or 2048; blocks: the grid (ops/kernels/probes.py: whole rounds a block).
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
