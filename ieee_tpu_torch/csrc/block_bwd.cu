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
// rounds, so d3 agrees with it bit for bit. The mask compares in f32.
//
// What bounds it on an H100 (batch 128 at 256x128: N = 262144, 65536, 16384
// rows at C = 256, 512, 1024): `_reduce3` moves 8 N C bytes for no product:
// bytes (2.28 ms over the 30 blocks of a step).
//
// Design: one launch, one wave. The grid is (C / 128 channel tiles) x (row
// ranges), two blocks an SM over the card (ops/kernels/block_bwd.py
// `_reduce3_plan`); a block owns one contiguous range of rows of one
// 128-channel tile. Its threads are 16 channel lanes (8 channels, one
// 16-byte vector, each) by 16 row lanes; a warp reads two whole 256-byte
// row segments. Each thread issues the loads of 4 rows of dy, y and a3 (12
// 16-byte loads) before it computes any of them: 192 bytes a thread in
// flight. Its two sums run in f32 registers over its rows in order; the
// row lanes are added in order through shared memory into one (2, 128)
// partial per block. Then each block takes a ticket of its tile (an atomic
// counter, after __threadfence); the tile's last block adds the partials of
// all its row ranges in range order (4 groups of consecutive ranges, then
// the groups in order), writes S3 and resets the ticket for the next call.
// No float atomics: two runs agree bit for bit. The tile width weighs the
// stream against that last sum (at most 132 partials of 1 KB at the main
// path's stages, spread over C / 128 blocks): in a paired run on an H100
// 128-channel tiles took 2.69 device ms a batch-128 step, 64-channel tiles
// 2.75 and 256-channel tiles 2.79-2.81; streaming loads and stores
// (ld.global.nc.L1::no_allocate, st.global.cs) 2.91 against plain ones'
// 2.75 at 64 (PERF.md §6). Channel counts must be multiples of 8 (the
// wrapper checks); any N runs.

#include "vec8_sums.cuh"  // unpack8, pack8, load_vec8

namespace {

constexpr int kLanes = 16;                  // channel lanes of a block
constexpr int kTile = 8 * kLanes;           // its 128 channels
constexpr int kRowLanes = 16;               // row lanes of a block
constexpr int kThreads = kLanes * kRowLanes;
constexpr int kRowsInFlight = 4;            // rows a thread loads at once
constexpr int kGroups = kThreads / (2 * kTile / 4);  // of the final sum

__device__ __forceinline__ float xhat(float a, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(a, mean), rstd);
}

// block (tile, range): d3 and the sums of rows [range * rows, + rows) of
// channels [128 tile, + 128); the tile's last block to finish writes its S3
__global__ void __launch_bounds__(kThreads, 2)
reduce3_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
               const bf16* __restrict__ a3, const float* __restrict__ mean3,
               const float* __restrict__ rstd3, bf16* __restrict__ d3,
               float* __restrict__ s3, float* __restrict__ part,
               unsigned* __restrict__ tickets, int n, int c, int rows) {
  __shared__ __align__(16) float red[kRowLanes][2][kTile];
  __shared__ bool last;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int tile = blockIdx.x;
  const int range = blockIdx.y;
  const int cbase = tile * kTile;
  const int gc = cbase + tx * 8;
  const int r1 = min(n, (range + 1) * rows);
  float s[8], sx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = sx[e] = 0.f;
  if (gc < c) {
    float mean[8], rstd[8];
    load_vec8(mean3 + gc, mean);
    load_vec8(rstd3 + gc, rstd);
    for (int r = range * rows + ty; r < r1;
         r += kRowLanes * kRowsInFlight) {
      uint4 g[kRowsInFlight], yv[kRowsInFlight], av[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int ru = r + u * kRowLanes;
        if (ru < r1) {
          const size_t off = (size_t)ru * c + gc;
          g[u] = *reinterpret_cast<const uint4*>(dy + off);
          yv[u] = *reinterpret_cast<const uint4*>(y + off);
          av[u] = *reinterpret_cast<const uint4*>(a3 + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int ru = r + u * kRowLanes;
        if (ru < r1) {
          float gf[8], yf[8], af[8];
          unpack8(g[u], gf);
          unpack8(yv[u], yf);
          unpack8(av[u], af);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (!(yf[e] > 0.f)) gf[e] = 0.f;
            s[e] += gf[e];
            sx[e] += __fmul_rn(gf[e], xhat(af[e], mean[e], rstd[e]));
          }
          *reinterpret_cast<uint4*>(d3 + (size_t)ru * c + gc) = pack8(gf);
        }
      }
    }
  }
  // the block's partial: its row lanes added in order
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[ty][0][tx * 8 + e] = s[e];
    red[ty][1][tx * 8 + e] = sx[e];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * kTile; o += kThreads) {
    const int which = o / kTile;
    const int col = o % kTile;
    float t = 0.f;
#pragma unroll 8
    for (int q = 0; q < kRowLanes; ++q) t += red[q][which][col];
    if (cbase + col < c)
      part[((size_t)range * 2 + which) * c + cbase + col] = t;
  }
  // every partial of the block is written and visible to the card before
  // its ticket is taken
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + tile, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the tile's last block: S3 = the ranges' partials added in order, in
  // kGroups groups of consecutive ranges (a float4 of 4 columns a thread),
  // then the groups in order
  const int v = threadIdx.x % (2 * kTile / 4);  // float4 of the (2, 128) sums
  const int g = threadIdx.x / (2 * kTile / 4);
  const int which = v / (kTile / 4);
  const int col = cbase + (v % (kTile / 4)) * 4;  // c % 8 == 0: col + 3 < c
  const int ranges = gridDim.y;
  const int per = (ranges + kGroups - 1) / kGroups;
  const int b0 = min(ranges, g * per), b1 = min(ranges, b0 + per);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < c) {
#pragma unroll 4
    for (int b = b0; b < b1; ++b) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(
          part + ((size_t)b * 2 + which) * c + col));
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
  }
  float4* grp = reinterpret_cast<float4*>(&red[0][0][0]);  // [kGroups][64]
  grp[g * (2 * kTile / 4) + v] = acc;
  __syncthreads();
  if (g == 0 && col < c) {
    float4 t = grp[v];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) {
      const float4 p = grp[q * (2 * kTile / 4) + v];
      t.x += p.x;
      t.y += p.y;
      t.z += p.z;
      t.w += p.w;
    }
    *reinterpret_cast<float4*>(s3 + (size_t)which * c + col) = t;
  }
  if (threadIdx.x == 0) tickets[tile] = 0u;  // for the next launch
}

}  // namespace

// d3 (n, c) bf16 and s3 (2, c) f32 = [sum d3, sum d3 * xhat3] from dy, y,
// a3 (n, c) bf16 and mean3, rstd3 (c,) f32, over a grid of (c / 128) x
// `ranges` blocks of `rows` rows each (ranges * rows >= n); part is scratch
// of (ranges, 2, c) f32 and tickets (c / 128,) unsigned, all 0 before the
// first call (each call leaves them 0). Calls that share the scratch must be
// ordered (one stream).
extern "C" int ieee_block_reduce3(const void* dy, const void* y,
                                  const void* a3, const void* mean3,
                                  const void* rstd3, void* d3, void* s3,
                                  void* part, void* tickets, int n, int c,
                                  int ranges, int rows, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (ranges <= 0 || (long long)ranges * rows < n)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((c + kTile - 1) / kTile, ranges);
  reduce3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
      static_cast<const bf16*>(a3), static_cast<const float*>(mean3),
      static_cast<const float*>(rstd3), static_cast<bf16*>(d3),
      static_cast<float*>(s3), static_cast<float*>(part),
      static_cast<unsigned*>(tickets), n, c, rows);
  return static_cast<int>(cudaGetLastError());
}
