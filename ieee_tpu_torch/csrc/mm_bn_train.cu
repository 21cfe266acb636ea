// Train-mode 1x1 conv + BatchNorm, forward: y = A @ W with the batch
// statistics in its epilogue. The two backward products (dA, dW with the BN
// backward recomputed in registers) are mm_bn_bwd.cu's kernels.
//
// Replaces: ieee_tpu/ops/pallas/matmul_bn.py
//   `_mm_stats` (body `_mm_stats_kernel`): y = A @ W with A (N, K) and W (K, C)
//       in bf16, the product accumulated in f32, y stored as bf16, and the
//       per-channel sums S1 = sum_n y and S2 = sum_n y^2 taken from the f32
//       accumulator before the bf16 rounding.
//   (tools/fusion_probe.py `pallas_mm_stats` is the same kernel.)
//
// What bounds it and the mainloop: mm_sm90.cuh. The epilogue stores y as
// bf16 rows and adds the tile's column sums of the f32 accumulator: a
// thread's two rows, the 8 lanes of a column (a reduce-scatter of
// shuffles), then the 8 warps in a fixed order. Rows past N come in as
// TMA zeros and add nothing. No float atomics: each block writes the sums
// of its 128 rows to a (row blocks, 2, C) buffer and stats_reduce_kernel
// adds the row blocks in order, so two runs agree bit for bit.

#include "mm_sm90.cuh"
#include "vec8_sums.cuh"  // stats_reduce_kernel

namespace {

// block (x, y) owns rows [128 y, +128) and columns [64 NB x, +64 NB):
// y (n, c) bf16 and part[y] (2, c) f32, the sums of its rows
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
mm_stats_sm90(const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_w,
              __nv_bfloat16* __restrict__ y, float* __restrict__ part, int n,
              int k, int c) {
  using L = MmTile<NB>;
  extern __shared__ uint8_t smem_raw[];
  const sm90::Smem sm = sm90::aligned_smem(smem_raw);
  const typename L::Ring ring(sm.base, L::STAGE);
  ring.init(kConsumers / 32);

  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * L::kWidth;
  const int steps = (k + kBK - 1) / kBK;
  if (threadIdx.x >= kConsumers) {
    mm_produce<NB>(sm, ring, &tm_a, &tm_w, row0, col0, steps);
    return;
  }
  sm90::setmaxnreg_inc<kConsumerRegs>();
  float acc[32 * NB];
  mm_consume<NB>(acc, sm, ring, steps);

  // both warpgroups are done with the ring, and every stage issued was
  // waited for, so no copy still lands in it
  sm90::named_sync(1, kConsumers);
  sm90::store_rows<NB>(acc, [](float v, int) { return v; }, sm.ptr, y, row0,
                       col0, n, c);

  // the column sums of the block's 128 rows: each thread adds its two
  // rows, lane_sums8 the 8 lanes of each column of a 64-column group;
  // lane (g, q) then holds columns 64 b + 8 g + 2 q (+1)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) + (lane >> 4);
  float* red = reinterpret_cast<float*>(sm.ptr + L::RED);
  float* wred = red + (tid >> 5) * 2 * L::kWidth;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float s[16], s2[16];  // entry 2 i + e: chunk 8 b + i, column e
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo = acc[32 * b + 4 * i + e];
        const float hi = acc[32 * b + 4 * i + 2 + e];
        s[2 * i + e] = lo + hi;
        s2[2 * i + e] = lo * lo + hi * hi;
      }
    lane_sums8(s, lane);
    lane_sums8(s2, lane);
    const int col = 64 * b + 8 * g + 2 * (lane & 3);
    *reinterpret_cast<float2*>(wred + col) = make_float2(s[0], s[1]);
    *reinterpret_cast<float2*>(wred + L::kWidth + col) =
        make_float2(s2[0], s2[1]);
  }
  sm90::named_sync(1, kConsumers);
  for (int u = tid; u < 2 * L::kWidth; u += kConsumers) {
    const int col = u % L::kWidth;  // u / kWidth: 0 the sums, 1 the squares
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers / 32; ++w) t += red[w * 2 * L::kWidth + u];
    if (col0 + col < c)
      part[((size_t)blockIdx.y * 2 + u / L::kWidth) * c + col0 + col] = t;
  }
}

template <int NB>
cudaError_t launch_stats(const CUtensorMap& tm_a, const CUtensorMap& tm_w,
                         void* y, void* part, int n, int k, int c,
                         cudaStream_t s) {
  using L = MmTile<NB>;
  cudaError_t err = sm90::allow_smem(mm_stats_sm90<NB>, L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((c + L::kWidth - 1) / L::kWidth, (n + kRows - 1) / kRows);
  mm_stats_sm90<NB><<<grid, kThreads, L::SMEM, s>>>(
      tm_a, tm_w, static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      n, k, c);
  return cudaGetLastError();
}

}  // namespace

// y (n, c) bf16 and stats (2, c) f32 [sum, sum of squares] from a (n, k)
// and w (k, c) bf16; part is scratch of (ceil(n / 128), 2, c) f32; nb (1,
// 2 or 4) sets the column tile, 64 nb wide.
extern "C" int ieee_mm_stats_bf16(const void* a, const void* w, void* y,
                                  void* stats, void* part, int n, int k,
                                  int c, int nb, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (k <= 0 || (nb != 1 && nb != 2 && nb != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_a, tm_w;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map_2d(&tm_a, a, bf, 2, n, k, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_w, w, bf, 2, k, c, kBK, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = nb == 4   ? &launch_stats<4>
                : nb == 2 ? &launch_stats<2>
                          : &launch_stats<1>;
  cudaError_t err = launch(tm_a, tm_w, y, part, n, k, c, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n + kRows - 1) / kRows;
  stats_reduce_kernel<<<(2 * c + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(stats), row_blocks,
      c);
  return static_cast<int>(cudaGetLastError());
}
