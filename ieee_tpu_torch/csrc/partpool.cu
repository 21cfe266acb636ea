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
// product, W is bf16, the product accumulates in f32 and the output is f32
// (the affine's product and sum each rounded on their own, as the plain
// version's two elementwise operations).
//
// What bounds it on an H100: bytes. Each call reads the whole map once
// (100 x 128 x 2048 values, 105 MB as f32) and does 2*(P+1)*C*(HW+F) flops per
// sample, ~0.3 flop/byte: memory-bound by two orders of magnitude.
//
// Design: two kernels behind the one entry point.
//   - The pooling pass runs over the whole card: a block owns one sample
//     and a chunk of 32 16-byte vectors of channels (128 channels of an f32
//     map, 256 of a bf16 one): 1600 blocks at the eval head's call. Its 256
//     threads are 32 channel lanes by 8 position lanes (a warp reads 512
//     contiguous bytes of one position); each thread issues the loads of 8
//     positions (ld.global.nc.L1::no_allocate) before it pools them, rounds
//     each value to bf16 and adds pool[r, i] * x into P+1 f32 sums per
//     channel (fmaf, positions in order), with the weights from shared
//     memory, so overlapping stripes cost nothing extra. The position lanes
//     are added in order through shared memory, and the P+1 pooled rows of
//     the sample are rounded to bf16 into a (B (P+1), C) scratch (2.9 MB at
//     B = 100: it stays in L2 for the product). Measured on an H100 in
//     paired runs (PERF.md §6): 8 positions in flight 0.0402-0.0413
//     device ms at the head's call, 4 0.0413-0.0425; 16 x 16 and 8 x 32
//     lanes, and plain loads, slower.
//   - The projection is a wgmma product on mm_sm90.cuh's SS-form mainloop
//     (TMA ring, producer and two consumer warpgroups, 128-row tiles) with an
//     f32 epilogue relu(acc * s + t) written straight from the accumulators:
//     M = B (P+1) = 700, K = C = 2048, N = F = 768 at the head's call; the
//     wrapper's column tile (matmul_bn.py `_mm_plan`) is 64 wide there, 72
//     blocks. TMA's zero fill covers ragged M and F; C and F must be
//     multiples of 8 (16-byte strides; the wrapper checks).

#include "mm_sm90.cuh"
#include "vec8_sums.cuh"  // load_stream, unpack8

namespace {

constexpr int kPoolLanes = 32;     // channel lanes: a 16-byte vector each
constexpr int kPositionLanes = 8;  // position lanes
constexpr int kPoolThreads = kPoolLanes * kPositionLanes;
constexpr int kPositionsInFlight = 8;  // positions a thread loads at once

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the channels of one 16-byte vector of the map, rounded to bf16, as f32
template <typename T>
struct MapVec;

template <>
struct MapVec<float> {
  static constexpr int kChannels = 4;
  __device__ static void unpack(const uint4& v, float (&f)[4]) {
    f[0] = round_bf16(__uint_as_float(v.x));
    f[1] = round_bf16(__uint_as_float(v.y));
    f[2] = round_bf16(__uint_as_float(v.z));
    f[3] = round_bf16(__uint_as_float(v.w));
  }
};

template <>
struct MapVec<__nv_bfloat16> {
  static constexpr int kChannels = 8;
  __device__ static void unpack(const uint4& v, float (&f)[8]) {
    unpack8(v, f);
  }
};

// block (chunk, sample): pooled[sample (P+1) + r, chunk channels] =
// bf16(sum_i pool[r, i] * bf16(x[sample, i, channel])) for the R = P+1 rows
template <typename T, int R>
__global__ void __launch_bounds__(kPoolThreads)
pool_kernel(const T* __restrict__ x, const float* __restrict__ pool,
            __nv_bfloat16* __restrict__ pooled, int hw, int c, int chunks) {
  using Vec = MapVec<T>;
  constexpr int V = Vec::kChannels;
  constexpr int kChunk = kPoolLanes * V;  // channels of a block
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                             // [position lane][kChunk]
  float* pool_s = smem + kPositionLanes * kChunk;  // [R][hw]
  const int lane = threadIdx.x % kPoolLanes;
  const int pl = threadIdx.x / kPoolLanes;
  const int chunk = blockIdx.x % chunks;
  const int b = blockIdx.x / chunks;
  const int c0 = chunk * kChunk;
  const int gc = c0 + lane * V;

  for (int i = threadIdx.x; i < R * hw; i += kPoolThreads) pool_s[i] = pool[i];
  __syncthreads();

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  if (gc < c) {
    const T* xb = x + (size_t)b * hw * c + gc;
    for (int i0 = pl; i0 < hw; i0 += kPositionLanes * kPositionsInFlight) {
      uint4 v[kPositionsInFlight];
#pragma unroll
      for (int u = 0; u < kPositionsInFlight; ++u) {
        const int i = i0 + u * kPositionLanes;
        if (i < hw) v[u] = load_stream(xb + (size_t)i * c);
      }
#pragma unroll
      for (int u = 0; u < kPositionsInFlight; ++u) {
        const int i = i0 + u * kPositionLanes;
        if (i < hw) {
          float f[V];
          Vec::unpack(v[u], f);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float w = pool_s[r * hw + i];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r][e] = fmaf(w, f[e], acc[r][e]);
          }
        }
      }
    }
  }
  // each pooled row: the position lanes added in order, rounded to bf16
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(red + pl * kChunk + lane * V + e) =
          make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
    __syncthreads();
    for (int col = threadIdx.x; col < kChunk; col += kPoolThreads) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kPositionLanes; ++q) t += red[q * kChunk + col];
      if (c0 + col < c)
        pooled[((size_t)b * R + r) * c + c0 + col] = __float2bfloat16(t);
    }
    __syncthreads();
  }
}

// block (x, y) owns rows [128 y, +128) and columns [64 NB x, +64 NB) of
// out (m, f) f32 = relu((pooled @ w) * s + t)
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
project_sm90(const __grid_constant__ CUtensorMap tm_a,
             const __grid_constant__ CUtensorMap tm_w,
             const float* __restrict__ s, const float* __restrict__ t,
             float* __restrict__ out, int m, int k, int f) {
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
  // s and t of the block's columns (0 past f), read in the epilogue after
  // the barrier that follows the mainloop
  float* sv = reinterpret_cast<float*>(sm.ptr + L::SV);
  for (int i = threadIdx.x; i < 2 * L::kWidth; i += kConsumers) {
    const int col = col0 + i % L::kWidth;
    sv[i] = col < f ? (i < L::kWidth ? s : t)[col] : 0.f;
  }
  float acc[32 * NB];
  mm_consume<NB>(acc, sm, ring, steps);
  sm90::named_sync(1, kConsumers);

  // the accumulator's rows of this thread (lane / 4 and 8 below) and its
  // column pair of each 8-column chunk; f % 8 == 0, so a pair inside f is
  // whole
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = row0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 8 * NB; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    if (col0 + col >= f) continue;
    const float s0 = sv[col], s1 = sv[col + 1];
    const float t0 = sv[L::kWidth + col], t1 = sv[L::kWidth + col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < m)
        *reinterpret_cast<float2*>(out + (size_t)row * f + col0 + col) =
            make_float2(
                fmaxf(__fadd_rn(__fmul_rn(acc[4 * i + 2 * h], s0), t0), 0.f),
                fmaxf(__fadd_rn(__fmul_rn(acc[4 * i + 2 * h + 1], s1), t1),
                      0.f));
    }
  }
}

template <typename T, int R>
cudaError_t launch_pool(const void* x, const void* pool, void* pooled, int b,
                        int hw, int c, cudaStream_t st) {
  constexpr int kChunk = kPoolLanes * MapVec<T>::kChannels;
  const int chunks = (c + kChunk - 1) / kChunk;
  const int smem = static_cast<int>(sizeof(float)) *
                   (kPositionLanes * kChunk + R * hw);
  auto kern = pool_kernel<T, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)b * chunks, kPoolThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(pool),
      static_cast<__nv_bfloat16*>(pooled), hw, c, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int rows, const void* x, const void* pool,
                          void* pooled, int b, int hw, int c,
                          cudaStream_t st) {
  switch (rows) {
#define IEEE_PARTPOOL_ROWS(R) \
  case R:                     \
    return launch_pool<T, R>(x, pool, pooled, b, hw, c, st);
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
      return cudaErrorInvalidValue;
  }
}

template <int NB>
cudaError_t launch_project(const CUtensorMap& tm_a, const CUtensorMap& tm_w,
                           const void* s, const void* t, void* out, int m,
                           int k, int f, cudaStream_t st) {
  using L = MmTile<NB>;
  cudaError_t err = sm90::allow_smem(project_sm90<NB>, L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((f + L::kWidth - 1) / L::kWidth, (m + kRows - 1) / kRows);
  project_sm90<NB><<<grid, kThreads, L::SMEM, st>>>(
      tm_a, tm_w, static_cast<const float*>(s), static_cast<const float*>(t),
      static_cast<float*>(out), m, k, f);
  return cudaGetLastError();
}

}  // namespace

// out (b, rows, f) f32 from x (b, hw, c) (x_is_bf16: 1 for a bf16 map, 0
// for an f32 map, rounded to bf16 on load), pool (rows, hw) f32, w (c, f)
// bf16 and s, t (f,) f32; pooled is scratch of (b rows, c) bf16; nb (1, 2
// or 4) sets the product's column tile, 64 nb wide.
extern "C" int ieee_partpool(const void* x, int x_is_bf16, const void* pool,
                             const void* w, const void* s, const void* t,
                             void* pooled, void* out, int b, int rows, int hw,
                             int c, int f, int nb, void* stream) {
  if (b <= 0) return 0;
  if (hw <= 0 || c <= 0 || f <= 0 || (nb != 1 && nb != 2 && nb != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = b * rows;
  CUtensorMap tm_a, tm_w;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map_2d(&tm_a, pooled, bf, 2, m, c, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_w, w, bf, 2, c, f, kBK, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      x_is_bf16 ? dispatch_rows<__nv_bfloat16>(rows, x, pool, pooled, b, hw,
                                               c, st)
                : dispatch_rows<float>(rows, x, pool, pooled, b, hw, c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto launch = nb == 4   ? &launch_project<4>
                : nb == 2 ? &launch_project<2>
                          : &launch_project<1>;
  return static_cast<int>(launch(tm_a, tm_w, s, t, out, m, c, f, st));
}
