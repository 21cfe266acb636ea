// Query x gallery squared-euclidean distance matrix at float32 accuracy, on
// the tensor cores by the 3xTF32 split.
//
// Replaces: ieee_tpu/ops/pallas/distmat.py `euclidean_sq_pallas` (Pallas body
// `_distmat_kernel`): out[i, j] = |q_i|^2 + |g_j|^2 - 2 q_i . g_j with an f32
// product at HIGHEST precision and the norms fused into the same pass.
//
// What bounds it on an H100: arithmetic. The product needs 2*m*n*K flops
// against 4*(m+n)*K + 4*m*n bytes. On f32 FMAs (67 TFLOP/s) 836x836x2304
// takes at least 0.048 ms. The tensor cores run TF32 at 495 TFLOP/s, but a
// TF32 value keeps 10 mantissa bits, and the ranking needs f32 accuracy. So
// each f32 x is split as x = hi + lo, hi = x rounded to TF32 and lo = x - hi
// (exact in f32), and a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b: three TF32
// products (lo_a.lo_b, below 2^-22 of a.b, is dropped), 6*m*n*K flops at
// 495 TFLOP/s: 0.0195 ms at 836x836x2304, 1.50 ms at Market-1501's
// 3368x15913x2304.
//
// Design (sm_90a; building blocks in sm90_gemm.cuh), up to three launches:
//   1. split_kernel: one warp per row of q, then of g. It forms the row's
//      f32 norm by FMAs in a fixed order (lane-strided, then a butterfly)
//      and writes the row's hi and lo into a workspace row [hi (kp) | lo
//      (kp)], kp = K rounded up to 32 with zeros: every row 128-byte aligned
//      for TMA and the 128-byte swizzle, whatever K (K = 19 has 76-byte
//      rows, and TMA needs 16-byte strides).
//   2. distmat_sm90: a producer warpgroup and two consumer warpgroups own a
//      128 x 128 tile of out. The producer's one thread fills a ring of 3
//      stages by TMA: per 32-deep k step, four 128-row x 128-byte boxes (q
//      hi, q lo, g hi, g lo), K-major as stored; TMA's zero fill covers
//      ragged m and n. Each consumer warpgroup runs, on its 64 rows, per k8
//      step three wgmma m64n128k8 tf32 in the SS form into an f32
//      accumulator, smallest terms first: lo.hi, hi.lo, hi.hi. The
//      tensor cores' f32 accumulation may drift over long chains (the
//      block backward's bf16 dW products did over 4960-row chains), so a
//      stage's 12 wgmmas start from zero (scale-d 0) and, once complete,
//      are added into f32 totals in registers, rounded to nearest, before
//      the stage is released.
//   3. Where the output tiles fill fewer than the card's SMs, blockIdx.z
//      splits K into contiguous ranges of steps (ops/kernels/distmat.py
//      `_distmat_plan`); each writes its totals to part[z], and
//      finish_kernel adds the parts in the order z = 0, 1, ... and applies
//      the epilogue. Runs are bit for bit the same.
// The epilogue: out = (qn_i + gn_j) - 2 tot, the plain version's order,
// stored from the accumulator layout (float2 where n is even), masked at
// the ragged edges.

#include <algorithm>

#include "sm90_gemm.cuh"

namespace {

using sm90::desc_sw128;
using sm90::kConsumerRegs;
using sm90::kConsumers;
using sm90::kProducerRegs;
using sm90::kRows;
using sm90::kThreads;

constexpr int kCols = 128;  // columns of an output tile (g rows)
constexpr int kDk = 32;     // k step: one 128-byte row of f32
constexpr int kBox = 16384;  // one 128-row x 128-byte box
// a stage: q hi, q lo, g hi, g lo
constexpr uint32_t QH = 0, QL = kBox, GH = 2 * kBox, GL = 3 * kBox;
constexpr uint32_t STAGE = 4 * kBox;
constexpr int kStages = 3;
using Ring = sm90::Ring<kStages>;
constexpr int SMEM = kStages * STAGE + Ring::kBarrierBytes + 1024;

constexpr int SPLIT_THREADS = 256;

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u & 0xFFFFE000u);
}

// rows [0, m) of q and [m, m+n) of g: ws row r = [hi (kp) | lo (kp)], nrm[r]
// = |row|^2
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const float* __restrict__ q, const float* __restrict__ g,
             float* __restrict__ ws, float* __restrict__ nrm, int m, int n,
             int k, int kp) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (SPLIT_THREADS / 32);
  for (int row = blockIdx.x * (SPLIT_THREADS / 32) + (threadIdx.x >> 5);
       row < m + n; row += warps) {
    const float* src = row < m ? q + (size_t)row * k
                               : g + (size_t)(row - m) * k;
    float* dst = ws + (size_t)row * 2 * kp;
    float s = 0.f;
    for (int e0 = lane; e0 < kp; e0 += 128) {
      float x[4];  // four loads in flight before the stores
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 32 * u;
        x[u] = e < k ? src[e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 32 * u;
        if (e < kp) {
          const float hi = tf32_rna(x[u]);
          dst[e] = hi;
          dst[kp + e] = __fsub_rn(x[u], hi);
          s = fmaf(x[u], x[u], s);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) nrm[row] = s;
  }
}

// (qn + gn) - 2 t, each operation rounded on its own
__device__ __forceinline__ float dist(float qn, float gn, float t) {
  return __fsub_rn(__fadd_rn(qn, gn), __fmul_rn(2.f, t));
}

// block (x, y, z) owns rows [128 x, +128) of q, rows [128 y, +128) of g
// and k steps [chunk z, +chunk) (at most steps - chunk z). With partial,
// it writes its totals to out + z m n; else the distances to out.
__global__ void __launch_bounds__(kThreads, 1)
distmat_sm90(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_g,
             const float* __restrict__ qn, const float* __restrict__ gn,
             float* __restrict__ out, int m, int n, int kp, int chunk,
             int partial) {
  extern __shared__ uint8_t smem_raw[];
  const sm90::Smem sm = sm90::aligned_smem(smem_raw);
  const Ring ring(sm.base, STAGE);
  ring.init(kConsumers / 32);

  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int s0 = blockIdx.z * chunk;
  const int steps = min(chunk, kp / kDk - s0);

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers) return;
    for (int t = 0; t < steps; ++t) {
      const int slot = t % kStages;
      sm90::mbar_wait(ring.empty_bar(slot), ((t / kStages) & 1) ^ 1);
      const uint32_t st = sm.base + slot * STAGE;
      const uint32_t bar = ring.full_bar(slot);
      const int k0 = (s0 + t) * kDk;
      sm90::mbar_expect_tx(bar, STAGE);
      sm90::tma_load_2d(st + QH, &tm_q, bar, k0, row0);
      sm90::tma_load_2d(st + QL, &tm_q, bar, kp + k0, row0);
      sm90::tma_load_2d(st + GH, &tm_g, bar, k0, col0);
      sm90::tma_load_2d(st + GL, &tm_g, bar, kp + k0, col0);
    }
    return;
  }
  sm90::setmaxnreg_inc<kConsumerRegs>();

  const int lane = threadIdx.x & 31;
  // this warpgroup's 64 rows of the q boxes: 8 atoms of 8 128-byte rows
  const uint32_t a_off = (threadIdx.x >> 7) * 8192;
  float tot[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = acc[i] = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int slot = t % kStages;
    sm90::mbar_wait(ring.full_bar(slot), (t / kStages) & 1);
    const uint32_t st = sm.base + slot * STAGE;
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // k8 steps: 32 bytes along the rows
      const uint64_t qh = desc_sw128(st + QH + a_off + 32 * j, 16, 1024);
      const uint64_t ql = desc_sw128(st + QL + a_off + 32 * j, 16, 1024);
      const uint64_t gh = desc_sw128(st + GH + 32 * j, 16, 1024);
      const uint64_t gl = desc_sw128(st + GL + 32 * j, 16, 1024);
      sm90::wgmma_m64n128k8_tf32_ss(acc, ql, gh, j);  // j = 0: a fresh sum
      sm90::wgmma_m64n128k8_tf32_ss(acc, qh, gl, 1);
      sm90::wgmma_m64n128k8_tf32_ss(acc, qh, gh, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
    if (lane == 0) sm90::mbar_arrive(ring.empty_bar(slot));
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
  }

  // the accumulator layout: d[4i], d[4i+1] at (row tr, columns 8i + 2 c4,
  // +1), d[4i+2], d[4i+3] 8 rows below
  const int tr = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                 (lane >> 2);
  const int c4 = lane & 3;
  const bool pairs = (n & 1) == 0;  // float2 stores stay 8-byte aligned
  float* base = out + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + tr + 8 * h;
    if (row >= m) continue;
    const float qv = partial ? 0.f : qn[row];
    float* o = base + (size_t)row * n;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = col0 + 8 * i + 2 * c4;
      if (col >= n) continue;
      float v0 = tot[4 * i + 2 * h], v1 = tot[4 * i + 2 * h + 1];
      if (!partial) {
        v0 = dist(qv, gn[col], v0);
        if (col + 1 < n) v1 = dist(qv, gn[col + 1], v1);
      }
      if (pairs) {
        *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
      } else {
        o[col] = v0;
        if (col + 1 < n) o[col + 1] = v1;
      }
    }
  }
}

// out[i, j] = (qn_i + gn_j) - 2 (part[0] + part[1] + ... ), in that order
__global__ void __launch_bounds__(256)
finish_kernel(const float* __restrict__ part, const float* __restrict__ qn,
              const float* __restrict__ gn, float* __restrict__ out, int m,
              int n, int split) {
  const size_t mn = (size_t)m * n;
  for (size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x; idx < mn;
       idx += (size_t)gridDim.x * 256) {
    float s = part[idx];
    for (int z = 1; z < split; ++z) s = __fadd_rn(s, part[z * mn + idx]);
    out[idx] = dist(qn[idx / n], gn[idx % n], s);
  }
}

}  // namespace

// out (m, n) f32 from q (m, k) and g (n, k) f32. ws: (m + n) x 2 kp f32 and
// nrm: m + n f32, kp = max(32, k rounded up to 32); split parts of chunk k
// steps of 32 each (ops/kernels/distmat.py `_distmat_plan`), and with split
// > 1 part: split x m x n f32 (8-byte aligned where n is even, as out).
// Up to three launches on `stream`.
extern "C" int ieee_distmat_f32(const void* q, const void* g, void* ws,
                                void* nrm, void* part, void* out, int m,
                                int n, int k, int split, int chunk,
                                void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int kp = k <= 0 ? kDk : (k + kDk - 1) / kDk * kDk;
  const int steps = kp / kDk;
  if (split < 1 || chunk < 1 || (split - 1) * chunk >= steps ||
      split * chunk < steps || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the product stores float2 where n is even: refuse an unaligned
  // destination here rather than fault on the card
  float* dst = static_cast<float*>(split > 1 ? part : out);
  if ((n & 1) == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  float* nf = static_cast<float*>(nrm);
  const int rows = m + n;
  split_kernel<<<(rows + SPLIT_THREADS / 32 - 1) / (SPLIT_THREADS / 32),
                 SPLIT_THREADS, 0, st>>>(static_cast<const float*>(q),
                                         static_cast<const float*>(g), wsf,
                                         nf, m, n, k, kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap tm_q, tm_g;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map_2d(&tm_q, wsf, f32, 4, m, 2 * kp, kRows, kDk, sw) ||
      !sm90::tensor_map_2d(&tm_g, wsf + (size_t)m * 2 * kp, f32, 4, n,
                           2 * kp, kCols, kDk, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  err = sm90::allow_smem(distmat_sm90, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + kRows - 1) / kRows, (n + kCols - 1) / kCols, split);
  distmat_sm90<<<grid, kThreads, SMEM, st>>>(tm_q, tm_g, nf, nf + m, dst, m,
                                             n, kp, chunk, split > 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);

  const size_t mn = (size_t)m * n;
  const int blocks = (int)std::min<size_t>((mn + 255) / 256, 65536);
  finish_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), nf,
                                        nf + m, static_cast<float*>(out), m,
                                        n, split);
  return static_cast<int>(cudaGetLastError());
}
