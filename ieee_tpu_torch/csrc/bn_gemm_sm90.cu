// Matrix products whose operands pass through a BatchNorm transform, with
// the transform built in registers (or in shared memory) on their way to the
// tensor cores.
//
// Replaces:
//   tools/fusion_probe.py `pallas_bn_mm` (:129, body `bn_mm_kernel`):
//       o = bf16(h @ W2), h = bf16(relu(y * inv + sh)) with y (N, K) bf16,
//       inv and sh (K,) f32, W2 (K, C) bf16, f32 accumulation;
//   ieee_tpu/ops/pallas/block_bwd.py `_bn3_apply` (:332, body
//       `_k_bn3_apply`): da3 = bn3_bwd(d3); dW3 = h2^T da3 (f32) with
//       h2 = relu(a2 * inv2 + shift2); d2 = (da3 W3^T) * [h2 > 0] (bf16);
//       S21 = sum d2, S22 = sum d2 * xhat2 (f32).
// The block backward's rows (block_bwd.cu states them): d3, a3 (N, c) and
// a2 (N, cm) bf16, v3 (5, c) = [inv, mean, rstd, S1/N, S2/N] and v2f (4, cm)
// = [inv, shift, mean, rstd] f32, W3 (cm, c) bf16:
//   da3 = bf16(inv * ((d3 - S1/N) - ((a3 - mean) * rstd) * S2/N))
//   h2 = relu(a2 * inv2 + shift2), the mask [h2 > 0] from the f32 value.
// Every transform rounds where the plain PyTorch versions do (explicit
// round-to-nearest operations, no FMA contraction), so h, da3 and the masks
// agree with them bit for bit; only the f32 sums differ in order.
//
// What bounds them on an H100: bn_mm at the probe's 16384 x 2048 x 2048
// does 137 GFLOP over 0.15 GB, the tensor cores (0.139 ms at 989 TFLOP/s).
// bn3_apply moves about 4 N (c + cm) bytes for 4 N c cm flops, 2/3 cm flop
// per byte at c = 4 cm: bytes (1.44 ms over the 30 blocks of a batch-128
// step, against 0.52 ms of flops).
//
// Design (Hopper, sm_90a; building blocks in sm90_gemm.cuh, the shape of
// mm_bn_bwd.cu's pair): a block is a producer warpgroup (one thread issues
// TMA into a ring of 128-byte-swizzled stages counted in by mbarriers) and
// two consumer warpgroups that build the transformed operand and run wgmma
// with f32 accumulators in registers; a consumer warp releases a stage once
// its warpgroup's wgmmas on it have completed. The reduction walks in steps
// of 64 (one 128-byte row of bf16).
//   - bn_mm: a block owns 128 rows x 256 columns of o. h is built per k16
//     step from ldmatrix'd y fragments and the stage's [inv, sh] rows (their
//     own TMA box) and fed to wgmma m64n256k16 as its register A operand;
//     W2 (K, C) is read as stored, an MN-major B (four 64-column boxes).
//     The epilogue rounds to bf16 into shared memory and stores 16-byte
//     rows.
//   - bn3_apply, two launches (d3 and a3 are read twice; see PERF.md): a
//     single pass would have to hold either dW3 (c x cm f32) or d2's partial
//     sums over c for every row of its range, far beyond a block's
//     registers at layer2-3.
//       bn3_d2: d2 = (da3 W3^T) * [h2 > 0], mm_bn_da's shape with n = the
//       cm tile (64, 128 or 256 wide: NB wgmma m64n64k16 per k16 step): da3
//       built in registers from d3, a3 and the stage's v3 rows, W3 (cm, c)
//       K-major as stored. Blocks are persistent over 128-row tiles, so one
//       tile's epilogue overlaps the next tile's loads. The epilogue masks
//       by h2 (from a2 and v2f), stores bf16 d2 and adds the tile's
//       channel sums (a shuffle tree over rows, then the 8 warps in order)
//       to the block's, which it writes to spart at the end;
//       stats_reduce_kernel adds the blocks' in order.
//       bn3_dw: dW3^T (c, cm) = da3^T h2 over split row ranges, mm_bn_dw's
//       shape: da3^T from ldmatrix.trans'd d3/a3 fragments (each thread's
//       two channels fixed, their v3 rows in registers); h2 is a2's TMA'd
//       tile rewritten in place by the consumers (each 16-byte unit's
//       channels from its un-swizzled position; rows past N written as 0),
//       then fence.proxy.async and a named barrier before the wgmma that
//       reads it as an MN-major B. With a tile of at most 128 cm the
//       accumulators are added into f32 totals every 128 rows (the tensor
//       cores' f32 sums drift over long same-signed chains; measured with
//       WMMA at layer1, 4960 rows); at 256 the plan keeps ranges to 1024
//       rows instead. dW3 leaves through shared memory as coalesced rows of
//       (cm, c); split_reduce_kernel adds the ranges' partials in order.
// No float atomics anywhere: two runs agree bit for bit. TMA's zero fill
// covers ragged N, c and cm; K, C, c and cm must be multiples of 8 (the
// wrappers check).

#include <algorithm>

#include "sm90_gemm.cuh"
#include "wmma_tile.cuh"  // stats_reduce_kernel, split_reduce_kernel

namespace {

using sm90::bf16_hi;
using sm90::bf16_lo;
using sm90::desc_sw128;
using sm90::pack_bf16;
using sm90::sw128;

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;  // 128*56 + 256*224 <= 65536
constexpr int kBK = 64;             // reduction step: one 128-byte row
constexpr int kRows = 128;          // rows of a tile (two m64)
constexpr int kPitch = kRows + 4;   // dW epilogue f32 row pitch

__device__ __forceinline__ float relu_bn(float a, float inv, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(a, inv), shift), 0.f);
}

__device__ __forceinline__ float xhat1(float a, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(a, mean), rstd);
}

// da = inv * ((d - s1) - xhat * s2), each operation rounded on its own
__device__ __forceinline__ float bn_bwd1(float d, float a, float inv,
                                         float mean, float rstd, float s1,
                                         float s2) {
  return __fmul_rn(inv, __fsub_rn(__fsub_rn(d, s1),
                                  __fmul_rn(xhat1(a, mean, rstd), s2)));
}

// the dynamic shared memory base aligned up to 1024 bytes (the swizzle's
// atom), as a shared address and a generic pointer
struct Smem {
  uint32_t base;
  uint8_t* ptr;
};

__device__ __forceinline__ Smem aligned_smem(uint8_t* raw_ptr) {
  const uint32_t raw = sm90::smem_u32(raw_ptr);
  const uint32_t base = (raw + 1023u) & ~1023u;
  return {base, raw_ptr + (base - raw)};
}

// ---------------------------------------------------------------------------
// bn_mm: block (blockIdx.y, blockIdx.x) owns rows [128 y, +128) of N and
// columns [256 x, +256) of C; the reduction runs over K
// ---------------------------------------------------------------------------

constexpr int MM_STAGES = 4;
constexpr uint32_t MM_W = 0;      // W2 (64 K rows x 4 x 64 C), MN-major
constexpr uint32_t MM_Y = 32768;  // y (128 N rows x 64 K)
constexpr uint32_t MM_V = 49152;  // [inv, sh] (2 x 64 K) f32
constexpr uint32_t MM_TX = 49152 + 2 * 64 * 4;  // bytes landing per stage
constexpr uint32_t MM_STAGE = 50176;
constexpr int MM_PITCH = 256 + 8;  // epilogue bf16 row pitch (no conflicts)
using MmRing = sm90::Ring<MM_STAGES>;
constexpr int MM_SMEM =
    MM_STAGES * MM_STAGE + MmRing::kBarrierBytes + 1024;
static_assert(kRows * MM_PITCH * 2 <= MM_STAGES * MM_STAGE,
              "the bn_mm epilogue reuses the stage ring");

__global__ void __launch_bounds__(kThreads, 1)
bn_mm_sm90(const __grid_constant__ CUtensorMap tm_y,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_w,
           __nv_bfloat16* __restrict__ out, int n, int k, int c) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const MmRing ring(sm.base, MM_STAGE);
  ring.init(kConsumers / 32);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * 256;
  const int steps = (k + kBK - 1) / kBK;

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int step = 0; step < steps; ++step) {
        const int slot = step % MM_STAGES;
        sm90::mbar_wait(ring.empty_bar(slot), ((step / MM_STAGES) & 1) ^ 1);
        const uint32_t st = sm.base + slot * MM_STAGE;
        const uint32_t bar = ring.full_bar(slot);
        const int k0 = step * kBK;
        sm90::mbar_expect_tx(bar, MM_TX);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)  // W2: four 64-column boxes
          sm90::tma_load_2d(st + MM_W + cc * 8192, &tm_w, bar, col0 + cc * 64,
                            k0);
        sm90::tma_load_2d(st + MM_Y, &tm_y, bar, k0, row0);
        sm90::tma_load_2d(st + MM_V, &tm_v, bar, k0, 0);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // warp of the warpgroup
  const int wg = tid >> 7;
  const int q = lane & 3;
  const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
  const int arow = wg * 64 + warp * 16 + (mi & 1) * 8 + (lane & 7);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a[4][4];
  for (int step = 0; step < steps; ++step) {
    const int slot = step % MM_STAGES;
    sm90::mbar_wait(ring.full_bar(slot), (step / MM_STAGES) & 1);
    const uint32_t st = sm.base + slot * MM_STAGE;
    const float* vs =
        reinterpret_cast<const float*>(sm.ptr + slot * MM_STAGE + MM_V);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // k16 steps
      uint32_t yr[4];
      sm90::ldmatrix_x4(yr, st + MM_Y + sw128(arow, 2 * j + (mi >> 1), 128));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // channels 16j + 2q (+1) for a0, a1 and 8 further for a2, a3
        const int ch = 16 * j + 2 * q + 8 * h;
        const float2 inv = *reinterpret_cast<const float2*>(vs + ch);
        const float2 sh = *reinterpret_cast<const float2*>(vs + 64 + ch);
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // the fragment's row, 8 rows below
          const uint32_t yy = yr[2 * h + r];
          a[j][2 * h + r] = pack_bf16(relu_bn(bf16_lo(yy), inv.x, sh.x),
                                      relu_bn(bf16_hi(yy), inv.y, sh.y));
        }
      }
      sm90::wgmma_fence();
      sm90::wgmma_m64n256k16_rs<1>(
          acc, a[j], desc_sw128(st + MM_W + 2048 * j, 8192, 1024));
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    // this stage's wgmmas are done: release its slot
    if (lane == 0) sm90::mbar_arrive(ring.empty_bar(slot));
  }

  // epilogue: bf16 pairs into a shared (128 x 256) tile, then 16-byte rows
  // of o. Both consumers are done with the ring, and every stage issued was
  // waited for, so no copy still lands in it
  sm90::named_sync(1, kConsumers);
  uint32_t* tile = reinterpret_cast<uint32_t*>(sm.ptr);
  const int tr = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    tile[(tr * MM_PITCH + 8 * i + 2 * q) / 2] =
        pack_bf16(acc[4 * i], acc[4 * i + 1]);
    tile[((tr + 8) * MM_PITCH + 8 * i + 2 * q) / 2] =
        pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
  sm90::named_sync(1, kConsumers);
  for (int u = tid; u < kRows * 32; u += kConsumers) {
    const int r = u >> 5, ch = (u & 31) * 8;
    if (row0 + r < n && col0 + ch < c)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * c + col0 + ch) =
          *reinterpret_cast<const uint4*>(sm.ptr + r * MM_PITCH * 2 + ch * 2);
  }
}

// ---------------------------------------------------------------------------
// bn3_d2: block (x, y) owns columns [64 NB x, +64 NB) of cm and the 128-row
// tiles y, y + gridDim.y, ... of N; the reduction runs over c
// ---------------------------------------------------------------------------

template <int NB>
struct D2 {
  static constexpr int kStages = NB == 4 ? 3 : 4;
  // the epilogue's a2 pairs are loaded into registers as the tile's
  // mainloop starts (its latency hidden behind the mainloop), where the
  // registers allow it; at NB = 4 one 64-column block at a time in the
  // epilogue
  static constexpr bool kPrefetch = NB <= 2;
  static constexpr uint32_t W = 0;           // W3 (64 NB cm rows x 64 c)
  static constexpr uint32_t D = 8192 * NB;   // d3 (128 N rows x 64 c)
  static constexpr uint32_t A = D + 16384;   // a3 (128 N rows x 64 c)
  static constexpr uint32_t V = A + 16384;   // v3 (5 x 64 c) f32
  static constexpr uint32_t TX = V + 5 * 64 * 4;
  static constexpr uint32_t STAGE = V + 2048;
  using Ring = sm90::Ring<kStages>;
  // the tile's channel sums of each warp: [8 warps][2][64 NB] f32
  static constexpr uint32_t RED = kStages * STAGE + Ring::kBarrierBytes;
  // v2f of the block's cm columns: [inv, shift, mean, rstd][64 NB] f32
  static constexpr uint32_t SV = RED + 8 * 2 * 64 * NB * 4;
  static constexpr int SMEM = SV + 4 * 64 * NB * 4 + 1024;
};

// a2 pairs at rows r_lo and r_lo + 8, columns gc + 8i (+1) for i < 8;
// zero outside (n, cm)
__device__ __forceinline__ void load_a2(uint32_t (&av)[8][2],
                                        const __nv_bfloat16* __restrict__ a2,
                                        int r_lo, int gc, int n, int cm) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r_lo + 8 * rr, col = gc + 8 * i;
      av[i][rr] = row < n && col < cm
                      ? __ldg(reinterpret_cast<const unsigned int*>(
                            a2 + (size_t)row * cm + col))
                      : 0u;
    }
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
bn3_d2_sm90(const __grid_constant__ CUtensorMap tm_d3,
            const __grid_constant__ CUtensorMap tm_a3,
            const __grid_constant__ CUtensorMap tm_v3,
            const __grid_constant__ CUtensorMap tm_w3,
            const __nv_bfloat16* __restrict__ a2,
            const float* __restrict__ v2f, __nv_bfloat16* __restrict__ d2,
            float* __restrict__ spart, int n, int c, int cm) {
  using L = D2<NB>;
  constexpr int S = L::kStages;
  constexpr int WIDTH = 64 * NB;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const typename L::Ring ring(sm.base, L::STAGE);
  ring.init(kConsumers / 32);

  const int tid = threadIdx.x;
  const int cm0 = blockIdx.x * WIDTH;
  const int tiles = (n + kRows - 1) / kRows;
  const int steps = (c + kBK - 1) / kBK;

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      int g = 0;  // steps through the ring, over all tiles
      for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
        for (int step = 0; step < steps; ++step, ++g) {
          const int slot = g % S;
          sm90::mbar_wait(ring.empty_bar(slot), ((g / S) & 1) ^ 1);
          const uint32_t st = sm.base + slot * L::STAGE;
          const uint32_t bar = ring.full_bar(slot);
          const int c0 = step * kBK;
          sm90::mbar_expect_tx(bar, L::TX);
          sm90::tma_load_2d(st + L::W, &tm_w3, bar, c0, cm0);
          sm90::tma_load_2d(st + L::D, &tm_d3, bar, c0, t * kRows);
          sm90::tma_load_2d(st + L::A, &tm_a3, bar, c0, t * kRows);
          sm90::tma_load_2d(st + L::V, &tm_v3, bar, c0, 0);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int wg = tid >> 7;
  const int q = lane & 3;
  const int mi = lane >> 3;
  const int arow = wg * 64 + warp * 16 + (mi & 1) * 8 + (lane & 7);
  float* red = reinterpret_cast<float*>(sm.ptr + L::RED);
  float* sv = reinterpret_cast<float*>(sm.ptr + L::SV);
  for (int i = tid; i < 4 * WIDTH; i += kConsumers) {
    const int col = cm0 + i % WIDTH;
    sv[i] = col < cm ? v2f[(size_t)(i / WIDTH) * cm + col] : 0.f;
  }
  // the block's channel sums over its tiles, in tile order: entries tid
  // and tid + 256 of [2][WIDTH]
  constexpr int RUN = (2 * WIDTH + kConsumers - 1) / kConsumers;
  float run[RUN];
#pragma unroll
  for (int k = 0; k < RUN; ++k) run[k] = 0.f;
  sm90::named_sync(1, kConsumers);

  int g = 0;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    float acc[NB][32];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
    // this thread's rows of the tile (the accumulator's lane/4 and 8
    // below) and its a2 pairs there
    const int r_lo = t * kRows + wg * 64 + warp * 16 + (lane >> 2);
    uint32_t av[L::kPrefetch ? NB : 1][8][2];
    if constexpr (L::kPrefetch) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        load_a2(av[b], a2, r_lo, cm0 + 64 * b + 2 * q, n, cm);
    }
    uint32_t a[4][4];
    for (int step = 0; step < steps; ++step, ++g) {
      const int slot = g % S;
      sm90::mbar_wait(ring.full_bar(slot), (g / S) & 1);
      const uint32_t st = sm.base + slot * L::STAGE;
      const float* vs =
          reinterpret_cast<const float*>(sm.ptr + slot * L::STAGE + L::V);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // k16 steps
        const uint32_t off = sw128(arow, 2 * j + (mi >> 1), 128);
        uint32_t dr[4], ar[4];
        sm90::ldmatrix_x4(dr, st + L::D + off);
        sm90::ldmatrix_x4(ar, st + L::A + off);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = 16 * j + 2 * q + 8 * h;
          float2 v[5];  // v[r]: the pair's two values of v3 row r
#pragma unroll
          for (int r = 0; r < 5; ++r)
            v[r] = *reinterpret_cast<const float2*>(vs + r * 64 + ch);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t dd = dr[2 * h + r], aa = ar[2 * h + r];
            a[j][2 * h + r] = pack_bf16(
                bn_bwd1(bf16_lo(dd), bf16_lo(aa), v[0].x, v[1].x, v[2].x,
                        v[3].x, v[4].x),
                bn_bwd1(bf16_hi(dd), bf16_hi(aa), v[0].y, v[1].y, v[2].y,
                        v[3].y, v[4].y));
          }
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int b = 0; b < NB; ++b)  // W3 rows 64b.. of the tile: K-major
          sm90::wgmma_m64n64k16_rs<0>(
              acc[b], a[j],
              desc_sw128(st + L::W + 8192 * b + 32 * j, 16, 1024));
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      // this stage's wgmmas are done: release its slot
      if (lane == 0) sm90::mbar_arrive(ring.empty_bar(slot));
    }

    // epilogue: mask by [h2 > 0], store bf16 d2, and the tile's channel
    // sums: a thread's two rows, then the 8 row lanes of its columns
    // (shuffles), then the 8 warps in order
    const int wid = tid >> 5;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if constexpr (!L::kPrefetch)
        load_a2(av[0], a2, r_lo, cm0 + 64 * b + 2 * q, n, cm);
      const uint32_t(&ab)[8][2] = av[L::kPrefetch ? b : 0];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int lc = 64 * b + 8 * i + 2 * q;  // column in the tile
        const int gc = cm0 + lc;
        // inv, shift, mean, rstd of columns lc, lc + 1
        const float2 inv = *reinterpret_cast<const float2*>(sv + lc);
        const float2 sh = *reinterpret_cast<const float2*>(sv + WIDTH + lc);
        const float2 mean =
            *reinterpret_cast<const float2*>(sv + 2 * WIDTH + lc);
        const float2 rstd =
            *reinterpret_cast<const float2*>(sv + 3 * WIDTH + lc);
        float s[2] = {0.f, 0.f}, sx[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = r_lo + 8 * rr;
          const bool in = row < n && gc < cm;
          const float af[2] = {bf16_lo(ab[i][rr]), bf16_hi(ab[i][rr])};
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = __fadd_rn(__fmul_rn(af[e], e ? inv.y : inv.x),
                                        e ? sh.y : sh.x);
            o[e] = in && pre > 0.f ? acc[b][4 * i + 2 * rr + e] : 0.f;
            s[e] += o[e];
            sx[e] += __fmul_rn(
                o[e], xhat1(af[e], e ? mean.y : mean.x, e ? rstd.y : rstd.x));
          }
          if (in)
            *reinterpret_cast<uint32_t*>(d2 + (size_t)row * cm + gc) =
                pack_bf16(o[0], o[1]);
        }
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[e] += __shfl_xor_sync(0xffffffffu, s[e], m);
            sx[e] += __shfl_xor_sync(0xffffffffu, sx[e], m);
          }
        }
        if (lane < 4) {
          float* rw = red + wid * 2 * WIDTH;
          rw[lc] = s[0];
          rw[lc + 1] = s[1];
          rw[WIDTH + lc] = sx[0];
          rw[WIDTH + lc + 1] = sx[1];
        }
      }
    }
    sm90::named_sync(1, kConsumers);
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const int o = tid + k * kConsumers;
      if (o < 2 * WIDTH) {
        const int which = o / WIDTH, col = o % WIDTH;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += red[(w * 2 + which) * WIDTH + col];
        run[k] += sum;
      }
    }
    sm90::named_sync(1, kConsumers);  // red is the next tile's
  }
  // the block's partial sums: row blockIdx.y of spart
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const int o = tid + k * kConsumers;
    const int which = o / WIDTH, col = o % WIDTH;
    if (o < 2 * WIDTH && cm0 + col < cm)
      spart[((size_t)blockIdx.y * 2 + which) * cm + cm0 + col] = run[k];
  }
}

// ---------------------------------------------------------------------------
// bn3_dw: dW3^T = da3^T @ h2 over rows [z*rows, (z+1)*rows) of N: block
// (x, y, z) owns channels [128 x, +128) of c and columns [64 NB y, +64 NB)
// of cm; an f32 partial of dW3 (cm, c) per z
// ---------------------------------------------------------------------------

// h2 = bf16(relu(a2 * inv2 + shift2)) in place for 16-byte unit u of a
// 128-byte-swizzled stage tile hb of a2 boxes (64 rows x 64 columns each):
// unit u is row r's chunk position p of box b, which holds the box's
// logical chunk p ^ (r % 8). sv: [inv2, shift2] (2, width) of the tile's
// columns. Rows past N read zeros by TMA but would give relu(shift2): they
// are written as 0
__device__ __forceinline__ void h2_unit(uint8_t* hb, int u, int r0, int n,
                                        const float* sv, int width) {
  const int b = u >> 9, r = (u >> 3) & 63, p = u & 7;
  const int lc = 64 * b + 8 * (p ^ (r & 7));
  uint4* ptr = reinterpret_cast<uint4*>(hb + u * 16);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r0 + r < n) {
    const uint4 raw = *ptr;
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const float4 i0 = *reinterpret_cast<const float4*>(sv + lc);
    const float4 i1 = *reinterpret_cast<const float4*>(sv + lc + 4);
    const float4 s0 = *reinterpret_cast<const float4*>(sv + width + lc);
    const float4 s1 = *reinterpret_cast<const float4*>(sv + width + lc + 4);
    const float inv[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
    const float sh[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = pack_bf16(relu_bn(bf16_lo(w[e]), inv[2 * e], sh[2 * e]),
                       relu_bn(bf16_hi(w[e]), inv[2 * e + 1], sh[2 * e + 1]));
    v = make_uint4(o[0], o[1], o[2], o[3]);
  }
  *ptr = v;
}

template <int NB>
struct Dw {
  static constexpr int kStages = NB == 4 ? 3 : 4;
  static constexpr bool kFlush = NB <= 2;  // registers for f32 totals
  static constexpr uint32_t D = 0;      // d3 (2 x 64 c) x 64 N rows
  static constexpr uint32_t A = 16384;  // a3 (2 x 64 c) x 64 N rows
  static constexpr uint32_t H = 32768;  // a2 -> h2 (NB x 64 cm) x 64 rows
  static constexpr uint32_t STAGE = H + 8192 * NB;  // all of it lands by TMA
  using Ring = sm90::Ring<kStages>;
  // [inv2, shift2] of the block's cm columns: (2, 64 NB) f32
  static constexpr uint32_t SV = kStages * STAGE + Ring::kBarrierBytes;
  static constexpr int SMEM = SV + 2 * 64 * NB * 4 + 1024;
  static_assert(64 * NB * kPitch * 4 <= kStages * STAGE,
                "the dW epilogue reuses the stage ring");
};

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
bn3_dw_sm90(const __grid_constant__ CUtensorMap tm_d3,
            const __grid_constant__ CUtensorMap tm_a3,
            const __grid_constant__ CUtensorMap tm_a2,
            const float* __restrict__ v3, const float* __restrict__ v2f,
            float* __restrict__ part, int n, int c, int cm, int rows) {
  using L = Dw<NB>;
  constexpr int S = L::kStages;
  constexpr int WIDTH = 64 * NB;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const typename L::Ring ring(sm.base, L::STAGE);
  ring.init(kConsumers / 32);

  const int tid = threadIdx.x;
  const int ch0 = blockIdx.x * kRows;
  const int cm0 = blockIdx.y * WIDTH;
  const int n_begin = blockIdx.z * rows;
  const int steps = (min(n, n_begin + rows) - n_begin + kBK - 1) / kBK;

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int step = 0; step < steps; ++step) {
        const int slot = step % S;
        sm90::mbar_wait(ring.empty_bar(slot), ((step / S) & 1) ^ 1);
        const uint32_t st = sm.base + slot * L::STAGE;
        const uint32_t bar = ring.full_bar(slot);
        const int r0 = n_begin + step * kBK;
        sm90::mbar_expect_tx(bar, L::STAGE);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // d3, a3: two 64-channel boxes
          sm90::tma_load_2d(st + L::D + h * 8192, &tm_d3, bar, ch0 + h * 64,
                            r0);
          sm90::tma_load_2d(st + L::A + h * 8192, &tm_a3, bar, ch0 + h * 64,
                            r0);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b)  // a2: NB 64-column boxes
          sm90::tma_load_2d(st + L::H + b * 8192, &tm_a2, bar, cm0 + b * 64,
                            r0);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int wg = tid >> 7;
  const int mi = lane >> 3;
  // this thread's two channels (fragment rows lane/4 and 8 below) are
  // fixed: their five v3 values in registers
  const int cha = ch0 + wg * 64 + warp * 16 + (lane >> 2);
  float va[5], vb[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    va[i] = cha < c ? v3[(size_t)i * c + cha] : 0.f;
    vb[i] = cha + 8 < c ? v3[(size_t)i * c + cha + 8] : 0.f;
  }
  float* sv = reinterpret_cast<float*>(sm.ptr + L::SV);
  for (int i = tid; i < WIDTH; i += kConsumers) {
    const bool in = cm0 + i < cm;
    sv[i] = in ? v2f[cm0 + i] : 0.f;
    sv[WIDTH + i] = in ? v2f[cm + cm0 + i] : 0.f;
  }
  sm90::named_sync(1, kConsumers);
  // ldmatrix.trans: lanes 8m..8m+7 address rows (m >> 1)*8 + 0..7 of the
  // k16 step at channels (m & 1)*8 of this warp's 16; the tile holds its
  // 128 channels as two 64-channel boxes
  const int lchunk = (wg * 64 + warp * 16 + (mi & 1) * 8) >> 3;
  const uint32_t lbox = (lchunk >> 3) * 8192;

  // acc: the wgmma accumulators; tot: their f32 totals (with kFlush)
  float acc[NB][32], tot[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = tot[b][i] = 0.f;
  uint32_t af[4][4];
  for (int step = 0; step < steps; ++step) {
    const int slot = step % S;
    sm90::mbar_wait(ring.full_bar(slot), (step / S) & 1);
    const uint32_t st = sm.base + slot * L::STAGE;
    // h2 in place, 2 NB units a thread
    uint8_t* hb = sm.ptr + slot * L::STAGE + L::H;
#pragma unroll
    for (int it = 0; it < 2 * NB; ++it)
      h2_unit(hb, tid + it * kConsumers, n_begin + step * kBK, n, sv, WIDTH);
    // the generic-proxy writes before wgmma's async-proxy reads, and both
    // warpgroups' halves of the tile before either reads it
    sm90::fence_proxy_async();
    sm90::named_sync(1, kConsumers);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * j + (mi >> 1) * 8 + (lane & 7);
      const uint32_t off = lbox + sw128(r, lchunk & 7, 128);
      uint32_t dr[4], ar[4];
      sm90::ldmatrix_x4_trans(dr, st + L::D + off);
      sm90::ldmatrix_x4_trans(ar, st + L::A + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0, a2: channel cha; a1, a3: +8
        const float* v = (i & 1) ? vb : va;
        af[j][i] = pack_bf16(
            bn_bwd1(bf16_lo(dr[i]), bf16_lo(ar[i]), v[0], v[1], v[2], v[3],
                    v[4]),
            bn_bwd1(bf16_hi(dr[i]), bf16_hi(ar[i]), v[0], v[1], v[2], v[3],
                    v[4]));
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int b = 0; b < NB; ++b)  // h2 columns 64b..: MN-major
        sm90::wgmma_m64n64k16_rs<1>(
            acc[b], af[j],
            desc_sw128(st + L::H + 8192 * b + 2048 * j, 8192, 1024));
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    // this stage's wgmmas are done: release its slot
    if (lane == 0) sm90::mbar_arrive(ring.empty_bar(slot));
    if constexpr (L::kFlush) {
      if ((step & 1) || step + 1 == steps) {  // every 128 rows
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            tot[b][i] += acc[b][i];
            acc[b][i] = 0.f;
          }
      }
    }
  }

  // epilogue: dW3^T tile -> shared (64 NB cm rows x 128 channels, f32),
  // then coalesced rows of dW3 (cm, c). Both consumers are done reading the
  // ring, and every stage issued was waited for
  sm90::named_sync(1, kConsumers);
  float* stf = reinterpret_cast<float*>(sm.ptr);
  const int chl = wg * 64 + warp * 16 + (lane >> 2);
  const int q = lane & 3;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 64 * b + 8 * i + 2 * q + e;
        stf[m * kPitch + chl] =
            L::kFlush ? tot[b][4 * i + e] : acc[b][4 * i + e];
        stf[m * kPitch + chl + 8] =
            L::kFlush ? tot[b][4 * i + 2 + e] : acc[b][4 * i + 2 + e];
      }
    }
  }
  sm90::named_sync(1, kConsumers);
  float* dst = part + (size_t)blockIdx.z * cm * c;
  const int gc = ch0 + lane * 4;
  for (int rr = tid >> 5; rr < WIDTH; rr += kConsumers / 32) {
    const int gm = cm0 + rr;
    if (gm < cm && gc < c)
      *reinterpret_cast<float4*>(dst + (size_t)gm * c + gc) =
          *reinterpret_cast<const float4*>(stf + rr * kPitch + lane * 4);
  }
}

template <int NB>
cudaError_t bn3_launch(const void* d3, const void* a3, const void* a2,
                       const void* w3, const void* v3, const void* v2f,
                       void* d2, void* s2, void* dw3, void* spart,
                       void* wpart, int n, int c, int cm, int splits,
                       int rows, cudaStream_t s) {
  constexpr int WIDTH = 64 * NB;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // bn3_d2 reads 128-row tiles, bn3_dw 64-row steps
  CUtensorMap tm_d3t, tm_a3t, tm_v3, tm_w3, tm_d3s, tm_a3s, tm_a2;
  if (!sm90::tensor_map_2d(&tm_d3t, d3, bf, 2, n, c, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_a3t, a3, bf, 2, n, c, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_w3, w3, bf, 2, cm, c, WIDTH, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_v3, v3, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 5,
                           c, 5, kBK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !sm90::tensor_map_2d(&tm_d3s, d3, bf, 2, n, c, kBK, 64, sw) ||
      !sm90::tensor_map_2d(&tm_a3s, a3, bf, 2, n, c, kBK, 64, sw) ||
      !sm90::tensor_map_2d(&tm_a2, a2, bf, 2, n, cm, kBK, 64, sw))
    return cudaErrorInvalidValue;

  // dW3 over the split row ranges (rows a multiple of the 64-row step, so
  // a range's steps end where the next begins), then the partials in order
  auto dw = bn3_dw_sm90<NB>;
  cudaError_t err = sm90::allow_smem(dw, Dw<NB>::SMEM);
  if (err != cudaSuccess) return err;
  float* dst = splits > 1 ? static_cast<float*>(wpart)
                          : static_cast<float*>(dw3);
  const int col_tiles = (cm + WIDTH - 1) / WIDTH;
  dim3 grid_w((c + kRows - 1) / kRows, col_tiles, splits);
  dw<<<grid_w, kThreads, Dw<NB>::SMEM, s>>>(
      tm_d3s, tm_a3s, tm_a2, static_cast<const float*>(v3),
      static_cast<const float*>(v2f), dst, n, c, cm, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const size_t size = (size_t)cm * c;
    split_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(wpart), static_cast<float*>(dw3), splits,
        size);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // d2 and the channel sums of each block's tiles, one block per SM
  // walking the tiles, then the blocks' sums in order
  auto d2k = bn3_d2_sm90<NB>;
  err = sm90::allow_smem(d2k, D2<NB>::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (n + kRows - 1) / kRows;
  dim3 grid_d(col_tiles, std::max(1, std::min(tiles, sms / col_tiles)));
  d2k<<<grid_d, kThreads, D2<NB>::SMEM, s>>>(
      tm_d3t, tm_a3t, tm_v3, tm_w3, static_cast<const __nv_bfloat16*>(a2),
      static_cast<const float*>(v2f), static_cast<__nv_bfloat16*>(d2),
      static_cast<float*>(spart), n, c, cm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<(2 * cm + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(spart), static_cast<float*>(s2), grid_d.y,
      cm);
  return cudaGetLastError();
}

}  // namespace

// o (n, c) bf16 = bf16(relu(y * inv + sh)) @ w2 from y (n, k) bf16, vf
// (2, k) f32 [inv, sh] and w2 (k, c) bf16.
extern "C" int ieee_bn_mm_bf16(const void* y, const void* vf, const void* w2,
                               void* o, int n, int k, int c, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  CUtensorMap tm_y, tm_v, tm_w;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map_2d(&tm_y, y, bf, 2, n, k, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_w, w2, bf, 2, k, c, kBK, 64, sw) ||
      !sm90::tensor_map_2d(&tm_v, vf, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2,
                           k, 2, kBK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = sm90::allow_smem(bn_mm_sm90, MM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((c + 255) / 256, (n + kRows - 1) / kRows);
  bn_mm_sm90<<<grid, kThreads, MM_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tm_y, tm_v, tm_w, static_cast<__nv_bfloat16*>(o), n, k, c);
  return static_cast<int>(cudaGetLastError());
}

// d2 (n, cm) bf16, s2 (2, cm) f32 and dw3 (cm, c) f32 from d3, a3 (n, c)
// and a2 (n, cm) bf16, w3 (cm, c) bf16, v3 (5, c) and v2f (4, cm) f32.
// spart: (ceil(n / 128), 2, cm) f32 (bn3_d2's blocks use a row each);
// wpart: (splits, cm, c) f32, or null with splits == 1; split z reduces
// rows [z*rows, (z+1)*rows), rows a multiple of 64.
extern "C" int ieee_block_bn3_apply(const void* d3, const void* a3,
                                    const void* a2, const void* w3,
                                    const void* v3, const void* v2f, void* d2,
                                    void* s2, void* dw3, void* spart,
                                    void* wpart, int n, int c, int cm,
                                    int splits, int rows, void* stream) {
  if (n <= 0 || c <= 0 || cm <= 0) return 0;
  if (splits < 1 || rows <= 0 || rows % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = cm <= 64    ? &bn3_launch<1>
                : cm <= 128 ? &bn3_launch<2>
                            : &bn3_launch<4>;
  return static_cast<int>(launch(d3, a3, a2, w3, v3, v2f, d2, s2, dw3, spart,
                                 wpart, n, c, cm, splits, rows, s));
}
