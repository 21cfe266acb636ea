// The block backward's matrix products whose operands pass through a
// BatchNorm backward (and whose other operand may be a recomputed
// relu(bn(.))), on Hopper: two kernel bodies, templated over the product
// they serve (an Op below), shared by `bn3_apply` (bn_gemm_sm90.cu) and by
// `conv2_bwd` and `bn1_apply` (block_bwd_sm90.cu).
//
// The block backward's rows: activations (N, C)
// rows of channels_last maps, N = B*H*W, row r the pixel (y, x) = ((r / W)
// % H, r % W) of image r / (H W). A BN backward reads the cotangent d, the
// pre-BN activation a and five f32 rows v = [inv, mean, rstd, S1/N, S2/N]:
//   da = bf16(inv * ((d - S1/N) - ((a - mean) * rstd) * S2/N))
// and a recomputed h reads a and four rows vf = [inv, shift, mean, rstd]:
//   h = relu(a * inv + shift), the mask [h > 0] from the f32 value.
// Every transform rounds where the plain PyTorch versions do (explicit
// round-to-nearest operations, no FMA contraction), so da, h and the masks
// agree with them bit for bit; only the f32 sums differ in order.
//
// The products (Op: what each of the two bodies computes for it):
//   Bn3Op  rows: d2 = (da3 W3^T) * [h2 > 0], S2; da3 from d3, a3 (N, c),
//               W3 (cm, c); mask and x-hat from a2, v2f.
//          dw:   dW3 (cm, c) = h2^T da3, h2 from a2 (N, cm).
//   Conv2Op rows: d1 = (sum_t shift_t(da2) W2[t]^T) * [h1 > 0], S1: the 3x3
//               SAME input gradient; tap t = 3 ky + kx reads da2 at the
//               pixel (y + 1 - ky, x + 1 - kx), W2 (3, 3, cm_in, cm_out)
//               read as (9 cm, cm) rows t cm + ci; mask from a1, v1f.
//          dw:   dW2[t] (ci, co) = shift_t(h1)^T da2 with h1 at the pixel
//               (y + ky - 1, x + kx - 1).
//          Both read da2 and h1 as bf16 rows that conv2_prep_kernel
//          (block_bwd_sm90.cu) writes once: the nine taps read each row
//          nine times, and rebuilding the BN operands per tap cost more
//          than the one extra pass (PERF.md §6).
//   Bn1Op  rows: dx = bf16(f32(da1 W1^T) + f32(d3)); da1 from d1, a1 (N,
//               cm), W1 (cin, cm).
//          dw:   dW1 (cin, cm) = x^T da1, x (N, cin) as stored.
// A tap that leaves its image reads zero (the JAX kernel's zero-padded
// scratch), and taps never cross into a neighbouring image row or image.
//
// Design (sm_90a; building blocks in sm90_gemm.cuh): a block is a producer
// warpgroup (one thread issues TMA into a ring of 128-byte-swizzled stages
// counted in by mbarriers) and two consumer warpgroups that build the BN
// operand in registers and run wgmma with f32 accumulators in registers; a
// consumer warp releases a stage once its warpgroup's wgmmas on it have
// completed. The reduction walks in steps of 64 (one 128-byte row of bf16).
//   - bn_rows_sm90 (the input-gradient products): a block owns an output
//     column tile (NB wgmma m64n64k16 per k16 step: 64, 128 or 256 wide)
//     and is persistent over 128-row tiles, so one tile's epilogue overlaps
//     the next tile's loads. The reduction runs over kTaps x k channels:
//     for tap t the producer TMAs the d (and a) rows at row + shift_t (TMA
//     zero-fills rows outside [0, N), negative coordinates included) and the
//     B rows t cols + col0 (K-major as stored). da is built from the
//     ldmatrix'd d/a fragments and the stage's v rows (or is d itself, with
//     kPlainA); each fragment row whose tap leaves its image is set to 0
//     (a shifted row inside [0, N) may lie in a neighbouring image row; a
//     9-bit tap mask per row, made once per tile).
//     Epilogues: mask by [h > 0] from a and vf, store bf16, and add the
//     tile's channel sums (a shuffle tree over rows, then the 8 warps in
//     order) to the block's, written to spart at the end and added in block
//     order by stats_reduce_kernel; or add the residual rows (dx).
//   - bn_dw_sm90 (the weight gradients): dW^T tiles = da^T B over split
//     row ranges. da^T comes from ldmatrix.trans'd d/a fragments (each
//     thread's two channels fixed, their v rows in registers; at layer1's
//     cm of 64 the second warpgroup's channels lie past c and read zeros).
//     B is the TMA'd box (for a tap at row + shift_t) as an MN-major
//     operand: for Bn3Op rewritten in place by the consumers as h (each
//     16-byte unit's channels from its un-swizzled position; rows past N
//     written as 0: relu(shift) is not 0), then fence.proxy.async and a
//     named barrier before the wgmma; for Bn1Op and Conv2Op as stored (x,
//     h1). Conv2Op masks the other side instead: the rows (the reduction
//     index) whose tap leaves the image are zeroed in the da2^T fragments,
//     from a bit table of the block's range made once in shared memory.
//     The grid carries the tap: (c tiles, taps x column tiles, ranges).
//     With a tile of at most 128 columns the accumulators are added into
//     f32 totals every 128 rows (the tensor cores' f32 sums drift over long
//     same-signed chains; measured with WMMA at layer1, 4960 rows); at 256
//     the plan keeps ranges to 1024 rows instead. dW leaves through shared
//     memory as coalesced rows; split_reduce_kernel adds the ranges'
//     partials in order.
// No float atomics anywhere: two runs agree bit for bit. TMA's zero fill
// covers ragged N and channel counts, which must be multiples of 8 (the
// wrappers check).
#pragma once

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

// the products the two bodies serve (the header's comment states them)
struct Bn3Op {
  static constexpr int kTaps = 1;
  static constexpr bool kPlainA = false;    // da built from d, a and v
  static constexpr bool kResidual = false;  // rows: mask-and-sums epilogue
  static constexpr bool kBuildB = true;     // dw: B rewritten as h
};
struct Conv2Op {  // da2 and h1 come from conv2_prep_kernel
  static constexpr int kTaps = 9;
  static constexpr bool kPlainA = true;
  static constexpr bool kResidual = false;
  static constexpr bool kBuildB = false;
};
struct Bn1Op {
  static constexpr int kTaps = 1;
  static constexpr bool kPlainA = false;
  static constexpr bool kResidual = true;
  static constexpr bool kBuildB = false;
};

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

// the row offset of tap t = 3 ky + kx: +1 reads the pixel (y + ky - 1,
// x + kx - 1) (dW2's h1), -1 the pixel (y + 1 - ky, x + 1 - kx) (the input
// gradient's da2)
__host__ __device__ __forceinline__ int tap_shift(int t, int w, int sign) {
  return sign * ((t / 3 - 1) * w + (t % 3 - 1));
}

// bit t set where tap t of row r (sign as tap_shift) reads inside the
// image of r, an (h, w) image of rows r = (b h + y) w + x
__device__ __forceinline__ uint32_t tap_mask(int r, int h, int w, int sign) {
  const int q = r / w;
  const int x = r - q * w, y = q % h;
  uint32_t m = 0;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int yy = y + sign * (ky - 1), xx = x + sign * (kx - 1);
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) m |= 1u << (3 * ky + kx);
    }
  return m;
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

__host__ inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

// ---------------------------------------------------------------------------
// bn_rows_sm90: block (x, y) owns columns [64 NB x, +64 NB) of the output
// and the 128-row tiles y, y + gridDim.y, ... of N; the reduction runs over
// kTaps x k
// ---------------------------------------------------------------------------

template <int NB, bool kRes = false>
struct D2 {
  static constexpr int kStages = kRes || NB == 4 ? 3 : 4;
  // the mask's a pairs are loaded into registers as the tile's mainloop
  // starts (its latency hidden behind the mainloop), where the registers
  // allow it; at NB = 4 one 64-column block at a time in the epilogue (the
  // residual has a ring of its own, kRes)
  static constexpr bool kPrefetch = NB <= 2 && !kRes;
  static constexpr uint32_t W = 0;           // B (64 NB rows x 64 k)
  static constexpr uint32_t D = 8192 * NB;   // d (128 N rows x 64 k)
  static constexpr uint32_t A = D + 16384;   // a (128 N rows x 64 k)
  static constexpr uint32_t V = A + 16384;   // v (5 x 64 k) f32
  static constexpr uint32_t TX = V + 5 * 64 * 4;
  static constexpr uint32_t STAGE = V + 2048;
  using Ring = sm90::Ring<kStages>;
  // the tile's channel sums of each warp: [8 warps][2][64 NB] f32
  static constexpr uint32_t RED = kStages * STAGE + Ring::kBarrierBytes;
  // vf of the block's columns: [inv, shift, mean, rstd][64 NB] f32
  static constexpr uint32_t SV = RED + 8 * 2 * 64 * NB * 4;
  // kRes, in place of RED and SV: two slots of a tile's residual rows (128
  // x 64 NB bf16, TMA'd a tile ahead; the epilogue writes the output rows
  // back into them), then their full and empty barriers
  static constexpr uint32_t RES = (RED + 1023) / 1024 * 1024;
  static constexpr uint32_t RES_SLOT = 16384 * NB;
  static constexpr uint32_t RES_BAR = RES + 2 * RES_SLOT;
  static constexpr int SMEM =
      kRes ? RES_BAR + 32 + 1024 : SV + 4 * 64 * NB * 4 + 1024;
};

// bf16 pairs of `e` (row pitch ld) at rows r_lo and r_lo + 8, columns
// gc + 8i (+1) for i < 8; zero outside (n, ld)
__device__ __forceinline__ void load_pairs(uint32_t (&av)[8][2],
                                           const __nv_bfloat16* __restrict__ e,
                                           int r_lo, int gc, int n, int ld) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r_lo + 8 * rr, col = gc + 8 * i;
      av[i][rr] = row < n && col < ld
                      ? __ldg(reinterpret_cast<const unsigned int*>(
                            e + (size_t)row * ld + col))
                      : 0u;
    }
}

// out (n, cols) bf16 from d, a (n, k) through tm_d/tm_a (128-row boxes),
// their v (5, k) (tm_v) and B (kTaps cols, k) (tm_w, 64 NB-row boxes); e:
// the mask's pre-BN rows (n, cols) with vf (4, cols) and spart (gridDim.y,
// 2, cols), or (kResidual) the residual rows (n, cols) through tm_e
// (128 x 64 boxes); (h, w) the images of Conv2Op
template <class Op, int NB>
__global__ void __launch_bounds__(kThreads, 1)
bn_rows_sm90(const __grid_constant__ CUtensorMap tm_d,
             const __grid_constant__ CUtensorMap tm_a,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_w,
             const __grid_constant__ CUtensorMap tm_e,
             const __nv_bfloat16* __restrict__ e,
             const float* __restrict__ vf, __nv_bfloat16* __restrict__ out,
             float* __restrict__ spart, int n, int k, int cols, int h,
             int w) {
  using L = D2<NB, Op::kResidual>;
  constexpr int S = L::kStages;
  constexpr int WIDTH = 64 * NB;
  constexpr int TAPS = Op::kTaps;
  constexpr bool kSums = !Op::kResidual;
  // the bytes a stage brings: B and d (with a and v unless kPlainA)
  constexpr uint32_t TX = Op::kPlainA ? L::A : L::TX;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const typename L::Ring ring(sm.base, L::STAGE);
  // the residual ring's barriers (ring.init fences them with its own)
  [[maybe_unused]] auto res_full = [&](int s) {
    return sm.base + L::RES_BAR + 8 * s;
  };
  [[maybe_unused]] auto res_empty = [&](int s) {
    return sm.base + L::RES_BAR + 16 + 8 * s;
  };
  if constexpr (Op::kResidual) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < 2; ++s) {
        sm90::mbar_init(res_full(s), 1);
        sm90::mbar_init(res_empty(s), kConsumers / 32);
      }
    }
  }
  ring.init(kConsumers / 32);

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * WIDTH;
  const int tiles = (n + kRows - 1) / kRows;
  const int ksteps = (k + kBK - 1) / kBK;

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      int g = 0;  // steps through the ring, over all tiles
      for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
        if constexpr (Op::kResidual) {  // the tile's residual rows
          const int ti = (t - blockIdx.y) / gridDim.y;  // the block's tile
          const int rs = ti & 1;
          sm90::mbar_wait(res_empty(rs), ((ti >> 1) & 1) ^ 1);
          sm90::mbar_expect_tx(res_full(rs), L::RES_SLOT);
#pragma unroll
          for (int b = 0; b < NB; ++b)
            sm90::tma_load_2d(sm.base + L::RES + rs * L::RES_SLOT + b * 16384,
                              &tm_e, res_full(rs), col0 + 64 * b, t * kRows);
        }
        for (int tap = 0; tap < TAPS; ++tap) {
          const int row = t * kRows + (TAPS > 1 ? tap_shift(tap, w, -1) : 0);
          const int wrow = tap * cols + col0;
          for (int ks = 0; ks < ksteps; ++ks, ++g) {
            const int slot = g % S;
            sm90::mbar_wait(ring.empty_bar(slot), ((g / S) & 1) ^ 1);
            const uint32_t st = sm.base + slot * L::STAGE;
            const uint32_t bar = ring.full_bar(slot);
            const int k0 = ks * kBK;
            sm90::mbar_expect_tx(bar, TX);
            sm90::tma_load_2d(st + L::W, &tm_w, bar, k0, wrow);
            sm90::tma_load_2d(st + L::D, &tm_d, bar, k0, row);
            if constexpr (!Op::kPlainA) {
              sm90::tma_load_2d(st + L::A, &tm_a, bar, k0, row);
              sm90::tma_load_2d(st + L::V, &tm_v, bar, k0, 0);
            }
          }
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
  [[maybe_unused]] float* red = reinterpret_cast<float*>(sm.ptr + L::RED);
  [[maybe_unused]] float* sv = reinterpret_cast<float*>(sm.ptr + L::SV);
  // the block's channel sums over its tiles, in tile order: entries tid
  // and tid + 256 of [2][WIDTH]
  constexpr int RUN = (2 * WIDTH + kConsumers - 1) / kConsumers;
  [[maybe_unused]] float run[RUN];
  if constexpr (kSums) {
    for (int i = tid; i < 4 * WIDTH; i += kConsumers) {
      const int col = col0 + i % WIDTH;
      sv[i] = col < cols ? vf[(size_t)(i / WIDTH) * cols + col] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) run[j] = 0.f;
    sm90::named_sync(1, kConsumers);
  }

  int g = 0;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    float acc[NB][32];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
    // this thread's rows of the tile (the accumulator's and the A
    // fragment's lane/4 and 8 below) and its epilogue pairs there
    const int r_lo = t * kRows + wg * 64 + warp * 16 + (lane >> 2);
    [[maybe_unused]] uint32_t av[L::kPrefetch ? NB : 1][8][2];
    if constexpr (L::kPrefetch) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        load_pairs(av[b], e, r_lo, col0 + 64 * b + 2 * q, n, cols);
    }
    // the taps of those two rows that read inside their images
    uint32_t m_lo = 1, m_hi = 1;
    if constexpr (TAPS > 1) {
      m_lo = tap_mask(r_lo, h, w, -1);
      m_hi = tap_mask(r_lo + 8, h, w, -1);
    }
    uint32_t a[4][4];
    for (int tap = 0; tap < TAPS; ++tap) {
      [[maybe_unused]] const bool in_lo = (m_lo >> tap) & 1;
      [[maybe_unused]] const bool in_hi = (m_hi >> tap) & 1;
      for (int ks = 0; ks < ksteps; ++ks, ++g) {
        const int slot = g % S;
        sm90::mbar_wait(ring.full_bar(slot), (g / S) & 1);
        const uint32_t st = sm.base + slot * L::STAGE;
        [[maybe_unused]] const float* vs =
            reinterpret_cast<const float*>(sm.ptr + slot * L::STAGE + L::V);
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // k16 steps
          const uint32_t off = sw128(arow, 2 * j + (mi >> 1), 128);
          uint32_t dr[4];
          sm90::ldmatrix_x4(dr, st + L::D + off);
          if constexpr (Op::kPlainA) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[j][i] = dr[i];
          } else {
            uint32_t ar[4];
            sm90::ldmatrix_x4(ar, st + L::A + off);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int ch = 16 * j + 2 * q + 8 * hh;
              float2 v[5];  // v[r]: the pair's two values of v row r
#pragma unroll
              for (int r = 0; r < 5; ++r)
                v[r] = *reinterpret_cast<const float2*>(vs + r * 64 + ch);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const uint32_t dd = dr[2 * hh + r], aa = ar[2 * hh + r];
                a[j][2 * hh + r] = pack_bf16(
                    bn_bwd1(bf16_lo(dd), bf16_lo(aa), v[0].x, v[1].x, v[2].x,
                            v[3].x, v[4].x),
                    bn_bwd1(bf16_hi(dd), bf16_hi(aa), v[0].y, v[1].y, v[2].y,
                            v[3].y, v[4].y));
              }
            }
          }
          if constexpr (TAPS > 1) {  // rows whose tap leaves the image
            a[j][0] = in_lo ? a[j][0] : 0u;
            a[j][2] = in_lo ? a[j][2] : 0u;
            a[j][1] = in_hi ? a[j][1] : 0u;
            a[j][3] = in_hi ? a[j][3] : 0u;
          }
          sm90::wgmma_fence();
#pragma unroll
          for (int b = 0; b < NB; ++b)  // B rows 64b.. of the tile: K-major
            sm90::wgmma_m64n64k16_rs<0>(
                acc[b], a[j],
                desc_sw128(st + L::W + 8192 * b + 32 * j, 16, 1024));
          sm90::wgmma_commit();
        }
        sm90::wgmma_wait<0>();
        // this stage's wgmmas are done: release its slot
        if (lane == 0) sm90::mbar_arrive(ring.empty_bar(slot));
      }
    }

    if constexpr (Op::kResidual) {
      // epilogue: out = bf16(acc + f32(residual)), the add rounded once,
      // written over the residual's slot; then the warp's 16 rows leave
      // as 16-byte row chunks, and the slot goes back to the producer
      const int ti = (t - blockIdx.y) / gridDim.y;  // the block's tile
      const int rs = ti & 1;
      sm90::mbar_wait(res_full(rs), (ti >> 1) & 1);
      uint8_t* rb = sm.ptr + L::RES + rs * L::RES_SLOT;
      const int rowbase = wg * 64 + warp * 16;  // the warp's rows
      const int lr = rowbase + (lane >> 2);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            uint32_t* p = reinterpret_cast<uint32_t*>(
                rb + b * 16384 + sw128(lr + 8 * rr, i, 128) + 4 * q);
            const uint32_t ev = *p;
            *p = pack_bf16(__fadd_rn(acc[b][4 * i + 2 * rr], bf16_lo(ev)),
                           __fadd_rn(acc[b][4 * i + 2 * rr + 1],
                                     bf16_hi(ev)));
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4 * NB; ++it) {
        const int idx = it * 32 + lane;
        const int b = idx >> 7, r = (idx >> 3) & 15, ch = idx & 7;
        const int row = t * kRows + rowbase + r;
        const int col = col0 + 64 * b + 8 * ch;
        if (row < n && col < cols)
          *reinterpret_cast<uint4*>(out + (size_t)row * cols + col) =
              *reinterpret_cast<const uint4*>(
                  rb + b * 16384 + sw128(rowbase + r, ch, 128));
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(res_empty(rs));
    } else {
      // epilogue: mask by [h > 0], store bf16, and the tile's channel
      // sums: a thread's two rows, then the 8 row lanes of its columns
      // (shuffles), then the 8 warps in order
      const int wid = tid >> 5;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if constexpr (!L::kPrefetch)
          load_pairs(av[0], e, r_lo, col0 + 64 * b + 2 * q, n, cols);
        const uint32_t(&ab)[8][2] = av[L::kPrefetch ? b : 0];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int lc = 64 * b + 8 * i + 2 * q;  // column in the tile
          const int gc = col0 + lc;
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
            const bool in = row < n && gc < cols;
            const float af[2] = {bf16_lo(ab[i][rr]), bf16_hi(ab[i][rr])};
            float o[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float pre = __fadd_rn(__fmul_rn(af[x], x ? inv.y : inv.x),
                                          x ? sh.y : sh.x);
              o[x] = in && pre > 0.f ? acc[b][4 * i + 2 * rr + x] : 0.f;
              s[x] += o[x];
              sx[x] += __fmul_rn(o[x], xhat1(af[x], x ? mean.y : mean.x,
                                             x ? rstd.y : rstd.x));
            }
            if (in)
              *reinterpret_cast<uint32_t*>(out + (size_t)row * cols + gc) =
                  pack_bf16(o[0], o[1]);
          }
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              s[x] += __shfl_xor_sync(0xffffffffu, s[x], m);
              sx[x] += __shfl_xor_sync(0xffffffffu, sx[x], m);
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
      for (int j = 0; j < RUN; ++j) {
        const int o = tid + j * kConsumers;
        if (o < 2 * WIDTH) {
          const int which = o / WIDTH, col = o % WIDTH;
          float sum = 0.f;
#pragma unroll
          for (int wi = 0; wi < 8; ++wi)
            sum += red[(wi * 2 + which) * WIDTH + col];
          run[j] += sum;
        }
      }
      sm90::named_sync(1, kConsumers);  // red is the next tile's
    }
  }
  if constexpr (kSums) {
    // the block's partial sums: row blockIdx.y of spart
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int o = tid + j * kConsumers;
      const int which = o / WIDTH, col = o % WIDTH;
      if (o < 2 * WIDTH && col0 + col < cols)
        spart[((size_t)blockIdx.y * 2 + which) * cols + col0 + col] = run[j];
    }
  }
}

// ---------------------------------------------------------------------------
// bn_dw_sm90: dW^T = da^T @ B over rows [z*rows, (z+1)*rows) of N: block
// (x, y, z) owns channels [128 x, +128) of c (da's) and, for the tap
// y / (column tiles), columns [64 NB (y % column tiles), +64 NB) of cm
// (B's); an f32 partial of dW (kTaps cm, c) per z
// ---------------------------------------------------------------------------

// h = bf16(relu(a * inv + shift)) in place for 16-byte unit u of a
// 128-byte-swizzled stage tile hb of a boxes (64 rows x 64 columns each):
// unit u is row r's chunk position p of box b, which holds the box's
// logical chunk p ^ (r % 8). sv: [inv, shift] (2, width) of the tile's
// columns. Rows past N read zeros by TMA but would give relu(shift): they
// are written as 0
__device__ __forceinline__ void h_unit(uint8_t* hb, int u, int r0, int n,
                                       const float* sv, int width) {
  const int b = u >> 9, r = (u >> 3) & 63, p = u & 7;
  const int lc = 64 * b + 8 * (p ^ (r & 7));
  uint4* ptr = reinterpret_cast<uint4*>(hb + u * 16);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r0 + r < n) {
    const uint4 raw = *ptr;
    const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
    const float4 i0 = *reinterpret_cast<const float4*>(sv + lc);
    const float4 i1 = *reinterpret_cast<const float4*>(sv + lc + 4);
    const float4 s0 = *reinterpret_cast<const float4*>(sv + width + lc);
    const float4 s1 = *reinterpret_cast<const float4*>(sv + width + lc + 4);
    const float inv[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
    const float sh[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    uint32_t o[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      o[x] = pack_bf16(relu_bn(bf16_lo(wd[x]), inv[2 * x], sh[2 * x]),
                       relu_bn(bf16_hi(wd[x]), inv[2 * x + 1], sh[2 * x + 1]));
    v = make_uint4(o[0], o[1], o[2], o[3]);
  }
  *ptr = v;
}

// the two bf16 of a fragment register, rows k and k + 1 of the reduction,
// kept where bits 0 and 1 of `bits` are set
__device__ __forceinline__ uint32_t keep_rows(uint32_t v, uint32_t bits) {
  return v & ((bits & 1u ? 0x0000FFFFu : 0u) | (bits & 2u ? 0xFFFF0000u : 0u));
}

template <int NB>
struct Dw {
  static constexpr int kStages = NB == 4 ? 3 : 4;
  static constexpr bool kFlush = NB <= 2;  // registers for f32 totals
  static constexpr uint32_t D = 0;      // d (2 x 64 c) x 64 N rows
  static constexpr uint32_t A = 16384;  // a (2 x 64 c) x 64 N rows
  static constexpr uint32_t H = 32768;  // B (NB x 64 cm) x 64 rows
  static constexpr uint32_t STAGE = H + 8192 * NB;
  using Ring = sm90::Ring<kStages>;
  // [inv, shift] of the block's cm columns: (2, 64 NB) f32
  static constexpr uint32_t SV = kStages * STAGE + Ring::kBarrierBytes;
  // the tap's row mask (Conv2Op): bit k of word i, row 32 i + k of the
  // block's range
  static constexpr uint32_t VT = SV + 2 * 64 * NB * 4;
  static constexpr int kMaxRows = 32768;  // rows of a range with a mask
  static constexpr int SMEM = VT + kMaxRows / 8 + 1024;
  static_assert(64 * NB * kPitch * 4 <= kStages * STAGE,
                "the dW epilogue reuses the stage ring");
};

// part (kTaps cm, c) f32 of rows [z rows, +rows) from d, a (n, c) through
// tm_d/tm_a (or da itself through tm_d with kPlainA), v (5, c), and B
// (n, cm) through tm_b; vf (2+, cm) [inv, shift] when B is rewritten as h;
// (h, w) the images of Conv2Op
template <class Op, int NB>
__global__ void __launch_bounds__(kThreads, 1)
bn_dw_sm90(const __grid_constant__ CUtensorMap tm_d,
           const __grid_constant__ CUtensorMap tm_a,
           const __grid_constant__ CUtensorMap tm_b,
           const float* __restrict__ v, const float* __restrict__ vf,
           float* __restrict__ part, int n, int c, int cm, int rows, int h,
           int w) {
  using L = Dw<NB>;
  constexpr int S = L::kStages;
  constexpr int WIDTH = 64 * NB;
  constexpr int TAPS = Op::kTaps;
  // the bytes a stage brings: d and a (or da alone) and B
  constexpr uint32_t TX = Op::kPlainA ? L::STAGE - 16384 : L::STAGE;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const typename L::Ring ring(sm.base, L::STAGE);
  ring.init(kConsumers / 32);

  const int tid = threadIdx.x;
  const int ch0 = blockIdx.x * kRows;
  const int col_tiles = (cm + WIDTH - 1) / WIDTH;
  const int tap = TAPS > 1 ? blockIdx.y / col_tiles : 0;
  const int cm0 = (blockIdx.y - tap * col_tiles) * WIDTH;
  const int n_begin = blockIdx.z * rows;
  const int steps = (min(n, n_begin + rows) - n_begin + kBK - 1) / kBK;

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      const int shift = TAPS > 1 ? tap_shift(tap, w, 1) : 0;
      for (int step = 0; step < steps; ++step) {
        const int slot = step % S;
        sm90::mbar_wait(ring.empty_bar(slot), ((step / S) & 1) ^ 1);
        const uint32_t st = sm.base + slot * L::STAGE;
        const uint32_t bar = ring.full_bar(slot);
        const int r0 = n_begin + step * kBK;
        sm90::mbar_expect_tx(bar, TX);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // d, a: two 64-channel boxes
          sm90::tma_load_2d(st + L::D + hh * 8192, &tm_d, bar, ch0 + hh * 64,
                            r0);
          if constexpr (!Op::kPlainA)
            sm90::tma_load_2d(st + L::A + hh * 8192, &tm_a, bar,
                              ch0 + hh * 64, r0);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b)  // B: NB 64-column boxes
          sm90::tma_load_2d(st + L::H + b * 8192, &tm_b, bar, cm0 + b * 64,
                            r0 + shift);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int wg = tid >> 7;
  const int mi = lane >> 3;
  const int q = lane & 3;
  // this thread's two channels (fragment rows lane/4 and 8 below) are
  // fixed: their five v values in registers
  const int cha = ch0 + wg * 64 + warp * 16 + (lane >> 2);
  [[maybe_unused]] float va[5], vb[5];
  if constexpr (!Op::kPlainA) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      va[i] = cha < c ? v[(size_t)i * c + cha] : 0.f;
      vb[i] = cha + 8 < c ? v[(size_t)i * c + cha + 8] : 0.f;
    }
  }
  [[maybe_unused]] float* sv = reinterpret_cast<float*>(sm.ptr + L::SV);
  if constexpr (Op::kBuildB) {
    for (int i = tid; i < WIDTH; i += kConsumers) {
      const bool in = cm0 + i < cm;
      sv[i] = in ? vf[cm0 + i] : 0.f;
      sv[WIDTH + i] = in ? vf[cm + cm0 + i] : 0.f;
    }
  }
  // Conv2Op: the rows of the range whose tap reads inside their image, a
  // bit a row (warp wid takes words wid, wid + 8, ...: each lane a row,
  // moved on by 256 rows a word without a division)
  [[maybe_unused]] const uint32_t* vt =
      reinterpret_cast<const uint32_t*>(sm.ptr + L::VT);
  if constexpr (TAPS > 1) {
    uint32_t* vtw = reinterpret_cast<uint32_t*>(sm.ptr + L::VT);
    const int wid = tid >> 5;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    int row = n_begin + 32 * wid + lane;
    const int qq = row / w;
    int x = row - qq * w, y = qq % h;
    const int sr = 256 % w, sq = (256 / w) % h;
    for (int i = wid; i < 2 * steps; i += 8, row += 256) {
      const int yy = y + dy, xx = x + dx;
      const uint32_t word = __ballot_sync(
          0xffffffffu, row < n && yy >= 0 && yy < h && xx >= 0 && xx < w);
      if (lane == 0) vtw[i] = word;
      x += sr;  // x + 256 % w wraps at most once, y + (256 / w) % h + 1
      const int carry = x >= w;
      x -= carry ? w : 0;
      y += sq + carry;
      y -= y >= h ? h : 0;
    }
  }
  if constexpr (Op::kBuildB || TAPS > 1) sm90::named_sync(1, kConsumers);
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
    if constexpr (Op::kBuildB) {
      // h in place, 2 NB units a thread
      uint8_t* hb = sm.ptr + slot * L::STAGE + L::H;
#pragma unroll
      for (int it = 0; it < 2 * NB; ++it)
        h_unit(hb, tid + it * kConsumers, n_begin + step * kBK, n, sv, WIDTH);
      // the generic-proxy writes before wgmma's async-proxy reads, and both
      // warpgroups' halves of the tile before either reads it
      sm90::fence_proxy_async();
      sm90::named_sync(1, kConsumers);
    }
    {
      // Conv2Op: the stage's 64 row bits; this thread's fragment rows (the
      // reduction index) are 16 j + 2 q (+1) and 8 further
      [[maybe_unused]] uint64_t rbits = 0;
      if constexpr (TAPS > 1)
        rbits = vt[2 * step] | (static_cast<uint64_t>(vt[2 * step + 1]) << 32);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * j + (mi >> 1) * 8 + (lane & 7);
        const uint32_t off = lbox + sw128(r, lchunk & 7, 128);
        uint32_t dr4[4];
        sm90::ldmatrix_x4_trans(dr4, st + L::D + off);
        if constexpr (Op::kPlainA) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[j][i] = dr4[i];
        } else {
          uint32_t ar4[4];
          sm90::ldmatrix_x4_trans(ar4, st + L::A + off);
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // a0, a2: channel cha; a1, a3: +8
            const float* vv = (i & 1) ? vb : va;
            af[j][i] = pack_bf16(
                bn_bwd1(bf16_lo(dr4[i]), bf16_lo(ar4[i]), vv[0], vv[1],
                        vv[2], vv[3], vv[4]),
                bn_bwd1(bf16_hi(dr4[i]), bf16_hi(ar4[i]), vv[0], vv[1],
                        vv[2], vv[3], vv[4]));
          }
        }
        if constexpr (TAPS > 1) {  // rows whose tap leaves the image
          const uint32_t lo = static_cast<uint32_t>(rbits >> (16 * j + 2 * q));
          const uint32_t hi = lo >> 8;
          af[j][0] = keep_rows(af[j][0], lo);
          af[j][1] = keep_rows(af[j][1], lo);
          af[j][2] = keep_rows(af[j][2], hi);
          af[j][3] = keep_rows(af[j][3], hi);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int b = 0; b < NB; ++b)  // B columns 64b..: MN-major
          sm90::wgmma_m64n64k16_rs<1>(
              acc[b], af[j],
              desc_sw128(st + L::H + 8192 * b + 2048 * j, 8192, 1024));
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
    }
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

  // epilogue: the dW^T tile -> shared (64 NB cm rows x 128 channels, f32),
  // then coalesced rows of dW (kTaps cm, c). Both consumers are done
  // reading the ring, and every stage issued was waited for
  sm90::named_sync(1, kConsumers);
  float* stf = reinterpret_cast<float*>(sm.ptr);
  const int chl = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int m = 64 * b + 8 * i + 2 * q + x;
        stf[m * kPitch + chl] =
            L::kFlush ? tot[b][4 * i + x] : acc[b][4 * i + x];
        stf[m * kPitch + chl + 8] =
            L::kFlush ? tot[b][4 * i + 2 + x] : acc[b][4 * i + 2 + x];
      }
    }
  }
  sm90::named_sync(1, kConsumers);
  float* dst = part + ((size_t)blockIdx.z * TAPS + tap) * cm * c;
  const int gc = ch0 + lane * 4;
  for (int rr = tid >> 5; rr < WIDTH; rr += kConsumers / 32) {
    const int gm = cm0 + rr;
    if (gm < cm && gc < c)
      *reinterpret_cast<float4*>(dst + (size_t)gm * c + gc) =
          *reinterpret_cast<const float4*>(stf + rr * kPitch + lane * 4);
  }
}

// ---------------------------------------------------------------------------
// host: one launch of each body (plus its small in-order reduction)
// ---------------------------------------------------------------------------

// dW (kTaps cm, c) f32 = da^T B over `splits` ranges of `rows` rows (a
// multiple of 64, so a range's steps end where the next begins), then the
// partials (wpart: (splits, kTaps cm, c), or null with one split) in order
template <class Op, int NB>
cudaError_t launch_dw(const void* d, const void* a, const void* bmat,
                      const void* v, const void* vf, void* dw, void* wpart,
                      int n, int c, int cm, int splits, int rows, int h,
                      int w, cudaStream_t s) {
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (Op::kTaps > 1 && rows > Dw<NB>::kMaxRows) return cudaErrorInvalidValue;
  // tm_a unused (a copy of tm_d) with kPlainA
  CUtensorMap tm_d, tm_a, tm_b;
  if (!sm90::tensor_map_2d(&tm_d, d, bf, 2, n, c, kBK, 64, sw) ||
      !sm90::tensor_map_2d(&tm_b, bmat, bf, 2, n, cm, kBK, 64, sw))
    return cudaErrorInvalidValue;
  if (Op::kPlainA)
    tm_a = tm_d;
  else if (!sm90::tensor_map_2d(&tm_a, a, bf, 2, n, c, kBK, 64, sw))
    return cudaErrorInvalidValue;
  auto kernel = bn_dw_sm90<Op, NB>;
  cudaError_t err = sm90::allow_smem(kernel, Dw<NB>::SMEM);
  if (err != cudaSuccess) return err;
  float* dst = splits > 1 ? static_cast<float*>(wpart)
                          : static_cast<float*>(dw);
  const int col_tiles = (cm + 64 * NB - 1) / (64 * NB);
  dim3 grid((c + kRows - 1) / kRows, Op::kTaps * col_tiles, splits);
  kernel<<<grid, kThreads, Dw<NB>::SMEM, s>>>(
      tm_d, tm_a, tm_b, static_cast<const float*>(v),
      static_cast<const float*>(vf), dst, n, c, cm, rows, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return err;
  const size_t size = (size_t)Op::kTaps * cm * c;
  split_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(wpart), static_cast<float*>(dw), splits,
      size);
  return cudaGetLastError();
}

// out (n, cols) bf16 from d, a (n, k), v (5, k) and wt (kTaps cols, k);
// with the mask-and-sums epilogue also sums (2, cols) f32 through spart
// ((ceil(n / 128), 2, cols) f32: one row per block); e and vf as
// bn_rows_sm90's. One block per SM walking the row tiles
template <class Op, int NB>
cudaError_t launch_rows(const void* d, const void* a, const void* v,
                        const void* wt, const void* e, const void* vf,
                        void* out, void* sums, void* spart, int n, int k,
                        int cols, int h, int w, cudaStream_t s) {
  constexpr int WIDTH = 64 * NB;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // tm_a and tm_v unused (copies of tm_d) with kPlainA, tm_e but with
  // kResidual
  CUtensorMap tm_d, tm_a, tm_v, tm_w, tm_e;
  if (!sm90::tensor_map_2d(&tm_d, d, bf, 2, n, k, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_w, wt, bf, 2, (uint64_t)Op::kTaps * cols, k,
                           WIDTH, kBK, sw))
    return cudaErrorInvalidValue;
  if (Op::kPlainA) {
    tm_a = tm_v = tm_d;
  } else if (!sm90::tensor_map_2d(&tm_a, a, bf, 2, n, k, kRows, kBK, sw) ||
             !sm90::tensor_map_2d(&tm_v, v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                  4, 5, k, 5, kBK,
                                  CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  if (!Op::kResidual)
    tm_e = tm_d;
  else if (!sm90::tensor_map_2d(&tm_e, e, bf, 2, n, cols, kRows, 64, sw))
    return cudaErrorInvalidValue;
  using L = D2<NB, Op::kResidual>;
  auto kernel = bn_rows_sm90<Op, NB>;
  cudaError_t err = sm90::allow_smem(kernel, L::SMEM);
  if (err != cudaSuccess) return err;
  const int col_tiles = (cols + WIDTH - 1) / WIDTH;
  const int tiles = (n + kRows - 1) / kRows;
  dim3 grid(col_tiles, std::max(1, std::min(tiles, sm_count() / col_tiles)));
  kernel<<<grid, kThreads, L::SMEM, s>>>(
      tm_d, tm_a, tm_v, tm_w, tm_e, static_cast<const __nv_bfloat16*>(e),
      static_cast<const float*>(vf), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(spart), n, k, cols, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || Op::kResidual) return err;
  stats_reduce_kernel<<<(2 * cols + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(spart), static_cast<float*>(sums), grid.y,
      cols);
  return cudaGetLastError();
}

// 64, 128 or 256 columns: a product's output tile at width `cols`
inline int tile_nb(int cols) { return cols <= 64 ? 1 : cols <= 128 ? 2 : 4; }

}  // namespace
