// The forward 1x1 conv + BatchNorm products on Hopper: out (N, C) = A (N, K)
// @ W (K, C) with bf16 operands and f32 accumulators in registers. One
// mainloop, two epilogues: mm_bn_train.cu's (y as bf16 and the batch
// statistics of the f32 product) and mm_affine.cu's (the folded BN and an
// optional ReLU before the bf16 store).
//
// What bounds them on an H100: the tensor cores. At the layer4 and CIM
// sites of the 256x128 model (N = B*16*8 rows: 16384 at train batch 128,
// 12800 at eval batch 100; K and C in {512, 1024, 2048}) a product does
// 2*N*K*C flops over 2*(N*K + K*C + N*C) bytes, 300-1000 flop/byte, above
// the bf16 ridge of ~295. The reduce sites (N = 128 and 768 at batch 128)
// are small: launch latency and the 3 MB weight read bound them.
//
// Design (sm_90a; building blocks in sm90_gemm.cuh, the shape of
// bn_gemm_sm90.cu's bn_mm): a block is a producer warpgroup and two
// consumer warpgroups and owns 128 rows x 64 NB columns of the output.
//   - The producer's one thread fills a ring of stages (192 KB: 4, 6 or 8
//     stages at NB = 4, 2, 1) by TMA: per 64-deep k step one 128 x 64 box
//     of A (K-major as stored) and NB 64 x 64 boxes of W (K, C) read as
//     stored, an MN-major B; each stage's full mbarrier counts the bytes in
//     and TMA's zero fill covers ragged N, K and C.
//   - Each consumer warpgroup runs wgmma on its 64 rows of the stage in the
//     SS form (A from its shared tile through a descriptor: no registers or
//     ldmatrix issue slots spent on A), m64n256k16 at NB = 4 and NB
//     m64n64k16 otherwise, with the f32 accumulator in 32 NB registers a
//     thread. One group of wgmmas stays in flight across the steps: a
//     step's stage is released (its empty mbarrier) once the next step's
//     wgmmas are issued and wgmma.wait_group 1 has seen the step's own
//     complete. (A from ldmatrix'd registers, bn_mm's RS loop, was 1-4%
//     slower at the layer4 sites: PERF.md §6.)
//   - The epilogue runs over the drained ring: the bf16 rows go through a
//     shared tile and leave as 16-byte row chunks (sm90::store_rows); the
//     sums (mm_stats) add a thread's two rows, then the 8 lanes of a column
//     by a reduce-scatter of shuffles (each lane ends with one column pair
//     of every 64), then the 8 warps in a fixed order through shared
//     memory.
//   - The wrappers' plan (ops/kernels/matmul_bn.py `_mm_plan`) narrows the
//     column tile (NB = 2 or 1) where 128 x 256 tiles would fill fewer than
//     half the SMs: the reduce sites, the config's batch-8 CIM site.
// K and C must be multiples of 8 (16-byte TMA strides; the wrappers check).
#pragma once

#include "sm90_gemm.cuh"

namespace {

using sm90::desc_sw128;
using sm90::kBK;
using sm90::kConsumerRegs;
using sm90::kConsumers;
using sm90::kProducerRegs;
using sm90::kRows;
using sm90::kThreads;

// the shared memory of a block whose tile is 64 NB columns wide (byte
// offsets from the 1024-aligned base; every TMA box on a 1024-byte boundary)
template <int NB>
struct MmTile {
  static constexpr int kWidth = 64 * NB;
  static constexpr uint32_t A = 0;        // A (128 N rows x 64 K)
  static constexpr uint32_t W = 16384;    // W (64 K rows x NB x 64 C)
  static constexpr uint32_t STAGE = W + 8192 * NB;
  static constexpr int kStages = 196608 / STAGE;
  using Ring = sm90::Ring<kStages>;
  // epilogue, over the drained ring: sm90::store_rows's bf16 tile, then
  // the warps' column sums [8 warps][sum, sum of squares][kWidth] f32
  static constexpr uint32_t RED = kRows * sm90::rows_pitch(NB) * 2;
  // mm_affine's inv and shift of the block's columns ([2][kWidth] f32),
  // loaded before the mainloop: past the ring and its barriers
  static constexpr uint32_t SV = kStages * STAGE + Ring::kBarrierBytes;
  static constexpr int SMEM = SV + 2 * kWidth * 4 + 1024;
  static_assert(RED + 8 * 2 * kWidth * 4 <= kStages * STAGE,
                "the epilogue reuses the stage ring");
};

// the producer warpgroup: its first thread TMAs every k step's A box
// (rows [row0, +128)) and W boxes (columns [col0, +64 NB)) into the ring
template <int NB>
__device__ __forceinline__ void mm_produce(
    const sm90::Smem& sm, const typename MmTile<NB>::Ring& ring,
    const CUtensorMap* tm_a, const CUtensorMap* tm_w, int row0, int col0,
    int steps) {
  using L = MmTile<NB>;
  constexpr int S = L::kStages;
  sm90::setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x != kConsumers) return;
  for (int step = 0; step < steps; ++step) {
    const int slot = step % S;
    // the consumers have released the slot's previous fill (the first
    // round passes: the parity of the phase before the first)
    sm90::mbar_wait(ring.empty_bar(slot), ((step / S) & 1) ^ 1);
    const uint32_t st = sm.base + slot * L::STAGE;
    const uint32_t bar = ring.full_bar(slot);
    const int k0 = step * kBK;
    sm90::mbar_expect_tx(bar, L::STAGE);
    sm90::tma_load_2d(st + L::A, tm_a, bar, k0, row0);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      sm90::tma_load_2d(st + L::W + 8192 * b, tm_w, bar, col0 + 64 * b, k0);
  }
}

// keeps the compiler from moving reads of acc above the wgmma wait that
// completes it (the asynchronous writes are invisible to it)
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// the consumers' mainloop: acc = the warpgroup's 64 rows x 64 NB columns
// of A @ W, in m64n(64 NB)'s accumulator layout (sm90_gemm.cuh)
template <int NB>
__device__ __forceinline__ void mm_consume(
    float (&acc)[32 * NB], const sm90::Smem& sm,
    const typename MmTile<NB>::Ring& ring, int steps) {
  using L = MmTile<NB>;
  constexpr int S = L::kStages;
  const int lane = threadIdx.x & 31;
  // this warpgroup's 64 rows of the A tile: 8 atoms of 8 128-byte rows
  const uint32_t a_off = L::A + (threadIdx.x >> 7) * 8192;
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int slot = step % S;
    sm90::mbar_wait(ring.full_bar(slot), (step / S) & 1);
    const uint32_t st = sm.base + slot * L::STAGE;
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // k16 steps: 32 bytes along A's rows,
      // 16 rows of W's boxes
      const uint64_t da = desc_sw128(st + a_off + 32 * j, 16, 1024);
      if constexpr (NB == 4) {
        sm90::wgmma_m64n256k16_ss<1>(
            acc, da, desc_sw128(st + L::W + 2048 * j, 8192, 1024));
      } else {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          sm90::wgmma_m64n64k16_ss<1>(
              *reinterpret_cast<float(*)[32]>(acc + 32 * b), da,
              desc_sw128(st + L::W + 8192 * b + 2048 * j, 8192, 1024));
      }
    }
    sm90::wgmma_commit();
    // the step before's wgmmas are done: release its slot
    sm90::wgmma_wait<1>();
    if (step > 0 && lane == 0)
      sm90::mbar_arrive(ring.empty_bar((step + S - 1) % S));
  }
  sm90::wgmma_wait<0>();
  fence_acc(acc);
}

// one round of lane_sums8: lanes `mask` apart add their halves of v[0,
// 2H), the lane with `up` set keeping the upper half, in v[0, H)
template <int H, int N>
__device__ __forceinline__ void half_sums(float (&v)[N], bool up, int mask) {
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const float send = up ? v[m] : v[m + H];
    const float keep = up ? v[m + H] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// sums v over the 8 lanes that share lane % 4 (lane bits 2-4) by a
// reduce-scatter: each of the three shuffle rounds halves the entries a
// lane keeps. At the end v[0, N/8) holds the sums of entries [g N/8,
// (g+1) N/8), g = 4 bit2 + 2 bit3 + bit4 of the lane. Every sum is formed
// by one lane in a fixed order: bit for bit the same in every run.
template <int N>
__device__ __forceinline__ void lane_sums8(float (&v)[N], int lane) {
  half_sums<N / 2>(v, (lane >> 2) & 1, 4);
  half_sums<N / 4>(v, (lane >> 3) & 1, 8);
  half_sums<N / 8>(v, (lane >> 4) & 1, 16);
}

}  // namespace
