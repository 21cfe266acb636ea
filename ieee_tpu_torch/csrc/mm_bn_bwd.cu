// The two backward products of the train-mode 1x1 conv + BatchNorm, with
// the BN backward recomputed in registers: dA = dy @ W^T and dW = A^T @ dy.
//
// Replaces: ieee_tpu/ops/pallas/matmul_bn.py
//   `_da` (body `_da_kernel`): dA = dy @ W^T, (N, K) bf16;
//   `_dw` (body `_dw_kernel`): dW = A^T @ dy, (K, C) f32.
// dy comes from the incoming cotangent d (N, C) bf16, the stored y (N, C)
// bf16 and six f32 rows vecs = [inv, shift, mean, rstd, S1/N, S2/N] (JAX
// `_dy_tile`):
//   g  = relu ? (y*inv + shift > 0 ? d : 0) : d
//   dy = bf16(inv * ((g - S1/N) - ((y - mean)*rstd) * S2/N))
// with each product and sum rounded on its own (no FMA contraction), as the
// plain PyTorch version (`ops/kernels/matmul_bn.py` `dy_plain`) computes
// it, so dy agrees with it bit for bit. dy never touches device memory.
//
// What bounds them on an H100: the tensor cores. At the layer4 and CIM
// sites of the batch-128 train step (N = 16384 rows, K and C in {512, 1024,
// 2048}) each does 2*N*K*C flops over about 2*(N*K + 2*N*C + K*C) bytes,
// 300-1000 flop/byte, above the bf16 ridge of ~295. The reduce sites (N =
// 128 and 768) are small and bound by launch and weight reads.
//
// Design (Hopper, sm_90a; building blocks in sm90_gemm.cuh): a block of
// three warpgroups owns a 128 x 256 output tile. Two consumer warpgroups
// each hold 64 x 256 of it as one wgmma m64n256k16 accumulator (128 f32
// registers a thread, 224 registers through setmaxnreg); in the third, the
// producer (56 registers), one thread fills a ring of 3 stages in dynamic
// shared memory by TMA (tensor maps built on the host per call; the copy
// engine swizzles the tiles and fills zeros past the edges) and the
// stage's "full" mbarrier counts the bytes in; each consumer warp releases
// a stage on its "empty" mbarrier once its warpgroup's wgmmas on it have
// completed, so two stages load while one is multiplied. The reduction
// walks in steps of 64 (one 128-byte row of bf16). dy is built per k16
// step in registers: the raw d and y fragments come from shared memory by
// ldmatrix, are transformed in f32, rounded to bf16 pairs and fed to wgmma
// as its register A operand; B (W or A) is read by wgmma from its
// 128-byte-swizzled shared tile. A k16 step's transform overlaps the wgmma
// of the step before, and the two consumers run unsynchronised with each
// other. What likely bounds it at the CIM shape: the 64 KB a stage brings
// in from L2 for its 2M multiply-adds (d and y cost 4 bytes per dy
// element). TMA multicast across 2 x 2 clusters would halve that; a version
// with it ran slower on the card (the cluster's four blocks advance in
// lockstep) and was not kept.
//   - dA = dy @ W^T: A operand dy (rows of N x channels, ldmatrix), B
//     operand W as stored (K, C): K-major, the layout wgmma reads natively.
//     The six vecs rows of the stage's 64 channels ride in the stage (its own TMA
//     box). dy is recomputed once per 256-wide K tile.
//   - dW^T = dy^T @ A: A operand dy^T (channels x rows, ldmatrix.trans of
//     the row-major d/y tiles), B operand A as stored (N, K): MN-major. A
//     thread's channels are fixed for the whole loop, so their vecs live
//     in registers. The epilogue writes dW (K, C) transposed through
//     shared memory as coalesced f32 rows. N is split into contiguous
//     ranges of whole 64-row steps (grid z, planned by the wrapper); each
//     range writes an f32 partial and split_reduce_kernel adds them in
//     order. No float atomics anywhere: two runs agree bit for bit.
// Rows past N and columns past K or C read as zeros or are masked, so any
// N runs (the reduce site has N = 8 at batch 8); K and C must be multiples
// of 8 (the wrappers check).

#include "sm90_gemm.cuh"
#include "wmma_tile.cuh"  // split_reduce_kernel

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
constexpr int kStages = 3;
using Ring = sm90::Ring<kStages>;
constexpr int kBK = 64;      // reduction step: one 128-byte row of bf16
constexpr int kTileN = 256;  // wgmma N: output columns of a block
constexpr int kRows = 128;   // output rows of a block (two m64)

// stage layouts (byte offsets; every tile on a 1024-byte boundary)
constexpr uint32_t DA_W = 0;        // W (256 K rows x 64 C), K-major
constexpr uint32_t DA_D = 32768;    // d (128 N rows x 64 C)
constexpr uint32_t DA_Y = 49152;    // y (128 N rows x 64 C)
constexpr uint32_t DA_V = 65536;    // vecs (6 x 64 C) f32
constexpr uint32_t DA_TX = 65536 + 6 * 64 * 4;  // bytes landing per stage
constexpr uint32_t DA_STAGE = 67584;
constexpr uint32_t DW_A = 0;      // A (64 N rows x 4 x 64 K), MN-major
constexpr uint32_t DW_D = 32768;  // d (2 x 64 C) x 64 N rows
constexpr uint32_t DW_Y = 49152;  // y (2 x 64 C) x 64 N rows
constexpr uint32_t DW_TX = 65536;
constexpr uint32_t DW_STAGE = 65536;
constexpr int DW_PITCH = kRows + 4;  // epilogue f32 row pitch (no conflicts)
// the ring, then its mbarriers; + 1024: the dynamic base is
// aligned up to 1024 bytes in the kernel
constexpr int DA_SMEM = kStages * DA_STAGE + Ring::kBarrierBytes + 1024;
constexpr int DW_SMEM = kStages * DW_STAGE + Ring::kBarrierBytes + 1024;
static_assert(kTileN * DW_PITCH * 4 <= kStages * DW_STAGE,
              "the dW epilogue reuses the stage ring");

template <bool RELU>
__device__ __forceinline__ float dy1(float d, float y, float inv,
                                     float shift, float mean, float rstd,
                                     float s1, float s2) {
  float g = d;
  if (RELU) {
    const float pre = __fadd_rn(__fmul_rn(y, inv), shift);
    if (!(pre > 0.f)) g = 0.f;
  }
  const float xhat = __fmul_rn(__fsub_rn(y, mean), rstd);
  const float t = __fsub_rn(__fsub_rn(g, s1), __fmul_rn(xhat, s2));
  return __fmul_rn(inv, t);
}

// ---------------------------------------------------------------------------
// dA = dy @ W^T: block (blockIdx.y, blockIdx.x) owns rows [128 y, +128) of N
// and columns [256 x, +256) of K; the reduction runs over C
// ---------------------------------------------------------------------------

template <bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
mm_bn_da_sm90(const __grid_constant__ CUtensorMap tm_d,
              const __grid_constant__ CUtensorMap tm_y,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_w,
              __nv_bfloat16* __restrict__ out, int n, int k, int c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const Ring ring(base, DA_STAGE);
  ring.init(kConsumers / 32);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kTileN;
  const int steps = (c + kBK - 1) / kBK;

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int step = 0; step < steps; ++step) {
        const int slot = step % kStages;
        // the consumers have released the slot's previous fill (the first
        // round passes: the parity of the phase before the first)
        sm90::mbar_wait(ring.empty_bar(slot), ((step / kStages) & 1) ^ 1);
        const uint32_t st = base + slot * DA_STAGE;
        const uint32_t bar = ring.full_bar(slot);
        const int c0 = step * kBK;
        sm90::mbar_expect_tx(bar, DA_TX);
        sm90::tma_load_2d(st + DA_W, &tm_w, bar, c0, col0);
        sm90::tma_load_2d(st + DA_D, &tm_d, bar, c0, row0);
        sm90::tma_load_2d(st + DA_Y, &tm_y, bar, c0, row0);
        sm90::tma_load_2d(st + DA_V, &tm_v, bar, c0, 0);
      }
    }
  } else {  // consumer warpgroups
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
      const int slot = step % kStages;
      sm90::mbar_wait(ring.full_bar(slot), (step / kStages) & 1);
      const uint32_t st = base + slot * DA_STAGE;
      const float* vs =
          reinterpret_cast<const float*>(gbase + slot * DA_STAGE + DA_V);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // k16 steps
        const uint32_t off = sw128(arow, 2 * j + (mi >> 1), 128);
        uint32_t dr[4], yr[4];
        sm90::ldmatrix_x4(dr, st + DA_D + off);
        sm90::ldmatrix_x4(yr, st + DA_Y + off);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // channels 16j + 2q (+1) for a0, a1 and 8 further for a2, a3;
          // v[r] = the pair's two values of vecs row r
          const int ch = 16 * j + 2 * q + 8 * h;
          float2 v[6];
#pragma unroll
          for (int r = 0; r < 6; ++r)
            v[r] = *reinterpret_cast<const float2*>(vs + r * 64 + ch);
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // the fragment's row, 8 rows below
            const uint32_t dd = dr[2 * h + r], yy = yr[2 * h + r];
            a[j][2 * h + r] = pack_bf16(
                dy1<RELU>(bf16_lo(dd), bf16_lo(yy), v[0].x, v[1].x, v[2].x,
                          v[3].x, v[4].x, v[5].x),
                dy1<RELU>(bf16_hi(dd), bf16_hi(yy), v[0].y, v[1].y, v[2].y,
                          v[3].y, v[4].y, v[5].y));
          }
        }
        sm90::wgmma_fence();
        sm90::wgmma_m64n256k16_rs<0>(
            acc, a[j], desc_sw128(st + DA_W + 32 * j, 16, 1024));
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      // this stage's wgmmas are done: release its slot
      if (lane == 0) sm90::mbar_arrive(ring.empty_bar(slot));
    }

    // epilogue: each thread's column pairs as bf16x2, masked at N and K
    const int r_lo = row0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int gk = col0 + 8 * i + 2 * q;
      if (gk >= k) continue;
      if (r_lo < n)
        *reinterpret_cast<uint32_t*>(out + (size_t)r_lo * k + gk) =
            pack_bf16(acc[4 * i], acc[4 * i + 1]);
      if (r_lo + 8 < n)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r_lo + 8) * k + gk) =
            pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dW^T = dy^T @ A over rows [z*rows, (z+1)*rows) of N: block (x, y, z) owns
// channels [128 x, +128) and columns [256 y, +256) of K; f32 partial per z
// ---------------------------------------------------------------------------

template <bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
mm_bn_dw_sm90(const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_d,
              const __grid_constant__ CUtensorMap tm_y,
              const float* __restrict__ vecs, float* __restrict__ part,
              int n, int k, int c, int rows) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const Ring ring(base, DW_STAGE);
  ring.init(kConsumers / 32);

  const int tid = threadIdx.x;
  const int ch0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kTileN;
  const int n_begin = blockIdx.z * rows;
  const int steps = (min(n, n_begin + rows) - n_begin + kBK - 1) / kBK;

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int step = 0; step < steps; ++step) {
        const int slot = step % kStages;
        sm90::mbar_wait(ring.empty_bar(slot), ((step / kStages) & 1) ^ 1);
        const uint32_t st = base + slot * DW_STAGE;
        const uint32_t bar = ring.full_bar(slot);
        const int r0 = n_begin + step * kBK;
        sm90::mbar_expect_tx(bar, DW_TX);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // A: four 64-column boxes
          sm90::tma_load_2d(st + DW_A + kc * 8192, &tm_a, bar,
                            col0 + kc * 64, r0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // d, y: two 64-channel boxes
          sm90::tma_load_2d(st + DW_D + h * 8192, &tm_d, bar, ch0 + h * 64,
                            r0);
          sm90::tma_load_2d(st + DW_Y + h * 8192, &tm_y, bar, ch0 + h * 64,
                            r0);
        }
      }
    }
  } else {  // consumer warpgroups
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int lane = tid & 31;
    const int warp = (tid >> 5) & 3;
    const int wg = tid >> 7;
    const int mi = lane >> 3;
    // this thread's two channels (fragment rows lane/4 and 8 below) are
    // fixed: their six vecs values in registers
    const int cha = ch0 + wg * 64 + warp * 16 + (lane >> 2);
    float va[6], vb[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      va[i] = cha < c ? vecs[(size_t)i * c + cha] : 0.f;
      vb[i] = cha + 8 < c ? vecs[(size_t)i * c + cha + 8] : 0.f;
    }
    // ldmatrix.trans: lanes 8m..8m+7 address rows (m >> 1)*8 + 0..7 of the
    // k16 step at channels (m & 1)*8 of this warp's 16; the tile holds its
    // 128 channels as two 64-channel boxes
    const int lchunk = (wg * 64 + warp * 16 + (mi & 1) * 8) >> 3;
    const uint32_t lbox = (lchunk >> 3) * 8192;

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t af[4][4];
    for (int step = 0; step < steps; ++step) {
      const int slot = step % kStages;
      sm90::mbar_wait(ring.full_bar(slot), (step / kStages) & 1);
      const uint32_t st = base + slot * DW_STAGE;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * j + (mi >> 1) * 8 + (lane & 7);
        const uint32_t off = lbox + sw128(r, lchunk & 7, 128);
        uint32_t dr[4], yr[4];
        sm90::ldmatrix_x4_trans(dr, st + DW_D + off);
        sm90::ldmatrix_x4_trans(yr, st + DW_Y + off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // a0, a2: channel cha; a1, a3: +8
          const float* v = (i & 1) ? vb : va;
          af[j][i] = pack_bf16(
              dy1<RELU>(bf16_lo(dr[i]), bf16_lo(yr[i]), v[0], v[1], v[2],
                        v[3], v[4], v[5]),
              dy1<RELU>(bf16_hi(dr[i]), bf16_hi(yr[i]), v[0], v[1], v[2],
                        v[3], v[4], v[5]));
        }
        sm90::wgmma_fence();
        sm90::wgmma_m64n256k16_rs<1>(
            acc, af[j], desc_sw128(st + DW_A + 2048 * j, 8192, 1024));
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      // this stage's wgmmas are done: release its slot
      if (lane == 0) sm90::mbar_arrive(ring.empty_bar(slot));
    }

    // epilogue: dW^T tile -> shared (K rows x 128 channels, f32), then
    // coalesced rows of dW (K, C). Both consumers must be done reading the
    // ring, and every stage the partners multicast here has landed (each
    // was waited for), before it is overwritten
    sm90::named_sync(1, kConsumers);
    float* stf = reinterpret_cast<float*>(gbase);
    const int chl = wg * 64 + warp * 16 + (lane >> 2);
    const int q = lane & 3;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * i + 2 * q + e;
        stf[kc * DW_PITCH + chl] = acc[4 * i + e];
        stf[kc * DW_PITCH + chl + 8] = acc[4 * i + 2 + e];
      }
    }
    sm90::named_sync(1, kConsumers);
    float* dst = part + (size_t)blockIdx.z * k * c;
    const int gc = ch0 + lane * 4;
    for (int rr = tid >> 5; rr < kTileN; rr += kConsumers / 32) {
      const int gk = col0 + rr;
      if (gk < k && gc < c)
        *reinterpret_cast<float4*>(dst + (size_t)gk * c + gc) =
            *reinterpret_cast<const float4*>(stf + rr * DW_PITCH + lane * 4);
    }
  }
}

}  // namespace

// da (n, k) bf16 from d, y (n, c) bf16, vecs (6, c) f32, w (k, c) bf16.
extern "C" int ieee_mm_bn_da_bf16(const void* d, const void* y,
                                  const void* vecs, const void* w, void* da,
                                  int n, int k, int c, int relu,
                                  void* stream) {
  if (n <= 0 || k <= 0) return 0;
  CUtensorMap tm_d, tm_y, tm_v, tm_w;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map_2d(&tm_d, d, bf, 2, n, c, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_y, y, bf, 2, n, c, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_w, w, bf, 2, k, c, kTileN, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_v, vecs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                           6, c, 6, 64, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = relu ? mm_bn_da_sm90<true> : mm_bn_da_sm90<false>;
  cudaError_t err = sm90::allow_smem(kernel, DA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((k + kTileN - 1) / kTileN, (n + kRows - 1) / kRows);
  kernel<<<grid, kThreads, DA_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tm_d, tm_y, tm_v, tm_w, static_cast<__nv_bfloat16*>(da), n, k, c);
  return static_cast<int>(cudaGetLastError());
}

// dw (k, c) f32 from a (n, k) bf16, d, y (n, c) bf16, vecs (6, c) f32. With
// splits > 1, part is scratch of (splits, k, c) f32 and split z reduces rows
// [z*rows, (z+1)*rows) (rows a multiple of 64); with splits == 1 part may be
// null.
extern "C" int ieee_mm_bn_dw_bf16(const void* a, const void* d, const void* y,
                                  const void* vecs, void* dw, void* part,
                                  int n, int k, int c, int relu, int splits,
                                  int rows, void* stream) {
  if (k <= 0 || c <= 0) return 0;
  if (splits < 1 || rows % kBK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows is a multiple of the 64-row step, so a range's steps end where the
  // next range begins; the last range ends at N, past which the maps read
  // zeros
  CUtensorMap tm_a, tm_d, tm_y;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map_2d(&tm_d, d, bf, 2, n, c, kBK, 64, sw) ||
      !sm90::tensor_map_2d(&tm_y, y, bf, 2, n, c, kBK, 64, sw) ||
      !sm90::tensor_map_2d(&tm_a, a, bf, 2, n, k, kBK, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = relu ? mm_bn_dw_sm90<true> : mm_bn_dw_sm90<false>;
  cudaError_t err = sm90::allow_smem(kernel, DW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dst = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(dw);
  dim3 grid((c + kRows - 1) / kRows, (k + kTileN - 1) / kTileN, splits);
  kernel<<<grid, kThreads, DW_SMEM, s>>>(
      tm_a, tm_d, tm_y, static_cast<const float*>(vecs), dst, n, k, c, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const size_t size = (size_t)k * c;
  split_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, size);
  return static_cast<int>(cudaGetLastError());
}
