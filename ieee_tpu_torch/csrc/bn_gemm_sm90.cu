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
// bn3_apply's two kernel bodies (bn_rows_sm90, bn_dw_sm90 with Bn3Op) are
// shared with conv2_bwd and bn1_apply: bn_gemm_sm90.cuh states them, their
// rows and rounding points.
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
// with f32 accumulators in registers.
//   - bn_mm: a block owns 128 rows x 256 columns of o. h is built per k16
//     step from ldmatrix'd y fragments and the stage's [inv, sh] rows (their
//     own TMA box) and fed to wgmma m64n256k16 as its register A operand;
//     W2 (K, C) is read as stored, an MN-major B (four 64-column boxes).
//     The epilogue rounds to bf16 into shared memory and stores 16-byte
//     rows.
//   - bn3_apply, two launches (d3 and a3 are read twice; see PERF.md): a
//     single pass would have to hold either dW3 (c x cm f32) or d2's partial
//     sums over c for every row of its range, far beyond a block's
//     registers at layer2-3. dW3^T (c, cm) = da3^T h2 over split row ranges
//     (bn_dw_sm90: da3^T in registers, h2 built in place from a2's stage),
//     then d2 with its channel sums (bn_rows_sm90: da3 in registers, W3
//     (cm, c) K-major as stored, the cm tile 64, 128 or 256 wide).
// No float atomics anywhere: two runs agree bit for bit. TMA's zero fill
// covers ragged N, c and cm; K, C, c and cm must be multiples of 8 (the
// wrappers check).

#include "bn_gemm_sm90.cuh"

namespace {

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
// spart: (ceil(n / 128), 2, cm) f32 (the d2 product's blocks use a row
// each); wpart: (splits, cm, c) f32, or null with splits == 1; split z
// reduces rows [z*rows, (z+1)*rows), rows a multiple of 64.
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
  const int nb = tile_nb(cm);
  auto dw = nb == 1   ? &launch_dw<Bn3Op, 1>
            : nb == 2 ? &launch_dw<Bn3Op, 2>
                      : &launch_dw<Bn3Op, 4>;
  cudaError_t err = dw(d3, a3, a2, v3, v2f, dw3, wpart, n, c, cm, splits,
                       rows, 1, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto d2k = nb == 1   ? &launch_rows<Bn3Op, 1>
             : nb == 2 ? &launch_rows<Bn3Op, 2>
                       : &launch_rows<Bn3Op, 4>;
  return static_cast<int>(d2k(d3, a3, v3, w3, a2, v2f, d2, s2, spart, n, c,
                              cm, 1, 1, s));
}
