// Eval-mode 1x1 conv + folded BatchNorm [+ ReLU] as one matmul kernel.
//
// Replaces: ieee_tpu/ops/pallas/matmul_bn.py `mm_affine_act` (Pallas body
// `_mm_affine_kernel`): out = [relu]((A @ W) * inv + shift), A (N, K) and
// W (K, C) in bf16, the product accumulated in f32, the affine and ReLU on the
// f32 accumulator, the result stored as bf16. A residual, when the caller has
// one, is added outside (models/common.py), exactly as in the JAX package.
//
// What bounds it and the mainloop: mm_sm90.cuh (at the layer4 sites of the
// 256x128 eval, N = 100*16*8 = 12800 rows, the tensor cores). The
// epilogue applies the block's 64 NB inv and shift values (staged in
// shared memory before the mainloop) to the f32 accumulator, each product
// and sum rounded on its own (no FMA contraction) as the plain version
// rounds them, then the ReLU, and rounds once to bf16.

#include "mm_sm90.cuh"

namespace {

// block (x, y) owns rows [128 y, +128) and columns [64 NB x, +64 NB) of
// out (n, c) bf16
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
mm_affine_sm90(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ inv, const float* __restrict__ shift,
               __nv_bfloat16* __restrict__ out, int n, int k, int c,
               int relu) {
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
  // inv and shift of the block's columns (0 past c), read in the epilogue
  // after the barrier that follows the mainloop
  float* sv = reinterpret_cast<float*>(sm.ptr + L::SV);
  for (int i = threadIdx.x; i < 2 * L::kWidth; i += kConsumers) {
    const int col = col0 + i % L::kWidth;
    sv[i] = col < c ? (i < L::kWidth ? inv : shift)[col] : 0.f;
  }
  float acc[32 * NB];
  mm_consume<NB>(acc, sm, ring, steps);

  // both warpgroups are done with the ring, and every stage issued was
  // waited for, so no copy still lands in it
  sm90::named_sync(1, kConsumers);
  const bool r = relu != 0;
  sm90::store_rows<NB>(
      acc,
      [sv, r](float v, int col) {
        const float o = __fadd_rn(__fmul_rn(v, sv[col]), sv[L::kWidth + col]);
        return r ? fmaxf(o, 0.f) : o;
      },
      sm.ptr, out, row0, col0, n, c);
}

template <int NB>
cudaError_t launch_affine(const CUtensorMap& tm_a, const CUtensorMap& tm_w,
                          const void* inv, const void* shift, void* out,
                          int n, int k, int c, int relu, cudaStream_t s) {
  using L = MmTile<NB>;
  cudaError_t err = sm90::allow_smem(mm_affine_sm90<NB>, L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((c + L::kWidth - 1) / L::kWidth, (n + kRows - 1) / kRows);
  mm_affine_sm90<NB><<<grid, kThreads, L::SMEM, s>>>(
      tm_a, tm_w, static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out), n,
      k, c, relu);
  return cudaGetLastError();
}

}  // namespace

// out (n, c) bf16 from a (n, k) and w (k, c) bf16, inv and shift (c,) f32;
// nb (1, 2 or 4) sets the column tile, 64 nb wide.
extern "C" int ieee_mm_affine_bf16(const void* a, const void* w,
                                   const void* inv, const void* shift,
                                   void* out, int n, int k, int c, int relu,
                                   int nb, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (k <= 0 || (nb != 1 && nb != 2 && nb != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_a, tm_w;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map_2d(&tm_a, a, bf, 2, n, k, kRows, kBK, sw) ||
      !sm90::tensor_map_2d(&tm_w, w, bf, 2, k, c, kBK, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = nb == 4   ? &launch_affine<4>
                : nb == 2 ? &launch_affine<2>
                          : &launch_affine<1>;
  return static_cast<int>(launch(tm_a, tm_w, inv, shift, out, n, k, c, relu,
                                 static_cast<cudaStream_t>(stream)));
}
