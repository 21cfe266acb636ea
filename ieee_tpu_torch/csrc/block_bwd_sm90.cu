// The block backward's 3x3 convolution and first 1x1 products on Hopper:
// conv2_bwd and bn1_apply, on the two kernel bodies that bn3_apply uses
// (bn_gemm_sm90.cuh states them, their rows and rounding points), and
// conv2_bwd's operand pass.
//
// Replaces: ieee_tpu/ops/pallas/block_bwd.py
//   `_conv2_bwd` (:351, body `_k_conv2_bwd`): da2 = bn2_bwd(d2); dW2[ky, kx]
//       = shift(h1)^T da2 (f32); d1 = (3x3 SAME input gradient of da2) *
//       [h1 > 0] (bf16 out); S11 = sum d1, S12 = sum d1 * xhat1 (f32);
//   `_bn1_apply` (:371, body `_k_bn1_apply`): da1 = bn1_bwd(d1); dW1 = x^T
//       da1 (f32); dx = da1 W1^T + d3 (bf16 out).
//
// What bounds them on an H100 (batch 128 at 256x128: N = 262144, 65536,
// 16384 rows at widths cm = 64, 128, 256 and cin = 4 cm): conv2_bwd does
// 36 N cm^2 flops over about 8 N cm bytes, 4.5 cm flop per byte, near the
// bf16 ridge of ~295 at cm = 64 and above it at 128 and 256: the tensor
// cores (1.18 ms over the 30 blocks of a step). bn1_apply does 4 N cin cm
// flops over about 28 N cm bytes (d1, a1 twice, x, d3 and dx): bytes (2.0
// ms over the 30 blocks).
//
// Design: the 3x3 convolution is nine shifted products each way, tap t =
// 3 ky + kx, no padded copy of any map. Its products stream their operands
// from L2 once per tap (and per output tile), so what they read decides
// their time: conv2_prep_kernel first writes da2 = bn2_bwd(d2) and h1 =
// relu(bn1(a1)) as bf16 rows (4 N cm bytes written and read back), and both
// products read those as stored, no BN operand rebuilt per tap and a2 not
// read again (PERF.md §6 has the ablations that chose this).
//   - conv2_bwd's input gradient (bn_rows_sm90, Conv2Op): the reduction runs
//     over 9 taps x cm; for tap t the da2 box is TMA'd at row + (1 - ky) W
//     + (1 - kx) and each fragment row whose tap leaves its image is
//     zeroed; B is W2[t] read as stored; the epilogue masks by [h1 > 0]
//     from a1 and v1f (the f32 value), stores bf16 d1 and sums S1.
//   - conv2_bwd's weight gradient (bn_dw_sm90, Conv2Op): the grid carries
//     the tap; A = da2^T of the unshifted rows, zero at the rows whose tap
//     leaves the image (a bit a row of the block's range in shared memory);
//     B the h1 box at row + (ky - 1) W + (kx - 1) as stored; dW2 written as
//     (3, 3, cm_in, cm_out); at most 128 columns, so the f32 totals flush
//     every 128 rows.
//   - bn1_apply's dx (bn_rows_sm90, Bn1Op): da1 in registers, W1 (cin, cm)
//     K-major as stored, output tiles of up to 128 cin columns; the blocks
//     of one row tile's cin tiles run at once, so d1 and a1 come from
//     device memory about once and from L2 after. The residual d3 has a TMA
//     ring of its own, a tile ahead; the epilogue rounds f32(acc) + f32(d3)
//     once to bf16 into that slot and stores 16-byte rows (4-byte pair
//     accesses measured 60% slower at layer1: PERF.md §6).
//   - bn1_apply's dW1 (bn_dw_sm90, Bn1Op): da1^T in registers, x as an
//     MN-major B as stored, at most 128 cin columns a block (flushed).
// The split ranges of the dW products are planned on the host
// (`ops/kernels/block_bwd.py`).

#include "bn_gemm_sm90.cuh"

namespace {

// the dW products' B tiles: 64 or 128 columns, so their f32 totals flush
int dw_nb(int cols) { return cols <= 64 ? 1 : 2; }

// da2 = bf16(bn2_bwd(d2, a2)) and h1 = bf16(relu(a1 * inv1 + shift1)) of
// (n, cm) rows, one 16-byte vector (8 channels) a thread, grid-strided;
// the same operations and roundings as the plain version's
__global__ void __launch_bounds__(256)
conv2_prep_kernel(const bf16* __restrict__ d2, const bf16* __restrict__ a2,
                  const bf16* __restrict__ a1, const float* __restrict__ v2,
                  const float* __restrict__ v1f, bf16* __restrict__ da2,
                  bf16* __restrict__ h1, int n, int cm) {
  const int vecs = cm / 8;
  const size_t total = (size_t)n * vecs;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int g = static_cast<int>(i % vecs) * 8;
    const size_t off = i * 8;
    float d[8], a[8], b[8], inv[8], mean[8], rstd[8], s1[8], s2[8], inv1[8],
        sh1[8];
    unpack8(d2 + off, d);
    unpack8(a2 + off, a);
    unpack8(a1 + off, b);
    load_vec8(v2 + g, inv);
    load_vec8(v2 + cm + g, mean);
    load_vec8(v2 + 2 * cm + g, rstd);
    load_vec8(v2 + 3 * cm + g, s1);
    load_vec8(v2 + 4 * cm + g, s2);
    load_vec8(v1f + g, inv1);
    load_vec8(v1f + cm + g, sh1);
    float o[8], hh[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[e] = bn_bwd1(d[e], a[e], inv[e], mean[e], rstd[e], s1[e], s2[e]);
      hh[e] = relu_bn(b[e], inv1[e], sh1[e]);
    }
    *reinterpret_cast<uint4*>(da2 + off) = pack8(o);
    *reinterpret_cast<uint4*>(h1 + off) = pack8(hh);
  }
}

}  // namespace

// d1 (b*h*w, cm) bf16, s1 (2, cm) f32 and dw2 (3, 3, cm, cm) f32 from d2,
// a2, a1 (b*h*w, cm) bf16, w2 (3, 3, cm, cm) bf16, v2 (5, cm) and v1f
// (4, cm) f32. spart: (ceil(b*h*w / 128), 2, cm) f32; wpart: (splits,
// 9 cm, cm) f32 or null with splits == 1; split z reduces rows [z*rows,
// (z+1)*rows), rows a multiple of 64 and at most 32768; da2, h1: (b*h*w,
// cm) bf16 scratch.
extern "C" int ieee_block_conv2_bwd(const void* d2, const void* a2,
                                    const void* a1, const void* w2,
                                    const void* v2, const void* v1f, void* d1,
                                    void* s1, void* dw2, void* spart,
                                    void* wpart, void* da2, void* h1, int b,
                                    int h, int w, int cm, int splits,
                                    int rows, void* stream) {
  const int n = b * h * w;
  if (n <= 0 || cm <= 0) return 0;
  if (splits < 1 || rows <= 0 || rows % kBK || cm % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t vecs = (size_t)n * (cm / 8);
  const unsigned blocks = static_cast<unsigned>(
      std::min<size_t>((vecs + 255) / 256, (size_t)sm_count() * 8));
  conv2_prep_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const bf16*>(d2), static_cast<const bf16*>(a2),
      static_cast<const bf16*>(a1), static_cast<const float*>(v2),
      static_cast<const float*>(v1f), static_cast<bf16*>(da2),
      static_cast<bf16*>(h1), n, cm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dw = dw_nb(cm) == 1 ? &launch_dw<Conv2Op, 1> : &launch_dw<Conv2Op, 2>;
  err = dw(da2, da2, h1, v2, v1f, dw2, wpart, n, cm, cm, splits, rows, h, w,
           s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = tile_nb(cm);
  auto dx = nb == 1   ? &launch_rows<Conv2Op, 1>
            : nb == 2 ? &launch_rows<Conv2Op, 2>
                      : &launch_rows<Conv2Op, 4>;
  return static_cast<int>(dx(da2, da2, v2, w2, a1, v1f, d1, s1, spart, n, cm,
                             cm, h, w, s));
}

// dx (n, cin) bf16 and dw1 (cin, cm) f32 from d1, a1 (n, cm), x, d3
// (n, cin) bf16, w1 (cin, cm) bf16 and v1 (5, cm) f32. wpart: (splits, cin,
// cm) f32 or null with splits == 1; split z reduces rows [z*rows,
// (z+1)*rows), rows a multiple of 64.
extern "C" int ieee_block_bn1_apply(const void* d1, const void* a1,
                                    const void* x, const void* d3,
                                    const void* w1, const void* v1, void* dx,
                                    void* dw1, void* wpart, int n, int cin,
                                    int cm, int splits, int rows,
                                    void* stream) {
  if (n <= 0 || cin <= 0 || cm <= 0) return 0;
  if (splits < 1 || rows <= 0 || rows % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto dw = dw_nb(cin) == 1 ? &launch_dw<Bn1Op, 1> : &launch_dw<Bn1Op, 2>;
  cudaError_t err = dw(d1, a1, x, v1, nullptr, dw1, wpart, n, cm, cin,
                       splits, rows, 1, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dx tiles of at most 128 columns: their residual pairs are loaded as
  // the tile's mainloop starts (D2::kPrefetch)
  auto dxk = tile_nb(cin) == 1 ? &launch_rows<Bn1Op, 1>
                               : &launch_rows<Bn1Op, 2>;
  return static_cast<int>(dxk(d1, a1, v1, w1, d3, nullptr, dx, nullptr,
                              nullptr, n, cm, cin, 1, 1, s));
}
