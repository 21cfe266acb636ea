// Whole-block backward of the stride-1 bottleneck without downsample:
// three of its four kernels, each one or two products with the BN backward
// and the relu(bn(.)) recompute in their operand loads (the fourth,
// `_bn3_apply`, is in bn_gemm_sm90.cu).
//
// Replaces: ieee_tpu/ops/pallas/block_bwd.py
//   `_reduce3` (body `_k_reduce3`): d3 = dy * [y > 0] (bf16 out) and the
//       channel sums S31 = sum d3, S32 = sum d3 * xhat3 (f32);
//   `_conv2_bwd` (body `_k_conv2_bwd`): da2 = bn2_bwd(d2); dW2[ky, kx] =
//       shift(h1)^T da2 (f32); d1 = (3x3 SAME input gradient of da2) *
//       [h1 > 0] (bf16 out); S11, S12;
//   `_bn1_apply` (body `_k_bn1_apply`): da1 = bn1_bwd(d1); dW1 = x^T da1
//       (f32); dx = da1 W1^T + d3 (bf16 out).
// Activations are (N, C) rows, N = B*H*W, of channels_last maps. A BN
// backward reads the cotangent d, the pre-BN activation a and five f32 rows
// v = [inv, mean, rstd, S1/N, S2/N]:
//   da = bf16(inv * ((d - S1/N) - ((a - mean) * rstd) * S2/N))
// and a recomputed h reads a and four rows vf = [inv, shift, mean, rstd]:
//   h = relu(a * inv + shift), the mask [h > 0] from the f32 value.
// da and h never touch device memory. Every rounding point is that of the
// plain PyTorch version (`ops/kernels/block_bwd.py`): explicit
// round-to-nearest operations, no FMA contraction, so masks and bf16 stores
// agree bit for bit where the f32 sums they read agree.
//
// What bounds them on an H100 (batch 128 at 256x128: N = 262144, 65536,
// 16384 rows at widths cm = 64, 128, 256 and C = 4 cm): `_reduce3` moves
// 8 N C bytes for no product, and `_bn1_apply` does 4 N C cm flops over
// about 6 N C bytes, 2/3 cm flop per byte: both are bound by bytes.
// `_conv2_bwd` does 36 N cm^2 flops over about 8 N cm bytes, 4.5 cm flop
// per byte, near the bf16 ridge of ~295 at cm = 64 and above it at cm =
// 128, 256.
//
// Design (simple first). The products are two templated WMMA bf16
// mainloops (f32 accumulation) with the train kernels' tiling
// (wmma_tile.cuh): 256 threads, a 128x128 output tile, warps of 64x32, the
// reduction in steps of 32 through padded shared tiles filled with 16-byte
// loads. Each operand is read
// through a loader that returns 8 bf16 of a logical matrix at (row,
// column), which is where the BN backward, the recomputed h and the 3x3
// shifts live:
//   - rows_gemm (row_gemm.cuh): out (N, cols) = A (N, K) B (cols, K)^T,
//     one block per 128 rows and 128 columns; its epilogue either masks by
//     [h > 0], stores bf16 and writes the block's channel sums [sum d,
//     sum d*xhat] (d1), or adds the residual d3 and stores bf16 (dx).
//   - tgemm: dW (M, cols) = A (N, M)^T B (N, cols) over a contiguous range
//     of rows per grid z (split N for occupancy), f32 partials.
//   - The 3x3 convolution is the product over K = 9 cm (tap, channel): the
//     input gradient reads da2 at the pixel (y + 1 - ky, x + 1 - kx) of the
//     same image against W2[ky, kx]^T; dW2, as an (9 cm, cm) matrix, reads
//     h1 at (y + ky - 1, x + kx - 1). A tap that leaves the image reads
//     zero (the JAX kernel's zero-padded scratch, never a padded copy), and
//     the row index is mapped back to (b, y, x) so taps never cross images.
//   - Deterministic sums, no float atomics: the channel sums of each 128-row
//     block and the f32 dW partials of each row range are added in a fixed
//     order by a second small kernel. Two runs agree bit for bit.
// Loads are synchronous; cp.async/TMA pipelining and wgmma are later work.
// Channel counts must be multiples of 8 (the wrappers check); any N runs.

#include "row_gemm.cuh"

namespace {

// tgemm adds its tensor-core sums into f32 totals every FLUSH steps of BK
// rows (see there)
constexpr int FLUSH = 4;

__device__ __forceinline__ float xhat(float a, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(a, mean), rstd);
}

// da for channels gc..gc+7 of one row: d and a point at the row, v is the
// (5, c) block [inv, mean, rstd, S1/N, S2/N]
__device__ __forceinline__ uint4 da8(const bf16* __restrict__ d,
                                     const bf16* __restrict__ a,
                                     const float* __restrict__ v, int c,
                                     int gc) {
  float df[8], af[8], inv[8], mean[8], rstd[8], s1[8], s2[8];
  unpack8(d + gc, df);
  unpack8(a + gc, af);
  load_vec8(v + gc, inv);
  load_vec8(v + c + gc, mean);
  load_vec8(v + 2 * c + gc, rstd);
  load_vec8(v + 3 * c + gc, s1);
  load_vec8(v + 4 * c + gc, s2);
  float o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fsub_rn(__fsub_rn(df[e], s1[e]),
                              __fmul_rn(xhat(af[e], mean[e], rstd[e]), s2[e]));
    o[e] = __fmul_rn(inv[e], t);
  }
  return pack8(o);
}

// the block backward's own operand loaders (row_gemm.cuh states their
// contract and holds Plain and h8)

struct BnBwd {  // da of rows d, a (N, c)
  const bf16* d;
  const bf16* a;
  const float* v;
  int c;
  __device__ __forceinline__ uint4 load8(int r, int k) const {
    return da8(d + (size_t)r * c, a + (size_t)r * c, v, c, k);
  }
};

// + x, or -1 where it leaves the image
struct Geom {
  int h, w;
  __device__ __forceinline__ int shift(int r, int dy, int dx) const {
    const int x = r % w;
    const int y = (r / w) % h;
    const int yy = y + dy, xx = x + dx;
    if (yy < 0 || yy >= h || xx < 0 || xx >= w) return -1;
    return r + dy * w + dx;
  }
};

// dW2's A operand (N, 9 cm): [r][t*cm + ci] = h1 at the pixel (y + ky - 1,
// x + kx - 1), t = 3 ky + kx
struct ShiftedH1 {
  const bf16* a1;
  const float* vf;
  int cm;
  Geom g;
  __device__ __forceinline__ uint4 load8(int r, int k) const {
    const int t = k / cm;
    const int rr = g.shift(r, t / 3 - 1, t % 3 - 1);
    if (rr < 0) return make_uint4(0, 0, 0, 0);
    return h8(a1 + (size_t)rr * cm, vf, cm, k - t * cm);
  }
};

// the input gradient's A operand (N, 9 cm): [r][t*cm + co] = da2 at the
// pixel (y + 1 - ky, x + 1 - kx)
struct ShiftedDa2 {
  const bf16* d2;
  const bf16* a2;
  const float* v;
  int cm;
  Geom g;
  __device__ __forceinline__ uint4 load8(int r, int k) const {
    const int t = k / cm;
    const int rr = g.shift(r, 1 - t / 3, 1 - t % 3);
    if (rr < 0) return make_uint4(0, 0, 0, 0);
    return da8(d2 + (size_t)rr * cm, a2 + (size_t)rr * cm, v, cm, k - t * cm);
  }
};

// the input gradient's B operand (cm_in, 9 cm): [ci][t*cm + co] =
// W2[t][ci][co] of the (3, 3, cm_in, cm_out) weight
struct TapWeight {
  const bf16* w;
  int cm;
  __device__ __forceinline__ uint4 load8(int r, int k) const {
    const int t = k / cm;
    return *reinterpret_cast<const uint4*>(w + ((size_t)t * cm + r) * cm +
                                           (k - t * cm));
  }
};

// ---------------------------------------------------------------------------
// epilogues of rows_gemm: apply(r, k, acc, v, vx) stores the 8 outputs at
// (r, k..k+7) from the f32 accumulators and, with kStats, returns the
// values and their products with x-hat for the channel sums
// ---------------------------------------------------------------------------

struct MaskStats {  // out = bf16(acc * [h > 0]), h from rows a (N, cols)
  const bf16* a;
  const float* vf;
  bf16* out;
  int cols;
  static constexpr bool kStats = true;
  __device__ __forceinline__ void apply(int r, int k, const float* acc,
                                        float v[8], float vx[8]) const {
    float af[8], inv[8], shift[8], mean[8], rstd[8];
    unpack8(a + (size_t)r * cols + k, af);
    load_vec8(vf + k, inv);
    load_vec8(vf + cols + k, shift);
    load_vec8(vf + 2 * cols + k, mean);
    load_vec8(vf + 3 * cols + k, rstd);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float pre = __fadd_rn(__fmul_rn(af[e], inv[e]), shift[e]);
      v[e] = pre > 0.f ? acc[e] : 0.f;
      vx[e] = __fmul_rn(v[e], xhat(af[e], mean[e], rstd[e]));
    }
    *reinterpret_cast<uint4*>(out + (size_t)r * cols + k) = pack8(v);
  }
};

struct Residual {  // out = bf16(acc + f32(res)), res (N, cols)
  const bf16* res;
  bf16* out;
  int cols;
  static constexpr bool kStats = false;
  __device__ __forceinline__ void apply(int r, int k, const float* acc,
                                        float v[8], float vx[8]) const {
    float rf[8];
    unpack8(res + (size_t)r * cols + k, rf);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(acc[e], rf[e]);
    *reinterpret_cast<uint4*>(out + (size_t)r * cols + k) = pack8(v);
  }
};

// total += acc and acc = 0, element by element (the same fragment layout)
__device__ __forceinline__ void add_acc(frag_acc (&total)[FM][FN],
                                        frag_acc (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int t = 0; t < acc[i][j].num_elements; ++t) {
        total[i][j].x[t] += acc[i][j].x[t];
        acc[i][j].x[t] = 0.f;
      }
}

// ---------------------------------------------------------------------------
// dW (m, cols) = A (n, m)^T @ B (n, cols) over rows [z*rows, (z+1)*rows),
// an f32 partial per z. The tensor cores' f32 accumulation drifts over long
// chains of same-signed products (h >= 0 times a biased da: measured on an
// H100 at layer1, 4960 rows per chain, 1.5e-5 of the value, against 3.5e-7
// for the plain version), so the fragments' sums are added into f32 totals
// and restarted every FLUSH * BK rows.
// ---------------------------------------------------------------------------

template <class LA, class LB>
__global__ void __launch_bounds__(THREADS)
tgemm_kernel(LA la, LB lb, float* __restrict__ part, int n, int m, int cols,
             int rows) {
  __shared__ __align__(128) bf16 as[BK][BM + PAD];
  __shared__ __align__(128) bf16 bs[BK][BN + PAD];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM;  // rows of m
  const int col0 = blockIdx.x * BN;  // columns
  const int n_begin = blockIdx.z * rows;
  const int n_end = min(n, n_begin + rows);

  frag_acc acc[FM][FN], total[FM][FN];
  zero_acc(acc);
  zero_acc(total);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  int steps = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += BK) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = tid + e * THREADS;
      const int r = v / (BM / 8);
      const int cv = (v % (BM / 8)) * 8;
      const int gn = n0 + r;
      const int gm = row0 + cv;
      *reinterpret_cast<uint4*>(&as[r][cv]) =
          (gn < n_end && gm < m) ? la.load8(gn, gm) : zero;
      const int gc = col0 + cv;
      *reinterpret_cast<uint4*>(&bs[r][cv]) =
          (gn < n_end && gc < cols) ? lb.load8(gn, gc) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A^T (m, n) is A (n, m) read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &as[kk][wm * WM + i * 16], BM + PAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &bs[kk][wn * WN + j * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (++steps == FLUSH || n0 + BK >= n_end) {
      steps = 0;
      add_acc(total, acc);
    }
  }

  float* out = part + (size_t)blockIdx.z * m * cols;
  float* sc = scratch[warp];
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, total[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = row0 + wm * WM + i * 16 + er;
      const int gc = col0 + wn * WN + j * 16 + ec;
      if (gm < m && gc < cols) {
        float* dst = out + (size_t)gm * cols + gc;
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(&sc[er * 16 + ec]);
        *reinterpret_cast<float4*>(dst + 4) =
            *reinterpret_cast<const float4*>(&sc[er * 16 + ec + 4]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// _reduce3: d3 = dy * [y > 0] and the channel sums of `rows` rows per block
// (y of the grid) over 256 channels (x of the grid); threads (32, 8): 8
// channels per thread across, 8 row lanes down
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
reduce3_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
               const bf16* __restrict__ a3, const float* __restrict__ vec,
               bf16* __restrict__ d3, float* __restrict__ part, int n, int c,
               int rows) {
  __shared__ float red[8][2][256];  // [row lane][sum, sum*xhat][channel]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int cbase = blockIdx.x * 256;
  const int gc = cbase + tx * 8;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(n, r0 + rows);
  float s[8], sx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = sx[e] = 0.f;
  if (gc < c) {
    float mean[8], rstd[8];
    load_vec8(vec + gc, mean);
    load_vec8(vec + c + gc, rstd);
    for (int r = r0 + ty; r < r1; r += 8) {
      const size_t off = (size_t)r * c + gc;
      float g[8], yf[8], af[8];
      unpack8(dy + off, g);
      unpack8(y + off, yf);
      unpack8(a3 + off, af);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!(yf[e] > 0.f)) g[e] = 0.f;
        s[e] += g[e];
        sx[e] += __fmul_rn(g[e], xhat(af[e], mean[e], rstd[e]));
      }
      *reinterpret_cast<uint4*>(d3 + off) = pack8(g);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[ty][0][tx * 8 + e] = s[e];
    red[ty][1][tx * 8 + e] = sx[e];
  }
  __syncthreads();
  const int tid = ty * 32 + tx;
  for (int o = tid; o < 512; o += 256) {
    const int which = o / 256;
    const int col = o % 256;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += red[q][which][col];
    if (cbase + col < c)
      part[((size_t)blockIdx.y * 2 + which) * c + cbase + col] = t;
  }
}

template <class LA, class LB>
cudaError_t launch_t(LA la, LB lb, float* dw, float* part, int n, int m,
                     int cols, int splits, int rows, cudaStream_t s) {
  float* dst = splits > 1 ? part : dw;
  dim3 grid((cols + BN - 1) / BN, (m + BM - 1) / BM, splits);
  tgemm_kernel<<<grid, THREADS, 0, s>>>(la, lb, dst, n, m, cols, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return err;
  const size_t size = (size_t)m * cols;
  split_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, dw, splits, size);
  return cudaGetLastError();
}

}  // namespace

// d3 (n, c) bf16 and s3 (2, c) f32 from dy, y, a3 (n, c) bf16 and vec (2, c)
// f32 [mean3, rstd3]; part is scratch of (ceil(n / rows), 2, c) f32.
extern "C" int ieee_block_reduce3(const void* dy, const void* y,
                                  const void* a3, const void* vec, void* d3,
                                  void* s3, void* part, int n, int c,
                                  int rows, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + rows - 1) / rows;
  dim3 grid((c + 255) / 256, row_blocks);
  reduce3_kernel<<<grid, dim3(32, 8), 0, s>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
      static_cast<const bf16*>(a3), static_cast<const float*>(vec),
      static_cast<bf16*>(d3), static_cast<float*>(part), n, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_reduce_kernel<<<(2 * c + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(s3), row_blocks,
      c);
  return static_cast<int>(cudaGetLastError());
}

// d1 (b*h*w, cm) bf16, s1 (2, cm) f32 and dw2 (3, 3, cm, cm) f32 from d2,
// a2, a1 (b*h*w, cm) bf16, w2 (3, 3, cm, cm) bf16, v2 (5, cm) and v1f
// (4, cm) f32. spart: (ceil(b*h*w / 128), 2, cm) f32; wpart: (splits,
// 9 cm, cm) f32 or null.
extern "C" int ieee_block_conv2_bwd(const void* d2, const void* a2,
                                    const void* a1, const void* w2,
                                    const void* v2, const void* v1f, void* d1,
                                    void* s1, void* dw2, void* spart,
                                    void* wpart, int b, int h, int w, int cm,
                                    int splits, int rows, void* stream) {
  const int n = b * h * w;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{h, w};
  const ShiftedH1 h1{static_cast<const bf16*>(a1),
                     static_cast<const float*>(v1f), cm, g};
  const BnBwd da2{static_cast<const bf16*>(d2), static_cast<const bf16*>(a2),
                  static_cast<const float*>(v2), cm};
  cudaError_t err = launch_t(h1, da2, static_cast<float*>(dw2),
                             static_cast<float*>(wpart), n, 9 * cm, cm,
                             splits, rows, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ShiftedDa2 da2s{static_cast<const bf16*>(d2),
                        static_cast<const bf16*>(a2),
                        static_cast<const float*>(v2), cm, g};
  const MaskStats epi{static_cast<const bf16*>(a1),
                      static_cast<const float*>(v1f), static_cast<bf16*>(d1),
                      cm};
  return static_cast<int>(launch_rows(
      da2s, TapWeight{static_cast<const bf16*>(w2), cm}, epi,
      static_cast<float*>(spart), static_cast<float*>(s1), n, cm, 9 * cm, s));
}

// dx (n, cin) bf16 and dw1 (cin, cm) f32 from d1, a1 (n, cm), x, d3
// (n, cin) bf16, w1 (cin, cm) bf16 and v1 (5, cm) f32. wpart: (splits, cin,
// cm) f32 or null.
extern "C" int ieee_block_bn1_apply(const void* d1, const void* a1,
                                    const void* x, const void* d3,
                                    const void* w1, const void* v1, void* dx,
                                    void* dw1, void* wpart, int n, int cin,
                                    int cm, int splits, int rows,
                                    void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BnBwd da1{static_cast<const bf16*>(d1), static_cast<const bf16*>(a1),
                  static_cast<const float*>(v1), cm};
  cudaError_t err = launch_t(Plain{static_cast<const bf16*>(x), cin}, da1,
                             static_cast<float*>(dw1),
                             static_cast<float*>(wpart), n, cin, cm, splits,
                             rows, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Residual epi{static_cast<const bf16*>(d3), static_cast<bf16*>(dx),
                     cin};
  return static_cast<int>(launch_rows(
      da1, Plain{static_cast<const bf16*>(w1), cm}, epi, nullptr, nullptr, n,
      cin, cm, s));
}
