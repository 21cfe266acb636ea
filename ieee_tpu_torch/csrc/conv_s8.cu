// The w8a8 convolution of the int8 eval path: an s8 x s8 -> s32 implicit
// GEMM that quantizes its activations as it loads them.
//
// Replaces no Pallas kernel. The JAX package's int8 path
// (ieee_tpu/models/int8_eval.py `trunk_forward_int8`, :161-177) leaves each
// conv site to XLA: a quantize pass clip(round(x * inv_sx), -127, 127) into
// int8, then `_conv_nhwc` (:122) with preferred_element_type=int32, then the
// dequantizing epilogue y = f32(acc) * (sw[n] * sx) + b[n], bf16, [ReLU].
// PyTorch has no int8 convolution on the card (F.conv2d refuses int8), so
// this kernel computes the whole site in one launch:
//   M = B * Ho * Wo output pixels, N = C_out, K = KH * KW * C_in;
//   A (M, K) is gathered from the NHWC input (zero padding, stride) and
//   quantized on load; B (N, K) holds the int8 weights, K-major (OHWI);
//   the s32 sums go through the epilogue into bf16 NHWC, or are written raw
//   (s32) for an exact check.
//
// Rounding follows the JAX site: x is read in its own type (bf16, or f32 for
// the stem's normalized image), multiplied in f32 by inv_sx = f32(1 / sx)
// and rounded half to even (__float2int_rn, jnp.round), then clamped; the
// products and sums are exact in s32 (|acc| <= 127^2 * 4608 < 2^31 at
// ResNet-50's deepest K); the epilogue's product and sum are rounded each
// on their own (__fmul_rn, __fadd_rn: no FMA), as the plain version's two
// elementwise operations, then rounded to nearest-even bf16.
//
// What bounds it on an H100: bytes at most sites. The card does 1,979 int8
// TOP/s against 3.35 TB/s, 590 operations a byte; a site reads its bf16
// input once (f32 for the stem) and writes a bf16 output, so with K of
// 64-4608 only layer3-4's 3x3 sites and widest 1x1 sites of a ResNet-50
// at 256x128 (last_stride 1) pass that ratio, and over the trunk's 53
// sites the bytes weigh most (tools/int8_probe.py prints each site's).
//
// Design (a simple kernel that is right first; the wgmma redesign is
// ROADMAP B.7): 128 x BN output tiles (BN 64 or 128), 256 threads as 8
// warps, each warp a 64 x 32 (BN 128) or 32 x 32 (BN 64) tile of
// mma.sync.m16n8k32 s8 products with s32 sums in registers. K runs in steps
// of 64 bytes through two shared-memory buffers: while the warps multiply
// one step, each thread has the next step's loads in flight in registers,
// then quantizes and stores them into the other buffer. Shared rows are 80
// bytes (64 + 16 of padding), so the 32-bit fragment loads of a warp fall
// in 32 different banks. Two loaders:
//   - VEC (C_in % 16 == 0: every site but the stem): a thread gathers
//     16-channel chunks, 32 bytes of bf16 (or 64 of f32) in 16-byte loads,
//     two chunks of A and BN / 64 chunks of B a step; a chunk lies in one
//     tap, so the tap, the pixel and the padding are found once per chunk.
//   - Scalar (the stem: C_in 3, K = 147): a thread walks 32 (A) and
//     BN / 4 (B) consecutive k of one row a step, element by element; K is
//     padded to the step with zeros here, not by the caller.
// N must be a multiple of 8 (the wrapper checks), so an 8-wide fragment
// column is either inside N or wholly outside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBK = 64;            // bytes of K per step
constexpr int kRow = kBK + 16;     // padded shared row, bytes

struct ConvArgs {
  const void* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int h, w_in, cin, ho, wo, n, kw, stride, pad;
  int m, k;
  float inv_sx;
  int relu, raw;
};

__device__ __forceinline__ int quant(float v, float inv_sx) {
  const int q = __float2int_rn(__fmul_rn(v, inv_sx));
  return min(max(q, -127), 127);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t(a) & 0xffu) | ((uint32_t(b) & 0xffu) << 8) |
         ((uint32_t(c) & 0xffu) << 16) | (uint32_t(d) << 24);
}

__device__ __forceinline__ float ld_elem(const float* p) { return *p; }
__device__ __forceinline__ float ld_elem(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// 16 consecutive input values of one chunk, as raw 16-byte vectors
template <typename T>
struct Chunk {
  static constexpr int kVecs = 16 * sizeof(T) / 16;
  uint4 v[kVecs];
};

__device__ __forceinline__ void chunk_values(const Chunk<float>& c,
                                             float f[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i + 0] = __uint_as_float(c.v[i].x);
    f[4 * i + 1] = __uint_as_float(c.v[i].y);
    f[4 * i + 2] = __uint_as_float(c.v[i].z);
    f[4 * i + 3] = __uint_as_float(c.v[i].w);
  }
}

__device__ __forceinline__ void chunk_values(const Chunk<__nv_bfloat16>& c,
                                             float f[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t u[4] = {c.v[i].x, c.v[i].y, c.v[i].z, c.v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
      f[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// where an output row (pixel) of the tile reads its input
struct RowOrigin {
  long long base;  // element offset of the image in x
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ RowOrigin row_origin(const ConvArgs& p, int m) {
  RowOrigin r;
  r.valid = m < p.m;
  const int mm = r.valid ? m : 0;
  const int hw = p.ho * p.wo;
  const int b = mm / hw;
  const int rem = mm - b * hw;
  const int oh = rem / p.wo;
  const int ow = rem - oh * p.wo;
  r.base = (long long)b * p.h * p.w_in * p.cin;
  r.ih0 = oh * p.stride - p.pad;
  r.iw0 = ow * p.stride - p.pad;
  return r;
}

// the element offset in x of (row origin, k), or -1 for padding and k >= K
__device__ __forceinline__ long long gather_offset(const ConvArgs& p,
                                                   const RowOrigin& r,
                                                   int k) {
  if (!r.valid || k >= p.k) return -1;
  const int tap = k / p.cin;
  const int ci = k - tap * p.cin;
  const int kh = tap / p.kw;
  const int ih = r.ih0 + kh;
  const int iw = r.iw0 + (tap - kh * p.kw);
  if (ih < 0 || ih >= p.h || iw < 0 || iw >= p.w_in) return -1;
  return r.base + ((long long)ih * p.w_in + iw) * p.cin + ci;
}

template <int BN, typename T, bool VEC>
struct Loader;

// VEC: 16-channel chunks; A: rows tid / 4 and tid / 4 + 64, chunk tid % 4;
// B: chunk tasks tid + 256 i, row task / 4, chunk task % 4
template <int BN, typename T>
struct Loader<BN, T, true> {
  static constexpr int kBTasks = BN * 4 / kThreads;
  RowOrigin rows[2];
  Chunk<T> a[2];
  bool a_ok[2];
  uint4 b[kBTasks];

  __device__ void init(const ConvArgs& p, int m0) {
    const int r = threadIdx.x >> 2;
    rows[0] = row_origin(p, m0 + r);
    rows[1] = row_origin(p, m0 + r + 64);
  }

  __device__ void load(const ConvArgs& p, int n0, int k0) {
    const int c = threadIdx.x & 3;
    const T* x = static_cast<const T*>(p.x);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long off = gather_offset(p, rows[i], k0 + c * 16);
      a_ok[i] = off >= 0;
      if (a_ok[i]) {
        const uint4* src = reinterpret_cast<const uint4*>(x + off);
#pragma unroll
        for (int v = 0; v < Chunk<T>::kVecs; ++v) a[i].v[v] = src[v];
      }
    }
#pragma unroll
    for (int i = 0; i < kBTasks; ++i) {
      const int task = threadIdx.x + i * kThreads;
      const int n = n0 + (task >> 2);
      const int k = k0 + (task & 3) * 16;
      const int8_t* src = p.w + (long long)n * p.k + k;
      b[i] = (n < p.n && k < p.k) ? *reinterpret_cast<const uint4*>(src)
                                  : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(const ConvArgs& p, uint8_t* as, uint8_t* bs) const {
    const int c = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 q = make_uint4(0, 0, 0, 0);
      if (a_ok[i]) {
        float f[16];
        chunk_values(a[i], f);
        q.x = pack4(quant(f[0], p.inv_sx), quant(f[1], p.inv_sx),
                    quant(f[2], p.inv_sx), quant(f[3], p.inv_sx));
        q.y = pack4(quant(f[4], p.inv_sx), quant(f[5], p.inv_sx),
                    quant(f[6], p.inv_sx), quant(f[7], p.inv_sx));
        q.z = pack4(quant(f[8], p.inv_sx), quant(f[9], p.inv_sx),
                    quant(f[10], p.inv_sx), quant(f[11], p.inv_sx));
        q.w = pack4(quant(f[12], p.inv_sx), quant(f[13], p.inv_sx),
                    quant(f[14], p.inv_sx), quant(f[15], p.inv_sx));
      }
      const int r = (threadIdx.x >> 2) + 64 * i;
      *reinterpret_cast<uint4*>(as + r * kRow + c * 16) = q;
    }
#pragma unroll
    for (int i = 0; i < kBTasks; ++i) {
      const int task = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(bs + (task >> 2) * kRow + (task & 3) * 16) =
          b[i];
    }
  }
};

// scalar: A row tid / 2, k (tid % 2) * 32 + [0, 32); B row tid / (256 / BN),
// k (tid % (256 / BN)) * BN / 4 + [0, BN / 4)
template <int BN, typename T>
struct Loader<BN, T, false> {
  static constexpr int kBPerRow = kThreads / BN;  // threads a B row
  static constexpr int kBElems = kBK / kBPerRow;  // k a thread of B
  RowOrigin row;
  uint32_t a[8];
  uint32_t b[kBElems / 4];

  __device__ void init(const ConvArgs& p, int m0) {
    row = row_origin(p, m0 + (threadIdx.x >> 1));
  }

  __device__ void load(const ConvArgs& p, int n0, int k0) {
    const T* x = static_cast<const T*>(p.x);
    const int ka = k0 + (threadIdx.x & 1) * 32;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long off = gather_offset(p, row, ka + 4 * j + e);
        q[e] = off >= 0 ? quant(ld_elem(x + off), p.inv_sx) : 0;
      }
      a[j] = pack4(q[0], q[1], q[2], q[3]);
    }
    const int n = n0 + threadIdx.x / kBPerRow;
    const int kb = k0 + (threadIdx.x % kBPerRow) * kBElems;
#pragma unroll
    for (int j = 0; j < kBElems / 4; ++j) {
      int q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kb + 4 * j + e;
        q[e] = (n < p.n && k < p.k) ? int(p.w[(long long)n * p.k + k]) : 0;
      }
      b[j] = pack4(q[0], q[1], q[2], q[3]);
    }
  }

  __device__ void store(const ConvArgs&, uint8_t* as, uint8_t* bs) const {
    uint32_t* ra = reinterpret_cast<uint32_t*>(
        as + (threadIdx.x >> 1) * kRow + (threadIdx.x & 1) * 32);
#pragma unroll
    for (int j = 0; j < 8; ++j) ra[j] = a[j];
    uint32_t* rb = reinterpret_cast<uint32_t*>(
        bs + (threadIdx.x / kBPerRow) * kRow +
        (threadIdx.x % kBPerRow) * kBElems);
#pragma unroll
    for (int j = 0; j < kBElems / 4; ++j) rb[j] = b[j];
  }
};

template <int BN, typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const ConvArgs p) {
  constexpr int kWarpsN = BN / 32;
  constexpr int kWM = kBM / (8 / kWarpsN);  // rows a warp
  constexpr int kMT = kWM / 16;             // m16 tiles a warp
  constexpr int kNT = 4;                    // n8 tiles a warp (32 columns)
  __shared__ __align__(16) uint8_t smem_a[2][kBM * kRow];
  __shared__ __align__(16) uint8_t smem_b[2][BN * kRow];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / kWarpsN) * kWM;
  const int wn = (warp % kWarpsN) * 32;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  Loader<BN, T, VEC> ld;
  ld.init(p, m0);
  const int steps = (p.k + kBK - 1) / kBK;
  ld.load(p, n0, 0);
  ld.store(p, smem_a[0], smem_b[0]);
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) ld.load(p, n0, (s + 1) * kBK);
    const uint8_t* as = smem_a[cur];
    const uint8_t* bs = smem_b[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint8_t* pa = as + (wm + i * 16 + g) * kRow + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(pa);
        af[i][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint8_t* pb = bs + (wn + j * 8 + g) * kRow + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(pb);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (s + 1 < steps) ld.store(p, smem_a[cur ^ 1], smem_b[cur ^ 1]);
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= p.n) continue;
    float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (!p.raw) {
      s0 = p.scale[col];
      s1 = p.scale[col + 1];
      b0 = p.bias[col];
      b1 = p.bias[col + 1];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + g + 8 * half;
        if (row >= p.m) continue;
        const int c0 = acc[i][j][2 * half];
        const int c1 = acc[i][j][2 * half + 1];
        const long long o = (long long)row * p.n + col;
        if (p.raw) {
          *reinterpret_cast<int2*>(static_cast<int*>(p.out) + o) =
              make_int2(c0, c1);
        } else {
          float y0 = __fadd_rn(__fmul_rn(__int2float_rn(c0), s0), b0);
          float y1 = __fadd_rn(__fmul_rn(__int2float_rn(c1), s1), b1);
          if (p.relu) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

template <int BN, typename T>
cudaError_t launch(const ConvArgs& p, cudaStream_t st) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.n + BN - 1) / BN);
  if (p.cin % 16 == 0)
    conv_s8_kernel<BN, T, true><<<grid, kThreads, 0, st>>>(p);
  else
    conv_s8_kernel<BN, T, false><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C_in) bf16 (x_is_f32 0) or f32, NHWC, 16-byte aligned; w
// (C_out, KH, KW, C_in) int8; scale, bias (C_out,) f32 (unused with raw);
// out (B, Ho, Wo, C_out): bf16 y = f32(acc) * scale + bias [ReLU], or the
// s32 sums with raw. C_out % 8 == 0; bn: the tile's columns, 64 or 128.
extern "C" int ieee_conv_s8(const void* x, int x_is_f32, const void* w,
                            const void* scale, const void* bias, void* out,
                            int batch, int h, int w_in, int cin, int cout,
                            int kh, int kw, int stride, int pad, int ho,
                            int wo, float inv_sx, int relu, int raw, int bn,
                            void* stream) {
  if (batch <= 0 || ho <= 0 || wo <= 0) return 0;
  if (cin <= 0 || cout <= 0 || cout % 8 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.h = h;
  p.w_in = w_in;
  p.cin = cin;
  p.ho = ho;
  p.wo = wo;
  p.n = cout;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.m = batch * ho * wo;
  p.k = kh * kw * cin;
  p.inv_sx = inv_sx;
  p.relu = relu;
  p.raw = raw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    return static_cast<int>(bn == 64 ? launch<64, float>(p, st)
                                     : launch<128, float>(p, st));
  return static_cast<int>(bn == 64 ? launch<64, __nv_bfloat16>(p, st)
                                   : launch<128, __nv_bfloat16>(p, st));
}
