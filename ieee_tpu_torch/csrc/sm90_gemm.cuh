// Hopper (sm_90a) building blocks for hand-written matrix products: TMA
// tile loads into 128-byte-swizzled shared tiles counted in by mbarriers
// (a ring of stages, with waits bounded in time), producer/consumer warp
// specialisation (setmaxnreg), ldmatrix fragment loads, and wgmma
// m64n256k16 and m64n64k16 with A from registers (the RS form) or from a
// K-major shared tile (the SS form) and B from shared memory through a
// matrix descriptor, f32 accumulators in registers; the block shape the
// products share (a producer and two consumer warpgroups over 128 rows)
// and its bf16 row epilogue (store_rows); on the host, the 2D tensor maps
// the TMA loads read.
//
// Shared tiles use the 128-byte swizzle that wgmma reads natively
// (descriptor layout B128) and that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: a tile is made of 128-byte rows; in each
// group of 8 rows (a 1024-byte atom) the 16-byte chunk j of row r sits at
// chunk position j ^ (r % 8). The swizzle acts on address bits 4-6 against
// bits 7-9, so every tile starts on a 1024-byte boundary. The same layout
// keeps ldmatrix conflict-free: the 8 row addresses of one 8x8 matrix fall
// on 8 different chunk positions.
//
// Operand layouts (bf16); an SS-form A is a K-major tile of 64 rows:
//   - K-major (the reduction dimension contiguous, trans-b 0): rows are
//     the N index, 64 reduction values per 128-byte row; 8-row atoms 1024
//     bytes apart (SBO); a k16 step advances the start address by 32
//     bytes inside the row.
//   - MN-major (N contiguous, trans-b 1): rows are the reduction index,
//     64 consecutive N values per 128-byte row; 8-row atoms 1024 bytes
//     apart (SBO); the next 64 N values lie LBO bytes further (a block of
//     all the tile's rows, one TMA box); a k16 step advances the start by
//     16 rows.
//
// The register A fragment of wgmma m64nNk16 is, per warp of the
// warpgroup (rows 16w..16w+15), mma.sync m16n8k16's A layout: a0 (row
// lane/4, columns 2(lane%4), +1), a1 the same 8 rows below, a2 and a3 the
// same 8 columns to the right. ldmatrix.x4 with lanes 0-7, 8-15, 16-23,
// 24-31 addressing (rows 0-7, col 0), (rows 8-15, col 0), (rows 0-7, col
// 8), (rows 8-15, col 8) of a row-major 16x16 tile returns exactly that;
// with .trans on a tile stored the other way round it returns the
// fragment of the transpose. The accumulator of m64n256 holds, for each
// 8-column chunk i, d[4i], d[4i+1] at (row lane/4, columns 8i + 2(lane%4),
// +1) and d[4i+2], d[4i+3] 8 rows below.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "wait_report.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of 128-byte row `row` (rows
// consecutive) in a 128-byte-swizzled tile; chunk may exceed 7 for rows
// wider than 128 bytes (only its low 3 bits are swizzled)
__device__ __forceinline__ uint32_t sw128(int row, int chunk, int pitch) {
  return static_cast<uint32_t>(row * pitch + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the dynamic shared memory base aligned up to 1024 bytes (the swizzle's
// atom), as a shared address and a generic pointer
struct Smem {
  uint32_t base;
  uint8_t* ptr;
};

__device__ __forceinline__ Smem aligned_smem(uint8_t* raw_ptr) {
  const uint32_t raw = smem_u32(raw_ptr);
  const uint32_t base = (raw + 1023u) & ~1023u;
  return {base, raw_ptr + (base - raw)};
}

// --- the block of the warp-specialised products ----------------------------
// a producer warpgroup (one thread issues TMA) and two consumer warpgroups,
// each consumer running wgmma on 64 of the block's 128 rows
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;  // 128*56 + 256*224 <= 65536
constexpr int kBK = 64;             // reduction step: one 128-byte row of bf16
constexpr int kRows = 128;          // rows of a tile (two m64)

// the bf16 row pitch of store_rows's shared tile, 64 nb columns wide (+8:
// no bank conflicts)
__host__ __device__ constexpr int rows_pitch(int nb) { return 64 * nb + 8; }

// --- mbarriers and warp specialisation --------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes barrier initialisation visible before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrives on `bar` and adds `bytes` to the transaction count its phase
// waits for (the TMA copies that follow complete it)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// the wait's bound: a phase that has not completed after this many
// nanoseconds of the global timer never will (a wrong expected byte count or
// parity); every legitimate wait of these kernels lasts microseconds
constexpr uint64_t kWaitBoundNs = 1000000000ull;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that times out is reported from the host: the kernels hold no
// call (printf is one), since any call in a kernel that issues wgmma makes
// ptxas serialise its wgmmas (its note C7510; 7% of mm_stats's time at the
// layer4 sites on an H100, PERF.md §6). The first thread of the unit's
// kernels to time out writes a WaitReport (wait_report.cuh) into
// page-locked host memory mapped into the device, and every timed-out
// thread traps; the host prints the record (wait_report.cu; ops/_build.py
// at the process's exit).

// the record in host memory (set by allow_smem before the unit's first
// launch; null until then), and the flag that elects its one writer
static __device__ WaitReport* g_wait_report;
static __device__ uint32_t g_wait_claimed;

// the first timed-out thread writes the record and traps; the others wait
// for its trap (trapping at once could cut its writes short)
__device__ __forceinline__ void wait_timed_out(uint32_t bar,
                                               uint32_t parity) {
  WaitReport* r = g_wait_report;
  if (r != nullptr) {
    if (atomicCAS(&g_wait_claimed, 0u, 1u) != 0u)
      for (;;) __nanosleep(1000);
    volatile WaitReport* v = r;
    v->block[0] = blockIdx.x;
    v->block[1] = blockIdx.y;
    v->block[2] = blockIdx.z;
    v->thread = threadIdx.x;
    v->bar = bar;
    v->parity = parity;
    __threadfence_system();
    v->set = 1;
    __threadfence_system();
  }
  __trap();
}

// waits until the phase of parity `parity` of `bar` has completed; past
// kWaitBoundNs it records the block, the barrier and the parity and traps,
// so a ring that can never fill fails its launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kWaitBoundNs) wait_timed_out(bar, parity);
}

// A ring of STAGES stages at `base` (each stage_bytes), then the full[s]
// mbarriers (the producer's expected bytes; TMA completes them) and the
// empty[s] ones (every consumer warp arrives once the wgmmas that read the
// stage have completed). Step t of a loop uses slot t % STAGES; its full
// phase has parity (t / STAGES) & 1, and the producer's wait on the slot's
// empty barrier the opposite one (the first round passes: the parity of
// the phase before the first).
template <int STAGES>
struct Ring {
  static constexpr int kBarrierBytes = 2 * STAGES * 8;
  uint32_t full, empty;
  __device__ Ring(uint32_t base, uint32_t stage_bytes)
      : full(base + STAGES * stage_bytes), empty(full + STAGES * 8) {}
  __device__ uint32_t full_bar(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return empty + 8 * s; }
  // thread 0 initialises the barriers (empty ones for `consumer_warps`
  // arrivals), then the block syncs
  __device__ void init(int consumer_warps) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full_bar(s), 1);
        mbar_init(empty_bar(s), consumer_warps);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }
};

// --- TMA --------------------------------------------------------------------

// a 2D box of `map` at element coordinates (x inner, y outer) into shared
// memory at `dst`; its bytes count towards `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// orders this thread's generic-proxy writes to shared memory before the
// async proxy's later accesses to it (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma matrix descriptor of a 128-byte-swizzled shared tile at `addr`
// (bits 0-13 address >> 4, 16-29 LBO >> 4, 32-45 SBO >> 4, 62-63 layout 1 =
// 128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 256 per warpgroup, f32) += A (64 x 16, bf16 fragments a) * B
// (16 x 256, bf16 in shared memory, descriptor b); TRANS_B 0 for a K-major
// B tile, 1 for an MN-major one
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// d (64 x 64 per warpgroup, f32) += A (64 x 16, bf16 fragments a) * B
// (16 x 64, descriptor b); the accumulator layout is m64n256's first 32
// registers
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// d (64 x 256 per warpgroup, f32) += A (64 x 16, bf16 in shared memory,
// K-major, descriptor a) * B (16 x 256, descriptor b); the SS form of
// wgmma_m64n256k16_rs, no registers spent on A
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128],
                                                    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B));
}

// d (64 x 64 per warpgroup, f32) += A (64 x 16, K-major in shared memory,
// descriptor a) * B (16 x 64, descriptor b): the SS form of
// wgmma_m64n64k16_rs
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B));
}

// the two bf16 of a packed pair as f32 (low half first)
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// two f32 rounded to nearest-even bf16, packed low first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the epilogue's bf16 rows of a block's 128 x 64 NB tile: f(acc, column in
// the tile) of each m64n(64 NB) accumulator of the consumer threads into a
// shared tile at `smem` (both warpgroups must be done with what it
// overlays), then 16-byte chunks of the rows inside (n, c) to out, whose
// rows are c wide
template <int NB, class F>
__device__ __forceinline__ void store_rows(const float (&acc)[32 * NB], F f,
                                           uint8_t* smem, __nv_bfloat16* out,
                                           int row0, int col0, int n, int c) {
  constexpr int kPitch = rows_pitch(NB);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = lane & 3;
  // this thread's rows of the tile (the accumulator's lane/4 and 8 below)
  const int tr = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
  for (int i = 0; i < 8 * NB; ++i) {  // 8-column chunks
    const int col = 8 * i + 2 * q;
    tile[(tr * kPitch + col) / 2] =
        pack_bf16(f(acc[4 * i], col), f(acc[4 * i + 1], col + 1));
    tile[((tr + 8) * kPitch + col) / 2] =
        pack_bf16(f(acc[4 * i + 2], col), f(acc[4 * i + 3], col + 1));
  }
  named_sync(1, kConsumers);
  constexpr int kChunks = 8 * NB;  // 16-byte chunks of a row
  for (int u = tid; u < kRows * kChunks; u += kConsumers) {
    const int r = u / kChunks, ch = (u % kChunks) * 8;
    if (row0 + r < n && col0 + ch < c)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * c + col0 + ch) =
          *reinterpret_cast<const uint4*>(smem + (r * kPitch + ch) * 2);
  }
}

// --- host: tensor maps --------------------------------------------------------

// cuTensorMapEncodeTiled lives in the driver library; fetch it through the
// runtime, so the kernels link without -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) matrix at `ptr` (row pitch cols elements) read in
// boxes of (box_rows, box_cols); elements outside the matrix read as zero.
// Returns false if the driver refuses (alignment, sizes).
inline bool tensor_map_2d(CUtensorMap* map, const void* ptr,
                          CUtensorMapDataType type, int elem_bytes,
                          uint64_t rows, uint64_t cols, uint32_t box_rows,
                          uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// points this unit's g_wait_report at the process's host record, which
// the first call of all allocates; once per unit
static cudaError_t arm_wait_report() {
  static bool armed = false;  // this unit's g_wait_report is set
  if (armed) return cudaSuccess;
  WaitReport*& host = wait_report_host();
  if (host == nullptr) {
    void* p = nullptr;
    const cudaError_t err =
        cudaHostAlloc(&p, sizeof(WaitReport), cudaHostAllocMapped);
    if (err != cudaSuccess) return err;
    memset(p, 0, sizeof(WaitReport));
    host = static_cast<WaitReport*>(p);
  }
  void* dev = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&dev, host, 0);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_wait_report, &dev, sizeof(dev));
  armed = err == cudaSuccess;
  return err;
}

// lets `kernel` take `bytes` of dynamic shared memory (above the 48 KB
// default), after arm_wait_report: every launch of a kernel that waits on
// mbarriers comes through here first
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  const cudaError_t err = arm_wait_report();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace sm90
