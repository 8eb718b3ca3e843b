// Hopper (sm_90a) building blocks of the flash-attention kernels, all built
// on TMA and wgmma (flash_fwd.cu, and the dq and dkv kernels of flash_bwd.cu):
//   * TMA: 4-D tensor maps over (batch, heads, seq, dim) bf16 views read
//     through their strides, boxes of `rows` x 64 columns (128 bytes) stored
//     with the 128-byte swizzle that wgmma descriptors read; rows past the
//     sequence are zero-filled by the hardware;
//   * mbarriers: transaction-counted "full" barriers that TMA completes and
//     thread-counted "empty" barriers the consumers arrive on;
//   * wgmma: m64nNk16 bf16 products with f32 accumulators, A from shared
//     memory (K-major) or from registers, B from shared memory (K-major for
//     a row-major tile whose columns are the contraction, MN-major for one
//     whose rows are); wgmma_ss / wgmma_rs pick the width N, and an N = 256
//     product (the head dim 256 accumulators) runs as two n128 halves;
//   * the tile schedule of the segment mask (tile_class, and the per-CTA
//     schedule_key_tiles of the forward and dq kernels), mirrored by
//     simpletuner_tpu_torch/ops/flash_attention.py::tile_schedule.
//
// A tile of R rows x D columns is stored as D / 64 column blocks of R x 64
// elements (R x 128 bytes, 1024-byte aligned); row r of a block starts at
// byte 128 r and its 16-byte chunks are permuted by the swizzle (chunk c of
// row r lands at c ^ (r % 8)).
//
// Accumulator layout of wgmma m64nNk16 (f32), thread `lane` of warp w of the
// warpgroup, g = lane / 4, t = lane % 4: d[4 i + e] holds row
// 16 w + g + 8 (e / 2), column 8 i + 2 t + (e % 2).  A bf16 A operand in
// registers for the k-slice [16 kk, 16 kk + 16) of such an accumulator is
// {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]},
// each pair packed low half first.  The host side needs no -lcuda: the
// tensor-map encoder is reached through cudaGetDriverEntryPoint.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace hopper {

// ---------------------------------------------------------------------------
// tile schedule of the segment mask
// ---------------------------------------------------------------------------

constexpr int TILE_SKIP = 0;   // no (i, j) of the tile pair attends
constexpr int TILE_FULL = 1;   // every (i, j) attends: no mask
constexpr int TILE_MIXED = 2;  // per-element mask

// q_lo, q_hi: min and max segment id over the query tile's rows (rows past
// the sequence count as SEGMENT_PAD_ID); kv_lo, kv_hi: min and max over the
// key tile's non-pad ids, n_valid of them out of `keys` (keys past the
// sequence are pad).
__host__ __device__ __forceinline__ int tile_class(int q_lo, int q_hi, int kv_lo, int kv_hi, int n_valid,
                                                   int keys) {
  if (n_valid == 0 || kv_hi < q_lo || kv_lo > q_hi) return TILE_SKIP;
  if (n_valid == keys && q_lo == q_hi && kv_lo == kv_hi && q_lo == kv_lo) return TILE_FULL;
  return TILE_MIXED;
}

// The schedule of a CTA that owns query rows [m0, m0 + ROWS) and streams key
// tiles of KEYS: each warp of the first ROWS threads reduces its query ids to
// a range in `bounds` (two ints per warp of shared memory), then every key
// tile is classed into `classes` (one byte per tile).  All THREADS threads of
// the CTA call it; the caller syncs before it reads `classes`.
template <int ROWS, int KEYS, int THREADS>
__device__ __forceinline__ void schedule_key_tiles(const int32_t* q_seg, const int32_t* kv_seg, int b, int sq,
                                                   int sk, int m0, int* bounds, uint8_t* classes) {
  static_assert(ROWS % 32 == 0 && ROWS <= THREADS && KEYS % 32 == 0, "whole warps per row and key block");
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  if (tid < ROWS) {
    const int id = flash::segment_id(q_seg, b, sq, m0 + tid);
    const int lo = __reduce_min_sync(0xffffffffu, id);
    const int hi = __reduce_max_sync(0xffffffffu, id);
    if (lane == 0) {
      bounds[2 * (tid / 32)] = lo;
      bounds[2 * (tid / 32) + 1] = hi;
    }
  }
  __syncthreads();
  int q_lo = bounds[0], q_hi = bounds[1];
#pragma unroll
  for (int w = 1; w < ROWS / 32; ++w) {
    q_lo = min(q_lo, bounds[2 * w]);
    q_hi = max(q_hi, bounds[2 * w + 1]);
  }
  const int n_tiles = (sk + KEYS - 1) / KEYS;
  for (int j = tid / 32; j < n_tiles; j += THREADS / 32) {
    int lo = 0x7fffffff, hi = -0x7fffffff - 1, n = 0;
#pragma unroll
    for (int r = 0; r < KEYS / 32; ++r) {
      const int id = flash::segment_id(kv_seg, b, sk, j * KEYS + r * 32 + lane);
      if (id != flash::SEGMENT_PAD_ID) {
        lo = min(lo, id);
        hi = max(hi, id);
        ++n;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) classes[j] = (uint8_t)tile_class(q_lo, q_hi, lo, hi, n, KEYS);
  }
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, fences, register reallocation
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase with the given parity has completed; a
// wait of more than about 10 s (2e10 cycles) traps, so a fault in the
// schedule ends the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000ll) {
      __trap();
    }
  }
}

// one box of a 4-D tensor map at coordinates (col, row, head, batch) into
// shared memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                                            int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// 2^x on the special-function unit (relative error about 2^-22; -inf and
// large negative x give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barriers (0 is __syncthreads'): sync waits until `count` threads
// have arrived, arrive counts this thread without waiting
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int REGS>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4);
  desc |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  desc |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  desc |= (uint64_t)1 << 62;
  return desc;
}

// K-major operand (rows = the M or N index, columns = the contraction):
// k-slice kk (16 columns) of a tile starting at row block `row_byte` (128 B
// per row) of its column block kk / 4
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, uint32_t row_byte, int kk) {
  return smem_desc(tile + (kk / 4) * ROWS * 128 + row_byte + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (rows = the contraction, columns = the N index): k-slice
// kk (16 rows) of a tile of ROWS rows; the column blocks are ROWS * 128
// bytes apart
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 32, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 32, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x N, f32) (+)= A (64 x 16, smem, K-major) * B (16 x N, smem, K-major), N in {32, 64, 128}
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, desc_a, desc_b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(N == 32, "wgmma_ss takes N = 32, 64 or 128");
    wgmma_ss_n32(d, desc_a, desc_b, accumulate);
  }
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, smem, MN-major):
// k-slice kk of a tile of ROWS rows whose first column block starts at
// `tile`, N in {64, 128, 256}.  N = 256 runs as two n128 products, over
// column blocks 0-1 into d[0, 64) and column blocks 2-3 into d[64, 128): the
// accumulator layout of each half is that of an n128 product.
template <int N, int ROWS>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint32_t tile, int kk) {
  if constexpr (N == 256) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, desc_mn_major<ROWS>(tile, kk));
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, desc_mn_major<ROWS>(tile + 2 * ROWS * 128, kk));
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_mn_major<ROWS>(tile, kk));
  } else {
    static_assert(N == 64, "wgmma_rs takes N = 64, 128 or 256");
    wgmma_rs_n64(d, a, desc_mn_major<ROWS>(tile, kk));
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault,
                                                       &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(entry);
  }
  return fn;
}

// tensor map of a (batch, heads, seq, dim) bf16 view with the given element
// strides (unit stride on dim), boxes of `box_rows` rows x 64 columns
inline cudaError_t make_tensor_map(CUtensorMap* map, const void* base, int batch, int heads, int seq, int dim,
                                   int64_t s_batch, int64_t s_head, int64_t s_seq, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the stride of a size-1 dimension is never used; keep it valid for the encoder
  if (heads == 1) s_head = s_seq * seq;
  if (batch == 1) s_batch = s_head * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)seq, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_seq * 2, (cuuint64_t)s_head * 2, (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t element_strides[4] = {1, 1, 1, 1};
  const CUresult result =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, element_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return result == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
