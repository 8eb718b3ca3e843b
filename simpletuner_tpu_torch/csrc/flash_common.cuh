// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async tile loads into padded shared memory, the bf16
// mma.sync m16n8k16 product, ldmatrix, bf16 packing and quad reductions.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): {A[g][2t..2t+1]}, {A[g+8][2t..]}, {A[g][2t+8..]}, {A[g+8][2t+8..]}
//   B (16x8, col-major):  {B[2t..2t+1][g]}, {B[2t+8..2t+9][g]}
//   C (16x8, f32):        C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
// A tile held in shared memory as rows of a row-major (rows, D) matrix
// serves as A directly, as B "non-transposed" when its rows are the product's
// n index (S = Q K^T reads K so), and through ldmatrix.trans as B when its rows
// are the contraction index (P V reads V so).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int SEGMENT_PAD_ID = -1;
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows padded by 8 elements (16 bytes): fragment loads are bank-conflict free
// and every ldmatrix row address stays 16-byte aligned
template <int D>
struct Row {
  static constexpr int STRIDE = D + 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte async copy; src_size 0 fills the destination with zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&pair);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// rows [row0, row0 + ROWS) of a (rows, D) matrix with row stride `stride`
// into shared memory with row stride D + 8; rows at or past `nrows` are
// zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t stride, int row0,
                                          int nrows, int tid) {
  constexpr int CHUNKS_PER_ROW = D / 8;
  constexpr int CHUNKS = ROWS * CHUNKS_PER_ROW;
  static_assert(CHUNKS % NUM_THREADS == 0, "tile must split evenly over the CTA");
#pragma unroll
  for (int i = 0; i < CHUNKS / NUM_THREADS; ++i) {
    const int chunk = tid + i * NUM_THREADS;
    const int r = chunk / CHUNKS_PER_ROW;
    const int col = (chunk % CHUNKS_PER_ROW) * 8;
    const int row = row0 + r;
    const bool valid = row < nrows;
    const bf16* from = valid ? src + (int64_t)row * stride + col : src;
    cp_async_16(dst + r * Row<D>::STRIDE + col, from, valid);
  }
}

// A fragment of rows [16 * warp_row, +16) x cols [16 * kk, +16) of a tile in
// shared memory with row stride STRIDE
template <int STRIDE>
__device__ __forceinline__ void load_a_frag(uint32_t* a, const bf16* rows16, int kk, int g, int t) {
  a[0] = load_u32(rows16 + g * STRIDE + kk * 16 + t * 2);
  a[1] = load_u32(rows16 + (g + 8) * STRIDE + kk * 16 + t * 2);
  a[2] = load_u32(rows16 + g * STRIDE + kk * 16 + 8 + t * 2);
  a[3] = load_u32(rows16 + (g + 8) * STRIDE + kk * 16 + 8 + t * 2);
}

// B fragment for n-tile nt (8 rows of the tile) x k-slice kk of the depth:
// B[k][n] = tile[nt * 8 + n][kk * 16 + k]
template <int STRIDE>
__device__ __forceinline__ void load_b_frag(uint32_t* b, const bf16* tile, int nt, int kk, int g,
                                            int t) {
  const bf16* row = tile + (nt * 8 + g) * STRIDE + kk * 16 + t * 2;
  b[0] = load_u32(row);
  b[1] = load_u32(row + 8);
}

// two B fragments (n-tiles 2 dp and 2 dp + 1 of the depth) for the k-slice
// of rows [16 kk, +16) of a row-major tile: B[k][n] = tile[16 kk + k][16 dp + n]
template <int STRIDE>
__device__ __forceinline__ void load_b_frag_trans(uint32_t* b, const bf16* tile, int kk, int dp,
                                                  int lane) {
  const int mat = lane >> 3;
  const int mat_row = lane & 7;
  ldmatrix_x4_trans(b, tile + (kk * 16 + (mat & 1) * 8 + mat_row) * STRIDE + dp * 16 + (mat >> 1) * 8);
}

// the f32 accumulator of a 16 x (16 (kk + 1)) product, re-packed as the bf16
// A fragment of its k-slice kk
template <int N>
__device__ __forceinline__ void pack_a_frag(uint32_t* a, const float (&acc)[N][4], int kk) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the mask of the Pallas kernels: attend(i, j) = q_seg[i] == kv_seg[j] && kv_seg[j] != PAD
__device__ __forceinline__ bool attends(int q_id, int kv_id) {
  return q_id == kv_id && kv_id != SEGMENT_PAD_ID;
}

// segment id of position `pos` of a sequence of `len`: SEGMENT_PAD_ID past
// the end, 0 without ids
__device__ __forceinline__ int segment_id(const int32_t* ids, int b, int len, int pos) {
  return pos >= len ? SEGMENT_PAD_ID : (ids ? ids[(int64_t)b * len + pos] : 0);
}

}  // namespace flash
