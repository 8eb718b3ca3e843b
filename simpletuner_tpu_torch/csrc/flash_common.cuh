// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the mask semantics, bf16 packing and the reductions over
// the quad of lanes that shares an accumulator row.  The TMA and wgmma
// building blocks are in hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int SEGMENT_PAD_ID = -1;
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&pair);
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
