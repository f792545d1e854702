// The 64-row tile shared by the flash kernels (flash_attention.cu, through
// sm90_tile.cuh) and the roofline's microkernels (attention_components.cu):
// the tile size, bf16 packing, and the max and sum over the four lanes that
// hold one row of an accumulator (an mma.sync C fragment and a wgmma
// accumulator spread a row the same way).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // rows per warpgroup tile and per inner-loop tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max and sum over the four lanes (t = 0..3) that hold one row of an accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
