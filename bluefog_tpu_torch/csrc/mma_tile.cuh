// Tile and fragment helpers of the roofline's microkernels
// (attention_components.cu): 64-row tiles, 128-thread blocks of four warps
// of 16 rows, mma.sync.m16n8k16 with bf16 operands and f32 accumulators,
// and rows spread over four lanes.  This is the port's first flash tile; no
// flash kernel runs it any more (flash_attention.cu is on wgmma through
// sm90_tile.cuh, which takes only the tile size, pack_bf16 and the quad
// reductions from here).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;    // rows per block tile and per inner-loop tile
constexpr int kWarps = 4;    // each warp owns 16 rows of the block tile
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A (16x16, row) * B (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: the 16x16 block of a row-major smem matrix at (r0, c0).
template <int S>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* m, int r0,
                                       int c0, int lane) {
  const bf16* p = m + (r0 + (lane >> 2)) * S + c0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * S);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * S + 8);
}

// B fragment with B[k][n] = m[n0 + n][c0 + k]: the matrix's rows are B's
// columns (q.K^T, dO.V^T and friends), so each register is one 32-bit load.
template <int S>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2], const bf16* m,
                                            int n0, int c0, int lane) {
  const bf16* p = m + (n0 + (lane >> 2)) * S + c0 + (lane & 3) * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = m[r0 + k][n0 + n] (p.V, dS.K, ...).
template <int S>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[2], const bf16* m,
                                            int r0, int n0, int lane) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(m);
  const int r = r0 + (lane & 3) * 2;
  const int n = n0 + (lane >> 2);
  b[0] = (uint32_t)u[r * S + n] | ((uint32_t)u[(r + 1) * S + n] << 16);
  b[1] = (uint32_t)u[(r + 8) * S + n] | ((uint32_t)u[(r + 9) * S + n] << 16);
}

// The C fragments of n-tiles 2kk and 2kk+1 (16 rows x 16 cols of f32),
// rounded to bf16 and laid out as the A fragment of the next product.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}


// Max and sum over the four lanes (t = 0..3) that hold one row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
