// Hopper (sm_90a) building blocks of the flash kernels (flash_attention.cu:
// fwd_kernel, dkv_kernel and dq_kernel): TMA tile loads through 3-D tensor
// maps, mbarrier rings, warpgroup matrix products (wgmma) with operands in
// 128-byte-swizzled shared memory, and register reallocation between a
// producer and its consumer warpgroups.  The roofline's product
// microkernels (attention_components.cu: qk_kernel, pv_kernel) run the same
// wgmma products on the same shared-memory layout.
//
// Element types: bf16 and f16 (the products are wgmma .f32.bf16.bf16 or
// .f32.f16.f16, the tensor maps BFLOAT16 or FLOAT16; `T` below, bf16 where
// a caller names none), both two bytes, so every layout below holds for
// both.
//
// Shared-memory tiles: TMA writes a box of R rows x 64 columns (128 bytes a
// row) with the 128-byte swizzle, so 16-byte chunk c of row r lands at
// r * 128 + ((c ^ (r % 8)) * 16), from a 1024-byte-aligned base.  A head
// dim of 128 is two such boxes side by side (columns 0-63, then 64-127),
// R * 128 bytes apart, and 256 four.  wgmma reads the same layout through
// a descriptor:
//   K-major (the contracted dim is the row's 64 columns: Q.K^T, dO.V^T,
//   K.Q^T, V.dO^T): start + 32 bytes per 16-column step, 8-row groups 1024
//   bytes apart (SBO); steps 4-7 of D = 128 start in the second box, and
//   so on for D = 256.
//   MN-major (the contracted dim runs down the rows: P.V, dS.K, P^T.dO,
//   dS^T.Q): start + 2048 bytes per 16-row step, 8-row groups 1024 bytes
//   apart (SBO), 64-column boxes R * 128 bytes apart (LBO), and the
//   transpose bit set.

#pragma once

#include <cuda.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace {

typedef __half f16;

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values rounded to T and packed, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, f16>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Round up to the 1024-byte alignment of the 128-byte swizzle.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

// One box of a [BH, T, D] tensor map (innermost first: column c, row r,
// head h) into shared memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c,
                                         int r, int h, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(h), "r"(smem_u32(bar))
      : "memory");
}

// Every 64-column box of rows [r, r + rows) of head h: D / 64 boxes of
// rows x 128 bytes, one after the other from dst.
template <int D>
__device__ __forceinline__ void tma_load_rows(unsigned char* dst, const CUtensorMap* map,
                                              int rows, int r, int h, uint64_t* bar) {
#pragma unroll
  for (int half = 0; half < D / 64; ++half)
    tma_load(dst + half * rows * 128, map, half * 64, r, h, bar);
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// K-major operand: 16-column step kk of a tile of `rows` rows at `base`.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t base, int rows, int kk) {
  return smem_desc(base + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: 16-row step kk of a tile of `rows` rows at `base`.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t base, int rows, int kk) {
  return smem_desc(base + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most kPending committed groups are still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Columns 16kk..16kk+15 of a 64-row wgmma accumulator, rounded to T and
// laid out as the register A operand of the next product (thread by thread,
// the accumulator's n-tiles 2kk and 2kk+1 are the A fragment).
template <typename T = bf16, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack2<T>(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
}

template <int kRegs>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// The accumulator operands of a 64 x 64 and a 64 x 128 product.
#define BF_ACC32_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define BF_ACC32(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define BF_ACC64_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define BF_ACC64(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),\
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),\
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// Each product's asm is written once, as a macro over the wgmma type
// suffix; BF_WGMMA_TYPED(T, ASM) expands ASM with T's.
#define BF_WGMMA_TYPED(T, ASM) \
  if constexpr (std::is_same_v<T, f16>) ASM(".f16.f16"); else ASM(".bf16.bf16")

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major.
#define BF_WGMMA_SS_N64(TYPES)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                     \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32" TYPES " " BF_ACC32_REGS \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                 \
               : BF_ACC32(d)                                                     \
               : "l"(da), "l"(db), "r"(accumulate))
template <typename T = bf16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  BF_WGMMA_TYPED(T, BF_WGMMA_SS_N64);
}

// D (64 x N, f32) += A (64 x 16, registers) . B (16 x N, smem, MN-major),
// N = the head dim.  N = 256 is two N = 128 products, the second on the
// descriptor moved two 64-column boxes on (its LBO apart each).
#define BF_WGMMA_RS_N64(TYPES)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                     \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32" TYPES " " BF_ACC32_REGS \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                   \
               : BF_ACC32(d)                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define BF_WGMMA_RS_N128(TYPES)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32" TYPES " " BF_ACC64_REGS \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                    \
               : BF_ACC64(d)                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <int D, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128 or 256");
  if constexpr (D == 256) {
    const uint64_t lbo = ((db >> 16) & 0x3FFF) << 4;
    wgmma_rs<128, T>(*reinterpret_cast<float(*)[64]>(&d[0]), a, db);
    wgmma_rs<128, T>(*reinterpret_cast<float(*)[64]>(&d[64]), a, db + ((2 * lbo) >> 4));
  } else if constexpr (D == 64) {
    BF_WGMMA_TYPED(T, BF_WGMMA_RS_N64);
  } else {
    BF_WGMMA_TYPED(T, BF_WGMMA_RS_N128);
  }
}
#undef BF_WGMMA_SS_N64
#undef BF_WGMMA_RS_N64
#undef BF_WGMMA_RS_N128
#undef BF_WGMMA_TYPED

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library; the runtime hands
// out its entry point, so nothing links against libcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Let `kernel` take `smem` bytes of dynamic shared memory (above 48 KB only
// so).  0 or the CUDA error.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// out[0] = resident blocks per SM, out[1] = dynamic shared memory bytes,
// out[2] = registers per thread, out[3] = threads per block, of one kernel
// as its launcher launches it.
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int threads, int* out) {
  int err = prepare(kernel, smem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = threads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem);
}

constexpr int kNoEncoder = -2;         // the driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 10000;   // + the CUresult of a refused encode

// A 3-D map of a contiguous [bh, t, d] T tensor (bf16 or f16) read in
// boxes of `rows` rows x 64 columns with the 128-byte swizzle.  Rows at or
// past t of a head read as zeros, never the next head's rows.  0 or an
// error code.
template <typename T>
inline int encode_rows_map(CUtensorMap* map, const void* ptr, int bh, int t, int d,
                           int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, f16> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

}  // namespace
