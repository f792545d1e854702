// Tile-component microkernels of the counted flash-attention roofline, for
// Hopper (sm_90a).
//
// Replaces the four Pallas bodies that benchmarks/attention_roofline.py times
// through _pallas_component (:69, one pl.pallas_call at :87):
//   qk_kernel<D>                <- qk_make  (:136)  scores q.k, [64,D] x [D,64]
//   pv_kernel<D>                <- pv_make  (:150)  p.v, [64,64] x [64,D]
//   softmax_chain_kernel        <- vpu_make (:167)  forward softmax chain
//   bwd_chain_kernel<cast_p>    <- bwd_component_times.make_rows (:221)
//
// Each computes what its Pallas body computes: `reps` repetitions of
//   acc <- 0.5 * acc + f(acc)
// on one 64 x 64 (or 64 x D) tile whose operands are staged once, before the
// loop, in shared memory or registers; the loop touches no device memory.
// f reads row 0 of acc back into an operand, so no repetition can be hoisted:
//   qk:      f = bf16(q + bf16(acc[0, j mod 64])) . k          (f32 accumulate)
//   pv:      f = p16 . bf16(v + bf16(acc[0, :]))               (f32 accumulate)
//   softmax: s = s0 + acc[0, :]; m = rowmax s; p = exp2(s - m); l = rowsum p;
//            f = bf16(p) + (m + l)
//   bwd:     p = exp2(s0 + acc[0, :] - 1.7); ds = p * (dp + 0.3);
//            f = bf16(ds) + (cast_p ? bf16(p) : p)
// For D = 128 the Pallas qk body is undefined (acc is only 64 wide); here
// column j of q takes acc[0, j mod 64].  With body = 0 the product or chain
// is left out and f is just the fed-back row plus 1: the cost of the
// dependency pass alone.
//
// What bounds each on the H100: qk and pv are tensor-core operations
// (2 * 64 * 64 * D flops a tile against 989 TFLOP/s bf16); the chains are
// SM issue, on whichever of the FP32, ALU (min, max, F2FP, shifts) and MUFU
// (ex2) pipes their instructions fill first
// (bluefog_tpu_torch/benchmarks/attention_roofline.py: tile_bound).
//
// All four time the flash kernels' own block (csrc/flash_attention.cu):
//   * The block.  One producer warpgroup and two consumer warpgroups
//     (384 threads, setmaxnreg 24/240, one block a SM by registers).  Each
//     consumer warpgroup repeats the component on its own 64-row tile and
//     writes its own slice of out, so a block computes two tiles, as a flash
//     block does.  The producer (for qk and pv after staging with the
//     others) gives its registers back: the loop reads no device memory, so
//     there is nothing to stream.
//   * The products.  qk is issue_qk's: wgmma m64n64k16 with q and k both
//     K-major in shared memory, in the 128-byte-swizzled 64-column boxes TMA
//     writes (sm90_tile.cuh); the two warpgroups' q copies sit in one
//     128-row tile as the forward's Q does, and D = 128 takes k-steps 4-7
//     from the second box.  pv is issue_pv's: p packed once from the f32
//     tile into the register A operand (acc_to_a), v MN-major in shared
//     memory, m64nDk16.
//   * The chains run on the wgmma accumulator's registers: s0 (and dp) are
//     loaded once into its layout, a row is spread over four lanes and
//     reduced with two shuffles, and exp2 is ex2.approx.ftz, as in the flash
//     kernels.
//   * The fed-back row.  Row 0 of a warpgroup's accumulator lives in its
//     warp 0 (lanes 0-3).  Every repetition publishes it to the warpgroup's
//     own ping-pong buffer and takes a named barrier (bar.sync 1 + w, 128),
//     which also orders the next repetition's publish after every read of
//     the other buffer.  qk and pv then rewrite each thread's share of the
//     warpgroup's own copy of the fed operand (q for qk, v for pv) from the
//     pristine values it keeps in registers plus the row, fence the
//     generic-proxy stores for the async proxy
//     (fence.proxy.async.shared::cta) and take the barrier again, so the
//     product reads the whole new copy.  The chains rewrite no shared-memory
//     operand and take the barrier once.  No block-wide barrier sits in the
//     loop.
//   * body = 0 keeps the publish, the barriers (and for qk and pv the
//     rewrite and the fence, whose memory clobber keeps the stores) and
//     drops the product or chain, so us - dep_us is the product or chain.
//
// Every block computes the same tiles: each writes [2 * blocks, 64, W] f32,
// slice 2b + w from warpgroup w of block b.
// The launch reserves max(need, smem) bytes of dynamic shared memory, so a
// caller can hold the blocks per SM to those of the flash kernel a component
// models.  Seconds per tile, device-wide, is then the slope of a launch's
// time over reps divided by the tiles computed.  Every launcher runs on the
// caller's stream, allocates nothing and returns the launch's error or
// cudaGetLastError().

#include <math.h>

#include "sm90_tile.cuh"

namespace {

constexpr int kBadArg = -1;

// The flash kernels' block (flash_attention.cu: kConsumers, kSm90Threads,
// kProducerRegs, kConsumerRegs; they stay there, where
// benchmarks/flash_variants.py rewrites them).
constexpr int kConsumers = 2;
constexpr int kBlockRows = 64 * kConsumers;
constexpr int kSm90Threads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// qk and pv: the wgmma tile
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk c (columns 8c..8c+7) of row r in a bf16 tile
// of R-row, 64-column boxes with the 128-byte swizzle, as TMA writes it.
__device__ __forceinline__ uint32_t swizzled(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Make this thread's generic-proxy stores to shared memory visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of consumer warpgroup w's 128 threads alone (id 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// A row-major [64, D] bf16 matrix into rows row0..row0+63 of a swizzled
// tile of R-row boxes, by all threads of the block.
template <int D, int R>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int row0, const bf16* src) {
  for (int i = threadIdx.x; i < kTile * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<uint4*>(tile + swizzled(row0 + r, c, R)) =
        *reinterpret_cast<const uint4*>(src + r * D + c * 8);
  }
}

// The transpose of a row-major [D, 64] bf16 matrix (row n of the tile holds
// column n of src) into a swizzled tile of 64-row boxes, by all threads.
template <int D>
__device__ __forceinline__ void stage_transposed(unsigned char* tile, const bf16* src) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(src);
  for (int i = threadIdx.x; i < kTile * D / 8; i += blockDim.x) {
    const int n = i % kTile, c = i / kTile;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = (uint32_t)u[(8 * c + 2 * e) * kTile + n] |
             ((uint32_t)u[(8 * c + 2 * e + 1) * kTile + n] << 16);
    *reinterpret_cast<uint4*>(tile + swizzled(n, c, kTile)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The fed operand's chunks a consumer thread owns (tid 0..127 of its
// warpgroup): column chunk tid % (D/8) of every (128 / (D/8))-th row from
// tid / (D/8); D / 16 chunks, 16 (D = 64) or 32 (D = 128) registers.
template <int D>
struct Owned {
  static constexpr int kChunks = D / 16, kCols = D / 8, kRowStep = 128 / kCols;
};

template <int D>
__device__ __forceinline__ void load_owned(uint4 (&mine)[D / 16], const bf16* src, int tid) {
  using O = Owned<D>;
#pragma unroll
  for (int i = 0; i < O::kChunks; ++i) {
    const int r = tid / O::kCols + i * O::kRowStep;
    mine[i] = *reinterpret_cast<const uint4*>(src + r * D + (tid % O::kCols) * 8);
  }
}

// This thread's share of the fed operand, rewritten in the tile (rows
// row0..row0+63, R-row boxes): bf16(pristine + bf16(fed[(8c + e) mod W])) for
// column 8c + e.
template <int D, int W, int R>
__device__ __forceinline__ void rewrite_owned(unsigned char* tile, int row0,
                                              const uint4 (&mine)[D / 16], const float* fed,
                                              int tid) {
  using O = Owned<D>;
  const int c = tid % O::kCols;
  const float4 a = *reinterpret_cast<const float4*>(fed + (8 * c) % W);
  const float4 b = *reinterpret_cast<const float4*>(fed + (8 * c) % W + 4);
  const uint32_t f0 = pack_bf16(a.x, a.y), f1 = pack_bf16(a.z, a.w);
  const uint32_t f2 = pack_bf16(b.x, b.y), f3 = pack_bf16(b.z, b.w);
#pragma unroll
  for (int i = 0; i < O::kChunks; ++i) {
    const int r = tid / O::kCols + i * O::kRowStep;
    const uint4 x = mine[i];
    *reinterpret_cast<uint4*>(tile + swizzled(row0 + r, c, R)) =
        make_uint4(add_bf16x2(x.x, f0), add_bf16x2(x.y, f1), add_bf16x2(x.z, f2),
                   add_bf16x2(x.w, f3));
  }
}

// A wgmma accumulator (64 x 2N) holds element (16 warp + g + 8h, 8j + 2t + i)
// in d[4j + 2h + i], g = lane / 4, t = lane % 4.  Row 0 (warp 0, lanes 0-3)
// into buf.
template <int N>
__device__ __forceinline__ void publish_row(float* buf, const float (&d)[N], int warp,
                                            int lane) {
  if (warp == 0 && lane < 4) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<float2*>(buf + 8 * j + 2 * lane) = make_float2(d[4 * j], d[4 * j + 1]);
  }
}

// The dependency pass alone: d <- 0.5 d + (fed + 1), fed = bf16(row[col])
// where the component feeds a bf16 operand (kRound: qk, pv), else row[col].
template <bool kRound, int N>
__device__ __forceinline__ void dep_pass(float (&d)[N], const float* row, int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(row + 8 * j + 2 * t);
    const float f0 = (kRound ? round_bf16(x.x) : x.x) + 1.f;
    const float f1 = (kRound ? round_bf16(x.y) : x.y) + 1.f;
    d[4 * j + 0] = fmaf(d[4 * j + 0], 0.5f, f0);
    d[4 * j + 1] = fmaf(d[4 * j + 1], 0.5f, f1);
    d[4 * j + 2] = fmaf(d[4 * j + 2], 0.5f, f0);
    d[4 * j + 3] = fmaf(d[4 * j + 3], 0.5f, f1);
  }
}

// A warpgroup's accumulator into out, a row-major [64, 2N] f32 tile.
template <int N>
__device__ __forceinline__ void store_acc(float* out, const float (&d)[N], int warp, int lane) {
  const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (row + 8 * h) * 2 * N + 8 * j + col) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

// q [64, D] bf16, k [D, 64] bf16 -> out [2 blocks, 64, 64] f32
template <int D>
struct QkSmem {
  static constexpr int kQ = kBlockRows * D * 2;  // both warpgroups' q copies
  static constexpr int kK = kTile * D * 2;       // k^T, shared
  static constexpr size_t kBytes = 1024 + kQ + kK + kConsumers * 2 * kTile * sizeof(float);
};

template <int D, bool kBody>
__global__ void __launch_bounds__(kSm90Threads, 1)
qk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, float* __restrict__ out,
          int reps) {
  using L = QkSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);  // warpgroup w's q in rows 64w..64w+63
  unsigned char* sk = sq + L::kQ;
  float* rows = reinterpret_cast<float*>(sk + L::kK);  // [warpgroup][2][64]

  for (int w = 0; w < kConsumers; ++w) stage_rows<D, kBlockRows>(sq, 64 * w, q);
  stage_transposed<D>(sk, k);
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: nothing to stream
    regs_release<kProducerRegs>();
    return;
  }
  regs_claim<kConsumerRegs>();
  const int w = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  uint4 mine[D / 16];
  load_owned<D>(mine, q, tid);
  const uint32_t q_addr = smem_u32(sq) + w * 64 * 128, k_addr = smem_u32(sk);
  float acc[32], s[32];
  zero(acc);
  zero(s);
  for (int r = 0; r < reps; ++r) {
    float* row = rows + (2 * w + (r & 1)) * kTile;
    publish_row(row, acc, warp, lane);
    wg_sync(w);
    rewrite_owned<D, kTile, kBlockRows>(sq, 64 * w, mine, row, tid);
    fence_async_smem();
    wg_sync(w);
    if constexpr (!kBody) {
      dep_pass<true>(acc, row, lane & 3);
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // issue_qk: kk = 0 overwrites s
        wgmma_ss_n64(s, desc_k_major(q_addr, kBlockRows, kk), desc_k_major(k_addr, kTile, kk),
                     kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], 0.5f, s[i]);
    }
  }
  store_acc(out + (size_t)(kConsumers * blockIdx.x + w) * kTile * kTile, acc, warp, lane);
}

// p16 [64, 64] bf16, v [64, D] bf16 -> out [2 blocks, 64, D] f32
template <int D>
struct PvSmem {
  static constexpr int kV = kTile * D * 2;  // one warpgroup's v copy
  static constexpr size_t kBytes = 1024 + kConsumers * kV + kConsumers * 2 * D * sizeof(float);
};

template <int D, bool kBody>
__global__ void __launch_bounds__(kSm90Threads, 1)
pv_kernel(const bf16* __restrict__ p16, const bf16* __restrict__ v, float* __restrict__ out,
          int reps) {
  using L = PvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sv = align_1024(smem_raw);  // warpgroup w's v at w * kV
  float* rows = reinterpret_cast<float*>(sv + kConsumers * L::kV);  // [warpgroup][2][D]

  for (int w = 0; w < kConsumers; ++w) stage_rows<D, kTile>(sv + w * L::kV, 0, v);
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: nothing to stream
    regs_release<kProducerRegs>();
    return;
  }
  regs_claim<kConsumerRegs>();
  const int w = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  unsigned char* my_v = sv + w * L::kV;
  uint4 mine[D / 16];
  load_owned<D>(mine, v, tid);
  // p as the forward holds it before P.V: an f32 accumulator, packed into
  // the register A operand (here once).
  uint32_t pa[4][4];
  {
    float p[32];
    const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p16 + (row + 8 * h) * kTile + 8 * j + col));
        p[4 * j + 2 * h] = x.x;
        p[4 * j + 2 * h + 1] = x.y;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], p, kk);
  }
  const uint32_t v_addr = smem_u32(my_v);
  float acc[D / 2];
  zero(acc);
  for (int r = 0; r < reps; ++r) {
    float* row = rows + (2 * w + (r & 1)) * D;
    publish_row(row, acc, warp, lane);
    wg_sync(w);
    rewrite_owned<D, D, kTile>(my_v, 0, mine, row, tid);
    fence_async_smem();
    wg_sync(w);
    if constexpr (!kBody) {
      dep_pass<true>(acc, row, lane & 3);
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= 0.5f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // issue_pv
        wgmma_rs<D>(acc, pa[kk], desc_mn_major(v_addr, kTile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
  store_acc(out + (size_t)(kConsumers * blockIdx.x + w) * kTile * D, acc, warp, lane);
}

// ---------------------------------------------------------------------------
// The chains: the same block, on the accumulator's registers
// ---------------------------------------------------------------------------

// A row-major [64, 2N] f32 tile into a warpgroup accumulator's layout (the
// inverse of store_acc).
template <int N>
__device__ __forceinline__ void load_acc(float (&d)[N], const float* src, int warp, int lane) {
  const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = *reinterpret_cast<const float2*>(src + (row + 8 * h) * 2 * N + 8 * j + col);
      d[4 * j + 2 * h] = x.x;
      d[4 * j + 2 * h + 1] = x.y;
    }
}

// Keeps the compiler from hoisting arithmetic on a loop-invariant operand.
__device__ __forceinline__ void opaque(float& x) { asm volatile("" : "+f"(x)); }

// Two values rounded to bf16 by one packed conversion (F2FP, as the flash
// kernels round p and dS for their products) and widened back to f32.
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  const uint32_t u = pack_bf16(a, b);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Both warpgroups' ping-pong rows: [warpgroup][2][64] f32.
constexpr size_t kChainSmem = kConsumers * 2 * kTile * sizeof(float);

// Forward softmax chain: s0 [64, 64] f32 -> out [2 blocks, 64, 64] f32
template <bool kBody>
__global__ void __launch_bounds__(kSm90Threads, 1)
softmax_chain_kernel(const float* __restrict__ s0, float* __restrict__ out, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rows = reinterpret_cast<float*>(smem_raw);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: nothing to stream
    regs_release<kProducerRegs>();
    return;
  }
  regs_claim<kConsumerRegs>();
  const int w = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t = lane & 3;
  float s0r[32], acc[32];  // the scores as the forward holds them after S = Q.K^T
  load_acc(s0r, s0, warp, lane);
  zero(acc);
  for (int r = 0; r < reps; ++r) {
    float* row = rows + (2 * w + (r & 1)) * kTile;
    publish_row(row, acc, warp, lane);
    wg_sync(w);
    if constexpr (!kBody) {
      dep_pass<false>(acc, row, t);
    } else {
      float s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(row + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[4 * j + i] = s0r[4 * j + i] + ((i & 1) ? x.y : x.x);
          m[i >> 1] = fmaxf(m[i >> 1], s[4 * j + i]);
        }
      }
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = ex2(s[e] - m[(e >> 1) & 1]);
        l[(e >> 1) & 1] += s[e];
      }
      const float ml[2] = {m[0] + quad_sum(l[0]), m[1] + quad_sum(l[1])};
#pragma unroll
      for (int e = 0; e < 32; e += 2) {  // columns 2t, 2t + 1 of one row
        const float2 p = round_bf16x2(s[e], s[e + 1]);
        acc[e] = fmaf(acc[e], 0.5f, p.x) + ml[(e >> 1) & 1];
        acc[e + 1] = fmaf(acc[e + 1], 0.5f, p.y) + ml[(e >> 1) & 1];
      }
    }
  }
  store_acc(out + (size_t)(kConsumers * blockIdx.x + w) * kTile * kTile, acc, warp, lane);
}

// Backward chain: s0, dp [64, 64] f32 -> out [2 blocks, 64, 64] f32.  The
// dK/dV kernel rounds both p and dS to bf16 (cast_p); the dQ kernel only dS.
template <bool kCastP, bool kBody>
__global__ void __launch_bounds__(kSm90Threads, 1)
bwd_chain_kernel(const float* __restrict__ s0, const float* __restrict__ dp,
                 float* __restrict__ out, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rows = reinterpret_cast<float*>(smem_raw);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: nothing to stream
    regs_release<kProducerRegs>();
    return;
  }
  regs_claim<kConsumerRegs>();
  const int w = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t = lane & 3;
  float s0r[32], dpr[32], acc[32];
  load_acc(s0r, s0, warp, lane);
  load_acc(dpr, dp, warp, lane);
  // s0 - 1.7 once: the exponent s0 + row - 1.7 then costs one FADD an
  // element, as the flash kernels' s * scale - lse costs one FFMA
#pragma unroll
  for (int e = 0; e < 32; ++e) s0r[e] -= 1.7f;
  zero(acc);
  for (int r = 0; r < reps; ++r) {
    float* row = rows + (2 * w + (r & 1)) * kTile;
    publish_row(row, acc, warp, lane);
    wg_sync(w);
    if constexpr (!kBody) {
      dep_pass<false>(acc, row, t);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(row + 8 * j + 2 * t);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; e += 2) {  // columns 2t, 2t + 1 of one row
          opaque(dpr[e]);  // dp + 0.3 stays in the loop, as dP is fresh per tile
          opaque(dpr[e + 1]);
          const float p0 = ex2(s0r[e] + x.x), p1 = ex2(s0r[e + 1] + x.y);
          const float2 ds = round_bf16x2(p0 * (dpr[e] + 0.3f), p1 * (dpr[e + 1] + 0.3f));
          const float2 p = kCastP ? round_bf16x2(p0, p1) : make_float2(p0, p1);
          acc[e] = fmaf(acc[e], 0.5f, ds.x) + p.x;
          acc[e + 1] = fmaf(acc[e + 1], 0.5f, ds.y) + p.y;
        }
      }
    }
  }
  store_acc(out + (size_t)(kConsumers * blockIdx.x + w) * kTile * kTile, acc, warp, lane);
}

// ---------------------------------------------------------------------------
// Instance selection, launch and occupancy
// ---------------------------------------------------------------------------

typedef void (*BinaryFn)(const bf16*, const bf16*, float*, int);
typedef void (*ChainFn)(const float*, float*, int);
typedef void (*BwdFn)(const float*, const float*, float*, int);

// One kernel instance: the function, the shared memory it needs, its
// threads and the tiles a block computes.
struct Instance {
  const void* fn;
  size_t need;
  int threads, tiles;
};

template <int D>
Instance qk_instance(int body) {
  return {body ? (const void*)(BinaryFn)qk_kernel<D, true>
               : (const void*)(BinaryFn)qk_kernel<D, false>,
          QkSmem<D>::kBytes, kSm90Threads, kConsumers};
}

template <int D>
Instance pv_instance(int body) {
  return {body ? (const void*)(BinaryFn)pv_kernel<D, true>
               : (const void*)(BinaryFn)pv_kernel<D, false>,
          PvSmem<D>::kBytes, kSm90Threads, kConsumers};
}

// The instance of component `which` (0 qk, 1 pv, 2 softmax, 3 bwd); fn is
// nullptr for arguments it does not take.
Instance pick(int which, int d, int cast_p, int body) {
  if (which == 0 && d == 64) return qk_instance<64>(body);
  if (which == 0 && d == 128) return qk_instance<128>(body);
  if (which == 1 && d == 64) return pv_instance<64>(body);
  if (which == 1 && d == 128) return pv_instance<128>(body);
  Instance chain = {nullptr, kChainSmem, kSm90Threads, kConsumers};
  if (which == 2)
    chain.fn = body ? (const void*)(ChainFn)softmax_chain_kernel<true>
                    : (const void*)(ChainFn)softmax_chain_kernel<false>;
  else if (which == 3 && cast_p)
    chain.fn = body ? (const void*)(BwdFn)bwd_chain_kernel<true, true>
                    : (const void*)(BwdFn)bwd_chain_kernel<true, false>;
  else if (which == 3)
    chain.fn = body ? (const void*)(BwdFn)bwd_chain_kernel<false, true>
                    : (const void*)(BwdFn)bwd_chain_kernel<false, false>;
  return chain;
}

// Allow max(need, smem) bytes of dynamic shared memory for the instance;
// returns the byte count through *bytes.
int reserve(const Instance& in, int smem, size_t* bytes) {
  *bytes = smem > 0 && (size_t)smem > in.need ? (size_t)smem : in.need;
  return (int)cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

int launch(int which, int d, int cast_p, int body, int blocks, int smem,
           int reps, void** args, void* stream) {
  const Instance in = pick(which, d, cast_p, body);
  if (!in.fn || blocks < 1 || reps < 0) return kBadArg;
  size_t bytes = 0;
  int err = reserve(in, smem, &bytes);
  if (err) return err;
  err = (int)cudaLaunchKernel(in.fn, dim3(blocks), dim3(in.threads), args, bytes,
                              (cudaStream_t)stream);
  const int last = (int)cudaGetLastError();
  return err ? err : last;
}

}  // namespace

extern "C" {

int bf_qk_component(const void* q, const void* k, void* out, int d, int reps,
                    int body, int blocks, int smem, void* stream) {
  void* args[] = {&q, &k, &out, &reps};
  return launch(0, d, 0, body, blocks, smem, reps, args, stream);
}

int bf_pv_component(const void* p16, const void* v, void* out, int d, int reps,
                    int body, int blocks, int smem, void* stream) {
  void* args[] = {&p16, &v, &out, &reps};
  return launch(1, d, 0, body, blocks, smem, reps, args, stream);
}

int bf_softmax_chain_component(const void* s0, void* out, int reps, int body,
                               int blocks, int smem, void* stream) {
  void* args[] = {&s0, &out, &reps};
  return launch(2, 64, 0, body, blocks, smem, reps, args, stream);
}

int bf_bwd_chain_component(const void* s0, const void* dp, void* out,
                           int cast_p, int reps, int body, int blocks,
                           int smem, void* stream) {
  void* args[] = {&s0, &dp, &out, &reps};
  return launch(3, 64, cast_p, body, blocks, smem, reps, args, stream);
}

// out[0] = resident blocks per SM at max(need, smem) bytes of dynamic shared
// memory, out[1] = those bytes, out[2] = registers per thread, out[3] = tiles
// a block computes.
int bf_component_occupancy(int which, int d, int cast_p, int body, int smem,
                           int* out) {
  const Instance in = pick(which, d, cast_p, body);
  if (!in.fn) return kBadArg;
  size_t bytes = 0;
  int err = reserve(in, smem, &bytes);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, in.fn);
  if (err) return err;
  out[1] = (int)bytes;
  out[2] = attr.numRegs;
  out[3] = in.tiles;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], in.fn, in.threads,
                                                            bytes);
}

}  // extern "C"
