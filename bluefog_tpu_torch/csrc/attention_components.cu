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
// column j of q takes acc[0, j mod 64].
//
// The tiles, fragments and reductions are those of csrc/flash_attention.cu
// (both include mma_tile.cuh), so each component times the flash kernels' own
// instructions: 128-thread blocks, four warps of 16 rows, mma.sync.m16n8k16
// (bf16 in, f32 out), p re-packed from C fragments into A fragments every
// tile, a row spread over four lanes and reduced with two shuffles.  With
// body = 0 the product or chain is left out and f is just the fed-back row
// plus 1: the cost of the dependency pass alone.
//
// The dependency pass is a cross-warp broadcast: row 0 lives in warp 0
// (lanes 0-3), so every repetition publishes it to a ping-pong row buffer in
// shared memory and takes one block barrier, which also orders the next
// repetition's write after every warp's read of the other buffer.  The flash
// kernels take two barriers per key tile themselves.
//
// What bounds each on the H100: qk and pv are tensor-core operations
// (2 * 64 * 64 * D flops a tile against 989 TFLOP/s bf16); the chains are
// exp2 (the MUFU ex2 unit) and FP32 issue (about 8 f32 operations per element
// against 67 TFLOP/s).  The flash kernels call expf, which costs more than
// exp2f; the chains time exp2f, as the TPU bodies time exp2.
//
// Every block computes the same tile and writes it to its own slice of out
// ([blocks, 64, W] f32).  The launch reserves max(need, smem) bytes of
// dynamic shared memory, so a caller can hold the blocks per SM to those of
// the flash kernel a component models.  Seconds per tile, device-wide, is
// then the slope of a launch's time over reps divided by the blocks
// launched.  Every launcher runs on the caller's stream, allocates nothing
// and returns the launch's error or cudaGetLastError().

#include <math.h>

#include "mma_tile.cuh"

namespace {

constexpr int kBadArg = -1;

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// --- staging, the row broadcast, the store ---------------------------------

// Copy a row-major [64, W] bf16 matrix into smem with row stride S (16-byte
// chunks).
template <int W, int S>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src) {
  constexpr int kChunks = W / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    *reinterpret_cast<uint4*>(dst + r * S + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * W + c * 8);
  }
}

// A row-major [64, 64] f32 matrix into this warp's C fragments: element
// (warp*16 + g + 8*(i>>1), nt*8 + 2t + (i&1)) is c[nt][i].
__device__ __forceinline__ void load_c(float (&c)[8][4], const float* src,
                                       int warp, int lane) {
  const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(
          src + (row + 8 * h) * kTile + nt * 8 + col);
      c[nt][2 * h] = v.x;
      c[nt][2 * h + 1] = v.y;
    }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
}

// Row 0 of the block's accumulator (warp 0, lanes 0-3) into buf, then one
// barrier: after it every warp may read buf.
template <int NT>
__device__ __forceinline__ const float* publish_row0(float* buf,
                                                     const float (&c)[NT][4],
                                                     int warp, int lane) {
  if (warp == 0 && lane < 4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(buf + nt * 8 + lane * 2) =
          make_float2(c[nt][0], c[nt][1]);
  }
  __syncthreads();
  return buf;
}

// The dependency pass alone: acc <- 0.5 acc + (fed + 1), fed = row[col],
// rounded to bf16 where the full body rounds it.
template <int NT, bool kRound>
__device__ __forceinline__ void dep_only(float (&acc)[NT][4], const float* row,
                                         int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 x = *reinterpret_cast<const float2*>(row + nt * 8 + 2 * t);
    const float f0 = (kRound ? round_bf16(x.x) : x.x) + 1.f;
    const float f1 = (kRound ? round_bf16(x.y) : x.y) + 1.f;
    acc[nt][0] = fmaf(acc[nt][0], 0.5f, f0);
    acc[nt][1] = fmaf(acc[nt][1], 0.5f, f1);
    acc[nt][2] = fmaf(acc[nt][2], 0.5f, f0);
    acc[nt][3] = fmaf(acc[nt][3], 0.5f, f1);
  }
}

// This warp's C fragments into out, a row-major [64, W] f32 tile.
template <int NT>
__device__ __forceinline__ void store_c(float* out, const float (&c)[NT][4],
                                        int warp, int lane) {
  constexpr int W = NT * 8;
  const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (row + 8 * h) * W + nt * 8 + col) =
          make_float2(c[nt][2 * h], c[nt][2 * h + 1]);
}

// Keeps the compiler from hoisting arithmetic on a loop-invariant operand.
__device__ __forceinline__ void opaque(float& x) { asm volatile("" : "+f"(x)); }

// ---------------------------------------------------------------------------
// qk: q [64, D] bf16, k [D, 64] bf16 -> out [blocks, 64, 64] f32
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t qk_smem() {
  return 2 * kTile * (D + 8) * sizeof(bf16) + 2 * kTile * sizeof(float);
}

template <int D, bool kBody>
__global__ void __launch_bounds__(kThreads)
qk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          float* __restrict__ out, int reps) {
  constexpr int S = D + 8;  // padded smem row stride, as in the flash kernels
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * S;  // k transposed: row n holds column n of k
  float* rows = reinterpret_cast<float*>(ks + kTile * S);  // [2][64]

  stage_rows<D, S>(qs, q);
  for (int i = threadIdx.x; i < D * kTile; i += kThreads)
    ks[(i % kTile) * S + i / kTile] = k[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  float acc[8][4];
  zero(acc);
  for (int r = 0; r < reps; ++r) {
    const float* row = publish_row0(rows + (r & 1) * kTile, acc, warp, lane);
    if (!kBody) {
      dep_only<8, true>(acc, row, lane);
      continue;
    }
    float s[8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a<S>(a, qs, warp * 16, kk * 16, lane);
      const int c = (kk * 16) % kTile + 2 * t;  // q column j takes acc[0, j mod 64]
      const uint32_t lo = pack_bf16(row[c], row[c + 1]);
      const uint32_t hi = pack_bf16(row[c + 8], row[c + 9]);
      a[0] = add_bf16x2(a[0], lo);
      a[1] = add_bf16x2(a[1], lo);
      a[2] = add_bf16x2(a[2], hi);
      a[3] = add_bf16x2(a[3], hi);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b[2];
        frag_b_rows<S>(b, ks, nt * 8, kk * 16, lane);
        mma16816(s[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = fmaf(acc[nt][i], 0.5f, s[nt][i]);
  }
  store_c(out + (size_t)blockIdx.x * kTile * kTile, acc, warp, lane);
}

// ---------------------------------------------------------------------------
// pv: p16 [64, 64] bf16, v [64, D] bf16 -> out [blocks, 64, D] f32
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t pv_smem() {
  return kTile * (kTile + 8) * sizeof(bf16) + kTile * (D + 8) * sizeof(bf16) +
         2 * D * sizeof(float);
}

template <int D, bool kBody>
__global__ void __launch_bounds__(kThreads)
pv_kernel(const bf16* __restrict__ p16, const bf16* __restrict__ v,
          float* __restrict__ out, int reps) {
  constexpr int S = D + 8, SP = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ps = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ps + kTile * SP;
  float* rows = reinterpret_cast<float*>(vs + kTile * S);  // [2][D]

  stage_rows<kTile, SP>(ps, p16);
  stage_rows<D, S>(vs, v);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  // p as the flash kernels hold it before p.V: f32 C fragments, re-packed
  // into bf16 A fragments every tile.
  float p[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[nt][i] = __bfloat162float(
          ps[(warp * 16 + g + 8 * (i >> 1)) * SP + nt * 8 + (lane & 3) * 2 + (i & 1)]);

  float acc[D / 8][4];
  zero(acc);
  for (int r = 0; r < reps; ++r) {
    const float* row = publish_row0(rows + (r & 1) * D, acc, warp, lane);
    if (!kBody) {
      dep_only<D / 8, true>(acc, row, lane);
      continue;
    }
    uint32_t fed[D / 8];  // bf16(acc[0, n]) twice, n = dt*8 + g: B's column
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float x = row[dt * 8 + g];
      fed[dt] = pack_bf16(x, x);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] *= 0.5f;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b[2];
        frag_b_cols<S>(b, vs, kk * 16, dt * 8, lane);
        b[0] = add_bf16x2(b[0], fed[dt]);
        b[1] = add_bf16x2(b[1], fed[dt]);
        mma16816(acc[dt], a, b);
      }
    }
  }
  store_c(out + (size_t)blockIdx.x * kTile * D, acc, warp, lane);
}

// ---------------------------------------------------------------------------
// Forward softmax chain: s0 [64, 64] f32 -> out [blocks, 64, 64] f32
// ---------------------------------------------------------------------------
constexpr size_t chain_smem() { return 2 * kTile * sizeof(float); }

template <bool kBody>
__global__ void __launch_bounds__(kThreads)
softmax_chain_kernel(const float* __restrict__ s0, float* __restrict__ out,
                     int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rows = reinterpret_cast<float*>(smem_raw);  // [2][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  float s0r[8][4];  // the scores as the flash forward holds them
  load_c(s0r, s0, warp, lane);

  float acc[8][4];
  zero(acc);
  for (int r = 0; r < reps; ++r) {
    const float* row = publish_row0(rows + (r & 1) * kTile, acc, warp, lane);
    if (!kBody) {
      dep_only<8, false>(acc, row, lane);
      continue;
    }
    float s[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(row + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = s0r[nt][i] + ((i & 1) ? x.y : x.x);
        m[i >> 1] = fmaxf(m[i >> 1], s[nt][i]);
      }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(s[nt][i] - m[i >> 1]);
        l[i >> 1] += s[nt][i];
      }
    const float ml[2] = {m[0] + quad_sum(l[0]), m[1] + quad_sum(l[1])};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[nt][i] = fmaf(acc[nt][i], 0.5f, round_bf16(s[nt][i])) + ml[i >> 1];
  }
  store_c(out + (size_t)blockIdx.x * kTile * kTile, acc, warp, lane);
}

// ---------------------------------------------------------------------------
// Backward chain: s0, dp [64, 64] f32 -> out [blocks, 64, 64] f32.  The dK/dV
// kernel rounds both p and dS to bf16 (cast_p); the dQ kernel only dS.
// ---------------------------------------------------------------------------
template <bool kCastP, bool kBody>
__global__ void __launch_bounds__(kThreads)
bwd_chain_kernel(const float* __restrict__ s0, const float* __restrict__ dp,
                 float* __restrict__ out, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rows = reinterpret_cast<float*>(smem_raw);  // [2][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  float s0r[8][4], dpr[8][4];
  load_c(s0r, s0, warp, lane);
  load_c(dpr, dp, warp, lane);

  float acc[8][4];
  zero(acc);
  for (int r = 0; r < reps; ++r) {
    const float* row = publish_row0(rows + (r & 1) * kTile, acc, warp, lane);
    if (!kBody) {
      dep_only<8, false>(acc, row, lane);
      continue;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(row + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        opaque(dpr[nt][i]);  // dp + 0.3 stays in the loop, as dP is fresh per tile
        const float p = exp2f(s0r[nt][i] + ((i & 1) ? x.y : x.x) - 1.7f);
        const float ds = p * (dpr[nt][i] + 0.3f);
        const float o = fmaf(acc[nt][i], 0.5f, round_bf16(ds));
        acc[nt][i] = o + (kCastP ? round_bf16(p) : p);
      }
    }
  }
  store_c(out + (size_t)blockIdx.x * kTile * kTile, acc, warp, lane);
}

// ---------------------------------------------------------------------------
// Instance selection, launch and occupancy
// ---------------------------------------------------------------------------

typedef void (*BinaryFn)(const bf16*, const bf16*, float*, int);
typedef void (*ChainFn)(const float*, float*, int);
typedef void (*BwdFn)(const float*, const float*, float*, int);

// The kernel instance of component `which` (0 qk, 1 pv, 2 softmax, 3 bwd)
// and the shared memory it needs; nullptr for arguments it does not take.
const void* pick(int which, int d, int cast_p, int body, size_t* need) {
  if (which == 0 && d == 64) {
    *need = qk_smem<64>();
    return body ? (const void*)(BinaryFn)qk_kernel<64, true>
                : (const void*)(BinaryFn)qk_kernel<64, false>;
  }
  if (which == 0 && d == 128) {
    *need = qk_smem<128>();
    return body ? (const void*)(BinaryFn)qk_kernel<128, true>
                : (const void*)(BinaryFn)qk_kernel<128, false>;
  }
  if (which == 1 && d == 64) {
    *need = pv_smem<64>();
    return body ? (const void*)(BinaryFn)pv_kernel<64, true>
                : (const void*)(BinaryFn)pv_kernel<64, false>;
  }
  if (which == 1 && d == 128) {
    *need = pv_smem<128>();
    return body ? (const void*)(BinaryFn)pv_kernel<128, true>
                : (const void*)(BinaryFn)pv_kernel<128, false>;
  }
  *need = chain_smem();
  if (which == 2)
    return body ? (const void*)(ChainFn)softmax_chain_kernel<true>
                : (const void*)(ChainFn)softmax_chain_kernel<false>;
  if (which == 3 && cast_p)
    return body ? (const void*)(BwdFn)bwd_chain_kernel<true, true>
                : (const void*)(BwdFn)bwd_chain_kernel<true, false>;
  if (which == 3)
    return body ? (const void*)(BwdFn)bwd_chain_kernel<false, true>
                : (const void*)(BwdFn)bwd_chain_kernel<false, false>;
  return nullptr;
}

// Allow max(need, smem) bytes of dynamic shared memory for fn; returns the
// byte count through *bytes.
int reserve(const void* fn, size_t need, int smem, size_t* bytes) {
  *bytes = smem > 0 && (size_t)smem > need ? (size_t)smem : need;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

int launch(int which, int d, int cast_p, int body, int blocks, int smem,
           int reps, void** args, void* stream) {
  size_t need = 0, bytes = 0;
  const void* fn = pick(which, d, cast_p, body, &need);
  if (!fn || blocks < 1 || reps < 0) return kBadArg;
  int err = reserve(fn, need, smem, &bytes);
  if (err) return err;
  err = (int)cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, bytes,
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
// memory, out[1] = those bytes, out[2] = registers per thread.
int bf_component_occupancy(int which, int d, int cast_p, int body, int smem,
                           int* out) {
  size_t need = 0, bytes = 0;
  const void* fn = pick(which, d, cast_p, body, &need);
  if (!fn) return kBadArg;
  int err = reserve(fn, need, smem, &bytes);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err) return err;
  out[1] = (int)bytes;
  out[2] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, kThreads,
                                                            bytes);
}

}  // extern "C"
