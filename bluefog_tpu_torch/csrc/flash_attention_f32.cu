// Flash attention in float32 for Hopper (sm_90a): forward, dK/dV, dQ.
//
// The f32 instances of the three Pallas TPU kernels of
// bluefog_tpu/kernels/flash_attention.py, which serve f32 inputs with f32
// products (preferred_element_type=float32, :279, :311, :522-555, :599-623):
//   fwd_f32_kernel  <- _fwd_kernel      (:246, pallas_call :383)
//   dkv_f32_kernel  <- _bwd_dkv_kernel  (:490, pallas_call :686)
//   dq_f32_kernel   <- _bwd_dq_kernel   (:575, pallas_call :708)
// and above D = 256 fwd_wide_f32_kernel, dkv_wide_f32_kernel,
// dq_wide_f32_kernel.
// The bf16 instances are the Hopper kernels of flash_attention.cu.
//
// Contract (that of the bf16 kernels): q, k, v, o, dO are [BH, T, D] f32,
// contiguous, D = 64, 128 or 256 (the wrapper zero-pads a smaller head dim)
// or a multiple of 128 above 256 (the wide kernels, at the end);
// lse and corr are [BH, Tq] f32.  Causal masking uses global positions
// (q_start + row, k_start + col; visible iff kpos <= qpos).  Rows with no
// visible key give o = 0 and lse = -1e30.  corr = g_lse - rowsum(o * dO)
// comes from the wrapper.  What differs from bf16: p and dS are not rounded
// to a narrower type before they multiply (the reference casts them to
// v.dtype, f32 here), and every product is f32-accurate.
//
// Mixed dtypes: the reference's kernels take q, k, v (and dO) of different
// float dtypes, promote them in their products (lax.dot_general) and round
// p to v's dtype before P.V, p to dO's before P^T.dO and dS to q's before
// dS^T.Q and dS.K.  Every mix of bf16, f16 and f32 promotes to f32, so the
// wrapper casts the narrower operands up (exact) and runs these kernels,
// whose `rounding` argument names those roundings: bits 0-1 p's dtype, bits
// 2-3 dS's (round_to's codes: 0 none, 1 bf16, 2 f16), each rounded to
// nearest even as the reference's astype.  Without them a mixed case
// leaves the narrowest dtype's rule of the plain version at some element
// (tests/test_torch_flash_mixed.py, by up to 2.27x).  Outputs go back to
// the reference's dtypes in the wrapper (o and dQ q's, dK k's, dV v's).
//
// All three: f32-accurate products on the tensor cores (3xTF32).
// Every operand x is split once, when its fragment is formed, into
// big = tf32(x) (cvt.rna: nearest, ties away, at TF32's 10 mantissa bits)
// and small = x - big (exact in f32), and a.b runs as three TF32 products
// into one f32 accumulator: small_a.big_b + big_a.small_b + big_a.big_b.
// The dropped term small_a.small_b is below 2^-22 |a||b|, and the tensor
// cores read small's top 10 mantissa bits only, which moves a product by
// under 2^-21 |a||b|: against the f32 tolerance the kernels are held to,
// 2^-14 (|ref| + rms(ref)) per element, that is over a hundred times
// smaller.  p and dS are split like any operand.  What bounds the three on
// the H100 is the tensor-core pipe at three TF32 products per product,
// 495 / 3 = 165 TFLOP/s, 2.5x the 67 TFLOP/s of FFMA.  The instruction is
// mma.sync.m16n8k8 (tf32 in, f32 out; HMMA.1688.F32.TF32 in the SASS),
// whose own rate on this card is 64% of that (PERF.md), one warp a 16-row
// slab:
//   * wgmma takes tf32 operands only K-major from shared memory, and P.V,
//     P^T.dO, dS^T.Q and dS.K read V, dO, Q and K along their rows
//     (MN-major), which would need split, transposed copies of every staged
//     tile: at D = 128 dK/dV's stage alone would pass the 227 KB a block
//     may hold.
//     mma.sync reads its fragments from shared memory in any layout, as
//     PyTorch's own f32 attention (CUTLASS, OpMultiplyAddFastF32) does.
//   * Staging: the K/V tiles (forward, dQ) or Q/dO tiles with their lse and
//     corr rows (dK/dV) stream by TMA through 3-D tensor maps (rows past T
//     read as zeros) into a ring, kFwdStages, kDqStages or kDkvStages deep,
//     each stage with a full and an empty mbarrier; the block's own Q (and
//     dO for dQ), or K and V, arrive once.  Warp 0 issues the loads inline,
//     kStages - 1 tiles ahead of the tile it works on: its wait on the empty
//     barrier holds warp 0 alone, and no block-wide barrier sits in the
//     tile loop.  (A producer
//     warp of its own would make five warps a block: three on one SM
//     sub-partition caps a thread at 168 registers, and the products
//     spill.)  Tiles land as boxes of 32 floats (128 bytes) a row with the
//     128-byte swizzle, so 16-byte chunk c of row r sits at r * 128 +
//     ((c ^ (r % 8)) * 16).
//   * Fragments: the contraction index of a product may be permuted, as
//     long as both operands agree.  K-major products (S = Q.K^T, dP =
//     dO.V^T, S^T = K.Q^T, dP^T = V.dO^T) give thread (g, t) of a warp
//     (g = lane / 4, t = lane % 4) columns 8t + 4p + {0..3} of each
//     32-column box, p = 0, 1: one
//     float4 a row feeds two k-steps, and the chunks 2t + p of rows g and
//     g + 1 miss each other's banks under the swizzle.  MN-major products
//     (O += P.V, dV += P^T.dO, dK += dS^T.Q, dQ += dS.K) take P or dS from
//     the score accumulator's registers (k = t, t + 4 of a k-step are its
//     columns 2t, 2t + 1) and permute the output columns: column n of
//     n-tile i is d = 32 (i / 4) + 4n + i % 4, so one float4 of a V row serves four
//     n-tiles and a thread's outputs are eight adjacent columns a row.
//   * Softmax: exp2 with log2 e folded into the scale (ex2.approx, about
//     2^-22 relative); masks only on the tiles that cross the diagonal or
//     the end; the forward's lse goes back to the natural log when it is
//     written, dK/dV and dQ take lse in log2 units once.
//   * A longest-first causal schedule: the tile index is the slowest grid
//     axis, walked from the last query tile (forward) or the first key tile
//     (dK/dV), as in flash_attention.cu; dQ walks as the forward.
//   * Accumulation: the tensor cores round their f32 sums toward zero, one
//     f32 step a product at most, always the same way, so a chain of
//     products into one accumulator over all T rows drifts: dK/dV read
//     0.83 of the f32 tolerance at [24, 2048, 64] that way (PERF.md).
//     So every product sums into a zeroed partial sum of at most 24 TF32
//     products (a 32-column box of D, a 32-query tile of dK/dV or a key
//     tile of the forward or dQ), which one round-to-nearest add folds
//     into the accumulator.
//   A warp whose 16 rows see nothing of a staged tile (past the diagonal or
//   past the end) skips its products but still releases the stage.
//
// dQ is the forward's block with a second K-major product: S = Q.K^T and
// dP = dO.V^T from the block's Q and dO tiles and a K/V stage, p =
// 2^(s scale log2 e - lse log2 e) against the forward's lse (no running
// max), dS = p (dP + corr) in the score registers, dQ += dS.K MN-major
// from the K stage, scaled once when stored.  Its accumulator (D / 2
// floats) and two score arrays (S and dP) take more registers than the
// forward's, and Q + dO take twice the forward's Q: at D = 128 eight
// warps with 64-key stages would need 256 KB, so the D = 128 block streams
// kDqKeys128 keys a stage (PERF.md has the layouts measured).
//
// D = 256: a 16-row slab of Q, K or V alone is 16 KB, so the <256> blocks
// take short stages (the byte counts: PERF.md): the forward 8 warps with
// kFwdKeys256 keys a K/V stage, dQ 4 warps with kDqKeys256 (three stages),
// dK/dV 64 keys with kDkvQRows256 query rows a Q/dO stage.  A warp's 16
// rows of a 256-wide accumulator take 128 registers a thread: the forward
// and dQ carry one, their products taken box by box as at every D.  dK/dV's
// two would take 256, over the 255 a thread has, so at D = 256 two warps
// own each 16-key slab, each half of D's columns of dK and dV (kHalves),
// both computing S^T and dP^T over all of D, as flash_attention.cu's
// kDkvSplit splits its warpgroups.
//
// Every launcher runs on the caller's stream, allocates nothing and returns
// 0, cudaGetLastError(), the error of the attribute call before it, or a
// tensor-map encode failure (sm90_tile.cuh: kNoEncoder, kEncodeFailed + r).

#include "sm90_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite mask sentinel
constexpr float kMaskThresh = -0.5e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Block shapes and ring depths, the fastest measured
// (benchmarks/flash_variants.py --f32; PERF.md).  A warp owns 16 rows:
// query rows in the forward and dQ, keys in dK/dV.
constexpr int kFwdWarps64 = 4, kFwdWarps128 = 8, kFwdWarps256 = 8;
constexpr int kFwdKeys256 = 16;  // keys of a K/V stage at D = 256 (kTile below)
constexpr int kFwdStages = 2;    // K/V ring
constexpr int kDkvWarps64 = 4, kDkvWarps128 = 8;
constexpr int kDkvKeys256 = 64;  // keys a block at D = 256, two warps a 16-key slab
constexpr int kDkvQRows = 32, kDkvQRows256 = 16;  // query rows of a stage
constexpr int kDkvStages = 2;                     // Q/dO ring
constexpr int kDqWarps64 = 8, kDqWarps128 = 8, kDqWarps256 = 4;
constexpr int kDqKeys64 = 64, kDqKeys128 = 32, kDqKeys256 = 16;  // keys of a K/V stage
constexpr int kDqStages = 2;                                     // K/V ring
constexpr int kDqStages256 = 3;                                  // ... at D = 256

// ---- 3xTF32 products on mma.sync ---------------------------------------------

struct Tf32 {
  uint32_t big, small;
};

// x rounded to nearest even at bf16's (code 1) or f16's (code 2) precision
// and kept in f32, as the reference's astype rounds p and dS of mixed
// inputs; code 0 leaves x.
__device__ __forceinline__ float round_to(float x, int code) {
  return code == 1 ? __bfloat162float(__float2bfloat16_rn(x))
                   : code == 2 ? __half2float(__float2half_rn(x)) : x;
}

// x = big + small, big = x rounded to nearest (ties away) at 10 mantissa
// bits, small = x - big (exact).
__device__ __forceinline__ Tf32 split(float x) {
  uint32_t big;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  return {big, __float_as_uint(x - __uint_as_float(big))};
}

struct AFrag {
  Tf32 x[4];  // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of 16 x 8
};
struct BFrag {
  Tf32 x[2];  // (t, g), (t + 4, g) of 8 x 8
};

// n-tile j of acc (16 x 8, f32: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1))
// += one TF32 product of a and b: term 0 small.big, 1 big.small, 2 big.big.
template <int N>
__device__ __forceinline__ void mma_term(float (&acc)[N], int j, const AFrag& a,
                                         const BFrag& b, int term) {
  const uint32_t a0 = term == 0 ? a.x[0].small : a.x[0].big;
  const uint32_t a1 = term == 0 ? a.x[1].small : a.x[1].big;
  const uint32_t a2 = term == 0 ? a.x[2].small : a.x[2].big;
  const uint32_t a3 = term == 0 ? a.x[3].small : a.x[3].big;
  const uint32_t b0 = term == 1 ? b.x[0].small : b.x[0].big;
  const uint32_t b1 = term == 1 ? b.x[1].small : b.x[1].big;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[4 * j]), "+f"(acc[4 * j + 1]), "+f"(acc[4 * j + 2]), "+f"(acc[4 * j + 3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte chunk ch (columns 4ch..4ch+3) of row r of a swizzled tile of
// `rows` rows: D / 32 boxes of rows x 128 bytes, one after the other.
__device__ __forceinline__ float4 lds4(const unsigned char* tile, int rows, int r, int ch) {
  return *reinterpret_cast<const float4*>(tile + (ch >> 3) * rows * 128 + r * 128 +
                                          (((ch & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// K-major: acc[4j + c] += sum over the D columns of rows ra + g and
// ra + g + 8 of tile a times row 8j + g of tile b, j < N / 8: S = Q.K^T and
// dP = dO.V^T (N keys), S^T = K.Q^T and dP^T = V.dO^T (N queries).  Each 32-column box
// sums into a zeroed partial sum (12 products), folded into acc by a
// round-to-nearest add (see mma_mnmajor).  B fragments are formed NB
// n-tiles at a time: four, or two for a 16-row tile b.
template <int D, int N>
__device__ __forceinline__ void mma_kmajor(float (&acc)[N / 2], const unsigned char* a,
                                           int a_rows, int ra, const unsigned char* b,
                                           int b_rows, int g, int t) {
  constexpr int NB = N % 32 == 0 ? 4 : 2;
  static_assert(N % (8 * NB) == 0, "n-tiles go four or two at a time");
#pragma unroll
  for (int box = 0; box < D / 32; ++box) {
    float part[N / 2];
    zero(part);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int ch = 8 * box + 2 * t + p;
      const float4 lo = lds4(a, a_rows, ra + g, ch), hi = lds4(a, a_rows, ra + g + 8, ch);
      const AFrag a0 = {{split(lo.x), split(hi.x), split(lo.y), split(hi.y)}};
      const AFrag a1 = {{split(lo.z), split(hi.z), split(lo.w), split(hi.w)}};
#pragma unroll
      for (int j0 = 0; j0 < N / 8; j0 += NB) {
        BFrag b0[NB], b1[NB];
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          const float4 v = lds4(b, b_rows, 8 * (j0 + jj) + g, ch);
          b0[jj] = {{split(v.x), split(v.y)}};
          b1[jj] = {{split(v.z), split(v.w)}};
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) mma_term(part, j0 + jj, a0, b0[jj], term);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) mma_term(part, j0 + jj, a1, b1[jj], term);
      }
    }
#pragma unroll
    for (int c = 0; c < N / 2; ++c) acc[c] += part[c];
  }
}

// MN-major: acc[4i + c] += sum over rows k < N of p (registers, the
// K-major form's accumulator over those N rows) times row k of tile m,
// i < D / 8, output columns permuted (column n of n-tile i holds
// d = 32 (i / 4) + 4n + i % 4).  D is the columns taken: a tile's first D,
// or D from box c on of a tile passed at m + c * m_rows * 128.  O += P.V,
// dV += P^T.dO, dK += dS^T.Q, dQ += dS.K.
// The tensor cores round their f32 sums toward zero, so a chain of
// products into one accumulator drifts by about one f32 step per product,
// always the same way; over the thousands of rows dK/dV contract that
// nears the f32 tolerance.  So each box's products for this tile go into a
// zeroed partial sum (3 N / 8 products), which one round-to-nearest add
// folds into acc.
template <int D, int N>
__device__ __forceinline__ void mma_mnmajor(float (&acc)[D / 2], const float (&p)[N / 2],
                                            const unsigned char* m, int m_rows, int g,
                                            int t) {
  AFrag a[N / 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
    a[j] = {{split(p[4 * j]), split(p[4 * j + 2]), split(p[4 * j + 1]), split(p[4 * j + 3])}};
#pragma unroll
  for (int box = 0; box < D / 32; ++box) {
    float part[16];
    zero(part);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float4 v0 = lds4(m, m_rows, 8 * j + 2 * t, 8 * box + g);
      const float4 v1 = lds4(m, m_rows, 8 * j + 2 * t + 1, 8 * box + g);
      BFrag b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = {{split(lane4(v0, i)), split(lane4(v1, i))}};
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_term(part, i, a[j], b[i], term);
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[16 * box + c] += part[c];
  }
}

// Store a warp's 16 x C accumulator of the MN-major form (columns
// permuted) into rows row_g and row_g + 8 of a [T, D] output from its
// column `out` points at, row half r times mul[r]; rows at or past `rows`
// are dropped.  A thread writes columns 32 box + 8t .. + 7 of each row: two
// float4.
template <int D, int C = D>
__device__ __forceinline__ void store_perm(float* out, const float (&acc)[C / 2], int row_g,
                                           int rows, float mul0, float mul1, int t,
                                           int ld = D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= rows) continue;
    const float mul = r ? mul1 : mul0;
#pragma unroll
    for (int box = 0; box < C / 32; ++box) {
      float* dst = out + (size_t)row * ld + 32 * box + 8 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * r + h;
        *reinterpret_cast<float4*>(dst + 4 * h) =
            make_float4(acc[4 * (4 * box) + c] * mul, acc[4 * (4 * box + 1) + c] * mul,
                        acc[4 * (4 * box + 2) + c] * mul, acc[4 * (4 * box + 3) + c] * mul);
      }
    }
  }
}

// Every 32-column box of rows [r, r + rows) of head h: D / 32 boxes of
// rows x 128 bytes, one after the other from dst.
template <int D>
__device__ __forceinline__ void tma_rows_f32(unsigned char* dst, const CUtensorMap* map,
                                             int rows, int r, int h, uint64_t* bar) {
#pragma unroll
  for (int box = 0; box < D / 32; ++box)
    tma_load(dst + box * rows * 128, map, box * 32, r, h, bar);
}

// Key tiles of n keys that query rows up to rows_end (local, capped at tq)
// see: all of them, or under the causal mask those up to the last row.
__device__ __forceinline__ int key_tiles(int rows_end, int tq, int tk, int q_start,
                                         int k_start, int n, int causal) {
  const int all = (tk + n - 1) / n;
  if (!causal) return all;
  const int q_last = q_start + min(rows_end, tq) - 1;
  return min(all, q_last >= k_start ? (q_last - k_start) / n + 1 : 0);
}

// Blocks a SM the launch bounds ask for: two where two blocks' shared
// memory fits the SM's 228 KB and each SM sub-partition (16K registers)
// still holds two warps of 255 registers.
constexpr int min_blocks(size_t smem, int threads) {
  return 2 * (smem + 1024) <= 228 * 1024 && threads <= 128 ? 2 : 1;
}

// ---------------------------------------------------------------------------
// Forward: one block per (bh, query tile of 16 x kWarps rows), the last
// tiles first; warp 0 streams key tiles of kKeys keys up to the diagonal.
// ---------------------------------------------------------------------------

template <int D>
struct FwdF32 {
  static constexpr int kWarps = D == 64 ? kFwdWarps64 : D == 128 ? kFwdWarps128 : kFwdWarps256;
  static constexpr int kKeys = D == 256 ? kFwdKeys256 : kTile;  // keys of a K/V stage
  static constexpr int kStages = kFwdStages;
  static constexpr int kRows = 16 * kWarps;  // query rows a block
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQ = kRows * D * 4;            // the block's Q tile, bytes
  static constexpr int kKV = kKeys * D * 4;           // one K or V tile of a stage
  static constexpr size_t kBytes = 1024 + kQ + kStages * 2 * kKV + (1 + 2 * kStages) * 8;
  static constexpr int kMinBlocks = min_blocks(kBytes, kThreads);
};

// One key tile of the online softmax over a warp's 16 x (2 M) scores (raw,
// n-tile j in sc[4j..4j+3]).  m is the running max of the raw scores (the
// sentinel while a row has seen no visible key) and l the running sum.
// Masked entries become the sentinel, whose exponent underflows to exactly
// 0, and a row whose max is still the sentinel takes its exponents against
// 0, so it sums nothing (where exp of sentinel - sentinel would give 1).
// p = 2^(s * scale log2 e - m * scale log2 e).  Leaves p in sc and the
// factor the output must be rescaled by in alpha.
template <int M>
__device__ __forceinline__ void online_softmax(float (&sc)[M], float (&alpha)[2],
                                               float (&m)[2], float (&l)[2],
                                               float scale_log2, bool need_mask, int k0,
                                               int tk, int causal, int k_start, int qpos0,
                                               int t) {
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool ok =
          col < tk && (!causal || k_start + col <= qpos0 + ((i >> 1) & 1) * 8);
      sc[i] = ok ? sc[i] : kNegInf;
    }
  }
  float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < M; ++i) mcur[(i >> 1) & 1] = fmaxf(mcur[(i >> 1) & 1], sc[i]);
  float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mnew = fmaxf(m[r], quad_max(mcur[r]));
    alpha[r] = ex2((m[r] - mnew) * scale_log2);
    m[r] = mnew;
    ms[r] = (mnew > kMaskThresh ? mnew : 0.f) * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], scale_log2, -ms[r]));
    sc[i] = p;
    rs[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
}

template <int D>
__global__ void __launch_bounds__(FwdF32<D>::kThreads, FwdF32<D>::kMinBlocks)
fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
               float* __restrict__ lse, int tq, int tk, int q_start, int k_start,
               float scale, int causal, int rounding) {
  using L = FwdF32<D>;
  constexpr int N = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* skv = sq + L::kQ;  // stage s: K at s * 2 kKV, V kKV after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + L::kStages * 2 * L::kKV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;  // longest first
  const int n_kv = key_tiles(q0 + L::kRows, tq, tk, q_start, k_start, N, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kWarps);  // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 stages key tile `it` into its ring slot once every warp has
  // released the tile the slot held.
  auto stage = [&](int it) {
    const int s = it % L::kStages;
    mbar_wait(&empty[s], ((it / L::kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
    unsigned char* sk = skv + s * 2 * L::kKV;
    tma_rows_f32<D>(sk, &tm_k, N, it * N, bh, &full[s]);
    tma_rows_f32<D>(sk + L::kKV, &tm_v, N, it * N, bh, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_full, L::kQ);
    tma_rows_f32<D>(sq, &tm_q, L::kRows, q0, bh, q_full);
    for (int it = 0; it < min(L::kStages - 1, n_kv); ++it) stage(it);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows of the block's Q tile
  const int q0w = q0 + r0;
  const bool rows_in = q0w < tq;
  const int qpos0 = q_start + q0w + g;  // row g; row g + 8 is + 8
  const float scale_log2 = scale * kLog2e;
  const int p_round = rounding & 3;  // p's dtype before P.V (mixed inputs)
  // the key tiles these 16 rows see are a prefix of the block's
  const int n_own = rows_in ? key_tiles(q0w + 16, tq, tk, q_start, k_start, N, causal) : 0;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2];
  zero(acc);
  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    // the ring runs kStages - 1 tiles ahead of the slowest warp
    if (threadIdx.x == 0 && it + L::kStages - 1 < n_kv) stage(it + L::kStages - 1);
    const int s = it % L::kStages;
    mbar_wait(&full[s], (it / L::kStages) & 1);
    if (it < n_own) {
      const unsigned char* sk = skv + s * 2 * L::kKV;
      const int k0 = it * N;
      float sc[N / 2], alpha[2];
      zero(sc);
      mma_kmajor<D, N>(sc, sq, L::kRows, r0, sk, N, g, t);  // S = Q.K^T
      const bool need_mask =
          (causal && k_start + k0 + N - 1 > q_start + q0w) || k0 + N > tk;
      online_softmax(sc, alpha, m, l, scale_log2, need_mask, k0, tk, causal, k_start,
                     qpos0, t);
      if (p_round) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) sc[i] = round_to(sc[i], p_round);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      mma_mnmajor<D, N>(acc, sc, sk + L::kKV, N, g, t);  // O += P.V
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (!rows_in) return;
  const int row_g = q0w + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  store_perm<D>(o + (size_t)bh * tq * D, acc, row_g, tq, inv[0], inv[1], t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_g + 8 * r < tq)
        lse[(size_t)bh * tq + row_g + 8 * r] =
            m[r] > kMaskThresh ? m[r] * scale + log2f(fmaxf(l[r], 1e-30f)) * kLn2
                               : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (bh, key tile of kRows keys), the first tiles
// first; warp 0 streams query tiles of kQRows from the diagonal.  Each
// warp owns 16 keys and kCols columns of their dK and dV (all D, or half at
// D = 256), so no two write the same element.
// ---------------------------------------------------------------------------

template <int D>
struct DkvF32 {
  static constexpr int kHalves = D == 256 ? 2 : 1;  // warps a 16-key slab
  static constexpr int kCols = D / kHalves;         // columns of dK and dV a warp owns
  static constexpr int kRows =                      // keys a block
      D == 64 ? 16 * kDkvWarps64 : D == 128 ? 16 * kDkvWarps128 : kDkvKeys256;
  static constexpr int kWarps = kRows / 16 * kHalves;
  static constexpr int kQRows = D == 256 ? kDkvQRows256 : kDkvQRows;
  static constexpr int kStages = kDkvStages;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKV = kRows * D * 4;           // the block's K or V tile
  static constexpr int kQ = kQRows * D * 4;           // one Q or dO tile of a stage
  static constexpr int kStats = 2 * kQRows * 4;       // lse (log2 units), corr
  static constexpr size_t kBytes =
      1024 + 2 * kKV + kStages * (2 * kQ + kStats) + (1 + 2 * kStages) * 8;
  static constexpr int kMinBlocks = min_blocks(kBytes, kThreads);
};

template <int D>
__global__ void __launch_bounds__(DkvF32<D>::kThreads, DkvF32<D>::kMinBlocks)
dkv_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
               const float* __restrict__ corr, float* __restrict__ dk,
               float* __restrict__ dv, int tq, int tk, int q_start, int k_start,
               float scale, int causal, int rounding) {
  using L = DkvF32<D>;
  constexpr int QT = L::kQRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1024(smem_raw);
  unsigned char* sv = sk + L::kKV;
  unsigned char* sqg = sv + L::kKV;  // stage s: Q at s * 2 kQ, dO kQ after it
  float* stats = reinterpret_cast<float*>(sqg + L::kStages * 2 * L::kQ);  // [s][2][QT]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + L::kStages * 2 * QT);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * L::kRows;  // longest first
  const int n_qt = (tq + QT - 1) / QT;
  int it0 = 0;  // first query tile that reaches a key of this block
  if (causal) {
    const int first = k_start + k0 - q_start;
    it0 = first <= 0 ? 0 : (first > tq - 1 ? n_qt : first / QT);
  }
  const int n_it = n_qt - it0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 32);          // every lane of warp 0
      mbar_init(&empty[s], L::kWarps);  // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Warp 0 stages query tile `it` (its lse and corr rows too) into its ring
  // slot once every warp has released the tile the slot held.
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* corr_bh = corr + (size_t)bh * tq;
  auto stage = [&](int it) {
    const int s = it % L::kStages, q0 = (it0 + it) * QT;
    mbar_wait(&empty[s], ((it / L::kStages) & 1) ^ 1);
    float* st = stats + s * 2 * QT;
    for (int r = lane; r < QT; r += 32) {
      const int row = q0 + r;
      st[r] = row < tq ? lse_bh[row] * kLog2e : 0.f;
      st[QT + r] = row < tq ? corr_bh[row] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * L::kQ);
      unsigned char* sq = sqg + s * 2 * L::kQ;
      tma_rows_f32<D>(sq, &tm_q, QT, q0, bh, &full[s]);
      tma_rows_f32<D>(sq + L::kQ, &tm_do, QT, q0, bh, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
      tma_rows_f32<D>(sk, &tm_k, L::kRows, k0, bh, kv_full);
      tma_rows_f32<D>(sv, &tm_v, L::kRows, k0, bh, kv_full);
    }
    for (int it = 0; it < min(L::kStages - 1, n_it); ++it) stage(it);
  }

  const int g = lane >> 2, t = lane & 3;
  // this warp's keys of the block's K/V tiles, and its first column of dK/dV
  const int r0 = 16 * (L::kHalves == 1 ? warp : warp % (L::kRows / 16));
  const int c0 = L::kHalves == 1 ? 0 : warp / (L::kRows / 16) * L::kCols;
  const int k0w = k0 + r0;
  const bool keys_in = k0w < tk;
  const int kpos0 = k_start + k0w + g;  // key g; key g + 8 is + 8
  const float scale_log2 = scale * kLog2e;
  // p's dtype before P^T.dO and dS's before dS^T.Q (mixed inputs)
  const int p_round = rounding & 3, ds_round = rounding >> 2;

  float dk_acc[L::kCols / 2], dv_acc[L::kCols / 2];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    // the ring runs kStages - 1 tiles ahead of the slowest warp
    if (warp == 0 && it + L::kStages - 1 < n_it) stage(it + L::kStages - 1);
    const int s = it % L::kStages, q0 = (it0 + it) * QT;
    mbar_wait(&full[s], (it / L::kStages) & 1);
    // query tiles wholly above the diagonal reach no key of this warp
    if (keys_in && !(causal && q_start + min(q0 + QT, tq) - 1 < k_start + k0w)) {
      const unsigned char* sq = sqg + s * 2 * L::kQ;
      const unsigned char* sg = sq + L::kQ;
      const float* st_lse = stats + s * 2 * QT;
      const float* st_corr = st_lse + QT;
      float st[QT / 2], dpt[QT / 2];  // S^T and dP^T: 16 keys x QT queries
      zero(st);
      zero(dpt);
      mma_kmajor<D, QT>(st, sk, L::kRows, r0, sq, QT, g, t);   // S^T = K.Q^T
      mma_kmajor<D, QT>(dpt, sv, L::kRows, r0, sg, QT, g, t);  // dP^T = V.dO^T
      // every pair visible: all 16 keys at or before the first query, and
      // all QT queries before tq
      const bool need_mask =
          (causal && k_start + k0w + 15 > q_start + q0) || q0 + QT > tq;
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(st_lse + qc);
        const float2 cv = *reinterpret_cast<const float2*>(st_corr + qc);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1, h = c & 1, idx = 4 * j + c;
          float p = ex2(fmaf(st[idx], scale_log2, -(h ? lv.y : lv.x)));
          if (need_mask) {
            const int qrow = q0 + qc + h;
            const bool ok = qrow < tq && (!causal || kpos0 + 8 * r <= q_start + qrow);
            p = ok ? p : 0.f;
          }
          st[idx] = p;
          dpt[idx] = p * (dpt[idx] + (h ? cv.y : cv.x));  // dS^T, unscaled
        }
      }
      if (rounding) {
#pragma unroll
        for (int i = 0; i < QT / 2; ++i) {
          st[i] = round_to(st[i], p_round);
          dpt[i] = round_to(dpt[i], ds_round);
        }
      }
      // the warp's columns of dO and Q: boxes c0 / 32 on
      const int cb = c0 / 32 * QT * 128;
      mma_mnmajor<L::kCols, QT>(dv_acc, st, sg + cb, QT, g, t);   // dV += P^T.dO
      mma_mnmajor<L::kCols, QT>(dk_acc, dpt, sq + cb, QT, g, t);  // dK += dS^T.Q
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (!keys_in) return;
  const int row_g = k0w + g;
  store_perm<D, L::kCols>(dk + (size_t)bh * tk * D + c0, dk_acc, row_g, tk, scale, scale, t);
  store_perm<D, L::kCols>(dv + (size_t)bh * tk * D + c0, dv_acc, row_g, tk, 1.f, 1.f, t);
}

// ---------------------------------------------------------------------------
// dQ: one block per (bh, query tile of 16 x kWarps rows), the last tiles
// first; warp 0 streams K/V tiles of kKeys keys up to the diagonal.
// ---------------------------------------------------------------------------

template <int D>
struct DqF32 {
  static constexpr int kWarps = D == 64 ? kDqWarps64 : D == 128 ? kDqWarps128 : kDqWarps256;
  static constexpr int kKeys = D == 64 ? kDqKeys64 : D == 128 ? kDqKeys128 : kDqKeys256;
  static constexpr int kStages = D == 256 ? kDqStages256 : kDqStages;
  static constexpr int kRows = 16 * kWarps;  // query rows a block
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQ = kRows * D * 4;   // the block's Q or dO tile, bytes
  static constexpr int kKV = kKeys * D * 4;  // one K or V tile of a stage
  static constexpr size_t kBytes =
      1024 + 2 * kQ + kStages * 2 * kKV + (1 + 2 * kStages) * 8;
  static constexpr int kMinBlocks = min_blocks(kBytes, kThreads);
};

template <int D>
__global__ void __launch_bounds__(DqF32<D>::kThreads, DqF32<D>::kMinBlocks)
dq_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
              const float* __restrict__ corr, float* __restrict__ dq, int tq, int tk,
              int q_start, int k_start, float scale, int causal, int rounding) {
  using L = DqF32<D>;
  constexpr int N = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* sg = sq + L::kQ;   // dO
  unsigned char* skv = sg + L::kQ;  // stage s: K at s * 2 kKV, V kKV after it
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(skv + L::kStages * 2 * L::kKV);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;  // longest first
  const int n_kv = key_tiles(q0 + L::kRows, tq, tk, q_start, k_start, N, causal);

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kWarps);  // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 stages key tile `it` into its ring slot once every warp has
  // released the tile the slot held.
  auto stage = [&](int it) {
    const int s = it % L::kStages;
    mbar_wait(&empty[s], ((it / L::kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
    unsigned char* sk = skv + s * 2 * L::kKV;
    tma_rows_f32<D>(sk, &tm_k, N, it * N, bh, &full[s]);
    tma_rows_f32<D>(sk + L::kKV, &tm_v, N, it * N, bh, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(qg_full, 2 * L::kQ);
    tma_rows_f32<D>(sq, &tm_q, L::kRows, q0, bh, qg_full);
    tma_rows_f32<D>(sg, &tm_do, L::kRows, q0, bh, qg_full);
    for (int it = 0; it < min(L::kStages - 1, n_kv); ++it) stage(it);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows of the block's Q and dO tiles
  const int q0w = q0 + r0;
  const bool rows_in = q0w < tq;
  const int qpos0 = q_start + q0w + g;  // row g; row g + 8 is + 8
  const float scale_log2 = scale * kLog2e;
  // the key tiles these 16 rows see are a prefix of the block's
  const int n_own = rows_in ? key_tiles(q0w + 16, tq, tk, q_start, k_start, N, causal) : 0;
  // rows g and g + 8: lse in log2 units, corr (rows past tq give dS = 0:
  // their Q and dO rows read as zeros)
  float lse2[2], crr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0w + g + 8 * r;
    lse2[r] = row < tq ? lse[(size_t)bh * tq + row] * kLog2e : 0.f;
    crr[r] = row < tq ? corr[(size_t)bh * tq + row] : 0.f;
  }

  float acc[D / 2];
  zero(acc);
  mbar_wait(qg_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    // the ring runs kStages - 1 tiles ahead of the slowest warp
    if (threadIdx.x == 0 && it + L::kStages - 1 < n_kv) stage(it + L::kStages - 1);
    const int s = it % L::kStages;
    mbar_wait(&full[s], (it / L::kStages) & 1);
    if (it < n_own) {
      const unsigned char* sk = skv + s * 2 * L::kKV;
      const int k0 = it * N;
      float sc[N / 2], dp[N / 2];
      zero(sc);
      zero(dp);
      mma_kmajor<D, N>(sc, sq, L::kRows, r0, sk, N, g, t);           // S = Q.K^T
      mma_kmajor<D, N>(dp, sg, L::kRows, r0, sk + L::kKV, N, g, t);  // dP = dO.V^T
      const bool need_mask =
          (causal && k_start + k0 + N - 1 > q_start + q0w) || k0 + N > tk;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (need_mask) {
          // a masked p may be inf (a row with no visible key has lse -1e30):
          // select, never multiply
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool ok = col < tk && (!causal || k_start + col <= qpos0 + 8 * r);
          p = ok ? p : 0.f;
        }
        sc[i] = p * (dp[i] + crr[r]);  // dS, unscaled
      }
      if (rounding) {  // dS's dtype before dS.K (mixed inputs)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) sc[i] = round_to(sc[i], rounding >> 2);
      }
      mma_mnmajor<D, N>(acc, sc, sk, N, g, t);  // dQ += dS.K
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (!rows_in) return;
  store_perm<D>(dq + (size_t)bh * tq * D, acc, q0w + g, tq, scale, scale, t);
}

// ---------------------------------------------------------------------------
// Head dims above 256 (D a multiple of kWideCols): the wide kernels.
//
// At D = 512 a 16-row slab of Q alone is 32 KB and a warp's 16 x 512
// accumulator 256 registers a thread.  As in flash_attention.cu's wide
// kernels, a block owns one column slice of its rows' outputs (kWideCols =
// 128 columns: a warp's accumulators are those of the D = 128 blocks; a
// third grid axis, the fastest, so the slices of one tile run side by side
// and share their reads in L2) and computes the score products S = Q.K^T
// and dP = dO.V^T whole, streaming both operands one 32-column box at a
// time through a chunk ring: the box of the block's own 128 rows (Q; Q then
// dO for dQ; K then V for dK/dV) and of the streamed tile's rows (64 keys;
// 32 keys for dQ; 32 query rows for dK/dV), each box summed into a zeroed
// partial sum and folded into the scores by one round-to-nearest add, as
// mma_kmajor folds a box at every D.  A slice ring holds the streamed
// tile's rows of the block's columns (V, K, or dO and Q with their lse and
// corr rows), which mma_mnmajor reads as a whole tile at D = 128.  Warp 0
// loads both rings inline, kChunkStages - 1 chunks ahead and a tile's slice
// when it starts the tile (the scores of the tile take longer than the
// load).  8 warps, 16 rows each: query rows for the forward and dQ, keys
// for dK/dV.  Every slice recomputes the scores (at D = 512 the forward
// does 2.5x the JAX kernel's tensor work, dQ 3x, dK/dV 2.5x); every slice's
// lse is the same, and slice 0 writes it.  p and dS are rounded where the
// D <= 256 kernels round them (`rounding`).
// ---------------------------------------------------------------------------

constexpr int kWideCols = 128;  // output columns a wide block owns
constexpr int kWideRows = 128;  // rows a wide block owns: 8 warps of 16
constexpr int kWideWarps = kWideRows / 16, kWideThreads = 32 * kWideWarps;
constexpr int kWideFwdKeys = 64, kWideDqKeys = 32, kWideDkvQRows = 32;  // streamed rows
constexpr int kChunkStages = 4, kSliceStages = 2;

// A wide block's shared memory: the chunk ring (32 columns of the block's
// rows and of N streamed rows), the slice ring (kTensors tensors of N rows
// x kWideCols), kStats bytes of f32 rows a slice stage, the barriers.
template <int N, int kTensors, int kStats>
struct WideF32 {
  static constexpr int kA = kWideRows * 128;  // the block's rows of a chunk, bytes
  static constexpr int kChunk = kA + N * 128;
  static constexpr int kHalf = N * kWideCols * 4;  // one tensor of a slice stage
  static constexpr int kSlice = kTensors * kHalf;
  static constexpr int kSliceOff = kChunkStages * kChunk;
  static constexpr int kStatsOff = kSliceOff + kSliceStages * kSlice;
  static constexpr int kBarOff = kStatsOff + kSliceStages * kStats;
  static constexpr size_t kBytes = 1024 + kBarOff + 2 * (kChunkStages + kSliceStages) * 8;
};

// Every 32-column box of columns [col0, col0 + C) of rows [r, r + rows) of
// head h: C / 32 boxes of rows x 128 bytes, one after the other from dst.
template <int C>
__device__ __forceinline__ void tma_cols_f32(unsigned char* dst, const CUtensorMap* map,
                                             int rows, int r, int col0, int h, uint64_t* bar) {
#pragma unroll
  for (int box = 0; box < C / 32; ++box)
    tma_load(dst + box * rows * 128, map, col0 + 32 * box, r, h, bar);
}

struct WideBars {
  uint64_t *c_full, *c_empty, *s_full, *s_empty;
};

// The barriers after the rings: chunk full / empty, slice full / empty;
// `slice_arrivals` lanes of warp 0 arrive on a slice's full barrier.
__device__ __forceinline__ WideBars wide_bars(unsigned char* base, int slice_arrivals) {
  uint64_t* b = reinterpret_cast<uint64_t*>(base);
  WideBars bars = {b, b + kChunkStages, b + 2 * kChunkStages,
                   b + 2 * kChunkStages + kSliceStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kChunkStages; ++s) {
      mbar_init(&bars.c_full[s], 1);
      mbar_init(&bars.c_empty[s], kWideWarps);  // one arrival a warp
    }
    for (int s = 0; s < kSliceStages; ++s) {
      mbar_init(&bars.s_full[s], slice_arrivals);
      mbar_init(&bars.s_empty[s], kWideWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return bars;
}

// Chunk c: box `box` of map a's rows [a_row, a_row + 128) and map b's N rows
// from b_row, once every warp has released the chunk the stage held.
template <int N>
__device__ __forceinline__ void load_chunk(unsigned char* chunks, const WideBars& bars, int c,
                                           const CUtensorMap* a, int a_row,
                                           const CUtensorMap* b, int b_row, int box, int bh) {
  using L = WideF32<N, 1, 0>;
  const int s = c % kChunkStages;
  mbar_wait(&bars.c_empty[s], ((c / kChunkStages) & 1) ^ 1);
  mbar_arrive_expect_tx(&bars.c_full[s], L::kChunk);
  unsigned char* st = chunks + s * L::kChunk;
  tma_load(st, a, 32 * box, a_row, bh, &bars.c_full[s]);
  tma_load(st + L::kA, b, 32 * box, b_row, bh, &bars.c_full[s]);
}

__device__ __forceinline__ void release_stage(uint64_t* empty, int i, int stages, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[i % stages]);
}

// acc (16 x N) += rows [r0, r0 + 16) of the A parts of chunks c .. c + n -
// 1 times their B parts^T (skipped when !own; each chunk is still taken
// and released); c is advanced.  Thread 0 first loads chunk c +
// kChunkStages - 1 (`load(i)`, while i < total).
template <int N, typename Load>
__device__ __forceinline__ void wide_scores(float (&acc)[N / 2], unsigned char* chunks,
                                            const WideBars& bars, int& c, int n, int total,
                                            bool own, int r0, int g, int t, int lane,
                                            Load&& load) {
  using L = WideF32<N, 1, 0>;
  for (int i = 0; i < n; ++i, ++c) {
    if (threadIdx.x == 0 && c + kChunkStages - 1 < total) load(c + kChunkStages - 1);
    const int s = c % kChunkStages;
    mbar_wait(&bars.c_full[s], (c / kChunkStages) & 1);
    if (own) {
      const unsigned char* st = chunks + s * L::kChunk;
      mma_kmajor<32, N>(acc, st, kWideRows, r0, st + L::kA, N, g, t);
    }
    release_stage(bars.c_empty, c, kChunkStages, lane);
  }
}

// Forward above D = 256: one block per (column slice, bh, 128 query rows),
// the last tiles first.
__global__ void __launch_bounds__(kWideThreads, 1)
fwd_wide_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                    float* __restrict__ lse, int tq, int tk, int d, int q_start, int k_start,
                    float scale, int causal, int rounding) {
  constexpr int N = kWideFwdKeys, C = kWideCols;
  using L = WideF32<N, 1, 0>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* chunks = align_1024(smem_raw);
  unsigned char* slices = chunks + L::kSliceOff;
  const WideBars bars = wide_bars(chunks + L::kBarOff, 1);

  const int col0 = blockIdx.x * C, bh = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWideRows;  // longest first
  const int n_box = d / 32;
  const int n_kv = key_tiles(q0 + kWideRows, tq, tk, q_start, k_start, N, causal);
  const int total = n_kv * n_box;
  auto load = [&](int c) {  // S = Q.K^T, box by box
    load_chunk<N>(chunks, bars, c, &tm_q, q0, &tm_k, c / n_box * N, c % n_box, bh);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < min(kChunkStages - 1, total); ++c) load(c);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int q0w = q0 + r0;
  const bool rows_in = q0w < tq;
  const int qpos0 = q_start + q0w + g;  // row g; row g + 8 is + 8
  const float scale_log2 = scale * kLog2e;
  const int p_round = rounding & 3;  // p's dtype before P.V (mixed inputs)
  const int n_own = rows_in ? key_tiles(q0w + 16, tq, tk, q_start, k_start, N, causal) : 0;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[C / 2];
  zero(acc);
  int c = 0;
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kSliceStages;
    if (threadIdx.x == 0) {  // the tile's V slice
      mbar_wait(&bars.s_empty[s], ((it / kSliceStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&bars.s_full[s], L::kSlice);
      tma_cols_f32<C>(slices + s * L::kSlice, &tm_v, N, it * N, col0, bh, &bars.s_full[s]);
    }
    const bool own = it < n_own;
    float sc[N / 2];
    zero(sc);
    wide_scores<N>(sc, chunks, bars, c, n_box, total, own, r0, g, t, lane, load);
    mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
    if (own) {
      const int k0 = it * N;
      float alpha[2];
      const bool need_mask =
          (causal && k_start + k0 + N - 1 > q_start + q0w) || k0 + N > tk;
      online_softmax(sc, alpha, m, l, scale_log2, need_mask, k0, tk, causal, k_start, qpos0,
                     t);
      if (p_round) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) sc[i] = round_to(sc[i], p_round);
      }
#pragma unroll
      for (int i = 0; i < C / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      mma_mnmajor<C, N>(acc, sc, slices + s * L::kSlice, N, g, t);  // O += P.V slice
    }
    release_stage(bars.s_empty, it, kSliceStages, lane);
  }

  if (!rows_in) return;
  const int row_g = q0w + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  store_perm<C>(o + (size_t)bh * tq * d + col0, acc, row_g, tq, inv[0], inv[1], t, d);
  if (t == 0 && blockIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_g + 8 * r < tq)
        lse[(size_t)bh * tq + row_g + 8 * r] =
            m[r] > kMaskThresh ? m[r] * scale + log2f(fmaxf(l[r], 1e-30f)) * kLn2
                               : kNegInf;
  }
}

// dK/dV above D = 256: one block per (column slice, bh, 128 keys), the first
// tiles first; warp 0 stores each query tile's lse (log2 units) and corr
// beside its dO and Q slices.
__global__ void __launch_bounds__(kWideThreads, 1)
dkv_wide_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ corr, float* __restrict__ dk,
                    float* __restrict__ dv, int tq, int tk, int d, int q_start, int k_start,
                    float scale, int causal, int rounding) {
  constexpr int QT = kWideDkvQRows, C = kWideCols;
  using L = WideF32<QT, 2, 2 * QT * 4>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* chunks = align_1024(smem_raw);
  unsigned char* slices = chunks + L::kSliceOff;  // stage s: dO, then Q kHalf after it
  float* stats = reinterpret_cast<float*>(chunks + L::kStatsOff);  // [s][2][QT]
  const WideBars bars = wide_bars(chunks + L::kBarOff, 32);

  const int col0 = blockIdx.x * C, bh = blockIdx.y;
  const int k0 = blockIdx.z * kWideRows;  // longest first
  const int n_box = d / 32;
  const int n_qt = (tq + QT - 1) / QT;
  int it0 = 0;  // first query tile that reaches a key of this block
  if (causal) {
    const int first = k_start + k0 - q_start;
    it0 = first <= 0 ? 0 : (first > tq - 1 ? n_qt : first / QT);
  }
  const int n_it = n_qt - it0;
  const int total = n_it * 2 * n_box;
  auto load = [&](int c) {  // S^T = K.Q^T, then dP^T = V.dO^T, box by box
    const int it = c / (2 * n_box), j = c % (2 * n_box), q0 = (it0 + it) * QT;
    if (j < n_box)
      load_chunk<QT>(chunks, bars, c, &tm_k, k0, &tm_q, q0, j, bh);
    else
      load_chunk<QT>(chunks, bars, c, &tm_v, k0, &tm_do, q0, j - n_box, bh);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < min(kChunkStages - 1, total); ++c) load(c);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's keys of the block
  const int k0w = k0 + r0;
  const bool keys_in = k0w < tk;
  const int kpos0 = k_start + k0w + g;  // key g; key g + 8 is + 8
  const float scale_log2 = scale * kLog2e;
  const int p_round = rounding & 3, ds_round = rounding >> 2;
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* corr_bh = corr + (size_t)bh * tq;

  float dk_acc[C / 2], dv_acc[C / 2];
  zero(dk_acc);
  zero(dv_acc);
  int c = 0;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kSliceStages, q0 = (it0 + it) * QT;
    float* st_lse = stats + s * 2 * QT;
    if (warp == 0) {  // the tile's lse and corr rows, dO and Q slices
      mbar_wait(&bars.s_empty[s], ((it / kSliceStages) & 1) ^ 1);
      for (int r = lane; r < QT; r += 32) {
        const int row = q0 + r;
        st_lse[r] = row < tq ? lse_bh[row] * kLog2e : 0.f;
        st_lse[QT + r] = row < tq ? corr_bh[row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&bars.s_full[s], L::kSlice);
        unsigned char* sl = slices + s * L::kSlice;
        tma_cols_f32<C>(sl, &tm_do, QT, q0, col0, bh, &bars.s_full[s]);
        tma_cols_f32<C>(sl + L::kHalf, &tm_q, QT, q0, col0, bh, &bars.s_full[s]);
      } else {
        mbar_arrive(&bars.s_full[s]);
      }
    }
    // query tiles wholly above the diagonal reach no key of this warp
    const bool own = keys_in && !(causal && q_start + min(q0 + QT, tq) - 1 < k_start + k0w);
    float st[QT / 2], dpt[QT / 2];  // S^T and dP^T: 16 keys x QT queries
    zero(st);
    zero(dpt);
    wide_scores<QT>(st, chunks, bars, c, n_box, total, own, r0, g, t, lane, load);
    wide_scores<QT>(dpt, chunks, bars, c, n_box, total, own, r0, g, t, lane, load);
    mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
    if (own) {
      const float* st_corr = st_lse + QT;
      const bool need_mask =
          (causal && k_start + k0w + 15 > q_start + q0) || q0 + QT > tq;
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(st_lse + qc);
        const float2 cv = *reinterpret_cast<const float2*>(st_corr + qc);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int r = cc >> 1, h = cc & 1, idx = 4 * j + cc;
          float p = ex2(fmaf(st[idx], scale_log2, -(h ? lv.y : lv.x)));
          if (need_mask) {
            const int qrow = q0 + qc + h;
            const bool ok = qrow < tq && (!causal || kpos0 + 8 * r <= q_start + qrow);
            p = ok ? p : 0.f;
          }
          st[idx] = p;
          dpt[idx] = p * (dpt[idx] + (h ? cv.y : cv.x));  // dS^T, unscaled
        }
      }
      if (rounding) {
#pragma unroll
        for (int i = 0; i < QT / 2; ++i) {
          st[i] = round_to(st[i], p_round);
          dpt[i] = round_to(dpt[i], ds_round);
        }
      }
      const unsigned char* sg = slices + s * L::kSlice;
      mma_mnmajor<C, QT>(dv_acc, st, sg, QT, g, t);             // dV += P^T.dO slice
      mma_mnmajor<C, QT>(dk_acc, dpt, sg + L::kHalf, QT, g, t);  // dK += dS^T.Q slice
    }
    release_stage(bars.s_empty, it, kSliceStages, lane);
  }

  if (!keys_in) return;
  const int row_g = k0w + g;
  const size_t off = (size_t)bh * tk * d + col0;
  store_perm<C>(dk + off, dk_acc, row_g, tk, scale, scale, t, d);
  store_perm<C>(dv + off, dv_acc, row_g, tk, 1.f, 1.f, t, d);
}

// dQ above D = 256: one block per (column slice, bh, 128 query rows), the
// last tiles first; S and dP from the chunk ring, dQ += dS . the K slice.
__global__ void __launch_bounds__(kWideThreads, 1)
dq_wide_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                   const float* __restrict__ corr, float* __restrict__ dq, int tq, int tk,
                   int d, int q_start, int k_start, float scale, int causal, int rounding) {
  constexpr int N = kWideDqKeys, C = kWideCols;
  using L = WideF32<N, 1, 0>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* chunks = align_1024(smem_raw);
  unsigned char* slices = chunks + L::kSliceOff;
  const WideBars bars = wide_bars(chunks + L::kBarOff, 1);

  const int col0 = blockIdx.x * C, bh = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWideRows;  // longest first
  const int n_box = d / 32;
  const int n_kv = key_tiles(q0 + kWideRows, tq, tk, q_start, k_start, N, causal);
  const int total = n_kv * 2 * n_box;
  auto load = [&](int c) {  // S = Q.K^T, then dP = dO.V^T, box by box
    const int it = c / (2 * n_box), j = c % (2 * n_box);
    if (j < n_box)
      load_chunk<N>(chunks, bars, c, &tm_q, q0, &tm_k, it * N, j, bh);
    else
      load_chunk<N>(chunks, bars, c, &tm_do, q0, &tm_v, it * N, j - n_box, bh);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < min(kChunkStages - 1, total); ++c) load(c);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int q0w = q0 + r0;
  const bool rows_in = q0w < tq;
  const int qpos0 = q_start + q0w + g;  // row g; row g + 8 is + 8
  const float scale_log2 = scale * kLog2e;
  const int n_own = rows_in ? key_tiles(q0w + 16, tq, tk, q_start, k_start, N, causal) : 0;
  float lse2[2], crr[2];  // rows g and g + 8: lse in log2 units, corr
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0w + g + 8 * r;
    lse2[r] = row < tq ? lse[(size_t)bh * tq + row] * kLog2e : 0.f;
    crr[r] = row < tq ? corr[(size_t)bh * tq + row] : 0.f;
  }

  float acc[C / 2];
  zero(acc);
  int c = 0;
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kSliceStages;
    if (threadIdx.x == 0) {  // the tile's K slice
      mbar_wait(&bars.s_empty[s], ((it / kSliceStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&bars.s_full[s], L::kSlice);
      tma_cols_f32<C>(slices + s * L::kSlice, &tm_k, N, it * N, col0, bh, &bars.s_full[s]);
    }
    const bool own = it < n_own;
    float sc[N / 2], dp[N / 2];
    zero(sc);
    zero(dp);
    wide_scores<N>(sc, chunks, bars, c, n_box, total, own, r0, g, t, lane, load);
    wide_scores<N>(dp, chunks, bars, c, n_box, total, own, r0, g, t, lane, load);
    mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
    if (own) {
      const int k0 = it * N;
      const bool need_mask =
          (causal && k_start + k0 + N - 1 > q_start + q0w) || k0 + N > tk;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (need_mask) {  // select, never multiply: a masked p may be inf
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool ok = col < tk && (!causal || k_start + col <= qpos0 + 8 * r);
          p = ok ? p : 0.f;
        }
        sc[i] = p * (dp[i] + crr[r]);  // dS, unscaled
      }
      if (rounding) {  // dS's dtype before dS.K (mixed inputs)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) sc[i] = round_to(sc[i], rounding >> 2);
      }
      mma_mnmajor<C, N>(acc, sc, slices + s * L::kSlice, N, g, t);  // dQ += dS.K slice
    }
    release_stage(bars.s_empty, it, kSliceStages, lane);
  }

  if (!rows_in) return;
  store_perm<C>(dq + (size_t)bh * tq * d + col0, acc, q0w + g, tq, scale, scale, t, d);
}

// ---- host -------------------------------------------------------------------

// A 3-D map of a contiguous [bh, t, d] f32 tensor read in boxes of `rows`
// rows x 32 columns (128 bytes) with the 128-byte swizzle.  Rows at or past
// t of a head read as zeros, never the next head's rows.  0 or an error code.
inline int encode_rows_map_f32(CUtensorMap* map, const void* ptr, int bh, int t, int d,
                               int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)t * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
               int tq, int tk, int q_start, int k_start, float scale, int causal,
               int rounding, cudaStream_t stream) {
  using L = FwdF32<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_rows_map_f32(&tm_q, q, bh, tq, D, L::kRows);
  if (!err) err = encode_rows_map_f32(&tm_k, k, bh, tk, D, L::kKeys);
  if (!err) err = encode_rows_map_f32(&tm_v, v, bh, tk, D, L::kKeys);
  if (!err) err = prepare(fwd_f32_kernel<D>, L::kBytes);
  if (err) return err;
  dim3 grid(bh, (tq + L::kRows - 1) / L::kRows);
  fwd_f32_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, (float*)o, (float*)lse, tq, tk, q_start, k_start, scale, causal,
      rounding);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* corr, void* dk, void* dv, int bh, int tq,
               int tk, int q_start, int k_start, float scale, int causal, int rounding,
               cudaStream_t stream) {
  using L = DkvF32<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map_f32(&tm_q, q, bh, tq, D, L::kQRows);
  if (!err) err = encode_rows_map_f32(&tm_do, dout, bh, tq, D, L::kQRows);
  if (!err) err = encode_rows_map_f32(&tm_k, k, bh, tk, D, L::kRows);
  if (!err) err = encode_rows_map_f32(&tm_v, v, bh, tk, D, L::kRows);
  if (!err) err = prepare(dkv_f32_kernel<D>, L::kBytes);
  if (err) return err;
  dim3 grid(bh, (tk + L::kRows - 1) / L::kRows);
  dkv_f32_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (float*)dk,
      (float*)dv, tq, tk, q_start, k_start, scale, causal, rounding);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* corr, void* dq, int bh, int tq, int tk,
              int q_start, int k_start, float scale, int causal, int rounding,
              cudaStream_t stream) {
  using L = DqF32<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map_f32(&tm_q, q, bh, tq, D, L::kRows);
  if (!err) err = encode_rows_map_f32(&tm_do, dout, bh, tq, D, L::kRows);
  if (!err) err = encode_rows_map_f32(&tm_k, k, bh, tk, D, L::kKeys);
  if (!err) err = encode_rows_map_f32(&tm_v, v, bh, tk, D, L::kKeys);
  if (!err) err = prepare(dq_f32_kernel<D>, L::kBytes);
  if (err) return err;
  dim3 grid(bh, (tq + L::kRows - 1) / L::kRows);
  dq_f32_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (float*)dq, tq, tk,
      q_start, k_start, scale, causal, rounding);
  return (int)cudaGetLastError();
}

using WideFwdF32 = WideF32<kWideFwdKeys, 1, 0>;
using WideDkvF32 = WideF32<kWideDkvQRows, 2, 2 * kWideDkvQRows * 4>;
using WideDqF32 = WideF32<kWideDqKeys, 1, 0>;

// A head dim the wide kernels take: above 256, a multiple of kWideCols.
inline bool wide_head_dim(int d) { return d > 256 && d % kWideCols == 0; }

int launch_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int tq, int tk, int d, int q_start, int k_start, float scale, int causal,
                    int rounding, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_rows_map_f32(&tm_q, q, bh, tq, d, kWideRows);
  if (!err) err = encode_rows_map_f32(&tm_k, k, bh, tk, d, kWideFwdKeys);
  if (!err) err = encode_rows_map_f32(&tm_v, v, bh, tk, d, kWideFwdKeys);
  if (!err) err = prepare(fwd_wide_f32_kernel, WideFwdF32::kBytes);
  if (err) return err;
  dim3 grid(d / kWideCols, bh, (tq + kWideRows - 1) / kWideRows);
  fwd_wide_f32_kernel<<<grid, kWideThreads, WideFwdF32::kBytes, stream>>>(
      tm_q, tm_k, tm_v, (float*)o, (float*)lse, tq, tk, d, q_start, k_start, scale, causal,
      rounding);
  return (int)cudaGetLastError();
}

int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* corr, void* dk, void* dv, int bh, int tq,
                    int tk, int d, int q_start, int k_start, float scale, int causal,
                    int rounding, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map_f32(&tm_q, q, bh, tq, d, kWideDkvQRows);
  if (!err) err = encode_rows_map_f32(&tm_do, dout, bh, tq, d, kWideDkvQRows);
  if (!err) err = encode_rows_map_f32(&tm_k, k, bh, tk, d, kWideRows);
  if (!err) err = encode_rows_map_f32(&tm_v, v, bh, tk, d, kWideRows);
  if (!err) err = prepare(dkv_wide_f32_kernel, WideDkvF32::kBytes);
  if (err) return err;
  dim3 grid(d / kWideCols, bh, (tk + kWideRows - 1) / kWideRows);
  dkv_wide_f32_kernel<<<grid, kWideThreads, WideDkvF32::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (float*)dk, (float*)dv,
      tq, tk, d, q_start, k_start, scale, causal, rounding);
  return (int)cudaGetLastError();
}

int launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* corr, void* dq, int bh, int tq, int tk, int d,
                   int q_start, int k_start, float scale, int causal, int rounding,
                   cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map_f32(&tm_q, q, bh, tq, d, kWideRows);
  if (!err) err = encode_rows_map_f32(&tm_do, dout, bh, tq, d, kWideRows);
  if (!err) err = encode_rows_map_f32(&tm_k, k, bh, tk, d, kWideDqKeys);
  if (!err) err = encode_rows_map_f32(&tm_v, v, bh, tk, d, kWideDqKeys);
  if (!err) err = prepare(dq_wide_f32_kernel, WideDqF32::kBytes);
  if (err) return err;
  dim3 grid(d / kWideCols, bh, (tq + kWideRows - 1) / kWideRows);
  dq_wide_f32_kernel<<<grid, kWideThreads, WideDqF32::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (float*)dq, tq, tk, d,
      q_start, k_start, scale, causal, rounding);
  return (int)cudaGetLastError();
}

constexpr int kBadHeadDim = -1;

template <int D>
int f32_occupancy(int which, int* out) {
  using F = FwdF32<D>;
  using K = DkvF32<D>;
  using Q = DqF32<D>;
  if (which == 0) return occupancy(fwd_f32_kernel<D>, F::kBytes, F::kThreads, out);
  if (which == 1) return occupancy(dkv_f32_kernel<D>, K::kBytes, K::kThreads, out);
  if (which == 2) return occupancy(dq_f32_kernel<D>, Q::kBytes, Q::kThreads, out);
  return kBadHeadDim;
}

}  // namespace

// `rounding`: bits 0-1 the dtype p is rounded to, bits 2-3 dS's (round_to's
// codes; 0 for f32 inputs).
extern "C" {

int bf_flash_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                     int bh, int tq, int tk, int d, int q_start, int k_start, float scale,
                     int causal, int rounding, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_fwd<64>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal,
                          rounding, s);
  if (d == 128)
    return launch_fwd<128>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal,
                           rounding, s);
  if (d == 256)
    return launch_fwd<256>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal,
                           rounding, s);
  if (wide_head_dim(d))
    return launch_fwd_wide(q, k, v, o, lse, bh, tq, tk, d, q_start, k_start, scale, causal,
                           rounding, s);
  return kBadHeadDim;
}

int bf_flash_f32_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* corr, void* dk, void* dv, int bh,
                         int tq, int tk, int d, int q_start, int k_start, float scale,
                         int causal, int rounding, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                          scale, causal, rounding, s);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                           scale, causal, rounding, s);
  if (d == 256)
    return launch_dkv<256>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                           scale, causal, rounding, s);
  if (wide_head_dim(d))
    return launch_dkv_wide(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, d, q_start, k_start,
                           scale, causal, rounding, s);
  return kBadHeadDim;
}

int bf_flash_f32_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* corr, void* dq, int bh, int tq,
                        int tk, int d, int q_start, int k_start, float scale, int causal,
                        int rounding, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start, scale,
                         causal, rounding, s);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start,
                          scale, causal, rounding, s);
  if (d == 256)
    return launch_dq<256>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start,
                          scale, causal, rounding, s);
  if (wide_head_dim(d))
    return launch_dq_wide(q, k, v, dout, lse, corr, dq, bh, tq, tk, d, q_start, k_start, scale,
                          causal, rounding, s);
  return kBadHeadDim;
}

// which: 0 forward, 1 dK/dV, 2 dQ; out as occupancy() above (4 ints).
int bf_flash_f32_occupancy(int which, int d, int* out) {
  if (d == 64) return f32_occupancy<64>(which, out);
  if (d == 128) return f32_occupancy<128>(which, out);
  if (d == 256) return f32_occupancy<256>(which, out);
  if (wide_head_dim(d)) {
    if (which == 0)
      return occupancy(fwd_wide_f32_kernel, WideFwdF32::kBytes, kWideThreads, out);
    if (which == 1)
      return occupancy(dkv_wide_f32_kernel, WideDkvF32::kBytes, kWideThreads, out);
    if (which == 2) return occupancy(dq_wide_f32_kernel, WideDqF32::kBytes, kWideThreads, out);
  }
  return kBadHeadDim;
}

}  // extern "C"
