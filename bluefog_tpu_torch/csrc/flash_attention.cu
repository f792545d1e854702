// Flash attention for Hopper (sm_90a): forward, dK/dV backward, dQ backward.
//
// Replaces the three Pallas TPU kernels of bluefog_tpu/kernels/flash_attention.py:
//   fwd_kernel  <- _fwd_kernel      (:246, launched by _flash_fwd :356)
//   dkv_kernel  <- _bwd_dkv_kernel  (:490, launched by _flash_bwd_pallas :686)
//   dq_kernel   <- _bwd_dq_kernel   (:575, launched by _flash_bwd_pallas :708)
// and above D = 256 fwd_wide_kernel, dkv_wide_kernel, dq_wide_kernel.
//
// Contract (same as the TPU kernels): q, k, v, o, dO are [BH, T, D] of one
// type T, bf16 or f16, contiguous, D = 64, 128 or 256, or a multiple of
// 256 above that (the wide kernels, at the end); lse and corr are [BH, Tq]
// f32.  Causal masking uses global
// positions (q_start + row, k_start + col; visible iff kpos <= qpos), so one
// kernel serves plain attention and every ring-attention hop.  Rows with no
// visible key give o = 0 and lse = -1e30.  Accumulation is f32; rounding
// points match the TPU kernels: p is rounded to T before p.V and p^T.dO
// (the reference's p.astype(v.dtype)), dS is rounded to T before dS.K and
// dS^T.Q (ds.astype(q.dtype)), and the softmax scale multiplies the dK and
// dQ accumulators once at the end.  lse is the natural-log log-sum-exp.
//
// What bounds these kernels on the H100: at the main path's shapes (D = 64,
// T = 2048) attention does ~64 flops per byte of q/k/v per key tile, so the
// work is tensor-core bound (989 TFLOP/s bf16 and f16), and the causal mask
// leaves blocks of very unequal length.
//
// All three kernels are built for Hopper (sm90_tile.cuh):
//   * Products on wgmma.  A block is one producer warpgroup and two consumer
//     warpgroups of 64 rows each, which share every staged tile (128 query
//     rows a forward or dQ block, 128 keys a dK/dV block).  S = Q.K^T,
//     dP = dO.V^T, S^T = K.Q^T and dP^T = V.dO^T read both operands from
//     shared memory (K-major); O += P.V, dQ += dS.K, dV += P^T.dO and dK +=
//     dS^T.Q take P or dS from registers (the rounded accumulator re-packed
//     as the A operand) and the other operand from shared memory, MN-major
//     (dQ reads the one staged K tile both ways).  Scores, p and dS never
//     leave registers.
//   * Asynchronous staging.  One producer thread streams the K/V tiles of
//     the forward and dQ, or dK/dV's Q/dO tiles, by TMA through 3-D tensor
//     maps (rows past T read as zeros) into a ring (kFwdStages, kDqStages,
//     kDkvStages deep), each stage with a "full" and an "empty" mbarrier;
//     the block's own Q (forward), Q and dO (dQ) or K/V (dK/dV) tiles arrive
//     once, by TMA too.  dK/dV's lse and corr rows ride the same stage,
//     stored by the producer warp's lanes; dQ's are fixed per row, so each
//     consumer thread reads its two rows once.  The producer gives its
//     registers to the consumers (setmaxnreg), which holds D = 128 dK/dV's
//     four accumulators.  No block-wide barrier sits in the tile loop.
//   * Overlap inside a forward or dQ warpgroup: the score products of key
//     tile i (S; or S and dP) are issued before the register product of
//     tile i - 1 (P.V; or dS.K) and waited for alone, so one product runs
//     on the tensor cores while the elementwise work of the other tile is
//     done (a warpgroup holds two stages while the producer fills the rest).
//   * exp2 (ex2.approx.ftz): log2(e) is folded into the scale, one FFMA and
//     one ex2 an element, masks only on the tiles that cross the diagonal
//     or the end; the forward's lse goes back to the natural log when it is
//     written, the backward takes lse in log2 units once.
//   * A longest-first causal schedule.  The tile index is the slowest grid
//     axis, walked in reverse for the forward and dQ (the last query tiles
//     see the most keys) and forward for dK/dV (the first key tiles see the
//     most queries), so the longest blocks of all heads launch first.  Chain
//     length is monotone in the tile index for any q_start/k_start.
//     launch_order() in kernels/flash_attention.py mirrors this arithmetic.
//   A consumer warpgroup whose 64 rows see nothing of a staged tile (past
//   the diagonal or past the end) skips its products but still releases
//   the stage.
//
// D = 256 keeps that block where shared memory and registers allow: a block
// gets 227 KB of shared memory, and a warpgroup's 64 x 256 f32 accumulator
// is 128 registers a thread of the 240 a consumer holds.
//   * Forward: the 64 KB Q tile and a ring of two 64 KB K/V stages.  A
//     warpgroup runs its tiles in turn (S, softmax, P.V) while the producer
//     fills the other stage: the overlap above would hold both stages.
//   * dQ: the Q and dO tiles (128 KB) leave room for one K/V stage, so
//     loads and products take turns.
//   * dK/dV (kDkvSplit): two accumulators of 128 registers do not fit
//     a warpgroup, so a block owns 64 keys and warpgroup w owns columns
//     [128 w, 128 w + 128) of their dK and dV.  Both warpgroups compute the
//     block's S^T and dP^T over the whole head dim (the score products
//     twice, where sharing P and dS through shared memory would put a
//     barrier between the warpgroups each tile); a ring of two Q/dO stages.
// These are first versions, right before fast; PERF.md has their times.
//
// Every launcher runs on the caller's stream, allocates nothing and returns
// 0, cudaGetLastError(), the error of the attribute call before it, or a
// tensor-map encode failure (sm90_tile.cuh: kNoEncoder, kEncodeFailed + r).

#include "sm90_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;      // finite mask sentinel
constexpr float kMaskThresh = -0.5e30f;

// ---------------------------------------------------------------------------
// Shared layout of the three kernels
// ---------------------------------------------------------------------------

// Ring depths: a forward or dQ warpgroup holds two stages (the score
// products' tile and the one before it, whose V or K its register product
// still reads), a dK/dV warpgroup one.  Block shape and depths are the
// fastest measured (benchmarks/flash_variants.py; PERF.md).  D = 256 has
// room for two forward stages and one dQ stage (above).
constexpr int kFwdStages = 4;
constexpr int kDqStages = 4;
constexpr int kDkvStages = 2;
constexpr int kFwdStages256 = 2, kDqStages256 = 1;
template <int D>
constexpr int kFwdRing = D == 256 ? kFwdStages256 : kFwdStages;
template <int D>
constexpr int kDqRing = D == 256 ? kDqStages256 : kDqStages;
constexpr int kConsumers = 2;                  // consumer warpgroups a block
constexpr int kBlockRows = 64 * kConsumers;    // rows a block owns
constexpr int kSm90Threads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 24*128 + 240*256 <= 64K
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Store one warpgroup's 64 x N f32 accumulator (times `mul` per row half)
// as T into rows `ld` elements apart; row_g is this thread's first row,
// rows past `rows` are dropped.
template <int N, typename T>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[N / 2], int row_g,
                                          int rows, float mul0, float mul1, int t,
                                          int ld = N) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= rows) continue;
    const float mul = r ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * ld + 8 * j + 2 * t) =
          pack2<T>(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (bh, 128-row query tile), the last tiles first; the
// producer streams key tiles up to the diagonal.
// ---------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kStages = kFwdRing<D>;
  static constexpr int kQ = kBlockRows * D * 2;  // the block's Q tile, bytes
  static constexpr int kKV = kTile * D * 2;      // one K or V tile of a stage
  static constexpr size_t kBytes =
      1024 + kQ + kStages * 2 * kKV + (1 + 2 * kStages) * 8;
};

// S (64 x 64) = this warpgroup's Q rows . the staged K tile^T, issued; dQ
// issues dP = its dO rows . the staged V tile^T through it too.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<T>(sc, desc_k_major(q_addr, kBlockRows, kk), desc_k_major(k_addr, kTile, kk),
                    kk);
}

// O += P (registers, T) . the staged V tile, issued; dQ issues dQ +=
// dS . the staged K tile through it too.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[4][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D, T>(acc, pa[kk], desc_mn_major(v_addr, kTile, kk));
}

// One key tile of the online softmax.  sc holds raw scores; m is the
// running max of the raw scores (the sentinel while a row has seen no
// visible key) and l the running sum.  Masked entries become the sentinel,
// whose exponent underflows to exactly 0, and a row whose max is still the
// sentinel takes its exponents against 0, so it sums nothing (where exp of
// sentinel - sentinel would give 1).  One FFMA and one ex2 an element:
// p = 2^(s * scale log2 e - m * scale log2 e).  Leaves p in sc and the
// factor the output must be rescaled by in alpha.
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&alpha)[2],
                                               float (&m)[2], float (&l)[2],
                                               float scale_log2, bool need_mask, int k0,
                                               int tk, int causal, int k_start, int qpos0,
                                               int t) {
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool ok =
          col < tk && (!causal || k_start + col <= qpos0 + ((i >> 1) & 1) * 8);
      sc[i] = ok ? sc[i] : kNegInf;
    }
  }
  float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) mcur[(i >> 1) & 1] = fmaxf(mcur[(i >> 1) & 1], sc[i]);
  float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mnew = fmaxf(m[r], quad_max(mcur[r]));
    alpha[r] = ex2((m[r] - mnew) * scale_log2);
    m[r] = mnew;
    ms[r] = (mnew > kMaskThresh ? mnew : 0.f) * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], scale_log2, -ms[r]));
    sc[i] = p;
    rs[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
           float* __restrict__ lse, int tq, int tk, int q_start, int k_start, float scale,
           int causal) {
  using L = FwdSmem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* skv = sq + L::kQ;  // stage s: K at s * 2 kKV, V kKV after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + kStages * 2 * L::kKV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest first
  const int q_last = q_start + min(q0 + kBlockRows, tq) - 1;
  int n_kv = (tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q_last >= k_start ? (q_last - k_start) / kTile + 1 : 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, L::kQ);
      tma_load_rows<D>(sq, &tm_q, kBlockRows, q0, bh, q_full);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
        unsigned char* sk = skv + s * 2 * L::kKV;
        tma_load_rows<D>(sk, &tm_k, kTile, it * kTile, bh, &full[s]);
        tma_load_rows<D>(sk + L::kKV, &tm_v, kTile, it * kTile, bh, &full[s]);
      }
    }
    return;
  }

  regs_claim<kConsumerRegs>();
  const int w = wg - 1;  // rows [64 w, 64 w + 64) of the block
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0w = q0 + 64 * w;
  const bool rows_in = q0w < tq;
  const int q_last_w = q_start + min(q0w + 64, tq) - 1;
  const int qpos0 = q_start + q0w + warp * 16 + g;  // row g; row g+8 is +8
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_u32(sq) + w * 64 * 128;
  // the key tiles these 64 rows see are a prefix of the block's
  int n_own = rows_in ? n_kv : 0;
  if (causal && rows_in)
    n_own = min(n_kv, q_last_w >= k_start ? (q_last_w - k_start) / kTile + 1 : 0);

  auto k_tile = [&](int it) { return smem_u32(skv + (it % kStages) * 2 * L::kKV); };
  auto wait_full = [&](int it) {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kStages]);
  };
  auto softmax = [&](float (&sc)[32], float (&alpha)[2], float (&m)[2], float (&l)[2],
                     int k0) {
    const bool need_mask =
        (causal && k_start + k0 + kTile - 1 > q_start + q0w) || k0 + kTile > tk;
    online_softmax(sc, alpha, m, l, scale_log2, need_mask, k0, tk, causal, k_start, qpos0, t);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2];
  zero(acc);
  mbar_wait(q_full, 0);

  if constexpr (D == 256) {
    // Tiles in turn: S, the softmax, P.V; the producer fills the other
    // stage meanwhile.
    float sc[32], alpha[2];
    uint32_t pa[4][4];
    for (int it = 0; it < n_own; ++it) {
      wait_full(it);
      zero(sc);
      wgmma_fence();
      issue_qk<T, D>(sc, q_addr, k_tile(it));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, alpha, m, l, it * kTile);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(pa[kk], sc, kk);
      wgmma_fence();
      issue_pv<T, D>(acc, pa, k_tile(it) + L::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(it);
    }
  } else if (n_own > 0) {
    // Software pipeline inside the warpgroup: S of key tile it runs on the
    // tensor cores while the softmax of tile it - 1 is done, and P.V of
    // tile it - 1 while the softmax of tile it is done.
    float sc[32], alpha[2];
    uint32_t pa[4][4];
    wait_full(0);
    zero(sc);
    wgmma_fence();
    issue_qk<T, D>(sc, q_addr, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, alpha, m, l, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(pa[kk], sc, kk);
    for (int it = 1; it < n_own; ++it) {
      wait_full(it);
      wgmma_fence();
      issue_qk<T, D>(sc, q_addr, k_tile(it));
      wgmma_commit();
      issue_pv<T, D>(acc, pa, k_tile(it - 1) + L::kKV);
      wgmma_commit();
      fence_regs(sc);
      fence_regs(acc);
      wgmma_wait<1>();  // S of tile it is done; P.V of tile it - 1 may run
      fence_regs(sc);
      softmax(sc, alpha, m, l, it * kTile);
      fence_regs(sc);  // the softmax runs while P.V does, not after it
      fence_regs(alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      release(it - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(pa[kk], sc, kk);
    }
    wgmma_fence();
    issue_pv<T, D>(acc, pa, k_tile(n_own - 1) + L::kKV);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(n_own - 1);
  }
  for (int it = n_own; it < n_kv; ++it) {  // past these rows' diagonal
    wait_full(it);
    release(it);
  }

  if (!rows_in) return;
  const int row_g = q0w + warp * 16 + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  store_acc<D>(o + (size_t)bh * tq * D, acc, row_g, tq, inv[0], inv[1], t);
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
// dK/dV: one block per (bh, 128-key tile), the first tiles first; the
// producer streams query tiles from the diagonal.  Each consumer warpgroup
// owns 64 keys, so no two write the same dK/dV row.  (D = 256: a block of
// 64 keys whose warpgroups own half the columns each, kDkvSplit below.)
// ---------------------------------------------------------------------------

// The first query tile of a dK/dV block whose keys start at k0: the first
// that reaches one of its keys.
__device__ __forceinline__ int first_query_tile(int k0, int tq, int q_start, int k_start,
                                                int causal) {
  if (!causal) return 0;
  const int first = k_start + k0 - q_start;
  const int n_qt = (tq + kTile - 1) / kTile;
  return first <= 0 ? 0 : (first > tq - 1 ? n_qt : first / kTile);
}

// The producer warp of a dK/dV block: the block's `keys` rows of K and V
// once, then from query tile it0 on, a stage a tile: Q and dO by TMA, and
// lse (in log2 units) and corr stored by the warp's lanes.
template <int D, int kStages>
__device__ __forceinline__ void dkv_produce(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse, const float* corr, unsigned char* sk,
    unsigned char* sv, unsigned char* sqg, float* stats, uint64_t* kv_full, uint64_t* full,
    uint64_t* empty, int keys, int k0, int bh, int it0, int n_it, int tq) {
  constexpr int kQ = kTile * D * 2;
  const int lane = threadIdx.x;
  if (lane == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * keys * D * 2);
    tma_load_rows<D>(sk, tm_k, keys, k0, bh, kv_full);
    tma_load_rows<D>(sv, tm_v, keys, k0, bh, kv_full);
  }
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* corr_bh = corr + (size_t)bh * tq;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages, q0 = (it0 + it) * kTile;
    mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    float* st = stats + s * 2 * kTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h, row = q0 + r;
      st[r] = row < tq ? lse_bh[row] * kLog2e : 0.f;
      st[kTile + r] = row < tq ? corr_bh[row] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * kQ);
      unsigned char* sq = sqg + s * 2 * kQ;
      tma_load_rows<D>(sq, tm_q, kTile, q0, bh, &full[s]);
      tma_load_rows<D>(sq + kQ, tm_do, kTile, q0, bh, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  }
}

// S^T and dP^T (64 keys x 64 queries) of one staged query tile, issued and
// waited for: the keys' rows of K and V (K-major tiles of `key_rows` rows a
// box) against the stage's Q and dO.
template <typename T, int D>
__device__ __forceinline__ void dkv_scores(float (&st)[32], float (&dpt)[32], uint32_t k_addr,
                                           uint32_t v_addr, int key_rows, uint32_t q_addr,
                                           uint32_t g_addr) {
  zero(st);
  zero(dpt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<T>(st, desc_k_major(k_addr, key_rows, kk), desc_k_major(q_addr, kTile, kk),
                    kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<T>(dpt, desc_k_major(v_addr, key_rows, kk), desc_k_major(g_addr, kTile, kk),
                    kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
}

// P^T and dS^T (unscaled) in place of S^T and dP^T, packed as the register
// A operands pa and da: p = 2^(s scale log2 e - lse log2 e), 0 where
// masked, dS = p (dP + corr).  `need_mask`: some pair of the tile is not
// visible (past the diagonal, or queries past tq).
template <typename T>
__device__ __forceinline__ void dkv_grads(float (&st)[32], float (&dpt)[32],
                                          uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                          const float* st_lse, const float* st_corr,
                                          float scale_log2, bool need_mask, int q0, int tq,
                                          int causal, int q_start, int kpos0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t;
    const float2 lv = *reinterpret_cast<const float2*>(st_lse + qc);
    const float2 cv = *reinterpret_cast<const float2*>(st_corr + qc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, h = i & 1, idx = 4 * j + i;
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
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    acc_to_a<T>(pa[kk], st, kk);
    acc_to_a<T>(da[kk], dpt, kk);
  }
}

// dK/dV's division of a block: below D = 256 a block owns 128 keys and
// consumer warpgroup w owns keys [64 w, 64 w + 64) and every column; at
// D = 256 (two accumulators of 128 registers do not fit a warpgroup) a
// block owns 64 keys and warpgroup w owns columns [128 w, 128 w + 128) of
// their dK and dV, both computing the block's S^T and dP^T.
template <int D>
constexpr bool kDkvSplit = D == 256;
template <int D>
constexpr int kDkvKeys = kDkvSplit<D> ? 64 : kBlockRows;  // keys a block owns
template <int D>
constexpr int kDkvCols = kDkvSplit<D> ? D / kConsumers : D;  // columns a warpgroup owns

template <int D>
struct DkvSmem {
  static constexpr int kKV = kDkvKeys<D> * D * 2;  // the block's K or V tile
  static constexpr int kQ = kTile * D * 2;         // one Q or dO tile of a stage
  static constexpr int kStats = 2 * kTile * 4;     // lse (log2 units), corr
  static constexpr size_t kBytes =
      1024 + 2 * kKV + kDkvStages * (2 * kQ + kStats) + (1 + 2 * kDkvStages) * 8;
};

template <typename T, int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
           const float* __restrict__ lse, const float* __restrict__ corr,
           T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int q_start,
           int k_start, float scale, int causal) {
  using L = DkvSmem<D>;
  constexpr bool kSplit = kDkvSplit<D>;
  constexpr int kKeys = kDkvKeys<D>, kCols = kDkvCols<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1024(smem_raw);
  unsigned char* sv = sk + L::kKV;
  unsigned char* sqg = sv + L::kKV;  // stage s: Q at s * 2 kQ, dO kQ after it
  float* stats = reinterpret_cast<float*>(sqg + kDkvStages * 2 * L::kQ);  // [s][2][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kDkvStages * 2 * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;  // longest first
  const int it0 = first_query_tile(k0, tq, q_start, k_start, causal);
  const int n_it = (tq + kTile - 1) / kTile - it0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 32);               // every producer lane
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: warp 0
    regs_release<kProducerRegs>();
    if (threadIdx.x < 32)
      dkv_produce<D, kDkvStages>(&tm_q, &tm_k, &tm_v, &tm_do, lse, corr, sk, sv, sqg, stats,
                                 kv_full, full, empty, kKeys, k0, bh, it0, n_it, tq);
    return;
  }

  regs_claim<kConsumerRegs>();
  const int w = wg - 1;  // its 64 keys, or its kCols columns (kDkvSplit)
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0w = kSplit ? k0 : k0 + 64 * w;
  const bool keys_in = k0w < tk;
  const int kpos0 = k_start + k0w + warp * 16 + g;  // key row g; g+8 is +8
  const float scale_log2 = scale * kLog2e;
  const uint32_t key_off = kSplit ? 0 : w * 64 * 128;
  const uint32_t k_addr = smem_u32(sk) + key_off, v_addr = smem_u32(sv) + key_off;
  // this warpgroup's columns of a staged tile: its 64-column boxes
  const uint32_t col_off = kSplit ? w * (kCols / 64) * kTile * 128 : 0;

  float dk_acc[kCols / 2], dv_acc[kCols / 2];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kDkvStages, q0 = (it0 + it) * kTile;
    mbar_wait(&full[s], (it / kDkvStages) & 1);
    // query tiles wholly above the diagonal reach no key of this warpgroup
    if (keys_in && !(causal && q_start + min(q0 + kTile, tq) - 1 < k_start + k0w)) {
      const uint32_t q_addr = smem_u32(sqg + s * 2 * L::kQ), g_addr = q_addr + L::kQ;
      const float* st_lse = stats + s * 2 * kTile;
      float st[32], dpt[32];  // S^T and dP^T: this warpgroup's 64 keys x 64 queries
      dkv_scores<T, D>(st, dpt, k_addr, v_addr, kKeys, q_addr, g_addr);
      // every pair visible: all 64 keys at or before the first query, and
      // all 64 queries before tq
      const bool need_mask =
          (causal && k_start + k0w + 63 > q_start + q0) || q0 + kTile > tq;
      uint32_t pa[4][4], da[4][4];
      dkv_grads<T>(st, dpt, pa, da, st_lse, st_lse + kTile, scale_log2, need_mask, q0, tq,
                   causal, q_start, kpos0, t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T . dO
        wgmma_rs<kCols, T>(dv_acc, pa[kk], desc_mn_major(g_addr + col_off, kTile, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T . Q
        wgmma_rs<kCols, T>(dk_acc, da[kk], desc_mn_major(q_addr + col_off, kTile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (!keys_in) return;
  const int row_g = k0w + warp * 16 + g;
  const size_t off = (size_t)bh * tk * D + (kSplit ? w * kCols : 0);
  store_acc<kCols>(dk + off, dk_acc, row_g, tk, scale, scale, t, D);
  store_acc<kCols>(dv + off, dv_acc, row_g, tk, 1.f, 1.f, t, D);
}

// ---------------------------------------------------------------------------
// dQ: one block per (bh, 128-row query tile), the last tiles first; the
// producer streams K/V tiles up to the diagonal.  Each consumer warpgroup
// owns 64 query rows, so no two write the same dQ row.  Per key tile a
// warpgroup issues S and dP (both from shared memory), turns them into dS in
// registers and adds dS.K into its accumulator, reading the staged K tile a
// second time, MN-major.  FlashAttention-3 folds dQ into the dK/dV kernel
// through f32 atomics instead; this kernel keeps the TPU package's split
// (bits that do not change from run to run, dK/dV untouched) and pays for
// it with S and dP computed a second time.
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kStages = kDqRing<D>;
  static constexpr int kQ = kBlockRows * D * 2;  // the block's Q or dO tile, bytes
  static constexpr int kKV = kTile * D * 2;      // one K or V tile of a stage
  static constexpr size_t kBytes =
      1024 + 2 * kQ + kStages * 2 * kKV + (1 + 2 * kStages) * 8;
};

template <typename T, int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ corr,
          T* __restrict__ dq, int tq, int tk, int q_start, int k_start, float scale,
          int causal) {
  using L = DqSmem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* sg = sq + L::kQ;   // the block's dO tile
  unsigned char* skv = sg + L::kQ;  // stage s: K at s * 2 kKV, V kKV after it
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(skv + kStages * 2 * L::kKV);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest first
  const int q_last = q_start + min(q0 + kBlockRows, tq) - 1;
  int n_kv = (tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q_last >= k_start ? (q_last - k_start) / kTile + 1 : 0);

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qg_full, 2 * L::kQ);
      tma_load_rows<D>(sq, &tm_q, kBlockRows, q0, bh, qg_full);
      tma_load_rows<D>(sg, &tm_do, kBlockRows, q0, bh, qg_full);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
        unsigned char* sk = skv + s * 2 * L::kKV;
        tma_load_rows<D>(sk, &tm_k, kTile, it * kTile, bh, &full[s]);
        tma_load_rows<D>(sk + L::kKV, &tm_v, kTile, it * kTile, bh, &full[s]);
      }
    }
    return;
  }

  regs_claim<kConsumerRegs>();
  const int w = wg - 1;  // rows [64 w, 64 w + 64) of the block
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0w = q0 + 64 * w;
  const bool rows_in = q0w < tq;
  const int q_last_w = q_start + min(q0w + 64, tq) - 1;
  const int row_g = q0w + warp * 16 + g;  // row g; row g+8 is +8
  const int qpos0 = q_start + row_g;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_u32(sq) + w * 64 * 128, g_addr = smem_u32(sg) + w * 64 * 128;
  // the key tiles these 64 rows see are a prefix of the block's
  int n_own = rows_in ? n_kv : 0;
  if (causal && rows_in)
    n_own = min(n_kv, q_last_w >= k_start ? (q_last_w - k_start) / kTile + 1 : 0);

  // lse (in log2 units) and corr of this thread's two rows, for every tile
  float lse_r[2], corr_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    lse_r[r] = row < tq ? lse[(size_t)bh * tq + row] * kLog2e : 0.f;
    corr_r[r] = row < tq ? corr[(size_t)bh * tq + row] : 0.f;
  }

  auto k_tile = [&](int it) { return smem_u32(skv + (it % kStages) * 2 * L::kKV); };
  auto wait_full = [&](int it) {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kStages]);
  };
  auto issue_scores = [&](float (&sc)[32], float (&dp)[32], int it) {
    issue_qk<T, D>(sc, q_addr, k_tile(it));           // S = Q.K^T
    issue_qk<T, D>(dp, g_addr, k_tile(it) + L::kKV);  // dP = dO.V^T
  };
  // dS (unscaled) of key tile k0 in place of S: p = 2^(s scale log2 e - lse
  // log2 e), set to 0 where masked before it multiplies anything (a row
  // whose lse is the sentinel would give inf there), times dP + corr.
  // Rows past tq need no mask: their dQ rows are dropped at the store.
  auto grad_scores = [&](float (&sc)[32], const float (&dp)[32], int k0) {
    const bool need_mask =
        (causal && k_start + k0 + kTile - 1 > q_start + q0w) || k0 + kTile > tk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(fmaf(sc[i], scale_log2, -lse_r[r]));
      if (need_mask) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool ok = col < tk && (!causal || k_start + col <= qpos0 + 8 * r);
        p = ok ? p : 0.f;
      }
      sc[i] = p * (dp[i] + corr_r[r]);
    }
  };

  float acc[D / 2];
  zero(acc);
  mbar_wait(qg_full, 0);

  if constexpr (D == 256) {
    // One stage: S and dP, dS, dS.K of each tile in turn, then the
    // producer refills the stage.
    float sc[32], dp[32];
    uint32_t da[4][4];
    for (int it = 0; it < n_own; ++it) {
      wait_full(it);
      zero(sc);
      zero(dp);
      wgmma_fence();
      issue_scores(sc, dp, it);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      grad_scores(sc, dp, it * kTile);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(da[kk], sc, kk);
      wgmma_fence();
      issue_pv<T, D>(acc, da, k_tile(it));  // dQ += dS . K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(it);
    }
  } else if (n_own > 0) {
    // Software pipeline inside the warpgroup: S and dP of key tile it run
    // on the tensor cores while dS of tile it - 1 is packed and dS.K of it
    // is issued, and dS.K of tile it - 1 while dS of tile it is computed.
    float sc[32], dp[32];
    uint32_t da[4][4];
    wait_full(0);
    zero(sc);
    zero(dp);
    wgmma_fence();
    issue_scores(sc, dp, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grad_scores(sc, dp, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(da[kk], sc, kk);
    for (int it = 1; it < n_own; ++it) {
      wait_full(it);
      wgmma_fence();
      issue_scores(sc, dp, it);
      wgmma_commit();
      issue_pv<T, D>(acc, da, k_tile(it - 1));  // dQ += dS . K of tile it - 1
      wgmma_commit();
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(acc);
      wgmma_wait<1>();  // S and dP of tile it are done; dS.K of it - 1 may run
      fence_regs(sc);
      fence_regs(dp);
      grad_scores(sc, dp, it * kTile);
      fence_regs(sc);  // dS is computed while dS.K runs, not after it
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sc);  // da of tile it - 1 is rewritten only once dS.K is done
      release(it - 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(da[kk], sc, kk);
    }
    wgmma_fence();
    issue_pv<T, D>(acc, da, k_tile(n_own - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(n_own - 1);
  }
  for (int it = n_own; it < n_kv; ++it) {  // past these rows' diagonal
    wait_full(it);
    release(it);
  }

  if (!rows_in) return;
  store_acc<D>(dq + (size_t)bh * tq * D, acc, row_g, tq, scale, scale, t);
}

// ---------------------------------------------------------------------------
// Head dims above 256 (D a multiple of kWideAlign): the wide kernels.
//
// Neither a block's Q tile nor a warpgroup's accumulator over the whole
// head dim fits there: at D = 512 the forward's 128-row Q tile alone is
// 128 KB, and a 64 x 512 f32 accumulator is 256 registers a thread.  But
// given P (or dS) every output is linear in one column slice of the head
// dim: o[:, c] = P.V[:, c], dV[:, c] = P^T.dO[:, c], dK[:, c] = dS^T.Q[:, c],
// dQ[:, c] = dS.K[:, c].  Only the score products S = Q.K^T and dP = dO.V^T
// contract over all of D, and they need it only as a sum of chunks.  So a
// wide block owns one column slice of its rows' outputs (a third grid axis,
// the fastest, so the slices of one tile run side by side and share their
// reads in L2) and computes the scores whole, streaming both operands:
//   * a chunk stage holds 64 columns (one 128-byte box) of the block's own
//     128 rows (Q; Q then dO for dQ; K then V for dK/dV) and of the streamed
//     tile's 64 rows (K; K then V; Q then dO), 24 KB; S (and dP) sum over
//     the D / 64 chunks, each chunk's products into a zeroed partial that
//     one round-to-nearest add folds into the scores (wide_scores);
//   * a slice stage holds the streamed tile's rows of the block's columns
//     (V for the forward, K for dQ, dO and Q with their lse and corr rows
//     for dK/dV), which the register product reads as it reads a whole
//     tile at D = C;
//   * forward and dQ slices are kWideCols = 256 columns (a 64 x 256
//     accumulator, 128 registers, as D = 256's), dK/dV's kWideDkvCols = 128
//     (two 64 x 128 accumulators, as D = 128's); the wrapper zero-pads D to
//     a multiple of kWideAlign.
// A warpgroup runs its tiles in turn (the scores, the softmax or dS, the
// register product), the producer filling the rings meanwhile.  Every slice
// recomputes the scores: at D = 512 the forward does 1.5x the JAX kernel's
// tensor work, dQ 1.67x and dK/dV 2.5x.  The forward's lse is the same in
// every slice (each computes the same S in the same order); slice 0 writes
// it.  First versions, right before fast; PERF.md has their times.
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;  // columns of a chunk stage: one 128-byte box
constexpr int kWideAlign = 256, kWideCols = 256, kWideDkvCols = 128;
constexpr int kChunkStages = 4, kSliceStages = 2;
constexpr int kChunkA = kBlockRows * kChunk * 2;  // the block's rows of a chunk, bytes
constexpr int kChunkB = kTile * kChunk * 2;       // the streamed tile's rows
constexpr int kChunkBytes = kChunkA + kChunkB;

// A wide block's shared memory: the chunk ring, the slice ring (kSlice
// bytes a stage), kStats bytes of f32 rows a slice stage, the barriers.
template <int kSlice, int kStats>
struct WideSmem {
  static constexpr int kSliceBytes = kSlice;
  static constexpr int kSlices = kChunkStages * kChunkBytes;  // offset of the slice ring
  static constexpr int kStatsOff = kSlices + kSliceStages * kSlice;
  static constexpr int kBarOff = kStatsOff + kSliceStages * kStats;
  static constexpr size_t kBytes = 1024 + kBarOff + 2 * (kChunkStages + kSliceStages) * 8;
};

// Every 64-column box of columns [col0, col0 + C) of rows [r, r + rows) of
// head h: C / 64 boxes of rows x 128 bytes, one after the other from dst.
template <int C>
__device__ __forceinline__ void tma_load_cols(unsigned char* dst, const CUtensorMap* map,
                                              int rows, int r, int col0, int h, uint64_t* bar) {
#pragma unroll
  for (int j = 0; j < C / 64; ++j) tma_load(dst + j * rows * 128, map, col0 + 64 * j, r, h, bar);
}

// Chunk c of the ring: columns [64 ch, 64 ch + 64) of map a's rows [a_row,
// a_row + 128) and map b's rows [b_row, b_row + 64), once the stage is free.
__device__ __forceinline__ void load_chunk(unsigned char* chunks, uint64_t* full,
                                           uint64_t* empty, int c, const CUtensorMap* a,
                                           int a_row, const CUtensorMap* b, int b_row, int ch,
                                           int bh) {
  const int s = c % kChunkStages;
  mbar_wait(&empty[s], ((c / kChunkStages) & 1) ^ 1);
  mbar_arrive_expect_tx(&full[s], kChunkBytes);
  unsigned char* st = chunks + s * kChunkBytes;
  tma_load(st, a, ch * kChunk, a_row, bh, &full[s]);
  tma_load(st + kChunkA, b, ch * kChunk, b_row, bh, &full[s]);
}

__device__ __forceinline__ void release_stage(uint64_t* empty, int i, int stages, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[i % stages]);
}

// acc (64 x 64, f32) = rows [64 w, 64 w + 64) of the A parts of chunks c ..
// c + n - 1 times their B parts^T, summed over the chunks; c is advanced.
// Each chunk's four products go into a zeroed partial sum, which one
// round-to-nearest add folds into acc, and its stage is released: one
// chain of products over the whole head dim drifts (the tensor cores'
// sums are not rounded to nearest), and at D = 512 that put dK 1.04
// element tolerances farther from float64 than the plain version, where
// the folded sums stay at 0.69 (PERF.md §6, the wide kernels).
template <typename T>
__device__ __forceinline__ void wide_scores(float (&acc)[32], unsigned char* chunks,
                                            uint64_t* full, uint64_t* empty, int& c, int n,
                                            int w, int lane) {
  zero(acc);
  for (int ch = 0; ch < n; ++ch, ++c) {
    const int s = c % kChunkStages;
    mbar_wait(&full[s], (c / kChunkStages) & 1);
    const uint32_t a = smem_u32(chunks + s * kChunkBytes) + w * 64 * 128;
    const uint32_t b = smem_u32(chunks + s * kChunkBytes + kChunkA);
    float part[32];
    zero(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64<T>(part, desc_k_major(a, kBlockRows, kk), desc_k_major(b, kTile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    release_stage(empty, c, kChunkStages, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
}

// A warpgroup that sees nothing of a streamed tile still takes and releases
// its n chunks.
__device__ __forceinline__ void skip_chunks(uint64_t* full, uint64_t* empty, int& c, int n,
                                            int lane) {
  for (int ch = 0; ch < n; ++ch, ++c) {
    mbar_wait(&full[c % kChunkStages], (c / kChunkStages) & 1);
    release_stage(empty, c, kChunkStages, lane);
  }
}

// The barriers of a wide block, after the rings: chunk full / empty, slice
// full / empty.  Thread 0 initialises them; `slice_arrivals` producer
// threads arrive on a slice's full barrier.
struct WideBars {
  uint64_t *c_full, *c_empty, *s_full, *s_empty;
};

__device__ __forceinline__ WideBars wide_bars(unsigned char* base, int slice_arrivals) {
  uint64_t* b = reinterpret_cast<uint64_t*>(base);
  WideBars bars = {b, b + kChunkStages, b + 2 * kChunkStages,
                   b + 2 * kChunkStages + kSliceStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kChunkStages; ++s) {
      mbar_init(&bars.c_full[s], 1);
      mbar_init(&bars.c_empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    for (int s = 0; s < kSliceStages; ++s) {
      mbar_init(&bars.s_full[s], slice_arrivals);
      mbar_init(&bars.s_empty[s], kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return bars;
}

// Forward above D = 256: one block per (column slice, bh, 128-row query
// tile), the last tiles first.
template <typename T>
__global__ void __launch_bounds__(kSm90Threads, 1)
fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                float* __restrict__ lse, int tq, int tk, int d, int q_start, int k_start,
                float scale, int causal) {
  constexpr int C = kWideCols;
  using L = WideSmem<kTile * C * 2, 0>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* chunks = align_1024(smem_raw);
  unsigned char* slices = chunks + L::kSlices;
  const WideBars bars = wide_bars(chunks + L::kBarOff, 1);

  const int col0 = blockIdx.x * C;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // longest first
  const int n_ch = d / kChunk;
  const int q_last = q_start + min(q0 + kBlockRows, tq) - 1;
  int n_kv = (tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q_last >= k_start ? (q_last - k_start) / kTile + 1 : 0);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      int c = 0;
      for (int it = 0; it < n_kv; ++it) {
        for (int ch = 0; ch < n_ch; ++ch, ++c)
          load_chunk(chunks, bars.c_full, bars.c_empty, c, &tm_q, q0, &tm_k, it * kTile, ch,
                     bh);
        const int s = it % kSliceStages;
        mbar_wait(&bars.s_empty[s], ((it / kSliceStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&bars.s_full[s], L::kSliceBytes);
        tma_load_cols<C>(slices + s * L::kSliceBytes, &tm_v, kTile, it * kTile, col0, bh,
                         &bars.s_full[s]);
      }
    }
    return;
  }

  regs_claim<kConsumerRegs>();
  const int w = wg - 1;  // rows [64 w, 64 w + 64) of the block
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0w = q0 + 64 * w;
  const bool rows_in = q0w < tq;
  const int q_last_w = q_start + min(q0w + 64, tq) - 1;
  const int qpos0 = q_start + q0w + warp * 16 + g;  // row g; row g+8 is +8
  const float scale_log2 = scale * kLog2e;
  int n_own = rows_in ? n_kv : 0;
  if (causal && rows_in)
    n_own = min(n_kv, q_last_w >= k_start ? (q_last_w - k_start) / kTile + 1 : 0);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[C / 2];
  zero(acc);
  int c = 0;
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kSliceStages;
    if (it < n_own) {
      float sc[32], alpha[2];
      uint32_t pa[4][4];
      wide_scores<T>(sc, chunks, bars.c_full, bars.c_empty, c, n_ch, w, lane);  // S
      const int k0 = it * kTile;
      const bool need_mask =
          (causal && k_start + k0 + kTile - 1 > q_start + q0w) || k0 + kTile > tk;
      online_softmax(sc, alpha, m, l, scale_log2, need_mask, k0, tk, causal, k_start, qpos0,
                     t);
#pragma unroll
      for (int i = 0; i < C / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(pa[kk], sc, kk);
      mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
      wgmma_fence();
      issue_pv<T, C>(acc, pa, smem_u32(slices + s * L::kSliceBytes));  // O += P . V slice
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {  // past these rows' diagonal
      skip_chunks(bars.c_full, bars.c_empty, c, n_ch, lane);
      mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
    }
    release_stage(bars.s_empty, it, kSliceStages, lane);
  }

  if (!rows_in) return;
  const int row_g = q0w + warp * 16 + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  store_acc<C>(o + (size_t)bh * tq * d + col0, acc, row_g, tq, inv[0], inv[1], t, d);
  if (t == 0 && blockIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_g + 8 * r < tq)
        lse[(size_t)bh * tq + row_g + 8 * r] =
            m[r] > kMaskThresh ? m[r] * scale + log2f(fmaxf(l[r], 1e-30f)) * kLn2
                               : kNegInf;
  }
}

// dK/dV above D = 256: one block per (column slice, bh, 128-key tile), the
// first tiles first; each consumer warpgroup owns 64 keys.  The producer
// warp's lanes store each query tile's lse (log2 units) and corr beside its
// dO and Q slices.
template <typename T>
__global__ void __launch_bounds__(kSm90Threads, 1)
dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                const float* __restrict__ corr, T* __restrict__ dk, T* __restrict__ dv,
                int tq, int tk, int d, int q_start, int k_start, float scale, int causal) {
  constexpr int C = kWideDkvCols;
  constexpr int kHalf = kTile * C * 2;  // the dO or the Q slice of a stage
  using L = WideSmem<2 * kHalf, 2 * kTile * 4>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* chunks = align_1024(smem_raw);
  unsigned char* slices = chunks + L::kSlices;  // stage s: dO, then Q kHalf after it
  float* stats = reinterpret_cast<float*>(chunks + L::kStatsOff);  // [s][2][64]
  const WideBars bars = wide_bars(chunks + L::kBarOff, 32);

  const int col0 = blockIdx.x * C;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.z * kBlockRows;  // longest first
  const int n_ch = d / kChunk;
  const int it0 = first_query_tile(k0, tq, q_start, k_start, causal);
  const int n_it = (tq + kTile - 1) / kTile - it0;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: warp 0
    regs_release<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_bh = lse + (size_t)bh * tq;
      const float* corr_bh = corr + (size_t)bh * tq;
      int c = 0;
      for (int it = 0; it < n_it; ++it) {
        const int q0 = (it0 + it) * kTile;
        if (lane == 0) {
          for (int ch = 0; ch < n_ch; ++ch, ++c)  // S^T = K . Q^T
            load_chunk(chunks, bars.c_full, bars.c_empty, c, &tm_k, k0, &tm_q, q0, ch, bh);
          for (int ch = 0; ch < n_ch; ++ch, ++c)  // dP^T = V . dO^T
            load_chunk(chunks, bars.c_full, bars.c_empty, c, &tm_v, k0, &tm_do, q0, ch, bh);
        }
        const int s = it % kSliceStages;
        mbar_wait(&bars.s_empty[s], ((it / kSliceStages) & 1) ^ 1);
        float* st = stats + s * 2 * kTile;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, row = q0 + r;
          st[r] = row < tq ? lse_bh[row] * kLog2e : 0.f;
          st[kTile + r] = row < tq ? corr_bh[row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&bars.s_full[s], L::kSliceBytes);
          unsigned char* sl = slices + s * L::kSliceBytes;
          tma_load_cols<C>(sl, &tm_do, kTile, q0, col0, bh, &bars.s_full[s]);
          tma_load_cols<C>(sl + kHalf, &tm_q, kTile, q0, col0, bh, &bars.s_full[s]);
        } else {
          mbar_arrive(&bars.s_full[s]);
        }
      }
    }
    return;
  }

  regs_claim<kConsumerRegs>();
  const int w = wg - 1;  // keys [64 w, 64 w + 64) of the block
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0w = k0 + 64 * w;
  const bool keys_in = k0w < tk;
  const int kpos0 = k_start + k0w + warp * 16 + g;  // key row g; g+8 is +8
  const float scale_log2 = scale * kLog2e;

  float dk_acc[C / 2], dv_acc[C / 2];
  zero(dk_acc);
  zero(dv_acc);
  int c = 0;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kSliceStages, q0 = (it0 + it) * kTile;
    // query tiles wholly above the diagonal reach no key of this warpgroup
    if (keys_in && !(causal && q_start + min(q0 + kTile, tq) - 1 < k_start + k0w)) {
      float st[32], dpt[32];  // S^T and dP^T: this warpgroup's 64 keys x 64 queries
      wide_scores<T>(st, chunks, bars.c_full, bars.c_empty, c, n_ch, w, lane);
      wide_scores<T>(dpt, chunks, bars.c_full, bars.c_empty, c, n_ch, w, lane);
      mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
      const float* st_lse = stats + s * 2 * kTile;
      const bool need_mask =
          (causal && k_start + k0w + 63 > q_start + q0) || q0 + kTile > tq;
      uint32_t pa[4][4], da[4][4];
      dkv_grads<T>(st, dpt, pa, da, st_lse, st_lse + kTile, scale_log2, need_mask, q0, tq,
                   causal, q_start, kpos0, t);
      const uint32_t g_addr = smem_u32(slices + s * L::kSliceBytes), q_addr = g_addr + kHalf;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T . dO slice
        wgmma_rs<C, T>(dv_acc, pa[kk], desc_mn_major(g_addr, kTile, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T . Q slice
        wgmma_rs<C, T>(dk_acc, da[kk], desc_mn_major(q_addr, kTile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    } else {
      skip_chunks(bars.c_full, bars.c_empty, c, 2 * n_ch, lane);
      mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
    }
    release_stage(bars.s_empty, it, kSliceStages, lane);
  }

  if (!keys_in) return;
  const int row_g = k0w + warp * 16 + g;
  const size_t off = (size_t)bh * tk * d + col0;
  store_acc<C>(dk + off, dk_acc, row_g, tk, scale, scale, t, d);
  store_acc<C>(dv + off, dv_acc, row_g, tk, 1.f, 1.f, t, d);
}

// dQ above D = 256: one block per (column slice, bh, 128-row query tile),
// the last tiles first; S and dP from the chunk ring, dQ += dS . the K slice.
template <typename T>
__global__ void __launch_bounds__(kSm90Threads, 1)
dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
               const float* __restrict__ corr, T* __restrict__ dq, int tq, int tk, int d,
               int q_start, int k_start, float scale, int causal) {
  constexpr int C = kWideCols;
  using L = WideSmem<kTile * C * 2, 0>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* chunks = align_1024(smem_raw);
  unsigned char* slices = chunks + L::kSlices;
  const WideBars bars = wide_bars(chunks + L::kBarOff, 1);

  const int col0 = blockIdx.x * C;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // longest first
  const int n_ch = d / kChunk;
  const int q_last = q_start + min(q0 + kBlockRows, tq) - 1;
  int n_kv = (tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q_last >= k_start ? (q_last - k_start) / kTile + 1 : 0);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      int c = 0;
      for (int it = 0; it < n_kv; ++it) {
        for (int ch = 0; ch < n_ch; ++ch, ++c)  // S = Q . K^T
          load_chunk(chunks, bars.c_full, bars.c_empty, c, &tm_q, q0, &tm_k, it * kTile, ch,
                     bh);
        for (int ch = 0; ch < n_ch; ++ch, ++c)  // dP = dO . V^T
          load_chunk(chunks, bars.c_full, bars.c_empty, c, &tm_do, q0, &tm_v, it * kTile, ch,
                     bh);
        const int s = it % kSliceStages;
        mbar_wait(&bars.s_empty[s], ((it / kSliceStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&bars.s_full[s], L::kSliceBytes);
        tma_load_cols<C>(slices + s * L::kSliceBytes, &tm_k, kTile, it * kTile, col0, bh,
                         &bars.s_full[s]);
      }
    }
    return;
  }

  regs_claim<kConsumerRegs>();
  const int w = wg - 1;  // rows [64 w, 64 w + 64) of the block
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0w = q0 + 64 * w;
  const bool rows_in = q0w < tq;
  const int q_last_w = q_start + min(q0w + 64, tq) - 1;
  const int row_g = q0w + warp * 16 + g;  // row g; row g+8 is +8
  const int qpos0 = q_start + row_g;
  const float scale_log2 = scale * kLog2e;
  int n_own = rows_in ? n_kv : 0;
  if (causal && rows_in)
    n_own = min(n_kv, q_last_w >= k_start ? (q_last_w - k_start) / kTile + 1 : 0);
  float lse_r[2], corr_r[2];  // lse (log2 units) and corr of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    lse_r[r] = row < tq ? lse[(size_t)bh * tq + row] * kLog2e : 0.f;
    corr_r[r] = row < tq ? corr[(size_t)bh * tq + row] : 0.f;
  }

  float acc[C / 2];
  zero(acc);
  int c = 0;
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kSliceStages;
    if (it < n_own) {
      float sc[32], dp[32];
      uint32_t da[4][4];
      wide_scores<T>(sc, chunks, bars.c_full, bars.c_empty, c, n_ch, w, lane);  // S
      wide_scores<T>(dp, chunks, bars.c_full, bars.c_empty, c, n_ch, w, lane);  // dP
      // dS (unscaled) in place of S, as dq_kernel's grad_scores
      const int k0 = it * kTile;
      const bool need_mask =
          (causal && k_start + k0 + kTile - 1 > q_start + q0w) || k0 + kTile > tk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse_r[r]));
        if (need_mask) {
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool ok = col < tk && (!causal || k_start + col <= qpos0 + 8 * r);
          p = ok ? p : 0.f;
        }
        sc[i] = p * (dp[i] + corr_r[r]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(da[kk], sc, kk);
      mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
      wgmma_fence();
      issue_pv<T, C>(acc, da, smem_u32(slices + s * L::kSliceBytes));  // dQ += dS . K slice
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {  // past these rows' diagonal
      skip_chunks(bars.c_full, bars.c_empty, c, 2 * n_ch, lane);
      mbar_wait(&bars.s_full[s], (it / kSliceStages) & 1);
    }
    release_stage(bars.s_empty, it, kSliceStages, lane);
  }

  if (!rows_in) return;
  store_acc<C>(dq + (size_t)bh * tq * d + col0, acc, row_g, tq, scale, scale, t, d);
}

template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int tq, int tk, int d, int q_start, int k_start, float scale, int causal,
                    cudaStream_t stream) {
  constexpr size_t smem = WideSmem<kTile * kWideCols * 2, 0>::kBytes;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_rows_map<T>(&tm_q, q, bh, tq, d, kBlockRows);
  if (!err) err = encode_rows_map<T>(&tm_k, k, bh, tk, d, kTile);
  if (!err) err = encode_rows_map<T>(&tm_v, v, bh, tk, d, kTile);
  if (!err) err = prepare(fwd_wide_kernel<T>, smem);
  if (err) return err;
  dim3 grid(d / kWideCols, bh, (tq + kBlockRows - 1) / kBlockRows);
  fwd_wide_kernel<T><<<grid, kSm90Threads, smem, stream>>>(
      tm_q, tm_k, tm_v, (T*)o, (float*)lse, tq, tk, d, q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* corr, void* dk, void* dv, int bh, int tq,
                    int tk, int d, int q_start, int k_start, float scale, int causal,
                    cudaStream_t stream) {
  constexpr size_t smem = WideSmem<2 * kTile * kWideDkvCols * 2, 2 * kTile * 4>::kBytes;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map<T>(&tm_q, q, bh, tq, d, kTile);
  if (!err) err = encode_rows_map<T>(&tm_do, dout, bh, tq, d, kTile);
  if (!err) err = encode_rows_map<T>(&tm_k, k, bh, tk, d, kBlockRows);
  if (!err) err = encode_rows_map<T>(&tm_v, v, bh, tk, d, kBlockRows);
  if (!err) err = prepare(dkv_wide_kernel<T>, smem);
  if (err) return err;
  dim3 grid(d / kWideDkvCols, bh, (tk + kBlockRows - 1) / kBlockRows);
  dkv_wide_kernel<T><<<grid, kSm90Threads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (T*)dk, (T*)dv, tq, tk,
      d, q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* corr, void* dq, int bh, int tq, int tk, int d,
                   int q_start, int k_start, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = WideSmem<kTile * kWideCols * 2, 0>::kBytes;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map<T>(&tm_q, q, bh, tq, d, kBlockRows);
  if (!err) err = encode_rows_map<T>(&tm_do, dout, bh, tq, d, kBlockRows);
  if (!err) err = encode_rows_map<T>(&tm_k, k, bh, tk, d, kTile);
  if (!err) err = encode_rows_map<T>(&tm_v, v, bh, tk, d, kTile);
  if (!err) err = prepare(dq_wide_kernel<T>, smem);
  if (err) return err;
  dim3 grid(d / kWideCols, bh, (tq + kBlockRows - 1) / kBlockRows);
  dq_wide_kernel<T><<<grid, kSm90Threads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (T*)dq, tq, tk, d,
      q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

// A head dim the wide kernels take: above 256, a multiple of kWideAlign.
inline bool wide_head_dim(int d) { return d > 256 && d % kWideAlign == 0; }

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int bh, int tq, int tk, int q_start, int k_start, float scale,
               int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_rows_map<T>(&tm_q, q, bh, tq, D, kBlockRows);
  if (!err) err = encode_rows_map<T>(&tm_k, k, bh, tk, D, kTile);
  if (!err) err = encode_rows_map<T>(&tm_v, v, bh, tk, D, kTile);
  if (!err) err = prepare(fwd_kernel<T, D>, FwdSmem<D>::kBytes);
  if (err) return err;
  dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
  fwd_kernel<T, D><<<grid, kSm90Threads, FwdSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, (T*)o, (float*)lse, tq, tk, q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* corr, void* dk, void* dv, int bh,
               int tq, int tk, int q_start, int k_start, float scale,
               int causal, cudaStream_t stream) {
  constexpr int keys = kDkvKeys<D>;  // a block's keys
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map<T>(&tm_q, q, bh, tq, D, kTile);
  if (!err) err = encode_rows_map<T>(&tm_do, dout, bh, tq, D, kTile);
  if (!err) err = encode_rows_map<T>(&tm_k, k, bh, tk, D, keys);
  if (!err) err = encode_rows_map<T>(&tm_v, v, bh, tk, D, keys);
  if (!err) err = prepare(dkv_kernel<T, D>, DkvSmem<D>::kBytes);
  if (err) return err;
  dim3 grid(bh, (tk + keys - 1) / keys);
  dkv_kernel<T, D><<<grid, kSm90Threads, DkvSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (T*)dk, (T*)dv, tq,
      tk, q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* corr, void* dq, int bh, int tq,
              int tk, int q_start, int k_start, float scale, int causal,
              cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map<T>(&tm_q, q, bh, tq, D, kBlockRows);
  if (!err) err = encode_rows_map<T>(&tm_do, dout, bh, tq, D, kBlockRows);
  if (!err) err = encode_rows_map<T>(&tm_k, k, bh, tk, D, kTile);
  if (!err) err = encode_rows_map<T>(&tm_v, v, bh, tk, D, kTile);
  if (!err) err = prepare(dq_kernel<T, D>, DqSmem<D>::kBytes);
  if (err) return err;
  dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
  dq_kernel<T, D><<<grid, kSm90Threads, DqSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (T*)dq, tq, tk,
      q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

constexpr int kBadHeadDim = -1;

template <typename T, int D>
int flash_occupancy(int which, int* out) {
  if (which == 0) return occupancy(fwd_kernel<T, D>, FwdSmem<D>::kBytes, kSm90Threads, out);
  if (which == 1) return occupancy(dkv_kernel<T, D>, DkvSmem<D>::kBytes, kSm90Threads, out);
  if (which == 2) return occupancy(dq_kernel<T, D>, DqSmem<D>::kBytes, kSm90Threads, out);
  return kBadHeadDim;
}

// The C entry points of one element type: d selects the instance.
template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
              int tk, int d, int q_start, int k_start, float scale, int causal,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_fwd<T, 64>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal, s);
  if (d == 128)
    return launch_fwd<T, 128>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal, s);
  if (d == 256)
    return launch_fwd<T, 256>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal, s);
  if (wide_head_dim(d))
    return launch_fwd_wide<T>(q, k, v, o, lse, bh, tq, tk, d, q_start, k_start, scale, causal,
                              s);
  return kBadHeadDim;
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* corr, void* dk, void* dv, int bh, int tq, int tk, int d,
              int q_start, int k_start, float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                             scale, causal, s);
  if (d == 128)
    return launch_dkv<T, 128>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                              scale, causal, s);
  if (d == 256)
    return launch_dkv<T, 256>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                              scale, causal, s);
  if (wide_head_dim(d))
    return launch_dkv_wide<T>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, d, q_start,
                              k_start, scale, causal, s);
  return kBadHeadDim;
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* corr, void* dq, int bh, int tq, int tk, int d, int q_start,
             int k_start, float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start, scale,
                            causal, s);
  if (d == 128)
    return launch_dq<T, 128>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start,
                             scale, causal, s);
  if (d == 256)
    return launch_dq<T, 256>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start,
                             scale, causal, s);
  if (wide_head_dim(d))
    return launch_dq_wide<T>(q, k, v, dout, lse, corr, dq, bh, tq, tk, d, q_start, k_start,
                             scale, causal, s);
  return kBadHeadDim;
}

template <typename T>
int occupancy_entry(int which, int d, int* out) {
  if (d == 64) return flash_occupancy<T, 64>(which, out);
  if (d == 128) return flash_occupancy<T, 128>(which, out);
  if (d == 256) return flash_occupancy<T, 256>(which, out);
  if (wide_head_dim(d)) {
    constexpr size_t rows_smem = WideSmem<kTile * kWideCols * 2, 0>::kBytes;
    constexpr size_t dkv_smem = WideSmem<2 * kTile * kWideDkvCols * 2, 2 * kTile * 4>::kBytes;
    if (which == 0) return occupancy(fwd_wide_kernel<T>, rows_smem, kSm90Threads, out);
    if (which == 1) return occupancy(dkv_wide_kernel<T>, dkv_smem, kSm90Threads, out);
    if (which == 2) return occupancy(dq_wide_kernel<T>, rows_smem, kSm90Threads, out);
  }
  return kBadHeadDim;
}

}  // namespace

extern "C" {

// bf16: bf_flash_*; f16: bf_flash_f16_*.  The arguments of each pair are
// the same, and those of flash_attention_f32.cu's launchers: `rounding` is
// read there only (these kernels round p and dS to their own dtype).

int bf_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int tq, int tk, int d, int q_start,
                 int k_start, float scale, int causal, int rounding, void* stream) {
  return fwd_entry<bf16>(q, k, v, o, lse, bh, tq, tk, d, q_start, k_start, scale, causal,
                         stream);
}

int bf_flash_f16_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int tq, int tk, int d, int q_start,
                     int k_start, float scale, int causal, int rounding, void* stream) {
  return fwd_entry<f16>(q, k, v, o, lse, bh, tq, tk, d, q_start, k_start, scale, causal,
                        stream);
}

int bf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* corr,
                     void* dk, void* dv, int bh, int tq, int tk, int d,
                     int q_start, int k_start, float scale, int causal,
                     int rounding, void* stream) {
  return dkv_entry<bf16>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, d, q_start, k_start,
                         scale, causal, stream);
}

int bf_flash_f16_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* corr,
                         void* dk, void* dv, int bh, int tq, int tk, int d,
                         int q_start, int k_start, float scale, int causal,
                         int rounding, void* stream) {
  return dkv_entry<f16>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, d, q_start, k_start,
                        scale, causal, stream);
}

int bf_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* corr,
                    void* dq, int bh, int tq, int tk, int d, int q_start,
                    int k_start, float scale, int causal, int rounding, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, corr, dq, bh, tq, tk, d, q_start, k_start, scale,
                        causal, stream);
}

int bf_flash_f16_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* corr,
                        void* dq, int bh, int tq, int tk, int d, int q_start,
                        int k_start, float scale, int causal, int rounding, void* stream) {
  return dq_entry<f16>(q, k, v, dout, lse, corr, dq, bh, tq, tk, d, q_start, k_start, scale,
                       causal, stream);
}

// which: 0 forward, 1 dK/dV, 2 dQ; out as occupancy() above (4 ints).
int bf_flash_occupancy(int which, int d, int* out) {
  return occupancy_entry<bf16>(which, d, out);
}

int bf_flash_f16_occupancy(int which, int d, int* out) {
  return occupancy_entry<f16>(which, d, out);
}

}  // extern "C"
