// Flash attention for Hopper (sm_90a): forward, dK/dV backward, dQ backward.
//
// Replaces the three Pallas TPU kernels of bluefog_tpu/kernels/flash_attention.py:
//   fwd_kernel  <- _fwd_kernel      (:246, launched by _flash_fwd :356)
//   dkv_kernel  <- _bwd_dkv_kernel  (:490, launched by _flash_bwd_pallas :686)
//   dq_kernel   <- _bwd_dq_kernel   (:575, launched by _flash_bwd_pallas :708)
//
// Contract (same as the TPU kernels): q, k, v, o, dO are [BH, T, D] bf16,
// contiguous; lse and corr are [BH, Tq] f32.  Causal masking uses global
// positions (q_start + row, k_start + col; visible iff kpos <= qpos), so one
// kernel serves plain attention and every ring-attention hop.  Rows with no
// visible key give o = 0 and lse = -1e30.  Accumulation is f32; rounding
// points match the TPU kernels: p is rounded to bf16 before p.V and p^T.dO,
// dS is rounded to bf16 before dS.K and dS^T.Q, and the softmax scale
// multiplies the dK and dQ accumulators once at the end.  lse is the
// natural-log log-sum-exp.
//
// What bounds these kernels on the H100: at the main path's shapes (D = 64,
// T = 2048) attention does ~64 flops per byte of q/k/v per key tile, so the
// work is tensor-core bound (989 TFLOP/s bf16), and the causal mask leaves
// blocks of very unequal length.
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
// fastest measured (benchmarks/flash_variants.py; PERF.md).
constexpr int kFwdStages = 4;
constexpr int kDqStages = 4;
constexpr int kDkvStages = 2;
constexpr int kConsumers = 2;                  // consumer warpgroups a block
constexpr int kBlockRows = 64 * kConsumers;    // rows a block owns
constexpr int kSm90Threads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 24*128 + 240*256 <= 64K
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Store one warpgroup's 64 x D f32 accumulator (times `mul` per row half)
// as bf16; row_g is this thread's first row, rows past `rows` are dropped.
template <int D>
__device__ __forceinline__ void store_acc(bf16* out, const float (&acc)[D / 2], int row_g,
                                          int rows, float mul0, float mul1, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= rows) continue;
    const float mul = r ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * D + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (bh, 128-row query tile), the last tiles first; the
// producer streams key tiles up to the diagonal.
// ---------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kQ = kBlockRows * D * 2;  // the block's Q tile, bytes
  static constexpr int kKV = kTile * D * 2;      // one K or V tile of a stage
  static constexpr size_t kBytes =
      1024 + kQ + kFwdStages * 2 * kKV + (1 + 2 * kFwdStages) * 8;
};

// S (64 x 64) = this warpgroup's Q rows . the staged K tile^T, issued; dQ
// issues dP = its dO rows . the staged V tile^T through it too.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, desc_k_major(q_addr, kBlockRows, kk), desc_k_major(k_addr, kTile, kk),
                 kk);
}

// O += P (registers, bf16) . the staged V tile, issued; dQ issues dQ +=
// dS . the staged K tile through it too.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[4][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mn_major(v_addr, kTile, kk));
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

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
           float* __restrict__ lse, int tq, int tk, int q_start, int k_start, float scale,
           int causal) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* skv = sq + L::kQ;  // stage s: K at s * 2 kKV, V kKV after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + kFwdStages * 2 * L::kKV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest first
  const int q_last = q_start + min(q0 + kBlockRows, tq) - 1;
  int n_kv = (tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q_last >= k_start ? (q_last - k_start) / kTile + 1 : 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
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
        const int s = it % kFwdStages;
        mbar_wait(&empty[s], ((it / kFwdStages) & 1) ^ 1);
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

  auto k_tile = [&](int it) { return smem_u32(skv + (it % kFwdStages) * 2 * L::kKV); };
  auto wait_full = [&](int it) {
    mbar_wait(&full[it % kFwdStages], (it / kFwdStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kFwdStages]);
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

  // Software pipeline inside the warpgroup: S of key tile it runs on the
  // tensor cores while the softmax of tile it - 1 is done, and P.V of tile
  // it - 1 while the softmax of tile it is done.
  if (n_own > 0) {
    float sc[32], alpha[2];
    uint32_t pa[4][4];
    wait_full(0);
    zero(sc);
    wgmma_fence();
    issue_qk<D>(sc, q_addr, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, alpha, m, l, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
    for (int it = 1; it < n_own; ++it) {
      wait_full(it);
      wgmma_fence();
      issue_qk<D>(sc, q_addr, k_tile(it));
      wgmma_commit();
      issue_pv<D>(acc, pa, k_tile(it - 1) + L::kKV);
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
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
    }
    wgmma_fence();
    issue_pv<D>(acc, pa, k_tile(n_own - 1) + L::kKV);
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
// owns 64 keys, so no two write the same dK/dV row.
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kKV = kBlockRows * D * 2;  // the block's K or V tile
  static constexpr int kQ = kTile * D * 2;        // one Q or dO tile of a stage
  static constexpr int kStats = 2 * kTile * 4;    // lse (log2 units), corr
  static constexpr size_t kBytes =
      1024 + 2 * kKV + kDkvStages * (2 * kQ + kStats) + (1 + 2 * kDkvStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
           const float* __restrict__ lse, const float* __restrict__ corr,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk, int q_start,
           int k_start, float scale, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1024(smem_raw);
  unsigned char* sv = sk + L::kKV;
  unsigned char* sqg = sv + L::kKV;  // stage s: Q at s * 2 kQ, dO kQ after it
  float* stats = reinterpret_cast<float*>(sqg + kDkvStages * 2 * L::kQ);  // [s][2][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kDkvStages * 2 * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;  // longest first
  const int n_qt = (tq + kTile - 1) / kTile;
  int it0 = 0;  // first query tile that reaches a key of this block
  if (causal) {
    const int first = k_start + k0 - q_start;
    it0 = first <= 0 ? 0 : (first > tq - 1 ? n_qt : first / kTile);
  }
  const int n_it = n_qt - it0;

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
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
      tma_load_rows<D>(sk, &tm_k, kBlockRows, k0, bh, kv_full);
      tma_load_rows<D>(sv, &tm_v, kBlockRows, k0, bh, kv_full);
    }
    const float* lse_bh = lse + (size_t)bh * tq;
    const float* corr_bh = corr + (size_t)bh * tq;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kDkvStages, q0 = (it0 + it) * kTile;
      mbar_wait(&empty[s], ((it / kDkvStages) & 1) ^ 1);
      float* st = stats + s * 2 * kTile;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, row = q0 + r;
        st[r] = row < tq ? lse_bh[row] * kLog2e : 0.f;
        st[kTile + r] = row < tq ? corr_bh[row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::kQ);
        unsigned char* sq = sqg + s * 2 * L::kQ;
        tma_load_rows<D>(sq, &tm_q, kTile, q0, bh, &full[s]);
        tma_load_rows<D>(sq + L::kQ, &tm_do, kTile, q0, bh, &full[s]);
      } else {
        mbar_arrive(&full[s]);
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
  const uint32_t k_addr = smem_u32(sk) + w * 64 * 128, v_addr = smem_u32(sv) + w * 64 * 128;

  float dk_acc[D / 2], dv_acc[D / 2];
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
      const float* st_corr = st_lse + kTile;
      float st[32], dpt[32];  // S^T and dP^T: this warpgroup's keys x 64 queries
      zero(st);
      zero(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, desc_k_major(k_addr, kBlockRows, kk), desc_k_major(q_addr, kTile, kk),
                     kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k_major(v_addr, kBlockRows, kk),
                     desc_k_major(g_addr, kTile, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // every pair visible: all 64 keys at or before the first query, and
      // all 64 queries before tq
      const bool need_mask =
          (causal && k_start + k0w + 63 > q_start + q0) || q0 + kTile > tq;
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
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], st, kk);
        acc_to_a(da[kk], dpt, kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T . dO
        wgmma_rs<D>(dv_acc, pa[kk], desc_mn_major(g_addr, kTile, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T . Q
        wgmma_rs<D>(dk_acc, da[kk], desc_mn_major(q_addr, kTile, kk));
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
  store_acc<D>(dk + (size_t)bh * tk * D, dk_acc, row_g, tk, scale, scale, t);
  store_acc<D>(dv + (size_t)bh * tk * D, dv_acc, row_g, tk, 1.f, 1.f, t);
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
  static constexpr int kQ = kBlockRows * D * 2;  // the block's Q or dO tile, bytes
  static constexpr int kKV = kTile * D * 2;      // one K or V tile of a stage
  static constexpr size_t kBytes =
      1024 + 2 * kQ + kDqStages * 2 * kKV + (1 + 2 * kDqStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ corr,
          bf16* __restrict__ dq, int tq, int tk, int q_start, int k_start, float scale,
          int causal) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* sg = sq + L::kQ;   // the block's dO tile
  unsigned char* skv = sg + L::kQ;  // stage s: K at s * 2 kKV, V kKV after it
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(skv + kDqStages * 2 * L::kKV);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + kDqStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest first
  const int q_last = q_start + min(q0 + kBlockRows, tq) - 1;
  int n_kv = (tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q_last >= k_start ? (q_last - k_start) / kTile + 1 : 0);

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
        const int s = it % kDqStages;
        mbar_wait(&empty[s], ((it / kDqStages) & 1) ^ 1);
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

  auto k_tile = [&](int it) { return smem_u32(skv + (it % kDqStages) * 2 * L::kKV); };
  auto wait_full = [&](int it) {
    mbar_wait(&full[it % kDqStages], (it / kDqStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kDqStages]);
  };
  auto issue_scores = [&](float (&sc)[32], float (&dp)[32], int it) {
    issue_qk<D>(sc, q_addr, k_tile(it));           // S = Q.K^T
    issue_qk<D>(dp, g_addr, k_tile(it) + L::kKV);  // dP = dO.V^T
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

  // Software pipeline inside the warpgroup: S and dP of key tile it run on
  // the tensor cores while dS of tile it - 1 is packed and dS.K of it is
  // issued, and dS.K of tile it - 1 while dS of tile it is computed.
  if (n_own > 0) {
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
    for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], sc, kk);
    for (int it = 1; it < n_own; ++it) {
      wait_full(it);
      wgmma_fence();
      issue_scores(sc, dp, it);
      wgmma_commit();
      issue_pv<D>(acc, da, k_tile(it - 1));  // dQ += dS . K of tile it - 1
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
      for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], sc, kk);
    }
    wgmma_fence();
    issue_pv<D>(acc, da, k_tile(n_own - 1));
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

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int bh, int tq, int tk, int q_start, int k_start, float scale,
               int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_rows_map(&tm_q, q, bh, tq, D, kBlockRows);
  if (!err) err = encode_rows_map(&tm_k, k, bh, tk, D, kTile);
  if (!err) err = encode_rows_map(&tm_v, v, bh, tk, D, kTile);
  if (!err) err = prepare(fwd_kernel<D>, FwdSmem<D>::kBytes);
  if (err) return err;
  dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
  fwd_kernel<D><<<grid, kSm90Threads, FwdSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, (bf16*)o, (float*)lse, tq, tk, q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* corr, void* dk, void* dv, int bh,
               int tq, int tk, int q_start, int k_start, float scale,
               int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map(&tm_q, q, bh, tq, D, kTile);
  if (!err) err = encode_rows_map(&tm_do, dout, bh, tq, D, kTile);
  if (!err) err = encode_rows_map(&tm_k, k, bh, tk, D, kBlockRows);
  if (!err) err = encode_rows_map(&tm_v, v, bh, tk, D, kBlockRows);
  if (!err) err = prepare(dkv_kernel<D>, DkvSmem<D>::kBytes);
  if (err) return err;
  dim3 grid(bh, (tk + kBlockRows - 1) / kBlockRows);
  dkv_kernel<D><<<grid, kSm90Threads, DkvSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (bf16*)dk,
      (bf16*)dv, tq, tk, q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* corr, void* dq, int bh, int tq,
              int tk, int q_start, int k_start, float scale, int causal,
              cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_rows_map(&tm_q, q, bh, tq, D, kBlockRows);
  if (!err) err = encode_rows_map(&tm_do, dout, bh, tq, D, kBlockRows);
  if (!err) err = encode_rows_map(&tm_k, k, bh, tk, D, kTile);
  if (!err) err = encode_rows_map(&tm_v, v, bh, tk, D, kTile);
  if (!err) err = prepare(dq_kernel<D>, DqSmem<D>::kBytes);
  if (err) return err;
  dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
  dq_kernel<D><<<grid, kSm90Threads, DqSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)corr, (bf16*)dq, tq, tk,
      q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

constexpr int kBadHeadDim = -1;

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
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                            threads, smem);
}

template <int D>
int flash_occupancy(int which, int* out) {
  if (which == 0) return occupancy(fwd_kernel<D>, FwdSmem<D>::kBytes, kSm90Threads, out);
  if (which == 1) return occupancy(dkv_kernel<D>, DkvSmem<D>::kBytes, kSm90Threads, out);
  if (which == 2) return occupancy(dq_kernel<D>, DqSmem<D>::kBytes, kSm90Threads, out);
  return kBadHeadDim;
}

}  // namespace

extern "C" {

int bf_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int tq, int tk, int d, int q_start,
                 int k_start, float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_fwd<64>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal, s);
  if (d == 128)
    return launch_fwd<128>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal, s);
  return kBadHeadDim;
}

int bf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* corr,
                     void* dk, void* dv, int bh, int tq, int tk, int d,
                     int q_start, int k_start, float scale, int causal,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk,
                          q_start, k_start, scale, causal, s);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk,
                           q_start, k_start, scale, causal, s);
  return kBadHeadDim;
}

int bf_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* corr,
                    void* dq, int bh, int tq, int tk, int d, int q_start,
                    int k_start, float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start,
                         k_start, scale, causal, s);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start,
                          k_start, scale, causal, s);
  return kBadHeadDim;
}

// which: 0 forward, 1 dK/dV, 2 dQ; out as occupancy() above (4 ints).
int bf_flash_occupancy(int which, int d, int* out) {
  if (d == 64) return flash_occupancy<64>(which, out);
  if (d == 128) return flash_occupancy<128>(which, out);
  return kBadHeadDim;
}

}  // extern "C"
