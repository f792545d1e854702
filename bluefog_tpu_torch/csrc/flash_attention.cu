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
// multiplies the dK and dQ accumulators once at the end.
//
// What bounds these kernels on the H100: at the main path's shapes (D = 64,
// T = 2048) attention does ~64 flops per byte of q/k/v per key tile, so the
// work is tensor-core bound in principle (989 TFLOP/s bf16).  This first
// version uses warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
// synchronous shared-memory staging: no TMA, no wgmma, no double buffering,
// so it reaches only a fraction of that rate (times in PERF.md).  What the
// design does about the bound: scores, probabilities and dS never leave
// registers (the FA2 trick: an mma's C fragment is re-packed as the next
// mma's A fragment), tiles above the causal diagonal are skipped, and the
// TPU's sequential grid axis becomes a loop inside each block -- forward and
// dQ loop over key tiles per query tile, dK/dV loops over query tiles per key
// tile -- which keeps the TPU's two-kernel backward split and needs no
// atomics.  Each block is 4 warps; each warp owns 16 rows of the block's
// 64-row tile.
//
// Every launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the error of the attribute call before it).

#include "mma_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;      // finite mask sentinel
constexpr float kMaskThresh = -0.5e30f;

// Copy rows [row0, row0 + 64) of a [T, D] matrix into smem (row stride S),
// zero-filling rows at or past `rows`.  16-byte chunks.
template <int D, int S>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * S + c * 8) = val;
  }
}

// s[nt] (16 rows x 64 cols of this warp) = A rows [r0, r0+16) of `a_m`
// times rows of `b_m` as columns, contracted over D.
template <int D, int S>
__device__ __forceinline__ void rows_by_rows(float (&s)[8][4], const bf16* a_m,
                                             int r0, const bf16* b_m, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a<S>(a, a_m, r0, kk * 16, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[2];
      frag_b_rows<S>(b, b_m, nt * 8, kk * 16, lane);
      mma16816(s[nt], a, b);
    }
  }
}

// acc[dt] (16 rows x D) += P (16 x 64, from C fragments) . m (64 x D in smem)
template <int D, int S>
__device__ __forceinline__ void p_times(float (&acc)[D / 8][4],
                                        const float (&p)[8][4], const bf16* m,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    c_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      uint32_t b[2];
      frag_b_cols<S>(b, m, kk * 16, dt * 8, lane);
      mma16816(acc[dt], a, b);
    }
  }
}

// Store this warp's 16 x D f32 accumulator rows (times `mul`) as bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4],
                                           int row_g, int rows, float mul0,
                                           float mul1, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= rows) continue;
    const float mul = r ? mul1 : mul0;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(out + (size_t)row * D + col) =
          pack_bf16(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, bh); loop over key tiles up to the diagonal.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int tq, int tk, int q_start, int k_start,
           float scale, int causal) {
  constexpr int S = D + 8;  // padded smem row stride: conflict-free fragments
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * S;
  bf16* vs = ks + kTile * S;

  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * tq * D;
  o += (size_t)bh * tq * D;
  k += (size_t)bh * tk * D;
  v += (size_t)bh * tk * D;

  load_tile<D, S>(qs, q, q0, tq);
  const int qpos0 = q_start + q0 + warp * 16 + g;  // row g; row g+8 is +8
  const int q_last = q_start + min(q0 + kTile, tq) - 1;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    if (causal && k_start + k0 > q_last) break;  // wholly above the diagonal
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, S>(ks, k, k0, tk);
    load_tile<D, S>(vs, v, k0, tk);
    __syncthreads();

    float s[8][4];
    rows_by_rows<D, S>(s, qs, warp * 16, ks, lane);
    const bool need_mask =
        (causal && k_start + k0 + kTile - 1 > q_start + q0) || k0 + kTile > tk;
    float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale;
        if (need_mask) {
          const int col = k0 + nt * 8 + t * 2 + (i & 1);
          const bool ok = col < tk &&
                          (!causal || k_start + col <= qpos0 + (i >> 1) * 8);
          x = ok ? x : kNegInf;
        }
        s[nt][i] = x;
        mcur[i >> 1] = fmaxf(mcur[i >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mcur[r]));
      alpha[r] = expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // masked entries, and whole rows with no visible key (m == the
        // sentinel, where exp would give 1), contribute nothing
        const float p = s[nt][i] > kMaskThresh ? expf(s[nt][i] - m[i >> 1]) : 0.f;
        s[nt][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    p_times<D, S>(acc, s, vs, lane);
  }

  const int row_g = q0 + warp * 16 + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  store_rows<D>(o, acc, row_g, tq, inv[0], inv[1], lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_g + 8 * r < tq)
        lse[(size_t)bh * tq + row_g + 8 * r] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (key tile, bh); loop over query tiles from the diagonal.
// Each warp owns 16 keys, so no two warps write the same dK/dV row.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ corr,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk,
           int q_start, int k_start, float scale, int causal) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile * S;
  bf16* qs = vs + kTile * S;
  bf16* gs = qs + kTile * S;
  float* lse_s = reinterpret_cast<float*>(gs + kTile * S);
  float* corr_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * tq * D;
  dout += (size_t)bh * tq * D;
  lse += (size_t)bh * tq;
  corr += (size_t)bh * tq;
  k += (size_t)bh * tk * D;
  v += (size_t)bh * tk * D;
  dk += (size_t)bh * tk * D;
  dv += (size_t)bh * tk * D;

  load_tile<D, S>(ks, k, k0, tk);
  load_tile<D, S>(vs, v, k0, tk);
  const int kpos0 = k_start + k0 + warp * 16 + g;  // key row g; g+8 is +8
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dt][i] = dv_acc[dt][i] = 0.f;

  for (int q0 = 0; q0 < tq; q0 += kTile) {
    // query tiles wholly above the diagonal reach no key of this tile
    if (causal && q_start + min(q0 + kTile, tq) - 1 < k_start + k0) continue;
    __syncthreads();
    load_tile<D, S>(qs, q, q0, tq);
    load_tile<D, S>(gs, dout, q0, tq);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < tq ? lse[row] : 0.f;
      corr_s[threadIdx.x] = row < tq ? corr[row] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // S^T and dP^T: this warp's keys x 64 queries
    rows_by_rows<D, S>(st, ks, warp * 16, qs, lane);
    rows_by_rows<D, S>(dpt, vs, warp * 16, gs, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = nt * 8 + t * 2 + (i & 1);
        const int qrow = q0 + qc;
        const bool ok = qrow < tq &&
                        (!causal || kpos0 + (i >> 1) * 8 <= q_start + qrow);
        const float p = ok ? expf(st[nt][i] * scale - lse_s[qc]) : 0.f;
        st[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] + corr_s[qc]);  // dS^T, unscaled
      }
    p_times<D, S>(dv_acc, st, gs, lane);   // dV += P^T . dO
    p_times<D, S>(dk_acc, dpt, qs, lane);  // dK += dS^T . Q
  }

  const int row_g = k0 + warp * 16 + g;
  store_rows<D>(dk, dk_acc, row_g, tk, scale, scale, lane);
  store_rows<D>(dv, dv_acc, row_g, tk, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, bh); loop over key tiles up to the diagonal.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ corr,
          bf16* __restrict__ dq, int tq, int tk, int q_start, int k_start,
          float scale, int causal) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + kTile * S;
  bf16* ks = gs + kTile * S;
  bf16* vs = ks + kTile * S;

  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * tq * D;
  dout += (size_t)bh * tq * D;
  dq += (size_t)bh * tq * D;
  lse += (size_t)bh * tq;
  corr += (size_t)bh * tq;
  k += (size_t)bh * tk * D;
  v += (size_t)bh * tk * D;

  load_tile<D, S>(qs, q, q0, tq);
  load_tile<D, S>(gs, dout, q0, tq);
  const int row_g = q0 + warp * 16 + g;
  const int qpos0 = q_start + row_g;
  const int q_last = q_start + min(q0 + kTile, tq) - 1;
  float lse_r[2], corr_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row_g + 8 * r < tq;
    lse_r[r] = in ? lse[row_g + 8 * r] : 0.f;
    corr_r[r] = in ? corr[row_g + 8 * r] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[dt][i] = 0.f;

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    if (causal && k_start + k0 > q_last) break;
    __syncthreads();
    load_tile<D, S>(ks, k, k0, tk);
    load_tile<D, S>(vs, v, k0, tk);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_by_rows<D, S>(s, qs, warp * 16, ks, lane);
    rows_by_rows<D, S>(dp, gs, warp * 16, vs, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = k0 + nt * 8 + t * 2 + (i & 1);
        const bool ok = row_g + 8 * r < tq && col < tk &&
                        (!causal || k_start + col <= qpos0 + 8 * r);
        const float p = ok ? expf(s[nt][i] * scale - lse_r[r]) : 0.f;
        s[nt][i] = p * (dp[nt][i] + corr_r[r]);  // dS, unscaled
      }
    p_times<D, S>(dq_acc, s, ks, lane);  // dQ += dS . K
  }
  store_rows<D>(dq, dq_acc, row_g, tq, scale, scale, lane);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
constexpr size_t fwd_smem() { return 3 * kTile * (D + 8) * sizeof(bf16); }
template <int D>
constexpr size_t dkv_smem() {
  return 4 * kTile * (D + 8) * sizeof(bf16) + 2 * kTile * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() { return 4 * kTile * (D + 8) * sizeof(bf16); }

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int bh, int tq, int tk, int q_start, int k_start, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  int err = prepare(fwd_kernel<D>, smem);
  if (err) return err;
  dim3 grid((tq + kTile - 1) / kTile, bh);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      tq, tk, q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* corr, void* dk, void* dv, int bh,
               int tq, int tk, int q_start, int k_start, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  int err = prepare(dkv_kernel<D>, smem);
  if (err) return err;
  dim3 grid((tk + kTile - 1) / kTile, bh);
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)corr, (bf16*)dk, (bf16*)dv, tq, tk,
      q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* corr, void* dq, int bh, int tq,
              int tk, int q_start, int k_start, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  int err = prepare(dq_kernel<D>, smem);
  if (err) return err;
  dim3 grid((tq + kTile - 1) / kTile, bh);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)corr, (bf16*)dq, tq, tk, q_start,
      k_start, scale, causal);
  return (int)cudaGetLastError();
}

constexpr int kBadHeadDim = -1;

// out[0] = resident blocks per SM, out[1] = dynamic shared memory bytes,
// out[2] = registers per thread, of one kernel as its launcher launches it.
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int* out) {
  int err = prepare(kernel, smem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                            kThreads, smem);
}

template <int D>
int flash_occupancy(int which, int* out) {
  if (which == 0) return occupancy(fwd_kernel<D>, fwd_smem<D>(), out);
  if (which == 1) return occupancy(dkv_kernel<D>, dkv_smem<D>(), out);
  if (which == 2) return occupancy(dq_kernel<D>, dq_smem<D>(), out);
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

// which: 0 forward, 1 dK/dV, 2 dQ; out as occupancy() above.
int bf_flash_occupancy(int which, int d, int* out) {
  if (d == 64) return flash_occupancy<64>(which, out);
  if (d == 128) return flash_occupancy<128>(which, out);
  return kBadHeadDim;
}

}  // extern "C"
