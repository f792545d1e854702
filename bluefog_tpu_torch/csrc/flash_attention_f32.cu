// Flash attention in float32 for Hopper (sm_90a): forward, dK/dV, dQ.
//
// The f32 instances of the three Pallas TPU kernels of
// bluefog_tpu/kernels/flash_attention.py, which serve f32 inputs with f32
// products (preferred_element_type=float32, :279, :311, :522-555, :599-623):
//   fwd_f32_kernel  <- _fwd_kernel      (:246, pallas_call :383)
//   dkv_f32_kernel  <- _bwd_dkv_kernel  (:490, pallas_call :686)
//   dq_f32_kernel   <- _bwd_dq_kernel   (:575, pallas_call :708)
// The bf16 instances are the Hopper kernels of flash_attention.cu.
//
// Contract (that of the bf16 kernels): q, k, v, o, dO are [BH, T, D] f32,
// contiguous, D = 64 or 128 (the wrapper zero-pads a smaller head dim);
// lse and corr are [BH, Tq] f32.  Causal masking uses global positions
// (q_start + row, k_start + col; visible iff kpos <= qpos).  Rows with no
// visible key give o = 0 and lse = -1e30.  corr = g_lse - rowsum(o * dO)
// comes from the wrapper.  What differs from bf16: every product is a true
// f32 FFMA (no TF32), and p and dS are not rounded before they multiply
// (the reference casts them to v.dtype, f32 here).
//
// What bounds these kernels on the H100: f32 products run on the FP32 pipe,
// 67 TFLOP/s, not on the tensor cores, so the work is bound by operations
// (at D = 64, T = 2048 attention does ~16 flops per f32 byte of q/k/v per
// key tile).  The design is the simple one: one 64-row tile of queries
// (forward, dQ) or keys (dK/dV) a block of 256 threads, every operand tile
// staged once through shared memory (row stride D + 4, so the float4 reads
// of 8 neighbouring threads hit 8 distinct bank groups), scores in
// registers.  Thread (ty, tx) owns rows ty + 16i and columns tx + 16j of
// every 64 x 64 score tile, i, j < 4: one float4 of each operand feeds 64
// FFMAs.  p and dS pass through shared memory to the second product, whose
// row operand is read as float4 (a broadcast) and whose column operand as
// one float a thread (16 neighbouring columns).  A row's max and sum are
// shuffles over the 16 lanes of one half-warp.  Tiles wholly past the
// causal diagonal are skipped; the tile axis is the slow grid axis, walked
// longest chain first.  No ring, no overlap of loads with products: making
// these fast is later work.
//
// Every launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the error of the attribute call before it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of a block tile and of every loop tile
constexpr int kThreads = 256;  // 16 x 16: (ty, tx) = (tid / 16, tid % 16)
constexpr int kPad = 4;        // floats added to every shared-memory row
constexpr int kPS = kTile + kPad;  // row stride of the p / dS tiles
constexpr float kNegInf = -1e30f;  // finite mask sentinel
constexpr float kMaskThresh = -0.5e30f;

// Copy rows [row0, row0 + 64) of a [T, D] matrix into shared memory (row
// stride D + kPad), zero-filling rows at or past `rows`.  float4 chunks.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows) {
  constexpr int kChunks = D / 4, S = D + kPad;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c * 4);
    *reinterpret_cast<float4*>(dst + r * S + c * 4) = val;
  }
}

// Max / sum over the 16 lanes of a half-warp (the threads of one ty).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// s[i][j] = sum_d a[ty + 16i][d] * b[tx + 16j][d] over two row-major tiles.
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&s)[4][4], const float* a,
                                              const float* b, int ty, int tx) {
  constexpr int S = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][j] += sum_c p[ty + 16i][c] * m[c][tx + 16j], c < 64, j < D / 16:
// p a 64 x 64 tile (stride kPS), m a 64 x D tile (stride D + kPad).
template <int D>
__device__ __forceinline__ void rows_times(float (&acc)[4][D / 16], const float* p,
                                           const float* m, int ty, int tx) {
  constexpr int S = D + kPad;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float mv[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) mv[j] = m[(c + cc) * S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pc, mv[j], acc[i][j]);
      }
    }
  }
}

// Store this thread's rows ty + 16i, columns tx + 16j of a [T, D] output,
// each row times mul[i]; rows at or past `rows` are not written.
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][D / 16],
                                           int row0, int rows, const float (&mul)[4],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) out[(size_t)row * D + tx + 16 * j] = acc[i][j] * mul[i];
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// Forward: one block a (head, query tile); loop over key tiles to the diagonal.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int tq, int tk, int q_start, int k_start,
               float scale, int causal) {
  constexpr int S = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // last tile first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  q += (size_t)bh * tq * D;
  o += (size_t)bh * tq * D;
  lse += (size_t)bh * tq;
  k += (size_t)bh * tk * D;
  v += (size_t)bh * tk * D;

  load_tile<D>(qs, q, q0, tq);
  const int q_last = q_start + min(q0 + kTile, tq) - 1;
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.f;
  zero<D>(acc);

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    if (causal && k_start + k0 > q_last) break;  // wholly past the diagonal
    __syncthreads();  // every thread is done with the previous K, V and p
    load_tile<D>(ks, k, k0, tk);
    load_tile<D>(vs, v, k0, tk);
    __syncthreads();

    float s[4][4];
    rows_dot_rows<D>(s, qs, ks, ty, tx);
    const bool need_mask =
        (causal && k_start + k0 + kTile - 1 > q_start + q0) || k0 + kTile > tk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mcur = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (need_mask) {
          const int col = k0 + tx + 16 * j;
          const bool ok = col < tk &&
                          (!causal || k_start + col <= q_start + q0 + ty + 16 * i);
          x = ok ? x : kNegInf;
        }
        s[i][j] = x;
        mcur = fmaxf(mcur, x);
      }
      const float mnew = fmaxf(m[i], row_max(mcur));
      const float alpha = expf(m[i] - mnew);
      m[i] = mnew;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked entries, and rows with no visible key yet (m still the
        // sentinel, where exp would give 1), contribute nothing
        const float p = s[i][j] > kMaskThresh ? expf(s[i][j] - mnew) : 0.f;
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // p complete
    rows_times<D>(acc, ps, vs, ty, tx);  // O += P.V
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  store_rows<D>(o, acc, q0, tq, inv, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < tq) lse[row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block a (head, key tile); loop over query tiles from the
// diagonal.  S^T and dP^T are [key][query] tiles; P^T and dS^T go through
// shared memory into dV += P^T.dO and dK += dS^T.Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ corr,
               float* __restrict__ dk, float* __restrict__ dv, int tq, int tk,
               int q_start, int k_start, float scale, int causal) {
  constexpr int S = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTile * S;
  float* qs = vs + kTile * S;
  float* gs = qs + kTile * S;
  float* pts = gs + kTile * S;
  float* dsts = pts + kTile * kPS;
  float* lse_s = dsts + kTile * kPS;
  float* corr_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // the first key tiles see the most queries
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  q += (size_t)bh * tq * D;
  dout += (size_t)bh * tq * D;
  lse += (size_t)bh * tq;
  corr += (size_t)bh * tq;
  k += (size_t)bh * tk * D;
  v += (size_t)bh * tk * D;
  dk += (size_t)bh * tk * D;
  dv += (size_t)bh * tk * D;

  load_tile<D>(ks, k, k0, tk);
  load_tile<D>(vs, v, k0, tk);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  for (int q0 = 0; q0 < tq; q0 += kTile) {
    // query tiles wholly before the diagonal see no key of this tile
    if (causal && q_start + min(q0 + kTile, tq) - 1 < k_start + k0) continue;
    __syncthreads();  // every thread is done with the previous tiles
    load_tile<D>(qs, q, q0, tq);
    load_tile<D>(gs, dout, q0, tq);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < tq ? lse[row] : 0.f;
      corr_s[threadIdx.x] = row < tq ? corr[row] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];  // this thread's keys x queries
    rows_dot_rows<D>(st, ks, qs, ty, tx);
    rows_dot_rows<D>(dpt, vs, gs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const bool ok = q0 + qc < tq &&
                        (!causal || k_start + k0 + ty + 16 * i <= q_start + q0 + qc);
        const float p = ok ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
        pts[(ty + 16 * i) * kPS + qc] = p;
        dsts[(ty + 16 * i) * kPS + qc] = p * (dpt[i][j] + corr_s[qc]);  // unscaled
      }
    __syncthreads();
    rows_times<D>(dv_acc, pts, gs, ty, tx);   // dV += P^T . dO
    rows_times<D>(dk_acc, dsts, qs, ty, tx);  // dK += dS^T . Q
  }

  const float by_scale[4] = {scale, scale, scale, scale}, one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dk, dk_acc, k0, tk, by_scale, ty, tx);
  store_rows<D>(dv, dv_acc, k0, tk, one, ty, tx);
}

// ---------------------------------------------------------------------------
// dQ: one block a (head, query tile); loop over key tiles to the diagonal.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ corr,
              float* __restrict__ dq, int tq, int tk, int q_start, int k_start,
              float scale, int causal) {
  constexpr int S = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + kTile * S;
  float* ks = gs + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // last tile first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  q += (size_t)bh * tq * D;
  dout += (size_t)bh * tq * D;
  dq += (size_t)bh * tq * D;
  lse += (size_t)bh * tq;
  corr += (size_t)bh * tq;
  k += (size_t)bh * tk * D;
  v += (size_t)bh * tk * D;

  load_tile<D>(qs, q, q0, tq);
  load_tile<D>(gs, dout, q0, tq);
  const int q_last = q_start + min(q0 + kTile, tq) - 1;
  float lse_r[4], corr_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < tq ? lse[row] : 0.f;
    corr_r[i] = row < tq ? corr[row] : 0.f;
  }
  float dq_acc[4][D / 16];
  zero<D>(dq_acc);

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    if (causal && k_start + k0 > q_last) break;
    __syncthreads();
    load_tile<D>(ks, k, k0, tk);
    load_tile<D>(vs, v, k0, tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    rows_dot_rows<D>(s, qs, ks, ty, tx);
    rows_dot_rows<D>(dp, gs, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        const bool ok = row < tq && col < tk &&
                        (!causal || k_start + col <= q_start + row);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] + corr_r[i]);  // unscaled
      }
    __syncthreads();
    rows_times<D>(dq_acc, dss, ks, ty, tx);  // dQ += dS . K
  }
  const float by_scale[4] = {scale, scale, scale, scale};
  store_rows<D>(dq, dq_acc, q0, tq, by_scale, ty, tx);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

constexpr size_t tile_bytes(int d) { return (size_t)kTile * (d + kPad) * sizeof(float); }
constexpr size_t p_bytes() { return (size_t)kTile * kPS * sizeof(float); }

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
               int tq, int tk, int q_start, int k_start, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes(D) + p_bytes();
  int err = prepare(fwd_f32_kernel<D>, smem);
  if (err) return err;
  dim3 grid(bh, (tq + kTile - 1) / kTile);
  fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, tq, tk,
      q_start, k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* corr, void* dk, void* dv, int bh, int tq,
               int tk, int q_start, int k_start, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(D) + 2 * p_bytes() + 2 * kTile * sizeof(float);
  int err = prepare(dkv_f32_kernel<D>, smem);
  if (err) return err;
  dim3 grid(bh, (tk + kTile - 1) / kTile);
  dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)corr, (float*)dk, (float*)dv, tq, tk, q_start,
      k_start, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* corr, void* dq, int bh, int tq, int tk,
              int q_start, int k_start, float scale, int causal, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(D) + p_bytes();
  int err = prepare(dq_f32_kernel<D>, smem);
  if (err) return err;
  dim3 grid(bh, (tq + kTile - 1) / kTile);
  dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)corr, (float*)dq, tq, tk, q_start, k_start, scale,
      causal);
  return (int)cudaGetLastError();
}

constexpr int kBadHeadDim = -1;

}  // namespace

extern "C" {

int bf_flash_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                     int bh, int tq, int tk, int d, int q_start, int k_start, float scale,
                     int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_fwd<64>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal, s);
  if (d == 128)
    return launch_fwd<128>(q, k, v, o, lse, bh, tq, tk, q_start, k_start, scale, causal, s);
  return kBadHeadDim;
}

int bf_flash_f32_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* corr, void* dk, void* dv, int bh,
                         int tq, int tk, int d, int q_start, int k_start, float scale,
                         int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                          scale, causal, s);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, corr, dk, dv, bh, tq, tk, q_start, k_start,
                           scale, causal, s);
  return kBadHeadDim;
}

int bf_flash_f32_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* corr, void* dq, int bh, int tq,
                        int tk, int d, int q_start, int k_start, float scale, int causal,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start, scale,
                         causal, s);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, corr, dq, bh, tq, tk, q_start, k_start,
                          scale, causal, s);
  return kBadHeadDim;
}

}  // extern "C"
