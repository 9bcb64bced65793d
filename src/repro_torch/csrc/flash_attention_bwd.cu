// FlashAttention-2 backward for Hopper (sm_90a): the gradient of causal GQA
// attention with respect to Q, K and V.
//
// Replaces what the JAX package gets from autodiff: its training forward
// attends through the pure-jnp `gqa_attention` (src/repro/models/layers.py),
// which JAX differentiates; the Pallas forward `flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py) has no backward of its own.
// On the card the port's training forward is the flash kernel
// (csrc/flash_attention.cu), which also writes the per-row natural
// log-sum-exp `lse` this kernel starts from.
//
// Bound on an H100: bytes at llama3.2-3b's training shape (S 512, H 24, G 8,
// D 128), operations from about S 640.  The work is five products of the
// visible (row, column) pairs (S = Q K^T and dP = dO V^T again, dV = P^T dO,
// dK = dS^T Q, dQ = dS K), 10 * D FLOP a pair and query head, which grow
// with S^2; the bytes are Q, K, V, O, dO, the three gradients and lse moved
// once, which grow with S.
//
// Three launches, deterministic, no atomics:
//  (a) delta_kernel: delta = rowsum(dO * O) for each (batch, head, row), fp32.
//  (b) dK and dV: one block per (batch, KV head, 64-row KV tile).  It keeps
//      its K and V tiles in shared memory and walks, for every query head of
//      its GQA group, the Q tiles at or below the causal diagonal, so that dK
//      and dV (summed over the group) stay in registers and are written once.
//  (c) dQ: one block per (batch, query head, 64-row Q tile).  It keeps its Q
//      and dO tiles and walks the KV tiles up to the diagonal; dQ stays in
//      registers and is written once.
// Both (b) and (c) recompute S and dP for each pair of tiles (FlashAttention-
// 2's choice: recomputing is cheaper than storing P or dS).
//
// bf16, the training path (dkdv_mma_kernel, dq_mma_kernel): mma.sync
// m16n8k16 products with fp32 sums on tiles that cp.async stages into
// swizzled rows, as the forward's bf16 path (the helpers of bf16_tiles.cuh).
// P and dS are rounded to bf16 in registers and feed the next products
// directly, as FlashAttention-2 does; the gradients are summed in fp32 and
// written in bf16.  Left for later: wgmma fed by TMA, and a ring that loads
// the next tile while one computes.
//
// fp32 (dkdv_kernel, dq_kernel): FMA on tiles widened into shared memory, a
// 4 x 4 patch of scores a thread (16 x 16 threads on 64 x 64 tiles), exact
// fp32 sums (no TF32, which the fp32 tolerance rules out).  Rows are staged
// with one pad word so that 16 lanes reading 16 consecutive rows hit 16
// banks.
//
// Computed here: causal masking with Sq == Sk (training's shape), any length,
// head_dim 64 and 128, GQA groups of any size, bf16 and fp32.  Not computed
// (the wrapper refuses them before any launch): a sliding window, a softcap,
// head_dim 112 or 256, non-causal attention.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_tiles.cuh"

namespace {

using namespace dco_tiles;

constexpr int BT = 64;        // rows of a Q or KV tile
constexpr int THREADS = 256;  // fp32 path: 16 x 16, thread (ty, tx) owns rows ty*4 + i and columns tx + 16*j
constexpr int LDP = BT + 1;   // fp32 path: padded row of a P or dS tile
constexpr int MMA_WARPS = 4;  // bf16 path: warps of a block, 16 rows each of a 64-row tile
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Rows [0, BT) of an fp32 tile into padded shared rows of D + 1 words, from
// device rows `stride` elements apart; rows from `nvalid` on are zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride,
                                      int nvalid) {
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    dst[r * (D + 1) + c] = r < nvalid ? src[r * stride + c] : 0.f;
  }
}

// lse and delta of rows [row0, row0 + BT) of one (batch, head); zeros past S.
__device__ __forceinline__ void stage_rows_stats(float* lse_s, float* delta_s, const float* lse,
                                                 const float* delta, int row0, int S) {
  for (int i = threadIdx.x; i < BT; i += blockDim.x) {
    const bool ok = row0 + i < S;
    lse_s[i] = ok ? lse[row0 + i] : 0.f;
    delta_s[i] = ok ? delta[row0 + i] : 0.f;
  }
}

// P and dS of one (Q tile, KV tile) pair into shared memory:
//   S = Q K^T, dP = dO V^T (one pass over D), P = exp(S * scale - lse),
//   dS = P * (dP - delta); both 0 where the causal mask or the ragged edge
//   hides the pair.  WRITE_P: also store P (the dK/dV kernel needs it).
template <int D, bool WRITE_P>
__device__ __forceinline__ void tile_grads(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, const float* lse_s,
                                           const float* delta_s, float* Ps, float* dSs,
                                           int q_lo, int k_lo, int S, float scale) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qf[4], of[4], kf[4], vf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qf[i] = Qs[(ty * 4 + i) * LD + d];
      of[i] = dOs[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kf[j] = Ks[(tx + 16 * j) * LD + d];
      vf[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += qf[i] * kf[j];
        dp[i][j] += of[i] * vf[j];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q_lo + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = k_lo + c;
      const bool ok = row < S && col <= row;  // causal; col < S follows
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      if (WRITE_P) Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// grid = ceil(B * S * H / 8): one warp a (batch, row, head), rows of
// (B, S, H, D) contiguous O and dO; delta is (B, H, S).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int S, int H) {
  const long long item = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (long long)B * S * H) return;
  const T* orow = o + item * D;
  const T* drow = dout + item * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(orow[c]) * to_f32(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(item % H);
    const long long bs = item / H;  // b * S + s
    const int s = (int)(bs % S);
    const int b = (int)(bs / S);
    delta[((long long)b * H + h) * S + s] = acc;
  }
}

// grid = (KV tiles, G, B).  q, o-like tensors (B, S, H, D) and k, v, dk, dv
// (B, S, G, D), all contiguous; lse and delta (B, H, S).
template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int H, int G, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;  // output columns a thread owns in each row
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;
  float* dSs = Ps + BT * LDP;
  float* lse_s = dSs + BT * LDP;
  float* delta_s = lse_s + BT;

  const int kt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / G;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k_lo = kt * BT;
  const int n_tiles = (S + BT - 1) / BT;
  const long long qstride = (long long)H * D;  // elements between rows of q, o, dout
  const long long kstride = (long long)G * D;

  const long long kv_off = ((long long)b * S + k_lo) * kstride + (long long)g * D;
  stage<D>(Ks, k + kv_off, kstride, S - k_lo);
  stage<D>(Vs, v + kv_off, kstride, S - k_lo);

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    for (int qt = kt; qt < n_tiles; ++qt) {  // causal: rows at or past k_lo
      const int q_lo = qt * BT;
      __syncthreads();  // the previous pair's tiles are free
      const long long q_off = ((long long)b * S + q_lo) * qstride + (long long)h * D;
      stage<D>(Qs, q + q_off, qstride, S - q_lo);
      stage<D>(dOs, dout + q_off, qstride, S - q_lo);
      const long long st_off = ((long long)b * H + h) * S;
      stage_rows_stats(lse_s, delta_s, lse + st_off, delta + st_off, q_lo, S);
      __syncthreads();
      tile_grads<D, true>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q_lo, k_lo, S, scale);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q for this thread's KV rows and columns
      const int r_end = min(BT, S - q_lo);
      for (int r = 0; r < r_end; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * LDP + ty * 4 + i];
          ds[i] = dSs[r * LDP + ty * 4 + i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float o = dOs[r * LD + tx + 16 * jj];
          const float qv = Qs[r * LD + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][jj] += p[i] * o;
            acc_k[i][jj] += ds[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k_lo + ty * 4 + i;
    if (row < S) {
      const long long off = ((long long)b * S + row) * kstride + (long long)g * D;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        dk[off + tx + 16 * jj] = acc_k[i][jj] * scale;
        dv[off + tx + 16 * jj] = acc_v[i][jj];
      }
    }
  }
}

// grid = (Q tiles, H, B); layouts as dkdv_kernel, dq (B, S, H, D).
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int H, int G, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* dSs = dOs + BT * LD;
  float* lse_s = dSs + BT * LDP;
  float* delta_s = lse_s + BT;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q_lo = qt * BT;
  const long long qstride = (long long)H * D;
  const long long kstride = (long long)G * D;

  const long long q_off = ((long long)b * S + q_lo) * qstride + (long long)h * D;
  stage<D>(Qs, q + q_off, qstride, S - q_lo);
  stage<D>(dOs, dout + q_off, qstride, S - q_lo);
  const long long st_off = ((long long)b * H + h) * S;
  stage_rows_stats(lse_s, delta_s, lse + st_off, delta + st_off, q_lo, S);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {  // causal: KV tiles up to the diagonal
    const int k_lo = kt * BT;
    __syncthreads();  // the previous KV tiles are free (and Q, dO staged)
    const long long kv_off = ((long long)b * S + k_lo) * kstride + (long long)g * D;
    stage<D>(Ks, k + kv_off, kstride, S - k_lo);
    stage<D>(Vs, v + kv_off, kstride, S - k_lo);
    __syncthreads();
    tile_grads<D, false>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q_lo, k_lo, S, scale);
    __syncthreads();
    // dQ += dS K for this thread's Q rows and columns
    const int c_end = min(BT, S - k_lo);
    for (int c = 0; c < c_end; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float kv = Ks[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] += ds[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty * 4 + i;
    if (row < S) {
      const long long off = ((long long)b * S + row) * qstride + (long long)h * D;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) dq[off + tx + 16 * jj] = acc[i][jj] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path: mma.sync.m16n8k16 products with fp32 sums (bf16_tiles.cuh),
// tiles staged by cp.async into swizzled rows as the forward stages them.
// Four warps a block, each owning 16 rows of the block's 64-row tile; S and
// dP are taken 32 columns at a time (16 fp32 sums each a thread), so that
// the two 16 x D gradient sums of the dK/dV kernel (64 + 64 at D 128) and
// the scores fit the registers without a spill.  P and dS are rounded to
// bf16 in registers and are the A operands of the next products, as the
// forward's P is: they never pass through shared memory.

// The 16 x 32 blocks S = A_s B_s^T and dP = A_p B_p^T of this warp's rows
// `ra` (A_s, A_p: rows ra.. of two tiles) against rows c0.. of two other
// tiles (B_s, B_p), over the head dimension.
template <int D>
__device__ __forceinline__ void mma_pair(float (&s)[4][4], float (&dp)[4][4], uint32_t As,
                                         uint32_t Ap, uint32_t Bs, uint32_t Bp, int ra,
                                         int c0, int lane) {
  constexpr int ROWB = row_bytes<D>();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4], pf[4];
    ldsm_x4(As + swz<ROWB>(ra + (lane & 15), 2 * ks + (lane >> 4)), af);
    ldsm_x4(Ap + swz<ROWB>(ra + (lane & 15), 2 * ks + (lane >> 4)), pf);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = c0 + 16 * j + ((lane >> 4) << 3) + (lane & 7);
      uint32_t bs[4], bp[4];
      ldsm_x4(Bs + swz<ROWB>(n, 2 * ks + ((lane >> 3) & 1)), bs);
      ldsm_x4(Bp + swz<ROWB>(n, 2 * ks + ((lane >> 3) & 1)), bp);
      mma_bf16(s[2 * j], af, bs[0], bs[1]);
      mma_bf16(s[2 * j + 1], af, bs[2], bs[3]);
      mma_bf16(dp[2 * j], pf, bp[0], bp[1]);
      mma_bf16(dp[2 * j + 1], pf, bp[2], bp[3]);
    }
  }
}

// acc (16 x D) += A (16 x 32, two 16-deep steps of bf16 fragments) times rows
// c0.. of a [k][n] tile read transposed.
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const uint32_t (&a)[2][4],
                                        uint32_t Bt, int c0, int lane) {
  constexpr int ROWB = row_bytes<D>();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t bf[4];
      ldsm_x4_trans(Bt + swz<ROWB>(c0 + 16 * kk + (lane & 15), 2 * j + (lane >> 4)), bf);
      mma_bf16(acc[2 * j], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], a[kk], bf[2], bf[3]);
    }
}

// Rows of a 16 x D fp32 sum (C fragments) times `mul`, as bf16, to rows
// `row`, `row` + 8 (those below S) of a tensor `stride` elements a row.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], int row,
                                           int S, long long stride, float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= S) continue;
    bf16* o = out + (long long)(row + 8 * i) * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
  }
}

// grid = (KV tiles, G, B), MMA_WARPS warps; layouts as dkdv_kernel.  Warp w
// owns KV rows [16 w, +16) of the tile; S^T = K Q^T and dP^T = V dO^T put
// its KV rows in the rows of the products, so that P^T and dS^T are A
// fragments of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int G, float scale) {
  constexpr int TILEB = BT * row_bytes<D>();
  constexpr int NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_b[];
  const uint32_t Ks = smem_addr(smem_b);
  const uint32_t Vs = Ks + TILEB;
  const uint32_t Qs = Vs + TILEB;
  const uint32_t dOs = Qs + TILEB;
  float* lse_s = reinterpret_cast<float*>(smem_b + 4 * TILEB);
  float* delta_s = lse_s + BT;

  const int kt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / G;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);  // this warp's first KV row in the tile
  const int k_lo = kt * BT;
  const int kv_a = k_lo + r0 + (lane >> 2);  // this thread's KV rows: kv_a and kv_a + 8
  const int n_tiles = (S + BT - 1) / BT;
  const long long qstride = (long long)H * D;
  const long long kstride = (long long)G * D;

  const long long kv_off = ((long long)b * S + k_lo) * kstride + (long long)g * D;
  stage_tile<D>(Ks, k + kv_off, kstride, BT, min(BT, S - k_lo));
  stage_tile<D>(Vs, v + kv_off, kstride, BT, min(BT, S - k_lo));
  cp_async_commit();

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    for (int qt = kt; qt < n_tiles; ++qt) {  // causal: Q rows at or past k_lo
      const int q_lo = qt * BT;
      __syncthreads();  // the previous Q and dO tiles are free
      const long long q_off = ((long long)b * S + q_lo) * qstride + (long long)h * D;
      stage_tile<D>(Qs, q + q_off, qstride, BT, min(BT, S - q_lo));
      stage_tile<D>(dOs, dout + q_off, qstride, BT, min(BT, S - q_lo));
      cp_async_commit();
      const long long st_off = ((long long)b * H + h) * S;
      stage_rows_stats(lse_s, delta_s, lse + st_off, delta + st_off, q_lo, S);
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int c0 = 0; c0 < BT; c0 += 32) {
        // Q rows [q_lo + c0, +32): all past S, or all above this warp's KV rows
        if (q_lo + c0 >= S || q_lo + c0 + 31 < k_lo + r0) continue;
        float s[4][4], dp[4][4];
        mma_pair<D>(s, dp, Ks, Vs, Qs, dOs, r0, c0, lane);
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * j + 2 * (lane & 3) + (e & 1);  // Q row in the tile
            const int kv = kv_a + 8 * (e >> 1);
            const bool ok = q_lo + c < S && kv <= q_lo + c;
            p[e] = ok ? __expf(s[j][e] * scale - lse_s[c]) : 0.f;
            ds[e] = p[e] * (dp[j][e] - delta_s[c]);
          }
          pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
          pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
          da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
          da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }
        mma_acc<D>(acc_v, pa, dOs, c0, lane);
        mma_acc<D>(acc_k, da, Qs, c0, lane);
      }
    }
  }
  const long long out_off = (long long)b * S * kstride + (long long)g * D;
  store_rows<D>(dk + out_off, acc_k, kv_a, S, kstride, scale, lane);
  store_rows<D>(dv + out_off, acc_v, kv_a, S, kstride, 1.f, lane);
}

// grid = (Q tiles, H, B), MMA_WARPS warps; layouts as dq_kernel.  Warp w
// owns Q rows [16 w, +16) of the tile.
template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int H, int G, float scale) {
  constexpr int TILEB = BT * row_bytes<D>();
  constexpr int NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_b[];
  const uint32_t Qs = smem_addr(smem_b);
  const uint32_t dOs = Qs + TILEB;
  const uint32_t Ks = dOs + TILEB;
  const uint32_t Vs = Ks + TILEB;
  float* lse_s = reinterpret_cast<float*>(smem_b + 4 * TILEB);
  float* delta_s = lse_s + BT;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);  // this warp's first Q row in the tile
  const int q_lo = qt * BT;
  const long long qstride = (long long)H * D;
  const long long kstride = (long long)G * D;

  const long long q_off = ((long long)b * S + q_lo) * qstride + (long long)h * D;
  stage_tile<D>(Qs, q + q_off, qstride, BT, min(BT, S - q_lo));
  stage_tile<D>(dOs, dout + q_off, qstride, BT, min(BT, S - q_lo));
  cp_async_commit();
  const long long st_off = ((long long)b * H + h) * S;
  stage_rows_stats(lse_s, delta_s, lse + st_off, delta + st_off, q_lo, S);

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {  // causal: KV tiles up to the diagonal
    const int k_lo = kt * BT;
    __syncthreads();  // the previous K and V tiles are free
    const long long kv_off = ((long long)b * S + k_lo) * kstride + (long long)g * D;
    stage_tile<D>(Ks, k + kv_off, kstride, BT, min(BT, S - k_lo));
    stage_tile<D>(Vs, v + kv_off, kstride, BT, min(BT, S - k_lo));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < BT; c0 += 32) {
      // KV rows [k_lo + c0, +32) all above this warp's Q rows
      if (k_lo + c0 > q_lo + r0 + 15) continue;
      float s[4][4], dp[4][4];
      mma_pair<D>(s, dp, Qs, dOs, Ks, Vs, r0, c0, lane);
      uint32_t da[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (lane >> 2) + 8 * (e >> 1);  // Q row in the tile
          const int kv = k_lo + c0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const bool ok = q_lo + r < S && kv <= q_lo + r;
          const float p = ok ? __expf(s[j][e] * scale - lse_s[r]) : 0.f;
          ds[e] = p * (dp[j][e] - delta_s[r]);
        }
        da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      mma_acc<D>(acc, da, Ks, c0, lane);
    }
  }
  store_rows<D>(dq + (long long)b * S * qstride + (long long)h * D, acc,
                q_lo + r0 + (lane >> 2), S, qstride, scale, lane);
}

// The bf16 path's three launches.
template <int D>
int launch_bwd_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                   const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                   bf16* dv, int B, int S, int H, int G, float scale, cudaStream_t stream) {
  const int smem = 4 * BT * row_bytes<D>() + 2 * BT * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dkdv_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffll) return -1;
  delta_kernel<bf16, D><<<(unsigned)blocks, THREADS, 0, stream>>>(o, dout, delta, B, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + BT - 1) / BT;
  dkdv_mma_kernel<D><<<dim3(n_tiles, G, B), MMA_WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_mma_kernel<D><<<dim3(n_tiles, H, B), MMA_WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, G, scale);
  return (int)cudaGetLastError();
}

// The fp32 path's three launches.
template <int D>
int launch_bwd_fp32(const float* q, const float* k, const float* v, const float* o,
                    const float* dout, const float* lse, float* delta, float* dq, float* dk,
                    float* dv, int B, int S, int H, int G, float scale, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem_dkdv = sizeof(float) * (4 * BT * LD + 2 * BT * LDP + 2 * BT);
  const size_t smem_dq = sizeof(float) * (4 * BT * LD + BT * LDP + 2 * BT);
  if (smem_dkdv > (size_t)SMEM_LIMIT) return -2;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffll) return -1;
  delta_kernel<float, D><<<(unsigned)blocks, THREADS, 0, stream>>>(o, dout, delta, B, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + BT - 1) / BT;
  dkdv_kernel<D><<<dim3(n_tiles, G, B), THREADS, smem_dkdv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<D><<<dim3(n_tiles, H, B), THREADS, smem_dq, stream>>>(q, k, v, dout, lse, delta,
                                                                  dq, S, H, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  Causal attention with Sq == Sk == S.  q, o,
// dout and dq are (B, S, H, D), k, v, dk and dv (B, S, G, D), all contiguous;
// lse (B, H, S) fp32 as the forward (dco_flash_attention) wrote it; delta
// (B, H, S) fp32 scratch.  Three launches on `stream`.  Returns 0, a
// cudaError_t, -1 for arguments the kernel does not take (D other than 64 and
// 128, H not a multiple of G, empty or oversized grids), or -2 when the
// shared memory a block needs is more than a block may take.
extern "C" int dco_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv, int dtype,
                                       int B, int S, int H, int G, int D, float scale,
                                       void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0) return -1;
  if (B > 65535 || H > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq |
         (uintptr_t)dk | (uintptr_t)dv) % 16 != 0)
      return -1;  // the 16-byte copies and the paired stores
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(o),
               *db = static_cast<const bf16*>(dout);
    bf16 *dqb = static_cast<bf16*>(dq), *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
    if (D == 64)
      return launch_bwd_mma<64>(qb, kb, vb, ob, db, lse, delta, dqb, dkb, dvb, B, S, H, G, scale, s);
    if (D == 128)
      return launch_bwd_mma<128>(qb, kb, vb, ob, db, lse, delta, dqb, dkb, dvb, B, S, H, G, scale, s);
  }
  if (dtype == 1) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
                *df = static_cast<const float*>(dout);
    float *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv);
    if (D == 64)
      return launch_bwd_fp32<64>(qf, kf, vf, of, df, lse, delta, dqf, dkf, dvf, B, S, H, G, scale, s);
    if (D == 128)
      return launch_bwd_fp32<128>(qf, kf, vf, of, df, lse, delta, dqf, dkf, dvf, B, S, H, G, scale, s);
  }
  return -1;
}
