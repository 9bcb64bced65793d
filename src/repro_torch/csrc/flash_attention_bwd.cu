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
// head_dim 64, 112, 128 and 256, GQA groups of any size, bf16 and fp32, with
// or without a sliding window and a softcap.  Not computed (the wrapper
// refuses it before any launch): non-causal attention.
//
// Sliding window and softcap (gemma2-27b: window 4096 on its local layers,
// softcap 50).  They are taken by kernels of their own (the `_ext_` ones,
// the same bodies with EXT set), so that the kernels without them keep their
// code and registers.  With s = S * scale and the cap c, the forward's
// scores are s_c = c tanh(s / c), and its lse is the natural log-sum-exp of
// the capped, masked scores.  So P = exp(s_c - lse) is recomputed in natural
// units (the bf16 forward caps in log2 units, but writes a natural lse), the
// cap's argument formed as each forward path forms it, and
// dS = P (dP - delta) (1 - (s_c / c)^2): the cap's derivative enters dS
// before it is rounded to bf16, so dK and dQ take it and dV does not.  Row r
// sees columns (r - W, r].  A KV tile's block walks the Q tiles from its own
// to the last that its last row's window reaches, (k_lo + BT - 1 + W - 1) /
// BT; a Q tile's block walks the KV tiles from the forward's
// `first_kv_tile`, (q_lo - W + 1) / BT; the bf16 kernels skip the 32-row
// blocks wholly outside the window of a warp's rows, as they skip those
// above the diagonal, and every element is masked by kv > q - W beside the
// causal test.
//
// Explicit positions (the JAX package's `forward` with a (B, S) positions
// table, which its autodiff differentiates through `gqa_attention`): the
// position variant, flash_attention_bwd_pos.cu, compiles the `_ext_` kernels
// again with DCO_FLASH_POS defined, taking `pos` (B, S) int32, the positions
// of both the query and the key rows (training passes one table for both);
// a translation unit of its own, so that the kernels here keep their code and
// registers, and dco_flash_attention_bwd hands a call with a table to it.  Row q sees row kv where pos[kv] <= pos[q] and, under a
// window, pos[kv] > pos[q] - W.  Positions need not follow the rows, so a KV
// tile's block walks every Q tile and a Q tile's block every KV tile, skipping
// a pair of tiles whose smallest and largest positions prove that no row of
// one sees a row of the other (positions.cuh), and the skips of 32-row blocks
// by index are off.  Every row sees itself under such a table, so its lse is
// finite and no row needs the forward's rule for a row that sees no key; a
// hidden pair's P and dS are 0.
//
// head_dim 112 (zamba2-7b's shared attention block) takes the same code as 64
// and 128: every loop over the head dimension steps one 16-column block at a
// time (7 of them; no step takes two blocks at once), so D / 16 being odd
// changes nothing.  A bf16 row of 112 values (14 sixteen-byte chunks) is
// staged at the forward's 256-byte pitch (row_bytes<112>): the swizzle maps
// chunks 0..13 onto 14 of a row's 16 slots, and the 2 left over are never
// copied, read or summed.  The dK/dV sums are 2 x 56 fp32 registers a
// thread (2 x 64 at D 128).  fp32 keeps D + 1 words a staged row.
//
// head_dim 256 (gemma-7b).  bf16: a thread's dK and dV sums over all 256
// columns would be 2 x 128 fp32 registers, past the 255 a thread may hold.
// So the dK/dV kernel splits the output columns over two blocks (grid y = 2
// G): each recomputes S and dP over all of D for its KV tile and sums dK and
// dV for its 128 columns (2 x 64 registers, as at D 128).  That costs S and
// dP twice (9 products of a visible pair where 7 would do) and keeps the
// launch count at three; splitting into a dV and a dK kernel would save one
// product and cost a launch.  The dQ kernel holds its 16 x 256 sum (128
// registers) whole: it holds no Q fragments across steps, as the forward
// did, so the scores fit beside it.  fp32: four staged 64-row tiles of 257
// words (263 KB) pass the 227 KB a block may take, so the fp32 kernels take
// 32-row tiles at D 256 (2 x 2 scores a thread; fp32_tile), 140 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_tiles.cuh"
#include "positions.cuh"

namespace {

using namespace dco_tiles;

// the position variant's translation unit: the _ext_ bodies read `pos`
#ifdef DCO_FLASH_POS
constexpr bool POS_TABLE = true;
#define DCO_POS_PARAM , const int* __restrict__ pos
#define DCO_POS_ARG pos
#else
constexpr bool POS_TABLE = false;
#define DCO_POS_PARAM
#define DCO_POS_ARG nullptr
#endif

// (EXT, pos) the pair of TB-row tiles at q_lo and k_lo hidden from each other,
// k_mn and k_mx the KV tile's smallest and largest position: skipped whole.
// Uniform over the block (every warp reduces the Q tile itself).
template <int TB>
__device__ __forceinline__ bool pair_hidden(const int* __restrict__ pos, int q_lo, int S,
                                            int k_mn, int k_mx, int window) {
  int q_mn, q_mx;
  dco_positions::tile_min_max(pos, q_lo, min(TB, S - q_lo), q_mn, q_mx);
  return dco_positions::tiles_hidden(q_mn, q_mx, k_mn, k_mx, window);
}

constexpr int BT = 64;        // rows of a Q or KV tile (bf16; fp32 up to D 128)
constexpr int THREADS = 256;  // fp32 path: 16 x 16, thread (ty, tx) owns rows ty*R + i and columns tx + 16*j
constexpr int MMA_WARPS = 4;  // bf16 path: warps of a block, 16 rows each of a 64-row tile
constexpr int SMEM_LIMIT = 232448;

// fp32 path: rows of a tile at head_dim D (32 at 256, where 64 do not fit)
template <int D>
__host__ __device__ constexpr int fp32_tile() {
  return D > 128 ? 32 : BT;
}

// bf16 dK/dV kernel: blocks that share a KV tile's output columns (2 at 256)
template <int D>
__host__ __device__ constexpr int dkdv_splits() {
  return D > 128 ? 2 : 1;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Q row q sees KV row kv: causal, and (EXT, window > 0) kv > q - window; (EXT,
// pos) the same tests on their positions, kv below S
template <bool EXT>
__device__ __forceinline__ bool visible(int q, int kv, int window, const int* pos = nullptr,
                                        int S = 0) {
  if (EXT && POS_TABLE) {
    if (kv >= S) return false;
    const int pq = pos[q], pk = pos[kv];
    return pk <= pq && (window == 0 || pk > pq - window);
  }
  return kv <= q && (!EXT || window == 0 || kv > q - window);
}

// The Q tiles of TB rows a KV tile's block walks: from its own to the last
// that the window of its last row reaches (the last tile without one)
template <bool EXT, int TB>
__device__ __forceinline__ int q_tile_end(int k_lo, int n_tiles, int window) {
  return EXT && window > 0 ? min(n_tiles, (k_lo + TB - 1 + window - 1) / TB + 1) : n_tiles;
}

// The first KV tile of TB rows that row q_lo can see (the forward's first_kv_tile)
template <bool EXT, int TB>
__device__ __forceinline__ int kv_tile_begin(int q_lo, int window) {
  return EXT && window > 0 ? max(0, q_lo - window + 1) / TB : 0;
}

// Rows [0, TB) of an fp32 tile into padded shared rows of D + 1 words, from
// device rows `stride` elements apart; rows from `nvalid` on are zeros.
template <int D, int TB>
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride,
                                      int nvalid) {
  for (int i = threadIdx.x; i < TB * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    dst[r * (D + 1) + c] = r < nvalid ? src[r * stride + c] : 0.f;
  }
}

// lse and delta of rows [row0, row0 + TB) of one (batch, head); zeros past S.
template <int TB = BT>
__device__ __forceinline__ void stage_rows_stats(float* lse_s, float* delta_s, const float* lse,
                                                 const float* delta, int row0, int S) {
  for (int i = threadIdx.x; i < TB; i += blockDim.x) {
    const bool ok = row0 + i < S;
    lse_s[i] = ok ? lse[row0 + i] : 0.f;
    delta_s[i] = ok ? delta[row0 + i] : 0.f;
  }
}

// P and dS of one (Q tile, KV tile) pair of TB rows each into shared memory:
//   S = Q K^T, dP = dO V^T (one pass over D), P = exp(s_c - lse) with s_c
//   the scaled (EXT: and capped) scores, dS = P * (dP - delta) (EXT: times
//   the cap's derivative); both 0 where the mask or the ragged edge hides the
//   pair.  WRITE_P: also store P (the dK/dV kernel needs it).
template <int D, int TB, bool WRITE_P, bool EXT>
__device__ __forceinline__ void tile_grads(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, const float* lse_s,
                                           const float* delta_s, float* Ps, float* dSs,
                                           int q_lo, int k_lo, int S, float scale, int window,
                                           float softcap, const int* __restrict__ pos) {
  constexpr int LD = D + 1;
  constexpr int LDP = TB + 1;
  constexpr int R = TB / 16;  // rows and columns of a thread's patch
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qf[R], of[R], kf[R], vf[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qf[i] = Qs[(ty * R + i) * LD + d];
      of[i] = dOs[(ty * R + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kf[j] = Ks[(tx + 16 * j) * LD + d];
      vf[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] += qf[i] * kf[j];
        dp[i][j] += of[i] * vf[j];
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    const int row = q_lo + r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      const int col = k_lo + c;
      // col < S follows from causality without positions
      const bool ok = row < S && visible<EXT>(row, col, window, pos, S);
      float x = s[i][j] * scale;
      float dcap = 1.f;
      if (EXT && softcap > 0.f) {  // as the fp32 forward caps
        const float t = tanhf(x / softcap);
        x = softcap * t;
        dcap = 1.f - t * t;
      }
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      if (WRITE_P) Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = EXT ? p * (dp[i][j] - delta_s[r]) * dcap : p * (dp[i][j] - delta_s[r]);
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
template <int D, bool EXT>
__device__ __forceinline__ void dkdv_body(const float* __restrict__ q, const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, float* __restrict__ dk,
                                          float* __restrict__ dv, int S, int H, int G,
                                          float scale, int window, float softcap,
                                          const int* __restrict__ pos) {
  constexpr int TB = fp32_tile<D>();
  constexpr int R = TB / 16;    // KV rows a thread owns
  constexpr int LD = D + 1;
  constexpr int LDP = TB + 1;
  constexpr int NJ = D / 16;  // output columns a thread owns in each row
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TB * LD;
  float* Qs = Vs + TB * LD;
  float* dOs = Qs + TB * LD;
  float* Ps = dOs + TB * LD;
  float* dSs = Ps + TB * LDP;
  float* lse_s = dSs + TB * LDP;
  float* delta_s = lse_s + TB;

  const int kt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / G;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k_lo = kt * TB;
  const int n_tiles = (S + TB - 1) / TB;
  const bool by_pos = EXT && POS_TABLE;  // every Q tile not hidden from this one
  const int* pb = by_pos ? pos + (long long)b * S : nullptr;
  const int qt_end = by_pos ? n_tiles : q_tile_end<EXT, TB>(k_lo, n_tiles, window);
  int k_mn = 0, k_mx = 0;
  if (by_pos) dco_positions::tile_min_max(pb, k_lo, min(TB, S - k_lo), k_mn, k_mx);
  const long long qstride = (long long)H * D;  // elements between rows of q, o, dout
  const long long kstride = (long long)G * D;

  const long long kv_off = ((long long)b * S + k_lo) * kstride + (long long)g * D;
  stage<D, TB>(Ks, k + kv_off, kstride, S - k_lo);
  stage<D, TB>(Vs, v + kv_off, kstride, S - k_lo);

  float acc_k[R][NJ], acc_v[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    for (int qt = by_pos ? 0 : kt; qt < qt_end; ++qt) {  // causal: rows at or past k_lo
      const int q_lo = qt * TB;
      if (by_pos && pair_hidden<TB>(pb, q_lo, S, k_mn, k_mx, window)) continue;
      __syncthreads();  // the previous pair's tiles are free
      const long long q_off = ((long long)b * S + q_lo) * qstride + (long long)h * D;
      stage<D, TB>(Qs, q + q_off, qstride, S - q_lo);
      stage<D, TB>(dOs, dout + q_off, qstride, S - q_lo);
      const long long st_off = ((long long)b * H + h) * S;
      stage_rows_stats<TB>(lse_s, delta_s, lse + st_off, delta + st_off, q_lo, S);
      __syncthreads();
      tile_grads<D, TB, true, EXT>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q_lo, k_lo, S,
                                   scale, window, softcap, pb);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q for this thread's KV rows and columns
      const int r_end = min(TB, S - q_lo);
      for (int r = 0; r < r_end; ++r) {
        float p[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = Ps[r * LDP + ty * R + i];
          ds[i] = dSs[r * LDP + ty * R + i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float o = dOs[r * LD + tx + 16 * jj];
          const float qv = Qs[r * LD + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc_v[i][jj] += p[i] * o;
            acc_k[i][jj] += ds[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k_lo + ty * R + i;
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

// Above D 64 the staged tiles leave shared memory for one block an SM;
// saying so lets ptxas keep the sums in registers (left to itself, it took
// 128 registers at D 112 and spilled).
template <int D>
__global__ void __launch_bounds__(THREADS, D > 64 ? 1 : 2)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int H, int G, float scale) {
  dkdv_body<D, false>(q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, 0, 0.f, nullptr);
}

template <int D>
__global__ void __launch_bounds__(THREADS, D > 64 ? 1 : 2)
dkdv_ext_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int S, int H, int G, float scale,
                int window, float softcap DCO_POS_PARAM) {
  dkdv_body<D, true>(q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, window, softcap,
                     DCO_POS_ARG);
}

// grid = (Q tiles, H, B); layouts as dkdv_body, dq (B, S, H, D).
template <int D, bool EXT>
__device__ __forceinline__ void dq_body(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, float* __restrict__ dq,
                                        int S, int H, int G, float scale, int window,
                                        float softcap, const int* __restrict__ pos) {
  constexpr int TB = fp32_tile<D>();
  constexpr int R = TB / 16;    // Q rows a thread owns
  constexpr int LD = D + 1;
  constexpr int LDP = TB + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TB * LD;
  float* Qs = Vs + TB * LD;
  float* dOs = Qs + TB * LD;
  float* dSs = dOs + TB * LD;
  float* lse_s = dSs + TB * LDP;
  float* delta_s = lse_s + TB;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q_lo = qt * TB;
  const long long qstride = (long long)H * D;
  const long long kstride = (long long)G * D;

  const long long q_off = ((long long)b * S + q_lo) * qstride + (long long)h * D;
  stage<D, TB>(Qs, q + q_off, qstride, S - q_lo);
  stage<D, TB>(dOs, dout + q_off, qstride, S - q_lo);
  const long long st_off = ((long long)b * H + h) * S;
  stage_rows_stats<TB>(lse_s, delta_s, lse + st_off, delta + st_off, q_lo, S);

  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  // causal: KV tiles up to the diagonal (EXT: from the window's first; EXT
  // and pos: every KV tile)
  const bool by_pos = EXT && POS_TABLE;
  const int* pb = by_pos ? pos + (long long)b * S : nullptr;
  const int kt_last = by_pos ? (S - 1) / TB : qt;
  for (int kt = by_pos ? 0 : kv_tile_begin<EXT, TB>(q_lo, window); kt <= kt_last; ++kt) {
    const int k_lo = kt * TB;
    if (by_pos) {  // a KV tile hidden from this Q tile: skipped
      int k_mn, k_mx;
      dco_positions::tile_min_max(pb, k_lo, min(TB, S - k_lo), k_mn, k_mx);
      if (pair_hidden<TB>(pb, q_lo, S, k_mn, k_mx, window)) continue;
    }
    __syncthreads();  // the previous KV tiles are free (and Q, dO staged)
    const long long kv_off = ((long long)b * S + k_lo) * kstride + (long long)g * D;
    stage<D, TB>(Ks, k + kv_off, kstride, S - k_lo);
    stage<D, TB>(Vs, v + kv_off, kstride, S - k_lo);
    __syncthreads();
    tile_grads<D, TB, false, EXT>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q_lo, k_lo, S,
                                  scale, window, softcap, pb);
    __syncthreads();
    // dQ += dS K for this thread's Q rows and columns
    const int c_end = min(TB, S - k_lo);
    for (int c = 0; c < c_end; ++c) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty * R + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float kv = Ks[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][jj] += ds[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q_lo + ty * R + i;
    if (row < S) {
      const long long off = ((long long)b * S + row) * qstride + (long long)h * D;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) dq[off + tx + 16 * jj] = acc[i][jj] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int H, int G, float scale) {
  dq_body<D, false>(q, k, v, dout, lse, delta, dq, S, H, G, scale, 0, 0.f, nullptr);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_ext_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int H, int G, float scale, int window,
              float softcap DCO_POS_PARAM) {
  dq_body<D, true>(q, k, v, dout, lse, delta, dq, S, H, G, scale, window, softcap, DCO_POS_ARG);
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

// acc (16 x DC) += A (16 x 32, two 16-deep steps of bf16 fragments) times
// rows c0.. and columns [col0, col0 + DC) of a [k][n] tile read transposed.
template <int D, int DC>
__device__ __forceinline__ void mma_acc(float (&acc)[DC / 8][4], const uint32_t (&a)[2][4],
                                        uint32_t Bt, int c0, int col0, int lane) {
  constexpr int ROWB = row_bytes<D>();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) {
      uint32_t bf[4];
      ldsm_x4_trans(Bt + swz<ROWB>(c0 + 16 * kk + (lane & 15), col0 / 8 + 2 * j + (lane >> 4)),
                    bf);
      mma_bf16(acc[2 * j], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], a[kk], bf[2], bf[3]);
    }
}

// Rows of a 16 x DC fp32 sum (C fragments) times `mul`, as bf16, to rows
// `row`, `row` + 8 (those below S) of a tensor `stride` elements a row.
template <int DC>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[DC / 8][4], int row,
                                           int S, long long stride, float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= S) continue;
    bf16* o = out + (long long)(row + 8 * i) * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
  }
}

// P (and the cap's derivative) of a raw score s = (Q K^T) of a visible
// pair: exp(s * scale - lse), or (EXT, softcap > 0) with the score capped as
// the bf16 forward caps it, in natural units.
template <bool EXT>
__device__ __forceinline__ float prob_mma(float s, float scale, float lse, float softcap,
                                          float& dcap) {
  if (EXT && softcap > 0.f) {
    const float t = tanhf(s * (scale / softcap));
    dcap = 1.f - t * t;
    return __expf(softcap * t - lse);
  }
  dcap = 1.f;
  return __expf(s * scale - lse);
}

// grid = (KV tiles, G * dkdv_splits<D>(), B), MMA_WARPS warps; layouts as
// dkdv_body.  Warp w owns KV rows [16 w, +16) of the tile, and the block
// output columns [c_lo, c_lo + DC); S^T = K Q^T and dP^T = V dO^T put its KV
// rows in the rows of the products, so that P^T and dS^T are A fragments of
// dV += P^T dO and dK += dS^T Q.
template <int D, bool EXT>
__device__ __forceinline__ void dkdv_mma_body(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              const bf16* __restrict__ dout,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                                              int H, int G, float scale, int window,
                                              float softcap, const int* __restrict__ pos) {
  constexpr int TILEB = BT * row_bytes<D>();
  constexpr int SPLITS = dkdv_splits<D>();
  constexpr int DC = D / SPLITS;  // output columns of a block
  constexpr int NO = DC / 8;
  extern __shared__ __align__(128) unsigned char smem_b[];
  const uint32_t Ks = smem_addr(smem_b);
  const uint32_t Vs = Ks + TILEB;
  const uint32_t Qs = Vs + TILEB;
  const uint32_t dOs = Qs + TILEB;
  float* lse_s = reinterpret_cast<float*>(smem_b + 4 * TILEB);
  float* delta_s = lse_s + BT;

  const int kt = blockIdx.x;
  const int g = blockIdx.y / SPLITS;
  const int c_lo = blockIdx.y % SPLITS * DC;  // this block's first output column
  const int b = blockIdx.z;
  const int group = H / G;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);  // this warp's first KV row in the tile
  const int k_lo = kt * BT;
  const int kv_a = k_lo + r0 + (lane >> 2);  // this thread's KV rows: kv_a and kv_a + 8
  const int n_tiles = (S + BT - 1) / BT;
  const bool by_pos = EXT && POS_TABLE;  // every Q tile not hidden, no skip by index
  const int* pb = by_pos ? pos + (long long)b * S : nullptr;
  const int qt_end = by_pos ? n_tiles : q_tile_end<EXT, BT>(k_lo, n_tiles, window);
  int k_mn = 0, k_mx = 0;
  if (by_pos) dco_positions::tile_min_max(pb, k_lo, min(BT, S - k_lo), k_mn, k_mx);
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
    for (int qt = by_pos ? 0 : kt; qt < qt_end; ++qt) {  // causal: Q rows at or past k_lo
      const int q_lo = qt * BT;
      if (by_pos && pair_hidden<BT>(pb, q_lo, S, k_mn, k_mx, window)) continue;
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
        if (q_lo + c0 >= S || (!by_pos && q_lo + c0 + 31 < k_lo + r0)) continue;
        // (EXT) or all past the window of every KV row of this warp
        if (EXT && !by_pos && window > 0 && q_lo + c0 >= k_lo + r0 + 15 + window) continue;
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
            const bool ok = q_lo + c < S && visible<EXT>(q_lo + c, kv, window, pb, S);
            float dcap = 1.f;  // read only where p is 0 when the pair is hidden
            p[e] = ok ? prob_mma<EXT>(s[j][e], scale, lse_s[c], softcap, dcap) : 0.f;
            ds[e] = p[e] * (dp[j][e] - delta_s[c]);
            if (EXT) ds[e] *= dcap;
          }
          pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
          pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
          da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
          da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }
        mma_acc<D, DC>(acc_v, pa, dOs, c0, c_lo, lane);
        mma_acc<D, DC>(acc_k, da, Qs, c0, c_lo, lane);
      }
    }
  }
  const long long out_off = (long long)b * S * kstride + (long long)g * D + c_lo;
  store_rows<DC>(dk + out_off, acc_k, kv_a, S, kstride, scale, lane);
  store_rows<DC>(dv + out_off, acc_v, kv_a, S, kstride, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int G, float scale) {
  dkdv_mma_body<D, false>(q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, 0, 0.f, nullptr);
}

template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
dkdv_mma_ext_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int G,
                    float scale, int window, float softcap DCO_POS_PARAM) {
  dkdv_mma_body<D, true>(q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, window, softcap,
                         DCO_POS_ARG);
}

// grid = (Q tiles, H, B), MMA_WARPS warps; layouts as dkdv_body.  Warp w
// owns Q rows [16 w, +16) of the tile.
template <int D, bool EXT>
__device__ __forceinline__ void dq_mma_body(const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const bf16* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            bf16* __restrict__ dq, int S, int H, int G,
                                            float scale, int window, float softcap,
                                            const int* __restrict__ pos) {
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

  // causal: KV tiles up to the diagonal (EXT: from the window's first; EXT
  // and pos: every KV tile, no skip by index)
  const bool by_pos = EXT && POS_TABLE;
  const int* pb = by_pos ? pos + (long long)b * S : nullptr;
  const int kt_last = by_pos ? (S - 1) / BT : qt;
  for (int kt = by_pos ? 0 : kv_tile_begin<EXT, BT>(q_lo, window); kt <= kt_last; ++kt) {
    const int k_lo = kt * BT;
    if (by_pos) {  // a KV tile hidden from this Q tile: skipped
      int k_mn, k_mx;
      dco_positions::tile_min_max(pb, k_lo, min(BT, S - k_lo), k_mn, k_mx);
      if (pair_hidden<BT>(pb, q_lo, S, k_mn, k_mx, window)) continue;
    }
    __syncthreads();  // the previous K and V tiles are free
    const long long kv_off = ((long long)b * S + k_lo) * kstride + (long long)g * D;
    stage_tile<D>(Ks, k + kv_off, kstride, BT, min(BT, S - k_lo));
    stage_tile<D>(Vs, v + kv_off, kstride, BT, min(BT, S - k_lo));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < BT; c0 += 32) {
      // KV rows [k_lo + c0, +32) all above this warp's Q rows (by_pos: all past S)
      if (by_pos ? k_lo + c0 >= S : k_lo + c0 > q_lo + r0 + 15) continue;
      // (EXT) or all older than the window of every Q row of this warp
      if (EXT && !by_pos && window > 0 && k_lo + c0 + 31 <= q_lo + r0 - window) continue;
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
          const bool ok = q_lo + r < S && visible<EXT>(q_lo + r, kv, window, pb, S);
          float dcap = 1.f;
          const float p = ok ? prob_mma<EXT>(s[j][e], scale, lse_s[r], softcap, dcap) : 0.f;
          ds[e] = p * (dp[j][e] - delta_s[r]);
          if (EXT) ds[e] *= dcap;
        }
        da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      mma_acc<D, D>(acc, da, Ks, c0, 0, lane);
    }
  }
  store_rows<D>(dq + (long long)b * S * qstride + (long long)h * D, acc,
                q_lo + r0 + (lane >> 2), S, qstride, scale, lane);
}

template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int H, int G, float scale) {
  dq_mma_body<D, false>(q, k, v, dout, lse, delta, dq, S, H, G, scale, 0, 0.f, nullptr);
}

template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
dq_mma_ext_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int H, int G, float scale, int window,
                  float softcap DCO_POS_PARAM) {
  dq_mma_body<D, true>(q, k, v, dout, lse, delta, dq, S, H, G, scale, window, softcap,
                       DCO_POS_ARG);
}

// delta = rowsum(dO * O), the first of the three launches
template <typename T, int D>
int launch_delta(const T* o, const T* dout, float* delta, int B, int S, int H,
                 cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffll) return -1;
  delta_kernel<T, D><<<(unsigned)blocks, THREADS, 0, stream>>>(o, dout, delta, B, S, H);
  return (int)cudaGetLastError();
}

// The bf16 path's three launches; the _ext_ kernels where a window or a
// softcap is given (the position variant: they alone, with `pos`).
template <int D>
int launch_bwd_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                   const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                   bf16* dv, const int* pos, int B, int S, int H, int G, float scale, int window,
                   float softcap, cudaStream_t stream) {
  const int smem = 4 * BT * row_bytes<D>() + 2 * BT * (int)sizeof(float);
#ifdef DCO_FLASH_POS
  const void* dkdv = (const void*)dkdv_mma_ext_kernel<D>;
  const void* dqk = (const void*)dq_mma_ext_kernel<D>;
#else
  const bool ext = window > 0 || softcap > 0.f;
  const void* dkdv = ext ? (const void*)dkdv_mma_ext_kernel<D> : (const void*)dkdv_mma_kernel<D>;
  const void* dqk = ext ? (const void*)dq_mma_ext_kernel<D> : (const void*)dq_mma_kernel<D>;
#endif
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_delta<bf16, D>(o, dout, delta, B, S, H, stream);
  if (rc != 0) return rc;
  const int n_tiles = (S + BT - 1) / BT;
  const dim3 grid_kv(n_tiles, G * dkdv_splits<D>(), B), grid_q(n_tiles, H, B);
#ifdef DCO_FLASH_POS
  dkdv_mma_ext_kernel<D><<<grid_kv, MMA_WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, window, softcap, pos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_mma_ext_kernel<D><<<grid_q, MMA_WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, G, scale, window, softcap, pos);
  return (int)cudaGetLastError();
#else
  if (ext)
    dkdv_mma_ext_kernel<D><<<grid_kv, MMA_WARPS * 32, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, window, softcap);
  else
    dkdv_mma_kernel<D><<<grid_kv, MMA_WARPS * 32, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                                                  dv, S, H, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ext)
    dq_mma_ext_kernel<D><<<grid_q, MMA_WARPS * 32, smem, stream>>>(
        q, k, v, dout, lse, delta, dq, S, H, G, scale, window, softcap);
  else
    dq_mma_kernel<D><<<grid_q, MMA_WARPS * 32, smem, stream>>>(q, k, v, dout, lse, delta, dq, S,
                                                               H, G, scale);
  return (int)cudaGetLastError();
#endif
}

// The fp32 path's three launches, as the bf16 path's.
template <int D>
int launch_bwd_fp32(const float* q, const float* k, const float* v, const float* o,
                    const float* dout, const float* lse, float* delta, float* dq, float* dk,
                    float* dv, const int* pos, int B, int S, int H, int G, float scale, int window,
                    float softcap, cudaStream_t stream) {
  constexpr int TB = fp32_tile<D>();
  constexpr int LD = D + 1;
  constexpr int LDP = TB + 1;
  const size_t smem_dkdv = sizeof(float) * (4 * TB * LD + 2 * TB * LDP + 2 * TB);
  const size_t smem_dq = sizeof(float) * (4 * TB * LD + TB * LDP + 2 * TB);
  if (smem_dkdv > (size_t)SMEM_LIMIT) return -2;
#ifdef DCO_FLASH_POS
  const void* dkdv = (const void*)dkdv_ext_kernel<D>;
  const void* dqk = (const void*)dq_ext_kernel<D>;
#else
  const bool ext = window > 0 || softcap > 0.f;
  const void* dkdv = ext ? (const void*)dkdv_ext_kernel<D> : (const void*)dkdv_kernel<D>;
  const void* dqk = ext ? (const void*)dq_ext_kernel<D> : (const void*)dq_kernel<D>;
#endif
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_delta<float, D>(o, dout, delta, B, S, H, stream);
  if (rc != 0) return rc;
  const int n_tiles = (S + TB - 1) / TB;
#ifdef DCO_FLASH_POS
  dkdv_ext_kernel<D><<<dim3(n_tiles, G, B), THREADS, smem_dkdv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, window, softcap, pos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_ext_kernel<D><<<dim3(n_tiles, H, B), THREADS, smem_dq, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, G, scale, window, softcap, pos);
  return (int)cudaGetLastError();
#else
  if (ext)
    dkdv_ext_kernel<D><<<dim3(n_tiles, G, B), THREADS, smem_dkdv, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, H, G, scale, window, softcap);
  else
    dkdv_kernel<D><<<dim3(n_tiles, G, B), THREADS, smem_dkdv, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, H, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ext)
    dq_ext_kernel<D><<<dim3(n_tiles, H, B), THREADS, smem_dq, stream>>>(
        q, k, v, dout, lse, delta, dq, S, H, G, scale, window, softcap);
  else
    dq_kernel<D><<<dim3(n_tiles, H, B), THREADS, smem_dq, stream>>>(q, k, v, dout, lse, delta,
                                                                    dq, S, H, G, scale);
  return (int)cudaGetLastError();
#endif
}

template <int D>
int launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
               const int* pos, int B, int S, int H, int G, float scale, int window, float softcap,
               cudaStream_t s) {
  if (dtype == 0)
    return launch_bwd_mma<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                             static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv), pos, B, S, H, G, scale,
                             window, softcap, s);
  return launch_bwd_fp32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<const float*>(o),
                            static_cast<const float*>(dout), lse, delta,
                            static_cast<float*>(dq), static_cast<float*>(dk),
                            static_cast<float*>(dv), pos, B, S, H, G, scale, window, softcap, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  Causal attention with Sq == Sk == S.  q, o,
// dout and dq are (B, S, H, D), k, v, dk and dv (B, S, G, D), all contiguous;
// lse (B, H, S) fp32 as the forward (dco_flash_attention) wrote it, with the
// same window and softcap; delta (B, H, S) fp32 scratch.  `window` > 0 lets
// row r see columns (r - window, r] (0: none); `softcap` 0 means none.  `pos`
// (B, S) contiguous int32, or null: the positions of both the query and the
// key rows that the forward masked by (its q_pos and kv_pos, one table),
// which the position variant (flash_attention_bwd_pos.cu) takes.
// Three launches on `stream`.  Returns 0, a cudaError_t, -1 for arguments the
// kernel does not take (D other than 64, 112, 128 and 256, H not a multiple
// of G, a negative window or softcap, empty or oversized grids), or -2 when
// the shared memory a block needs is more than a block may take.
namespace {

int bwd_entry(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv, const int* pos,
              int dtype, int B, int S, int H, int G, int D, int window, float scale,
              float softcap, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || window < 0 || !(softcap >= 0.f)) return -1;
  if (B > 65535 || H > 65535 || 2 * G > 65535) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (dtype == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
                     (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16 != 0)
    return -1;  // the 16-byte copies and the paired stores
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_bwd<64>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, pos, B, S, H, G,
                          scale, window, softcap, s);
  if (D == 112)
    return launch_bwd<112>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, pos, B, S, H, G,
                           scale, window, softcap, s);
  if (D == 128)
    return launch_bwd<128>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, pos, B, S, H, G,
                           scale, window, softcap, s);
  if (D == 256)
    return launch_bwd<256>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, pos, B, S, H, G,
                           scale, window, softcap, s);
  return -1;
}

}  // namespace

#ifdef DCO_FLASH_POS
extern "C" int dco_flash_attention_bwd_pos(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const float* lse,
                                           float* delta, void* dq, void* dk, void* dv,
                                           const int* pos, int dtype, int B, int S, int H,
                                           int G, int D, int window, float scale,
                                           float softcap, void* stream) {
  if (pos == nullptr) return -1;
  return bwd_entry(q, k, v, o, dout, lse, delta, dq, dk, dv, pos, dtype, B, S, H, G, D, window,
                   scale, softcap, stream);
}
#else
extern "C" int dco_flash_attention_bwd_pos(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const float* lse,
                                           float* delta, void* dq, void* dk, void* dv,
                                           const int* pos, int dtype, int B, int S, int H,
                                           int G, int D, int window, float scale,
                                           float softcap, void* stream);

extern "C" int dco_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv,
                                       const int* pos, int dtype,
                                       int B, int S, int H, int G, int D, int window,
                                       float scale, float softcap, void* stream) {
  if (pos != nullptr)  // the position variant (flash_attention_bwd_pos.cu)
    return dco_flash_attention_bwd_pos(q, k, v, o, dout, lse, delta, dq, dk, dv, pos, dtype, B,
                                       S, H, G, D, window, scale, softcap, stream);
  return bwd_entry(q, k, v, o, dout, lse, delta, dq, dk, dv, pos, dtype, B, S, H, G, D, window,
                   scale, softcap, stream);
}
#endif
