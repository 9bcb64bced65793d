// FlashAttention backward for Hopper (sm_90a): the gradient of causal GQA
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
//  (b) dK and dV: a block keeps its KV rows' K and V in shared memory and
//      walks, for every query head of its GQA group, the Q tiles at or below
//      the causal diagonal, so that dK and dV (summed over the group) stay in
//      registers and are written once.
//  (c) dQ: a block keeps its Q rows' Q and dO and walks the KV tiles up to
//      the diagonal; dQ stays in registers and is written once.
// Both (b) and (c) recompute S and dP for each pair of tiles, so the kernels
// run 7 products of a visible pair where the bound counts 5: the price of
// writing each gradient once from one block in a fixed order.  FlashAttention-3
// computes S and dP once and adds dQ from the dK/dV kernel with fp32 atomics,
// whose order changes from run to run; here two calls on the same inputs give
// bit-identical gradients, and autograd through the port stays reproducible.
//
// bf16, the training path (dkdv_wgmma*_kernel, dq_wgmma*_kernel): Hopper's
// own instructions (hopper.cuh), laid out as the forward's bf16 path.
//  * Warp specialisation.  A block is a producer warpgroup and consumer
//    warpgroups.  One warp of the producer issues every load as a TMA copy
//    from one elected lane, and its registers go to the consumers
//    (setmaxnreg: PRODUCER_REGS, CONSUMER_REGS).  Streamed tiles pass
//    through a ring of ring_stages<D>() slots (STAGES; two at head_dim 256,
//    where a third would pass the block's shared memory; on an H100 three
//    slots were faster than two at every other training shape) with a full
//    and an empty mbarrier each; once the roles split no block barrier
//    remains.  TMA fills a box's elements past the tensor's ends with zeros,
//    so rows past S are zeros.  Each consumer waits for its block's resident
//    tiles before its first product and for each slot before reading it: the
//    shared memory otherwise still holds the previous block's tiles.
//  * dK/dV (FlashAttention-3's layout).  A block holds CONSUMERS 64-row KV
//    tiles, one a consumer, loaded once; the producer streams, for every
//    query head of the group and every Q tile the walk reaches, the Q and dO
//    tiles and the tile's 64 lse and delta values (1-d tensor maps: a box of
//    STATS_BOX values from the 16-byte boundary at or below the tile's
//    first, since a box that starts off one faults).  With the KV rows in
//    M, S^T = K Q^T and dP^T = V dO^T are wgmma from shared memory, both
//    sides K-major; P^T = exp(S^T scale - lse[col])
//    and dS^T = P^T (dP^T - delta[col]) are computed in fp32 on the
//    accumulator fragments, rounded to bf16 in registers and used as the
//    register A operand of dV += P^T dO and dK += dS^T Q, dO and Q the
//    MN-major B from the same swizzled tiles: P and dS never pass through
//    shared memory.  dV's product is issued as soon as P^T is packed, and
//    dS^T is computed while the tensor cores add it.  (Issuing the next
//    item's S^T and dP^T behind this item's dV and dK as well made ptxas
//    serialise every wgmma of the kernel for want of registers, C7512, and
//    was slower.)  Blocks are launched heaviest first: KV block 0 walks every
//    Q tile.
//  * dQ.  A block is one Q tile of each KV head: a consumer's 64 packed rows
//    are 64 / group query rows of every head of the group, as the forward
//    packs them (PackGQA), so each K/V tile reaches shared memory once per
//    group.  The producer loads Q and dO once (packed boxes), and K and V
//    stream through the ring.  S = Q K^T and dP = dO V^T from shared memory;
//    dS is the register A operand of dQ += dS K, K the MN-major B.  As in the
//    forward, the next tile's S and dP are issued with this tile's dS K, and
//    the next dS is computed while the tensor cores add it.  Each thread
//    reads the lse and delta of its two rows once.  Blocks are launched
//    heaviest first: the last Q tile walks the most KV tiles.
//  * head_dim 112 is two 64-column boxes a row, the second zero past column
//    112 (its products computed, its columns never written); 64, 128 and 256
//    are one, two and four boxes.
//  * head_dim 256 (gemma-7b).  A warpgroup cannot hold 64 x 256 fp32 sums of
//    both dK and dV (256 registers a thread).  So a dK/dV block's two
//    consumers share one KV tile and each sums half of the columns of dK and
//    dV: both compute S^T and dP^T of every pair (9 products of a visible
//    pair where 7 would do), while the ring's Q and dO tiles are loaded once
//    for both.  (Two roles instead, one consumer making S^T, P^T and dV and
//    handing P^T to the other through shared memory for dP^T, dS^T and dK,
//    gained little at gemma-7b's training shape on an H100: not worth its
//    second code path.)  The dQ kernel has one consumer there, whose 64 x 256 sum is
//    128 registers (the forward's choice: two consumers' Q, dO and the ring
//    pass the block's shared memory).
//
// fp32 (dkdv_kernel, dq_kernel): FMA on tiles widened into shared memory, a
// 4 x 4 patch of scores a thread (16 x 16 threads on 64 x 64 tiles), exact
// fp32 sums (no TF32, which the fp32 tolerance rules out).  Rows are staged
// with one pad word so that 16 lanes reading 16 consecutive rows hit 16
// banks.  Four staged 64-row tiles of 257 words (263 KB) pass the 227 KB a
// block may take at head_dim 256, so the fp32 kernels take 32-row tiles
// there (2 x 2 scores a thread; fp32_tile), 140 KB.
//
// Computed here: causal masking with Sq == Sk (training's shape), any length,
// head_dim 64, 112, 128 and 256, GQA groups of any size (bf16: at most 64
// query heads a KV head, a dQ consumer's rows), bf16 and fp32, with or
// without a sliding window and a softcap.  Not computed (the wrapper refuses
// it before any launch): non-causal attention.
//
// Sliding window and softcap (gemma2-27b: window 4096 on its local layers,
// softcap 50).  They are taken by kernels of their own (the `_ext_` ones,
// the same bodies with EXT set), so that the kernels without them keep their
// code and registers.  With s = S * scale and the cap c, the forward's
// scores are s_c = c tanh(s / c), and its lse is the natural log-sum-exp of
// the capped, masked scores.  So P = exp(s_c - lse) is recomputed (the bf16
// kernels in log2 units from the natural lse), the cap's argument formed as
// each forward path forms it, and dS = P (dP - delta) (1 - (s_c / c)^2): the
// cap's derivative enters dS before it is rounded to bf16, so dK and dQ take
// it and dV does not.  Row r sees columns (r - W, r].  A KV tile's walk runs
// over the Q tiles from its own to the last that its last row's window
// reaches, (k_lo + BT - 1 + W - 1) / BT; a Q tile's over the KV tiles from
// the forward's `first_kv_tile`, (q_lo - W + 1) / BT; every element is
// masked by kv > q - W beside the causal test.
//
// Explicit positions (the JAX package's `forward` with a (B, S) positions
// table, which its autodiff differentiates through `gqa_attention`): the
// position variant, flash_attention_bwd_pos.cu, compiles the `_ext_` bodies
// again with DCO_FLASH_POS defined, taking `pos` (B, S) int32, the positions
// of both the query and the key rows (training passes one table for both);
// a translation unit of its own, so that the kernels here keep their code and
// registers, and dco_flash_attention_bwd hands a call with a table to it (its
// bf16 kernels are dkdv_wgmma_pos_kernel and dq_wgmma_pos_kernel).  Row q
// sees row kv where pos[kv] <= pos[q] and, under a window, pos[kv] > pos[q] -
// W.  Positions need not follow the rows, so a KV block walks every Q tile
// and a Q tile's block every KV tile, skipping a pair of tiles whose smallest
// and largest positions prove that no row of one sees a row of the other
// (positions.cuh); every element is masked on the table.  Every row sees
// itself under such a table, so its lse is finite and no row needs the
// forward's rule for a row that sees no key; a hidden pair's P and dS are 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "positions.cuh"

namespace {

using namespace dco_hopper;

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
constexpr int SMEM_LIMIT = 232448;
constexpr int CONSUMERS = 2;        // bf16 path: consumer warpgroups of a dK/dV block (dQ: above WIDE_DIM one)
constexpr int WIDE_DIM = 128;       // bf16 path: above this head size, the column split and one dQ consumer
constexpr int MMA_ROWS = 64;        // bf16 path: rows of a consumer's products (wgmma's M)
constexpr int STAGES = 3;           // bf16 path: streamed items in the ring (2 above WIDE_DIM)
constexpr int STATS_BOX = 68;      // bf16 path: lse (or delta) values a TMA box brings for a Q tile
constexpr int STATS_BYTES = 384;    // bf16 path: the shared memory of one such box
constexpr int BAR_BYTES = 64;       // bf16 path: the block's mbarriers
constexpr int PRODUCER_REGS = 24;   // bf16 path: registers of a producer thread (setmaxnreg)
constexpr int CONSUMER_REGS = 240;  // bf16 path: registers of a consumer thread
constexpr float LOG2E = 1.4426950408889634f;

// fp32 path: rows of a tile at head_dim D (32 at 256, where 64 do not fit)
template <int D>
__host__ __device__ constexpr int fp32_tile() {
  return D > 128 ? 32 : BT;
}

// bf16 dK/dV kernel: consumers that share one KV tile, each summing its share
// of the columns (two above WIDE_DIM, where one warpgroup cannot hold the
// 64 x D fp32 sums of both dK and dV), and so the KV tiles of a block
template <int D>
__host__ __device__ constexpr int dkdv_col_split() {
  return D > WIDE_DIM ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int dkdv_kv_tiles() {
  return CONSUMERS / dkdv_col_split<D>();
}

// bf16 dQ kernel: consumers of a block (one above WIDE_DIM, where two
// consumers' Q and dO and the ring would pass a block's shared memory)
template <int D>
__host__ __device__ constexpr int dq_consumers() {
  return D > WIDE_DIM ? 1 : CONSUMERS;
}

// bf16 path: the ring's slots at head_dim D (two above WIDE_DIM, where three
// 64-row tiles of Q and dO, or of K and V, would pass a block's shared memory)
template <int D>
__host__ __device__ constexpr int ring_stages() {
  return D > WIDE_DIM ? 2 : STAGES;
}

// bf16 dynamic shared memory: the dK/dV kernel's K and V tiles, the ring of
// Q and dO tiles with their lse and delta values, the mbarriers and the slack
// that puts the first tile on the swizzle's 1024-byte period
template <int D>
__host__ __device__ constexpr long long dkdv_smem_bytes() {
  return (long long)(2 * dkdv_kv_tiles<D>() + 2 * ring_stages<D>()) * tile_bytes<D>() +
         2 * ring_stages<D>() * STATS_BYTES + BAR_BYTES + SMEM_ALIGN;
}

// the dQ kernel's: each consumer's Q and dO tiles, the ring of K and V tiles
template <int D>
__host__ __device__ constexpr long long dq_smem_bytes() {
  return (long long)(2 * dq_consumers<D>() + 2 * ring_stages<D>()) * tile_bytes<D>() +
         BAR_BYTES + SMEM_ALIGN;
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
// bf16 path: TMA, mbarriers and wgmma (hopper.cuh).  Accumulators are
// m64n64 fragments: a thread of warp w of its warpgroup holds rows
// 16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0, 1} (element
// 4 j + 2 i + e: row + 8 i, column + e).

// P of a raw score s (a row of Q times a row of K) of a visible pair:
// exp(s * scale - lse) in log2 units (sl2 = scale * LOG2E, lse2 = lse *
// LOG2E), or (EXT, softcap > 0) with the score capped as the bf16 forward
// caps it; `dcap` the cap's derivative (1 without a cap).
template <bool EXT>
__device__ __forceinline__ float prob(float s, float sl2, float lse2, float scale, float softcap,
                                      float& dcap) {
  if (EXT && softcap > 0.f) {
    const float t = tanhf(s * (scale / softcap));
    dcap = 1.f - t * t;
    return fast_exp2(t * (softcap * LOG2E) - lse2);
  }
  dcap = 1.f;
  return fast_exp2(s * sl2 - lse2);
}

// Two fp32 accumulators as the bf16 A fragments of four 16-deep steps
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j >> 1][2 * (j & 1)] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j >> 1][2 * (j & 1) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// The dK/dV kernel.  grid = KV blocks x B x G, heaviest first: block x takes
// KV block x / (B G) (its dkdv_kv_tiles<D>() 64-row tiles; block 0 walks
// every Q tile), batch x / G % B and KV head x % G.  Q, dO (B, S, H, D), K, V
// (B, S, G, D) through tensor maps of 64-row boxes of one head; lse and delta
// (B, H, S) through 1-d maps; dk, dv (B, S, G, D) contiguous.  Consumer c
// takes KV tile c / split of the block, whose rows are the rows of its
// products, and output boxes [(c % split) NO, + NO).  POS (EXT only): mask by
// pos (B, S), the positions of the queries and of the keys.
template <int D, bool EXT>
__device__ __forceinline__ void dkdv_wgmma_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_do, const CUtensorMap& tm_lse, const CUtensorMap& tm_delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S, int H, int G, float scale,
    int window, float softcap, const int* __restrict__ pos) {
  constexpr int NCB = col_blocks<D>();
  constexpr int TB = tile_bytes<D>();
  constexpr int KS = D / 16;  // 16-deep steps of K Q^T
  constexpr int SPLIT = dkdv_col_split<D>();
  constexpr int KVT = dkdv_kv_tiles<D>();
  constexpr int NO = NCB / SPLIT;       // output boxes of a consumer
  constexpr int NS = ring_stages<D>();  // slots of the ring
  static_assert(D % 16 == 0 && NCB % SPLIT == 0, "head size");

  extern __shared__ unsigned char smem_bwd[];
  const uint32_t base = smem_addr(smem_bwd);
  const uint32_t kvbuf = (base + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  const uint32_t ring = kvbuf + KVT * 2 * TB;  // NS x (Q tile, dO tile)
  const uint32_t stats = ring + NS * 2 * TB;   // NS x (lse values, delta values)
  const uint32_t bars = stats + NS * 2 * STATS_BYTES;
  // K and V landed; per stage: Q, dO, lse and delta landed, and the slot free
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 + 16 * st; };
  auto empty = [&](int st) { return bars + 16 + 16 * st; };

  const int bg = blockIdx.x % (B * G);
  const int kb = blockIdx.x / (B * G);
  const int b = bg / G;
  const int g = bg % G;
  const int group = H / G;
  const int n_tiles = (S + BT - 1) / BT;
  const int kt0 = kb * KVT;                     // the block's first KV tile
  const int kv_live = min(KVT, n_tiles - kt0);  // its KV tiles below S
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool by_pos = EXT && POS_TABLE;  // every Q tile not hidden, no skip by index
  const int* pb = by_pos ? pos + (long long)b * S : nullptr;
  // each head's walk: the Q tiles from the block's first KV tile's own to
  // the last that its last KV tile's window reaches (by_pos: every Q tile
  // not hidden from the block's KV rows)
  const int w_lo = by_pos ? 0 : kt0;
  const int w_hi =
      by_pos ? n_tiles : q_tile_end<EXT, BT>((kt0 + kv_live - 1) * BT, n_tiles, window);
  int k_mn = 0, k_mx = 0;
  if (by_pos) dco_positions::tile_min_max(pb, kt0 * BT, min(KVT * BT, S - kt0 * BT), k_mn, k_mx);
  // the walk's next Q tile at or after qt (uniform over the block)
  auto next_q = [&](int qt) {
    if (by_pos) {
      while (qt < w_hi && pair_hidden<BT>(pb, qt * BT, S, k_mn, k_mx, window)) ++qt;
      qt = warp_uniform(qt);
    }
    return qt;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: one warp, whose first lane issues every copy
    reg_dealloc<PRODUCER_REGS>();
    if (warp != 0) return;
    auto load_tile = [&](uint32_t dst, const CUtensorMap& map, uint32_t bar, int head, int t) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load(dst + cb * BOX_BYTES, map, bar, cb * BOX_COLS, head, t * BT, b);
    };
    if (lane == 0) {
      mbar_expect_tx(kv_full, kv_live * 2 * TB);
      for (int i = 0; i < kv_live; ++i) {
        load_tile(kvbuf + i * 2 * TB, tm_k, kv_full, g, kt0 + i);
        load_tile(kvbuf + i * 2 * TB + TB, tm_v, kv_full, g, kt0 + i);
      }
    }
    int n = 0;  // items issued
    for (int hh = 0; hh < group; ++hh) {
      const int h = g * group + hh;
      const int row0 = (b * H + h) * S;  // the head's first lse and delta value
      for (int qt = next_q(w_lo); qt < w_hi; qt = next_q(qt + 1), ++n) {
        const int st = n % NS;
        const int lap = n / NS;
        if (lap > 0) mbar_wait(empty(st), (lap - 1) & 1);
        if (lane == 0) {
          const uint32_t dst = ring + st * 2 * TB;
          const uint32_t row_stats = stats + st * 2 * STATS_BYTES;
          // the tile's values from the 16-byte boundary at or below them (a
          // box that starts off one faults)
          const int at = (row0 + qt * BT) & ~3;
          mbar_expect_tx(full(st), 2 * TB + 2 * 4 * STATS_BOX);
          load_tile(dst, tm_q, full(st), h, qt);
          load_tile(dst + TB, tm_do, full(st), h, qt);
          tma_load_1d(row_stats, tm_lse, full(st), at);
          tma_load_1d(row_stats + STATS_BYTES, tm_delta, full(st), at);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: the 64 KV rows of one tile and its share of the
  // output columns
  reg_alloc<CONSUMER_REGS>();
  const int c = warp_uniform(warp / 4 - 1);
  const int kt = kt0 + c / SPLIT;  // this consumer's KV tile
  const int k_lo = kt * BT;
  const int ob0 = c % SPLIT * NO;  // its first output box
  const uint32_t kbuf = kvbuf + c / SPLIT * 2 * TB;
  const uint64_t kdesc0 = smem_desc(kbuf), vdesc0 = smem_desc(kbuf + TB);
  unsigned char* const stats_p = smem_bwd + (stats - base);
  // the Q tiles of each head's walk this consumer computes: from its own
  // (the first at or below the diagonal) to the last its window reaches
  // (by_pos: the whole walk); none where its KV rows lie past S.  It takes
  // and frees every other one.
  const int c_lo = by_pos ? w_lo : kt;
  const int c_hi = kt >= n_tiles ? c_lo : by_pos ? w_hi : q_tile_end<EXT, BT>(k_lo, n_tiles, window);
  // this thread's two KV rows and (by_pos) their positions
  int kr[2], kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kr[i] = k_lo + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    kp[i] = by_pos ? pb[min(kr[i], S - 1)] : 0;
  }
  const float sl2 = scale * LOG2E;

  int n = 0;  // items taken
  auto pass = [&]() {
    const int st = n % NS, lap = n / NS;
    mbar_wait(full(st), lap & 1);
    mbar_arrive(empty(st), lane == 0);
    ++n;
  };
  // the descriptors of the item in slot st, kept whole (each step's is its
  // tile's plus a constant; hoisted for every step they spilled)
  uint64_t qdesc = 0, odesc = 0, kdesc = 0, vdesc = 0;
  auto prep = [&](int st) {
    const uint32_t qs = ring + st * 2 * TB;
    qdesc = smem_desc(qs);
    odesc = smem_desc(qs + TB);
    kdesc = kdesc0;
    vdesc = vdesc0;
    asm volatile("" : "+l"(qdesc), "+l"(odesc), "+l"(kdesc), "+l"(vdesc)::"memory");
  };
  // d = A B^T over the head dimension for A, B the K-major tiles of
  // descriptors a, b (S^T = K Q^T, dP^T = V dO^T), issued as one group
  auto issue_scores = [&](float(&d)[32], uint64_t a, uint64_t b) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = ((ks >> 2) * BOX_BYTES + (ks & 3) * 32) >> 4;
      wgmma_ss(d, a + off, b + off, ks);
    }
    wgmma_commit();
  };
  // acc[ob] += A B for the bf16 A fragments a and the MN-major B tile of
  // descriptor bd (dO or Q: its rows the reduction), this consumer's boxes,
  // issued as one group
  auto issue_grad = [&](float(&acc)[NO][32], const uint32_t(&a)[4][4], uint64_t bd) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int ob = 0; ob < NO; ++ob)
        wgmma_rs(acc[ob], a[kk], bd + (((ob0 + ob) * BOX_BYTES + kk * 16 * 128) >> 4));
    wgmma_commit();
  };
  // the lse (or delta) values of the item in slot st, Q tile at q_lo of the
  // head at row0: (row0 + q_lo) % 4 into their box
  auto stat_values = [&](int st, int which, int row0, int q_lo) {
    return reinterpret_cast<const float*>(stats_p + (st * 2 + which) * STATS_BYTES) +
           ((row0 + q_lo) & 3);
  };
  // P^T of the scores in s (columns: the tile's Q rows at q_lo) into pf; s
  // keeps P^T times the cap's derivative, for dS^T
  float s[32], dp[32];
  uint32_t pf[4][4], df[4][4];  // P^T and dS^T as bf16 A fragments
  auto probs = [&](const float* lse_s, int q_lo) {
    // a pair of the tile that the mask, the window or S may hide
    const bool need_mask = by_pos || q_lo + BT > S || q_lo < k_lo + BT - 1 ||
                           (EXT && window > 0 && k_lo <= q_lo + BT - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + 2 * (lane & 3);
      const float l2[2] = {lse_s[cl], lse_s[cl + 1]};
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q_lo + cl + (e & 1);
        const int kv = kr[e >> 1];
        float dcap;
        p[e] = prob<EXT>(s[4 * j + e], sl2, l2[e & 1] * LOG2E, scale, softcap, dcap);
        bool hidden = false;
        if (need_mask) {
          if (by_pos) {
            const int pq = pb[min(q, S - 1)];
            hidden = q >= S || kv >= S || kp[e >> 1] > pq ||
                     (window > 0 && kp[e >> 1] <= pq - window);
          } else {
            hidden = q >= S || q < kv || (EXT && window > 0 && kv <= q - window);
          }
        }
        s[4 * j + e] = hidden ? 0.f : EXT ? p[e] * dcap : p[e];
        p[e] = hidden ? 0.f : p[e];
      }
      pf[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
      pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
    }
  };
  // dS^T = P^T (dP^T - delta) into df, P^T (times the cap's derivative) in
  // s, dP^T in dp
  auto dscores = [&](const float* delta_s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + 2 * (lane & 3);
      const float d2[2] = {delta_s[cl], delta_s[cl + 1]};
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = s[4 * j + e] * (dp[4 * j + e] - d2[e & 1]);
      df[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
      df[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }
  };
  // this thread's sums to rows kr, this consumer's columns, of a tensor
  // (B, S, G, D), times mul
  auto store = [&](bf16* out, const float(&acc)[NO][32], float mul) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kt < n_tiles && kr[i] < S) {
        bf16* row = out + ((long long)(b * S + kr[i]) * G + g) * D + 2 * (lane & 3);
#pragma unroll
        for (int ob = 0; ob < NO; ++ob)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = (ob0 + ob) * BOX_COLS + 8 * j;
            if (col < D)
              *reinterpret_cast<uint32_t*>(row + col) =
                  pack_bf16(acc[ob][4 * j + 2 * i] * mul, acc[ob][4 * j + 2 * i + 1] * mul);
          }
      }
    }
  };

  float acck[NO][32], accv[NO][32];
#pragma unroll
  for (int ob = 0; ob < NO; ++ob)
#pragma unroll
    for (int e = 0; e < 32; ++e) acck[ob][e] = accv[ob][e] = 0.f;
  mbar_wait(kv_full, 0);  // this block's K and V
  for (int hh = 0; hh < group; ++hh) {
    const int row0 = (b * H + g * group + hh) * S;  // the head's first lse and delta value
    int qt = next_q(w_lo);
    for (; qt < c_lo; qt = next_q(qt + 1)) pass();
    for (; qt < c_hi; qt = next_q(qt + 1)) {
      const int st = n % NS, lap = n / NS;
      prep(st);
      mbar_wait(full(st), lap & 1);
      // S^T = K Q^T, then dP^T = V dO^T, each its own group
      wgmma_fence();
      issue_scores(s, kdesc, qdesc);
      issue_scores(dp, vdesc, odesc);
      wgmma_wait<1>();  // S^T; dP^T still runs
      hold(s);
      probs(stat_values(st, 0, row0, qt * BT), qt * BT);
      wgmma_wait<0>();  // dP^T
      hold(dp);
      hold(pf);
#pragma unroll
      for (int ob = 0; ob < NO; ++ob) hold(accv[ob]);
      wgmma_fence();
      issue_grad(accv, pf, odesc);  // dV += P^T dO, dO's rows the reduction
      // dS^T into df while the tensor cores add dV
      dscores(stat_values(st, 1, row0, qt * BT));
      hold(df);
#pragma unroll
      for (int ob = 0; ob < NO; ++ob) hold(acck[ob]);
      wgmma_fence();
      issue_grad(acck, df, qdesc);  // dK += dS^T Q
      wgmma_wait<0>();
#pragma unroll
      for (int ob = 0; ob < NO; ++ob) {
        hold(accv[ob]);
        hold(acck[ob]);
      }
      mbar_arrive(empty(st), lane == 0);
      ++n;
    }
    for (; qt < w_hi; qt = next_q(qt + 1)) pass();
  }
  store(dk, acck, scale);
  store(dv, accv, 1.f);
}

// The dQ kernel.  grid = Q tiles x B x G, heaviest first: block x takes Q
// tile n - 1 - x / (B G) (the last walks the most KV tiles), batch x / G % B
// and KV head x % G.  A consumer's 64 packed rows are rows_s = 64 / group
// query rows of every head of the group, packed row r being query row
// r / group of head r % group (the forward's packing; where the group does
// not divide 64 a consumer's last 64 % group rows are never loaded or
// written); a Q tile is the consumers' rows.  Q and dO through tensor maps of
// those packed boxes, K and V as the dK/dV kernel's; lse and delta (B, H, S)
// and dq (B, S, H, D) contiguous.  POS as dkdv_wgmma_body.
template <int D, bool EXT>
__device__ __forceinline__ void dq_wgmma_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_do, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int B, int S, int H, int G, float scale, int window, float softcap,
    const int* __restrict__ pos) {
  constexpr int NCB = col_blocks<D>();
  constexpr int TB = tile_bytes<D>();
  constexpr int KS = D / 16;  // 16-deep steps of Q K^T
  constexpr int NC = dq_consumers<D>();
  constexpr int NS = ring_stages<D>();  // slots of the ring
  static_assert(D % 16 == 0, "head size");

  extern __shared__ unsigned char smem_bwd[];
  const uint32_t qbuf =
      (smem_addr(smem_bwd) + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);  // NC x (Q, dO)
  const uint32_t ring = qbuf + NC * 2 * TB;  // NS x (K tile, V tile)
  const uint32_t bars = ring + NS * 2 * TB;
  // Q and dO landed; per stage: K and V landed, and the slot free
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 + 16 * st; };
  auto empty = [&](int st) { return bars + 16 + 16 * st; };

  const int group = H / G;
  const int rows_s = MMA_ROWS / group;  // query rows of a consumer's tile
  const int bq = NC * rows_s;           // query rows of a block's Q tile
  const int n_q = (S + bq - 1) / bq;
  const int bg = blockIdx.x % (B * G);
  const int qt = n_q - 1 - (int)(blockIdx.x / (B * G));
  const int b = bg / G;
  const int g = bg % G;
  const int q_lo = qt * bq;
  const int n_tiles = (S + BT - 1) / BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool by_pos = EXT && POS_TABLE;  // every KV tile not hidden, no skip by index
  const int* pb = by_pos ? pos + (long long)b * S : nullptr;
  // the walk: the KV tiles from the first the window of the tile's first
  // row reaches to the diagonal (by_pos: every KV tile not hidden from the
  // tile's rows)
  const int t_lo = by_pos ? 0 : kv_tile_begin<EXT, BT>(q_lo, window);
  const int t_hi = by_pos ? n_tiles : (min(S, q_lo + bq) + BT - 1) / BT;
  int q_mn = 0, q_mx = 0;
  if (by_pos) dco_positions::tile_min_max(pb, q_lo, min(bq, S - q_lo), q_mn, q_mx);
  // the walk's next KV tile at or after t (uniform over the block)
  auto next_kv = [&](int t) {
    if (by_pos) {
      for (; t < t_hi; ++t) {
        int k_mn, k_mx;
        dco_positions::tile_min_max(pb, t * BT, min(BT, S - t * BT), k_mn, k_mx);
        if (!dco_positions::tiles_hidden(q_mn, q_mx, k_mn, k_mx, window)) break;
      }
      t = warp_uniform(t);
    }
    return t;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NC * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: one warp, whose first lane issues every copy; with two
    // consumers its registers go to them (one consumer has 255 anyway)
    if constexpr (NC > 1) reg_dealloc<PRODUCER_REGS>();
    if (warp != 0) return;
    if (lane == 0) {
      // a box is 64 columns of group x rows_s packed rows: 64 % group rows short of 64
      mbar_expect_tx(q_full, NC * 2 * NCB * BOX_COLS * 2 * group * rows_s);
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          const uint32_t dst = qbuf + c * 2 * TB + cb * BOX_BYTES;
          tma_load(dst, tm_q, q_full, cb * BOX_COLS, g * group, q_lo + c * rows_s, b);
          tma_load(dst + TB, tm_do, q_full, cb * BOX_COLS, g * group, q_lo + c * rows_s, b);
        }
    }
    int n = 0;  // tiles issued
    for (int t = next_kv(t_lo); t < t_hi; t = next_kv(t + 1), ++n) {
      const int st = n % NS;
      const int lap = n / NS;
      if (lap > 0) mbar_wait(empty(st), (lap - 1) & 1);
      if (lane == 0) {
        const uint32_t dst = ring + st * 2 * TB;
        mbar_expect_tx(full(st), 2 * TB);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load(dst + cb * BOX_BYTES, tm_k, full(st), cb * BOX_COLS, g, t * BT, b);
          tma_load(dst + TB + cb * BOX_BYTES, tm_v, full(st), cb * BOX_COLS, g, t * BT, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 packed rows of the Q tile
  if constexpr (NC > 1) reg_alloc<CONSUMER_REGS>();
  const int c = warp_uniform(warp / 4 - 1);
  const uint32_t qs = qbuf + c * 2 * TB;
  const int s0 = q_lo + c * rows_s;         // this consumer's first query row
  const int s1 = min(S, s0 + rows_s) - 1;   // its last (below s0: none)
  // this thread's two packed rows, r and r + 8 of its warp's 16: their query
  // row and head, the row's lse (log2 units) and delta, and (by_pos) position
  int sr[2], hd[2], qp[2];
  bool live[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * (warp & 3) + (lane >> 2) + 8 * i;
    sr[i] = s0 + r / group;
    hd[i] = g * group + r % group;
    live[i] = r < rows_s * group && sr[i] < S;
    const long long at = ((long long)b * H + hd[i]) * S + min(sr[i], S - 1);
    lse2[i] = lse[at] * LOG2E;
    dl[i] = delta[at];
    qp[i] = by_pos ? pb[min(sr[i], S - 1)] : 0;
  }
  const float sl2 = scale * LOG2E;
  // this consumer's KV tiles: the walk's, less (by index) those above all
  // its rows or below all their windows, a contiguous range [c_lo, c_hi)
  // (by_pos: the whole walk).  It takes and frees every other one.
  const int c_lo = by_pos ? t_lo : max(t_lo, kv_tile_begin<EXT, BT>(s0, window));
  const int c_hi = s1 < s0 ? c_lo : by_pos ? t_hi : min(t_hi, s1 / BT + 1);

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[cb][e] = 0.f;
  mbar_wait(q_full, 0);  // this block's Q and dO
  int n = 0;  // tiles taken
  auto pass = [&]() {
    const int st = n % NS, lap = n / NS;
    mbar_wait(full(st), lap & 1);
    mbar_arrive(empty(st), lane == 0);
    ++n;
  };

  float s[32], dp[32];
  uint32_t df[4][4];  // dS of the tile whose dS K is pending, as bf16 A fragments
  // the descriptors of Q, dO and the K and V tiles the next products read,
  // set before wgmma_fence and kept whole: each step's descriptor is its
  // tile's plus a constant (hoisted for every step, they spilled at D 256)
  uint64_t qdesc = 0, odesc = 0, kdesc = 0, vdesc = 0;
  auto prep = [&](uint32_t kt) {
    qdesc = smem_desc(qs);
    odesc = smem_desc(qs + TB);
    kdesc = smem_desc(kt);
    vdesc = smem_desc(kt + TB);
    asm volatile("" : "+l"(qdesc), "+l"(odesc), "+l"(kdesc), "+l"(vdesc)::"memory");
  };
  // S = Q K^T and dP = dO V^T of prep's tile, issued as one group
  auto issue_sdp = [&]() {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = ((ks >> 2) * BOX_BYTES + (ks & 3) * 32) >> 4;
      wgmma_ss(s, qdesc + off, kdesc + off, ks);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = ((ks >> 2) * BOX_BYTES + (ks & 3) * 32) >> 4;
      wgmma_ss(dp, odesc + off, vdesc + off, ks);
    }
    wgmma_commit();
  };
  // dQ += dS K for dS in df and the K tile of descriptor kd (its rows the
  // reduction: MN-major), issued
  auto issue_dq = [&](uint64_t kd) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        wgmma_rs(acc[cb], df[kk], kd + ((cb * BOX_BYTES + kk * 16 * 128) >> 4));
    wgmma_commit();
  };
  // dS = P (dP - delta) (times the cap's derivative) of the tile at k_lo,
  // in place in s (fp32), from its scores s and dp
  auto grads = [&](int k_lo) {
    const bool need_mask = by_pos || k_lo + BT - 1 > s0 ||
                           (EXT && window > 0 && k_lo <= s1 - window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const int col = k_lo + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      float dcap;
      const float p = prob<EXT>(s[e], sl2, lse2[i], scale, softcap, dcap);
      bool hidden = false;
      if (need_mask) {
        if (by_pos) {
          const int kpos = pb[min(col, S - 1)];
          hidden = col >= S || kpos > qp[i] || (window > 0 && kpos <= qp[i] - window);
        } else {
          hidden = col > sr[i] || (EXT && window > 0 && col <= sr[i] - window);
        }
      }
      const float ds = p * (dp[e] - dl[i]);
      s[e] = hidden ? 0.f : EXT ? ds * dcap : ds;
    }
  };

  int t = next_kv(t_lo);
  for (; t < c_lo; t = next_kv(t + 1)) pass();
  if (t < c_hi) {
    // the first tile: its S and dP, then its dS, whose dS K the next step issues
    int st = n % NS, lap = n / NS;
    uint32_t kt = ring + st * 2 * TB;
    mbar_wait(full(st), lap & 1);
    prep(kt);
    wgmma_fence();
    issue_sdp();
    wgmma_wait<0>();
    hold(s);
    hold(dp);
    grads(t * BT);
    pack_a(df, s);
    int t_next = next_kv(t + 1);
    // The next tile's S and dP are issued with this tile's dS K, and the next
    // dS is computed while the tensor cores add it; dS is packed into df only
    // after the wait for the pending dS K.
    while (t_next < c_hi) {
      const int st_next = (n + 1) % NS, lap_next = (n + 1) / NS;
      const uint32_t kt_next = ring + st_next * 2 * TB;
      mbar_wait(full(st_next), lap_next & 1);
      uint64_t kd = smem_desc(kt);
      asm volatile("" : "+l"(kd)::"memory");
      prep(kt_next);
      hold(df);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
      wgmma_fence();
      issue_sdp();
      issue_dq(kd);
      const int t_after = next_kv(t_next + 1);
      wgmma_wait<1>();  // S and dP of the next tile
      hold(s);
      hold(dp);
      grads(t_next * BT);
      wgmma_wait<0>();  // dS K of this tile
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
      hold(s);
      mbar_arrive(empty(st), lane == 0);
      ++n;
      pack_a(df, s);
      t = t_next;
      t_next = t_after;
      st = st_next;
      kt = kt_next;
    }
    // the last tile's dS K
    uint64_t kd = smem_desc(kt);
    asm volatile("" : "+l"(kd)::"memory");
    hold(df);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
    wgmma_fence();
    issue_dq(kd);
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
    mbar_arrive(empty(st), lane == 0);
    ++n;
    t = next_kv(t + 1);
  }
  for (; t < t_hi; t = next_kv(t + 1)) pass();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (live[i]) {
      bf16* row = dq + ((long long)(b * S + sr[i]) * H + hd[i]) * D + 2 * (lane & 3);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (cb * BOX_COLS + 8 * j < D)
            *reinterpret_cast<uint32_t*>(row + cb * BOX_COLS + 8 * j) =
                pack_bf16(acc[cb][4 * j + 2 * i] * scale, acc[cb][4 * j + 2 * i + 1] * scale);
    }
  }
}

#ifndef DCO_FLASH_POS
template <int D>
__global__ void __launch_bounds__((1 + CONSUMERS) * 128, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_lse,
                  const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int B, int S, int H, int G, float scale) {
  dkdv_wgmma_body<D, false>(tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, dk, dv, B, S, H, G, scale,
                            0, 0.f, nullptr);
}

template <int D>
__global__ void __launch_bounds__((1 + CONSUMERS) * 128, 1)
dkdv_wgmma_ext_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse,
                      const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int B, int S, int H, int G, float scale, int window,
                      float softcap) {
  dkdv_wgmma_body<D, true>(tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, dk, dv, B, S, H, G, scale,
                           window, softcap, nullptr);
}

template <int D>
__global__ void __launch_bounds__((1 + dq_consumers<D>()) * 128, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int B, int S, int H, int G, float scale) {
  dq_wgmma_body<D, false>(tm_q, tm_k, tm_v, tm_do, lse, delta, dq, B, S, H, G, scale, 0, 0.f,
                          nullptr);
}

template <int D>
__global__ void __launch_bounds__((1 + dq_consumers<D>()) * 128, 1)
dq_wgmma_ext_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int B, int S, int H,
                    int G, float scale, int window, float softcap) {
  dq_wgmma_body<D, true>(tm_q, tm_k, tm_v, tm_do, lse, delta, dq, B, S, H, G, scale, window,
                         softcap, nullptr);
}
#else
// The position variant's bf16 kernels: the _ext_ bodies with the table.
template <int D>
__global__ void __launch_bounds__((1 + CONSUMERS) * 128, 1)
dkdv_wgmma_pos_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse,
                      const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int B, int S, int H, int G, float scale, int window,
                      float softcap, const int* __restrict__ pos) {
  dkdv_wgmma_body<D, true>(tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, dk, dv, B, S, H, G, scale,
                           window, softcap, pos);
}

template <int D>
__global__ void __launch_bounds__((1 + dq_consumers<D>()) * 128, 1)
dq_wgmma_pos_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int B, int S, int H,
                    int G, float scale, int window, float softcap, const int* __restrict__ pos) {
  dq_wgmma_body<D, true>(tm_q, tm_k, tm_v, tm_do, lse, delta, dq, B, S, H, G, scale, window,
                         softcap, pos);
}
#endif

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
// softcap is given (the position variant: its _pos_ kernels, with `pos`).
template <int D>
int launch_bwd_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                     const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                     bf16* dv, const int* pos, int B, int S, int H, int G, float scale, int window,
                     float softcap, cudaStream_t stream) {
  static_assert(dkdv_smem_bytes<D>() <= SMEM_LIMIT && dq_smem_bytes<D>() <= SMEM_LIMIT,
                "a block's shared memory");
  static_assert(8 * (1 + 2 * STAGES) <= BAR_BYTES, "the barriers");
  static_assert(STATS_BOX >= BT + 3 && 4 * STATS_BOX % 16 == 0 && 4 * STATS_BOX <= STATS_BYTES,
                "a Q tile's lse values from a 16-byte boundary");
  const int group = H / G;
  if (group > MMA_ROWS) return -1;  // a dQ consumer's rows hold one query row of every head
  // lse and delta are read at int coordinates through 1-d maps (TMA: 16-byte pointers)
  if ((long long)B * H * S > INT_MAX - STATS_BOX) return -1;
  if (((uintptr_t)lse | (uintptr_t)delta) % 16 != 0) return -1;
  const int rows_s = MMA_ROWS / group;
  const long long qrow = (long long)H * D, qbatch = (long long)S * H * D;
  const long long krow = (long long)G * D, kbatch = (long long)S * G * D;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_lse, tm_delta, tm_qp, tm_dop;
  if (!tensor_map(&tm_q, q, D, H, S, B, D, qrow, qbatch, 1, BT) ||
      !tensor_map(&tm_do, dout, D, H, S, B, D, qrow, qbatch, 1, BT) ||
      !tensor_map(&tm_k, k, D, G, S, B, D, krow, kbatch, 1, BT) ||
      !tensor_map(&tm_v, v, D, G, S, B, D, krow, kbatch, 1, BT) ||
      !tensor_map_1d(&tm_lse, lse, (long long)B * H * S, STATS_BOX) ||
      !tensor_map_1d(&tm_delta, delta, (long long)B * H * S, STATS_BOX) ||
      !tensor_map(&tm_qp, q, D, H, S, B, D, qrow, qbatch, group, rows_s) ||
      !tensor_map(&tm_dop, dout, D, H, S, B, D, qrow, qbatch, group, rows_s))
    return -1;
#ifdef DCO_FLASH_POS
  const void* dkdv_k = (const void*)dkdv_wgmma_pos_kernel<D>;
  const void* dq_k = (const void*)dq_wgmma_pos_kernel<D>;
#else
  const bool ext = window > 0 || softcap > 0.f;
  const void* dkdv_k =
      ext ? (const void*)dkdv_wgmma_ext_kernel<D> : (const void*)dkdv_wgmma_kernel<D>;
  const void* dq_k = ext ? (const void*)dq_wgmma_ext_kernel<D> : (const void*)dq_wgmma_kernel<D>;
#endif
  const int smem_kv = (int)dkdv_smem_bytes<D>(), smem_q = (int)dq_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(dkdv_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_delta<bf16, D>(o, dout, delta, B, S, H, stream);
  if (rc != 0) return rc;
  const int n_tiles = (S + BT - 1) / BT;
  const long long blocks_kv = (long long)(n_tiles + dkdv_kv_tiles<D>() - 1) /
                              dkdv_kv_tiles<D>() * B * G;
  const int bq = dq_consumers<D>() * rows_s;
  const long long blocks_q = (long long)(S + bq - 1) / bq * B * G;
  if (blocks_kv > INT_MAX || blocks_q > INT_MAX) return -1;
  const int threads_kv = (1 + CONSUMERS) * 128, threads_q = (1 + dq_consumers<D>()) * 128;
#ifdef DCO_FLASH_POS
  dkdv_wgmma_pos_kernel<D><<<(unsigned)blocks_kv, threads_kv, smem_kv, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, dk, dv, B, S, H, G, scale, window, softcap, pos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_wgmma_pos_kernel<D><<<(unsigned)blocks_q, threads_q, smem_q, stream>>>(
      tm_qp, tm_k, tm_v, tm_dop, lse, delta, dq, B, S, H, G, scale, window, softcap, pos);
  return (int)cudaGetLastError();
#else
  if (ext)
    dkdv_wgmma_ext_kernel<D><<<(unsigned)blocks_kv, threads_kv, smem_kv, stream>>>(
        tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, dk, dv, B, S, H, G, scale, window, softcap);
  else
    dkdv_wgmma_kernel<D><<<(unsigned)blocks_kv, threads_kv, smem_kv, stream>>>(
        tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, dk, dv, B, S, H, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ext)
    dq_wgmma_ext_kernel<D><<<(unsigned)blocks_q, threads_q, smem_q, stream>>>(
        tm_qp, tm_k, tm_v, tm_dop, lse, delta, dq, B, S, H, G, scale, window, softcap);
  else
    dq_wgmma_kernel<D><<<(unsigned)blocks_q, threads_q, smem_q, stream>>>(
        tm_qp, tm_k, tm_v, tm_dop, lse, delta, dq, B, S, H, G, scale);
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
    return launch_bwd_wgmma<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
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
  if (B > 65535 || H > 65535) return -1;
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
