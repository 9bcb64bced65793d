// FlashAttention-2 forward for Hopper (sm_90a) with the DCO pinned/streamed KV
// split.
//
// Replaces the Pallas-TPU kernel `flash_kernel` with its helper `_attend`
// (src/repro/kernels/flash_attention/kernel.py, built by build_flash_call,
// wrapped by ops.py::flash_attention).
//
// Bound on an H100: operations for prompts beyond a few hundred tokens
// (4 * Sq * Sk * D * H * B, halved under the causal mask, against Q, K, V and O
// moved once), bytes below that.
//
// Common to both paths:
//  * The pinned KV prefix has an explicit home.  On the TPU a constant block
//    index lets the compiler skip the re-copy; a GPU has no such thing, so one
//    block per (batch, KV head, chunk of Q tiles) stages `pinned_rows` rows of K
//    and V in dynamic shared memory once and reuses them for every Q tile of its
//    chunk and every query head of the GQA group.  The rest of K/V is streamed
//    tile by tile and never claims resident memory.
//  * Q, K, V and O are read and written in (B, S, heads, D) layout through
//    strides: no transposed copies, no dummy operands.
//  * The per-row log-sum-exp, on request (`lse`, for the backward in
//    csrc/flash_attention_bwd.cu): natural log, of the scaled, capped and
//    masked scores, from the running max and sum the online softmax keeps
//    anyway (the bf16 path's are in log2 units and are converted once a row
//    at the end).  It changes neither O nor, on the bf16 path, the serving
//    kernel: training's is a second kernel over the same body.
//  * Any Sq and Sk: ragged Q and KV tails are masked here.  Causal masking is by
//    absolute position (Sq == Sk); tiles wholly above the diagonal are skipped.
//  * A sliding window of W rows (gemma2-27b's local layers; causal only): row r
//    sees columns (r - W, r].  A KV row older than the window of a Q tile's
//    first row is dead for the whole tile, so a Q tile walks KV tiles from
//    (q_lo - W + 1) / BK on, the pinned prefix is staged only from the first
//    tile some Q tile of the block walks, and in-tile masking adds
//    col <= row - W beside the causal test.  The tile order of a Q tile does
//    not depend on where a tile lives, so the bf16 result stays bit-identical
//    across `pinned_rows` and `tiles_per_chunk` with a window too.
//
// The bf16 path (flash_mma_kernel), the one the serving path runs, is built
// from Hopper's own instructions (sm_90a): TMA copies, mbarriers and wgmma,
// in inline PTX.
//  * Warp specialisation.  A block is a producer warpgroup and CONSUMERS
//    consumer warpgroups (one above WIDE_DIM, below).  One warp of the
//    producer issues every load as a TMA copy (cp.async.bulk.tensor) from
//    one elected lane, and with two consumers its registers are cut to
//    PRODUCER_REGS (setmaxnreg) so that each consumer can hold
//    CONSUMER_REGS.  The tensor maps cover Q, K and V in their
//    (B, S, heads, D) layout through the strides the caller passes: no
//    transposed copies.  K and V stream through a ring of STAGES tiles with
//    a full and an empty mbarrier for K and for V of each stage, so that K of
//    a tile can load as soon as the last one's scores are taken; no block
//    barrier remains once the roles split.  TMA fills a box's elements past
//    the tensor's ends with zeros: KV rows past Sk are zeros, and at D 112 a
//    row's second 64-column box holds zeros past column 112.
//  * Tensor cores.  S = Q K^T is wgmma m64n64k16 with Q and K from shared
//    memory, K-major in the 128-byte swizzle TMA writes (a 64-row tile is
//    ceil(D / 64) boxes of 64 rows x 128 bytes); the online softmax runs in
//    registers on the accumulator's fragments (a thread holds rows lane / 4
//    and + 8 of its warp's 16, column pairs 8j + 2 (lane % 4): mma.sync's C
//    layout, so the masks are those of the Ampere kernel); P, rounded to
//    bf16 in registers, is the register A operand of O += P V, one m64n64k16
//    product for each 64-column box of V (MN-major, transposed by the
//    instruction).  At D 112 the second box's 16 zero columns are computed
//    and never written.
//  * Overlap within a consumer (FlashAttention-3's): the next tile's
//    S = Q K^T and this tile's O += P V are issued together, and the next
//    tile's softmax runs while the tensor cores add this tile's P V.  ptxas
//    serialises every wgmma of a kernel (a wait after each) as soon as one
//    register a wgmma reads or writes is touched by another instruction
//    while a product is pending, or a wgmma sits in a branch it cannot prove
//    uniform over the warpgroup; that made the first pipelined version
//    slower than none.  So a consumer computes its own contiguous range of
//    the walk (a prologue, a steady loop, a drain: one static pipeline, no
//    per-tile branch around a wgmma), the consumer index and the position
//    walk are broadcast from lane 0, barrier arrivals are predicated, each
//    product's descriptor is its tile's plus a constant, the softmax reads S
//    and writes P in fp32 registers of its own, and P is packed into the A
//    fragments only after the wait for the pending P V.  `hold` pins operand
//    and accumulator registers on either side of each fence and wait.
//  * One K/V fetch serves the whole GQA group (FlashAttention-3's PackGQA).
//    A consumer's 64 rows are `rows_s` = 64 / group query rows of every head
//    of the group, packed row r being query row r / group of head r % group
//    (one TMA box of group heads x rows_s rows); a Q tile is the two
//    consumers' rows, 2 * rows_s query rows, and each K/V tile reaches shared
//    memory once per Q tile.  Where the group does not divide 64 a
//    consumer's last 64 % group rows are never loaded or written.
//  * The pinned prefix has a region of its own, in the layout of a ring
//    slot, loaded once a block by TMA for every Q tile of the chunk and every
//    head of the group, after the block's first Q tile and with an mbarrier
//    a tile, so that the first products wait for their own tile only; one
//    inner loop reads a pinned or a streamed tile and only the address (and
//    the barrier it waits on) differs.  The tile order
//    and the arithmetic never depend on where a tile lives, so the result is
//    bit-identical whatever `pinned_rows` and `tiles_per_chunk` are.
//  * Causal balance.  A consumer skips a tile whose keys lie above all its
//    rows or below all its rows' windows and masks the rest.  Q tiles are
//    dealt to the chunks in the order n-1, 0, n-2, 1, ...: a chunk of two
//    tiles pairs the heaviest left with the lightest, which keeps
//    `tiles_per_chunk`'s meaning (the Q tiles that share one load of the
//    prefix) without a model of the work.
//  * Shared memory: each consumer's Q (2 x 16 KB at D 128), the ring
//    (STAGES x 32 KB at D 128) and the pinned tiles.  At D 256 (gemma-7b) a
//    consumer's 64 x 256 fp32 output is 128 registers a thread and a 64-row
//    tile of K and V is 64 KB: two consumers' Q and the ring would take 192
//    KB and leave no tile to pin, so a block there has one consumer (255
//    registers, no setmaxnreg), whose Q and the ring leave one 64 KB tile.
//
// The fp32 path (flash_kernel) keeps fp32 FMA on shared-memory tiles (64 x 64
// scores, a 4 x 4 patch a thread): exact fp32 accumulation, no TF32, which its
// 2e-5 tolerance rules out.  Rows are staged with one pad word so that 16 lanes
// reading 16 consecutive rows hit 16 banks.
//
// Explicit positions (the position variant, DCO_FLASH_POS: this body compiled
// again by flash_attention_pos.cu into kernels of their own, flash_pos_kernel
// (fp32) and flash_mma_pos_kernel (bf16, with and without the LSE), so that
// the serving kernels keep their code and registers).  The JAX package masks by the
// positions it is given: query row i at position pos[b][i] sees key row j at
// position kpos where kpos <= qpos and, under a window, kpos > qpos - W; a
// hidden score is the finite -1e30, so that a row that sees no key gets the
// mean of all Sk value rows, as the reference's softmax gives it.  One table,
// `pos` (B, Sq), and two modes:
//  * forward (keys_at_rows 0; training and `forward`): key j sits at pos[b][j]
//    (Sq == Sk).  Positions need not follow the rows, so a Q tile walks every
//    KV tile, but every row sees itself, so a KV tile that the smallest and
//    largest positions of the two tiles prove hidden from all of the Q tile's
//    rows adds nothing and is skipped (positions.cuh; a pinned or streamed
//    tile alike, so the bf16 result stays bit-identical across `pinned_rows`);
//  * prefill (keys_at_rows 1; keys at their row index, as a cache's rows are):
//    a Q tile walks from the window's first tile under its smallest position
//    to min(Sk, its largest position + 1).  A Q tile that holds a row seeing
//    no key (a negative position, or one whose window lies past Sk) walks
//    every KV tile, so that row's uniform mean covers all of them.
// The tile walk, the in-tile masks and the pinned staging (the whole prefix)
// depend on the Q tile and the tables only, never on where a tile lives, so the
// bf16 result stays bit-identical across `pinned_rows` and `tiles_per_chunk`.
// The masks test every element (the index-based skips of 16-column blocks
// are off); columns past Sk stay -inf, which no row counts.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "positions.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // fp32 path: query rows of a tile
constexpr int BK = 64;        // KV rows of a tile, both paths
constexpr int THREADS = 256;  // fp32 path: 16 x 16, thread (ty, tx) owns rows ty*4.., cols tx+16*j
constexpr int LDP = BK + 1;
constexpr int SMEM_LIMIT = 232448;
constexpr int STAGES = 2;          // bf16 path: streamed K/V tiles in the ring
constexpr int CONSUMERS = 2;       // bf16 path: consumer warpgroups of a block
constexpr int WIDE_DIM = 128;      // bf16 path: above this head size, one consumer
constexpr int MMA_ROWS = 64;       // bf16 path: packed Q rows of a consumer (wgmma's M)
constexpr int BAR_BYTES = 256;     // bf16 path: the block's mbarriers (4 a stage, 2 for Q, 1 a pinned tile)
constexpr int PRODUCER_REGS = 40;  // bf16 path: registers of a producer thread (setmaxnreg)
constexpr int CONSUMER_REGS = 232; // bf16 path: registers of a consumer thread
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32 path

// One 32-bit word of T as floats.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int EPW = 1;
  static __device__ __forceinline__ void unpack(uint32_t w, float* o) {
    o[0] = __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t pack(const float* x) {
    return __float_as_uint(x[0]);
  }
};

// The first KV tile that row q_lo can see under a window of `window` rows (0:
// none); later rows see no earlier tile.
__device__ __forceinline__ int first_kv_tile(int q_lo, int window) {
  return window > 0 ? max(0, q_lo - window + 1) / BK : 0;
}

// The position variant's KV walk of a Q tile, [t_lo * BK, kv_end), for its
// rows [q_lo, q_lo + nq) at positions qp (this batch row's table) and keys at
// positions kp (null: at their row index), and the tile's smallest and
// largest position.  Every warp of the block calls it whole and gets the same
// answer (each reduces all nq <= 64 rows itself).
__device__ __forceinline__ void pos_walk(const int* __restrict__ qp, const int* __restrict__ kp,
                                         int q_lo, int nq, int Sk, int window, int& t_lo,
                                         int& kv_end, int& lo, int& hi) {
  dco_positions::tile_min_max(qp, q_lo, nq, lo, hi);
  t_lo = 0;
  kv_end = Sk;
  if (kp != nullptr) return;  // forward mode: every KV tile
  // a row that sees no key: a negative position, or a window past Sk
  if (lo < 0 || (window > 0 && hi - window + 1 >= Sk)) return;
  t_lo = window > 0 ? max(0, lo - window + 1) / BK : 0;
  kv_end = min(Sk, hi + 1);
}

// The KV tile at k_lo hidden from every row of a Q tile whose positions lie
// in [q_mn, q_mx], in forward mode (keys at positions kp, the queries' table:
// every row sees itself); in prefill mode (kp null) no tile is skipped: the
// walk is bounded instead.  Uniform over the block.
__device__ __forceinline__ bool pos_tile_hidden(const int* __restrict__ kp, int k_lo, int Sk,
                                                int q_mn, int q_mx, int window) {
  if (kp == nullptr) return false;
  int k_mn, k_mx;
  dco_positions::tile_min_max(kp, k_lo, min(BK, Sk - k_lo), k_mn, k_mx);
  return dco_positions::tiles_hidden(q_mn, q_mx, k_mn, k_mx, window);
}

// Key `col` (below Sk) hidden from a query at position qp: causal and window
// tests on the key's position (kp[col], or col where kp is null)
__device__ __forceinline__ bool pos_hidden(const int* __restrict__ kp, int col, int qp,
                                           int window) {
  const int kpos = kp != nullptr ? kp[col] : col;
  return kpos > qp || (window > 0 && kpos <= qp - window);
}

// Copy `nrows` rows of WPR words from device memory to padded shared rows.
template <int WPR, int LD>
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* src,
                                           long long row_stride, int nrows) {
  for (int idx = threadIdx.x; idx < nrows * WPR; idx += THREADS) {
    const int r = idx / WPR;
    const int w = idx % WPR;
    dst[r * LD + w] = src[(long long)r * row_stride + w];
  }
}

// grid = (Q-tile chunks, G, B).  Strides are in 32-bit words.  POS: mask by
// the position table pos (B, Sq), keys at the same positions or, with
// keys_at_rows, at their row index.
template <typename T, int D, bool POS>
__device__ __forceinline__ void flash_body(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ k,
    const uint32_t* __restrict__ v, uint32_t* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ pos, int keys_at_rows, int Sq, int Sk, int H,
    int G, int tiles_per_chunk, int pinned_rows, int causal, int window, float scale,
    float softcap, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sg, long long v_sb, long long v_ss, long long v_sg,
    long long o_sb, long long o_ss, long long o_sh) {
  constexpr int EPW = Word<T>::EPW;
  constexpr int WPR = D / EPW;  // words of one row
  constexpr int LD = WPR + 1;   // padded row stride in shared memory
  constexpr int NJ = WPR / 16;  // output words a thread owns in each row
  static_assert(WPR % 16 == 0, "16 lanes share a row's words evenly");

  extern __shared__ uint32_t smem[];
  uint32_t* pinK = smem;
  uint32_t* pinV = pinK + pinned_rows * LD;
  uint32_t* Qs = pinV + pinned_rows * LD;
  uint32_t* Ks = Qs + BQ * LD;
  uint32_t* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / G;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  const int qt0 = blockIdx.x * tiles_per_chunk;
  const int qt1 = min(n_q_tiles, qt0 + tiles_per_chunk);

  const uint32_t* kb = k + b * k_sb + g * k_sg;
  const uint32_t* vb = v + b * v_sb + g * v_sg;
  // POS: this batch row's positions of the queries and (forward mode) the keys
  const int* qpb = POS ? pos + (long long)b * Sq : nullptr;
  const int* kpb = POS && !keys_at_rows ? qpb : nullptr;

  // the pinned prefix: staged once, as far as this block's Q rows can see it,
  // from the first tile one of them sees (the block's Q tiles are in order);
  // POS: the whole prefix
  const int kv_need = POS || !causal ? Sk : min(Sk, qt1 * BQ);
  const int pin = min(pinned_rows, kv_need);
  const int pin_lo = POS ? 0 : min(pin, first_kv_tile(qt0 * BQ, window) * BK);
  stage_rows<WPR, LD>(pinK + pin_lo * LD, kb + (long long)pin_lo * k_ss, k_ss, pin - pin_lo);
  stage_rows<WPR, LD>(pinV + pin_lo * LD, vb + (long long)pin_lo * v_ss, v_ss, pin - pin_lo);

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q_lo = qt * BQ;
    int kv_end = causal ? min(Sk, q_lo + BQ) : Sk;
    int t_lo = first_kv_tile(q_lo, window);
    int q_mn = 0, q_mx = 0;  // POS: the tile's smallest and largest position
    if constexpr (POS)
      pos_walk(qpb, kpb, q_lo, min(BQ, Sq - q_lo), Sk, window, t_lo, kv_end, q_mn, q_mx);
    const int n_kv_tiles = (kv_end + BK - 1) / BK;
    for (int hh = 0; hh < group; ++hh) {
      const int h = g * group + hh;
      __syncthreads();  // Qs free (and the pinned prefix staged)
      const uint32_t* qb = q + b * q_sb + h * q_sh;
      for (int idx = tid; idx < BQ * WPR; idx += THREADS) {
        const int r = idx / WPR;
        const int w = idx % WPR;
        const int row = q_lo + r;
        Qs[r * LD + w] = row < Sq ? qb[(long long)row * q_ss + w] : 0u;
      }
      __syncthreads();

      float m[4], l[4], acc[4][NJ * EPW];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int e = 0; e < NJ * EPW; ++e) acc[i][e] = 0.f;
      }

      for (int t = t_lo; t < n_kv_tiles; ++t) {
        const int k_lo = t * BK;
        if constexpr (POS) {  // a tile no row sees: nothing to add (uniform over the block)
          if (pos_tile_hidden(kpb, k_lo, Sk, q_mn, q_mx, window)) continue;
        }
        const int ncols = min(BK, kv_end - k_lo);
        const uint32_t* Kt;
        const uint32_t* Vt;
        if (k_lo < pinned_rows) {  // resident: no traffic
          Kt = pinK + k_lo * LD;
          Vt = pinV + k_lo * LD;
        } else {                   // streamed: fetched again for this Q tile
          stage_rows<WPR, LD>(Ks, kb + (long long)k_lo * k_ss, k_ss, ncols);
          stage_rows<WPR, LD>(Vs, vb + (long long)k_lo * v_ss, v_ss, ncols);
          __syncthreads();
          Kt = Ks;
          Vt = Vs;
        }

        // S = Q K^T on a 4 x 4 patch
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int w = 0; w < WPR; ++w) {
          float qf[4][EPW], kf[4][EPW];
#pragma unroll
          for (int i = 0; i < 4; ++i) Word<T>::unpack(Qs[(ty * 4 + i) * LD + w], qf[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) Word<T>::unpack(Kt[(tx + 16 * j) * LD + w], kf[j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < EPW; ++e) s[i][j] += qf[i][e] * kf[j][e];
        }

        // scale, softcap, mask, online softmax; P goes to shared memory
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q_lo + ty * 4 + i;
          // POS: this row's position (a row past Sq is never written)
          const int qp = POS && row < Sq ? qpb[row] : 0;
          bool ok[4];
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = k_lo + tx + 16 * j;
            float x = s[i][j] * scale;
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
            if constexpr (POS) {
              // a hidden key scores -1e30 and still counts (a row that sees
              // none gets the uniform mean); a column past kv_end does not
              ok[j] = col < kv_end;
              s[i][j] = ok[j] && !pos_hidden(kpb, col, qp, window) ? x : NEG_INF;
            } else {
              ok[j] = col < kv_end && (!causal || col <= row) && (window == 0 || col > row - window);
              s[i][j] = ok[j] ? x : NEG_INF;
            }
            mx = fmaxf(mx, s[i][j]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
            rs += p;
            Ps[(ty * 4 + i) * LDP + tx + 16 * j] = p;
          }
          rs += __shfl_xor_sync(0xffffffffu, rs, 8);
          rs += __shfl_xor_sync(0xffffffffu, rs, 4);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          l[i] = l[i] * alpha + rs;
          m[i] = m_new;
#pragma unroll
          for (int e = 0; e < NJ * EPW; ++e) acc[i][e] *= alpha;
        }
        __syncthreads();

        // O += P V over the tile's valid rows only
        for (int c = 0; c < ncols; ++c) {
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDP + c];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            float vf[EPW];
            Word<T>::unpack(Vt[c * LD + tx + 16 * jj], vf);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < EPW; ++e) acc[i][jj * EPW + e] += p[i] * vf[e];
          }
        }
        __syncthreads();  // Ps and the streamed tiles are free again
      }

      uint32_t* ob = o + b * o_sb + h * o_sh;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q_lo + ty * 4 + i;
        if (row < Sq) {
          const float denom = fmaxf(l[i], 1e-30f);
          if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * Sq + row] = m[i] + logf(l[i]);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            float x[EPW];
#pragma unroll
            for (int e = 0; e < EPW; ++e) x[e] = acc[i][jj * EPW + e] / denom;
            ob[(long long)row * o_ss + tx + 16 * jj] = Word<T>::pack(x);
          }
        }
      }
    }
  }
}

#ifndef DCO_FLASH_POS
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ k,
             const uint32_t* __restrict__ v, uint32_t* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int H, int G, int tiles_per_chunk,
             int pinned_rows, int causal, int window,
             float scale, float softcap, long long q_sb, long long q_ss,
             long long q_sh, long long k_sb, long long k_ss, long long k_sg,
             long long v_sb, long long v_ss, long long v_sg, long long o_sb,
             long long o_ss, long long o_sh) {
  flash_body<T, D, false>(q, k, v, o, lse, nullptr, 0, Sq, Sk, H, G, tiles_per_chunk,
                          pinned_rows, causal, window, scale, softcap, q_sb, q_ss, q_sh, k_sb,
                          k_ss, k_sg, v_sb, v_ss, v_sg, o_sb, o_ss, o_sh);
}
#else
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_pos_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ k,
                 const uint32_t* __restrict__ v, uint32_t* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ pos,
                 int keys_at_rows, int Sq, int Sk, int H, int G,
                 int tiles_per_chunk, int pinned_rows, int causal, int window, float scale,
                 float softcap, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                 long long k_ss, long long k_sg, long long v_sb, long long v_ss, long long v_sg,
                 long long o_sb, long long o_ss, long long o_sh) {
  flash_body<T, D, true>(q, k, v, o, lse, pos, keys_at_rows, Sq, Sk, H, G, tiles_per_chunk,
                         pinned_rows, causal, window, scale, softcap, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sg, v_sb, v_ss, v_sg, o_sb, o_ss, o_sh);
}
#endif

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const int* pos,
           int keys_at_rows, int B, int Sq, int Sk, int H, int G, int tiles_per_chunk,
           int pinned_rows, int causal, int window, float scale, float softcap,
           const long long* st, cudaStream_t stream) {
  constexpr int EPW = Word<T>::EPW;
  constexpr int LD = D / EPW + 1;
  const long long smem =
      4ll * (2ll * pinned_rows * LD + 3ll * BQ * LD) + 4ll * BQ * LDP;
  if (smem > SMEM_LIMIT) return -2;
#ifndef DCO_FLASH_POS
  const void* kernel = (const void*)flash_kernel<T, D>;
#else
  const void* kernel = (const void*)flash_pos_kernel<T, D>;
#endif
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  const int n_chunks = (n_q_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  long long w[12];
  for (int i = 0; i < 12; ++i) {
    if (st[i] % EPW != 0) return -1;
    w[i] = st[i] / EPW;
  }
  const dim3 grid(n_chunks, G, B);
#ifndef DCO_FLASH_POS
  flash_kernel<T, D><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<uint32_t*>(o), lse, Sq, Sk, H, G,
      tiles_per_chunk, pinned_rows, causal, window, scale, softcap, w[0], w[1], w[2], w[3],
      w[4], w[5], w[6], w[7], w[8], w[9], w[10], w[11]);
#else
  flash_pos_kernel<T, D><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<uint32_t*>(o), lse, pos, keys_at_rows, Sq, Sk,
      H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, w[0], w[1], w[2],
      w[3], w[4], w[5], w[6], w[7], w[8], w[9], w[10], w[11]);
#endif
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path: TMA, mbarriers and wgmma (sm_90a)

using namespace dco_hopper;

// Consumer warpgroups of a block: CONSUMERS, or one above WIDE_DIM, where
// two consumers' Q and the ring would leave no 64 KB tile of K and V to pin.
template <int D>
__host__ __device__ constexpr int consumers() {
  return D > WIDE_DIM ? 1 : CONSUMERS;
}

// Dynamic shared memory of a block: each consumer's Q, the ring of K and V
// tiles, the pinned tiles, the mbarriers and the slack that puts the first
// tile on the swizzle's 1024-byte period.
template <int D>
__host__ __device__ constexpr long long mma_smem_bytes(int pin_tiles) {
  return (long long)(consumers<D>() + 2 * STAGES + 2 * pin_tiles) * tile_bytes<D>() +
         BAR_BYTES + SMEM_ALIGN;
}

// The Q tile at place p of the order n-1, 0, n-2, 1, ...
__device__ __forceinline__ int tile_at(int p, int n) {
  return (p & 1) ? p >> 1 : n - 1 - (p >> 1);
}

// The KV tiles a block's Q tile walks: [t_lo, n_kv), the first n_pinned of
// them resident, and (POS) the tile's smallest and largest position.  Every
// warp of the block computes it alike.
struct Walk {
  int t_lo, n_kv, n_pinned, q_mn, q_mx;
};

template <bool POS>
__device__ __forceinline__ Walk kv_walk(const int* __restrict__ qpb, const int* __restrict__ kpb,
                                        int q_lo, int bq, int Sq, int Sk, int causal, int window,
                                        int pinned_rows) {
  Walk w;
  int kv_end = causal ? min(Sk, q_lo + bq) : Sk;
  w.t_lo = first_kv_tile(q_lo, window);
  w.q_mn = w.q_mx = 0;
  if constexpr (POS) {
    pos_walk(qpb, kpb, q_lo, min(bq, Sq - q_lo), Sk, window, w.t_lo, kv_end, w.q_mn, w.q_mx);
    w.t_lo = warp_uniform(w.t_lo);
    kv_end = warp_uniform(kv_end);
  }
  w.n_kv = (kv_end + BK - 1) / BK;
  w.n_pinned = pinned_rows >= Sk ? w.n_kv : min(w.n_kv, pinned_rows / BK);
  return w;
}

// POS: the first tile at or after t that some row of the Q tile sees
// (forward mode; the next tile in prefill mode), so that a hidden tile is
// neither loaded nor computed.  Uniform over the block.
template <bool POS>
__device__ __forceinline__ int next_seen(const Walk& w, const int* __restrict__ kpb, int t, int Sk,
                                         int window) {
  if constexpr (POS) {
    while (t < w.n_kv && pos_tile_hidden(kpb, t * BK, Sk, w.q_mn, w.q_mx, window)) ++t;
    t = warp_uniform(t);
  }
  return t;
}

// grid = (Q-tile chunks, G, B); block = 1 + NC warpgroups (NC =
// consumers<D>()).  A consumer's 64 packed rows are `rows_s` query rows
// (64 / group) of every head of the group, row r = query row r / group of
// head r % group; a Q tile is NC of them, consecutive.  Q, K and V come
// through the tensor maps, O's strides are in elements.  LSE: also write each row's
// log-sum-exp to `lse`.  POS: mask by pos (B, Sq), keys at the same
// positions or, with keys_at_rows, at their row index.
template <int D, bool LSE, bool POS>
__device__ __forceinline__ void flash_mma_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    bf16* __restrict__ o, float* __restrict__ lse, const int* __restrict__ pos, int keys_at_rows,
    int Sq, int Sk, int H, int G, int tiles_per_chunk, int pinned_rows, int causal, int window,
    float scale, float softcap, long long o_sb, long long o_ss, long long o_sh) {
  constexpr int NCB = col_blocks<D>();
  constexpr int TB = tile_bytes<D>();
  constexpr int KS = D / 16;  // 16-deep steps of Q K^T
  constexpr int NC = consumers<D>();
  static_assert(D % 16 == 0 && D <= NCB * BOX_COLS, "head size");

  extern __shared__ unsigned char smem_mma[];
  const uint32_t qbuf = (smem_addr(smem_mma) + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  const int pin_tiles = (pinned_rows + BK - 1) / BK;
  const uint32_t ring = qbuf + NC * TB;               // STAGES x (K tile, V tile)
  const uint32_t pin = ring + STAGES * 2 * TB;        // pin_tiles x (K tile, V tile)
  const uint32_t bars = pin + pin_tiles * 2 * TB;
  // per stage: K landed, V landed, K free, V free; then Q landed, Q free, and
  // each pinned tile's K and V landed
  const uint32_t q_full = bars + 32 * STAGES, q_empty = q_full + 8;
  auto pin_full = [&](int t) { return q_empty + 8 + 8 * t; };
  auto k_full = [&](int st) { return bars + 32 * st; };
  auto v_full = [&](int st) { return bars + 32 * st + 8; };
  auto k_empty = [&](int st) { return bars + 32 * st + 16; };
  auto v_empty = [&](int st) { return bars + 32 * st + 24; };

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / G;
  const int rows_s = MMA_ROWS / group;  // query rows of a consumer's tile
  const int bq = NC * rows_s;           // query rows of a block's Q tile
  const int n_q_tiles = (Sq + bq - 1) / bq;
  const int p0 = blockIdx.x * tiles_per_chunk;
  const int p1 = min(n_q_tiles, p0 + tiles_per_chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // POS: this batch row's positions of the queries and (forward mode) the keys
  const int* qpb = POS ? pos + (long long)b * Sq : nullptr;
  const int* kpb = POS && !keys_at_rows ? qpb : nullptr;

  // the pinned prefix: loaded once, whole tiles, from the first tile to the
  // last that this block's Q rows can see; its rows hold what a streamed tile
  // would hold.  POS: the whole prefix
  int kv_need = POS ? Sk : 0, kv_first = POS ? 0 : Sk;
  for (int p = p0; p < (POS ? p0 : p1); ++p) {
    const int qt = tile_at(p, n_q_tiles);
    kv_need = max(kv_need, causal ? min(Sk, (qt + 1) * bq) : Sk);
    kv_first = min(kv_first, first_kv_tile(qt * bq, window) * BK);
  }
  const int n_pin = min(pin_tiles * BK, (min(pinned_rows, kv_need) + BK - 1) / BK * BK);
  const int pin_lo = min(n_pin, kv_first);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), NC * 4);  // one arrival a consumer warp
      mbar_init(v_empty(st), NC * 4);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC * 4);
    for (int t = 0; t < pin_tiles; ++t) mbar_init(pin_full(t), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: one warp, whose first lane issues every copy; with two
    // consumers its registers go to them (one consumer has 255 anyway)
    if constexpr (NC > 1) reg_dealloc<PRODUCER_REGS>();
    if (warp != 0) return;
    auto load_tile = [&](uint32_t dst, const CUtensorMap& map, uint32_t bar, int t) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load(dst + cb * BOX_BYTES, map, bar, cb * BOX_COLS, g, t * BK, b);
    };
    int n = 0;  // streamed tiles issued
    for (int p = p0; p < p1; ++p) {
      const int q_lo = tile_at(p, n_q_tiles) * bq;
      const Walk w = kv_walk<POS>(qpb, kpb, q_lo, bq, Sq, Sk, causal, window, pinned_rows);
      if (p > p0) mbar_wait(q_empty, (p - p0 - 1) & 1);
      if (lane == 0) {
        // a box is 64 columns of group x rows_s packed rows: 64 % group rows short of 64
        mbar_expect_tx(q_full, NC * NCB * BOX_COLS * 2 * group * rows_s);
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb)
            tma_load(qbuf + c * TB + cb * BOX_BYTES, tm_q, q_full, cb * BOX_COLS, g * group,
                     q_lo + c * rows_s, b);
        if (p == p0)  // the pinned prefix behind the first Q tile, a barrier a tile
          for (int t = pin_lo / BK; t < n_pin / BK; ++t) {
            mbar_expect_tx(pin_full(t), 2 * TB);
            load_tile(pin + t * 2 * TB, tm_k, pin_full(t), t);
            load_tile(pin + t * 2 * TB + TB, tm_v, pin_full(t), t);
          }
      }
      for (int t = next_seen<POS>(w, kpb, max(w.t_lo, w.n_pinned), Sk, window); t < w.n_kv;
           t = next_seen<POS>(w, kpb, t + 1, Sk, window), ++n) {
        const int st = n % STAGES;
        const int lap = n / STAGES;
        const uint32_t dst = ring + st * 2 * TB;
        if (lap > 0) mbar_wait(k_empty(st), (lap - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(k_full(st), TB);
          load_tile(dst, tm_k, k_full(st), t);
        }
        if (lap > 0) mbar_wait(v_empty(st), (lap - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(v_full(st), TB);
          load_tile(dst + TB, tm_v, v_full(st), t);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 packed rows of each Q tile
  if constexpr (NC > 1) reg_alloc<CONSUMER_REGS>();
  const int c = warp_uniform(warp / 4 - 1);
  const uint32_t qs = qbuf + c * TB;
  // this thread's two packed rows, r and r + 8 of its warp's 16: their query
  // row within the consumer's tile and their head
  int sl[2], hd[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * (warp & 3) + (lane >> 2) + 8 * i;
    sl[i] = r / group;
    hd[i] = g * group + r % group;
    live[i] = r < rows_s * group;
  }

  int n = 0;  // streamed tiles consumed
  for (int p = p0; p < p1; ++p) {
    const int q_lo = tile_at(p, n_q_tiles) * bq;
    const Walk w = kv_walk<POS>(qpb, kpb, q_lo, bq, Sq, Sk, causal, window, pinned_rows);
    const int s0 = q_lo + c * rows_s;           // this consumer's first query row
    const int s1 = min(Sq, s0 + rows_s) - 1;    // its last (below s0: none)
    int sr[2], qp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sr[i] = s0 + sl[i];
      // POS: the row's position (a row past Sq is never written)
      qp[i] = POS ? qpb[min(sr[i], Sq - 1)] : 0;
    }
    mbar_wait(q_full, (p - p0) & 1);

    float acc[NCB][32];
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[cb][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    // The tiles this consumer computes: the walk's, less (by index) those
    // above all its rows or below all their windows, a contiguous range
    // [c_lo, c_hi) (POS: the whole walk, holes and all).  It still takes and
    // frees each streamed tile outside the range.
    const int c_lo = POS ? w.t_lo : max(w.t_lo, first_kv_tile(s0, window));
    const int c_hi = s1 < s0 ? c_lo : POS || !causal ? w.n_kv : min(w.n_kv, s1 / BK + 1);
    auto pass = [&](int t) {  // a streamed tile this consumer does not compute
      if (t < w.n_pinned) return;
      const int st = n % STAGES, lap = n / STAGES;
      mbar_wait(k_full(st), lap & 1);
      mbar_arrive(k_empty(st), lane == 0);
      mbar_wait(v_full(st), lap & 1);
      mbar_arrive(v_empty(st), lane == 0);
      ++n;
    };

    // the descriptors of Q and of the K and V tiles the next products read,
    // set before wgmma_fence; each step's descriptor is its tile's plus a
    // constant (kept whole for every step, D 256's position kernels spilled)
    uint64_t dq = smem_desc(qs), dk = 0, dv = 0;
    auto prep = [&](uint32_t kt, uint32_t vt) {
      dk = smem_desc(kt);
      dv = smem_desc(vt);
      asm volatile("" : "+l"(dk), "+l"(dv), "+l"(dq)::"memory");
    };
    // S = Q K^T of prep's K tile into s, issued (committed, not waited for)
    auto issue_s = [&](float (&s)[32]) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (ks >> 2) * BOX_BYTES + (ks & 3) * 32;
        wgmma_ss(s, dq + (off >> 4), dk + (off >> 4), ks);
      }
      wgmma_commit();
    };
    // O += P V for P in pf and prep's V tile, issued
    uint32_t pf[4][4];  // P of the tile whose P V is pending: bf16 A fragments of four steps
    auto issue_pv = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          wgmma_rs(acc[cb], pf[kk], dv + ((cb * BOX_BYTES + kk * 16 * 128) >> 4));
      wgmma_commit();
    };
    // scale (in log2 units), softcap and mask the scores of the tile at
    // k_lo, and take them into the online softmax: P (fp32) into s, the
    // factor that rescales O into alpha.  The accumulator s_in is read, not
    // rewritten: it is also the next S = Q K^T's, and no register a wgmma
    // reads may be written while a product is pending (P reaches the A
    // fragments only after the wait for the pending P V)
    auto softmax = [&](const float (&s_in)[32], int k_lo, float (&s)[32], float (&alpha)[2]) {
      const bool need_mask = POS || k_lo + BK > Sk || (causal && k_lo + BK - 1 > s0) ||
                             (window > 0 && k_lo <= s1 - window);
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = tanhf(s_in[e] * (scale / softcap)) * (softcap * LOG2E);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = s_in[e] * (scale * LOG2E);
      }
      if (need_mask) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = k_lo + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
          const int i = (e >> 1) & 1;
          if constexpr (POS) {
            // a hidden key scores the finite -1e30: a row that sees none gets
            // the uniform mean; past Sk nothing counts.  The key's position
            // is read whether or not the column is past Sk (no branch)
            const int kpos = kpb != nullptr ? kpb[min(col, Sk - 1)] : col;
            const bool hidden = kpos > qp[i] || (window > 0 && kpos <= qp[i] - window);
            s[e] = col >= Sk ? -INFINITY : hidden ? NEG_INF : s[e];
          } else if (col >= Sk || (causal && col > sr[i]) ||
                     (window > 0 && col <= sr[i] - window)) {
            s[e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      float mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = fast_exp2(m[i] - mu[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = fast_exp2(s[4 * j] - mu[0]);
        s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mu[0]);
        s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mu[1]);
        s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mu[1]);
        l[0] += s[4 * j] + s[4 * j + 1];
        l[1] += s[4 * j + 2] + s[4 * j + 3];
      }
    };
    // P as bf16 A fragments of four 16-deep steps
    auto pack_p = [&](const float (&x)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pf[j >> 1][2 * (j & 1)] = pack_bf16(x[4 * j], x[4 * j + 1]);
        pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
      }
    };

    int t = next_seen<POS>(w, kpb, w.t_lo, Sk, window);
    for (; t < c_lo; t = next_seen<POS>(w, kpb, t + 1, Sk, window)) pass(t);
    // Q is free once this consumer's last S = Q K^T is done: then the
    // producer loads the next Q tile's while this one's last P V and its
    // output are still under way
    if (t >= c_hi) mbar_arrive(q_empty, lane == 0);
    if (t < c_hi) {
      // the first tile: its scores, then its P, whose P V the next step issues
      bool streamed = t >= w.n_pinned;
      int st = n % STAGES, lap = n / STAGES;
      uint32_t kt = streamed ? ring + st * 2 * TB : pin + t * 2 * TB;
      float s[32], x[32];
      float alpha[2];
      // a pinned tile's K and V land once, on the tile's own barrier
      mbar_wait(streamed ? k_full(st) : pin_full(t), streamed ? lap & 1 : 0);
      prep(kt, kt + TB);
      wgmma_fence();
      issue_s(s);
      wgmma_wait<0>();
      hold(s);
      if (streamed) mbar_arrive(k_empty(st), lane == 0);
      int t_next = next_seen<POS>(w, kpb, t + 1, Sk, window);
      if (t_next >= c_hi) mbar_arrive(q_empty, lane == 0);
      softmax(s, t * BK, x, alpha);  // O is zero: nothing to rescale
      pack_p(x);
      // The previous tile's O += P V is issued right after this tile's
      // S = Q K^T, and this tile's softmax runs while the tensor cores add it
      // (FlashAttention-3's overlap within a warpgroup); O is rescaled once
      // that product is done, so each row's arithmetic is the unpipelined
      // order's: rescale, then add.
      while (t_next < c_hi) {
        const bool streamed_next = t_next >= w.n_pinned;
        const int st_next = (n + streamed) % STAGES, lap_next = (n + streamed) / STAGES;
        const uint32_t kt_next =
            streamed_next ? ring + st_next * 2 * TB : pin + t_next * 2 * TB;
        mbar_wait(streamed_next ? k_full(st_next) : pin_full(t_next),
                  streamed_next ? lap_next & 1 : 0);
        if (streamed) mbar_wait(v_full(st), lap & 1);
        prep(kt_next, kt + TB);  // S of the next tile, P V of this one
        hold(pf);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
        wgmma_fence();
        issue_s(s);
        issue_pv();
        // the tile after (POS: a walk over positions) while the products run
        const int t_after = next_seen<POS>(w, kpb, t_next + 1, Sk, window);
        wgmma_wait<1>();  // S of the next tile
        hold(s);
        if (streamed_next) mbar_arrive(k_empty(st_next), lane == 0);
        if (t_after >= c_hi) mbar_arrive(q_empty, lane == 0);
        softmax(s, t_next * BK, x, alpha);
        wgmma_wait<0>();  // P V of this tile
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
        hold(x);
        if (streamed) {
          mbar_arrive(v_empty(st), lane == 0);
          ++n;
        }
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[cb][e] *= alpha[(e >> 1) & 1];
        pack_p(x);
        t = t_next;
        t_next = t_after;
        streamed = streamed_next;
        st = st_next;
        lap = lap_next;
        kt = kt_next;
      }
      // the last tile's P V
      if (streamed) mbar_wait(v_full(st), lap & 1);
      prep(kt, kt + TB);
      hold(pf);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
      wgmma_fence();
      issue_pv();
      wgmma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
      if (streamed) {
        mbar_arrive(v_empty(st), lane == 0);
        ++n;
      }
      t = next_seen<POS>(w, kpb, t + 1, Sk, window);
    }
    for (; t < w.n_kv; t = next_seen<POS>(w, kpb, t + 1, Sk, window)) pass(t);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (live[i] && sr[i] < Sq) {
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        // natural log-sum-exp of the row's scores from the log2-domain max and sum
        if (LSE && (lane & 3) == 0)
          lse[((long long)b * H + hd[i]) * Sq + sr[i]] = m[i] * LN2 + logf(l[i]);
        bf16* orow = o + b * o_sb + (long long)sr[i] * o_ss + (long long)hd[i] * o_sh +
                     2 * (lane & 3);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (cb * BOX_COLS + 8 * j < D)
              *reinterpret_cast<uint32_t*>(orow + cb * BOX_COLS + 8 * j) =
                  pack_bf16(acc[cb][4 * j + 2 * i] * inv, acc[cb][4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

#ifndef DCO_FLASH_POS
template <int D>
__global__ void __launch_bounds__((1 + consumers<D>()) * 128, 1)
flash_mma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int Sq, int Sk,
                 int H, int G, int tiles_per_chunk, int pinned_rows, int causal, int window,
                 float scale, float softcap, long long o_sb, long long o_ss, long long o_sh) {
  flash_mma_body<D, false, false>(tm_q, tm_k, tm_v, o, nullptr, nullptr, 0, Sq, Sk, H, G,
                                  tiles_per_chunk, pinned_rows, causal, window, scale, softcap,
                                  o_sb, o_ss, o_sh);
}

template <int D>
__global__ void __launch_bounds__((1 + consumers<D>()) * 128, 1)
flash_mma_lse_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int G, int tiles_per_chunk,
                     int pinned_rows, int causal, int window, float scale, float softcap,
                     long long o_sb, long long o_ss, long long o_sh) {
  flash_mma_body<D, true, false>(tm_q, tm_k, tm_v, o, lse, nullptr, 0, Sq, Sk, H, G,
                                 tiles_per_chunk, pinned_rows, causal, window, scale, softcap,
                                 o_sb, o_ss, o_sh);
}
#else
// The position variant, with (LSE, as flash_mma_lse_kernel) or without the
// per-row log-sum-exp.
template <int D, bool LSE>
__global__ void __launch_bounds__((1 + consumers<D>()) * 128, 1)
flash_mma_pos_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ pos, int keys_at_rows,
                     int Sq, int Sk, int H, int G, int tiles_per_chunk, int pinned_rows,
                     int causal, int window, float scale, float softcap, long long o_sb,
                     long long o_ss, long long o_sh) {
  flash_mma_body<D, LSE, true>(tm_q, tm_k, tm_v, o, lse, pos, keys_at_rows, Sq, Sk, H, G,
                               tiles_per_chunk, pinned_rows, causal, window, scale, softcap, o_sb,
                               o_ss, o_sh);
}
#endif

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
               const int* pos, int keys_at_rows, int B, int Sq, int Sk, int H, int G,
               int tiles_per_chunk, int pinned_rows, int causal, int window, float scale,
               float softcap, const long long* st, cudaStream_t stream) {
  const int group = H / G;
  if (group > MMA_ROWS) return -1;  // a consumer's rows hold one query row of every head
  const long long smem = mma_smem_bytes<D>((pinned_rows + BK - 1) / BK);
  if (smem > SMEM_LIMIT) return -2;
  static_assert(32 * STAGES + 16 + 8 * (SMEM_LIMIT / (2 * tile_bytes<64>())) <= BAR_BYTES,
                "a barrier for every pinned tile that fits");
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return -1;  // TMA: 16-byte strides
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0) return -1;
  const int rows_s = MMA_ROWS / group;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_q, q, D, H, Sq, B, st[2], st[1], st[0], group, rows_s) ||
      !tensor_map(&tm_k, k, D, G, Sk, B, st[5], st[4], st[3], 1, BK) ||
      !tensor_map(&tm_v, v, D, G, Sk, B, st[8], st[7], st[6], 1, BK))
    return -1;
#ifndef DCO_FLASH_POS
  const void* kernel =
      lse != nullptr ? (const void*)flash_mma_lse_kernel<D> : (const void*)flash_mma_kernel<D>;
#else
  const void* kernel = lse != nullptr ? (const void*)flash_mma_pos_kernel<D, true>
                                      : (const void*)flash_mma_pos_kernel<D, false>;
#endif
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  const int bq = consumers<D>() * rows_s;
  const int n_q_tiles = (Sq + bq - 1) / bq;
  const int n_chunks = (n_q_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  const dim3 grid(n_chunks, G, B);
  const int threads = (1 + consumers<D>()) * 128;
  bf16* ob = static_cast<bf16*>(o);
#ifdef DCO_FLASH_POS
  if (lse != nullptr)
    flash_mma_pos_kernel<D, true><<<grid, threads, (size_t)smem, stream>>>(
        tm_q, tm_k, tm_v, ob, lse, pos, keys_at_rows, Sq, Sk, H, G, tiles_per_chunk,
        pinned_rows, causal, window, scale, softcap, st[9], st[10], st[11]);
  else
    flash_mma_pos_kernel<D, false><<<grid, threads, (size_t)smem, stream>>>(
        tm_q, tm_k, tm_v, ob, nullptr, pos, keys_at_rows, Sq, Sk, H, G, tiles_per_chunk,
        pinned_rows, causal, window, scale, softcap, st[9], st[10], st[11]);
#else
  if (lse != nullptr)
    flash_mma_lse_kernel<D><<<grid, threads, (size_t)smem, stream>>>(
        tm_q, tm_k, tm_v, ob, lse, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window,
        scale, softcap, st[9], st[10], st[11]);
  else
    flash_mma_kernel<D><<<grid, threads, (size_t)smem, stream>>>(
        tm_q, tm_k, tm_v, ob, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale,
        softcap, st[9], st[10], st[11]);
#endif
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  `strides` (in elements): batch, row and head strides
// of q, then k, v and o; the last dimension of each has stride 1.  bf16 rows
// must be 16-byte aligned: pointers on 16 bytes, strides multiples of 8 (the
// TMA copies' rule); bf16 takes at most 64 query heads a KV head.
// `lse` (B, H, Sq) fp32, or null: the natural log-sum-exp of each row's scaled,
// capped and masked scores, for the backward (csrc/flash_attention_bwd.cu).
// `softcap` 0 means none.  `window` > 0 lets row r see columns (r - window, r]
// (causal only); 0 means none.  `pinned_rows` is Sk or a multiple of 64.
// `pos` (B, Sq), contiguous int32 in (-2^30, 2^30), or null: the queries'
// positions, which the causal mask and the window test instead of the row
// indices (causal only), with the keys at the same positions (`keys_at_rows`
// 0; Sq == Sk) or at their row index (1; Sq may differ from Sk); the
// position variant (flash_attention_pos.cu) computes them.  Returns 0, a cudaError_t,
// -1 for arguments the kernel does not take, or -2 when `pinned_rows` does not
// fit the shared memory a block may take.
namespace {

int flash_entry(const void* q, const void* k, const void* v, void* o, float* lse,
                const int* pos, int keys_at_rows, int dtype, int B, int Sq, int Sk, int H,
                int G, int D, int tiles_per_chunk, int pinned_rows, int causal, int window,
                float scale, float softcap, const long long* strides, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || G <= 0 || H % G != 0) return -1;
  if (B > 65535 || G > 65535 || tiles_per_chunk <= 0) return -1;
  if (pinned_rows < 0 || pinned_rows > Sk) return -1;
  if (pinned_rows != Sk && pinned_rows % BK != 0) return -1;
  if (causal && Sq != Sk && (pos == nullptr || !keys_at_rows)) return -1;
  if (window < 0 || (window > 0 && !causal)) return -1;
  if (pos != nullptr && !causal) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 256)
    return launch_mma<256>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 0 && D == 128)
    return launch_mma<128>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 0 && D == 112)
    return launch_mma<112>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 0 && D == 64)
    return launch_mma<64>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 1 && D == 256)
    return launch<float, 256>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 1 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 1 && D == 112)
    return launch<float, 112>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 1 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, pos, keys_at_rows, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  return -1;
}

}  // namespace

#ifdef DCO_FLASH_POS
extern "C" int dco_flash_attention_pos(const void* q, const void* k, const void* v, void* o,
                                       float* lse, const int* pos, int keys_at_rows,
                                       int dtype, int B, int Sq, int Sk, int H, int G, int D,
                                       int tiles_per_chunk, int pinned_rows, int causal,
                                       int window, float scale, float softcap,
                                       const long long* strides, void* stream) {
  if (pos == nullptr) return -1;
  return flash_entry(q, k, v, o, lse, pos, keys_at_rows, dtype, B, Sq, Sk, H, G, D,
                     tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides,
                     stream);
}
#else
extern "C" int dco_flash_attention_pos(const void* q, const void* k, const void* v, void* o,
                                       float* lse, const int* pos, int keys_at_rows,
                                       int dtype, int B, int Sq, int Sk, int H, int G, int D,
                                       int tiles_per_chunk, int pinned_rows, int causal,
                                       int window, float scale, float softcap,
                                       const long long* strides, void* stream);

extern "C" int dco_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   float* lse, const int* pos, int keys_at_rows, int dtype,
                                   int B, int Sq, int Sk, int H, int G, int D,
                                   int tiles_per_chunk, int pinned_rows, int causal,
                                   int window, float scale, float softcap,
                                   const long long* strides, void* stream) {
  if (pos != nullptr)  // the position variant (flash_attention_pos.cu)
    return dco_flash_attention_pos(q, k, v, o, lse, pos, keys_at_rows, dtype, B, Sq, Sk, H, G, D,
                                   tiles_per_chunk, pinned_rows, causal, window, scale,
                                   softcap, strides, stream);
  return flash_entry(q, k, v, o, lse, pos, keys_at_rows, dtype, B, Sq, Sk, H, G, D,
                     tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides,
                     stream);
}
#endif
