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
// The bf16 path (flash_mma_kernel), the one the serving path runs:
//  * Tensor cores.  S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products
//    with fp32 sums.  A warp owns 16 query rows of one head; its Q fragments are
//    loaded once per Q tile with ldmatrix and stay in registers.  K comes in by
//    ldmatrix, V by ldmatrix.trans.  The online softmax runs in registers (fp32
//    max, sum and rescale; exp2 with log2(e) folded into the scale; softcap
//    before the mask), and P, rounded to bf16 in registers, is the A operand of
//    P V: it never passes through shared memory.
//  * One K/V fetch serves the whole GQA group.  A block holds the Q tile of
//    every query head of its KV head, one (head, 16-row slice) a warp, at most
//    MAX_WARPS warps: 16 * warps_per_head query rows a tile (64 rows for groups
//    1 and 2, 32 for 3 and 4, 16 for 5 to 8); larger groups go in passes of
//    heads.  Each K/V tile reaches shared memory once per Q tile and pass, not
//    once per head.
//  * Asynchronous copies.  cp.async moves 16 bytes a lane into rows kept with
//    an XOR swizzle of their 16-byte chunks (chunk ^ row % 8), so that
//    ldmatrix reads 8 rows of one chunk from 8 distinct bank groups.  A row
//    takes 2 * D bytes rounded up to 128 (row_bytes): no pad at D 64, 128, 256;
//    at D 112 (zamba2-7b) its 14 chunks sit in 16 slots, the swizzle stays
//    inside the row, and the two spare slots are never copied or read (7
//    QK^T steps and 14 output column blocks, nothing computed on padding).
//    Streamed tiles go through a ring of STAGES tiles: tile t + 1 loads while
//    tile t computes.  Up to Q_REG_DIM, Q is staged through the ring before
//    the KV loop and needs no buffer of its own.  The pinned prefix is staged once, with the
//    same copies and in the same layout, so one inner loop reads a pinned or a
//    streamed tile and only the address differs.  KV rows past Sk are zeros in
//    both, so the result is bit-identical whatever `pinned_rows` and
//    `tiles_per_chunk` are: the tile order and the arithmetic never depend on
//    where a tile lives.
//  * Causal balance.  In the diagonal tile a warp skips the 16-column blocks
//    above its own rows and masks the rest.  Q tiles are dealt to the chunks in
//    the order n-1, 0, n-2, 1, ...: a chunk of two tiles pairs the heaviest
//    left with the lightest, so every block of llama's 1024-token prefill
//    walks the same number of KV tiles (16 chunks of two 32-row tiles per KV
//    head, one block per SM); with one tile a chunk, block 0 takes the
//    heaviest.  This was taken over ordering blocks by work because
//    `tiles_per_chunk` keeps its meaning (the Q tiles that share one staging
//    of the prefix) and the wrapper's chunking needs no model of the work.
//    The 32-row tile of groups 3 and 4 doubles the blocks a 64-row tile gives:
//    64 at 256 tokens for llama's 8 KV heads, where 64-row tiles gave 32.  A
//    12-warp block with 64-row tiles for group 3 was tried and lost: capped at
//    168 registers it spills.
//  * Head size 256 (gemma-7b).  A warp's 16 x 256 output is 128 fp32 sums a
//    thread, and Q's fragments held for the whole KV walk would be 64 more:
//    with the scores that is past the 255 registers a thread may hold.  So
//    above Q_REG_DIM the output stays in registers and Q's fragments do not
//    (FlashAttention-2's plan at this size): Q is staged once a tile and pass
//    into a buffer of its own (MAX_WARPS_Q_SMEM warps' 16 rows) and each
//    16-deep step of Q K^T reads its fragment back with ldmatrix.  That alone
//    still spilled at 255 registers, so the online softmax also takes a
//    64-row KV tile in two steps of 32 columns (scores and P fragments in half
//    the registers; FlashAttention-2's 64 x 32 tile at this size), skips a
//    step whose columns the causal mask or the window hide from every row of
//    the warp, and unrolls half of the Q K^T loop: no spill, 242 registers.
//    One 64-column step was about 10% faster but spilled at every unroll.  A block has MAX_WARPS_Q_SMEM warps at most, so Q's buffer
//    is 32 KB whatever the group, and a row is 512 bytes (row_bytes), so the
//    swizzle stays in it.  The tile walk and the masks are those of the
//    smaller heads, and the arithmetic does not depend on where a tile
//    lives: the result is bit-identical across `pinned_rows` and
//    `tiles_per_chunk` there too.  The ring (128 KB) and Q's buffer leave one
//    64-row tile of pinned K and V in a block's 227 KB.
//  * Left for later: wgmma fed by TMA with a producer warp and a consumer
//    warpgroup per 64 rows, once this version's numbers say whether MMA issue
//    rate or latency is what remains.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_tiles.cuh"
#include "positions.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // fp32 path: query rows of a tile
constexpr int BK = 64;        // KV rows of a tile, both paths
constexpr int THREADS = 256;  // fp32 path: 16 x 16, thread (ty, tx) owns rows ty*4.., cols tx+16*j
constexpr int LDP = BK + 1;
constexpr int SMEM_LIMIT = 232448;
constexpr int STAGES = 2;     // bf16 path: streamed K/V tiles in the ring
constexpr int MAX_WARPS = 8;  // bf16 path: warps of a block, one (head, 16 rows) each
constexpr int Q_REG_DIM = 128;        // bf16 path: the largest D whose Q fragments stay in registers
constexpr int MAX_WARPS_Q_SMEM = 4;   // bf16 path above Q_REG_DIM: warps of a block
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
// bf16 path

using namespace dco_tiles;
static_assert(STAGES == 2, "the ring loads one tile ahead");

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Bytes of Q's own buffer: none where Q's fragments stay in registers (Q is
// staged through the ring), else the 16 rows of each of MAX_WARPS_Q_SMEM warps.
template <int D>
__host__ __device__ constexpr int q_buffer_bytes() {
  return D > Q_REG_DIM ? MAX_WARPS_Q_SMEM * 16 * row_bytes<D>() : 0;
}

// The Q tile at place p of the order n-1, 0, n-2, 1, ...
__device__ __forceinline__ int tile_at(int p, int n) {
  return (p & 1) ? p >> 1 : n - 1 - (p >> 1);
}

// grid = (Q-tile chunks, G, B); block = 32 * hp * wph threads: warp w owns
// query rows [16 * (w % wph), +16) of the tile for head w / wph of the pass.
// Strides are in elements.  LSE: also write each row's log-sum-exp to `lse`.
// The body is shared by two kernels: the serving one (flash_mma_kernel, no
// LSE, with the signature and code it had before the LSE existed) and
// training's (flash_mma_lse_kernel); POS (the position variant's
// flash_mma_pos_kernel): mask by pos (B, Sq), keys at the same positions or,
// with keys_at_rows, at their row index.
template <int D, bool LSE, bool POS>
__device__ __forceinline__ void flash_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, const int* __restrict__ pos,
    int keys_at_rows, int Sq, int Sk, int H, int G, int wph,
    int hp, int tiles_per_chunk, int pinned_rows, int causal, int window, float scale,
    float softcap, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sg, long long v_sb, long long v_ss, long long v_sg,
    long long o_sb, long long o_ss, long long o_sh) {
  constexpr int ROWB = row_bytes<D>();  // bytes of a staged row
  constexpr int TILEB = BK * ROWB;  // bytes of a staged K or V tile
  constexpr int KS = D / 16;        // 16-deep steps of Q K^T
  constexpr int NO = D / 8;         // 8-wide column blocks of O
  constexpr bool QS = D > Q_REG_DIM;  // Q's fragments read back from its buffer each step
  constexpr int CB = QS ? 2 : 4;      // 16-column blocks of a KV tile a softmax step takes
  static_assert(D % 16 == 0 && ROWB % 128 == 0 && ROWB >= 2 * D, "row layout");

  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int pin_alloc = (pinned_rows + BK - 1) / BK * BK;
  const uint32_t pinK = smem_addr(smem_mma);
  const uint32_t pinV = pinK + pin_alloc * ROWB;
  const uint32_t ring = pinV + pin_alloc * ROWB;  // STAGES x (K tile, V tile)
  const uint32_t qbuf = ring + STAGES * 2 * TILEB;  // QS: Q of the pass's heads

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hh = warp / wph;
  const int slice = warp % wph;
  const int bq = 16 * wph;
  const int n_q_tiles = (Sq + bq - 1) / bq;
  const int p0 = blockIdx.x * tiles_per_chunk;
  const int p1 = min(n_q_tiles, p0 + tiles_per_chunk);

  const bf16* kb = k + b * k_sb + g * k_sg;
  const bf16* vb = v + b * v_sb + g * v_sg;
  // POS: this batch row's positions of the queries and (forward mode) the keys
  const int* qpb = POS ? pos + (long long)b * Sq : nullptr;
  const int* kpb = POS && !keys_at_rows ? qpb : nullptr;

  // the pinned prefix: staged once, whole tiles, from the first tile to the
  // last that this block's Q rows can see; its rows hold what a streamed tile
  // would hold.  POS: the whole prefix
  int kv_need = POS ? Sk : 0, kv_first = POS ? 0 : Sk;
  for (int p = p0; p < (POS ? p0 : p1); ++p) {
    const int qt = tile_at(p, n_q_tiles);
    kv_need = max(kv_need, causal ? min(Sk, (qt + 1) * bq) : Sk);
    kv_first = min(kv_first, first_kv_tile(qt * bq, window) * BK);
  }
  const int n_pin = min(pin_alloc, (min(pinned_rows, kv_need) + BK - 1) / BK * BK);
  const int pin_lo = min(n_pin, kv_first);
  stage_tile<D>(pinK + pin_lo * ROWB, kb + (long long)pin_lo * k_ss, k_ss, n_pin - pin_lo,
                min(n_pin, Sk) - pin_lo);
  stage_tile<D>(pinV + pin_lo * ROWB, vb + (long long)pin_lo * v_ss, v_ss, n_pin - pin_lo,
                min(n_pin, Sk) - pin_lo);
  cp_async_commit();

  auto load_kv = [&](int t, int st) {
    const int k_lo = t * BK;
    const int nv = min(BK, Sk - k_lo);
    const uint32_t dst = ring + st * 2 * TILEB;
    stage_tile<D>(dst, kb + (long long)k_lo * k_ss, k_ss, BK, nv);
    stage_tile<D>(dst + TILEB, vb + (long long)k_lo * v_ss, v_ss, BK, nv);
  };

  for (int p = p0; p < p1; ++p) {
    const int q_lo = tile_at(p, n_q_tiles) * bq;
    int kv_end = causal ? min(Sk, q_lo + bq) : Sk;
    int t_lo = first_kv_tile(q_lo, window);
    int q_mn = 0, q_mx = 0;  // POS: the tile's smallest and largest position
    if constexpr (POS)
      pos_walk(qpb, kpb, q_lo, min(bq, Sq - q_lo), Sk, window, t_lo, kv_end, q_mn, q_mx);
    const int n_kv = (kv_end + BK - 1) / BK;
    const int n_pinned = pinned_rows >= Sk ? n_kv : min(n_kv, pinned_rows / BK);
    // POS: the first tile at or after t that some row of this Q tile sees
    // (forward mode; the next tile in prefill mode), so that a hidden tile is
    // neither loaded nor computed.  Uniform over the block.
    auto next_seen = [&](int t) {
      if constexpr (POS) {
        while (t < n_kv && pos_tile_hidden(kpb, t * BK, Sk, q_mn, q_mx, window)) ++t;
      }
      return t;
    };
    const int t_stream = next_seen(max(t_lo, n_pinned));  // the first streamed tile
    const int r0 = q_lo + 16 * slice;  // this warp's first query row
    const int ra = r0 + (lane >> 2);   // this thread's rows: ra and ra + 8
    // POS: the positions of rows ra and ra + 8 (a row past Sq is never written)
    const int qp0 = POS && ra < Sq ? qpb[ra] : 0;
    const int qp1 = POS && ra + 8 < Sq ? qpb[ra + 8] : 0;
    for (int h0 = 0; h0 < group; h0 += hp) {
      const int nh = min(hp, group - h0);
      const int h = g * group + h0 + hh;
      const bool active = hh < nh && r0 < Sq;

      // Q of the pass's heads through the ring, into registers; or (QS) into
      // its own buffer, read back at each step of Q K^T
      __syncthreads();  // the ring (and Q's buffer) is free
      const uint32_t qdst = QS ? qbuf : ring;
      for (int j = 0; j < nh; ++j)
        stage_tile<D>(qdst + j * bq * ROWB,
                      q + b * q_sb + (long long)(g * group + h0 + j) * q_sh +
                          (long long)q_lo * q_ss,
                      q_ss, bq, min(bq, Sq - q_lo));
      cp_async_commit();
      cp_async_wait<0>();  // Q (and the pinned prefix) staged
      __syncthreads();
      const int q_row = hh * bq + 16 * slice + (lane & 15);  // this lane's ldmatrix row of Q
      uint32_t qf[QS ? 1 : KS][4];
      if constexpr (!QS) {
        if (active) {
#pragma unroll
          for (int s = 0; s < KS; ++s) ldsm_x4(ring + swz<ROWB>(q_row, 2 * s + (lane >> 4)), qf[s]);
        }
        __syncthreads();  // the ring takes K/V now
      }
      if (t_stream < n_kv) load_kv(t_stream, 0);
      cp_async_commit();

      float acc[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums

      for (int t = next_seen(t_lo), slot = 0; t < n_kv;) {
        const int t_next = next_seen(t + 1);
        const bool streamed = t >= n_pinned;
        uint32_t kt, vt;
        if (streamed) {
          const int st = POS ? slot : (t - t_stream) & 1;
          if (t_next < n_kv) load_kv(t_next, st ^ 1);
          cp_async_commit();
          cp_async_wait<1>();  // tile t has landed
          __syncthreads();
          kt = ring + st * 2 * TILEB;
        } else {
          kt = pinK + t * TILEB;
        }
        vt = streamed ? kt + TILEB : pinV + t * TILEB;

        const int k_lo = t * BK;
        // columns [0, dead) lie below the window of every row of this warp
        // (POS: no column is skipped by its index)
        const int dead = !POS && window > 0 ? min(BK, max(0, r0 - window + 1 - k_lo)) : 0;
        if (active && dead < BK) {
          // columns [lim, BK) lie above every row of this warp
          const int lim = !POS && causal ? min(BK, r0 + 16 - k_lo) : BK;
          const bool need_mask = POS || k_lo + BK > Sk || (causal && k_lo + BK > r0 + 1) ||
                                 (window > 0 && k_lo + window <= r0 + 15);

          // softmax steps of CB 16-column blocks: the whole tile, or (QS) two
          // halves, whose scores and P fragments take half the registers
#pragma unroll
          for (int c0 = 0; c0 < 4; c0 += CB) {
            // a step whose columns all lie above or below the warp's rows is
            // masked whole: skipping it changes nothing
            if (QS && (16 * c0 >= lim || 16 * (c0 + CB) <= dead)) continue;

            // S = Q K^T: 16 x 16 CB, 2 CB 8-column blocks
            float s[2 * CB][4];
#pragma unroll
            for (int j = 0; j < 2 * CB; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            // (QS: half unrolled; unrolled whole, it spilled 4 bytes)
#pragma unroll (QS ? 8 : KS)
            for (int ks = 0; ks < KS; ++ks) {
              if constexpr (QS) ldsm_x4(qbuf + swz<ROWB>(q_row, 2 * ks + (lane >> 4)), qf[0]);
#pragma unroll
              for (int j = 0; j < CB; ++j) {
                const int jb = c0 + j;  // 16-column block of the tile
                if (16 * jb < lim && 16 * jb + 16 > dead) {
                  uint32_t kf[4];
                  ldsm_x4(kt + swz<ROWB>(16 * jb + ((lane >> 4) << 3) + (lane & 7),
                                         2 * ks + ((lane >> 3) & 1)),
                          kf);
                  mma_bf16(s[2 * j], qf[QS ? 0 : ks], kf[0], kf[1]);
                  mma_bf16(s[2 * j + 1], qf[QS ? 0 : ks], kf[2], kf[3]);
                }
              }
            }

            // scale (in log2 units), softcap, mask
            if (softcap > 0.f) {
#pragma unroll
              for (int j = 0; j < 2 * CB; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  s[j][e] = tanhf(s[j][e] * (scale / softcap)) * (softcap * LOG2E);
            } else {
#pragma unroll
              for (int j = 0; j < 2 * CB; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] *= scale * LOG2E;
            }
            if (need_mask) {
#pragma unroll
              for (int j = 0; j < 2 * CB; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int col = k_lo + 16 * c0 + 8 * j + 2 * (lane & 3) + (e & 1);
                  const int row = ra + 8 * (e >> 1);
                  if constexpr (POS) {
                    // a hidden key scores the finite -1e30: a row that sees
                    // none gets the uniform mean; past Sk nothing counts
                    if (col >= Sk)
                      s[j][e] = -INFINITY;
                    else if (pos_hidden(kpb, col, (e >> 1) ? qp1 : qp0, window))
                      s[j][e] = NEG_INF;
                  } else if (col >= Sk || (causal && col > row) ||
                             (window > 0 && col <= row - window)) {
                    s[j][e] = -INFINITY;
                  }
                }
            }

            // online softmax; P as bf16 A fragments of CB 16-deep steps
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < 2 * CB; ++j) {
              mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
              mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
            }
            float mu[2], alpha[2];
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
            uint32_t pf[CB][4];
#pragma unroll
            for (int j = 0; j < 2 * CB; ++j) {
              const float e0 = fast_exp2(s[j][0] - mu[0]);
              const float e1 = fast_exp2(s[j][1] - mu[0]);
              const float e2 = fast_exp2(s[j][2] - mu[1]);
              const float e3 = fast_exp2(s[j][3] - mu[1]);
              l[0] += e0 + e1;
              l[1] += e2 + e3;
              pf[j >> 1][2 * (j & 1)] = pack_bf16(e0, e1);
              pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(e2, e3);
            }
#pragma unroll
            for (int j = 0; j < NO; ++j) {
              acc[j][0] *= alpha[0];
              acc[j][1] *= alpha[0];
              acc[j][2] *= alpha[1];
              acc[j][3] *= alpha[1];
            }

            // O += P V
#pragma unroll
            for (int s2 = 0; s2 < CB; ++s2) {
              const int jb = c0 + s2;
              if (16 * jb < lim && 16 * jb + 16 > dead) {
#pragma unroll
                for (int j = 0; j < NO / 2; ++j) {
                  uint32_t vf[4];
                  ldsm_x4_trans(vt + swz<ROWB>(16 * jb + (lane & 15), 2 * j + (lane >> 4)), vf);
                  mma_bf16(acc[2 * j], pf[s2], vf[0], vf[1]);
                  mma_bf16(acc[2 * j + 1], pf[s2], vf[2], vf[3]);
                }
              }
            }
          }
        }
        if (streamed) {
          __syncthreads();  // this ring slot may be refilled
          slot ^= 1;
        }
        t = t_next;
      }

      if (active) {
        bf16* ob = o + b * o_sb + (long long)h * o_sh + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
          const int row = ra + 8 * i;
          if (row < Sq) {
            const float inv = 1.f / fmaxf(l[i], 1e-30f);
            // natural log-sum-exp of the row's scores from the log2-domain max and sum
            if (LSE && (lane & 3) == 0)
              lse[((long long)b * H + h) * Sq + row] = m[i] * LN2 + logf(l[i]);
            bf16* orow = ob + (long long)row * o_ss;
#pragma unroll
            for (int j = 0; j < NO; ++j)
              *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                  pack_bf16(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
          }
        }
      }
    }
  }
}

#ifndef DCO_FLASH_POS
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk, int H,
                 int G, int wph, int hp, int tiles_per_chunk, int pinned_rows, int causal,
                 int window, float scale, float softcap, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sg, long long v_sb,
                 long long v_ss, long long v_sg, long long o_sb, long long o_ss,
                 long long o_sh) {
  flash_mma_body<D, false, false>(q, k, v, o, nullptr, nullptr, 0, Sq, Sk, H, G, wph, hp,
                                  tiles_per_chunk, pinned_rows, causal, window, scale, softcap,
                                  q_sb, q_ss, q_sh, k_sb, k_ss, k_sg, v_sb, v_ss, v_sg, o_sb,
                                  o_ss, o_sh);
}

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
flash_mma_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Sk, int H, int G, int wph, int hp, int tiles_per_chunk,
                     int pinned_rows, int causal, int window, float scale, float softcap,
                     long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sg, long long v_sb, long long v_ss,
                     long long v_sg, long long o_sb, long long o_ss, long long o_sh) {
  flash_mma_body<D, true, false>(q, k, v, o, lse, nullptr, 0, Sq, Sk, H, G, wph, hp,
                                 tiles_per_chunk, pinned_rows, causal, window, scale, softcap,
                                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sg, v_sb, v_ss, v_sg, o_sb, o_ss,
                                 o_sh);
}
#else
// The position variant, with (LSE, as flash_mma_lse_kernel) or without the
// per-row log-sum-exp.
template <int D, bool LSE>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
flash_mma_pos_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ pos, int keys_at_rows, int Sq,
                     int Sk, int H, int G, int wph, int hp, int tiles_per_chunk,
                     int pinned_rows, int causal, int window, float scale, float softcap,
                     long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sg, long long v_sb, long long v_ss,
                     long long v_sg, long long o_sb, long long o_ss, long long o_sh) {
  flash_mma_body<D, LSE, true>(q, k, v, o, lse, pos, keys_at_rows, Sq, Sk, H, G, wph, hp,
                               tiles_per_chunk, pinned_rows, causal, window, scale, softcap, q_sb,
                               q_ss, q_sh, k_sb, k_ss, k_sg, v_sb, v_ss, v_sg, o_sb, o_ss, o_sh);
}
#endif

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
               const int* pos, int keys_at_rows, int B, int Sq, int Sk, int H, int G,
               int tiles_per_chunk, int pinned_rows, int causal, int window, float scale,
               float softcap, const long long* st, cudaStream_t stream) {
  // heads a pass, then warps a head (16 query rows each), within the block's warps
  const int max_warps = D > Q_REG_DIM ? MAX_WARPS_Q_SMEM : MAX_WARPS;
  const int group = H / G;
  const int passes = (group + max_warps - 1) / max_warps;
  const int hp = (group + passes - 1) / passes;
  int wph = 4;
  while (wph > 1 && hp * wph > max_warps) wph >>= 1;
  const long long pin_alloc = (pinned_rows + BK - 1) / BK * BK;
  const long long smem =
      (2ll * pin_alloc + STAGES * 2ll * BK) * row_bytes<D>() + q_buffer_bytes<D>();
  if (smem > SMEM_LIMIT) return -2;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return -1;  // 16-byte rows for the 16-byte copies
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0) return -1;
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
  const int bq = 16 * wph;
  const int n_q_tiles = (Sq + bq - 1) / bq;
  const int n_chunks = (n_q_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  const dim3 grid(n_chunks, G, B);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
#ifdef DCO_FLASH_POS
  if (lse != nullptr)
    flash_mma_pos_kernel<D, true><<<grid, 32 * hp * wph, (size_t)smem, stream>>>(
        qb, kb, vb, static_cast<bf16*>(o), lse, pos, keys_at_rows, Sq, Sk, H, G, wph, hp,
        tiles_per_chunk, pinned_rows, causal, window, scale, softcap, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  else
    flash_mma_pos_kernel<D, false><<<grid, 32 * hp * wph, (size_t)smem, stream>>>(
        qb, kb, vb, static_cast<bf16*>(o), nullptr, pos, keys_at_rows, Sq, Sk, H, G, wph, hp,
        tiles_per_chunk, pinned_rows, causal, window, scale, softcap, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
#else
  if (lse != nullptr)
    flash_mma_lse_kernel<D><<<grid, 32 * hp * wph, (size_t)smem, stream>>>(
        qb, kb, vb, static_cast<bf16*>(o), lse, Sq, Sk, H, G, wph, hp, tiles_per_chunk,
        pinned_rows, causal, window, scale, softcap, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11]);
  else
    flash_mma_kernel<D><<<grid, 32 * hp * wph, (size_t)smem, stream>>>(
        qb, kb, vb, static_cast<bf16*>(o), Sq, Sk, H, G, wph, hp, tiles_per_chunk, pinned_rows,
        causal, window, scale, softcap, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
#endif
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  `strides` (in elements): batch, row and head strides
// of q, then k, v and o; the last dimension of each has stride 1.  bf16 rows
// must be 16-byte aligned: pointers on 16 bytes, strides multiples of 8.
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
