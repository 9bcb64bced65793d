// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a): the gradients
// of y and of the final state with respect to x, dt, A, B, C and the initial
// state.
//
// Replaces what the JAX package gets from autodiff: its training forward runs
// the chunked scan `ssd_chunked` (src/repro/models/ssm.py), which JAX
// differentiates; the Pallas forward `ssd_kernel`
// (src/repro/kernels/ssd_scan/kernel.py) has no backward of its own.  On the
// card the port's training forward is csrc/ssd_scan.cu, unchanged.
//
// For each (batch b, head h of group g), with a = dt A, xd = x dt, state_t the
// running state from `init` and dy the gradient of y:
//   dC^h_t = dy_t . state_t                                   (forward walk)
//   G_t    = dy_t (x) C_t + exp(a_{t+1}) G_{t+1},  G_{S-1} = dy (x) C + dFinal
//   dxd_t  = G_t B_t,  dx = dxd dt,  dB^h_t = xd_t^T G_t,  dinit = exp(a_0) G_0
//   dcum_t = C_t . dC^h_t - B_t . dB^h_t  (+ <dFinal, final state> at S - 1)
//   da_t   = sum_{t' >= t} dcum_t',  ddt = dxd . x + da A,  dA = sum_{b,t} da dt
// and dB, dC of group g are the sums of dB^h, dC^h over its heads.  The walks
// are taken a 64-row sub-chunk at a time as products, with the decays
// exp(cum_t - cum_s) of one sub-chunk's cumsum (exp2 in log2 units, as the
// forward kernel): no decay is ever formed across the sequence, where cum falls
// several hundred below zero.  In the sub-chunk of rows [c0, c0 + 64), with the
// cumsum local to it, L[t, s] = exp(cum_t - cum_s) for s <= t, w_t =
// exp(tot - cum_t) and tot its sum:
//   forward:  dC = ((dY X^T dt) o L) B + diag(exp(cum)) dY ST_prev
//             ST = exp(tot) ST_prev + X^T diag(dt w) B
//   reverse:  dXD = ((C B^T) o L)^T dY + diag(w) B R^T
//             dB^h = ((dY X^T dt) o L)^T C + diag(w dt) X R
//             R_prev = exp(tot) R + dY^T diag(exp(cum)) C
// where R, the reverse state carried from the sub-chunk after, starts as
// dFinal and ends as dinit.
//
// Bound on an H100: operations.  At the training shape (B 8, S 512, H 80, P 64,
// N 128) the gradient needs Q^2 (2 P + 3 N) + 10 Q P N FLOP a (batch, head,
// sub-chunk) with the causal products counted at half (37.6 GFLOP a layer),
// against some 0.26 GB moved (x, dy and dx dominate): 0.23 ms at 3xTF32's 165
// TFLOP/s, 0.08 ms at the memory rate.  Plain TF32 (10 mantissa bits) cannot
// hold the 1e-4 the gradients are held to, so every product is 3xTF32
// (tf32.cuh): a b ~ hi hi' + lo hi' + hi lo', fp32 sums.
//
// What the design does about it (Hopper's own instructions, hopper.cuh):
//  * Every product is wgmma m64nNk8 TF32 with fp32 sums, its A operand in
//    registers and its B operand a tile in shared memory.  TF32 wgmma takes B
//    K-major only (no transpose for 32-bit types), and the products read the
//    rows of x, dy, B and C both along them (dY X^T, B C^T, X R) and down
//    their columns (ML B, SL^T dY, X^T B, dY^T C).  So every B operand is a
//    tile laid out K-major for its product and split into hi and lo as it is
//    written, and every A operand is read into registers from wherever it
//    lies (a staged tile either way round, the L2, or an accumulator) and
//    split there.  Inside each group of 8 along K the B tiles hold k at
//    position (k & 7) / 2 + 4 (k & 1), so that an m64nN accumulator's
//    fragment is the register A of the next product as it stands (its
//    thread holds columns 2t, 2t + 1 of a k-step where the A fragment wants
//    t, t + 4); every other A fragment is read in the same order.  A
//    product's k-steps go four at a time, the next four split while the
//    tensor cores add the last (on an H100 this pattern alone ran at 457
//    TFLOP/s of TF32: scripts/kernel_timeline.py --kernel wgmma).  A
//    transposed copy of a 64-row tile costs its hi/lo pair in shared memory,
//    and at N 128 one walk's three B tiles are 160 KB; so the work is cut
//    into three walks, each a kernel whose tiles fit one block's 227 KB
//    beside the ring.  No product runs on mma.sync or FMA;
//    only the cumsum, the decays and the fp64 sums below do.
//  * Staging.  x and dy, the two tensors a head owns, reach shared memory
//    through tensor maps (boxes of 32 columns x 64 rows, the 128-byte
//    swizzle; rows past S are zeros), two sub-chunks in a ring, each stage
//    asked for by one thread as soon as the stage is read.  B and C are a
//    group's, the same for all its heads and all three walks: prep_kernel
//    lays out their tiles once (B^T, C^T and C, split, and B's rows as TMA
//    stages them), and each walk block takes its sub-chunk's tiles by bulk
//    copies, asked for as soon as the last ones are read.  The x walk stages
//    dy and B (the A of its products over N) and reads x for dXD . x from
//    the L2.  dt (stride H between rows: no 16-byte box) is read a sub-chunk
//    ahead by the first 64 threads.  No producer warp: a ninth
//    warp puts three warps on one of the SM's four schedulers, and ptxas then
//    compiles the whole kernel to the 168 registers that allows (setmaxnreg
//    does not lift it) and spills; with 256 threads a consumer has 255.
//  * The walk stays one block per (batch, head).  Stamps of the FMA kernel
//    (scripts/kernel_timeline.py --kernel ssd_bwd; PERF.md, PR 31) put its
//    time in per-SM throughput: each walk a block alone on its SM, its loads
//    (29-37% of a sub-chunk) overlapping nothing and its products on FMA.
//    Splitting the chunk walk over more blocks would add blocks that queue
//    for the same SMs; the ring overlaps the loads and the tensor cores take
//    the products.  A walk's running state lives between sub-chunks in its
//    B tile (hi + lo: the state to 2^-22 of itself) and in registers only
//    around its update.
//  * Scratch.  C_t . dC^h_t and B_t . dB^h_t are summed where dC^h and dB^h
//    are formed, in fp64, and handed on as (B, H, S) partials (one a consumer
//    warpgroup), so no walk reads dC^h or dB^h back.  The sums over a group's
//    heads (dB, dC) stay a pass of their own in a fixed order.
//
// Six launches, deterministic, no atomics (each output is written once, by
// one thread, in a fixed order, so two calls give bit-identical gradients):
//  (0) prep_kernel, a block per (b, sub-chunk, g): the B^T, C^T and C tiles.
//  (1) c_walk_kernel, a block per (b, h), sub-chunks first to last: recomputes
//      the running state from x, dt, A, B and init (the forward writes no
//      per-chunk state: the dead-block idea) and writes dC^h (B, S, H, N),
//      the partials of C . dC^h and <dFinal, final state>.  A consumer takes
//      half of the state's columns N (its dC^h columns and state columns);
//      both form dY X^T.
//  (2) b_walk_kernel, a block per (b, h), last sub-chunk to first, R on chip:
//      dB^h (B, S, H, N), the partials of B . dB^h, dinit.  A consumer takes
//      half of N; both form X dY^T.
//  (3) x_walk_kernel, the same walk: dx and the partials of dXD . x.  A
//      consumer takes half of P (its dXD columns and R^T columns); both form
//      B C^T.
//  (4) scan_kernel, a warp per (b, h): dcum from the partials and the reverse
//      running sum da, ddt and the (b, h) partial of dA.
//  (5) head_sum_kernel: dB and dC of each group, summed over its heads in
//      order, and dA summed over the batch in order.
// The sums behind dt's and A's gradients cancel (dA of a trained layer is a
// small difference of large terms), so dcum, its reverse running sum and dA's
// partials are fp64 scalars: a few operations a row, off the products' path.
//
// Computed here: fp32 inputs, P 32 or 64, N 16, 32, 64 or 128, any S (rows
// past S are zeros: they add nothing and, with dt 0, carry no decay), G >= 1,
// x, dt, B and C read through their strides.  The wrapper refuses bf16 and
// other sizes before any launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace dco_hopper;
using dco_tf32::split_tf32;

constexpr int Q = 64;                         // rows of a sub-chunk
constexpr int CONSUMERS = 2;                  // consumer warpgroups of a walk block
constexpr int CTHREADS = 128 * CONSUMERS;     // a walk block's threads: its consumers only
constexpr int STAGES = 2;                     // sub-chunks in the ring
constexpr int SMEM_LIMIT = 232448;
constexpr int RAW_BOX = 64 * 128;             // a TMA box: 64 rows x 32 fp32 columns
constexpr int SCAN_WARPS = 8;                 // warps of a scan block
constexpr float LOG2E = 1.4426950408889634f;

enum Walk { C_WALK, B_WALK, X_WALK };

// A wgmma B operand in TF32, K-major, split: ROWS rows (the product's N) of K
// values, boxes of 32 values (128 bytes) a row in the 128-byte swizzle, the
// hi part then the lo part; k sits at kpos(k) within its group of 8.
__host__ __device__ constexpr int kpos(int k) {
  return (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2);
}

template <int ROWS, int K>
struct OpTile {
  static_assert(ROWS % 8 == 0 && K % 8 == 0, "an operand tile");
  static constexpr int BOX = ROWS * 128;
  static constexpr int HALF = (K + 31) / 32 * BOX;
  static constexpr int BYTES = 2 * HALF;
  static __device__ __forceinline__ int off(int r, int k) {
    const int p = kpos(k);
    return (p >> 5) * BOX + r * 128 + ((((p & 31) >> 2) ^ (r & 7)) << 4) + ((p & 3) << 2);
  }
  // element (r, k) = v, split into hi and lo
  static __device__ __forceinline__ void put(unsigned char* tile, int r, int k, float v) {
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int o = off(r, k);
    *reinterpret_cast<uint32_t*>(tile + o) = hi;
    *reinterpret_cast<uint32_t*>(tile + HALF + o) = lo;
  }
};

// Element (r, c) of a staged TMA tile of 64 rows (boxes of 32 columns).
__device__ __forceinline__ float raw(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + (c >> 5) * RAW_BOX + r * 128 +
                                         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// Pin registers to this point of the program (hopper.cuh's hold, any size).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d += A B in 3xTF32 for K = 8 KS: B the rows from `b` (the shared address
// of the first row's hi part) of an OpTile whose parts lie `half` bytes
// apart and whose boxes `box` bytes apart; A's k-step ks from frag(ks, v)
// (v[0] row g, v[1] row g + 8 at column 2t; v[2], v[3] at 2t + 1).  The
// k-steps go in batches of four: a batch's fragments are split into one of
// two register sets, its 12 wgmma issued, and the next batch's fragments
// split into the other set while the tensor cores add it; the wait comes
// before that set is issued (no register of a pending product is written).
template <int NN, int KS, typename Frag>
__device__ __forceinline__ void product(float (&d)[NN / 2], uint32_t b, int half, int box,
                                        Frag frag) {
  constexpr int BATCH = KS < 4 ? KS : 4;
  constexpr int NB = KS / BATCH;
  static_assert(KS % BATCH == 0, "k-steps");
  uint32_t hi[2][BATCH][4], lo[2][BATCH][4];
  auto split = [&](int kb, uint32_t (&h)[BATCH][4], uint32_t (&l)[BATCH][4]) {
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      float v[4];
      frag(kb * BATCH + i, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], h[i][e], l[i][e]);
    }
    pin(h);
    pin(l);
  };
  split(0, hi[0], lo[0]);
#pragma unroll
  for (int kb = 0; kb < NB; ++kb) {
    pin(d);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int ks = kb * BATCH + i;
      const uint32_t at = b + (ks >> 2) * box + (ks & 3) * 32;
      const uint64_t bh = smem_desc(at), bl = smem_desc(at + half);
      wgmma_tf32<NN>(d, hi[kb & 1][i], bh, 1);
      wgmma_tf32<NN>(d, lo[kb & 1][i], bh, 1);
      wgmma_tf32<NN>(d, hi[kb & 1][i], bl, 1);
    }
    wgmma_commit();
    if (kb + 1 < NB) split(kb + 1, hi[(kb + 1) & 1], lo[(kb + 1) & 1]);
    wgmma_wait<0>();
    pin(d);
  }
}

// The product with B the rows [r0, r0 + NN) of OpTile T at `tile`.
template <typename T, int NN, int K, typename Frag>
__device__ __forceinline__ void product_from(float (&d)[NN / 2], uint32_t tile, int r0,
                                             Frag frag) {
  product<NN, K / 8>(d, tile + r0 * 128, T::HALF, T::BOX, frag);
}

// An m64nN accumulator's fragment as the A of k-step ks (the columns 8 ks to
// 8 ks + 7 of the accumulator are the k-step's K).
template <int NN>
__device__ __forceinline__ void acc_frag(const float (&a)[NN / 2], int ks, float (&v)[4]) {
  v[0] = a[4 * ks];
  v[1] = a[4 * ks + 2];
  v[2] = a[4 * ks + 1];
  v[3] = a[4 * ks + 3];
}

// A B tile from the Q x COLS rows get(t, k): every value a thread writes is
// read first (loads from the L2 in flight together), then split and put.
template <int COLS, typename Get, typename Put>
__device__ __forceinline__ void build_tile(int ctid, Get get, Put put) {
  constexpr int PER = Q * COLS / CTHREADS;
  constexpr int STEP = PER < 16 ? PER : 16;   // values in flight at once
  static_assert(Q * COLS % CTHREADS == 0 && PER % STEP == 0, "a tile's values a thread");
#pragma unroll
  for (int j0 = 0; j0 < PER; j0 += STEP) {
    float v[STEP];
#pragma unroll
    for (int j = 0; j < STEP; ++j) {
      const int i = ctid + (j0 + j) * CTHREADS;
      v[j] = get(i / COLS, i % COLS);
    }
#pragma unroll
    for (int j = 0; j < STEP; ++j) {
      const int i = ctid + (j0 + j) * CTHREADS;
      put(i / COLS, i % COLS, v[j]);
    }
  }
}

// The same for a tile written transposed (put(t, k, v) writes row k, K
// index t): a warp takes 8 x 8 blocks of (t, k), its lanes 8 columns k
// (8 rows of the tile: 8 swizzle phases) by t of one parity (4 positions
// within the 16-byte chunk), so that its stores hit 32 banks.
template <int COLS, typename Get, typename Put>
__device__ __forceinline__ void build_tile_t(int ctid, Get get, Put put) {
  constexpr int PER = Q * COLS / CTHREADS;
  constexpr int STEP = PER < 16 ? PER : 16;
  static_assert(COLS % 8 == 0 && PER % 2 == 0 && PER % STEP == 0, "a transposed tile's blocks");
  const int warp = ctid >> 5, lane = ctid & 31;
  auto at = [&](int j, int& t, int& k) {
    const int blk = warp + CTHREADS / 32 * (j >> 1);
    k = 8 * (blk % (COLS / 8)) + (lane & 7);
    t = 8 * (blk / (COLS / 8)) + 2 * (lane >> 3) + (j & 1);
  };
#pragma unroll
  for (int j0 = 0; j0 < PER; j0 += STEP) {
    float v[STEP];
#pragma unroll
    for (int j = 0; j < STEP; ++j) {
      int t, k;
      at(j0 + j, t, k);
      v[j] = get(t, k);
    }
#pragma unroll
    for (int j = 0; j < STEP; ++j) {
      int t, k;
      at(j0 + j, t, k);
      put(t, k, v[j]);
    }
  }
}

// The values other(t, col) (a float2: columns col, col + 1) that rows_out
// pairs with an m64nNN accumulator's elements, each read from a row in range
// (rows past `valid` read the last one, and go unused), all in flight at once.
template <int NN, typename Other>
__device__ __forceinline__ void load_pairs(float2 (&o)[NN / 8][2], int ra, int rb, int col0,
                                           int tq, int valid, Other other) {
#pragma unroll
  for (int j = 0; j < NN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      o[j][half] = other(min(half ? rb : ra, valid - 1), col0 + 8 * j + 2 * tq);
}

// An m64nNN accumulator's rows out: store(t, col, v0, v1) for the pair of
// columns col, col + 1 of row t (rows below `valid`), and the row's part of
// sum_col o . acc in fp64 into part[t] (o from load_pairs), summed over the
// row's four threads in a fixed order.
template <int NN, typename Store>
__device__ __forceinline__ void rows_out(const float (&acc)[NN / 2], const float2 (&o)[NN / 8][2],
                                         int ra, int rb, int col0, int tq, int valid, Store store,
                                         double* part) {
  double pa = 0.0, pb = 0.0;
#pragma unroll
  for (int j = 0; j < NN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? rb : ra;
      if (t < valid) {
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        store(t, col, v0, v1);
        const double d = (double)o[j][half].x * v0 + (double)o[j][half].y * v1;
        if (half) pb += d; else pa += d;
      }
    }
  }
  pa += __shfl_xor_sync(0xffffffffu, pa, 1);
  pa += __shfl_xor_sync(0xffffffffu, pa, 2);
  pb += __shfl_xor_sync(0xffffffffu, pb, 1);
  pb += __shfl_xor_sync(0xffffffffu, pb, 2);
  if (tq == 0) {
    if (ra < valid) part[ra] = pa;
    if (rb < valid) part[rb] = pb;
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CTHREADS) : "memory");
}

// The first consumer warp: the sub-chunk's inclusive cumsum of dt a (lane l
// holds rows l and 32 + l) into cum2 (log2 units), ecum = exp(cum), w =
// exp(tot - cum) (times dt where `with_dt`), and tot = exp(total).
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a, float* cum2, float* ecum,
                                             float* w, float* tot, bool with_dt, int lane) {
  float lo = dts[lane] * a, hi = dts[32 + lane] * a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float tl = __shfl_up_sync(0xffffffffu, lo, off);
    const float th = __shfl_up_sync(0xffffffffu, hi, off);
    if (lane >= off) {
      lo += tl;
      hi += th;
    }
  }
  hi += __shfl_sync(0xffffffffu, lo, 31);
  const float total = __shfl_sync(0xffffffffu, hi, 31);
  cum2[lane] = lo * LOG2E;
  cum2[32 + lane] = hi * LOG2E;
  ecum[lane] = expf(lo);
  ecum[32 + lane] = expf(hi);
  w[lane] = expf(total - lo) * (with_dt ? dts[lane] : 1.f);
  w[32 + lane] = expf(total - hi) * (with_dt ? dts[32 + lane] : 1.f);
  if (lane == 0) tot[0] = expf(total);
}

struct Strides {
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *init, *dy, *dfinal;
  float *dx, *ddt, *dA, *dB, *dC, *dinit, *dch, *dbh;
  double *fdot, *da_part, *parts;
  unsigned char* prep;
  int B, S, H, G;
  Strides st;
};

// The shared memory of a walk (bytes from a 1024-byte boundary): the ring
// (per stage x, then dy, P / 32 boxes each), the walk's three B operand tiles
// T0, T1, T2, then dts, cum2, ecum, w (Q floats each), tot, an fp64
// reduction of 8 and the ring's barriers.
template <int W, int P, int N>
struct Smem {
  static constexpr int RAW = P / 32 * RAW_BOX;  // a staged 64 x P tile
  // a stage: x then dy (the x walk: dy alone)
  static constexpr int DY_AT = W == X_WALK ? 0 : RAW;
  static constexpr int STAGE = DY_AT + RAW;
  // C_WALK: X rows (t, p), B^T (n, s), ST^T (n, p); B_WALK: dY rows (t', p),
  // C^T (n, t), R^T (n, p); X_WALK: C rows (t', n), dY^T (p, t'), R (p, n)
  using T0 = typename std::conditional<W == X_WALK, OpTile<Q, N>, OpTile<Q, P>>::type;
  using T1 = typename std::conditional<W == X_WALK, OpTile<P, Q>, OpTile<N, Q>>::type;
  using T2 = typename std::conditional<W == X_WALK, OpTile<P, N>, OpTile<N, P>>::type;
  static constexpr int T0_OFF = STAGES * STAGE;
  static constexpr int T1_OFF = T0_OFF + T0::BYTES;
  static constexpr int T2_OFF = T1_OFF + T1::BYTES;
  // the x walk's B rows (the A of B C^T and B R^T), as staged, one buffer
  static constexpr int BR_OFF = T2_OFF + T2::BYTES;
  static constexpr int V_OFF = BR_OFF + (W == X_WALK ? (N + 31) / 32 * RAW_BOX : 0);
  static constexpr int RED_OFF = V_OFF + 4 * Q * 4 + 16;
  static constexpr int BAR_OFF = RED_OFF + 8 * 8;  // the ring's barriers, then the tile's
  static constexpr int BYTES = BAR_OFF + 8 * (STAGES + 1) + SMEM_ALIGN;  // with the alignment slack
};

// Bytes of the prepared tiles of one (batch, group, sub-chunk): B^T and C^T
// (the c and b walks' K-major B of their products over the rows) and C (the
// x walk's B of B C^T), split, and B's rows as TMA would stage them (the
// x walk's A), in the layouts the walks' shared memory takes.
template <int N>
__host__ __device__ constexpr long long prep_bytes() {
  return 2LL * OpTile<N, Q>::BYTES + OpTile<Q, N>::BYTES + (N + 31) / 32 * RAW_BOX;
}

template <int N>
__device__ __forceinline__ long long prep_at(int b, int g, int c, int n_sub, int G) {
  return (((long long)b * G + g) * n_sub + c) * prep_bytes<N>();
}

// (0) grid (sub-chunks, G, B): a group's B^T, C^T and C tiles of a sub-chunk,
// once for all its heads and all three walks (rows past S are zeros).
template <int N>
__global__ void __launch_bounds__(CTHREADS) prep_kernel(const Args r) {
  using TT = OpTile<N, Q>;
  using TR = OpTile<Q, N>;
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_sub = gridDim.x;
  const int c0 = c * Q, valid = min(Q, r.S - c0);
  const Strides& st = r.st;
  const float* Bb = r.Bm + b * st.b_sb + g * st.b_sg;
  const float* Cb = r.Cm + b * st.c_sb + g * st.c_sg;
  unsigned char* out = r.prep + prep_at<N>(b, g, c, n_sub, r.G);
  auto brow = [&](int t) { return Bb + (c0 + min(t, valid - 1)) * st.b_ss; };
  auto crow = [&](int t) { return Cb + (c0 + min(t, valid - 1)) * st.c_ss; };
  const int tid = threadIdx.x;
  build_tile_t<N>(tid, [&](int s, int k) { return s < valid ? brow(s)[k] : 0.f; },
                  [&](int s, int k, float v) { TT::put(out, k, s, v); });
  build_tile_t<N>(tid, [&](int s, int k) { return s < valid ? crow(s)[k] : 0.f; },
                  [&](int s, int k, float v) { TT::put(out + TT::BYTES, k, s, v); });
  build_tile<N>(tid, [&](int s, int k) { return s < valid ? crow(s)[k] : 0.f; },
                [&](int s, int k, float v) { TR::put(out + 2 * TT::BYTES, s, k, v); });
  unsigned char* rows = out + 2 * TT::BYTES + TR::BYTES;
  build_tile<N>(tid, [&](int s, int k) { return s < valid ? brow(s)[k] : 0.f; },
                [&](int s, int k, float v) {
                  const int o = (k >> 5) * RAW_BOX + s * 128 + ((((k & 31) >> 2) ^ (s & 7)) << 4);
                  *reinterpret_cast<float*>(rows + o + ((k & 3) << 2)) = v;
                });
}

// One walk.  grid (H, B); x and dy through tensor maps of (B, S, H, P).
template <int W, int P, int N>
__device__ __forceinline__ void walk(const CUtensorMap& tm_x, const CUtensorMap& tm_dy,
                                     const Args& r) {
  using L = Smem<W, P, N>;
  using T0 = typename L::T0;
  using T1 = typename L::T1;
  using T2 = typename L::T2;
  constexpr bool REVERSE = W != C_WALK;
  constexpr int NH = N / CONSUMERS;             // C_WALK, B_WALK: a consumer's columns of N
  constexpr int PH = P / CONSUMERS;             // X_WALK: a consumer's columns of P
  constexpr int MB = N > 64 ? N / 64 : 1;       // X_WALK: 64-row blocks of R^T

  extern __shared__ unsigned char smem_walk[];
  const uint32_t s0 = smem_addr(smem_walk);
  const uint32_t base = (s0 + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  unsigned char* const sm = smem_walk + (base - s0);
  float* const dts = reinterpret_cast<float*>(sm + L::V_OFF);
  float* const cum2 = dts + Q;
  float* const ecum = cum2 + Q;
  float* const w = ecum + Q;
  float* const tot = w + Q;
  double* const red = reinterpret_cast<double*>(sm + L::RED_OFF);
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int st) { return bars + 8 * st; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int H = r.H, S = r.S, g = h / (H / r.G);
  const int n_sub = (S + Q - 1) / Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the x and dy rows of the n-th sub-chunk of the walk into its stage, by
  // thread 0 (TMA: one thread asks, the copy engine fills the stage)
  auto issue = [&](int n) {
    if (threadIdx.x != 0 || n >= n_sub) return;
    const int c = REVERSE ? n_sub - 1 - n : n;
    const int st = n % STAGES;
    const uint32_t dst = base + st * L::STAGE;
    mbar_expect_tx(full(st), L::STAGE);
#pragma unroll
    for (int cb = 0; cb < P / 32; ++cb) {
      if (W != X_WALK) tma_load(dst + cb * RAW_BOX, tm_x, full(st), cb * 32, h, c * Q, b);
      tma_load(dst + L::DY_AT + cb * RAW_BOX, tm_dy, full(st), cb * 32, h, c * Q, b);
    }
  };
  // the prepared B or C tile of the n-th sub-chunk (prep_kernel) into T1
  // (the c and b walks: B^T, C^T) or T0 (the x walk: C), by thread 0
  const uint32_t tbar = bars + 8 * STAGES;
  auto issue_tile = [&](int n) {
    if (threadIdx.x != 0 || n >= n_sub) return;
    const int c = REVERSE ? n_sub - 1 - n : n;
    const unsigned char* src = r.prep + prep_at<N>(b, g, c, n_sub, r.G);
    if constexpr (W == X_WALK) {
      constexpr int RB = (N + 31) / 32 * RAW_BOX;
      mbar_expect_tx(tbar, T0::BYTES + RB);
      bulk_load(base + L::T0_OFF, src + 2 * OpTile<N, Q>::BYTES, T0::BYTES, tbar);
      bulk_load(base + L::BR_OFF, src + 2 * OpTile<N, Q>::BYTES + T0::BYTES, RB, tbar);
    } else {
      mbar_expect_tx(tbar, T1::BYTES);
      bulk_load(base + L::T1_OFF, src + (W == B_WALK ? T1::BYTES : 0), T1::BYTES, tbar);
    }
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st <= STAGES; ++st) mbar_init(bars + 8 * st, 1);
    mbar_init_fence();
  }
  __syncthreads();
  for (int n = 0; n < STAGES; ++n) issue(n);
  issue_tile(0);

  const int ctid = threadIdx.x;
  const int cw = warp_uniform(warp / 4);      // this consumer warpgroup
  const int wl = warp & 3;                     // its warp
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = 16 * wl + gq;               // the accumulator rows row0 and row0 + 8
  const float a = r.A[h];
  const Strides& st = r.st;
  const float* dtb = r.dt + b * st.dt_sb + h * st.dt_sh;
  const float* Bb = r.Bm + b * st.b_sb + g * st.b_sg;
  const float* Cb = r.Cm + b * st.c_sb + g * st.c_sg;
  const long long st_base = ((long long)b * H + h) * P * N;
  const long long row_base = (long long)b * S;  // (b, t) rows of (B, S, ...)
  unsigned char* const t0 = sm + L::T0_OFF;
  unsigned char* const t1 = sm + L::T1_OFF;
  unsigned char* const t2 = sm + L::T2_OFF;
  const uint32_t t0a = base + L::T0_OFF, t1a = base + L::T1_OFF, t2a = base + L::T2_OFF;
  const float* state_in = W == C_WALK ? r.init : r.dfinal;
  double* const parts_c = r.parts + (((long long)(2 * W + cw) * r.B + b) * H + h) * S;

  // this consumer's part of the running state: C_WALK ST (P x NH, rows p),
  // B_WALK R (P x NH), X_WALK R^T (N x PH, MB blocks of 64 rows n), kept
  // between sub-chunks in the state's B tile T2 as its hi and lo parts (their
  // sum is the state to 2^-22 of itself) and in registers only around its
  // update; rows past P (or N) are zeros
  constexpr int SREGS = W == X_WALK ? MB * PH / 2 : NH / 2;
  // (row, column) of state element i of this thread: C/B walks (p, n), X (n, p)
  auto s_at = [&](int i, int& pr, int& nc) {
    if constexpr (W == X_WALK) {
      const int mb = i / (PH / 2), j = i % (PH / 2);
      pr = 64 * mb + row0 + 8 * ((j & 3) >> 1);           // n
      nc = cw * PH + 8 * (j >> 2) + 2 * tq + (j & 1);     // p
    } else {
      pr = row0 + 8 * ((i & 3) >> 1);                      // p
      nc = cw * NH + 8 * (i >> 2) + 2 * tq + (i & 1);     // n
    }
  };
  // element i is T2's (nc, pr): R (p, n) in the x walk, ST^T or R^T (n, p)
  auto in_state = [&](int pr) { return W == X_WALK ? pr < N : pr < P; };
  auto write_state_tile = [&](const float (&v)[SREGS]) {
#pragma unroll
    for (int i = 0; i < SREGS; ++i) {
      int pr, nc;
      s_at(i, pr, nc);
      if (in_state(pr)) T2::put(t2, nc, pr, v[i]);
    }
  };
  auto read_state_tile = [&](float (&v)[SREGS]) {
#pragma unroll
    for (int i = 0; i < SREGS; ++i) {
      int pr, nc;
      s_at(i, pr, nc);
      const unsigned char* e = t2 + T2::off(nc, pr);
      v[i] = in_state(pr) ? *reinterpret_cast<const float*>(e) +
                                *reinterpret_cast<const float*>(e + T2::HALF)
                          : 0.f;
    }
  };
  {
    float s_in[SREGS];
#pragma unroll
    for (int i = 0; i < SREGS; ++i) {
      int pr, nc;
      s_at(i, pr, nc);
      const int p = W == X_WALK ? nc : pr, n = W == X_WALK ? pr : nc;
      s_in[i] = state_in != nullptr && p < P && n < N
                    ? state_in[st_base + (long long)p * N + n] : 0.f;
    }
    write_state_tile(s_in);
    fence_proxy_async();
  }

  // dt of row ctid of the n-th sub-chunk of the walk (0 past S), read one
  // sub-chunk ahead of its use
  auto dt_of = [&](int n) {
    if (ctid >= Q || n >= n_sub) return 0.f;
    const int t = (REVERSE ? n_sub - 1 - n : n) * Q + ctid;
    return t < S ? dtb[t * st.dt_ss] : 0.f;
  };
  float dt_next = dt_of(0);

  for (int n = 0; n < n_sub; ++n) {
    const int c = REVERSE ? n_sub - 1 - n : n;
    const float dt_now = dt_next;
    dt_next = dt_of(n + 1);
    float sacc[SREGS];  // the state after this sub-chunk, from its update on
    const int c0 = c * Q;
    const int valid = min(Q, S - c0);
    const int stg = n % STAGES;
    // B's and C's row t of the sub-chunk, the last row below S past it (every
    // load in range, none behind a branch)
    auto brow = [&](int t) { return Bb + (c0 + min(t, valid - 1)) * st.b_ss; };
    auto crow = [&](int t) { return Cb + (c0 + min(t, valid - 1)) * st.c_ss; };
    // rows of the sub-chunk this thread's accumulators hold
    const int ra = row0, rb = row0 + 8;
    // the c walk's C and the b walk's B for its epilogue, from the L2 (read
    // once the cumsum is under way, in flight through the decays)
    float2 pre[W == X_WALK ? 1 : NH / 8][2];
    const unsigned char* xs = sm + stg * L::STAGE;
    const unsigned char* dys = xs + L::DY_AT;
    const unsigned char* bs = sm + L::BR_OFF;  // the x walk's B rows
    mbar_wait(full(stg), (n / STAGES) & 1);

    // the head's B tile of this sub-chunk from its staged rows, split as it
    // is written, and dt; the group's (B or C) arrives by the bulk copy
    if constexpr (W == C_WALK) {
      build_tile<P>(ctid, [&](int t, int k) { return raw(xs, t, k); },
                    [&](int t, int k, float v) { T0::put(t0, t, k, v); });
    } else if constexpr (W == B_WALK) {
      build_tile<P>(ctid, [&](int t, int k) { return raw(dys, t, k); },
                    [&](int t, int k, float v) { T0::put(t0, t, k, v); });
    } else {
      build_tile_t<P>(ctid, [&](int t, int k) { return raw(dys, t, k); },
                      [&](int t, int k, float v) { T1::put(t1, k, t, v); });
    }
    if (ctid < Q) dts[ctid] = dt_now;
    fence_proxy_async();
    mbar_wait(tbar, n & 1);
    consumer_sync();  // the tiles and dts are written
    if (ctid < 32) chunk_cumsum(dts, a, cum2, ecum, w, tot, W == C_WALK, lane);

    float sc[32];   // the 64 x 64 scores
    zero(sc);
    if constexpr (W == C_WALK) {
      // M = dY X^T; dC^h = dY ST (then scaled by exp(cum))
      float acc[NH / 2];
      zero(acc);
      product_from<T0, 64, P>(sc, t0a, 0, [&](int ks, float (&v)[4]) {
        const int k = 8 * ks + 2 * tq;
        v[0] = raw(dys, ra, k);
        v[1] = raw(dys, rb, k);
        v[2] = raw(dys, ra, k + 1);
        v[3] = raw(dys, rb, k + 1);
      });
      product_from<T2, NH, P>(acc, t2a, cw * NH, [&](int ks, float (&v)[4]) {
        const int k = 8 * ks + 2 * tq;
        v[0] = raw(dys, ra, k);
        v[1] = raw(dys, rb, k);
        v[2] = raw(dys, ra, k + 1);
        v[3] = raw(dys, rb, k + 1);
      });
      consumer_sync();  // cum2, ecum, w and tot are ready
      const float ea = ecum[ra], eb = ecum[rb];
      load_pairs<NH>(pre, ra, rb, cw * NH, tq, valid,
                     [&](int t, int col) {
                       return *reinterpret_cast<const float2*>(crow(t) + col);
                     });
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) acc[i] *= (i & 2) ? eb : ea;
      // ML[t][s] = dt_s L[t, s] M[t][s], zero above the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = (i & 2) ? rb : ra, s = 8 * (i >> 2) + 2 * tq + (i & 1);
        sc[i] = s <= t ? sc[i] * dts[s] * fast_exp2(cum2[t] - cum2[s]) : 0.f;
      }
      product_from<T1, NH, Q>(acc, t1a, cw * NH,
                              [&](int ks, float (&v)[4]) { acc_frag<64>(sc, ks, v); });
      // dC^h out, and this consumer's part of C_t . dC^h_t
      rows_out<NH>(acc, pre, ra, rb, cw * NH, tq, valid,
                   [&](int t, int col, float v0, float v1) {
                     *reinterpret_cast<float2*>(r.dch + ((row_base + c0 + t) * H + h) * N + col) =
                         make_float2(v0, v1);
                   },
                   parts_c + c0);
      // ST = exp(tot) ST + X^T diag(dt w) B
      const float e = tot[0];
      read_state_tile(sacc);
#pragma unroll
      for (int i = 0; i < SREGS; ++i) sacc[i] *= e;
      product_from<T1, NH, Q>(sacc, t1a, cw * NH, [&](int ks, float (&v)[4]) {
        const int k = 8 * ks + 2 * tq;
        const float w0 = w[k], w1 = w[k + 1];
        v[0] = ra < P ? raw(xs, k, ra) * w0 : 0.f;
        v[1] = rb < P ? raw(xs, k, rb) * w0 : 0.f;
        v[2] = ra < P ? raw(xs, k + 1, ra) * w1 : 0.f;
        v[3] = rb < P ? raw(xs, k + 1, rb) * w1 : 0.f;
      });
    } else if constexpr (W == B_WALK) {
      // M2 = X dY^T; dB^h = X R (then scaled by w dt)
      float acc[NH / 2];
      zero(acc);
      product_from<T0, 64, P>(sc, t0a, 0, [&](int ks, float (&v)[4]) {
        const int k = 8 * ks + 2 * tq;
        v[0] = raw(xs, ra, k);
        v[1] = raw(xs, rb, k);
        v[2] = raw(xs, ra, k + 1);
        v[3] = raw(xs, rb, k + 1);
      });
      product_from<T2, NH, P>(acc, t2a, cw * NH, [&](int ks, float (&v)[4]) {
        const int k = 8 * ks + 2 * tq;
        v[0] = raw(xs, ra, k);
        v[1] = raw(xs, rb, k);
        v[2] = raw(xs, ra, k + 1);
        v[3] = raw(xs, rb, k + 1);
      });
      consumer_sync();  // cum2, ecum, w and tot are ready
      const float fa = w[ra] * dts[ra], fb = w[rb] * dts[rb];
      load_pairs<NH>(pre, ra, rb, cw * NH, tq, valid,
                     [&](int t, int col) {
                       return *reinterpret_cast<const float2*>(brow(t) + col);
                     });
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) acc[i] *= (i & 2) ? fb : fa;
      // ML^T[t][t'] = dt_t L[t', t] M2[t][t'], zero below the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = (i & 2) ? rb : ra, tp = 8 * (i >> 2) + 2 * tq + (i & 1);
        sc[i] = tp >= t ? sc[i] * dts[t] * fast_exp2(cum2[tp] - cum2[t]) : 0.f;
      }
      product_from<T1, NH, Q>(acc, t1a, cw * NH,
                              [&](int ks, float (&v)[4]) { acc_frag<64>(sc, ks, v); });
      // dB^h out, and this consumer's part of B_t . dB^h_t
      rows_out<NH>(acc, pre, ra, rb, cw * NH, tq, valid,
                   [&](int t, int col, float v0, float v1) {
                     *reinterpret_cast<float2*>(r.dbh + ((row_base + c0 + t) * H + h) * N + col) =
                         make_float2(v0, v1);
                   },
                   parts_c + c0);
      // R = exp(tot) R + dY^T diag(exp(cum)) C
      const float e = tot[0];
      read_state_tile(sacc);
#pragma unroll
      for (int i = 0; i < SREGS; ++i) sacc[i] *= e;
      product_from<T1, NH, Q>(sacc, t1a, cw * NH, [&](int ks, float (&v)[4]) {
        const int k = 8 * ks + 2 * tq;
        const float e0 = ecum[k], e1 = ecum[k + 1];
        v[0] = ra < P ? raw(dys, k, ra) * e0 : 0.f;
        v[1] = rb < P ? raw(dys, k, rb) * e0 : 0.f;
        v[2] = ra < P ? raw(dys, k + 1, ra) * e1 : 0.f;
        v[3] = rb < P ? raw(dys, k + 1, rb) * e1 : 0.f;
      });
    } else {
      // S2 = B C^T; dXD = B R^T (then scaled by w)
      float acc[PH / 2];
      zero(acc);
      auto b_frag = [&](int ks, float (&v)[4]) {
        const int k = 8 * ks + 2 * tq;
        v[0] = raw(bs, ra, k);
        v[1] = raw(bs, rb, k);
        v[2] = raw(bs, ra, k + 1);
        v[3] = raw(bs, rb, k + 1);
      };
      product_from<T0, 64, N>(sc, t0a, 0, b_frag);
      product_from<T2, PH, N>(acc, t2a, cw * PH, b_frag);
      consumer_sync();  // cum2, ecum, w and tot are ready
      const float fa = w[ra], fb = w[rb];
      // x for dXD . x, from the L2 (the x walk stages no x)
      const float* xb = r.x + b * st.x_sb + h * st.x_sh;
      float2 xv[PH / 8][2];
      load_pairs<PH>(xv, ra, rb, cw * PH, tq, valid, [&](int t, int col) {
        return *reinterpret_cast<const float2*>(xb + (c0 + t) * st.x_ss + col);
      });
#pragma unroll
      for (int i = 0; i < PH / 2; ++i) acc[i] *= (i & 2) ? fb : fa;
      // SL^T[t][t'] = L[t', t] S2[t][t'], zero below the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = (i & 2) ? rb : ra, tp = 8 * (i >> 2) + 2 * tq + (i & 1);
        sc[i] = tp >= t ? sc[i] * fast_exp2(cum2[tp] - cum2[t]) : 0.f;
      }
      product_from<T1, PH, Q>(acc, t1a, cw * PH,
                              [&](int ks, float (&v)[4]) { acc_frag<64>(sc, ks, v); });
      // dx = dXD dt, and this consumer's part of dXD_t . x_t
      rows_out<PH>(acc, xv, ra, rb, cw * PH, tq, valid,
                   [&](int t, int col, float v0, float v1) {
                     const float d = dts[t];
                     *reinterpret_cast<float2*>(r.dx + ((row_base + c0 + t) * H + h) * P + col) =
                         make_float2(v0 * d, v1 * d);
                   },
                   parts_c + c0);
      // R^T = exp(tot) R^T + C^T diag(exp(cum)) dY, 64 rows of N at a time; C
      // from T0 (hi + lo: C to 2^-22 of itself), rows past S zero there
      auto c_tile = [&](int t, int nn) {
        const unsigned char* e = t0 + T0::off(t, nn);
        return *reinterpret_cast<const float*>(e) + *reinterpret_cast<const float*>(e + T0::HALF);
      };
      const float e = tot[0];
      read_state_tile(sacc);
#pragma unroll
      for (int i = 0; i < SREGS; ++i) sacc[i] *= e;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        float part[PH / 2];
#pragma unroll
        for (int i = 0; i < PH / 2; ++i) part[i] = sacc[mb * (PH / 2) + i];
        const int na = 64 * mb + ra, nb = 64 * mb + rb;
        product_from<T1, PH, Q>(part, t1a, cw * PH, [&](int ks, float (&v)[4]) {
          const int k = 8 * ks + 2 * tq;
          // columns past N are zeros
          const float e0 = ecum[k], e1 = ecum[k + 1];
          const int ca = min(na, N - 1), cb = min(nb, N - 1);
          const float fa = na < N ? 1.f : 0.f, fb = nb < N ? 1.f : 0.f;
          v[0] = c_tile(k, ca) * (e0 * fa);
          v[1] = c_tile(k, cb) * (e0 * fb);
          v[2] = c_tile(k + 1, ca) * (e1 * fa);
          v[3] = c_tile(k + 1, cb) * (e1 * fb);
        });
#pragma unroll
        for (int i = 0; i < PH / 2; ++i) sacc[mb * (PH / 2) + i] = part[i];
      }
    }
    consumer_sync();  // every read of the staged rows and the B tiles is done
    issue(n + STAGES);  // into the stage just read
    issue_tile(n + 1);
    write_state_tile(sacc);
    fence_proxy_async();
  }
  float sacc[SREGS];  // the final state: this thread wrote each element it reads
  read_state_tile(sacc);

  if constexpr (W == C_WALK) {
    // <dFinal, final state>, summed in a fixed order
    double part = 0.0;
    if (r.dfinal != nullptr) {
#pragma unroll
      for (int i = 0; i < SREGS; ++i) {
        int pr, nc;
        s_at(i, pr, nc);
        if (pr < P) part += (double)r.dfinal[st_base + (long long)pr * N + nc] * sacc[i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red[ctid / 32] = part;
    consumer_sync();
    if (ctid == 0) {
      double s = 0.0;
      for (int i = 0; i < CTHREADS / 32; ++i) s += red[i];
      r.fdot[b * H + h] = s;
    }
  } else if constexpr (W == B_WALK) {
    if (r.dinit != nullptr) {
#pragma unroll
      for (int i = 0; i < SREGS; ++i) {
        int pr, nc;
        s_at(i, pr, nc);
        if (pr < P) r.dinit[st_base + (long long)pr * N + nc] = sacc[i];
      }
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(CTHREADS, 1)
c_walk_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
              const Args r) {
  walk<C_WALK, P, N>(tm_x, tm_dy, r);
}

template <int P, int N>
__global__ void __launch_bounds__(CTHREADS, 1)
b_walk_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
              const Args r) {
  walk<B_WALK, P, N>(tm_x, tm_dy, r);
}

template <int P, int N>
__global__ void __launch_bounds__(CTHREADS, 1)
x_walk_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
              const Args r) {
  walk<X_WALK, P, N>(tm_x, tm_dy, r);
}

// (4) a warp per (b, h): da_t = <dFinal, final state> + the sum of dcum over
// rows t' >= t, walked from the last 32 rows to the first with the carry;
// dcum = C . dC^h - B . dB^h from the walks' partials, dxdx = dXD . x.  ddt =
// dxdx + da A; da_part[b H + h] = the sum of da dt (fp64, a fixed order).
__global__ void scan_kernel(const Args r) {
  const int item = blockIdx.x * SCAN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int H = r.H, S = r.S;
  if (item >= r.B * H) return;
  const int b = item / H, h = item % H;
  const long long plane = (long long)r.B * H * S;  // one partial's (B, H, S)
  const double* pc = r.parts + (long long)item * S;
  const float a = r.A[h];
  const float* dtb = r.dt + b * r.st.dt_sb + h * r.st.dt_sh;
  double carry = r.fdot[item], da_dt = 0.0;
  for (int t0 = (S - 1) / 32 * 32; t0 >= 0; t0 -= 32) {
    const int t = t0 + lane;
    double v = 0.0, dxdx = 0.0;
    float d = 0.f;
    if (t < S) {
      v = (pc[t] + pc[plane + t]) - (pc[2 * plane + t] + pc[3 * plane + t]);
      dxdx = pc[4 * plane + t] + pc[5 * plane + t];
      d = dtb[t * r.st.dt_ss];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < 32) v += u;
    }
    v += carry;
    carry = __shfl_sync(0xffffffffu, v, 0);
    if (t < S) {
      r.ddt[((long long)b * S + t) * H + h] = (float)(v * a + dxdx);
      da_dt += v * d;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
  if (lane == 0) r.da_part[item] = da_dt;
}

// (5) one thread an element of dB, then of dC (B, S, G, N), then of dA (H,).
__global__ void head_sum_kernel(const float* __restrict__ dbh, const float* __restrict__ dch,
                                const double* __restrict__ da_part, float* __restrict__ dB,
                                float* __restrict__ dC, float* __restrict__ dA, int Bsz, int S,
                                int H, int G, int N) {
  const long long n_out = (long long)Bsz * S * G * N;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int rep = H / G;
  if (i < 2 * n_out) {
    const bool is_c = i >= n_out;
    if (is_c) i -= n_out;
    const int n = (int)(i % N);
    const long long r = i / N;
    const int g = (int)(r % G);
    const long long bs = r / G;  // b S + t
    const float* src = (is_c ? dch : dbh) + (bs * H + (long long)g * rep) * N + n;
    float s = 0.f;
    for (int k = 0; k < rep; ++k) s += src[(long long)k * N];
    (is_c ? dC : dB)[i] = s;
  } else if (i < 2 * n_out + H) {
    const int h = (int)(i - 2 * n_out);
    double s = 0.0;
    for (int b = 0; b < Bsz; ++b) s += da_part[(long long)b * H + h];
    dA[h] = (float)s;
  }
}

template <int P, int N>
int launch(const Args& r, cudaStream_t stream) {
  static_assert(Smem<C_WALK, P, N>::BYTES <= SMEM_LIMIT &&
                    Smem<B_WALK, P, N>::BYTES <= SMEM_LIMIT &&
                    Smem<X_WALK, P, N>::BYTES <= SMEM_LIMIT,
                "a walk block's shared memory");
  CUtensorMap tm_x, tm_dy;
  const Strides& st = r.st;
  if (!tensor_map_f32(&tm_x, r.x, P, r.H, r.S, r.B, st.x_sh, st.x_ss, st.x_sb, Q) ||
      !tensor_map_f32(&tm_dy, r.dy, P, r.H, r.S, r.B, P, (long long)r.H * P,
                      (long long)r.S * r.H * P, Q))
    return -1;
  const void* kernels[3] = {(const void*)c_walk_kernel<P, N>, (const void*)b_walk_kernel<P, N>,
                            (const void*)x_walk_kernel<P, N>};
  const int smem[3] = {Smem<C_WALK, P, N>::BYTES, Smem<B_WALK, P, N>::BYTES,
                       Smem<X_WALK, P, N>::BYTES};
  for (int k = 0; k < 3; ++k) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[k]);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_sub = (r.S + Q - 1) / Q;
  prep_kernel<N><<<dim3(n_sub, r.G, r.B), CTHREADS, 0, stream>>>(r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(r.H, r.B);
  c_walk_kernel<P, N><<<grid, CTHREADS, smem[0], stream>>>(tm_x, tm_dy, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  b_walk_kernel<P, N><<<grid, CTHREADS, smem[1], stream>>>(tm_x, tm_dy, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  x_walk_kernel<P, N><<<grid, CTHREADS, smem[2], stream>>>(tm_x, tm_dy, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int scan_blocks = (r.B * r.H + SCAN_WARPS - 1) / SCAN_WARPS;
  scan_kernel<<<scan_blocks, 32 * SCAN_WARPS, 0, stream>>>(r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = 2LL * r.B * r.S * r.G * N + r.H;
  head_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      r.dbh, r.dch, r.da_part, r.dB, r.dC, r.dA, r.B, r.S, r.H, r.G, N);
  return (int)cudaGetLastError();
}

template <int P>
int launch_n(int N, const Args& r, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(r, stream);
    case 32:
      return launch<P, 32>(r, stream);
    case 64:
      return launch<P, 64>(r, stream);
    case 128:
      return launch<P, 128>(r, stream);
    default:
      return -1;
  }
}

}  // namespace

// fp32 throughout.  x, dt, B and C are read through `strides` (in elements:
// batch, row and head strides of x, then of dt, then batch, row and group
// strides of B and of C; the last dimension of x, B and C has stride 1, x's
// other strides are multiples of 4 and its rows start on 16 bytes).  dy is
// contiguous (B, S, H, P); init, dfinal and dinit contiguous (B, H, P, N),
// each may be null (zeros; dinit: not written).  Outputs dx (B, S, H, P), ddt
// (B, S, H), dA (H,), dB and dC (B, S, G, N), contiguous.  Scratch: dch and
// dbh (B, S, H, N) fp32, fdot and da_part (B, H) fp64, parts (6, B, H, S)
// fp64, prep B G ceil(S / 64) prep_bytes<N>() bytes (16-byte aligned).
// Returns 0, a cudaError_t of a launch, or -1 for arguments the kernels do
// not take.
extern "C" int dco_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, const void* init, const void* dy,
                                const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                                void* dC, void* dinit, void* dch, void* dbh, void* fdot,
                                void* da_part, void* parts, void* prep, int B, int S, int H,
                                int G, int P, int N, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -1;
  if (B > 65535 || H > 65535) return -1;
  Args r{static_cast<const float*>(x),      static_cast<const float*>(dt),
         static_cast<const float*>(A),      static_cast<const float*>(Bm),
         static_cast<const float*>(Cm),     static_cast<const float*>(init),
         static_cast<const float*>(dy),     static_cast<const float*>(dfinal),
         static_cast<float*>(dx),           static_cast<float*>(ddt),
         static_cast<float*>(dA),           static_cast<float*>(dB),
         static_cast<float*>(dC),           static_cast<float*>(dinit),
         static_cast<float*>(dch),          static_cast<float*>(dbh),
         static_cast<double*>(fdot),        static_cast<double*>(da_part),
         static_cast<double*>(parts),       static_cast<unsigned char*>(prep),
         B, S, H, G,
         {strides[0], strides[1], strides[2], strides[3], strides[4], strides[5], strides[6],
          strides[7], strides[8], strides[9], strides[10], strides[11]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 32) return launch_n<32>(N, r, s);
  if (P == 64) return launch_n<64>(N, r, s);
  return -1;
}
