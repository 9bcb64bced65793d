// Decode attention for Hopper (sm_90a): one query token per sequence against a
// KV cache, in one launch.
//
// Replaces the Pallas-TPU kernel `decode_kernel`
// (src/repro/kernels/decode_attention/kernel.py, built by build_decode_call,
// wrapped by ops.py::decode_attention).
//
// Bound on an H100: bytes.  Every live cached K and V row (below cache_len and,
// with a window, among the last `window`) is read once
// (2 * B * G * live rows * D * itemsize bytes) and each row feeds only
// `group = H / G` dot products, far below the card's operations-per-byte
// ridge, so the least time is those bytes over the memory rate.  The rate
// needs tens of KB in flight on every SM all the time, and the work is
// ragged: one sequence may hold ten times the rows of another, and on the
// serving path most rows of a call have cache_len 0, so that one call's time
// is mostly a chain of latencies (launch, q, the first rows, the merge).
//
// The bf16 kernel (decode_wgmma_kernel), the one every model serves through,
// is built from Hopper's own instructions: TMA, mbarriers, wgmma and
// thread-block clusters, in inline PTX (hopper.cuh).
//  * A GQA group's query heads are the rows of one 64-row wgmma tile (zeros
//    past the group; at most 64 heads a KV head), as the reference's kernel
//    makes them the rows of one MXU operand: each cached K/V row enters
//    shared memory once, whatever the group, and S = Q K^T is m64n64k16
//    products with both sides K-major in the 128-byte swizzle TMA writes.
//    A group of up to 8 heads is staged in one 8-row swizzle atom a box,
//    which all eight 8-row groups of the tile read (the descriptor's stride
//    0): 2 KB of q at D 128, not 16.  The scores are scaled in fp32 on the
//    accumulator (into log2 units; with a softcap, tanh(s * scale / cap) *
//    cap * log2(e)), not by rounding a scaled q to bf16; rows past the
//    sequence's end get -1e30.  The online max and rescale run once a
//    64-row tile on the fragment's rows (4 lanes a row, 2 shuffles); a warp
//    whose rows all lie past the group skips them.  P, rounded to bf16 as
//    the reference rounds it (p.astype(v_ref.dtype)), is the register A
//    operand of O += P V, with V MN-major from shared memory; O sums in
//    fp32.
//  * Loads by TMA.  A block is one warpgroup; its first thread issues every
//    copy: q's box (the group's heads, 3-d over (D, H, B)), in block 0 of a
//    (batch row, KV head) before the length is read (a later block asks for
//    q with its first tiles, and one with no rows asks for nothing), then
//    64-row K and V boxes over the cache's own 4-d (column, KV head, row,
//    batch) layout through its strides, into a ring of w_stages<D>() stages
//    (a grid of no more blocks than SMs: w_deep_stages) with a barrier for
//    K, one for V and one that frees the stage, each stage refilled as the
//    warpgroup frees it.  A producer warpgroup would hold 128 threads'
//    registers and a slot of the SM for one lane's work: without it a block
//    is 67 KB and 168 registers a thread at D 128, three blocks an SM, which
//    the cluster map below needs (half as many clusters again run at once).
//    No transposed copy is made, and
//    a view of a larger pool works as it is.  A box starts at any row: rows
//    below the window's first live row are never requested, rows past S
//    arrive as zeros, and the rows of a sequence's last tile past its length
//    (which may hold anything, and 0 * inf is no 0) are zeroed in the V tile
//    before the product reads them.  At D 112 a row is two 64-column boxes,
//    the second zero past column 112; at D 256 four, one block an SM.
//  * Work map.  grid = (C, G, B): the C blocks ("units", at most 8, one
//    thread-block cluster) of a (batch row, KV head) cut its live tiles
//    evenly, so a long sequence is read by up to C SMs at once.  C comes
//    from the shapes alone (the host never reads cache_len: no
//    synchronisation, and a CUDA graph can replay the call): the most whose
//    B * G clusters the card runs at once (dco_decode_clusters asks it), so
//    that a call with every slot live runs in one wave; but at least 2, and
//    enough that a sequence as long as the cache gives no block more than 8
//    tiles (ops.units_for).  The rows each block takes are cut on the card,
//    per call, from all the call's lengths (span_of), as the fp32 kernel's R
//    is: units of at least R tiles, R the least that keeps the call's blocks
//    with rows within what the card holds at once.  So a serving call with
//    one live position group spreads each of its sequences over C blocks,
//    and one with every slot live gives each block a few more tiles.  The
//    caller may fix the rows of a unit instead (`rows`): block r then takes
//    units r, r + C, ..., one online softmax over all its tiles.
//  * The merge around the rows.  A (batch row, KV head) whose live rows one
//    block holds is written by that block.  Otherwise its C blocks are one
//    thread-block cluster: each block's partial (m, l, acc of the group's
//    rows) stays in its shared memory, and after the cluster's barrier each
//    block merges its share of the output's elements from all the partials
//    through distributed shared memory, every block's loads in flight at
//    once: no scratch, no counter, nothing to reset between graph replays.
//    (A merge through global scratch and a counter, the last block merging,
//    was up to 13% slower at the GQA serving calls on the same map and up
//    to 12% faster where many MHA clusters queue: PERF.md.)
//
// The fp32 kernel (decode_kernel) keeps fp32 multiply-adds (its 2e-5
// tolerance rules out TF32), per-lane cp.async and the per-call R:
//  * Work is cut by rows, not by count.  A work item is a unit of R rows (a
//    multiple of STEP_ROWS) of one (batch, KV head, block of HPB query heads),
//    so the longest sequence takes ceil(len / R) items of at most R rows each
//    instead of setting the time for everyone.  Only live units are items: a
//    1-D grid of at most ITEMS_PER_SM blocks an SM walks them in order (block
//    i takes items i, i + gridDim.x, ...), and every block finds the place of
//    its item from cache_len alone.  The grid is sized from shapes (the cache's
//    capacity S bounds the items), so the host never reads cache_len (no
//    synchronisation, nothing that a CUDA graph could not replay), and the busy
//    blocks are the first ones dispatched: a serving call with one live row of
//    eight has no wave of empty blocks to get through.  An SM can hold
//    BLOCKS_PER_SM blocks (shared memory, __launch_bounds__).
//  * R is chosen per call on the device (rows_for): every block sums the
//    call's lengths and takes the least R, at least MIN_ROWS, that gives at
//    most ITEMS_PER_SM items an SM, so that no SM holds a third block of a
//    long sequence while others idle, and each block one item at most.  A
//    sequence's rows are then cut evenly into its ceil(len / R) units.  Short
//    sequences stay one unit (a merge costs more than a few steps: at one
//    live row of 97, one unit beat four), long ones are cut into as many
//    units as keep the SMs evenly loaded, each streamed through the ring.
//    The grid is `target` blocks, one item each when R is chosen.  (With R
//    fixed at 128, [2048] x 8 took several items a block and lost to the
//    two-launch kernel this one replaces; PERF.md.)  The caller may fix R
//    instead, which tests use.
//  * Loads stay in flight.  Each lane stages its own 16-byte chunks of K and V
//    with cp.async into a ring of up to MAX_STAGES steps in shared memory
//    (RING_BYTES a block).  A lane reads back only what it copied itself,
//    so the ring needs no barrier: cp.async.wait_group alone orders it.
//  * A lane group of 8 lanes scores ROWS_PER_GROUP rows a step for all HPB query
//    heads that share the KV head (16 bytes a lane along D, fp32 products, a
//    3-shuffle reduction), then takes one max and one rescale per step, with
//    exp2 on scores scaled by log2(e).  Rows at or past cache_len are never
//    loaded (zero-filled, masked) and a sequence with cache_len 0 yields zeros.
//  * One launch.  A sequence that fits one unit is written to `out` by that
//    unit.  Otherwise each unit writes its partial (m, l, acc) to scratch, and
//    the last unit of its (batch, head block) to finish, found with a counter
//    (__threadfence before the atomic), merges the partials and writes `out`.
//    It also sets the counter back to 0, so that the next call, or a replay of
//    a captured graph, finds it there; the wrapper zeroes the counters once,
//    when it allocates them for a (device, stream).  A launch that faults
//    leaves counters set, and the context with them: a new context needs
//    them zeroed anew.  The merge keeps MERGE_LOADS float4 loads of partials
//    in flight a thread.
//  * A block merges its 16 lane groups with warp shuffles and one small
//    shared-memory array per warp.
//  * Head sizes 64, 112, 128 and 256.  At D 112 (zamba2-7b) a row is 28
//    chunks of fp32, which 8 lanes do not share evenly: lanes 0-3 own one
//    chunk more than the others, and a chunk a lane does not own is never
//    copied, never read and counts zero in its q (Ring::TAIL).  At D 256
//    (gemma-7b) a lane owns 8 chunks of a row: its q and its accumulator
//    take 64 + 64 floats a head, so a block takes one head there
//    (MAX_HPB_WIDE); and a step of 32 rows is 64 KB, so the ring grows to
//    two steps (Ring::BYTES, 128 KB: one block an SM).
//  * A logit softcap cannot be folded into q as the log2(e) scale is: with
//    one, q is scaled by scale / softcap and each score becomes
//    tanh(s) * softcap * log2(e) before the max; without one, the scores are
//    the products of the log2-scaled q as before.
//
// Common to both: K/V are read in the cache's own (B, S, G, D) layout
// through strides.  A sliding window (gemma2-27b's local layers) makes the
// rows below len - window dead for this query and every later one: a
// sequence's live rows are [max(0, len - window), len), only they are cut
// into units, and no row below them is ever requested.  The slice kernel
// (decode_attention_lse.cu compiles this file with DCO_DECODE_SLICE defined:
// entry point dco_decode_attention_lse) runs the same bodies on one rank's
// slice of a sequence-sharded cache (the `kvseq` layout): its rows are rows
// [row_offset, row_offset + S) of the whole cache, cache_len counts whole
// rows, and the window counts back from the whole length, so that the slice
// attends exactly the rows of it that the whole cache's query sees.  It
// writes an fp32 output and each row's natural-log log-sum-exp, m + log l of
// the block (or of the merge) that finishes the row, for the exact merge
// across ranks; a row with no live key on the slice writes zeros and -inf.
// Each variant is a translation unit of its own, built in parallel; SLICE is
// a constant of the unit, so the serving kernels keep their code and their
// registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace dco_hopper;


#ifdef DCO_DECODE_SLICE
constexpr bool SLICE = true;   // this unit's kernel: one rank's slice, with the LSE
#else
constexpr bool SLICE = false;  // this unit's kernel: the serving one
#endif

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LANES_PER_ROW = 8;
constexpr int ROW_GROUPS = THREADS / LANES_PER_ROW;    // 16 lane groups
constexpr int ROWS_PER_GROUP = 2;                      // rows a lane group scores a step
constexpr int STEP_ROWS = ROW_GROUPS * ROWS_PER_GROUP;  // 32 rows a block step
constexpr int RING_BYTES = 64 * 1024;                  // cp.async ring of a block
constexpr int MAX_STAGES = 4;
constexpr int MAX_HPB = 4;
constexpr int MAX_HPB_WIDE = 1;   // query heads a block at most above D 128
constexpr int MAX_UNITS = 1024;   // units a sequence at most: ceil(S / R)
constexpr int BLOCKS_PER_SM = 3;  // 3 x (ring + merge arrays) fit the SM's shared memory
constexpr int MERGE_LOADS = 8;    // partials a thread of the last unit loads at once
constexpr int MIN_ROWS = 128;     // the least R chosen per call
constexpr int ITEMS_PER_SM = 2;   // work items an SM that a chosen R aims at, at most

// Query heads a block at most at head size D.
__host__ __device__ constexpr int max_hpb(int D) { return D > 128 ? MAX_HPB_WIDE : MAX_HPB; }

// 16 bytes of T widened to floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(uint4 v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float to(float x) { return x; }
};

// 16 bytes from device to shared memory; zeros, and nothing read, when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A row's 16-byte chunks are dealt to the 8 lanes of a lane group: lane l
// owns chunks l, l + 8, ... below ROW_CHUNKS.  Where 8 does not divide
// ROW_CHUNKS (D 112: 14 chunks of bf16, 28 of fp32) only the first TAIL lanes
// own a last chunk; the others never copy or read it, and their q holds zeros
// there, so the 3-shuffle reduction over the 8 lanes stays as it is.
template <typename T, int D>
struct Ring {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int ROW_CHUNKS = D / VEC;              // 16-byte chunks of a row
  static constexpr int NCH =                              // chunks a lane owns, at most
      (ROW_CHUNKS + LANES_PER_ROW - 1) / LANES_PER_ROW;
  static constexpr int TAIL = ROW_CHUNKS - (NCH - 1) * LANES_PER_ROW;  // lanes owning NCH
  static constexpr int EPL = NCH * VEC;                   // elements of a row a lane owns
  static_assert(D % VEC == 0, "rows of whole 16-byte chunks");
  static constexpr int CHUNKS = ROWS_PER_GROUP * 2 * NCH;  // a lane's chunks of K and V a step
  static constexpr int STEP_BYTES = CHUNKS * THREADS * 16;
  static constexpr int RING =  // RING_BYTES, or two steps where it holds fewer (fp32 D 256)
      2 * STEP_BYTES > RING_BYTES ? 2 * STEP_BYTES : RING_BYTES;
  static constexpr int STAGES = RING / STEP_BYTES < MAX_STAGES ? RING / STEP_BYTES : MAX_STAGES;
  static constexpr int BYTES = STAGES * STEP_BYTES;
  static_assert(STAGES >= 2, "the ring holds two steps or more");
  static_assert(BYTES >= 2 * MAX_HPB * MAX_UNITS * 4, "the merge's weights fit the ring");
  // chunk ci of a lane's step sits at ((stage * CHUNKS + ci) * THREADS + tid):
  // a warp's lanes write and read 16 consecutive bytes each, no bank conflict
};

// Arguments of one call, shared by every work unit.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const int* cache_len;
  T* out;
  float* part_acc;  // (B, H, units, D)
  float* part_m;    // (B, H, units)
  float* part_l;    // (B, H, units)
  int* counters;    // (B, head_blocks), 0 between calls
  int B, S, H, G;
  int rows;         // R, or 0: chosen on the device from cache_len
  int min_rows;     // the least R; units = ceil(S / min_rows)
  int target;       // work items the chosen R aims at, at most
  int units, head_blocks;
  int window;       // live rows a sequence at most, or 0: all of them
  float scale;
  float softcap;    // 0: none
  long long q_sb, q_sh, k_sb, k_ss, k_sg, v_sb, v_ss, v_sg;
  float* out_f;     // SLICE: the fp32 output (B, H, D)
  float* lse;       // SLICE: each row's log-sum-exp (B, H)
  int row_offset;   // SLICE: the whole cache's row of this slice's row 0
};

// cache_len is read-only here and read twice a block (the per-call sum, then
// the walk): through the read-only path
__device__ __forceinline__ int clamp_len(const int* cache_len, int b, int S) {
  const int len = __ldg(cache_len + b);
  return len < 0 ? 0 : (len > S ? S : len);
}

__device__ __forceinline__ long long round_up(long long x, int to) {
  return (x + to - 1) / to * to;
}

// The first live row of a sequence of length `len`: rows below it lie outside
// the window of its query (and of every later one)
__device__ __forceinline__ int first_live(int len, int window) {
  return window > 0 && len > window ? len - window : 0;
}

// SLICE: the live rows [lo, len) of batch row b on a slice of whole rows
// [row_offset, row_offset + S); cache_len and the window count whole rows,
// and a slice that holds none of the live ones gives len 0.
template <typename T>
__device__ __forceinline__ int slice_rows(const Args<T>& a, int b, int& lo) {
  const int n = max(__ldg(a.cache_len + b), 0);
  const int len = min(max(n - a.row_offset, 0), a.S);
  const int first = first_live(n, a.window) - a.row_offset;
  lo = 0;
  if (first >= len) return 0;  // the window ends below this slice, or nothing is on it
  lo = max(first, 0);
  return len;
}

// R for a call whose live rows (within the window) sum to `total`: the least multiple of STEP_ROWS
// (at least min_rows) that keeps the work items within `target`, so that every
// block takes one item at most and no SM more than target / SMs.  A (batch
// row, head block) has at most len / R + 1 items (one for cache_len 0), so
// head_blocks * (total / R + B) <= target holds for
// R >= head_blocks * total / (target - head_blocks * B).  With nothing to
// spare, every sequence is one unit.
__device__ __forceinline__ int rows_for(long long total, int B, int head_blocks, int target,
                                        int S, int min_rows) {
  const long long whole = round_up(S, STEP_ROWS);
  const long long spare = (long long)target - (long long)head_blocks * B;
  long long r = whole;
  if (spare > 0) r = round_up((head_blocks * total + spare - 1) / spare, STEP_ROWS);
  r = r < whole ? r : whole;
  return (int)(r > min_rows ? r : min_rows);
}

// Unit `unit` of the live rows [lo, len) of a sequence (`live` units, `live`
// > 0) for the HPB query heads h0.. of KV head g of batch row b; CAP: the
// scores are softcapped.
template <typename T, int D, int HPB, bool CAP>
__device__ __forceinline__ void attend_unit(const Args<T>& a, int R, int b, int hb, int unit,
                                            int lo, int len, int live, uint4* ring,
                                            float (&sm_m)[WARPS][HPB],
                                            float (&sm_l)[WARPS][HPB],
                                            float (&sm_acc)[WARPS][HPB][D], int& sm_last) {
  using L = Ring<T, D>;
  constexpr int VEC = L::VEC;
  constexpr int NCH = L::NCH;
  constexpr int EPL = L::EPL;
  constexpr int STAGES = L::STAGES;

  const int group = a.H / a.G;
  const int blocks_per_group = group / HPB;
  const int g = hb / blocks_per_group;
  const int h0 = g * group + (hb % blocks_per_group) * HPB;
  const int start = lo + unit * R;
  const int end = min(len, start + R);
  const bool direct = live == 1;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int sub = tid % LANES_PER_ROW;
  const int rgrp = tid / LANES_PER_ROW;

  // chunk c of a row is this lane's (always, but the last where 8 lanes do
  // not divide the row's chunks)
  const bool owns_last = sub < L::TAIL;
  auto owns = [&](int c) { return c + 1 < NCH || owns_last; };

  const T* kb = a.k + b * a.k_sb + g * a.k_sg;
  const T* vb = a.v + b * a.v_sb + g * a.v_sg;
  const int n_steps = (end - start + STEP_ROWS - 1) / STEP_ROWS;
  const uint32_t ring_base = smem_addr(ring);

  // step t: lane group rgrp copies rows start + t * STEP_ROWS + r * ROW_GROUPS + rgrp
  auto issue = [&](int t) {
    const int stage = t % STAGES;
#pragma unroll
    for (int r = 0; r < ROWS_PER_GROUP; ++r) {
      const int row = start + t * STEP_ROWS + r * ROW_GROUPS + rgrp;
      const bool ok = row < end;
      const T* kp = kb + (long long)(ok ? row : start) * a.k_ss;
      const T* vp = vb + (long long)(ok ? row : start) * a.v_ss;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (!owns(c)) continue;
        const int col = (sub + c * LANES_PER_ROW) * VEC;
        const int ck = (stage * L::CHUNKS + (2 * r) * NCH + c) * THREADS + tid;
        const int cv = (stage * L::CHUNKS + (2 * r + 1) * NCH + c) * THREADS + tid;
        cp_async16(ring_base + 16 * ck, kp + col, ok);
        cp_async16(ring_base + 16 * cv, vp + col, ok);
      }
    }
  };

  // q is requested first, ahead of the unit's K/V rows in the memory queue
  uint4 qraw[HPB][NCH];
#pragma unroll
  for (int hh = 0; hh < HPB; ++hh) {
    const T* qp = a.q + b * a.q_sb + (long long)(h0 + hh) * a.q_sh;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      qraw[hh][c] = owns(c) ? *reinterpret_cast<const uint4*>(
                                  qp + (sub + c * LANES_PER_ROW) * VEC)
                            : make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("" ::: "memory");

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_steps) issue(t);
    cp_async_commit();
  }

  // q, scaled so that scores are in log2 units; with a softcap, so that a
  // product is the argument of its tanh
  const float q_scale = CAP ? a.scale / a.softcap : a.scale * LOG2E;
  float qr[HPB][EPL];
#pragma unroll
  for (int hh = 0; hh < HPB; ++hh) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) Vec<T>::widen(qraw[hh][c], &qr[hh][c * VEC]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[hh][e] *= q_scale;
  }

  float m[HPB], l[HPB], acc[HPB][EPL];
#pragma unroll
  for (int hh = 0; hh < HPB; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[hh][e] = 0.f;
  }

  for (int t = 0; t < n_steps; ++t) {
    if (t + STAGES - 1 < n_steps) issue(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this lane's copies of step t have landed
    const uint4* st = ring + (t % STAGES) * L::CHUNKS * THREADS + tid;

    float s[ROWS_PER_GROUP][HPB];
    bool valid[ROWS_PER_GROUP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_GROUP; ++r) {
      valid[r] = start + t * STEP_ROWS + r * ROW_GROUPS + rgrp < end;
#pragma unroll
      for (int hh = 0; hh < HPB; ++hh) s[r][hh] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (!owns(c)) continue;
        float kf[VEC];
        Vec<T>::widen(st[((2 * r) * NCH + c) * THREADS], kf);
#pragma unroll
        for (int hh = 0; hh < HPB; ++hh)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[r][hh] = fmaf(qr[hh][c * VEC + e], kf[e], s[r][hh]);
      }
#pragma unroll
      for (int hh = 0; hh < HPB; ++hh) {
        float x = s[r][hh];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        if (CAP) x = tanhf(x) * (a.softcap * LOG2E);
        s[r][hh] = valid[r] ? x : NEG_INF;
      }
    }

    // one max and one rescale per step
    float p[ROWS_PER_GROUP][HPB];
#pragma unroll
    for (int hh = 0; hh < HPB; ++hh) {
      float m_new = m[hh];
#pragma unroll
      for (int r = 0; r < ROWS_PER_GROUP; ++r) m_new = fmaxf(m_new, s[r][hh]);
      const float alpha = exp2f(m[hh] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS_PER_GROUP; ++r) {
        p[r][hh] = valid[r] ? exp2f(s[r][hh] - m_new) : 0.f;
        psum += p[r][hh];
      }
      l[hh] = fmaf(l[hh], alpha, psum);
      m[hh] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[hh][e] *= alpha;
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_GROUP; ++r) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (!owns(c)) continue;
        float vf[VEC];
        Vec<T>::widen(st[((2 * r + 1) * NCH + c) * THREADS], vf);
#pragma unroll
        for (int hh = 0; hh < HPB; ++hh)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[hh][c * VEC + e] = fmaf(p[r][hh], vf[e], acc[hh][c * VEC + e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the four lane groups of a warp (lanes 8 apart own the same columns),
  // then the warps through shared memory
#pragma unroll
  for (int hh = 0; hh < HPB; ++hh) {
    float mx = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float w = exp2f(m[hh] - mx);
    float ls = l[hh] * w;
    ls += __shfl_xor_sync(0xffffffffu, ls, 8);
    ls += __shfl_xor_sync(0xffffffffu, ls, 16);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float x = acc[hh][e] * w;
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      acc[hh][e] = x;
    }
    if (lane < LANES_PER_ROW) {
      if (lane == 0) {
        sm_m[warp][hh] = mx;
        sm_l[warp][hh] = ls;
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        if (owns(c))
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sm_acc[warp][hh][(sub + c * LANES_PER_ROW) * VEC + e] = acc[hh][c * VEC + e];
    }
  }
  __syncthreads();

  for (int idx = tid; idx < HPB * D; idx += THREADS) {
    const int hh = idx / D;
    const int d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][hh]);
    float ls = 0.f, x = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(sm_m[w][hh] - mx);
      ls = fmaf(sm_l[w][hh], wt, ls);
      x = fmaf(sm_acc[w][hh][d], wt, x);
    }
    const long long bh = (long long)b * a.H + h0 + hh;
    if (direct) {
      if (SLICE) {
        a.out_f[bh * D + d] = x / fmaxf(ls, 1e-30f);
        if (d == 0) a.lse[bh] = (mx + log2f(ls)) * LN2;
      } else {
        a.out[bh * D + d] = Vec<T>::to(x / fmaxf(ls, 1e-30f));
      }
    } else {
      const long long slot = bh * a.units + unit;
      a.part_acc[slot * D + d] = x;
      if (d == 0) {
        a.part_m[slot] = mx;
        a.part_l[slot] = ls;
      }
    }
  }
  if (direct) return;

  // the last unit of this (batch, head block) to finish merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = a.counters + (long long)b * a.head_blocks + hb;
    const int done = atomicAdd(ctr, 1);
    sm_last = done == live - 1;
    if (sm_last) atomicExch(ctr, 0);  // every live unit has counted: back to 0
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // weights 2^(m_i - M) / sum_i l_i 2^(m_i - M) of the live partials, one warp
  // a head, in the ring (free now), then out = sum_i weight_i acc_i
  float* wts = reinterpret_cast<float*>(ring);
  float* lsum = wts + HPB * live;
  const long long bh0 = (long long)b * a.H + h0;
  for (int idx = tid; idx < HPB * live; idx += THREADS) {
    const long long slot = (bh0 + idx / live) * a.units + idx % live;
    wts[idx] = __ldcg(a.part_m + slot);
    lsum[idx] = __ldcg(a.part_l + slot);
  }
  __syncthreads();
  if (warp < HPB) {
    float* w = wts + warp * live;
    const float* lw = lsum + warp * live;
    float mx = NEG_INF;
    for (int i = lane; i < live; i += 32) mx = fmaxf(mx, w[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float ls = 0.f;
    for (int i = lane; i < live; i += 32) ls = fmaf(lw[i], exp2f(w[i] - mx), ls);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    if (SLICE && lane == 0) a.lse[bh0 + warp] = (mx + log2f(ls)) * LN2;
    __syncwarp();
    for (int i = lane; i < live; i += 32) w[i] = exp2f(w[i] - mx) * inv;
  }
  __syncthreads();
  // a thread takes 4 columns of one head, MERGE_LOADS partials' loads in flight
  constexpr int COLS4 = D / 4;
  for (int idx = tid; idx < HPB * COLS4; idx += THREADS) {
    const int hh = idx / COLS4;
    const int d4 = idx % COLS4;
    const float* w = wts + hh * live;
    const float4* pa =
        reinterpret_cast<const float4*>(a.part_acc + (bh0 + hh) * a.units * D) + d4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < live; i0 += MERGE_LOADS) {
      float4 r[MERGE_LOADS];
#pragma unroll
      for (int j = 0; j < MERGE_LOADS; ++j)
        r[j] = i0 + j < live ? __ldcg(pa + (long long)(i0 + j) * COLS4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < MERGE_LOADS; ++j) {
        const float wj = i0 + j < live ? w[i0 + j] : 0.f;
        x[0] = fmaf(r[j].x, wj, x[0]);
        x[1] = fmaf(r[j].y, wj, x[1]);
        x[2] = fmaf(r[j].z, wj, x[2]);
        x[3] = fmaf(r[j].w, wj, x[3]);
      }
    }
    if constexpr (SLICE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a.out_f[(bh0 + hh) * D + 4 * d4 + e] = x[e];
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) a.out[(bh0 + hh) * D + 4 * d4 + e] = Vec<T>::to(x[e]);
  }
}

// A 1-D grid of at most ITEMS_PER_SM blocks an SM walks the work items in
// order: for each batch row b, for each head block, its live units (one item
// for cache_len 0, which writes zeros).  Block i takes items i, i + gridDim.x,
// ...; every block finds the place of its item from cache_len alone.
template <typename T, int D, int HPB, bool CAP>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
decode_kernel(const Args<T> a) {
  extern __shared__ uint4 ring[];
  __shared__ float sm_m[WARPS][HPB];
  __shared__ float sm_l[WARPS][HPB];
  __shared__ float sm_acc[WARPS][HPB][D];
  __shared__ int sm_last;
  __shared__ long long sm_total[WARPS];

  // R: the caller's, or chosen from this call's lengths (every block reads
  // them all and comes to the same R)
  int R = a.rows;
  if (R == 0) {
    long long total = 0;
    for (int i = threadIdx.x; i < a.B; i += THREADS) {
      if constexpr (SLICE) {
        int lo;
        const int len = slice_rows(a, i, lo);
        total += len - lo;
      } else {
        const int len = clamp_len(a.cache_len, i, a.S);
        total += len - first_live(len, a.window);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
    if (threadIdx.x % 32 == 0) sm_total[threadIdx.x / 32] = total;
    __syncthreads();
    total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += sm_total[w];
    R = rows_for(total, a.B, a.head_blocks, a.target, a.S, a.min_rows);
  }

  int b = 0, base = 0;  // first item of batch row b
  for (int item = blockIdx.x;; item += gridDim.x) {
    int len = 0, lo = 0, live = 1;
    for (; b < a.B; ++b) {
      if constexpr (SLICE) {
        len = slice_rows(a, b, lo);
      } else {
        len = clamp_len(a.cache_len, b, a.S);
        lo = first_live(len, a.window);
      }
      live = len > 0 ? (len - lo + R - 1) / R : 1;
      if (item < base + live * a.head_blocks) break;
      base += live * a.head_blocks;
    }
    if (b >= a.B) return;
    const int hb = (item - base) / live;
    const int unit = (item - base) % live;
    // the sequence's live rows cut evenly into its `live` units (still <= R each)
    const int rows = (int)round_up((len - lo + live - 1) / live, STEP_ROWS);
    if (len == 0) {  // nothing to attend to: zeros
      const int group = a.H / a.G;
      const int blocks_per_group = group / HPB;
      const int h0 = hb / blocks_per_group * group + (hb % blocks_per_group) * HPB;
      if constexpr (SLICE) {
        const long long bh = (long long)b * a.H + h0;
        for (int idx = threadIdx.x; idx < HPB * D; idx += THREADS) a.out_f[bh * D + idx] = 0.f;
        if (threadIdx.x < HPB) a.lse[bh + threadIdx.x] = __int_as_float(0xff800000);  // -inf
      } else {
        for (int idx = threadIdx.x; idx < HPB * D; idx += THREADS)
          a.out[((long long)b * a.H + h0) * D + idx] = Vec<T>::to(0.f);
      }
      continue;
    }
    attend_unit<T, D, HPB, CAP>(a, rows, b, hb, unit, lo, len, live, ring, sm_m, sm_l, sm_acc,
                           sm_last);
    __syncthreads();  // the next item reuses the merge arrays
  }
}

// A softcap is a template argument: the uncapped kernel keeps its scores'
// loop as it was.
template <typename T, int D, int HPB, bool CAP>
int launch_cap(const Args<T>& a, int blocks, cudaStream_t stream) {
  constexpr int smem = Ring<T, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, HPB, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, D, HPB, CAP><<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D, int HPB>
int launch(const Args<T>& a, int blocks, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_cap<T, D, HPB, true>(a, blocks, stream)
                         : launch_cap<T, D, HPB, false>(a, blocks, stream);
}

// Variants for 1 to max_hpb(D) heads a block.
template <typename T, int D, int HPB = 1>
int launch_hpb(int hpb, const Args<T>& a, int blocks, cudaStream_t stream) {
  if (hpb == HPB) return launch<T, D, HPB>(a, blocks, stream);
  if constexpr (HPB < max_hpb(D)) return launch_hpb<T, D, HPB + 1>(hpb, a, blocks, stream);
  return -1;
}

// SLICE: `out` is the fp32 output and `lse` the log-sum-exp, `row_offset`
// the slice's first whole row; otherwise `out` is of T and the two unused.
template <typename T>
int launch_d(int D, int hpb, const void* q, const void* k, const void* v,
             const void* cache_len, void* out, void* lse, void* scratch, void* counters, int B,
             int S, int H, int G, int rows, int min_rows, int target, int window,
             int row_offset, float scale, float softcap, const long long* st, int blocks,
             cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.cache_len = static_cast<const int*>(cache_len);
  a.out = SLICE ? nullptr : static_cast<T*>(out);
  a.out_f = SLICE ? static_cast<float*>(out) : nullptr;
  a.lse = static_cast<float*>(lse);
  a.row_offset = row_offset;
  a.B = B;
  a.S = S;
  a.H = H;
  a.G = G;
  a.rows = rows;
  a.min_rows = min_rows;
  a.target = target;
  a.units = (S + min_rows - 1) / min_rows;
  a.head_blocks = H / hpb;
  const long long n_part = (long long)B * H * a.units;
  a.part_acc = static_cast<float*>(scratch);
  a.part_m = a.part_acc + n_part * D;
  a.part_l = a.part_m + n_part;
  a.counters = static_cast<int*>(counters);
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.q_sb = st[0];
  a.q_sh = st[1];
  a.k_sb = st[2];
  a.k_ss = st[3];
  a.k_sg = st[4];
  a.v_sb = st[5];
  a.v_ss = st[6];
  a.v_sg = st[7];
  if (D == 256) return launch_hpb<T, 256>(hpb, a, blocks, stream);
  if (D == 128) return launch_hpb<T, 128>(hpb, a, blocks, stream);
  if (D == 112) return launch_hpb<T, 112>(hpb, a, blocks, stream);
  if (D == 64) return launch_hpb<T, 64>(hpb, a, blocks, stream);
  return -1;
}

// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// bf16 path: TMA, mbarriers, wgmma and a thread-block cluster a (batch row,
// KV head) (sm_90a)

constexpr int W_TILE = 64;          // cache rows of a K/V tile: S's N, P V's depth
constexpr int W_PACKED = 64;        // rows of the packed query tile (wgmma's M)
constexpr int W_THREADS = 128;      // one warpgroup; its first thread issues every copy
constexpr int W_MAX_UNITS = 8;      // blocks of a (batch row, KV head) at most: a portable cluster
constexpr int W_MAX_GROUP = 64;     // query heads a KV head at most: the packed tile's rows
constexpr int W_MIN_UNIT_TILES = 2; // tiles a unit at least where the kernel cuts the rows
constexpr int W_SMALL_GROUP = 8;    // groups up to this stage q in 8 rows: one swizzle atom
constexpr int W_MAX_STAGES = 8;     // ring stages at most (a block alone on its SM)
constexpr int W_BAR_BYTES = 256;    // the mbarriers: q landed; K landed, V landed, stage free
constexpr int W_SMEM_LIMIT = 232448;

// Stages of the K/V ring where blocks share SMs: 64 KB of tiles in flight a
// block up to D 128, three blocks an SM (67 KB a block at D 128 with q in 8
// rows), and 192 KB at D 256, one block an SM.  A grid of no more blocks
// than SMs (batch 1 at long contexts) gives each block the SM's shared
// memory instead: w_deep_stages.
template <int D>
__host__ __device__ constexpr int w_stages() {
  return D > 128 ? 3 : D > 64 ? 2 : 4;
}

template <int D>
__host__ __device__ constexpr int w_blocks_per_sm() {
  return D > 128 ? 1 : 3;
}

// Rows of the staged q tile: a group of up to W_SMALL_GROUP heads is staged
// in one 8-row swizzle atom a box, which every 8-row group of the product's
// 64 rows reads (the descriptor's stride 0); larger groups in 64 rows.
__host__ __device__ constexpr int w_q_rows(int group) {
  return group <= W_SMALL_GROUP ? 8 : W_PACKED;
}

template <int D>
__host__ __device__ constexpr int w_smem_bytes(int group, int stages = w_stages<D>()) {
  return col_blocks<D>() * w_q_rows(group) * 128 + 2 * stages * tile_bytes<D>() +
         W_BAR_BYTES + SMEM_ALIGN;
}

template <int D>
__host__ __device__ constexpr int w_deep_stages(int group) {
  return (W_SMEM_LIMIT - w_smem_bytes<D>(group, 0)) / (2 * tile_bytes<D>()) < W_MAX_STAGES
             ? (W_SMEM_LIMIT - w_smem_bytes<D>(group, 0)) / (2 * tile_bytes<D>())
             : W_MAX_STAGES;
}

// Arguments of one bf16 call.
struct WArgs {
  const int* cache_len;
  bf16* out;          // (B, H, D); SLICE: unused
  float* out_f;       // SLICE: the fp32 output (B, H, D)
  float* lse;         // SLICE: each row's log-sum-exp (B, H)
  int B, S, H, G, group;
  int rows;           // rows a unit (a multiple of W_TILE), or 0: cut per call
  int target;         // the kernel's cut: blocks with rows a call at most
  int stages;         // of the K/V ring
  int window;         // live rows a sequence at most, or 0: all of them
  int row_offset;     // SLICE: the whole cache's row of this slice's row 0
  float scale;
  float softcap;      // 0: none
};

// The live rows [lo, len) of batch row b (SLICE: on this slice's rows), in
// `tiles` tiles of W_TILE rows from lo, cut into `units` units of `per`
// tiles (the last may be shorter).  Block `rank` of the (batch row, KV
// head) takes units rank, rank + C, ...: with the kernel's cut (rows 0) one
// unit at most; with the caller's `rows` there may be more units than
// blocks.  The kernel's cut is, as the fp32 kernel's R, chosen per call:
// units of at least R tiles, R the least (at least W_MIN_UNIT_TILES) that
// keeps the call's blocks with rows within `target` (a block for each live
// (batch row, KV head), and one more for every R of the call's live tiles),
// at most C units a (batch row, KV head), cutting its tiles evenly.  So a call with
// one live sequence spreads it over C blocks a KV head, and one whose every
// slot is live keeps all its blocks in one wave.
struct Span {
  int lo, len, tiles, per, units;
};

// The live rows [lo, len) of batch row b.
__device__ __forceinline__ void live_rows(const WArgs& a, int b, int& lo, int& len) {
  const int n = max(__ldg(a.cache_len + b), 0);
  if constexpr (SLICE) {
    len = min(max(n - a.row_offset, 0), a.S);
    const int first = first_live(n, a.window) - a.row_offset;
    lo = max(first, 0);
    if (first >= len) len = lo = 0;  // the window ends below this slice, or nothing is on it
  } else {
    len = min(n, a.S);
    lo = first_live(len, a.window);
  }
}

__device__ __forceinline__ Span span_of(const WArgs& a, int b, int C) {
  const int lane = threadIdx.x & 31;
  Span s;
  live_rows(a, b, s.lo, s.len);
  s.tiles = (s.len - s.lo + W_TILE - 1) / W_TILE;
  if (a.rows > 0) {
    s.per = a.rows / W_TILE;
  } else {
    // the call's live tiles and live batch rows, one batch row a lane
    int total = 0, live = 0;
    for (int i = lane; i < a.B; i += 32) {
      int lo, len;
      live_rows(a, i, lo, len);
      total += (len - lo + W_TILE - 1) / W_TILE;
      live += len > lo;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, off);
      live += __shfl_xor_sync(0xffffffffu, live, off);
    }
    const long long spare = max((long long)a.target - (long long)live * a.G, 1ll);
    const int r = max(W_MIN_UNIT_TILES, (int)(((long long)a.G * total + spare - 1) / spare));
    const int units = min(C, (s.tiles + r - 1) / r);
    s.per = units > 0 ? (s.tiles + units - 1) / units : 1;
  }
  s.units = (s.tiles + s.per - 1) / s.per;
  s.lo = warp_uniform(s.lo);
  s.len = warp_uniform(s.len);
  s.tiles = warp_uniform(s.tiles);
  s.per = warp_uniform(s.per);
  s.units = warp_uniform(s.units);
  return s;
}

// grid = (C, G, B), C blocks (`units`) a (batch row b, KV head g), one
// thread-block cluster, which merges its partials through distributed
// shared memory.  Block = one warpgroup, whose first thread
// issues every copy (q's first, ahead of the length; then the ring's tiles,
// each as its stage is freed).  The group's query heads g * group .. are the
// first `group` rows of the packed 64-row tile; rows past them are zeros.
// CAP: softcapped scores.
template <int D, bool CAP>
__global__ void __launch_bounds__(W_THREADS, w_blocks_per_sm<D>())
decode_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const WArgs a) {
  constexpr int NCB = col_blocks<D>();
  constexpr int TB = tile_bytes<D>();
  constexpr int KS = D / 16;  // 16-deep steps of Q K^T
  const int STAGES = a.stages;
  static_assert(D % 16 == 0 && D <= NCB * BOX_COLS, "head size");
  static_assert(8 + 24 * W_MAX_STAGES <= W_BAR_BYTES, "the barriers fit");
  static_assert(2 * W_PACKED * 4 + W_MAX_GROUP * D * 4 <= 2 * 2 * TB,
                "the merge's partial fits a ring of two stages");

  extern __shared__ unsigned char smem_w[];
  const uint32_t qbuf = (smem_addr(smem_w) + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  unsigned char* qbuf_ptr = smem_w + (qbuf - smem_addr(smem_w));
  const int q_rows = w_q_rows(a.group);
  const uint32_t q_box = q_rows * 128;  // bytes of one 64-column box of q
  const uint32_t ring = qbuf + NCB * q_box;  // STAGES x (K tile, V tile)
  const uint32_t bars = ring + STAGES * 2 * TB;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 + 24 * st; };
  auto v_full = [&](int st) { return bars + 16 + 24 * st; };
  auto stage_free = [&](int st) { return bars + 24 + 24 * st; };

  const int rank = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int C = gridDim.x;
  const int group = a.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(stage_free(st), 4);  // one arrival a warp
    }
    mbar_init_fence();
  }
  auto issue_q = [&]() {
    mbar_expect_tx(q_full, NCB * BOX_COLS * 2 * group);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(qbuf + cb * q_box, tm_q, q_full, cb * BOX_COLS, g * group, b);
  };
  // block 0 of a (batch row, KV head) works on every live sequence: its q
  // goes out first, ahead of the length
  if (threadIdx.x == 0 && rank == 0) issue_q();
  const Span sp = span_of(a, b, C);
  const int active = min(C, sp.units);  // blocks of this (batch row, KV head) with rows
  // this block's tiles: units rank, rank + C, ..., of sp.per tiles each (the
  // last unit of the sequence may be shorter, and it is the block's last)
  int n_tiles = 0;
  for (int u = rank; u < sp.units; u += C) n_tiles += min(sp.tiles, (u + 1) * sp.per) - u * sp.per;
  n_tiles = warp_uniform(n_tiles);
  auto tile_at = [&](int n) { return (rank + n / sp.per * C) * sp.per + n % sp.per; };
  // tile n of the block into its stage: a box may start on any row, and rows
  // past S arrive as zeros
  auto issue = [&](int n) {
    const int st = n % STAGES;
    const int row = sp.lo + tile_at(n) * W_TILE;
    const uint32_t dst = ring + st * 2 * TB;
    mbar_expect_tx(k_full(st), TB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      tma_load(dst + cb * BOX_BYTES, tm_k, k_full(st), cb * BOX_COLS, g, row, b);
    mbar_expect_tx(v_full(st), TB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      tma_load(dst + TB + cb * BOX_BYTES, tm_v, v_full(st), cb * BOX_COLS, g, row, b);
  };
  // a later block with no rows and no share of a merge (its sequence is
  // dead, or one block holds it) leaves at once, having asked for nothing
  if (rank > 0 && n_tiles == 0 && active <= 1) return;
  // the first tiles (a later block's q with them), while the other threads
  // zero q's rows past the group (TMA writes none of them)
  if (threadIdx.x == 0) {
    if (rank > 0 && n_tiles > 0) issue_q();
    for (int n = 0; n < min(STAGES, n_tiles); ++n) issue(n);
  }
  {
    uint4* qz = reinterpret_cast<uint4*>(qbuf_ptr);
    const int per_box = (q_rows - group) * 8;
    for (int i = threadIdx.x; i < NCB * per_box; i += W_THREADS)
      qz[(i / per_box) * (q_box / 16) + group * 8 + i % per_box] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();

  // this thread's packed rows r0 and r0 + 8 (query heads g * group + r);
  // a warp whose rows all lie past the group skips their softmax
  const int r0 = 16 * warp + (lane >> 2);
  const bool row_live[2] = {16 * warp < group, 16 * warp + 8 < group};
  // no copy may be in flight when the block ends: q is waited for wherever
  // it was asked for
  if (rank == 0 || n_tiles > 0) mbar_wait(q_full, 0);

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[cb][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t pf[4][4];        // P as bf16 A fragments of four 16-deep steps
#pragma unroll
  for (int i = 0; i < 16; ++i) pf[i / 4][i % 4] = 0u;
  // scores in log2 units; with a softcap, the argument of its tanh
  const float s_scale = CAP ? a.scale / a.softcap : a.scale * LOG2E;
  const float cap_scale = a.softcap * LOG2E;
  // q's descriptor: staged in 8 rows, every 8-row group of the 64 reads them
  // (the rows past the group are not written, and their P is 0)
  uint64_t dq0 = smem_desc(qbuf);
  if (q_rows == 8) dq0 &= ~(0x3FFFull << 32);

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % STAGES, lap = n / STAGES;
    const int row0 = sp.lo + tile_at(n) * W_TILE;
    const int valid = warp_uniform(min(W_TILE, sp.len - row0));  // live rows of the tile
    const uint32_t kt = ring + st * 2 * TB;
    uint64_t dq = dq0, dk = smem_desc(kt);
    asm volatile("" : "+l"(dq), "+l"(dk)::"memory");
    float s[32];
    mbar_wait(k_full(st), lap & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = (ks >> 2) * BOX_BYTES + (ks & 3) * 32;
      const uint32_t q_off = (ks >> 2) * q_box + (ks & 3) * 32;
      wgmma_ss(s, dq + (q_off >> 4), dk + (off >> 4), ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);

    // scale (and cap), mask the rows past the sequence's end (-1e30: no
    // weight), one max and one rescale a tile for each live row
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!row_live[i]) continue;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float x = CAP ? tanhf(s[e] * s_scale) * cap_scale : s[e] * s_scale;
          if (valid < W_TILE && 8 * j + 2 * (lane & 3) + c >= valid) x = NEG_INF;
          s[e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          s[e] = fast_exp2(s[e] - m_new);
          ps += s[e];
        }
      l[i] = fmaf(l[i], alpha[i], ps);
    }
    // P rounded to bf16, the A operand of O += P V (as the reference's
    // p.astype(v.dtype)); a row past the group keeps P = 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (row_live[0]) pf[j >> 1][2 * (j & 1)] = pack_bf16(s[4 * j], s[4 * j + 1]);
      if (row_live[1]) pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[cb][e] *= alpha[(e >> 1) & 1];

    const uint32_t vt = kt + TB;
    mbar_wait(v_full(st), lap & 1);
    if (valid < W_TILE) {
      // rows past the sequence's end may hold anything (inf, nan) and
      // 0 * inf is not 0: zero them before the product reads them
      uint4* vz = reinterpret_cast<uint4*>(qbuf_ptr + (vt - qbuf));
      const int per_box = (W_TILE - valid) * 8;
      for (int i = threadIdx.x; i < NCB * per_box; i += 128)
        vz[(i / per_box) * (BOX_BYTES / 16) + valid * 8 + i % per_box] =
            make_uint4(0u, 0u, 0u, 0u);
      fence_proxy_async();
      __syncthreads();
    }
    uint64_t dv = smem_desc(vt);
    asm volatile("" : "+l"(dv)::"memory");
    hold(pf);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        wgmma_rs(acc[cb], pf[kk], dv + ((cb * BOX_BYTES + kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) hold(acc[cb]);
    mbar_arrive(stage_free(st), lane == 0);
    if (threadIdx.x == 0 && n + STAGES < n_tiles) {  // the stage's next tile
      mbar_wait(stage_free(st), lap & 1);
      issue(n + STAGES);
    }
    __syncwarp();
  }
  // the tile loop's end

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const long long bh0 = (long long)b * a.H + (long long)g * group;  // the group's first row

  if (active == 0) {  // no live row: zeros (SLICE: and -inf), from block 0
    if (rank != 0) return;
    for (int i = threadIdx.x; i < group * D; i += 128) {
      if constexpr (SLICE) {
        a.out_f[bh0 * D + i] = 0.f;
      } else {
        a.out[bh0 * D + i] = __float2bfloat16_rn(0.f);
      }
    }
    if (SLICE && threadIdx.x < group) a.lse[bh0 + threadIdx.x] = __int_as_float(0xff800000);  // -inf
    return;
  }

  if (active == 1) {  // one unit: block 0 writes the output
    if (rank != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (!row_live[i] || r >= group) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      if (SLICE && (lane & 3) == 0) a.lse[bh0 + r] = (m[i] + log2f(l[i])) * LN2;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb * BOX_COLS + 8 * j + 2 * (lane & 3);
          if (col >= D) continue;
          const float x0 = acc[cb][4 * j + 2 * i] * inv, x1 = acc[cb][4 * j + 2 * i + 1] * inv;
          if constexpr (SLICE) {
            *reinterpret_cast<float2*>(a.out_f + (bh0 + r) * D + col) = make_float2(x0, x1);
          } else {
            *reinterpret_cast<uint32_t*>(a.out + (bh0 + r) * D + col) = pack_bf16(x0, x1);
          }
        }
    }
    return;
  }

  // Several units: each block with rows keeps its partial (m, l, acc of the
  // group's rows, in log2 units) in its shared memory (the ring, free now),
  // and after the cluster's barrier every block merges its share of the
  // output's elements from all the blocks' partials through distributed
  // shared memory:
  //   out = sum_u acc_u 2^(m_u - M) / sum_u l_u 2^(m_u - M),  M = max_u m_u,
  // summed over the blocks in order.
  float* pm = reinterpret_cast<float*>(qbuf_ptr + (ring - qbuf));  // m of the group's rows
  float* pl = pm + W_PACKED;                                        // then l
  float* pacc = pl + W_PACKED;                                      // then acc, group x D
  if (rank < active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (!row_live[i] || r >= group) continue;
      if ((lane & 3) == 0) {
        pm[r] = m[i];
        pl[r] = l[i];
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb * BOX_COLS + 8 * j + 2 * (lane & 3);
          if (col < D)
            *reinterpret_cast<float2*>(pacc + r * D + col) =
                make_float2(acc[cb][4 * j + 2 * i], acc[cb][4 * j + 2 * i + 1]);
        }
    }
  }
  cluster_arrive();  // the partials written, released to the cluster
  cluster_wait();
  // this block's share of the output's float4 elements, each from every
  // block's partial (all loads issued before the first is used)
  const uint32_t pm_s = smem_addr(pm), pl_s = smem_addr(pl), pacc_s = smem_addr(pacc);
  const int n4 = group * D / 4;
  const int share = (n4 + C - 1) / C;
  const int e_end = min(n4, (rank + 1) * share);
  for (int e = rank * share + threadIdx.x; e < e_end; e += W_THREADS) {
    const int r = 4 * e / D, col = 4 * e % D;
    float mv[W_MAX_UNITS], lv[W_MAX_UNITS];
    float4 av[W_MAX_UNITS];
#pragma unroll
    for (int v = 0; v < W_MAX_UNITS; ++v) {
      if (v < active) {
        mv[v] = ld_cluster(cluster_map(pm_s + 4 * r, v));
        lv[v] = ld_cluster(cluster_map(pl_s + 4 * r, v));
        av[v] = ld_cluster4(cluster_map(pacc_s + 4 * (r * D + col), v));
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int v = 0; v < W_MAX_UNITS; ++v)
      if (v < active) mx = fmaxf(mx, mv[v]);
    float ls = 0.f;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int v = 0; v < W_MAX_UNITS; ++v) {
      if (v < active) {
        const float w = fast_exp2(mv[v] - mx);
        ls = fmaf(lv[v], w, ls);
        x.x = fmaf(av[v].x, w, x.x);
        x.y = fmaf(av[v].y, w, x.y);
        x.z = fmaf(av[v].z, w, x.z);
        x.w = fmaf(av[v].w, w, x.w);
      }
    }
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    const long long o = (bh0 + r) * D + col;
    if constexpr (SLICE) {
      if (col == 0) a.lse[bh0 + r] = (mx + log2f(ls)) * LN2;
      *reinterpret_cast<float4*>(a.out_f + o) =
          make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
    } else {
      *reinterpret_cast<uint2*>(a.out + o) =
          make_uint2(pack_bf16(x.x * inv, x.y * inv), pack_bf16(x.z * inv, x.w * inv));
    }
  }
  cluster_arrive();  // no block leaves while another reads its partial
  cluster_wait();
}

// One tensor map of the bf16 path, encoded once for each (pointer, shape,
// strides, box) and kept: a pool's per-layer views repeat from call to call.
struct MapSlot {
  long long key[10];
  CUtensorMap map;
};
constexpr int MAP_SLOTS = 128;

bool cached_map(CUtensorMap* out, const long long (&key)[10], bool rank3) {
  thread_local MapSlot slots[MAP_SLOTS];
  thread_local int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    bool same = true;
    for (int j = 0; j < 10 && same; ++j) same = slots[i].key[j] == key[j];
    if (same) {
      *out = slots[i].map;
      return true;
    }
  }
  const void* ptr = reinterpret_cast<const void*>(key[0]);
  const bool ok = rank3 ? tensor_map_3d(out, ptr, (int)key[1], (int)key[2], (int)key[3], key[5],
                                        key[6], (int)key[8])
                        : tensor_map(out, ptr, (int)key[1], (int)key[2], (int)key[3],
                                     (int)key[4], key[5], key[6], key[7], (int)key[8],
                                     (int)key[9]);
  if (!ok) return false;
  MapSlot& slot = slots[next];
  for (int j = 0; j < 10; ++j) slot.key[j] = key[j];
  slot.map = *out;
  next = (next + 1) % MAP_SLOTS;
  used = used < MAP_SLOTS ? used + 1 : MAP_SLOTS;
  return true;
}

template <int D, bool CAP>
int launch_wgmma_cap(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                     const WArgs& a, int units, cudaStream_t stream) {
  static_assert(w_smem_bytes<D>(W_MAX_GROUP) <= W_SMEM_LIMIT, "shared memory of a block");
  static_assert(w_deep_stages<D>(W_MAX_GROUP) >= w_stages<D>(), "a deep ring is deeper");
  const int smem = w_smem_bytes<D>(a.group, a.stages);
  cudaError_t err = cudaFuncSetAttribute(decode_wgmma_kernel<D, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         W_SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units, a.G, a.B);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = units;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_wgmma_kernel<D, CAP>, tm_q, tm_k, tm_v, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                 const WArgs& a, int units, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_wgmma_cap<D, true>(tm_q, tm_k, tm_v, a, units, stream)
                         : launch_wgmma_cap<D, false>(tm_q, tm_k, tm_v, a, units, stream);
}

// The bf16 call: `units` blocks a (batch row, KV head) (1 to W_MAX_UNITS),
// one cluster; `rows` a unit (a positive multiple of W_TILE), or 0 and
// `target` > 0 (span_of).
int launch_bf16(int D, const void* q, const void* k, const void* v, const void* cache_len,
                void* out, void* lse, int B, int S, int H, int G, int units, int rows,
                int target, int window, int row_offset, float scale, float softcap,
                const long long* st, cudaStream_t stream) {
  const int group = H / G;
  if (group > W_MAX_GROUP || units < 1 || units > W_MAX_UNITS) return -1;
  if (rows < 0 || rows % W_TILE != 0 || (rows == 0 && target <= 0)) return -1;
  for (int i = 0; i < 8; ++i)
    if (st[i] % 8 != 0) return -1;  // TMA: 16-byte strides
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) return -1;
  WArgs a;
  a.cache_len = static_cast<const int*>(cache_len);
  a.out = SLICE ? nullptr : static_cast<bf16*>(out);
  a.out_f = SLICE ? static_cast<float*>(out) : nullptr;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.S = S;
  a.H = H;
  a.G = G;
  a.group = group;
  a.rows = rows;
  a.target = target;
  a.window = window;
  a.row_offset = row_offset;
  a.scale = scale;
  a.softcap = softcap;
  // q (B, H, D): 3-d, a box of the group's heads; k, v (B, S, G, D): 4-d, a
  // box of 64 rows of one KV head
  const long long kq[10] = {(long long)(uintptr_t)q, D, H, B, 0, st[1], st[0], 0, group, 0};
  const long long kk[10] = {(long long)(uintptr_t)k, D, G, S, B, st[4], st[3], st[2], 1, W_TILE};
  const long long kv[10] = {(long long)(uintptr_t)v, D, G, S, B, st[7], st[6], st[5], 1, W_TILE};
  CUtensorMap tm_q, tm_k, tm_v;
  if (!cached_map(&tm_q, kq, true) || !cached_map(&tm_k, kk, false) ||
      !cached_map(&tm_v, kv, false))
    return -1;
  // a grid of no more blocks than SMs: each block alone on its SM, with a
  // deep ring
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const bool alone = (long long)units * G * B <= sms;
  a.stages = D == 256 ? (alone ? w_deep_stages<256>(group) : w_stages<256>())
           : D == 128 ? (alone ? w_deep_stages<128>(group) : w_stages<128>())
           : D == 112 ? (alone ? w_deep_stages<112>(group) : w_stages<112>())
                      : (alone ? w_deep_stages<64>(group) : w_stages<64>());
  if (D == 256) return launch_wgmma<256>(tm_q, tm_k, tm_v, a, units, stream);
  if (D == 128) return launch_wgmma<128>(tm_q, tm_k, tm_v, a, units, stream);
  if (D == 112) return launch_wgmma<112>(tm_q, tm_k, tm_v, a, units, stream);
  if (D == 64) return launch_wgmma<64>(tm_q, tm_k, tm_v, a, units, stream);
  return -1;
}


// The entry points' checks and the dtype switch.  dtype: 0 = bf16, 1 = fp32.
// `window` > 0 keeps only a sequence's last `window` rows live (0: all rows);
// `softcap` > 0 caps the scaled scores at softcap * tanh(s / softcap) (0:
// none).  `strides` (in elements): q batch, q head, k batch, k row, k
// kv-head, v batch, v row, v kv-head; the last dimension of q, k and v has
// stride 1, `out` is contiguous (B, H, D).
// bf16 (launch_bf16): `units` blocks a (batch row, KV head), 1 to
// W_MAX_UNITS, one thread-block cluster; `rows` the rows of a unit, a
// positive multiple of W_TILE, or 0 for the live tiles cut evenly; at most
// W_MAX_GROUP query heads a KV head; pointers on 16 bytes and strides
// multiples of 8 (TMA).  `hpb`, `min_rows`, `target`, `blocks`, `scratch`
// and `counters` are the fp32 kernel's (null for bf16).
// fp32: `hpb` query heads of one KV head share a block (1 to max_hpb(D),
// dividing H / G).  `rows` is R, a positive multiple of STEP_ROWS, or 0 for
// R chosen on the device from cache_len (rows_for); `min_rows`, a positive
// multiple of STEP_ROWS with ceil(S / min_rows) at most MAX_UNITS, bounds R
// from below (with `rows` given, it equals `rows`); `target` is the most
// work items a chosen R may give.  Either way a sequence's live rows are cut
// evenly into ceil(live rows / R) units of a multiple of STEP_ROWS rows.
// `blocks` is the 1-D grid (the wrapper gives `target` blocks, or fewer when
// there are fewer work items).  `scratch` holds B * H * ceil(S / min_rows) *
// (D + 2) floats, starts on 16 bytes and needs no initial value; `counters`
// holds B * H / hpb ints that are 0 before the call and 0 again after it,
// provided that every launch on them runs to its end (a launch that faults
// leaves the context unusable, and a new context needs the counters zeroed
// anew) and that no two launches on them run at once.
// Returns 0, a cudaError_t of the launch, or -1 for arguments the kernel does
// not take.
int launch_call(const void* q, const void* k, const void* v, const void* cache_len, void* out,
                void* lse, void* scratch, void* counters, int dtype, int B, int S, int H, int G,
                int D, int hpb, int rows, int min_rows, int target, int blocks, int units,
                int window, int row_offset, float scale, float softcap,
                const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0) return -1;
  if (B > 65535 || G > 65535) return -1;
  if (window < 0 || !(softcap >= 0.f)) return -1;
  if (SLICE && (lse == nullptr || row_offset < 0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bf16(D, q, k, v, cache_len, out, lse, B, S, H, G, units, rows, target,
                       window, row_offset, scale, softcap, strides, s);
  if (dtype != 1 || blocks <= 0 || target <= 0) return -1;
  if (min_rows <= 0 || min_rows % STEP_ROWS != 0) return -1;
  if (rows != 0 && rows != min_rows) return -1;
  if ((S + min_rows - 1) / min_rows > MAX_UNITS) return -1;
  if (hpb < 1 || hpb > max_hpb(D) || (H / G) % hpb != 0) return -1;
  return launch_d<float>(D, hpb, q, k, v, cache_len, out, lse, scratch, counters, B, S, H, G,
                         rows, min_rows, target, window, row_offset, scale, softcap, strides,
                         blocks, s);
}

// Clusters of `units` blocks of the bf16 kernel (with a group of `group`
// heads, at head size D) that the card runs at once, or -1.
template <int D>
int max_clusters(int group, int units) {
  const int smem = w_smem_bytes<D>(group);
  if (cudaFuncSetAttribute(decode_wgmma_kernel<D, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           W_SMEM_LIMIT) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units, 1, 1);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = units;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, decode_wgmma_kernel<D, false>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

#ifndef DCO_DECODE_SLICE
extern "C" int dco_decode_attention(const void* q, const void* k, const void* v,
                                    const void* cache_len, void* out, void* scratch,
                                    void* counters, int dtype, int B, int S, int H, int G,
                                    int D, int hpb, int rows, int min_rows, int target,
                                    int blocks, int units, int window, float scale,
                                    float softcap, const long long* strides, void* stream) {
  return launch_call(q, k, v, cache_len, out, nullptr, scratch, counters, dtype, B, S, H, G, D,
                     hpb, rows, min_rows, target, blocks, units, window, 0, scale, softcap,
                     strides, stream);
}

// Clusters of `units` blocks (1 to W_MAX_UNITS) of the bf16 kernel, at head
// size D with `group` query heads a KV head, that the current device runs at
// once (the wrapper picks `units` so that a call's clusters run in one
// wave), or -1 for arguments the kernel does not take.
extern "C" int dco_decode_clusters(int D, int group, int units) {
  if (group < 1 || group > W_MAX_GROUP || units < 1 || units > W_MAX_UNITS) return -1;
  if (D == 256) return max_clusters<256>(group, units);
  if (D == 128) return max_clusters<128>(group, units);
  if (D == 112) return max_clusters<112>(group, units);
  if (D == 64) return max_clusters<64>(group, units);
  return -1;
}
#else
// One rank's slice of a sequence-sharded cache: as dco_decode_attention, with
// k / v holding whole rows [row_offset, row_offset + S), cache_len counting
// whole rows (a window counts back from it), `out` an fp32 (B, H, D) output
// and `lse` (B, H) floats: each row's natural-log sum of exp(score) over its
// live keys on the slice, -inf (and a zero output) where it has none.
extern "C" int dco_decode_attention_lse(const void* q, const void* k, const void* v,
                                        const void* cache_len, void* out, void* lse,
                                        void* scratch, void* counters, int dtype, int B, int S,
                                        int H, int G, int D, int hpb, int rows, int min_rows,
                                        int target, int blocks, int units, int window,
                                        int row_offset, float scale, float softcap,
                                        const long long* strides, void* stream) {
  return launch_call(q, k, v, cache_len, out, lse, scratch, counters, dtype, B, S, H, G, D, hpb,
                     rows, min_rows, target, blocks, units, window, row_offset, scale, softcap,
                     strides, stream);
}
#endif
