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
// needs some 20 KB in flight on every SM all the time, and the work is ragged:
// one sequence may hold ten times the rows of another, and on the serving path
// most rows of a call have cache_len 0.
//
// What the design does about it:
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
//    (RING_BYTES a block: a whole 128-row unit of bf16 at D 128 is requested
//    before the first score).  A lane reads back only what it copied itself,
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
//  * Head sizes 64, 112, 128 and 256.  At D 112 (zamba2-7b) a row is 14
//    chunks of bf16 (28 of fp32), which 8 lanes do not share evenly: lanes 0-5
//    (0-3) own one chunk more than the others, and a chunk a lane does not own
//    is never copied, never read and counts zero in its q (Ring::TAIL), so the
//    ring, the 3-shuffle reduction and the merge keep one shape for all D.  At
//    D 256 (gemma-7b) a lane owns 4 chunks of a bf16 row (8 of fp32): its q
//    and its accumulator take 32 + 32 floats a head, so a block takes one
//    head there (MAX_HPB_WIDE: two spilled in bf16 at the 168 registers of
//    BLOCKS_PER_SM blocks an SM); and an fp32 step of 32 rows is 64 KB, so the
//    ring grows to two steps (Ring::BYTES, 128 KB: one block an SM) where
//    RING_BYTES would hold one.  Every other variant's ring is RING_BYTES.
//  * K/V are read in the cache's own (B, S, G, D) layout through strides: no
//    transposed copy of the cache is ever made.  `group` is below any
//    tensor-core tile height, so the products are fp32 multiply-adds.
//  * A sliding window (gemma2-27b's local layers) makes the rows below
//    len - window dead for this query and every later one: a sequence's live
//    rows are [max(0, len - window), len), R is chosen from the live rows,
//    the units cut only them, and no row below them is ever requested.
//  * A logit softcap cannot be folded into q as the log2(e) scale is: with
//    one, q is scaled by scale / softcap and each score becomes
//    tanh(s) * softcap * log2(e) before the max; without one, the scores are
//    the products of the log2-scaled q as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
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

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(uint4 v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 to(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
      a.out[bh * D + d] = Vec<T>::to(x / fmaxf(ls, 1e-30f));
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
      const int len = clamp_len(a.cache_len, i, a.S);
      total += len - first_live(len, a.window);
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
      len = clamp_len(a.cache_len, b, a.S);
      lo = first_live(len, a.window);
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
      for (int idx = threadIdx.x; idx < HPB * D; idx += THREADS)
        a.out[((long long)b * a.H + h0) * D + idx] = Vec<T>::to(0.f);
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

template <typename T>
int launch_d(int D, int hpb, const void* q, const void* k, const void* v,
             const void* cache_len, void* out, void* scratch, void* counters, int B, int S,
             int H, int G, int rows, int min_rows, int target, int window, float scale,
             float softcap, const long long* st, int blocks, cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.cache_len = static_cast<const int*>(cache_len);
  a.out = static_cast<T*>(out);
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

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  `hpb` query heads of one KV head share a block
// (1 to max_hpb(D), dividing H / G).  `rows` is R, a positive multiple of
// STEP_ROWS, or 0 for R chosen on the device from cache_len (rows_for);
// `min_rows`, a positive multiple of STEP_ROWS with ceil(S / min_rows) at most
// MAX_UNITS, bounds R from below (with `rows` given, it equals `rows`);
// `target` is the most work items a chosen R may give.  `window` > 0 keeps
// only a sequence's last `window` rows live (0: all rows); `softcap` > 0 caps
// the scaled scores at softcap * tanh(s / softcap) (0: none).  Either way a
// sequence's live rows are cut evenly into ceil(live rows / R) units of a
// multiple of STEP_ROWS rows.  `blocks` is the 1-D grid (the wrapper gives `target`
// blocks, or fewer when there are fewer work items).  `strides` (in elements): q batch, q head,
// k batch, k row, k kv-head, v batch, v row, v kv-head; the last dimension of
// q, k and v has stride 1, `out` is contiguous (B, H, D).  `scratch` holds
// B * H * ceil(S / min_rows) * (D + 2) floats, starts on 16 bytes and needs no
// initial value; `counters` holds B * H / hpb ints that are 0 before the call
// and 0 again after it, provided that every launch on them runs to its end
// (a launch that faults leaves the context unusable, and a new context needs
// the counters zeroed anew) and that no two launches on them run at once.
// Returns 0, a cudaError_t of the launch, or -1 for arguments the kernel does
// not take.
extern "C" int dco_decode_attention(const void* q, const void* k, const void* v,
                                    const void* cache_len, void* out, void* scratch,
                                    void* counters, int dtype, int B, int S, int H, int G,
                                    int D, int hpb, int rows, int min_rows, int target,
                                    int blocks, int window, float scale, float softcap,
                                    const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || blocks <= 0) return -1;
  if (window < 0 || !(softcap >= 0.f)) return -1;
  if (min_rows <= 0 || min_rows % STEP_ROWS != 0) return -1;
  if (rows != 0 && rows != min_rows) return -1;
  if (target <= 0) return -1;
  if ((S + min_rows - 1) / min_rows > MAX_UNITS) return -1;
  if (hpb < 1 || hpb > max_hpb(D) || (H / G) % hpb != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<__nv_bfloat16>(D, hpb, q, k, v, cache_len, out, scratch, counters, B, S,
                                   H, G, rows, min_rows, target, window, scale, softcap,
                                   strides, blocks, s);
  if (dtype == 1)
    return launch_d<float>(D, hpb, q, k, v, cache_len, out, scratch, counters, B, S, H, G,
                           rows, min_rows, target, window, scale, softcap, strides, blocks, s);
  return -1;
}
