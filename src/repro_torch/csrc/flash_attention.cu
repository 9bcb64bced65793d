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
//    takes 2 * D bytes rounded up to 128 (row_bytes): no pad at D 64 and 128;
//    at D 112 (zamba2-7b) its 14 chunks sit in 16 slots, the swizzle stays
//    inside the row, and the two spare slots are never copied or read (7
//    QK^T steps and 14 output column blocks, nothing computed on padding).
//    Streamed tiles go through a ring of STAGES tiles: tile t + 1 loads while
//    tile t computes.  Q is staged through the ring before the KV loop and
//    needs no buffer of its own.  The pinned prefix is staged once, with the
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
//  * Left for later: wgmma fed by TMA with a producer warp and a consumer
//    warpgroup per 64 rows, once this version's numbers say whether MMA issue
//    rate or latency is what remains.
//
// The fp32 path (flash_kernel) keeps fp32 FMA on shared-memory tiles (64 x 64
// scores, a 4 x 4 patch a thread): exact fp32 accumulation, no TF32, which its
// 2e-5 tolerance rules out.  Rows are staged with one pad word so that 16 lanes
// reading 16 consecutive rows hit 16 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // fp32 path: query rows of a tile
constexpr int BK = 64;        // KV rows of a tile, both paths
constexpr int THREADS = 256;  // fp32 path: 16 x 16, thread (ty, tx) owns rows ty*4.., cols tx+16*j
constexpr int LDP = BK + 1;
constexpr int SMEM_LIMIT = 232448;
constexpr int STAGES = 2;     // bf16 path: streamed K/V tiles in the ring
constexpr int MAX_WARPS = 8;  // bf16 path: warps of a block, one (head, 16 rows) each
constexpr float LOG2E = 1.4426950408889634f;

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

// grid = (Q-tile chunks, G, B).  Strides are in 32-bit words.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ k,
             const uint32_t* __restrict__ v, uint32_t* __restrict__ o, int Sq, int Sk,
             int H, int G, int tiles_per_chunk, int pinned_rows, int causal, int window,
             float scale, float softcap, long long q_sb, long long q_ss,
             long long q_sh, long long k_sb, long long k_ss, long long k_sg,
             long long v_sb, long long v_ss, long long v_sg, long long o_sb,
             long long o_ss, long long o_sh) {
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

  // the pinned prefix: staged once, as far as this block's Q rows can see it,
  // from the first tile one of them sees (the block's Q tiles are in order)
  const int kv_need = causal ? min(Sk, qt1 * BQ) : Sk;
  const int pin = min(pinned_rows, kv_need);
  const int pin_lo = min(pin, first_kv_tile(qt0 * BQ, window) * BK);
  stage_rows<WPR, LD>(pinK + pin_lo * LD, kb + (long long)pin_lo * k_ss, k_ss, pin - pin_lo);
  stage_rows<WPR, LD>(pinV + pin_lo * LD, vb + (long long)pin_lo * v_ss, v_ss, pin - pin_lo);

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q_lo = qt * BQ;
    const int kv_end = causal ? min(Sk, q_lo + BQ) : Sk;
    const int n_kv_tiles = (kv_end + BK - 1) / BK;
    const int t_lo = first_kv_tile(q_lo, window);
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
          bool ok[4];
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = k_lo + tx + 16 * j;
            float x = s[i][j] * scale;
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
            ok[j] = col < kv_end && (!causal || col <= row) && (window == 0 || col > row - window);
            s[i][j] = ok[j] ? x : NEG_INF;
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int H, int G, int tiles_per_chunk, int pinned_rows, int causal, int window,
           float scale, float softcap, const long long* st, cudaStream_t stream) {
  constexpr int EPW = Word<T>::EPW;
  constexpr int LD = D / EPW + 1;
  const long long smem =
      4ll * (2ll * pinned_rows * LD + 3ll * BQ * LD) + 4ll * BQ * LDP;
  if (smem > SMEM_LIMIT) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  const int n_chunks = (n_q_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  long long w[12];
  for (int i = 0; i < 12; ++i) {
    if (st[i] % EPW != 0) return -1;
    w[i] = st[i] / EPW;
  }
  const dim3 grid(n_chunks, G, B);
  flash_kernel<T, D><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<uint32_t*>(o), Sq, Sk, H, G,
      tiles_per_chunk, pinned_rows, causal, window, scale, softcap, w[0], w[1], w[2], w[3],
      w[4], w[5], w[6], w[7], w[8], w[9], w[10], w[11]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path

using bf16 = __nv_bfloat16;
static_assert(STAGES == 2, "the ring loads one tile ahead");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; zeros when !full
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for a 16 x 16 bf16 A (row-major fragments), a 16 x 8 bf16 B, fp32 c
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Bytes of a staged bf16 row: 2 * D rounded up to 128, so that a row holds
// whole groups of eight 16-byte slots and the swizzle below stays inside it.
// D 112 (224 bytes) is staged at 256: slots 14 and 15 of a row are never
// copied or read, and no arithmetic runs on them.
template <int D>
__host__ __device__ constexpr int row_bytes() {
  return (2 * D + 127) / 128 * 128;
}

// Byte offset of 16-byte chunk c of row r in swizzled rows of ROWB bytes.
template <int ROWB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROWB + ((c ^ (r & 7)) << 4);
}

// Rows [0, nrows) of a swizzled tile from device rows `stride` elements apart;
// rows from `nvalid` on are zeros.
template <int D>
__device__ __forceinline__ void stage_tile(uint32_t dst, const bf16* src, long long stride,
                                           int nrows, int nvalid) {
  constexpr int CPR = D / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < nrows * CPR; i += blockDim.x) {
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = r < nvalid;
    cp_async16(dst + swz<row_bytes<D>()>(r, c), src + (ok ? r * stride + c * 8 : 0), ok);
  }
}

// The Q tile at place p of the order n-1, 0, n-2, 1, ...
__device__ __forceinline__ int tile_at(int p, int n) {
  return (p & 1) ? p >> 1 : n - 1 - (p >> 1);
}

// grid = (Q-tile chunks, G, B); block = 32 * hp * wph threads: warp w owns
// query rows [16 * (w % wph), +16) of the tile for head w / wph of the pass.
// Strides are in elements.
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk, int H,
                 int G, int wph, int hp, int tiles_per_chunk, int pinned_rows, int causal,
                 int window, float scale, float softcap, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sg, long long v_sb,
                 long long v_ss, long long v_sg, long long o_sb, long long o_ss,
                 long long o_sh) {
  constexpr int ROWB = row_bytes<D>();  // bytes of a staged row
  constexpr int TILEB = BK * ROWB;  // bytes of a staged K or V tile
  constexpr int KS = D / 16;        // 16-deep steps of Q K^T
  constexpr int NO = D / 8;         // 8-wide column blocks of O
  static_assert(D % 16 == 0 && ROWB % 128 == 0 && ROWB >= 2 * D, "row layout");

  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int pin_alloc = (pinned_rows + BK - 1) / BK * BK;
  const uint32_t pinK = smem_addr(smem_mma);
  const uint32_t pinV = pinK + pin_alloc * ROWB;
  const uint32_t ring = pinV + pin_alloc * ROWB;  // STAGES x (K tile, V tile)

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

  // the pinned prefix: staged once, whole tiles, from the first tile to the
  // last that this block's Q rows can see; its rows hold what a streamed tile
  // would hold
  int kv_need = 0, kv_first = Sk;
  for (int p = p0; p < p1; ++p) {
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
    const int kv_end = causal ? min(Sk, q_lo + bq) : Sk;
    const int n_kv = (kv_end + BK - 1) / BK;
    const int n_pinned = pinned_rows >= Sk ? n_kv : min(n_kv, pinned_rows / BK);
    const int t_lo = first_kv_tile(q_lo, window);
    const int t_stream = max(t_lo, n_pinned);  // the first streamed tile
    const int r0 = q_lo + 16 * slice;  // this warp's first query row
    const int ra = r0 + (lane >> 2);   // this thread's rows: ra and ra + 8
    for (int h0 = 0; h0 < group; h0 += hp) {
      const int nh = min(hp, group - h0);
      const int h = g * group + h0 + hh;
      const bool active = hh < nh && r0 < Sq;

      // Q of the pass's heads through the ring, into registers
      __syncthreads();  // the ring is free
      for (int j = 0; j < nh; ++j)
        stage_tile<D>(ring + j * bq * ROWB,
                      q + b * q_sb + (long long)(g * group + h0 + j) * q_sh +
                          (long long)q_lo * q_ss,
                      q_ss, bq, min(bq, Sq - q_lo));
      cp_async_commit();
      cp_async_wait<0>();  // Q (and the pinned prefix) staged
      __syncthreads();
      uint32_t qf[KS][4];
      if (active) {
#pragma unroll
        for (int s = 0; s < KS; ++s)
          ldsm_x4(ring + swz<ROWB>(hh * bq + 16 * slice + (lane & 15), 2 * s + (lane >> 4)),
                  qf[s]);
      }
      __syncthreads();  // the ring takes K/V now
      if (t_stream < n_kv) load_kv(t_stream, 0);
      cp_async_commit();

      float acc[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums

      for (int t = t_lo; t < n_kv; ++t) {
        const bool streamed = t >= n_pinned;
        uint32_t kt, vt;
        if (streamed) {
          const int st = (t - t_stream) & 1;
          if (t + 1 < n_kv) load_kv(t + 1, st ^ 1);
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
        const int dead = window > 0 ? min(BK, max(0, r0 - window + 1 - k_lo)) : 0;
        if (active && dead < BK) {
          // columns [lim, BK) lie above every row of this warp
          const int lim = causal ? min(BK, r0 + 16 - k_lo) : BK;
          const bool need_mask = k_lo + BK > Sk || (causal && k_lo + BK > r0 + 1) ||
                                 (window > 0 && k_lo + window <= r0 + 15);

          // S = Q K^T: 16 x 64, eight 8-column blocks
          float s[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (16 * j < lim && 16 * j + 16 > dead) {
                uint32_t kf[4];
                ldsm_x4(kt + swz<ROWB>(16 * j + ((lane >> 4) << 3) + (lane & 7),
                                       2 * ks + ((lane >> 3) & 1)),
                        kf);
                mma_bf16(s[2 * j], qf[ks], kf[0], kf[1]);
                mma_bf16(s[2 * j + 1], qf[ks], kf[2], kf[3]);
              }
            }
          }

          // scale (in log2 units), softcap, mask
          if (softcap > 0.f) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[j][e] = tanhf(s[j][e] * (scale / softcap)) * (softcap * LOG2E);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[j][e] *= scale * LOG2E;
          }
          if (need_mask) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = k_lo + 8 * j + 2 * (lane & 3) + (e & 1);
                const int row = ra + 8 * (e >> 1);
                if (col >= Sk || (causal && col > row) || (window > 0 && col <= row - window))
                  s[j][e] = -INFINITY;
              }
          }

          // online softmax; P as bf16 A fragments of four 16-deep steps
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
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
          uint32_t pf[4][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
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
          for (int s2 = 0; s2 < 4; ++s2) {
            if (16 * s2 < lim && 16 * s2 + 16 > dead) {
#pragma unroll
              for (int j = 0; j < NO / 2; ++j) {
                uint32_t vf[4];
                ldsm_x4_trans(vt + swz<ROWB>(16 * s2 + (lane & 15), 2 * j + (lane >> 4)), vf);
                mma_bf16(acc[2 * j], pf[s2], vf[0], vf[1]);
                mma_bf16(acc[2 * j + 1], pf[s2], vf[2], vf[3]);
              }
            }
          }
        }
        if (streamed) __syncthreads();  // this ring slot may be refilled
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
               int H, int G, int tiles_per_chunk, int pinned_rows, int causal, int window,
               float scale, float softcap, const long long* st, cudaStream_t stream) {
  // heads a pass, then warps a head (16 query rows each), within MAX_WARPS
  const int group = H / G;
  const int passes = (group + MAX_WARPS - 1) / MAX_WARPS;
  const int hp = (group + passes - 1) / passes;
  int wph = 4;
  while (wph > 1 && hp * wph > MAX_WARPS) wph >>= 1;
  const long long pin_alloc = (pinned_rows + BK - 1) / BK * BK;
  const long long smem = (2ll * pin_alloc + STAGES * 2ll * BK) * row_bytes<D>();
  if (smem > SMEM_LIMIT) return -2;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return -1;  // 16-byte rows for the 16-byte copies
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  const int bq = 16 * wph;
  const int n_q_tiles = (Sq + bq - 1) / bq;
  const int n_chunks = (n_q_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  const dim3 grid(n_chunks, G, B);
  flash_mma_kernel<D><<<grid, 32 * hp * wph, (size_t)smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, G, wph, hp, tiles_per_chunk, pinned_rows, causal,
      window, scale, softcap, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  `strides` (in elements): batch, row and head strides
// of q, then k, v and o; the last dimension of each has stride 1.  bf16 rows
// must be 16-byte aligned: pointers on 16 bytes, strides multiples of 8.
// `softcap` 0 means none.  `window` > 0 lets row r see columns (r - window, r]
// (causal only); 0 means none.  `pinned_rows` is Sk or a multiple of 64.  Returns 0,
// a cudaError_t, -1 for arguments the kernel does not take, or -2 when
// `pinned_rows` does not fit the shared memory a block may take.
extern "C" int dco_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int G, int D,
                                   int tiles_per_chunk, int pinned_rows, int causal,
                                   int window, float scale, float softcap,
                                   const long long* strides, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || G <= 0 || H % G != 0) return -1;
  if (B > 65535 || G > 65535 || tiles_per_chunk <= 0) return -1;
  if (pinned_rows < 0 || pinned_rows > Sk) return -1;
  if (pinned_rows != Sk && pinned_rows % BK != 0) return -1;
  if (causal && Sq != Sk) return -1;
  if (window < 0 || (window > 0 && !causal)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch_mma<128>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 0 && D == 112)
    return launch_mma<112>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 0 && D == 64)
    return launch_mma<64>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 1 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 1 && D == 112)
    return launch<float, 112>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  if (dtype == 1 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, window, scale, softcap, strides, s);
  return -1;
}
