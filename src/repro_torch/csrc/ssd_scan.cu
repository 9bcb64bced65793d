// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas-TPU kernel `ssd_kernel`
// (src/repro/kernels/ssd_scan/kernel.py, built by build_ssd_call, wrapped by
// ops.py::ssd_scan).
//
// For each (batch, head), over chunks of rows with cum = cumsum(dt * A):
//   y     = ((C B^T) o L) (x dt) + exp(cum) (C state),  L[i,j] = exp(cum_i - cum_j), i >= j
//   state = state exp(total) + B^T (x dt exp(total - cum))
// starting from `init` (or zeros); y comes out in x's type, the final state in
// fp32 as (B, H, P, N).  Sums are fp32.
//
// Bound on an H100: operations.  At the serving shape (prompt 1024, 80 heads,
// P 64, N 128) the chunked algorithm at 64-row sub-chunks does about 3.7 GFLOP
// a layer against some 46 MB moved, far above the ridge of the card.  The
// inputs are fp32 and the reference's tolerance is 1e-4, which plain TF32
// (10 mantissa bits, ~5e-4 relative) cannot hold; the fastest product that
// keeps fp32 accuracy is 3xTF32 on the tensor cores, 495 / 3 TFLOP/s.
//
// What the design does about it:
//  * The four products (C B^T, 64 x 64 x N; scores (x dt), 64 x 32 x 64;
//    C state^T, 64 x 32 x N; B^T (x dt w), N x 32 x 64) are
//    mma.sync.m16n8k8 TF32 products with fp32 sums, in 3xTF32: each operand
//    a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), rounded to nearest
//    as cvt.rna.tf32.f32 does but in integer operations, and a b ~ lo hi' +
//    hi lo' + hi hi' (the lo lo' term, ~2^-22 relative, is dropped).  bf16
//    inputs take the same path (a bf16 value is exact in hi).  Score blocks
//    above the diagonal are skipped.  A warp computes two or four 16 x 8
//    products a k-step, so a split operand feeds two or four of them; it sums
//    hi hi' and the two correction terms in separate accumulators, the n-tiles
//    interleaved, so that no product waits on the one just issued.  Operands
//    read along their rows come in by ldmatrix (one instruction for a 16 x 8
//    fragment), the others by 4-byte loads whose addresses are fixed per
//    thread; the k loops are unrolled.
//  * The TPU walks the chunk axis as a sequential grid dimension with the state
//    in VMEM scratch.  Here one block walks all the chunks of its (batch, head)
//    in a loop and keeps the running state (P slice x N fp32) from the first
//    row to the last: in registers, one piece a warp (the accumulator of the
//    state product), and in shared memory for C state^T; it is written to
//    device memory once, at the end.  No per-chunk state ever reaches device
//    memory: that state has a one-chunk lifetime, the dead-block idea of the
//    DCO paper.
//  * Columns of P are independent (y[:, p] and state[p, :] depend only on
//    x[:, p]), so a block owns a slice of PS = 32 columns and the grid is
//    (P / 32, H, B): 160 blocks for one mamba2-2.7b prompt.  Each slice
//    recomputes its sub-chunk's C B^T o L, which is exact.
//  * Staging by cp.async.  The rows of B, C and x of a 64-row sub-chunk
//    (16-byte copies, in the input's own type) and of dt (4-byte copies) go
//    into a ring of two sub-chunks, so that sub-chunk c + 1 arrives while c
//    computes; the six warps that carry the lighter half
//    of C B^T request it while the other two finish theirs.  bf16 is widened
//    into fp32 tiles after it arrives.  fp32 rows keep their 16-byte chunks
//    XOR-swizzled by ((r % 4) * 2 + (r / 4) % 2), which lets the products read
//    a tile both ways, along its rows (ldmatrix) and down its columns (4-byte
//    loads), from distinct banks.  At N 128 in fp32 a stage is 72 KB, so the
//    two stages hold a block to one an SM (on the card this beat two blocks
//    an SM with one stage each, which spilled).
//  * The decay factors L of the scores are exp2 of differences of the cumsum,
//    which one warp keeps in log2 units.
//  * x, dt, B and C are read in the model's own layouts through strides; head h
//    reads group h / (H / G).  The transposes and the repeat of B/C over heads
//    that the TPU wrapper makes do not exist here.  Rows past S are zeros: they
//    add nothing and, with dt 0, carry no decay.  In exact arithmetic the
//    result does not depend on the sub-chunk, and the wrapper keeps the
//    reference's `chunk` argument and its S % chunk rule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using namespace dco_tf32;

constexpr int Q = 64;         // rows of a sub-chunk
constexpr int PS = 32;        // columns of P a block owns
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;     // sub-chunks in the staging ring
constexpr int LDSC = Q + 4;   // row stride (floats) of the score tile

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory; zeros, and nothing read, when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 4 fp32 matrices (8 rows of 16 bytes each, one row address a lane):
// lane l receives word l % 4 of row l / 4 of each.
__device__ __forceinline__ void ldsm4(uint32_t addr, float (&r)[4]) {
  uint32_t u[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
               : "r"(addr));
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(u[i]);
}

// 16-byte chunk k of row r sits at chunk k ^ swz(r) of the row: 4 consecutive
// rows map one chunk to 4 even (or odd) places, 8 consecutive rows to 8.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 1) | ((r >> 2) & 1); }

// An fp32 work tile: Q rows of COLS floats, rows of ROWB bytes (8 chunks at
// least, so that the swizzle stays inside a row).
template <int COLS>
struct FTile {
  static constexpr int CHUNKS = COLS / 4;
  static constexpr int ROWB = (CHUNKS < 8 ? 8 : CHUNKS) * 16;
  static constexpr int BYTES = Q * ROWB;
  // byte offset of element (r, c)
  static __device__ __forceinline__ int off(int r, int c) {
    return r * ROWB + (((c >> 2) ^ swz(r)) << 4) + ((c & 3) << 2);
  }
};

// C B^T for NT n-tiles: A rows from the row address `arow`, B from `brow` (two
// n-tiles an ldmatrix, 16 rows apart), both in the layout of FTile<N>; `mi` is
// lane / 8.  Straight-line code: every k-step unrolled, no branch.
template <int N, int NT>
__device__ __forceinline__ void scores_mma(uint32_t cs, uint32_t bs, int arow, int brow, int mi,
                                           float (&c)[NT][4], float (&cc)[NT][4]) {
  using TN = FTile<N>;
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 8) {
    FragA fa;
    float av[4];
    ldsm4(cs + TN::off(arow, k0 + 4 * (mi >> 1)), av);
    fa.set(av);
    FragB fb[NT];
#pragma unroll
    for (int tp = 0; tp < NT / 2; ++tp) {
      float bv[4];
      ldsm4(bs + TN::off(brow + 16 * tp, k0 + 4 * (mi & 1)), bv);
      fb[2 * tp].set(bv[0], bv[1]);
      fb[2 * tp + 1].set(bv[2], bv[3]);
    }
    mma3(c, cc, fa, fb);
  }
}

// (C B^T) o L of NT n-tiles from column c0 of row block rb into the score tile
template <int NT>
__device__ __forceinline__ void scores_store(float* sc, const float* cum, int rb, int c0,
                                             int gq, int tq, const float (&c)[NT][4],
                                             const float (&cc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * rb + gq + 8 * (e >> 1);
      const int jj = c0 + 8 * j + 2 * tq + (e & 1);
      const float v = c[j][e] + cc[j][e];
      sc[i * LDSC + jj] = jj <= i ? v * exp2f(cum[i] - cum[jj]) : 0.f;
    }
}

// scores (x dt) for the 16 rows of one row block: K = KS rows of the scores
// (the blocks past the diagonal are zero), two n-tiles of x
template <int KS>
__device__ __forceinline__ void y_intra_mma(uint32_t sc_a, const char* Xs, const float* dts,
                                            const int (&xo)[2][2], int tq, float (&c)[2][4],
                                            float (&cc)[2][4]) {
  using TX = FTile<PS>;
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += 8) {
    FragA fa;
    float av[4];
    ldsm4(sc_a + 4 * k0, av);
    fa.set(av);
    const float d0 = dts[k0 + tq], d1 = dts[k0 + tq + 4];
    const char* xr = Xs + k0 * TX::ROWB;
    FragB fb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      fb[j].set(*reinterpret_cast<const float*>(xr + xo[j][0]) * d0,
                *reinterpret_cast<const float*>(xr + xo[j][1]) * d1);
    }
    mma3(c, cc, fa, fb);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

// The ring's copy of Q rows of COLS elements of T: fp32 lands in the work
// tile's layout; bf16 lands as plain rows and is widened by widen().
template <typename T, int COLS>
struct Staged {
  static constexpr bool F32 = IsF32<T>::value;
  static constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte chunk
  static constexpr int CH = COLS / EPC;       // chunks a row
  static constexpr int BYTES = F32 ? FTile<COLS>::BYTES : Q * COLS * (int)sizeof(T);

  // rows [0, Q) from `src`, rows `stride` elements apart, by threads t of nt;
  // rows from `valid` on are zeros
  static __device__ __forceinline__ void issue(int t, int nt, char* dst, const T* src,
                                               long long stride, int valid) {
    const uint32_t d = smem_addr(dst);
    for (int i = t; i < Q * CH; i += nt) {
      const int r = i / CH;
      const int k = i % CH;
      const bool ok = r < valid;
      const int o = F32 ? FTile<COLS>::off(r, 4 * k) : r * COLS * (int)sizeof(T) + 16 * k;
      cp_async16(d + o, src + (ok ? r * stride + k * EPC : 0), ok);
    }
  }

  // bf16 rows into the fp32 work tile
  static __device__ __forceinline__ void widen(const char* raw, char* work) {
    const T* rp = reinterpret_cast<const T*>(raw);
    for (int i = threadIdx.x; i < Q * COLS; i += THREADS) {
      *reinterpret_cast<float*>(work + FTile<COLS>::off(i / COLS, i % COLS)) =
          static_cast<float>(rp[i]);
    }
  }
};

// Shared memory of a block (bytes) for input type T and state size N.
template <typename T, int N>
struct Smem {
  using SB = Staged<T, N>;
  using SX = Staged<T, PS>;
  static constexpr bool F32 = IsF32<T>::value;
  static constexpr int B_OFF = 0;  // within a stage
  static constexpr int C_OFF = B_OFF + SB::BYTES;
  static constexpr int X_OFF = C_OFF + SB::BYTES;
  static constexpr int DT_OFF = X_OFF + SX::BYTES;
  static constexpr int STAGE = DT_OFF + Q * 4;
  // bf16: fp32 work tiles beside the ring (fp32 works in the ring's stage)
  static constexpr int WB_OFF = STAGES * STAGE;
  static constexpr int WC_OFF = WB_OFF + (F32 ? 0 : FTile<N>::BYTES);
  static constexpr int WX_OFF = WC_OFF + (F32 ? 0 : FTile<N>::BYTES);
  static constexpr int LDST = N + 4;  // row stride (floats) of the state
  static constexpr int ST_OFF = WX_OFF + (F32 ? 0 : FTile<PS>::BYTES);
  static constexpr int SC_OFF = ST_OFF + PS * LDST * 4;  // (C B^T) o L, Q x LDSC
  static constexpr int CUM_OFF = SC_OFF + Q * LDSC * 4;
  static constexpr int ECUM_OFF = CUM_OFF + Q * 4;       // exp(cum)
  static constexpr int DTW_OFF = ECUM_OFF + Q * 4;       // dt exp(total - cum)
  static constexpr int TOT_OFF = DTW_OFF + Q * 4;        // exp(total)
  static constexpr int BYTES = TOT_OFF + 16;
};

// grid = (P / PS, H, B).  y is contiguous (B, S, H, P); init and final_state
// are contiguous (B, H, P, N).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ final_state, int S, int H, int G,
                int P, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
                long long b_sg, long long c_sb, long long c_ss, long long c_sg) {
  using L = Smem<T, N>;
  using TN = FTile<N>;
  using TX = FTile<PS>;
  constexpr int LDST = L::LDST;
  // state product: a warp owns 16 rows of P x NTS n-tiles of 8
  constexpr int NTS = N / 32 > 0 ? N / 32 : 1;
  constexpr int STATE_WARPS = 2 * (N / (8 * NTS));

  extern __shared__ float4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  float* st = reinterpret_cast<float*>(sm + L::ST_OFF);
  float* sc = reinterpret_cast<float*>(sm + L::SC_OFF);
  float* cum = reinterpret_cast<float*>(sm + L::CUM_OFF);
  float* ecum = reinterpret_cast<float*>(sm + L::ECUM_OFF);
  float* dtw = reinterpret_cast<float*>(sm + L::DTW_OFF);
  float* tot = reinterpret_cast<float*>(sm + L::TOT_OFF);

  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // fragment row (A, C) or column (B)
  const int tq = lane % 4;  // fragment column (A) or row (B)
  const int mi = lane / 8;  // the ldmatrix matrix whose row address this lane gives
  const int mr = lane % 8;  // ... and the row
  const float a = A[h];

  const T* xb = x + b * x_sb + h * x_sh + p0;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* Bb = Bm + b * b_sb + g * b_sg;
  const T* Cb = Cm + b * c_sb + g * c_sg;
  const long long y_ss = (long long)H * P;
  T* yb = y + (long long)b * S * y_ss + (long long)h * P + p0;
  const long long st_base = (((long long)b * H + h) * P + p0) * N;
  const int n_sub = (S + Q - 1) / Q;

  // sub-chunk c into its stage, by threads t of nt
  auto issue = [&](int c, int t, int nt) {
    char* stage = sm + (c % STAGES) * L::STAGE;
    const int c0 = c * Q;
    const int valid = min(Q, S - c0);
    L::SB::issue(t, nt, stage + L::B_OFF, Bb + (long long)c0 * b_ss, b_ss, valid);
    L::SB::issue(t, nt, stage + L::C_OFF, Cb + (long long)c0 * c_ss, c_ss, valid);
    L::SX::issue(t, nt, stage + L::X_OFF, xb + (long long)c0 * x_ss, x_ss, valid);
    for (int r = t; r < Q; r += nt) {
      const bool ok = r < valid;
      cp_async4(smem_addr(stage + L::DT_OFF + 4 * r),
                dtb + (ok ? (long long)(c0 + r) * dt_ss : 0), ok);
    }
    cp_async_commit();
  };

  // the state piece this warp owns: rows sp0 + gq (+8) of the slice, columns
  // sn0 + 8 j + 2 tq (+1)
  const bool state_warp = warp < STATE_WARPS;
  const int sp0 = (warp % 2) * 16;
  const int sn0 = (warp / 2) * 8 * NTS;
  float sreg[NTS][4];
#pragma unroll
  for (int j = 0; j < NTS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = sp0 + gq + 8 * (e >> 1);
      const int n = sn0 + 8 * j + 2 * tq + (e & 1);
      float v = 0.f;
      if (state_warp && init != nullptr) v = init[st_base + (long long)p * N + n];
      sreg[j][e] = v;
      if (state_warp) st[p * LDST + n] = v;
    }

  // C B^T on and below the diagonal in blocks of 16 x 16: row block 3 in two
  // halves (warps 0, 1), row block 2 (warps 2-4), 1 (5, 6), 0 (7)
  const int g_rb = warp < 2 ? 3 : warp < 5 ? 2 : warp < 7 ? 1 : 0;
  const int g_c0 = warp < 2 ? 32 * warp : 16 * (warp < 5 ? warp - 2 : warp < 7 ? warp - 5 : 0);
  // y: warp w owns rows 16 (w / 2) and columns 16 (w % 2)
  const int y_r0 = 16 * (warp / 2);
  const int y_c0 = 16 * (warp % 2);

  // ldmatrix row addresses, fixed for the whole walk: A fragments take rows
  // r0 + 8 (mi % 2) + mr and 16-byte column block mi / 2; B fragments of two
  // n-tiles take rows c0 + 8 (mi / 2) + mr and column block mi % 2
  const int ga_row = 16 * g_rb + 8 * (mi & 1) + mr;
  const int ya_row = y_r0 + 8 * (mi & 1) + mr;
  const int gb_row = g_c0 + 8 * (mi >> 1) + mr;
  const uint32_t st_b = smem_addr(st + (y_c0 + 8 * (mi >> 1) + mr) * LDST + 4 * (mi & 1));
  const uint32_t sc_a = smem_addr(sc + ya_row * LDSC + 4 * (mi >> 1));
  // 4-byte loads down the columns: row k0 + tq (+4) has swizzle swz(tq) (swz(tq + 4))
  int xo_y[2][2], xo_s[2][2], bo_s[NTS][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      xo_y[j][u] = TX::off(tq + 4 * u, y_c0 + 8 * j + gq);
      xo_s[j][u] = TX::off(tq + 4 * u, sp0 + gq + 8 * j);
    }
#pragma unroll
  for (int j = 0; j < NTS; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) bo_s[j][u] = TN::off(tq + 4 * u, sn0 + 8 * j + gq);

  issue(0, tid, THREADS);
  for (int c = 0; c < n_sub; ++c) {
    const int c0 = c * Q;
    const int rows = min(Q, S - c0);
    cp_async_wait<0>();
    __syncthreads();  // sub-chunk c has landed for every thread
    char* stage = sm + (c % STAGES) * L::STAGE;
    const float* dts = reinterpret_cast<const float*>(stage + L::DT_OFF);
    char* Bs = stage + L::B_OFF;
    char* Cs = stage + L::C_OFF;
    char* Xs = stage + L::X_OFF;
    if (!L::F32) {
      L::SB::widen(Bs, sm + L::WB_OFF);
      L::SB::widen(Cs, sm + L::WC_OFF);
      L::SX::widen(Xs, sm + L::WX_OFF);
      Bs = sm + L::WB_OFF;
      Cs = sm + L::WC_OFF;
      Xs = sm + L::WX_OFF;
      __syncthreads();
    }
    const uint32_t bs = smem_addr(Bs), cs = smem_addr(Cs);

    // 1. warp 0: inclusive cumsum of dt * A (lane l holds rows l and 32 + l)
    if (warp == 0) {
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
      cum[lane] = lo * 1.4426950408889634f;  // in log2 units
      cum[32 + lane] = hi * 1.4426950408889634f;
      ecum[lane] = expf(lo);
      ecum[32 + lane] = expf(hi);
      dtw[lane] = dts[lane] * expf(total - lo);
      dtw[32 + lane] = dts[32 + lane] * expf(total - hi);
      if (lane == 0) tot[0] = expf(total);
    }

    // 2. C B^T: four n-tiles on warps 0 and 1, two on the others
    float gacc[4][4], gcor[4][4], gacc2[2][4], gcor2[2][4];
    zero(gacc);
    zero(gcor);
    zero(gacc2);
    zero(gcor2);
    if (warp < 2)
      scores_mma<N, 4>(cs, bs, ga_row, gb_row, mi, gacc, gcor);
    else
      scores_mma<N, 2>(cs, bs, ga_row, gb_row, mi, gacc2, gcor2);
    // the next sub-chunk is requested here, by the warps that carry the
    // lighter half of C B^T, into the stage that c - 1 has freed
    if (warp >= 2 && c + 1 < n_sub) issue(c + 1, tid - 64, THREADS - 64);

    // 3. C state^T with the state of the rows before this sub-chunk
    float yoff[2][4], yoff_c[2][4], yin[2][4], yin_c[2][4];
    zero(yoff);
    zero(yoff_c);
    zero(yin);
    zero(yin_c);
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      FragA fa;
      float av[4], bv[4];
      ldsm4(cs + TN::off(ya_row, k0 + 4 * (mi >> 1)), av);
      fa.set(av);
      ldsm4(st_b + 4 * k0, bv);
      FragB fb[2];
      fb[0].set(bv[0], bv[1]);
      fb[1].set(bv[2], bv[3]);
      mma3(yoff, yoff_c, fa, fb);
    }
    __syncthreads();  // cum, ecum, dtw and tot are ready

    // 4. scores (C B^T) o L, zeros above the diagonal
    if (warp < 2)
      scores_store<4>(sc, cum, g_rb, g_c0, gq, tq, gacc, gcor);
    else
      scores_store<2>(sc, cum, g_rb, g_c0, gq, tq, gacc2, gcor2);
    __syncthreads();  // the scores are ready; every read of the old state is done

    // 5. y = scores (x dt) + exp(cum) (C state); blocks past the diagonal are zero
    switch (warp / 2) {
      case 0:
        y_intra_mma<16>(sc_a, Xs, dts, xo_y, tq, yin, yin_c);
        break;
      case 1:
        y_intra_mma<32>(sc_a, Xs, dts, xo_y, tq, yin, yin_c);
        break;
      case 2:
        y_intra_mma<48>(sc_a, Xs, dts, xo_y, tq, yin, yin_c);
        break;
      default:
        y_intra_mma<64>(sc_a, Xs, dts, xo_y, tq, yin, yin_c);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = y_r0 + gq + 8 * half;
      if (i < rows) {
        const float e = ecum[i];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          T* out = yb + (long long)(c0 + i) * y_ss + y_c0 + 8 * j + 2 * tq;
          const int e0 = 2 * half, e1 = 2 * half + 1;
          put(out, fmaf(e, yoff[j][e0] + yoff_c[j][e0], yin[j][e0] + yin_c[j][e0]));
          put(out + 1, fmaf(e, yoff[j][e1] + yoff_c[j][e1], yin[j][e1] + yin_c[j][e1]));
        }
      }
    }

    // 6. state = state exp(total) + B^T (x dt exp(total - cum)), on this warp's piece
    if (state_warp) {
      float dl[NTS][4], dl_c[NTS][4];
      zero(dl);
      zero(dl_c);
#pragma unroll
      for (int k0 = 0; k0 < Q; k0 += 8) {
        const float w0 = dtw[k0 + tq], w1 = dtw[k0 + tq + 4];
        const char* xr = Xs + k0 * TX::ROWB;
        const char* br = Bs + k0 * TN::ROWB;
        FragA fa;
        const float av[4] = {*reinterpret_cast<const float*>(xr + xo_s[0][0]) * w0,
                             *reinterpret_cast<const float*>(xr + xo_s[1][0]) * w0,
                             *reinterpret_cast<const float*>(xr + xo_s[0][1]) * w1,
                             *reinterpret_cast<const float*>(xr + xo_s[1][1]) * w1};
        fa.set(av);
        FragB fb[NTS];
#pragma unroll
        for (int j = 0; j < NTS; ++j) {
          fb[j].set(*reinterpret_cast<const float*>(br + bo_s[j][0]),
                    *reinterpret_cast<const float*>(br + bo_s[j][1]));
        }
        mma3(dl, dl_c, fa, fb);
      }
      const float decay = tot[0];
#pragma unroll
      for (int j = 0; j < NTS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = sp0 + gq + 8 * (e >> 1);
          const int n = sn0 + 8 * j + 2 * tq + (e & 1);
          sreg[j][e] = fmaf(sreg[j][e], decay, dl[j][e] + dl_c[j][e]);
          st[p * LDST + n] = sreg[j][e];
        }
    }
    __syncthreads();  // the next sub-chunk overwrites this stage, the scores and the state
  }

  if (state_warp) {
#pragma unroll
    for (int j = 0; j < NTS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = sp0 + gq + 8 * (e >> 1);
        const int n = sn0 + 8 * j + 2 * tq + (e & 1);
        final_state[st_base + (long long)p * N + n] = sreg[j][e];
      }
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init, void* y, float* final_state, int B, int S, int H, int G,
           int P, const long long* st, cudaStream_t stream) {
  constexpr int smem = Smem<T, N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P / PS, H, B);
  ssd_scan_kernel<T, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init, static_cast<T*>(y), final_state, S, H, G, P, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* init, void* y, float* final_state, int B, int S,
             int H, int G, int P, const long long* st, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, G, P, st, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, G, P, st, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, G, P, st, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, G, P, st, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype of x, B, C and y: 0 = bf16, 1 = fp32; dt and A are fp32.  `strides` (in
// elements): batch, row and head strides of x, then of dt, then batch, row and
// group strides of B and of C; the last dimension of x, B and C has stride 1,
// and their rows start on 16 bytes.  `init` may be null (zeros).  Returns 0, a
// cudaError_t of the launch, or -1 for arguments the kernel does not take.
extern "C" int dco_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* init, void* y, void* final_state,
                            int dtype, int B, int S, int H, int G, int P, int N,
                            const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -1;
  if (P <= 0 || P % PS != 0 || B > 65535 || H > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* in = static_cast<const float*>(init);
  float* fs = static_cast<float*>(final_state);
  if (dtype == 0)
    return launch_n<__nv_bfloat16>(N, x, dtf, af, Bm, Cm, in, y, fs, B, S, H, G, P,
                                   strides, s);
  if (dtype == 1)
    return launch_n<float>(N, x, dtf, af, Bm, Cm, in, y, fs, B, S, H, G, P, strides, s);
  return -1;
}
