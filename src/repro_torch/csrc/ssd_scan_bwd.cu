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
// and dB, dC of group g are the sums of dB^h, dC^h over its heads.  Both walks
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
// sub-chunk) with the causal products counted at half (37.6 GFLOP a layer;
// this kernel forms dY X^T in both walks, Q^2 P more), against some 0.26 GB
// moved (x, dy and dx dominate): 0.23 ms at 3xTF32's 165 TFLOP/s, 0.08 ms at
// the memory rate.
//
// This first design is simple and exact rather than fast: fp32 FMA on tiles in
// shared memory, 256 threads a block as 16 x 16, thread (ty, tx) owning rows
// 4 ty + i and columns tx + 16 j of each 64-row output block.  Every tile row is
// padded by one word, so that the 16 lanes of a row (or the 16 rows a column
// load walks) hit 16 banks in every product, whichever way an operand is read.
// Left for later: 3xTF32 on mma.sync as the forward, a ring that stages the
// next sub-chunk while one computes, and splitting the chunk walk over blocks.
//
// Three launches, deterministic, no atomics:
//  (1) fwd_walk_kernel, a block per (b, h): recomputes the running state from
//      x, dt, A, B and init (the forward writes no per-chunk state: the
//      dead-block idea) and writes dC^h (B, S, H, N) fp32 and <dFinal, final>.
//  (2) rev_walk_kernel, a block per (b, h): walks the sub-chunks last to first
//      with R on chip, writes dx, ddt, dB^h (B, S, H, N) fp32, dinit, and the
//      block's partial of dA; the reverse running sum of dcum is carried from
//      one sub-chunk to the one before.
//  (3) head_sum_kernel: dB and dC of each group, summed over its heads in
//      order, and dA summed over the batch in order.
// The sums behind dt's and A's gradients cancel (dA of a trained layer is a
// small difference of large terms), so dcum, its reverse running sum and dA's
// partials are fp64 scalars: a few operations a row, off the products' path.
//
// Computed here: fp32 inputs, P 32 or 64, N 16, 32, 64 or 128, any S (rows
// past S are zeros: they add nothing and, with dt 0, carry no decay), G >= 1,
// x, dt, B and C read through their strides.  The wrapper refuses bf16 and
// other sizes before any launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;         // rows of a sub-chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDQ = Q + 1;    // padded row of a Q x Q tile
constexpr float LOG2E = 1.4426950408889634f;

template <int TN>
__device__ __forceinline__ void zero(float (&acc)[4][TN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k A(4 ty + i, k) ks[k] B(k, tx + 16 j), with A(r, k) =
// A[r * ASI + k * ASK] and B(k, c) = B[k * BSK + c * BSJ] in shared memory;
// ks null means ones.
template <int TN, int K, int ASI, int ASK, int BSK, int BSJ>
__device__ __forceinline__ void fma_tile(float (&acc)[4][TN], const float* A, const float* B,
                                         const float* ks) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* a0 = A + 4 * ty * ASI;
  const float* b0 = B + tx * BSJ;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float s = ks != nullptr ? ks[k] : 1.f;
    float av[4], bv[TN];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a0[i * ASI + k * ASK] * s;
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b0[k * BSK + 16 * j * BSJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Q rows of COLS floats from `src` (rows `stride` apart, unit stride along a
// row) into rows of `ld` floats; rows from `valid` on are zeros.
template <int COLS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int valid) {
  for (int i = threadIdx.x; i < Q * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    dst[r * ld + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// Warp 0: the sub-chunk's inclusive cumsum of dt a (lane l holds rows l and
// 32 + l) into cum2 (log2 units), ecum = exp(cum), w = exp(tot - cum) (times dt
// where `with_dt`), and tot = exp(total).
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a, float* cum2,
                                             float* ecum, float* w, float* tot,
                                             bool with_dt) {
  const int lane = threadIdx.x % 32;
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

// Sum over the 16 lanes of a half-warp (the tx of one ty).
__device__ __forceinline__ double half_warp_sum(double v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// Shared memory (floats) of the two walks.
template <int P, int N>
struct Layout {
  static constexpr int LDP = P + 1, LDN = N + 1;
  // forward walk: X, DY, Bs, ST, ML, then dts, cum2, ecum, w, tot, the
  // reduction (fp64; every offset is even, so it sits on 8 bytes)
  static constexpr int F_X = 0, F_DY = F_X + Q * LDP, F_B = F_DY + Q * LDP,
                       F_ST = F_B + Q * LDN, F_ML = F_ST + P * LDN, F_V = F_ML + Q * LDQ,
                       F_FLOATS = F_V + 4 * Q + 4 + 2 * (THREADS / 32);
  // reverse walk: X, DY, Bs, Cs, R, SL, ML, then dts, cum2, ecum, w, dxdx,
  // dcum (fp64), tot
  static constexpr int R_X = 0, R_DY = R_X + Q * LDP, R_B = R_DY + Q * LDP,
                       R_C = R_B + Q * LDN, R_R = R_C + Q * LDN, R_SL = R_R + P * LDN,
                       R_ML = R_SL + Q * LDQ, R_V = R_ML + Q * LDQ,
                       R_FLOATS = R_V + 7 * Q + 4;
};

// (1) grid (H, B).  dch is (B, S, H, N); fdot[b H + h] = <dFinal, final state>
// (0 without dFinal), summed in fp64.
template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
fwd_walk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ init, const float* __restrict__ dy,
                const float* __restrict__ dfinal, float* __restrict__ dch,
                double* __restrict__ fdot, int S, int H, int G, Strides st) {
  using L = Layout<P, N>;
  constexpr int LDP = L::LDP, LDN = L::LDN;
  constexpr int WN = N < 64 ? N : 64;  // columns of an output block of N
  constexpr int TNN = WN / 16;
  extern __shared__ float sm[];
  float* X = sm + L::F_X;
  float* DY = sm + L::F_DY;
  float* Bs = sm + L::F_B;
  float* ST = sm + L::F_ST;
  float* ML = sm + L::F_ML;
  float* dts = sm + L::F_V;
  float* cum2 = dts + Q;
  float* ecum = cum2 + Q;
  float* w = ecum + Q;
  float* tot = w + Q;
  double* red = reinterpret_cast<double*>(tot + 4);

  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = A[h];
  const long long st_base = ((long long)b * H + h) * P * N;
  const float* xb = x + b * st.x_sb + h * st.x_sh;
  const float* dtb = dt + b * st.dt_sb + h * st.dt_sh;
  const float* Bb = Bm + b * st.b_sb + g * st.b_sg;
  const long long dy_ss = (long long)H * P;
  const float* dyb = dy + (long long)b * S * dy_ss + (long long)h * P;

  for (int i = tid; i < P * N; i += THREADS)
    ST[(i / N) * LDN + i % N] = init != nullptr ? init[st_base + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int valid = min(Q, S - c0);
    load_rows<P>(X, LDP, xb + c0 * st.x_ss, st.x_ss, valid);
    load_rows<P>(DY, LDP, dyb + c0 * dy_ss, dy_ss, valid);
    load_rows<N>(Bs, LDN, Bb + c0 * st.b_ss, st.b_ss, valid);
    for (int r = tid; r < Q; r += THREADS) dts[r] = r < valid ? dtb[(c0 + r) * st.dt_ss] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, a, cum2, ecum, w, tot, true);
    __syncthreads();

    // ML[t][s] = dt_s L[t, s] (dy_t . x_s), zero above the diagonal
    {
      float acc[4][4];
      zero(acc);
      fma_tile<4, P, LDP, 1, 1, LDP>(acc, DY, X, nullptr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * ty + i, s = tx + 16 * j;
          ML[t * LDQ + s] = s <= t ? acc[i][j] * dts[s] * exp2f(cum2[t] - cum2[s]) : 0.f;
        }
    }
    __syncthreads();

    // dC^h = diag(exp(cum)) DY ST + ML Bs
#pragma unroll 1
    for (int nb = 0; nb < N; nb += WN) {
      float acc[4][TNN];
      zero(acc);
      fma_tile<TNN, P, LDP, 1, LDN, 1>(acc, DY, ST + nb, nullptr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TNN; ++j) acc[i][j] *= ecum[4 * ty + i];
      fma_tile<TNN, Q, LDQ, 1, LDN, 1>(acc, ML, Bs + nb, nullptr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        if (t < valid) {
          float* out = dch + (((long long)b * S + c0 + t) * H + h) * N + nb + tx;
#pragma unroll
          for (int j = 0; j < TNN; ++j) out[16 * j] = acc[i][j];
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // ST = exp(tot) ST + X^T diag(dt w) B
    if (4 * ty < P) {
#pragma unroll 1
      for (int nb = 0; nb < N; nb += WN) {
        float acc[4][TNN];
        zero(acc);
        fma_tile<TNN, Q, 1, LDP, LDN, 1>(acc, X, Bs + nb, w);
        const float decay = tot[0];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TNN; ++j) {
            float* e = ST + (4 * ty + i) * LDN + nb + tx + 16 * j;
            *e = fmaf(*e, decay, acc[i][j]);
          }
      }
    }
    __syncthreads();  // the next sub-chunk overwrites the tiles
  }

  // <dFinal, final state>, summed in a fixed order
  double part = 0.0;
  if (dfinal != nullptr)
    for (int i = tid; i < P * N; i += THREADS)
      part += (double)dfinal[st_base + i] * ST[(i / N) * LDN + i % N];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (tid % 32 == 0) red[tid / 32] = part;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    fdot[b * H + h] = s;
  }
}

// (2) grid (H, B).  dx is (B, S, H, P), ddt (B, S, H), dbh (B, S, H, N), dinit
// (B, H, P, N) (may be null); da_part[b H + h] is this block's sum of da dt.
// dcum, its reverse running sum da and the sum of da dt are kept in fp64: da
// sums up to S terms that cancel, and dA the products of S rows more.
template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
rev_walk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dy,
                const float* __restrict__ dfinal, const float* __restrict__ dch,
                const double* __restrict__ fdot, float* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ dbh, float* __restrict__ dinit,
                double* __restrict__ da_part, int S, int H, int G, Strides st) {
  using L = Layout<P, N>;
  constexpr int LDP = L::LDP, LDN = L::LDN;
  constexpr int WN = N < 64 ? N : 64;
  constexpr int TNN = WN / 16, TNP = P / 16;
  extern __shared__ float sm[];
  float* X = sm + L::R_X;
  float* DY = sm + L::R_DY;
  float* Bs = sm + L::R_B;
  float* Cs = sm + L::R_C;
  float* R = sm + L::R_R;
  float* SL = sm + L::R_SL;
  float* ML = sm + L::R_ML;
  float* dts = sm + L::R_V;
  float* cum2 = dts + Q;
  float* ecum = cum2 + Q;
  float* w = ecum + Q;
  float* dxdx = w + Q;
  double* dcum = reinterpret_cast<double*>(dxdx + Q);
  float* tot = dxdx + 3 * Q;

  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;
  const float a = A[h];
  const long long st_base = ((long long)b * H + h) * P * N;
  const float* xb = x + b * st.x_sb + h * st.x_sh;
  const float* dtb = dt + b * st.dt_sb + h * st.dt_sh;
  const float* Bb = Bm + b * st.b_sb + g * st.b_sg;
  const float* Cb = Cm + b * st.c_sb + g * st.c_sg;
  const long long dy_ss = (long long)H * P;
  const float* dyb = dy + (long long)b * S * dy_ss + (long long)h * P;

  for (int i = tid; i < P * N; i += THREADS)
    R[(i / N) * LDN + i % N] = dfinal != nullptr ? dfinal[st_base + i] : 0.f;
  // warp 0: the sum of dcum after the current sub-chunk, and its partial of dA
  double carry = fdot[b * H + h], da_dt = 0.0;

  const int n_sub = (S + Q - 1) / Q;
  for (int c = n_sub - 1; c >= 0; --c) {
    const int c0 = c * Q;
    const int valid = min(Q, S - c0);
    load_rows<P>(X, LDP, xb + c0 * st.x_ss, st.x_ss, valid);
    load_rows<P>(DY, LDP, dyb + c0 * dy_ss, dy_ss, valid);
    load_rows<N>(Bs, LDN, Bb + c0 * st.b_ss, st.b_ss, valid);
    load_rows<N>(Cs, LDN, Cb + c0 * st.c_ss, st.c_ss, valid);
    for (int r = tid; r < Q; r += THREADS) dts[r] = r < valid ? dtb[(c0 + r) * st.dt_ss] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, a, cum2, ecum, w, tot, false);
    __syncthreads();

    // SL[t'][t] = L[t', t] (C_t' . B_t) and ML[t'][t] = dt_t L[t', t] (dy_t' . x_t),
    // zero above the diagonal
    {
      float acc[4][4];
      zero(acc);
      fma_tile<4, N, LDN, 1, 1, LDN>(acc, Cs, Bs, nullptr);
      float acc2[4][4];
      zero(acc2);
      fma_tile<4, P, LDP, 1, 1, LDP>(acc2, DY, X, nullptr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tp = 4 * ty + i, t = tx + 16 * j;
          const float l = t <= tp ? exp2f(cum2[tp] - cum2[t]) : 0.f;
          SL[tp * LDQ + t] = acc[i][j] * l;
          ML[tp * LDQ + t] = acc2[i][j] * l * dts[t];
        }
    }
    __syncthreads();

    // dXD = diag(w) B R^T + SL^T DY; dx = dXD dt, dxdx_t = dXD_t . x_t
    {
      float acc[4][TNP];
      zero(acc);
      fma_tile<TNP, N, LDN, 1, 1, LDN>(acc, Bs, R, nullptr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TNP; ++j) acc[i][j] *= w[4 * ty + i];
      fma_tile<TNP, Q, 1, LDQ, LDP, 1>(acc, SL, DY, nullptr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < TNP; ++j) rs = fmaf(acc[i][j], X[t * LDP + tx + 16 * j], rs);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        if (tx == 0) dxdx[t] = rs;
        if (t < valid) {
          float* out = dx + (((long long)b * S + c0 + t) * H + h) * P + tx;
#pragma unroll
          for (int j = 0; j < TNP; ++j) out[16 * j] = acc[i][j] * dts[t];
        }
      }
    }

    // dB^h = diag(w dt) X R + ML^T Cs; dcum_t = C_t . dC^h_t - B_t . dB^h_t
    {
      double rs[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 1
      for (int nb = 0; nb < N; nb += WN) {
        float acc[4][TNN];
        zero(acc);
        fma_tile<TNN, P, LDP, 1, LDN, 1>(acc, X, R + nb, nullptr);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TNN; ++j) acc[i][j] *= w[4 * ty + i] * dts[4 * ty + i];
        fma_tile<TNN, Q, 1, LDQ, LDN, 1>(acc, ML, Cs + nb, nullptr);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * ty + i;
          if (t < valid) {
            const long long row = (((long long)b * S + c0 + t) * H + h) * N + nb + tx;
#pragma unroll
            for (int j = 0; j < TNN; ++j) {
              const int n = nb + tx + 16 * j;
              dbh[row + 16 * j] = acc[i][j];
              rs[i] += (double)Cs[t * LDN + n] * dch[row + 16 * j];
              rs[i] -= (double)Bs[t * LDN + n] * acc[i][j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double v = half_warp_sum(rs[i]);
        if (tx == 0) dcum[4 * ty + i] = v;
      }
    }
    __syncthreads();  // every read of R is done; dxdx and dcum are ready

    // R = exp(tot) R + DY^T diag(exp(cum)) Cs: the reverse state of the rows before
    if (4 * ty < P) {
#pragma unroll 1
      for (int nb = 0; nb < N; nb += WN) {
        float acc[4][TNN];
        zero(acc);
        fma_tile<TNN, Q, 1, LDP, LDN, 1>(acc, DY, Cs + nb, ecum);
        const float decay = tot[0];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TNN; ++j) {
            float* e = R + (4 * ty + i) * LDN + nb + tx + 16 * j;
            *e = fmaf(*e, decay, acc[i][j]);
          }
      }
    }

    // warp 0: da = the reverse running sum of dcum, from the carry; ddt and dA
    if (tid < 32) {
      double lo = dcum[lane], hi = dcum[32 + lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double tl = __shfl_down_sync(0xffffffffu, lo, off);
        const double th = __shfl_down_sync(0xffffffffu, hi, off);
        if (lane + off < 32) {
          lo += tl;
          hi += th;
        }
      }
      hi += carry;
      lo += __shfl_sync(0xffffffffu, hi, 0);
      carry = __shfl_sync(0xffffffffu, lo, 0);
      da_dt += lo * dts[lane] + hi * dts[32 + lane];
      if (lane < valid)
        ddt[((long long)b * S + c0 + lane) * H + h] = (float)(lo * a + dxdx[lane]);
      if (32 + lane < valid)
        ddt[((long long)b * S + c0 + 32 + lane) * H + h] = (float)(hi * a + dxdx[32 + lane]);
    }
    __syncthreads();  // the next sub-chunk overwrites the tiles; R is updated
  }

  if (dinit != nullptr)
    for (int i = tid; i < P * N; i += THREADS) dinit[st_base + i] = R[(i / N) * LDN + i % N];
  if (tid < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
    if (lane == 0) da_part[b * H + h] = da_dt;
  }
}

// (3) one thread an element of dB, then of dC (B, S, G, N), then of dA (H,).
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

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *init, *dy, *dfinal;
  float *dx, *ddt, *dA, *dB, *dC, *dinit, *dch, *dbh;
  double *fdot, *da_part;
  int B, S, H, G;
  Strides st;
};

template <int P, int N>
int launch(const Args& r, cudaStream_t stream) {
  using L = Layout<P, N>;
  constexpr int f_smem = L::F_FLOATS * 4, r_smem = L::R_FLOATS * 4;
  cudaError_t err = cudaFuncSetAttribute(fwd_walk_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, f_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rev_walk_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, r_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(r.H, r.B);
  fwd_walk_kernel<P, N><<<grid, THREADS, f_smem, stream>>>(
      r.x, r.dt, r.A, r.Bm, r.init, r.dy, r.dfinal, r.dch, r.fdot, r.S, r.H, r.G, r.st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rev_walk_kernel<P, N><<<grid, THREADS, r_smem, stream>>>(
      r.x, r.dt, r.A, r.Bm, r.Cm, r.dy, r.dfinal, r.dch, r.fdot, r.dx, r.ddt, r.dbh, r.dinit,
      r.da_part, r.S, r.H, r.G, r.st);
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
// strides of B and of C; the last dimension of x, B and C has stride 1).  dy
// is contiguous (B, S, H, P); init, dfinal and dinit contiguous (B, H, P, N),
// each may be null (zeros; dinit: not written).  Outputs dx (B, S, H, P), ddt
// (B, S, H), dA (H,), dB and dC (B, S, G, N), contiguous.  Scratch: dch and
// dbh (B, S, H, N) fp32, fdot and da_part (B, H) fp64.  Returns 0, a cudaError_t of a
// launch, or -1 for arguments the kernels do not take.
extern "C" int dco_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, const void* init, const void* dy,
                                const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                                void* dC, void* dinit, void* dch, void* dbh, void* fdot,
                                void* da_part, int B, int S, int H, int G, int P, int N,
                                const long long* strides, void* stream) {
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
         B, S, H, G,
         {strides[0], strides[1], strides[2], strides[3], strides[4], strides[5], strides[6],
          strides[7], strides[8], strides[9], strides[10], strides[11]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 32) return launch_n<32>(N, r, s);
  if (P == 64) return launch_n<64>(N, r, s);
  return -1;
}
