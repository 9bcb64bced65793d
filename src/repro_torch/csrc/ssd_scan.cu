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
// fp32 as (B, H, P, N).  All arithmetic is fp32.
//
// Bound on an H100: operations.  At the serving shape (prompt 1024, 80 heads,
// P 64, N 128) the chunked algorithm at this kernel's 64-row sub-chunks does
// about 3.7 GFLOP a layer against some 46 MB moved, far above the fp32 ridge
// of the card.
//
// What the design does about it, and what it leaves for later:
//  * The TPU walks the chunk axis as a sequential grid dimension with the state
//    in VMEM scratch.  Here one block walks all the chunks of its (batch, head)
//    in a loop and keeps the running state (P slice x N fp32) in shared memory
//    from the first row to the last; it is written to device memory once, at
//    the end.  No per-chunk state ever reaches device memory: that state has a
//    one-chunk lifetime, the dead-block idea of the DCO paper.
//  * Columns of P are independent (y[:, p] and state[p, :] depend only on
//    x[:, p]), so a block owns a slice of PS = 32 columns and the grid is
//    (P / 32, H, B): 160 blocks for one mamba2-2.7b prompt instead of 80 for
//    132 SMs.  Each slice recomputes its chunk's C B^T o L, which is exact.
//  * x, dt, B and C are read in the model's own layouts through strides; head h
//    reads group h / (H / G).  The transposes and the repeat of B/C over heads
//    that the TPU wrapper makes do not exist here.
//  * Shared memory caps the tile: B and C of one 256-row chunk at N 128 in fp32
//    are 128 KB each.  The kernel walks 64-row sub-chunks; in exact arithmetic
//    the result does not depend on the chunk, and the wrapper keeps the
//    reference's `chunk` argument and its S % chunk rule.  At N 128 a block
//    takes 110 KB, so two blocks share an SM.
//  * Products are fp32 FMA on shared-memory tiles (a 4 x 4 patch of scores, a
//    4 x 2 patch of y, 4 float4 of state a thread), with B/C rows padded by 4
//    words so that 8 consecutive rows read as float4 hit distinct banks.  Only
//    the 10 of 16 score blocks of 16 x 16 on or below the diagonal are computed.
//    Tensor cores (mma.sync / wgmma in TF32 or on bf16 inputs) and splitting the
//    chunk loop across blocks with a second pass are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;         // rows of a sub-chunk
constexpr int PS = 32;        // columns of P a block owns
constexpr int THREADS = 256;  // 16 x 16: thread (ti, tj) owns rows ti + 16 r, cols tj + 16 c
constexpr int LDS = Q + 1;    // row stride of the score tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared-memory layout (in floats) for state size N.
template <int N>
struct Smem {
  static constexpr int LDN = N + 4;  // row stride of B, C and the state
  static constexpr int B_OFF = 0;
  static constexpr int C_OFF = B_OFF + Q * LDN;
  static constexpr int ST_OFF = C_OFF + Q * LDN;
  static constexpr int X_OFF = ST_OFF + PS * LDN;   // x * dt, (Q, PS)
  static constexpr int S_OFF = X_OFF + Q * PS;      // (C B^T) o L, (Q, LDS)
  static constexpr int DT_OFF = S_OFF + Q * LDS;
  static constexpr int CUM_OFF = DT_OFF + Q;
  static constexpr int ECUM_OFF = CUM_OFF + Q;      // exp(cum)
  static constexpr int WDEC_OFF = ECUM_OFF + Q;     // exp(total - cum)
  static constexpr int TOT_OFF = WDEC_OFF + Q;
  static constexpr int FLOATS = TOT_OFF + 4;
  static constexpr int BYTES = FLOATS * 4;
};

// grid = (P / PS, H, B).  y is contiguous (B, S, H, P); init and final_state
// are contiguous (B, H, P, N).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ final_state, int S, int H, int G,
                int P, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
                long long b_sg, long long c_sb, long long c_ss, long long c_sg) {
  using L = Smem<N>;
  constexpr int LDN = L::LDN;
  // state update: TN float4 columns side by side, PSTEP rows of P a pass
  constexpr int TN = (N / 4 < 16) ? N / 4 : 16;
  constexpr int PSTEP = THREADS / TN;
  constexpr int NK = N / (4 * TN);
  constexpr int PC = (PS + PSTEP - 1) / PSTEP;
  constexpr int YC = PS / 16;

  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Bs = sm + L::B_OFF;
  float* Cs = sm + L::C_OFF;
  float* st = sm + L::ST_OFF;
  float* xs = sm + L::X_OFF;
  float* Ss = sm + L::S_OFF;
  float* dts = sm + L::DT_OFF;
  float* cum = sm + L::CUM_OFF;
  float* ecum = sm + L::ECUM_OFF;
  float* wdec = sm + L::WDEC_OFF;
  float* tot = sm + L::TOT_OFF;

  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int en = tid % TN, ep = tid / TN;
  const float a = A[h];

  const T* xb = x + b * x_sb + h * x_sh + p0;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* Bb = Bm + b * b_sb + g * b_sg;
  const T* Cb = Cm + b * c_sb + g * c_sg;
  const long long y_ss = (long long)H * P;
  T* yb = y + (long long)b * S * y_ss + (long long)h * P + p0;
  const long long st_base = (((long long)b * H + h) * P + p0) * N;

  for (int idx = tid; idx < PS * N; idx += THREADS) {
    st[(idx / N) * LDN + idx % N] = init != nullptr ? init[st_base + idx] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);

    // 1. stage dt, B and C; rows past the end are zeros: they add nothing and,
    //    with dt 0, carry no decay
    if (tid < Q) dts[tid] = tid < rows ? dtb[(long long)(c0 + tid) * dt_ss] : 0.f;
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      float bv = 0.f, cv = 0.f;
      if (i < rows) {
        bv = to_f(Bb[(long long)(c0 + i) * b_ss + n]);
        cv = to_f(Cb[(long long)(c0 + i) * c_ss + n]);
      }
      Bs[i * LDN + n] = bv;
      Cs[i * LDN + n] = cv;
    }
    __syncthreads();

    // 2. inclusive cumsum of dt * A (warp 0: lane l holds rows l and 32 + l),
    //    and x * dt
    if (tid < 32) {
      float lo = dts[tid] * a, hi = dts[32 + tid] * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float tl = __shfl_up_sync(0xffffffffu, lo, off);
        const float th = __shfl_up_sync(0xffffffffu, hi, off);
        if (tid >= off) {
          lo += tl;
          hi += th;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      const float total = __shfl_sync(0xffffffffu, hi, 31);
      cum[tid] = lo;
      cum[32 + tid] = hi;
      ecum[tid] = expf(lo);
      ecum[32 + tid] = expf(hi);
      wdec[tid] = expf(total - lo);
      wdec[32 + tid] = expf(total - hi);
      if (tid == 0) tot[0] = total;
    }
    for (int idx = tid; idx < Q * PS; idx += THREADS) {
      const int i = idx / PS, p = idx % PS;
      xs[idx] = i < rows ? to_f(xb[(long long)(c0 + i) * x_ss + p]) * dts[i] : 0.f;
    }
    __syncthreads();

    // 3. scores (C B^T) o L on and below the diagonal, zeros above
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * r) * LDN + n);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(Bs + (tj + 16 * c) * LDN + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) acc[r][c] = dot4(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        const float ci = cum[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          float v = 0.f;
          if (c <= r && j <= i) v = acc[r][c] * expf(ci - cum[j]);
          Ss[i * LDS + j] = v;
        }
      }
    }
    __syncthreads();

    // 4. y = scores (x dt) + exp(cum) (C state), with the state of the rows
    //    before this sub-chunk
    {
      float acc[4][YC], off[4][YC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < YC; ++c) {
          acc[r][c] = 0.f;
          off[r][c] = 0.f;
        }
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
#pragma unroll 4
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * jb + jj;
          float xv[YC];
#pragma unroll
          for (int c = 0; c < YC; ++c) xv[c] = xs[j * PS + tj + 16 * c];
#pragma unroll
          for (int r = jb; r < 4; ++r) {
            const float s = Ss[(ti + 16 * r) * LDS + j];
#pragma unroll
            for (int c = 0; c < YC; ++c) acc[r][c] = fmaf(s, xv[c], acc[r][c]);
          }
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[YC];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * r) * LDN + n);
#pragma unroll
        for (int c = 0; c < YC; ++c)
          sv[c] = *reinterpret_cast<const float4*>(st + (tj + 16 * c) * LDN + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < YC; ++c) off[r][c] = dot4(cv[r], sv[c], off[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i < rows) {
          const float e = ecum[i];
#pragma unroll
          for (int c = 0; c < YC; ++c)
            put(yb + (long long)(c0 + i) * y_ss + tj + 16 * c, fmaf(e, off[r][c], acc[r][c]));
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // 5. state = state exp(total) + B^T (x dt exp(total - cum)); each thread
    //    updates its own entries
    {
      float4 acc[PC][NK];
#pragma unroll
      for (int pc = 0; pc < PC; ++pc)
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[pc][k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float w = wdec[j];
        float xw[PC];
#pragma unroll
        for (int pc = 0; pc < PC; ++pc) {
          const int p = ep + PSTEP * pc;
          xw[pc] = p < PS ? xs[j * PS + p] * w : 0.f;
        }
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + j * LDN + 4 * (en + TN * k));
#pragma unroll
          for (int pc = 0; pc < PC; ++pc) {
            acc[pc][k].x = fmaf(bv.x, xw[pc], acc[pc][k].x);
            acc[pc][k].y = fmaf(bv.y, xw[pc], acc[pc][k].y);
            acc[pc][k].z = fmaf(bv.z, xw[pc], acc[pc][k].z);
            acc[pc][k].w = fmaf(bv.w, xw[pc], acc[pc][k].w);
          }
        }
      }
      const float decay = expf(tot[0]);
#pragma unroll
      for (int pc = 0; pc < PC; ++pc) {
        const int p = ep + PSTEP * pc;
        if (p < PS) {
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            float4* sp = reinterpret_cast<float4*>(st + p * LDN + 4 * (en + TN * k));
            float4 s = *sp;
            s.x = fmaf(s.x, decay, acc[pc][k].x);
            s.y = fmaf(s.y, decay, acc[pc][k].y);
            s.z = fmaf(s.z, decay, acc[pc][k].z);
            s.w = fmaf(s.w, decay, acc[pc][k].w);
            *sp = s;
          }
        }
      }
    }
    __syncthreads();  // the next sub-chunk overwrites B, C and x
  }

  for (int idx = tid; idx < PS * N; idx += THREADS) {
    final_state[st_base + idx] = st[(idx / N) * LDN + idx % N];
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init, void* y, float* final_state, int B, int S, int H, int G,
           int P, const long long* st, cudaStream_t stream) {
  constexpr int smem = Smem<N>::BYTES;
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
// group strides of B and of C; the last dimension of x, B and C has stride 1.
// `init` may be null (zeros).  Returns 0, a cudaError_t of the launch, or -1 for
// arguments the kernel does not take.
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
    return launch_n<__nv_bfloat16>(N, x, dtf, af, Bm, Cm, in, y, fs, B, S, H, G, P, strides, s);
  if (dtype == 1)
    return launch_n<float>(N, x, dtf, af, Bm, Cm, in, y, fs, B, S, H, G, P, strides, s);
  return -1;
}
