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
// What the design does about it, and what it leaves for later:
//  * The pinned KV prefix has an explicit home.  On the TPU a constant block
//    index lets the compiler skip the re-copy; a GPU has no such thing, so one
//    block per (batch, KV head, chunk of Q tiles) stages `pinned_rows` rows of K
//    and V in dynamic shared memory once and reuses them for every Q tile of its
//    chunk and every query head of the GQA group.  The rest of K/V is streamed
//    tile by tile, per Q tile and head, and never claims resident memory.
//    `pinned_rows` changes the schedule only, never the result beyond the order
//    of fp32 sums.
//  * Q, K, V and O are read and written in (B, S, heads, D) layout through
//    strides: no transposed copies, no dummy operands.
//  * Any Sq and Sk: ragged Q and KV tails are masked here.  Causal masking is by
//    absolute position (Sq == Sk); tiles wholly above the diagonal are skipped.
//  * The products are fp32 FMA on shared-memory tiles (64 x 64 scores, a 4 x 4
//    patch a thread), for bf16 and fp32 inputs alike: exact fp32 accumulation,
//    no TF32.  Rows are staged with one pad word so that 16 lanes reading 16
//    consecutive rows hit 16 banks.  Tensor-core products (mma.sync, then wgmma
//    fed by TMA) are the next step and would lift the bf16 path by an order of
//    magnitude; this version is the simple one that is right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows of a tile
constexpr int BK = 64;        // KV rows of a tile
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows ty*4.., cols tx+16*j
constexpr int LDP = BK + 1;
constexpr int SMEM_LIMIT = 232448;

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

template <>
struct Word<__nv_bfloat16> {
  static constexpr int EPW = 2;
  static __device__ __forceinline__ void unpack(uint32_t w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack(const float* x) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[0]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(x[1]));
    return lo | (hi << 16);
  }
};

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
             int H, int G, int tiles_per_chunk, int pinned_rows, int causal,
             float scale, float softcap, long long q_sb, long long q_ss,
             long long q_sh, long long k_sb, long long k_ss, long long k_sg,
             long long v_sb, long long v_ss, long long v_sg, long long o_sb,
             long long o_ss, long long o_sh) {
  constexpr int EPW = Word<T>::EPW;
  constexpr int WPR = D / EPW;  // words of one row
  constexpr int LD = WPR + 1;   // padded row stride in shared memory
  constexpr int NJ = WPR / 16;  // output words a thread owns in each row

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

  // the pinned prefix: staged once, as far as this block's Q rows can see it
  const int kv_need = causal ? min(Sk, qt1 * BQ) : Sk;
  const int pin = min(pinned_rows, kv_need);
  stage_rows<WPR, LD>(pinK, kb, k_ss, pin);
  stage_rows<WPR, LD>(pinV, vb, v_ss, pin);

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q_lo = qt * BQ;
    const int kv_end = causal ? min(Sk, q_lo + BQ) : Sk;
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

      for (int t = 0; t < n_kv_tiles; ++t) {
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
            ok[j] = col < kv_end && (!causal || col <= row);
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
           int H, int G, int tiles_per_chunk, int pinned_rows, int causal, float scale,
           float softcap, const long long* st, cudaStream_t stream) {
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
      tiles_per_chunk, pinned_rows, causal, scale, softcap, w[0], w[1], w[2], w[3],
      w[4], w[5], w[6], w[7], w[8], w[9], w[10], w[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  `strides` (in elements): batch, row and head strides
// of q, then k, v and o; the last dimension of each has stride 1.  `softcap` 0
// means none.  `pinned_rows` is Sk or a multiple of 64.  Returns 0, a cudaError_t,
// -1 for arguments the kernel does not take, or -2 when `pinned_rows` does not fit
// the shared memory a block may take.
extern "C" int dco_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int G, int D,
                                   int tiles_per_chunk, int pinned_rows, int causal,
                                   float scale, float softcap, const long long* strides,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || G <= 0 || H % G != 0) return -1;
  if (B > 65535 || G > 65535 || tiles_per_chunk <= 0) return -1;
  if (pinned_rows < 0 || pinned_rows > Sk) return -1;
  if (pinned_rows != Sk && pinned_rows % BK != 0) return -1;
  if (causal && Sq != Sk) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, scale, softcap, strides, s);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, scale, softcap, strides, s);
  if (dtype == 1 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, scale, softcap, strides, s);
  if (dtype == 1 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, H, G, tiles_per_chunk, pinned_rows, causal, scale, softcap, strides, s);
  return -1;
}
