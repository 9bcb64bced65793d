// Decode attention for Hopper (sm_90a): one query token per sequence against a
// KV cache.
//
// Replaces the Pallas-TPU kernel `decode_kernel`
// (src/repro/kernels/decode_attention/kernel.py, built by build_decode_call,
// wrapped by ops.py::decode_attention).
//
// Bound on an H100: bytes.  Every cached K and V row below cache_len is read
// once (2 * B * G * cache_len * D * itemsize bytes) and each row feeds only
// `group = H / G` dot products, far below the card's operations-per-byte
// ridge, so the least time is those bytes over the memory rate.
//
// What the design does about it:
//  * K/V are read in the cache's own (B, S, G, D) layout through strides, 16
//    bytes a lane, 8 lanes side by side on one row: no transposed copy of the
//    cache is ever made.
//  * All query heads of a GQA group (up to 4 per block) share each fetched row,
//    as the TPU kernel shares each fetched block.
//  * The TPU grid walks the KV axis in order and carries (m, l, acc) between
//    grid steps.  Blocks on a GPU run unordered, so the KV walk is a loop
//    inside the block, and because B * G blocks cannot fill 132 SMs the valid
//    range [0, cache_len) is cut into `n_splits` pieces: each block writes a
//    partial (m, l, acc) to scratch the wrapper allocated, and a small second
//    kernel combines them.  This is the split version, always two launches.
//  * Each block reads its own cache_len[b]; rows at or past it are never
//    loaded, and a sequence with cache_len 0 yields zeros.
//  * `group` is below any tensor-core tile height, so the products are
//    multiply-reduce in fp32 registers (no TF32 for fp32 inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int LANES_PER_ROW = 8;
constexpr int ROWS_PER_ITER = THREADS / LANES_PER_ROW;  // 16 rows a block step

// 16 bytes of T widened to floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  static __device__ __forceinline__ float to(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
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

// Partial attention of HPB query heads of one KV group over one split of the
// valid KV range.  grid = (n_splits, G * (group / HPB), B).
template <typename T, int D, int HPB>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ cache_len,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int S, int H, int G,
                      int n_splits, float scale, long long q_sb, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sg,
                      long long v_sb, long long v_ss, long long v_sg) {
  constexpr int VEC = Vec<T>::N;
  constexpr int NCH = D / (VEC * LANES_PER_ROW);  // 16-byte chunks a lane owns
  constexpr int EPL = NCH * VEC;                   // elements a lane owns

  __shared__ float sm_m[ROWS_PER_ITER][HPB];
  __shared__ float sm_l[ROWS_PER_ITER][HPB];
  __shared__ float sm_acc[ROWS_PER_ITER][HPB][D];

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int group = H / G;
  const int blocks_per_group = group / HPB;
  const int g = blockIdx.y / blocks_per_group;
  const int h0 = g * group + (blockIdx.y % blocks_per_group) * HPB;

  const int tid = threadIdx.x;
  const int sub = tid % LANES_PER_ROW;
  const int rgrp = tid / LANES_PER_ROW;

  int len = cache_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  int chunk = (len + n_splits - 1) / n_splits;
  chunk = (chunk + ROWS_PER_ITER - 1) / ROWS_PER_ITER * ROWS_PER_ITER;
  const int start = split * chunk;
  const int end = min(len, start + chunk);

  float qr[HPB][EPL];
#pragma unroll
  for (int hh = 0; hh < HPB; ++hh) {
    const T* qp = q + b * q_sb + (long long)(h0 + hh) * q_sh;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      Vec<T>::load(qp + (sub + c * LANES_PER_ROW) * VEC, &qr[hh][c * VEC]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[hh][e] *= scale;
  }

  float m[HPB], l[HPB], acc[HPB][EPL];
#pragma unroll
  for (int hh = 0; hh < HPB; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[hh][e] = 0.f;
  }

  const T* kb = k + b * k_sb + g * k_sg;
  const T* vb = v + b * v_sb + g * v_sg;
  for (int base = start; base < end; base += ROWS_PER_ITER) {
    const int row = base + rgrp;
    const bool valid = row < end;
    float kf[EPL], vf[EPL];
    if (valid) {
      const T* kp = kb + (long long)row * k_ss;
      const T* vp = vb + (long long)row * v_ss;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        Vec<T>::load(kp + (sub + c * LANES_PER_ROW) * VEC, &kf[c * VEC]);
        Vec<T>::load(vp + (sub + c * LANES_PER_ROW) * VEC, &vf[c * VEC]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kf[e] = 0.f;
        vf[e] = 0.f;
      }
    }
#pragma unroll
    for (int hh = 0; hh < HPB; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qr[hh][e] * kf[e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (valid) {
        const float m_new = fmaxf(m[hh], s);
        const float alpha = expf(m[hh] - m_new);
        const float p = expf(s - m_new);
        l[hh] = l[hh] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[hh][e] = acc[hh][e] * alpha + p * vf[e];
        m[hh] = m_new;
      }
    }
  }

  // merge the 16 row groups of the block
#pragma unroll
  for (int hh = 0; hh < HPB; ++hh) {
    if (sub == 0) {
      sm_m[rgrp][hh] = m[hh];
      sm_l[rgrp][hh] = l[hh];
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sm_acc[rgrp][hh][(sub + c * LANES_PER_ROW) * VEC + e] = acc[hh][c * VEC + e];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < HPB * D; idx += THREADS) {
    const int hh = idx / D;
    const int d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < ROWS_PER_ITER; ++r) mx = fmaxf(mx, sm_m[r][hh]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS_PER_ITER; ++r) {
      const float w = expf(sm_m[r][hh] - mx);
      lsum += sm_l[r][hh] * w;
      a += sm_acc[r][hh][d] * w;
    }
    const long long slot = ((long long)b * H + (h0 + hh)) * n_splits + split;
    part_acc[slot * D + d] = a;
    if (d == 0) {
      part_m[slot] = mx;
      part_l[slot] = lsum;
    }
  }
}

// out[b, h, :] = sum_i acc_i * exp(m_i - M) / max(sum_i l_i * exp(m_i - M), 1e-30)
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int n_splits) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  float mx = NEG_INF;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, part_m[bh * n_splits + i]);
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float w = expf(part_m[bh * n_splits + i] - mx);
    lsum += part_l[bh * n_splits + i] * w;
    a += part_acc[(bh * n_splits + i) * D + d] * w;
  }
  out[bh * D + d] = Vec<T>::to(a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D, int HPB>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           void* out, float* scratch, int B, int S, int H, int G, int n_splits,
           float scale, const long long* st, cudaStream_t stream) {
  const int group = H / G;
  const long long n_part = (long long)B * H * n_splits;
  float* part_m = scratch;
  float* part_l = scratch + n_part;
  float* part_acc = scratch + 2 * n_part;
  const dim3 grid(n_splits, G * (group / HPB), B);
  decode_partial_kernel<T, D, HPB><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      cache_len, part_m, part_l, part_acc, S, H, G, n_splits, scale, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<B * H, D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_hpb(int hpb, const void* q, const void* k, const void* v,
               const int* cache_len, void* out, float* scratch, int B, int S, int H,
               int G, int n_splits, float scale, const long long* st,
               cudaStream_t stream) {
  switch (hpb) {
    case 1:
      return launch<T, D, 1>(q, k, v, cache_len, out, scratch, B, S, H, G, n_splits, scale, st, stream);
    case 2:
      return launch<T, D, 2>(q, k, v, cache_len, out, scratch, B, S, H, G, n_splits, scale, st, stream);
    case 3:
      return launch<T, D, 3>(q, k, v, cache_len, out, scratch, B, S, H, G, n_splits, scale, st, stream);
    default:
      return launch<T, D, 4>(q, k, v, cache_len, out, scratch, B, S, H, G, n_splits, scale, st, stream);
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  `strides` (in elements): q batch, q head, k batch,
// k row, k kv-head, v batch, v row, v kv-head; the last dimension of q, k and v
// has stride 1, `out` is contiguous (B, H, D).  `scratch` holds
// B * H * n_splits * (D + 2) floats.  Returns 0, a cudaError_t of the launch, or
// -1 for arguments the kernel does not take.
extern "C" int dco_decode_attention(const void* q, const void* k, const void* v,
                                    const void* cache_len, void* out, void* scratch,
                                    int dtype, int B, int S, int H, int G, int D,
                                    int n_splits, float scale,
                                    const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || n_splits <= 0) return -1;
  if (B > 65535 || (long long)G * (H / G) > 65535) return -1;
  const int group = H / G;
  int hpb = 1;
  if (group <= 4) hpb = group;
  else if (group % 4 == 0) hpb = 4;
  else if (group % 3 == 0) hpb = 3;
  else if (group % 2 == 0) hpb = 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(cache_len);
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0 && D == 128)
    return launch_hpb<__nv_bfloat16, 128>(hpb, q, k, v, lens, out, scr, B, S, H, G, n_splits, scale, strides, s);
  if (dtype == 0 && D == 64)
    return launch_hpb<__nv_bfloat16, 64>(hpb, q, k, v, lens, out, scr, B, S, H, G, n_splits, scale, strides, s);
  if (dtype == 1 && D == 128)
    return launch_hpb<float, 128>(hpb, q, k, v, lens, out, scr, B, S, H, G, n_splits, scale, strides, s);
  if (dtype == 1 && D == 64)
    return launch_hpb<float, 64>(hpb, q, k, v, lens, out, scr, B, S, H, G, n_splits, scale, strides, s);
  return -1;
}
