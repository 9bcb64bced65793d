// 3xTF32 on the tensor cores: an fp32 product to about fp32 accuracy from
// three TF32 products.  Each operand a = hi + lo with hi = tf32(a) and lo =
// tf32(a - hi), rounded to nearest as cvt.rna.tf32.f32 does but in integer
// operations, and a b ~ lo hi' + hi lo' + hi hi' (the lo lo' term, ~2^-22
// relative, is dropped).  Shared by the SSD scan's forward (ssd_scan.cu, on
// mma.sync) and backward (ssd_scan_bwd.cu, on wgmma).

#pragma once

#include <stdint.h>

namespace dco_tf32 {

// fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from zero: the
// result of cvt.rna.tf32.f32 for finite values, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, each a TF32 value in a 32-bit register
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// c += a b for a 16 x 8 A (row-major fragment), an 8 x 8 B (column-major), fp32 c
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split into hi and lo: a[0] (row g, col t), a[1] (g + 8, t),
// a[2] (g, t + 4), a[3] (g + 8, t + 4) with g = lane / 4, t = lane % 4.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
  }
};

// A B fragment split into hi and lo: b[0] (row t, col g), b[1] (t + 4, g).
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// One k-step of NT products that share the A fragment, in 3xTF32: hi hi' into
// c, lo hi' + hi lo' into cc (the sum is c + cc).  The n-tiles are interleaved
// so that no product waits on the one just issued.
template <int NT>
__device__ __forceinline__ void mma3(float (&c)[NT][4], float (&cc)[NT][4], const FragA& a,
                                     const FragB (&b)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(c[j], a.hi, b[j].hi);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(cc[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(cc[j], a.hi, b[j].lo);
}

}  // namespace dco_tf32
