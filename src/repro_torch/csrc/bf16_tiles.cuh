// bf16 tile helpers for mma.sync kernels on sm_80 and later: asynchronous
// 16-byte copies into XOR-swizzled shared rows, ldmatrix, and the
// m16n8k16 bf16 product with fp32 sums.  The flash-attention backward
// (flash_attention_bwd.cu) is built on them; the forward (flash_attention.cu,
// TMA and wgmma) takes only smem_addr and pack_bf16.
//
// Fragment recipes (a lane's registers, as the kernels use them), for tiles
// kept as rows of 16-byte chunks at smem_addr + swz<ROWB>(row, chunk):
//  * A (16 x 16, row-major in shared memory, rows r0.., depth chunks 2k, 2k+1):
//    ldsm_x4(swz(r0 + (lane & 15), 2k + (lane >> 4))).
//  * B of two 8-wide column blocks from rows holding B's columns (a [n][k]
//    tile, as K for S = Q K^T): ldsm_x4(swz(n0 + ((lane >> 4) << 3) + (lane & 7),
//    2k + ((lane >> 3) & 1))); registers 0, 1 for columns n0.., 2, 3 for n0 + 8...
//  * B of two 8-wide column blocks from rows holding B's depth (a [k][n] tile,
//    as V for O += P V): ldsm_x4_trans(swz(k0 + (lane & 15), 2j + (lane >> 4)));
//    registers 0, 1 for columns 16j.., 2, 3 for 16j + 8...
//  * C (16 x 8): c[0], c[1] at row lane / 4, columns 2 (lane % 4) + {0, 1};
//    c[2], c[3] eight rows below.  Two C blocks side by side, rounded to
//    bf16 with pack_bf16, are the A fragment of a 16-deep step.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dco_tiles {

using bf16 = __nv_bfloat16;

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

}  // namespace dco_tiles
