// Hopper's own instructions (sm_90a) for the flash-attention kernels: TMA
// copies, mbarriers, wgmma with its shared-memory descriptors, setmaxnreg,
// and on the host the tensor maps TMA reads through.  The forward
// (flash_attention.cu) and the backward (flash_attention_bwd.cu) are built
// on them; each includes this header once, and its position variant
// includes that file again.
//
// Layout shared by both kernels: a bf16 tile of 64 rows is staged as
// col_blocks<D>() boxes of 64 rows x 128 bytes (64 head-dim columns), one
// after the other, each written by TMA in the 128-byte swizzle.  A box's
// 8-row groups lie 1024 bytes apart, so one descriptor form (smem_desc)
// serves every operand: K-major for the two sides of a score product
// (S = Q K^T and the like: the reduction runs along the head dimension), and
// MN-major for the B side of a product whose reduction runs along a tile's
// rows (O += P V and the like: the 16 rows of a step are two 8-row groups,
// and no product spans two boxes).  Accumulators are wgmma m64n64's: a
// thread of warp w of its warpgroup holds rows 16 w + lane / 4 and + 8,
// columns 8 j + 2 (lane % 4) + {0, 1} (mma.sync's C layout); a register A
// operand is mma.sync's A fragment of each warp's 16 rows.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace dco_hopper {

using bf16 = __nv_bfloat16;

constexpr int BOX_COLS = 64;      // head-dim columns of a TMA box (128 bytes)
constexpr int BOX_BYTES = 8192;   // a box of 64 rows x 128 bytes
constexpr int SMEM_ALIGN = 1024;  // the 128-byte swizzle's period

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Boxes of 64 head-dim columns (128 bytes, the swizzle's span) a row holds.
template <int D>
__host__ __device__ constexpr int col_blocks() {
  return (D + BOX_COLS - 1) / BOX_COLS;
}

// Bytes of a staged 64-row tile: col_blocks boxes of 64 rows x 128 bytes,
// one after the other.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return col_blocks<D>() * BOX_BYTES;
}

// Registers a thread keeps from here on: the producer warpgroup gives its
// own up, consumer warpgroups take them (every thread of a warpgroup).
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrive on the barrier where `arrive` holds, as a predicate rather than a
// branch: no divergent path between a warpgroup's wgmma instructions.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool arrive) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((int)arrive)
      : "memory");
}

// x from lane 0: a value the compiler then knows to be the same on every
// lane of the warp (wgmma in a branch it cannot prove uniform is serialised).
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map at coordinates (column, head, row, batch) into
// shared memory, counted on `bar`; elements past the tensor's ends are zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// One box of a 1-d tensor map from element `at` on, as tma_load.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                            int at) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(at)
      : "memory");
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled box whose 8-row
// groups lie 1024 bytes apart, both offsets 1024 bytes: either side of a
// K-major product (the leading offset is then unused), or the MN-major B of
// a product reducing along the box's rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that a wgmma reads or writes to this point of the program:
// an accumulator after its wait (no read moves above it), operands before
// wgmma_fence (no write moves below it, which would make ptxas insert a
// warpgroup.arrive and serialise the products).
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// d (+)= A B for a 64 x 16 A and a 16 x 64 B, both from shared memory
// (K-major), fp32 sums; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for a 64 x 16 bf16 A in registers (mma.sync's A fragment on each
// warp's 16 rows) and a 16 x 64 B from shared memory with its 64 columns
// contiguous (MN-major: the rows of a box).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// cuTensorMapEncodeTiled, a driver function, from the driver the process has
// loaded (the library links only the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The tensor map of a bf16 (B, rows, heads, D) tensor read through its
// strides (in elements), as 4-d (D, heads, rows, B) with the 128-byte
// swizzle; a box is 64 columns of `box_heads` heads of `box_rows` rows.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int D, int heads, int rows, int B,
                       long long head_stride, long long row_stride, long long batch_stride,
                       int box_heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * head_stride, 2ull * row_stride, 2ull * batch_stride};
  const cuuint32_t box[4] = {BOX_COLS, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of `n` contiguous fp32 values as 1-d, a box `box` of them
// (a multiple of 4, at most 256), unswizzled; values past n are zeros.  The
// pointer must sit on 16 bytes.
inline bool tensor_map_1d(CUtensorMap* map, const float* ptr, long long n, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // rank 1 reads none
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides,
                boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace dco_hopper
