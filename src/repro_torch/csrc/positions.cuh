// Explicit positions in the flash kernels (flash_attention.cu's position
// variant, flash_attention_bwd.cu's _ext_ kernels): the smallest and largest
// position of a tile of rows, and whether a tile of keys is hidden from a
// whole tile of queries.
//
// With one table for the queries and the keys (`forward`'s, and training's)
// every row sees itself, so no row is left without a visible key and a
// (Q tile, KV tile) pair that no (row, column) of it sees can be skipped
// exactly: its scores would all be masked, and a masked score adds nothing
// to a row that sees some key.

#pragma once

#include <limits.h>

namespace dco_positions {

// The smallest and largest of p[lo, lo + n), n <= 64, reduced by every lane
// of the calling warp (each warp of a block gets the same answer).
__device__ __forceinline__ void tile_min_max(const int* __restrict__ p, int lo, int n, int& mn,
                                             int& mx) {
  const int lane = threadIdx.x & 31;
  mn = INT_MAX;
  mx = INT_MIN;
  for (int r = lane; r < n; r += 32) {
    const int v = p[lo + r];
    mn = min(mn, v);
    mx = max(mx, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
}

// No query at a position in [q_mn, q_mx] sees a key at one in [k_mn, k_mx]:
// every key after every query, or (window > 0) every key older than every
// query's window.
__device__ __forceinline__ bool tiles_hidden(int q_mn, int q_mx, int k_mn, int k_mx, int window) {
  return k_mn > q_mx || (window > 0 && k_mx <= q_mn - window);
}

}  // namespace dco_positions
