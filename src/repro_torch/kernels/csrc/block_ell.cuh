// The Block-ELL aggregation loop shared by the kernels of this directory:
// the sum over one row block's valid slots of brick @ H-tile, for one
// feature column and up to ROWS_PER_THREAD rows, in f32 registers.
#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

namespace block_ell {

constexpr int ROWS_PER_THREAD = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// acc[r] += sum_{s < n_tiles[rb], col_tile[rb,s] >= 0}
//           sum_k blocks[rb, s, row0 + r, k] * H[col_tile[rb,s]*bk + k, col]
// for r < n_rows. The TPU grid's sequential slot axis is this loop, bounded
// by n_tiles[rb]. Every thread of the block must call it: the block stages
// each brick (converted to f32) in `brick` (bm * bk floats of shared memory)
// between two barriers, and every thread then reads it by broadcast.
// Threads with col >= f only help stage. Rows of H at or past k_rows read
// as zero, so H needs no padding and the caller no host-side max.
template <typename TA, typename TH>
__device__ __forceinline__ void accumulate_row_block(
    const TA* __restrict__ blocks, const int32_t* __restrict__ col_tile,
    const int32_t* __restrict__ n_tiles, const TH* __restrict__ h,
    float* brick, int64_t rb, int ell_w, int bm, int bk, int64_t k_rows,
    int f, int col, int row0, int n_rows, float (&acc)[ROWS_PER_THREAD]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int brick_elems = bm * bk;
  const int n_slots = min(n_tiles[rb], ell_w);
  for (int s = 0; s < n_slots; ++s) {
    const int t = col_tile[rb * ell_w + s];
    if (t < 0) continue;  // same value for the whole block: no divergence
    __syncthreads();      // the previous brick is fully consumed
    const TA* src = blocks + (rb * ell_w + s) * brick_elems;
    for (int i = tid; i < brick_elems; i += n_threads) brick[i] = to_f32(src[i]);
    __syncthreads();
    if (col >= f) continue;
    const int64_t k0 = static_cast<int64_t>(t) * bk;
    const int64_t k_left = k_rows - k0;
    const int k_end = k_left < bk ? static_cast<int>(k_left) : bk;
    const float* a = brick + row0 * bk;
    if (n_rows == ROWS_PER_THREAD) {
      for (int k = 0; k < k_end; ++k) {
        const float hv = to_f32(h[(k0 + k) * f + col]);
#pragma unroll
        for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] += a[r * bk + k] * hv;
      }
    } else {
      for (int k = 0; k < k_end; ++k) {
        const float hv = to_f32(h[(k0 + k) * f + col]);
        for (int r = 0; r < n_rows; ++r) acc[r] += a[r * bk + k] * hv;
      }
    }
  }
}

}  // namespace block_ell
