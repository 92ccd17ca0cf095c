// Block-ELL x dense SpMM for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point loaded with ctypes (repro_torch/kernels/bcsr_spmm.py).
//
// Replaces the TPU kernel repro/kernels/bcsr_spmm.py::bcsr_spmm_pallas:
//
//   X[rb*bm:+bm, c] = sum_{s < n_tiles[rb], col_tile[rb,s] >= 0}
//                     blocks[rb, s] @ H[col_tile[rb,s]*bk:+bk, c]
//
// accumulated in f32, for f32, f16 or bf16 bricks and H, with an f32 output.
//
// What bounds it: the bricks of the graphs AIRES streams are nearly empty
// (rUSA: 1.36 nonzeros per 8 x 8 brick, in 1.36 columns; socLJ1: 2.06). The
// work the function needs is 2 FLOPs per nonzero and feature column, and the
// bytes are the valid bricks, the H rows under their nonzero columns and X
// written once: bound by bytes (chip_smoke.py reports both this bound and
// the one that counts every brick entry).
//
// Design, route "zero_skip" (bricks of up to 8 rows of 8 columns; the loop
// is block_ell::warp_accumulate):
//   * one warp owns one (row block, 256-column chunk) output tile; there is
//     no barrier wider than a warp. A thread block is 4 independent warps;
//   * the warp copies up to 32 of the row block's bricks (one contiguous
//     range) into its own shared memory with 16-byte cp.async, one lane per
//     slot finds the brick's nonzero columns, and a warp scan compacts the
//     (H row, brick column) pairs into a list;
//   * each listed H row is gathered once, 4 rows in flight, as 16-byte loads
//     (each of a warp's loads one contiguous 512-byte run) where the pointer
//     and F allow, else as scalar loads that stay coalesced,
//     with bm FMAs per value; the brick column's values are broadcast reads
//     of shared memory;
//   * a row block with more than SLOTS_MAIN slots (a hub row of Aᵀ reaches
//     422; socLJ1's segments have hundreds of them) is split: the first
//     kernel takes its first SLOTS_MAIN slots, stores, and appends the row
//     block to a list on the device; a second kernel, launched only when
//     ell_w > SLOTS_MAIN, walks (listed row block, SLOTS_SPLIT slots, chunk)
//     items, one warp per item up to TAIL_WARPS_PER_SM warps per SM, and
//     adds into X with f32 atomics (sums then differ from run to run in
//     their order only).
// Route "brick_loop" (any other brick shape): the first version's kernel,
// in which one thread block per (row block, feature tile) stages each brick
// between two barriers and every thread walks all bk rows of its H tile.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_ell.cuh"

namespace {

using block_ell::CHUNK;
using block_ell::COLS_PER_LANE;
using block_ell::MAX_BM;
using block_ell::ROWS_PER_THREAD;
using block_ell::WARP;

constexpr int WARPS = 4;         // warps per thread block, each on its own
constexpr int BATCH = 32;        // slots per batch of bricks
constexpr int SLOTS_MAIN = 64;   // slots of a row block the first kernel takes
constexpr int SLOTS_SPLIT = 16;  // slots per item of the second
constexpr int TAIL_WARPS_PER_SM = 32;  // the second kernel's warps, at most

// Items of the second kernel per long row block and feature chunk: one for
// every SLOTS_SPLIT slots past SLOTS_MAIN (0: no second launch).
int tail_splits(int ell_w) {
  return ell_w > SLOTS_MAIN ? (ell_w - SLOTS_MAIN + SLOTS_SPLIT - 1) /
                                  SLOTS_SPLIT
                            : 0;
}

// ---- route "zero_skip" ----------------------------------------------------

// TAIL = false: warp g owns row block g / n_chunks and chunk g % n_chunks,
// takes slots [0, min(n_tiles, ell_w, SLOTS_MAIN)) and stores its rows; a
// row block with more slots is appended to `tail` (tail[0] counts them,
// tail[1 + i] names them; zero_skip zeroes tail[0] before the launch).
// TAIL = true: the warps walk the work items (listed row block, split j,
// chunk) in turn; an item takes slots [SLOTS_MAIN + j*SLOTS_SPLIT, +
// SLOTS_SPLIT) of its row block, where it has them, and adds into X
// atomically.
template <bool TAIL, bool VEC, typename TA, typename TH>
__global__ void __launch_bounds__(WARPS * WARP)
    spmm_zero_skip_kernel(const TA* __restrict__ blocks,
                          const int32_t* __restrict__ col_tile,
                          const int32_t* __restrict__ n_tiles,
                          const TH* __restrict__ h, float* __restrict__ out,
                          int32_t* __restrict__ tail, int64_t n_rb,
                          int ell_w, int bm, int64_t k_rows, int f,
                          int n_chunks, int n_splits) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  char* scratch = smem + warp * block_ell::warp_scratch_bytes<TA>(BATCH);
  const int64_t g = static_cast<int64_t>(blockIdx.x) * WARPS + warp;

  if (!TAIL) {
    const int64_t rb = g / n_chunks;
    const int c0 = static_cast<int>(g % n_chunks) * CHUNK;
    if (rb >= n_rb) return;
    const int n_all = min(n_tiles[rb], ell_w);
    if (n_all > SLOTS_MAIN && c0 == 0 && lane == 0)
      tail[1 + atomicAdd(tail, 1)] = static_cast<int32_t>(rb);
    float acc[MAX_BM][COLS_PER_LANE] = {};
    block_ell::warp_accumulate<BATCH, VEC>(blocks, col_tile, h, rb, ell_w, 0,
                                           min(n_all, SLOTS_MAIN), bm,
                                           k_rows, f, c0, scratch, acc);
#pragma unroll
    for (int r = 0; r < MAX_BM; ++r) {
      if (r >= bm) break;
      block_ell::store_row<VEC, TH>(
          out + (rb * bm + r) * static_cast<int64_t>(f), c0, lane, f, acc[r]);
    }
    return;
  }

  const int64_t items = static_cast<int64_t>(tail[0]) * n_splits * n_chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t item = g; item < items; item += stride) {
    const int c0 = static_cast<int>(item % n_chunks) * CHUNK;
    const int64_t rest = item / n_chunks;
    const int split = static_cast<int>(rest % n_splits);
    const int64_t rb = tail[1 + rest / n_splits];
    const int s_begin = SLOTS_MAIN + split * SLOTS_SPLIT;
    const int s_end = min(min(n_tiles[rb], ell_w), s_begin + SLOTS_SPLIT);
    if (s_begin >= s_end) continue;  // the same for the whole warp
    float acc[MAX_BM][COLS_PER_LANE] = {};
    block_ell::warp_accumulate<BATCH, VEC>(blocks, col_tile, h, rb, ell_w,
                                           s_begin, s_end, bm, k_rows, f, c0,
                                           scratch, acc);
#pragma unroll
    for (int r = 0; r < MAX_BM; ++r) {
      if (r >= bm) break;
      float* o = out + (rb * bm + r) * static_cast<int64_t>(f);
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) {
        const int c = block_ell::lane_col<VEC, block_ell::lane_vec<TH>()>(
            c0, lane, j);
        if (c < f) atomicAdd(o + c, acc[r][j]);
      }
    }
  }
}

// The first kernel (TAIL = false) launches one warp per (row block,
// chunk); the second one warp per item it may find, (row block, split,
// chunk), but no more than TAIL_WARPS_PER_SM per SM of the card.
template <bool TAIL, bool VEC, typename TA, typename TH>
cudaError_t launch_zero_skip(const void* blocks, const void* col_tile,
                             const void* n_tiles, const void* h, void* out,
                             void* tail, int64_t n_rb, int ell_w, int bm,
                             int64_t k_rows, int f, int n_splits,
                             cudaStream_t stream) {
  const int n_chunks = (f + CHUNK - 1) / CHUNK;
  int64_t warps = n_rb * n_chunks;
  if (TAIL) {
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int64_t cap = static_cast<int64_t>(n_sm) * TAIL_WARPS_PER_SM;
    warps = warps * n_splits < cap ? warps * n_splits : cap;
  }
  const size_t smem = WARPS * block_ell::warp_scratch_bytes<TA>(BATCH);
  const int64_t grid = (warps + WARPS - 1) / WARPS;
  spmm_zero_skip_kernel<TAIL, VEC, TA, TH>
      <<<static_cast<unsigned>(grid), WARPS * WARP, smem, stream>>>(
          static_cast<const TA*>(blocks),
          static_cast<const int32_t*>(col_tile),
          static_cast<const int32_t*>(n_tiles), static_cast<const TH*>(h),
          static_cast<float*>(out), static_cast<int32_t*>(tail), n_rb, ell_w,
          bm, k_rows, f, n_chunks, n_splits);
  return cudaGetLastError();
}

template <typename TA, typename TH>
cudaError_t zero_skip(const void* blocks, const void* col_tile,
                      const void* n_tiles, const void* h, void* out,
                      void* tail, int64_t n_rb, int ell_w, int bm,
                      int64_t k_rows, int f, cudaStream_t stream) {
  // 16-byte H loads where every row start is 16-byte aligned.
  const bool vec = reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   (f * sizeof(TH)) % 16 == 0;
  const int n_splits = tail_splits(ell_w);
  if (n_splits > 0) {  // the list of long row blocks starts empty
    cudaError_t err = cudaMemsetAsync(tail, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  auto first = vec ? launch_zero_skip<false, true, TA, TH>
                   : launch_zero_skip<false, false, TA, TH>;
  cudaError_t err = first(blocks, col_tile, n_tiles, h, out, tail, n_rb,
                          ell_w, bm, k_rows, f, n_splits, stream);
  if (err != cudaSuccess || n_splits == 0) return err;
  auto second = vec ? launch_zero_skip<true, true, TA, TH>
                    : launch_zero_skip<true, false, TA, TH>;
  return second(blocks, col_tile, n_tiles, h, out, tail, n_rb, ell_w, bm,
                k_rows, f, n_splits, stream);
}

// ---- route "brick_loop" ---------------------------------------------------

template <typename TA, typename TH>
__global__ void bcsr_spmm_kernel(const TA* __restrict__ blocks,
                                 const int32_t* __restrict__ col_tile,
                                 const int32_t* __restrict__ n_tiles,
                                 const TH* __restrict__ h,
                                 float* __restrict__ out,
                                 int ell_w, int bm, int bk, int64_t k_rows,
                                 int f) {
  extern __shared__ float brick[];  // bm * bk, row-major
  const int64_t rb = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int row0 = threadIdx.y * ROWS_PER_THREAD;
  const int n_rows = min(ROWS_PER_THREAD, bm - row0);

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0.0f;
  block_ell::accumulate_row_block(blocks, col_tile, n_tiles, h, brick, rb,
                                  ell_w, bm, bk, k_rows, f, col, row0, n_rows,
                                  acc);
  if (col >= f) return;
  float* o = out + (rb * bm + row0) * static_cast<int64_t>(f) + col;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    if (r < n_rows) o[static_cast<int64_t>(r) * f] = acc[r];
  }
}

template <typename TA, typename TH>
cudaError_t brick_loop(const void* blocks, const void* col_tile,
                       const void* n_tiles, const void* h, void* out,
                       int64_t n_rb, int ell_w, int bm, int bk, int64_t k_rows,
                       int f, int bn, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bm) * bk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bcsr_spmm_kernel<TA, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(bn, (bm + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD);
  const dim3 grid(static_cast<unsigned>(n_rb), (f + bn - 1) / bn);
  bcsr_spmm_kernel<TA, TH><<<grid, block, smem, stream>>>(
      static_cast<const TA*>(blocks), static_cast<const int32_t*>(col_tile),
      static_cast<const int32_t*>(n_tiles), static_cast<const TH*>(h),
      static_cast<float*>(out), ell_w, bm, bk, k_rows, f);
  return cudaGetLastError();
}

template <typename TA, typename TH>
cudaError_t dispatch(int route, const void* blocks, const void* col_tile,
                     const void* n_tiles, const void* h, void* out,
                     void* tail, int64_t n_rb, int ell_w, int bm, int bk,
                     int64_t k_rows, int f, int bn, cudaStream_t stream) {
  if (route == 0) {
    return zero_skip<TA, TH>(blocks, col_tile, n_tiles, h, out, tail, n_rb,
                             ell_w, bm, k_rows, f, stream);
  }
  return brick_loop<TA, TH>(blocks, col_tile, n_tiles, h, out, n_rb, ell_w,
                            bm, bk, k_rows, f, bn, stream);
}

template <typename TA>
cudaError_t dispatch_h(int h_dtype, int route, const void* blocks,
                       const void* col_tile, const void* n_tiles,
                       const void* h, void* out, void* tail, int64_t n_rb,
                       int ell_w, int bm, int bk, int64_t k_rows, int f,
                       int bn, cudaStream_t stream) {
  switch (h_dtype) {
    case 0:
      return dispatch<TA, float>(route, blocks, col_tile, n_tiles, h, out,
                                 tail, n_rb, ell_w, bm, bk, k_rows, f, bn,
                                 stream);
    case 1:
      return dispatch<TA, __half>(route, blocks, col_tile, n_tiles, h, out,
                                  tail, n_rb, ell_w, bm, bk, k_rows, f, bn,
                                  stream);
    case 2:
      return dispatch<TA, __nv_bfloat16>(route, blocks, col_tile, n_tiles, h,
                                         out, tail, n_rb, ell_w, bm, bk,
                                         k_rows, f, bn, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// blocks (n_rb, ell_w, bm, bk), col_tile (n_rb, ell_w) i32, n_tiles (n_rb,)
// i32, h (k_rows, f), out (n_rb*bm, f) f32; all contiguous. Dtype codes: 0
// f32, 1 f16, 2 bf16. `tail` is 1 + n_rb int32 of scratch, in any state.
// The route is chosen here and written to *route: 0 "zero_skip" where
// block_ell::zero_skip_fits takes the operands, else 1 "brick_loop", whose
// feature tile is bn columns, one thread per column (bn is read on that
// route only).
extern "C" int bcsr_spmm_launch(const void* blocks, const void* col_tile,
                                const void* n_tiles, const void* h, void* out,
                                void* tail, int n_rb, int ell_w, int bm,
                                int bk, int64_t k_rows, int f, int bn,
                                int blocks_dtype, int h_dtype, void* stream,
                                int* route) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = block_ell::zero_skip_fits(bm, bk, k_rows, blocks) ? 0 : 1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (blocks_dtype) {
    case 0:
      err = dispatch_h<float>(h_dtype, *route, blocks, col_tile, n_tiles, h,
                              out, tail, n_rb, ell_w, bm, bk, k_rows, f, bn,
                              s);
      break;
    case 1:
      err = dispatch_h<__half>(h_dtype, *route, blocks, col_tile, n_tiles, h,
                               out, tail, n_rb, ell_w, bm, bk, k_rows, f, bn,
                               s);
      break;
    case 2:
      err = dispatch_h<__nv_bfloat16>(h_dtype, *route, blocks, col_tile,
                                      n_tiles, h, out, tail, n_rb, ell_w, bm,
                                      bk, k_rows, f, bn, s);
      break;
  }
  return static_cast<int>(err);
}
