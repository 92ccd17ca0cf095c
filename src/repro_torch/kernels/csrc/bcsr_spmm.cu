// Block-ELL x dense SpMM for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point loaded with ctypes (repro_torch/kernels/bcsr_spmm.py).
//
// Replaces the TPU kernel repro/kernels/bcsr_spmm.py::bcsr_spmm_pallas:
//
//   X[rb*bm:+bm, c] = sum_{s < n_tiles[rb], col_tile[rb,s] >= 0}
//                     blocks[rb, s] @ H[col_tile[rb,s]*bk:+bk, c]
//
// accumulated in f32, for f32 or f16 bricks and H, with an f32 output.
//
// What bounds it: counted with each input read once and the output written
// once, the work at the serving shape is bound by f32 operations (2*bm*bk
// FLOPs per valid brick and feature column; chip_smoke.py reports the
// bound). This kernel, though, gathers one bk-row H tile per valid brick:
// 2*bm FLOPs per 4-byte H value gathered, 4 FLOP/byte at bm = 8, below the
// card's f32 ratio of about 20 FLOP/byte. As written it is limited by those
// gathers, which L2 serves when neighbouring row blocks reference the same
// tiles.
//
// Design (a simple first version, not yet tuned):
//   * one thread block owns one (row block rb, feature tile of blockDim.x
//     columns) output tile; the TPU grid's sequential slot axis becomes a
//     loop inside the block, bounded by n_tiles[rb], so padded slots cost
//     nothing and no sum is carried between blocks;
//   * the block stages each brick (bm x bk, converted to f32) in shared
//     memory once; every thread then reads it by broadcast;
//   * thread (x, y) owns column x of the tile and ROWS_PER_THREAD rows
//     starting at y*ROWS_PER_THREAD, keeps their sums in registers and loads
//     each gathered H value once for all of them: neighbouring threads read
//     neighbouring columns of one H row, so the gather is coalesced;
//   * rows of H past k_rows read as zero: the bound check replaces the
//     host-side max over col_tile that padding H would need.
// The slot loop lives in block_ell.cuh, shared with fused_gcn_layer.cu.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_ell.cuh"

namespace {

using block_ell::ROWS_PER_THREAD;

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
cudaError_t launch(const void* blocks, const void* col_tile,
                   const void* n_tiles, const void* h, void* out, int n_rb,
                   int ell_w, int bm, int bk, int64_t k_rows, int f, int bn,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bm) * bk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bcsr_spmm_kernel<TA, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(bn, (bm + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD);
  const dim3 grid(n_rb, (f + bn - 1) / bn);
  bcsr_spmm_kernel<TA, TH><<<grid, block, smem, stream>>>(
      static_cast<const TA*>(blocks), static_cast<const int32_t*>(col_tile),
      static_cast<const int32_t*>(n_tiles), static_cast<const TH*>(h),
      static_cast<float*>(out), ell_w, bm, bk, k_rows, f);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// blocks (n_rb, ell_w, bm, bk) f32|f16, col_tile (n_rb, ell_w) i32,
// n_tiles (n_rb,) i32, h (k_rows, f) f32|f16, out (n_rb*bm, f) f32; all
// contiguous. bn is the feature-tile width, one thread per column.
extern "C" int bcsr_spmm_launch(const void* blocks, const void* col_tile,
                                const void* n_tiles, const void* h, void* out,
                                int n_rb, int ell_w, int bm, int bk,
                                int64_t k_rows, int f, int bn, int blocks_f16,
                                int h_f16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (blocks_f16 && h_f16) {
    err = launch<__half, __half>(blocks, col_tile, n_tiles, h, out, n_rb,
                                 ell_w, bm, bk, k_rows, f, bn, s);
  } else if (blocks_f16) {
    err = launch<__half, float>(blocks, col_tile, n_tiles, h, out, n_rb,
                                ell_w, bm, bk, k_rows, f, bn, s);
  } else if (h_f16) {
    err = launch<float, __half>(blocks, col_tile, n_tiles, h, out, n_rb,
                                ell_w, bm, bk, k_rows, f, bn, s);
  } else {
    err = launch<float, float>(blocks, col_tile, n_tiles, h, out, n_rb, ell_w,
                               bm, bk, k_rows, f, bn, s);
  }
  return static_cast<int>(err);
}
