// Fused GCN layer for Hopper (sm_90a), bound to PyTorch through a plain C
// entry point loaded with ctypes (repro_torch/kernels/bcsr_spmm.py).
//
// Replaces the TPU kernel
// repro/kernels/bcsr_spmm.py::fused_gcn_layer_pallas (_fused_gcn_kernel):
//
//   X  = sum_{s < n_tiles[rb], col_tile[rb,s] >= 0}
//        blocks[rb, s] @ H[col_tile[rb,s]*bk:+bk, :]          (bm x F)
//   Y[rb*bm:+bm, :] = relu(X @ W + b)                         (bm x F_out)
//
// all in f32 (f32 operands only, plain FMA, no TF32), with X kept on chip.
//
// What bounds it: counted with each input read once and Y written once,
// the work is bound by f32 operations: 2*bm*bk*F FLOPs per valid brick for
// the aggregation plus 2*F*F_out per row for the combination, against
// about 4 bytes of H per 2*bm FLOPs and 4*F_out bytes of Y per row
// (chip_smoke.py reports the bound at the training path's shape).
//
// Design (a simple first version, not yet tuned):
//   * one thread block owns one row block rb and all of its output columns;
//     the TPU grid's sequential slot axis is a loop inside the block,
//     bounded by n_tiles[rb] (block_ell.cuh, shared with bcsr_spmm.cu);
//   * the aggregation runs in passes of blockDim.x columns; thread (x, y)
//     keeps ROWS_PER_THREAD rows of one column in registers and stores
//     them into X in shared memory. X (bm x F f32, 8 KiB at bm = 8,
//     F = 256) replaces the TPU kernel's VMEM scratch and is never written
//     to device memory;
//   * the combination gives thread (x, y) output column j and the same rows:
//     it walks k over F, reading W[k, j] straight from device memory
//     (neighbouring threads read neighbouring columns of one W row, so the
//     load is coalesced) and X[r, k..k+3] from shared memory as one float4
//     that every thread of the warp reads by broadcast. W (256 KiB at
//     F = F_out = 256) does not fit the 227 KB of shared memory a block may
//     use, so it is not staged there. The cost: every row block reads all of
//     W again, F*F_out*4 bytes per bm rows, served by L2 (4.7 GB of L2 reads
//     over 17,942 row blocks at that width) but not from device memory;
//     grouping several row blocks per thread block would divide it;
//   * a row block with no valid slot still writes relu(b), as on the TPU;
//     the caller strips the padding rows;
//   * rows of H past k_rows read as zero (bound check, no host-side max).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_ell.cuh"

namespace {

using block_ell::ROWS_PER_THREAD;

__global__ void fused_gcn_layer_kernel(const float* __restrict__ blocks,
                                       const int32_t* __restrict__ col_tile,
                                       const int32_t* __restrict__ n_tiles,
                                       const float* __restrict__ h,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b,
                                       float* __restrict__ out, int ell_w,
                                       int bm, int bk, int64_t k_rows, int f,
                                       int f_out) {
  extern __shared__ __align__(16) float smem[];
  // X has blockDim.y * ROWS_PER_THREAD rows: the rows past bm of the last
  // row group hold zeros and are never stored, so no loop below needs a
  // row guard. The brick follows X.
  const int bm_pad = blockDim.y * ROWS_PER_THREAD;
  float* x = smem;
  float* brick = smem + bm_pad * f;
  const int64_t rb = blockIdx.x;
  const int row0 = threadIdx.y * ROWS_PER_THREAD;
  const int n_rows = min(ROWS_PER_THREAD, bm - row0);
  float* xr = x + row0 * f;

  // Aggregation: X = sum_s A_s H_s, one pass per blockDim.x columns.
  for (int c0 = 0; c0 < f; c0 += blockDim.x) {
    const int col = c0 + threadIdx.x;
    float acc[ROWS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0.0f;
    block_ell::accumulate_row_block(blocks, col_tile, n_tiles, h, brick, rb,
                                    ell_w, bm, bk, k_rows, f, col, row0,
                                    n_rows, acc);
    if (col < f) {
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) xr[r * f + col] = acc[r];
    }
  }
  __syncthreads();

  // Combination: Y = relu(X W + b), one pass per blockDim.x output columns.
  for (int j0 = 0; j0 < f_out; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    if (j >= f_out) break;  // no barrier follows
    float acc[ROWS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0.0f;
    const float* wj = w + j;
    int k = 0;
    if ((f & 3) == 0) {  // X rows are 16-byte aligned: float4 reads
      for (; k < f; k += 4) {
        const float w0 = wj[static_cast<int64_t>(k) * f_out];
        const float w1 = wj[static_cast<int64_t>(k + 1) * f_out];
        const float w2 = wj[static_cast<int64_t>(k + 2) * f_out];
        const float w3 = wj[static_cast<int64_t>(k + 3) * f_out];
#pragma unroll
        for (int r = 0; r < ROWS_PER_THREAD; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + r * f + k);
          acc[r] = fmaf(xv.x, w0, acc[r]);
          acc[r] = fmaf(xv.y, w1, acc[r]);
          acc[r] = fmaf(xv.z, w2, acc[r]);
          acc[r] = fmaf(xv.w, w3, acc[r]);
        }
      }
    }
    for (; k < f; ++k) {
      const float wv = wj[static_cast<int64_t>(k) * f_out];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
        acc[r] = fmaf(xr[r * f + k], wv, acc[r]);
    }
    const float bj = b[j];
    float* o = out + (rb * bm + row0) * static_cast<int64_t>(f_out) + j;
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      if (r < n_rows) o[static_cast<int64_t>(r) * f_out] = fmaxf(acc[r] + bj, 0.0f);
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// blocks (n_rb, ell_w, bm, bk), col_tile (n_rb, ell_w) i32, n_tiles (n_rb,)
// i32, h (k_rows, f), w (f, f_out), b (f_out,), out (n_rb*bm, f_out); all
// f32 but the indices, all contiguous. bn is the block's width in threads
// (columns per pass); the block has ceil(bm / 8) rows of threads.
extern "C" int fused_gcn_layer_launch(const void* blocks, const void* col_tile,
                                      const void* n_tiles, const void* h,
                                      const void* w, const void* b, void* out,
                                      int n_rb, int ell_w, int bm, int bk,
                                      int64_t k_rows, int f, int f_out, int bn,
                                      void* stream) {
  const int row_groups = (bm + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD;
  const size_t smem =
      (static_cast<size_t>(row_groups) * ROWS_PER_THREAD * f +
       static_cast<size_t>(bm) * bk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_gcn_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(bn, row_groups);
  fused_gcn_layer_kernel<<<n_rb, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int32_t*>(col_tile),
      static_cast<const int32_t*>(n_tiles), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), ell_w, bm, bk, k_rows, f, f_out);
  return static_cast<int>(cudaGetLastError());
}
