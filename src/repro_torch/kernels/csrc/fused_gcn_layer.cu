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
// in f32 (f32 operands only), with X kept on chip.
//
// What bounds it: counted on the nonzeros of the valid bricks, the
// aggregation is bound by bytes (the bricks, the H rows under their nonzero
// columns) and the combination by f32 operations, 2*F*F_out per row
// (1.9e10 FLOPs, 0.28 ms at the f32 peak, on the training path's segment);
// chip_smoke.py reports the bound.
//
// Design, route "grouped" (bricks of up to 8 rows of 8 columns, and X of the
// group within shared memory):
//   * a thread block of 8 warps owns a group of GROUP = 8 row blocks (64 rows
//     of X, each row block padded to 8 rows). Warp w aggregates row block w
//     of the group with block_ell::warp_accumulate, the SpMM's zero-skipping
//     loop, 256 columns at a time, into X in shared memory (64 KiB at
//     F = 256); X never goes to device memory;
//   * then the block streams W through shared memory in KC-row chunks of 256
//     output columns with a cp.async double buffer, so W is read once per
//     group (F*F_out*4 bytes per 64 rows) where the first version read it
//     once per row block. The chunks reuse the aggregation's scratch;
//   * X·W runs on the tensor cores as three TF32 mma.sync products per
//     tile, hi·hi + hi·lo + lo·hi of each operand split into two TF32
//     parts (each operand kept within 2^-21, where one TF32 product would
//     keep 2^-11 and miss the f32 limit). Warp w
//     takes 16 rows (two row blocks) and 128 columns of the pass. X's rows
//     are padded by 4 floats and W's by 8, so the fragments' reads fall in
//     distinct banks. Then relu(acc + b) is stored (scripts/fused_variants.py
//     times this against X·W on f32 FMA, a variant it carries itself);
//   * a row block with no valid slot keeps X = 0 and gives relu(b), as on the
//     TPU; rows of a group past the segment's last row block are not stored.
// Route "row_block" (any other shape): the first version's kernel, one
// thread block per row block, W read from L2 for every row block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_ell.cuh"

namespace {

using block_ell::CHUNK;
using block_ell::COLS_PER_LANE;
using block_ell::MAX_BM;
using block_ell::ROWS_PER_THREAD;
using block_ell::WARP;

constexpr int GROUP = 8;        // row blocks per thread block, one per warp
constexpr int THREADS = GROUP * WARP;
constexpr int XROWS = GROUP * MAX_BM;
constexpr int BATCH = 16;       // slots per batch of bricks
constexpr int KC = 16;          // rows of W per shared-memory chunk
constexpr int WS = CHUNK + 8;   // row stride of a W chunk, in floats
static_assert(CHUNK == 256, "the combination's tiles take 256 columns");

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride of X in shared memory, in floats: f rounded up to KC, plus 4
// so the rows of an MMA fragment fall in other banks.
__host__ __device__ constexpr int x_stride(int f) {
  return round_up(f, KC) + 4;
}

// Shared memory of the grouped kernel at width f: X (XROWS x x_stride(f)
// f32), then the larger of the warps' aggregation scratch and the two W
// chunks.
__host__ __device__ constexpr size_t grouped_smem(int f) {
  const size_t scratch =
      static_cast<size_t>(GROUP) * block_ell::warp_scratch_bytes<float>(BATCH);
  const size_t w_chunks = 2u * KC * WS * sizeof(float);
  return static_cast<size_t>(XROWS) * x_stride(f) * sizeof(float) +
         (scratch > w_chunks ? scratch : w_chunks);
}

// x ≈ hi + lo, each a TF32 value (an f32 with its low 13 bits zero), both
// truncated: hi keeps x's top 11 significant bits, lo (x - hi, exact in
// f32) the next 11, so hi + lo is within 2^-21 of x, relative. Two integer
// ANDs and a subtraction, at full rate where cvt.rna.tf32 is not.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a (16 x 8, row) · b (8 x 8, col), TF32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// Rows [k0, k0 + KC) and columns [j0, j0 + CHUNK) of W (f x f_out) into the
// chunk at `dst` (KC rows of stride WS); entries past f or f_out become
// zeros. W16:
// f_out is a multiple of 4 and W 16-byte aligned, so 16-byte copies.
template <bool W16>
__device__ __forceinline__ void stage_w(float* dst, const float* __restrict__ w,
                                        int k0, int j0, int f, int f_out) {
  constexpr int PER = W16 ? 4 : 1;
  for (int i = threadIdx.x; i < KC * CHUNK / PER; i += THREADS) {
    const int kk = i / (CHUNK / PER);
    const int c = (i % (CHUNK / PER)) * PER;
    const bool ok = k0 + kk < f && j0 + c < f_out;
    const float* src = ok ? w + static_cast<int64_t>(k0 + kk) * f_out + j0 + c
                          : w;
    if (W16) {
      cp_async16z(dst + kk * WS + c, src, ok ? 16 : 0);
    } else {
      cp_async4(dst + kk * WS + c, src, ok ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool VEC, bool W16>
__global__ void __launch_bounds__(THREADS, 2)
    fused_grouped_kernel(const float* __restrict__ blocks,
                         const int32_t* __restrict__ col_tile,
                         const int32_t* __restrict__ n_tiles,
                         const float* __restrict__ h,
                         const float* __restrict__ w,
                         const float* __restrict__ b, float* __restrict__ out,
                         int64_t n_rb, int ell_w, int bm, int64_t k_rows,
                         int f, int f_out) {
  extern __shared__ __align__(16) char smem[];
  const int xs = x_stride(f);
  float* x = reinterpret_cast<float*>(smem);
  char* shared_tail = smem + static_cast<size_t>(XROWS) * xs * sizeof(float);
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int64_t rb0 = static_cast<int64_t>(blockIdx.x) * GROUP;
  const int64_t rb = rb0 + warp;
  float* xw = x + warp * MAX_BM * xs;  // this warp's 8 rows of X

  // Aggregation: the warp's rows of X, zeros where no term lands.
  for (int i = lane; i < MAX_BM * xs / 4; i += WARP)
    reinterpret_cast<float4*>(xw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  if (rb < n_rb) {
    char* scratch =
        shared_tail + warp * block_ell::warp_scratch_bytes<float>(BATCH);
    const int n_slots = min(n_tiles[rb], ell_w);
    for (int c0 = 0; c0 < f; c0 += CHUNK) {
      float acc[MAX_BM][COLS_PER_LANE] = {};
      block_ell::warp_accumulate<BATCH, VEC>(blocks, col_tile, h, rb, ell_w, 0,
                                             n_slots, bm, k_rows, f, c0,
                                             scratch, acc);
#pragma unroll
      for (int r = 0; r < MAX_BM; ++r) {
        if (r >= bm) break;
        block_ell::store_row<VEC, float>(xw + r * xs, c0, lane, f, acc[r]);
      }
    }
  }
  __syncthreads();  // X is whole; the scratch becomes the W chunks

  // Combination: Y = relu(X W + b), CHUNK output columns per pass. Warp w
  // takes X rows 16*(w%4) .. +16 (two row blocks) and columns 128*(w/4) ..
  // +128 of the pass, as 16 m16n8 tiles.
  float* wbuf = reinterpret_cast<float*>(shared_tail);
  const int n_kc = round_up(f, KC) / KC;
  const int g = lane >> 2, t = lane & 3;  // the MMA fragments' lane roles
  const int mt = warp & 3, nh = warp >> 2;
  for (int j0 = 0; j0 < f_out; j0 += CHUNK) {
    float tc[16][4] = {};
    stage_w<W16>(wbuf, w, 0, j0, f, f_out);
    for (int kc = 0; kc < n_kc; ++kc) {
      if (kc + 1 < n_kc) {
        stage_w<W16>(wbuf + ((kc + 1) & 1) * KC * WS, w, (kc + 1) * KC, j0,
                     f, f_out);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();  // chunk kc is in for every thread
      const float* wt = wbuf + (kc & 1) * KC * WS;
      const float* xa = x + (16 * mt + g) * xs + kc * KC + t;
#pragma unroll
      for (int k8 = 0; k8 < KC; k8 += 8) {
        uint32_t ah[4], al[4];
        split_tf32(xa[k8], ah[0], al[0]);
        split_tf32(xa[8 * xs + k8], ah[1], al[1]);
        split_tf32(xa[k8 + 4], ah[2], al[2]);
        split_tf32(xa[8 * xs + k8 + 4], ah[3], al[3]);
        const float* wb = wt + (k8 + t) * WS + nh * 128 + g;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(wb[n * 8], bh0, bl0);
          split_tf32(wb[4 * WS + n * 8], bh1, bl1);
          mma_tf32(tc[n], al, bh0, bh1);  // the small terms first
          mma_tf32(tc[n], ah, bl0, bl1);
          mma_tf32(tc[n], ah, bh0, bh1);
        }
      }
      __syncthreads();  // chunk kc is consumed before it is overwritten
    }
    // Fragment rows g and g + 8 of m tile mt are row g of row blocks
    // 2*mt and 2*mt + 1 of the group.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t rbh = rb0 + 2 * mt + half;
      if (rbh >= n_rb || g >= bm) continue;
      float* o = out + (rbh * bm + g) * static_cast<int64_t>(f_out);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = j0 + nh * 128 + n * 8 + 2 * t;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (c + q < f_out)
            o[c + q] = fmaxf(tc[n][2 * half + q] + b[c + q], 0.f);
        }
      }
    }
  }
}

template <bool VEC, bool W16>
cudaError_t launch_grouped(const void* blocks, const void* col_tile,
                           const void* n_tiles, const void* h, const void* w,
                           const void* b, void* out, int64_t n_rb, int ell_w,
                           int bm, int64_t k_rows, int f, int f_out,
                           cudaStream_t stream) {
  const size_t smem = grouped_smem(f);
  cudaError_t err = cudaFuncSetAttribute(
      fused_grouped_kernel<VEC, W16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t grid = (n_rb + GROUP - 1) / GROUP;
  fused_grouped_kernel<VEC, W16>
      <<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(
          static_cast<const float*>(blocks),
          static_cast<const int32_t*>(col_tile),
          static_cast<const int32_t*>(n_tiles), static_cast<const float*>(h),
          static_cast<const float*>(w), static_cast<const float*>(b),
          static_cast<float*>(out), n_rb, ell_w, bm, k_rows, f, f_out);
  return cudaGetLastError();
}

// ---- route "row_block" ----------------------------------------------------

__global__ void fused_gcn_layer_kernel(const float* __restrict__ blocks,
                                       const int32_t* __restrict__ col_tile,
                                       const int32_t* __restrict__ n_tiles,
                                       const float* __restrict__ h,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b,
                                       float* __restrict__ out, int ell_w,
                                       int bm, int bk, int64_t k_rows, int f,
                                       int f_out) {
  extern __shared__ __align__(16) float smem_f[];
  // X has blockDim.y * ROWS_PER_THREAD rows: the rows past bm of the last
  // row group hold zeros and are never stored, so no loop below needs a
  // row guard. The brick follows X.
  const int bm_pad = blockDim.y * ROWS_PER_THREAD;
  float* x = smem_f;
  float* brick = smem_f + bm_pad * f;
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

  // Combination: Y = relu(X W + b), one pass per blockDim.x output columns,
  // W read from device memory (L2) for every row block.
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

cudaError_t launch_row_block(const void* blocks, const void* col_tile,
                             const void* n_tiles, const void* h, const void* w,
                             const void* b, void* out, int64_t n_rb, int ell_w,
                             int bm, int bk, int64_t k_rows, int f, int f_out,
                             int bn, cudaStream_t stream) {
  const int row_groups = (bm + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD;
  const size_t smem =
      (static_cast<size_t>(row_groups) * ROWS_PER_THREAD * f +
       static_cast<size_t>(bm) * bk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_gcn_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(bn, row_groups);
  fused_gcn_layer_kernel<<<static_cast<unsigned>(n_rb), block, smem,
                           stream>>>(
      static_cast<const float*>(blocks), static_cast<const int32_t*>(col_tile),
      static_cast<const int32_t*>(n_tiles), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), ell_w, bm, bk, k_rows, f, f_out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// blocks (n_rb, ell_w, bm, bk), col_tile (n_rb, ell_w) i32, n_tiles (n_rb,)
// i32, h (k_rows, f), w (f, f_out), b (f_out,), out (n_rb*bm, f_out); all
// f32 but the indices, all contiguous. The route is chosen here and written
// to *route: 0 "grouped" where block_ell::zero_skip_fits takes the operands
// and grouped_smem(f) fits the shared memory a block of this card may opt
// in to, else 1 "row_block", whose block is bn threads wide (columns per
// pass; read on that route only) and ceil(bm / 8) rows.
extern "C" int fused_gcn_layer_launch(const void* blocks, const void* col_tile,
                                      const void* n_tiles, const void* h,
                                      const void* w, const void* b, void* out,
                                      int n_rb, int ell_w, int bm, int bk,
                                      int64_t k_rows, int f, int f_out, int bn,
                                      void* stream, int* route) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *route = block_ell::zero_skip_fits(bm, bk, k_rows, blocks) &&
                   grouped_smem(f) <= static_cast<size_t>(smem_optin)
               ? 0
               : 1;
  if (*route != 0) {
    return static_cast<int>(launch_row_block(blocks, col_tile, n_tiles, h, w,
                                             b, out, n_rb, ell_w, bm, bk,
                                             k_rows, f, f_out, bn, s));
  }
  const bool vec = reinterpret_cast<uintptr_t>(h) % 16 == 0 && f % 4 == 0;
  const bool w16 = reinterpret_cast<uintptr_t>(w) % 16 == 0 && f_out % 4 == 0;
  auto fn = vec ? (w16 ? launch_grouped<true, true> : launch_grouped<true, false>)
                : (w16 ? launch_grouped<false, true>
                       : launch_grouped<false, false>);
  return static_cast<int>(fn(blocks, col_tile, n_tiles, h, w, b, out, n_rb,
                             ell_w, bm, k_rows, f, f_out, s));
}
