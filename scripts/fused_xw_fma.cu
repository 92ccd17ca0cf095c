// A variant of the fused GCN layer's "grouped" kernel
// (src/repro_torch/kernels/csrc/fused_gcn_layer.cu) with X·W on f32 FMA
// instead of three TF32 tensor-core products; scripts/fused_variants.py
// builds it beside block_ell.cuh and times it against the shipped kernel.
// The aggregation and the W stream are the shipped kernel's; in the
// combination each warp takes its own row block, lane l output columns
// l*4 .. +3 and 128 + l*4 .. +3 of each 256-column pass, W read from the
// shared chunk as 16-byte vectors.
//
// Takes what the shipped grouped route takes, and further H and W 16-byte
// aligned with F and F_out multiples of 4 (else cudaErrorInvalidValue).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_ell.cuh"

namespace {

using block_ell::CHUNK;
using block_ell::COLS_PER_LANE;
using block_ell::MAX_BM;
using block_ell::WARP;

constexpr int GROUP = 8;
constexpr int THREADS = GROUP * WARP;
constexpr int XROWS = GROUP * MAX_BM;
constexpr int BATCH = 16;
constexpr int KC = 16;
constexpr int WS = CHUNK + 8;

__host__ __device__ constexpr int x_stride(int f) {
  return (f + KC - 1) / KC * KC + 4;
}

size_t grouped_smem(int f) {
  const size_t scratch =
      static_cast<size_t>(GROUP) * block_ell::warp_scratch_bytes<float>(BATCH);
  const size_t w_chunks = 2u * KC * WS * sizeof(float);
  return static_cast<size_t>(XROWS) * x_stride(f) * sizeof(float) +
         (scratch > w_chunks ? scratch : w_chunks);
}

__device__ __forceinline__ void stage_w(float* dst, const float* __restrict__ w,
                                        int k0, int j0, int f, int f_out) {
  for (int i = threadIdx.x; i < KC * CHUNK / 4; i += THREADS) {
    const int kk = i / (CHUNK / 4);
    const int c = (i % (CHUNK / 4)) * 4;
    const bool ok = k0 + kk < f && j0 + c < f_out;
    const float* src = ok ? w + static_cast<int64_t>(k0 + kk) * f_out + j0 + c
                          : w;
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + kk * WS + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
    fused_fma_kernel(const float* __restrict__ blocks,
                     const int32_t* __restrict__ col_tile,
                     const int32_t* __restrict__ n_tiles,
                     const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out,
                     int64_t n_rb, int ell_w, int bm, int64_t k_rows, int f,
                     int f_out) {
  extern __shared__ __align__(16) char smem[];
  const int xs = x_stride(f);
  float* x = reinterpret_cast<float*>(smem);
  char* shared_tail = smem + static_cast<size_t>(XROWS) * xs * sizeof(float);
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int64_t rb = static_cast<int64_t>(blockIdx.x) * GROUP + warp;
  float* xw = x + warp * MAX_BM * xs;

  for (int i = lane; i < MAX_BM * xs / 4; i += WARP)
    reinterpret_cast<float4*>(xw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  if (rb < n_rb) {
    char* scratch =
        shared_tail + warp * block_ell::warp_scratch_bytes<float>(BATCH);
    const int n_slots = min(n_tiles[rb], ell_w);
    for (int c0 = 0; c0 < f; c0 += CHUNK) {
      float acc[MAX_BM][COLS_PER_LANE] = {};
      block_ell::warp_accumulate<BATCH, true>(blocks, col_tile, h, rb, ell_w,
                                              0, n_slots, bm, k_rows, f, c0,
                                              scratch, acc);
#pragma unroll
      for (int r = 0; r < MAX_BM; ++r) {
        if (r >= bm) break;
        block_ell::store_row<true, float>(xw + r * xs, c0, lane, f, acc[r]);
      }
    }
  }
  __syncthreads();

  float* wbuf = reinterpret_cast<float*>(shared_tail);
  const int n_kc = (f + KC - 1) / KC;
  for (int j0 = 0; j0 < f_out; j0 += CHUNK) {
    float acc[MAX_BM][COLS_PER_LANE] = {};
    stage_w(wbuf, w, 0, j0, f, f_out);
    for (int kc = 0; kc < n_kc; ++kc) {
      if (kc + 1 < n_kc) {
        stage_w(wbuf + ((kc + 1) & 1) * KC * WS, w, (kc + 1) * KC, j0, f,
                f_out);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const float* wt = wbuf + (kc & 1) * KC * WS;
      const float* xk = xw + kc * KC;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 4) {
        float4 xv[MAX_BM];
#pragma unroll
        for (int r = 0; r < MAX_BM; ++r)
          xv[r] = *reinterpret_cast<const float4*>(xk + r * xs + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wr = wt + (kk + q) * WS + lane * 4;
          const float4 wa = *reinterpret_cast<const float4*>(wr);
          const float4 wb = *reinterpret_cast<const float4*>(wr + 128);
          const float wv[COLS_PER_LANE] = {wa.x, wa.y, wa.z, wa.w,
                                           wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < MAX_BM; ++r) {
            const float xr = q == 0   ? xv[r].x
                             : q == 1 ? xv[r].y
                             : q == 2 ? xv[r].z
                                      : xv[r].w;
#pragma unroll
            for (int j = 0; j < COLS_PER_LANE; ++j)
              acc[r][j] = fmaf(xr, wv[j], acc[r][j]);
          }
        }
      }
      __syncthreads();
    }
    if (rb >= n_rb) continue;  // no barrier is skipped: the pass ends here
    float bias[COLS_PER_LANE];
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) {
      const int c = block_ell::lane_col<true, 4>(j0, lane, j);
      bias[j] = c < f_out ? b[c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < MAX_BM; ++r) {
      if (r >= bm) break;
      float y[COLS_PER_LANE];
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j)
        y[j] = fmaxf(acc[r][j] + bias[j], 0.f);
      block_ell::store_row<true, float>(
          out + (rb * bm + r) * static_cast<int64_t>(f_out), j0, lane, f_out,
          y);
    }
  }
}

}  // namespace

extern "C" int fused_xw_fma_launch(const void* blocks, const void* col_tile,
                                   const void* n_tiles, const void* h,
                                   const void* w, const void* b, void* out,
                                   int n_rb, int ell_w, int bm, int bk,
                                   int64_t k_rows, int f, int f_out,
                                   void* stream) {
  if (!block_ell::zero_skip_fits(bm, bk, k_rows, blocks) || f % 4 != 0 ||
      f_out % 4 != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = grouped_smem(f);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((n_rb + GROUP - 1) / GROUP);
  fused_fma_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int32_t*>(col_tile),
      static_cast<const int32_t*>(n_tiles), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), n_rb, ell_w, bm, k_rows, f, f_out);
  return static_cast<int>(cudaGetLastError());
}
