// Flash-attention backward for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point loaded with ctypes (repro_torch/kernels/flash_attn.py,
// `flash_attention_bwd_cuda`, called by `FlashAttention.backward`).
//
// Replaces the gradient the JAX package takes by XLA's autodiff of the jnp
// attention core (repro/models/layers.py::_attn_core); the TPU package has
// no Pallas backward. It differentiates what flash_attn.cu computes, under
// the same causal and window masks, for q, k, v, out, dout (B, H, S, d) of
// one type (f32, f16 or bf16), d <= 128, and the forward's row log-sum-exp
// lse (B, H, S) f32, in natural-log units:
//
//   D_i   = sum_d dO_i . O_i                       (pre-pass, f32)
//   P_ij  = exp(s q_i . k_j - lse_i)               (recomputed, never stored)
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dV_j  = sum_i P_ij dO_i,  dK_j = s sum_i dS_ij q_i,  dQ_i = s sum_j dS_ij k_j
//
// with s = 1/sqrt(d). Sums run in f32; dQ, dK, dV are written in q's type.
// A row whose lse is -inf (no valid key) contributes nothing.
//
// What bounds it: operations. The work is 10*d FLOPs per valid (query, key)
// pair (q.k, dO.v, dV, dK, dQ: 2*d each), against 8 rows of d in (q, k, v,
// out, dout) and 3 out (dq, dk, dv); at the training shape (4, 32, 512, 128)
// causal 2.15e10 FLOPs, 0.0218 ms at the card's 989 TFLOP/s bf16, and at
// Yi-6B's prefill (1, 32, 4096, 128) 3.44e11 FLOPs, 0.347 ms. Only the
// tensor cores come near that bound.
//
// This first version does the sums as f32 FMA on every dtype (tensor cores,
// mma.sync with attention.cuh's split_pair and then wgmma, are later work):
// the FMA rate, 67 TFLOP/s, bounds it at 0.32 ms and 5.1 ms at those shapes,
// and it recomputes q.k and dO.v in both of its main kernels, 14*d FLOPs a
// pair in all. It is deterministic: no atomics, every sum in a fixed order.
// Three kernels, launched in order on one stream:
//
// * delta_kernel: D, one warp per row.
// * dkdv_kernel: one block owns ROWS = 32 keys of one (b, h), eight threads
//   a key (each holding 4 of every 32 dims of k_j, v_j and the dK_j, dV_j
//   sums in registers), and loops over the query tiles that see those keys
//   (from the tile's first key under the causal mask, to its last key plus
//   the window), TILE = 32 queries of q and dO widened to f32 in shared
//   memory per step, with their lse and D. Each (query, key) pair takes two
//   dot products reduced over the eight threads by shuffles, then two
//   axpys. Key tiles are scheduled longest first (tile 0 sees every query).
// * dq_kernel: one block owns 32 queries, eight threads a query (q_i, dO_i,
//   dQ_i, lse_i, D_i in registers), and loops over the key tiles the
//   queries see, k and v widened to f32 in shared memory; query tiles
//   longest first, as the forward schedules them.
#include "attention.cuh"

#include <math.h>

namespace {

constexpr int TPR = 8;                 // threads per owned row
constexpr int ROWS = 32;               // rows (keys or queries) a block owns
constexpr int THREADS = ROWS * TPR;    // 256
constexpr int TILE = 32;               // rows of the streamed operand a step
constexpr float LOG2E = 1.4426950408889634f;

// Head dims padded to DP = 32 * NCH: a thread holds dims c * 32 + part * 4
// + e, c < NCH, e < 4, so the eight threads of a row read one 128-byte
// line of each shared-memory row per c, and the four rows of a warp read
// the same line (a broadcast).
template <int NC>
__host__ __device__ constexpr int nch() {
  return (NC + 1) / 2;                 // NC 16-dim chunks in 32-dim chunks
}

__device__ __forceinline__ float row_sum(float x) {   // over 8 lanes
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ bool valid_pair(int qi, int kj, int S, int causal,
                                           int window) {
  bool ok = qi < S && kj < S;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

// Row `r` of the (S, d) matrix at `src`, this thread's dims of it, into
// f32 registers; 0 past S or d.
template <typename T, int NCH>
__device__ __forceinline__ void load_row(float (&dst)[NCH * 4],
                                         const T* __restrict__ src, int r,
                                         int S, int d, int part) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = c * 32 + part * 4 + e;
      dst[c * 4 + e] = (r < S && dim < d)
                           ? attn::to_f32(src[static_cast<int64_t>(r) * d + dim])
                           : 0.0f;
    }
  }
}

template <typename T, int NCH>
__device__ __forceinline__ void store_row(T* __restrict__ dst,
                                          const float (&x)[NCH * 4],
                                          float mul, int r, int S, int d,
                                          int part) {
  if (r >= S) return;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = c * 32 + part * 4 + e;
      if (dim < d)
        dst[static_cast<int64_t>(r) * d + dim] =
            attn::from_f32<T>(x[c * 4 + e] * mul);
    }
  }
}

// Rows [r0, r0 + TILE) of two (S, d) matrices into shared memory as f32
// rows of DP, zeros past S or d.
template <typename T, int DP>
__device__ __forceinline__ void load_tiles(float* __restrict__ a_s,
                                           float* __restrict__ b_s,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b, int r0,
                                           int S, int d, int tid) {
  for (int idx = tid; idx < TILE * DP; idx += THREADS) {
    const int r = r0 + idx / DP;
    const int dim = idx % DP;
    const bool ok = r < S && dim < d;
    const int64_t off = static_cast<int64_t>(r) * d + dim;
    a_s[idx] = ok ? attn::to_f32(a[off]) : 0.0f;
    b_s[idx] = ok ? attn::to_f32(b[off]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;             // a whole warp leaves together
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float acc = 0.0f;
  for (int dim = lane; dim < d; dim += 32)
    acc = fmaf(attn::to_f32(o[dim]), attn::to_f32(g[dim]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int S, int d, float scale, int causal,
                int window) {
  constexpr int NCH = nch<NC>();
  constexpr int DP = 32 * NCH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // TILE x DP
  float* gs = qs + TILE * DP;          // TILE x DP (dO)
  float* ls = gs + TILE * DP;          // TILE: lse_i * log2(e)
  float* ds = ls + TILE;               // TILE: D_i

  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int64_t base = bh * S * d;
  const int64_t rbase = bh * S;
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int k0 = blockIdx.x * ROWS;
  const int kj = k0 + tid / TPR;

  float kr[NCH * 4], vr[NCH * 4], dka[NCH * 4], dva[NCH * 4];
  load_row<T, NCH>(kr, k + base, kj, S, d, part);
  load_row<T, NCH>(vr, v + base, kj, S, d, part);
#pragma unroll
  for (int e = 0; e < NCH * 4; ++e) dka[e] = dva[e] = 0.0f;

  const float scale_log2 = scale * LOG2E;
  const int i_begin = (causal ? k0 : 0) / TILE * TILE;
  const int i_end = window > 0 ? min(S, k0 + ROWS - 1 + window) : S;
  for (int i0 = i_begin; i0 < i_end; i0 += TILE) {
    __syncthreads();                   // the previous tile is consumed
    load_tiles<T, DP>(qs, gs, q + base, dout + base, i0, S, d, tid);
    if (tid < TILE) {
      const int qi = i0 + tid;
      ls[tid] = qi < S ? lse[rbase + qi] * LOG2E : -INFINITY;
      ds[tid] = qi < S ? delta[rbase + qi] : 0.0f;
    }
    __syncthreads();

#pragma unroll 2
    for (int ii = 0; ii < TILE; ++ii) {
      const float* qrow = qs + ii * DP + part * 4;
      const float* grow = gs + ii * DP + part * 4;
      float4 qv[NCH], gv[NCH];
      float dot = 0.0f, dpv = 0.0f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        qv[c] = *reinterpret_cast<const float4*>(qrow + c * 32);
        gv[c] = *reinterpret_cast<const float4*>(grow + c * 32);
        dot = fmaf(kr[c * 4 + 0], qv[c].x, dot);
        dot = fmaf(kr[c * 4 + 1], qv[c].y, dot);
        dot = fmaf(kr[c * 4 + 2], qv[c].z, dot);
        dot = fmaf(kr[c * 4 + 3], qv[c].w, dot);
        dpv = fmaf(vr[c * 4 + 0], gv[c].x, dpv);
        dpv = fmaf(vr[c * 4 + 1], gv[c].y, dpv);
        dpv = fmaf(vr[c * 4 + 2], gv[c].z, dpv);
        dpv = fmaf(vr[c * 4 + 3], gv[c].w, dpv);
      }
      dot = row_sum(dot);
      dpv = row_sum(dpv);
      const float lse2 = ls[ii];
      const bool ok = valid_pair(i0 + ii, kj, S, causal, window) &&
                      lse2 != -INFINITY;
      const float p = ok ? exp2f(fmaf(dot, scale_log2, -lse2)) : 0.0f;
      const float dsv = p * (dpv - ds[ii]);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        dva[c * 4 + 0] = fmaf(p, gv[c].x, dva[c * 4 + 0]);
        dva[c * 4 + 1] = fmaf(p, gv[c].y, dva[c * 4 + 1]);
        dva[c * 4 + 2] = fmaf(p, gv[c].z, dva[c * 4 + 2]);
        dva[c * 4 + 3] = fmaf(p, gv[c].w, dva[c * 4 + 3]);
        dka[c * 4 + 0] = fmaf(dsv, qv[c].x, dka[c * 4 + 0]);
        dka[c * 4 + 1] = fmaf(dsv, qv[c].y, dka[c * 4 + 1]);
        dka[c * 4 + 2] = fmaf(dsv, qv[c].z, dka[c * 4 + 2]);
        dka[c * 4 + 3] = fmaf(dsv, qv[c].w, dka[c * 4 + 3]);
      }
    }
  }
  store_row<T, NCH>(dk + base, dka, scale, kj, S, d, part);
  store_row<T, NCH>(dv + base, dva, 1.0f, kj, S, d, part);
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int d, float scale, int causal,
              int window) {
  constexpr int NCH = nch<NC>();
  constexpr int DP = 32 * NCH;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // TILE x DP
  float* vs = ks + TILE * DP;          // TILE x DP

  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int64_t base = bh * S * d;
  const int64_t rbase = bh * S;
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int n_qt = (S + ROWS - 1) / ROWS;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * ROWS;
  const int qi = q0 + tid / TPR;

  float qr[NCH * 4], gr[NCH * 4], dqa[NCH * 4];
  load_row<T, NCH>(qr, q + base, qi, S, d, part);
  load_row<T, NCH>(gr, dout + base, qi, S, d, part);
#pragma unroll
  for (int e = 0; e < NCH * 4; ++e) dqa[e] = 0.0f;
  const float lse2 = qi < S ? lse[rbase + qi] * LOG2E : -INFINITY;
  const float di = qi < S ? delta[rbase + qi] : 0.0f;

  const float scale_log2 = scale * LOG2E;
  const int k_end = causal ? min(S, q0 + ROWS) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / TILE * TILE : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TILE) {
    __syncthreads();                   // the previous tile is consumed
    load_tiles<T, DP>(ks, vs, k + base, v + base, k0, S, d, tid);
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < TILE; ++jj) {
      const float* krow = ks + jj * DP + part * 4;
      const float* vrow = vs + jj * DP + part * 4;
      float4 kv[NCH];
      float dot = 0.0f, dpv = 0.0f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(krow + c * 32);
        const float4 vv = *reinterpret_cast<const float4*>(vrow + c * 32);
        dot = fmaf(qr[c * 4 + 0], kv[c].x, dot);
        dot = fmaf(qr[c * 4 + 1], kv[c].y, dot);
        dot = fmaf(qr[c * 4 + 2], kv[c].z, dot);
        dot = fmaf(qr[c * 4 + 3], kv[c].w, dot);
        dpv = fmaf(gr[c * 4 + 0], vv.x, dpv);
        dpv = fmaf(gr[c * 4 + 1], vv.y, dpv);
        dpv = fmaf(gr[c * 4 + 2], vv.z, dpv);
        dpv = fmaf(gr[c * 4 + 3], vv.w, dpv);
      }
      dot = row_sum(dot);
      dpv = row_sum(dpv);
      const bool ok = valid_pair(qi, k0 + jj, S, causal, window) &&
                      lse2 != -INFINITY;
      const float p = ok ? exp2f(fmaf(dot, scale_log2, -lse2)) : 0.0f;
      const float dsv = p * (dpv - di);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        dqa[c * 4 + 0] = fmaf(dsv, kv[c].x, dqa[c * 4 + 0]);
        dqa[c * 4 + 1] = fmaf(dsv, kv[c].y, dqa[c * 4 + 1]);
        dqa[c * 4 + 2] = fmaf(dsv, kv[c].z, dqa[c * 4 + 2]);
        dqa[c * 4 + 3] = fmaf(dsv, kv[c].w, dqa[c * 4 + 3]);
      }
    }
  }
  store_row<T, NCH>(dq + base, dqa, scale, qi, S, d, part);
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int b, h, s, d, causal, window;
  float scale;
  cudaStream_t stream;

  template <typename T, int NC>
  cudaError_t operator()() const {
    constexpr int DP = 32 * nch<NC>();
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* gt = static_cast<const T*>(dout);
    const int64_t rows = static_cast<int64_t>(b) * h * s;
    delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                      stream>>>(static_cast<const T*>(out), gt, delta, rows,
                                d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const dim3 grid((s + ROWS - 1) / ROWS, h, b);
    const size_t kv_smem = (2 * TILE * DP + 2 * TILE) * sizeof(float);
    err = attn::allow_smem(reinterpret_cast<const void*>(dkdv_kernel<T, NC>),
                           kv_smem);
    if (err != cudaSuccess) return err;
    dkdv_kernel<T, NC><<<grid, THREADS, kv_smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        s, d, scale, causal, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t q_smem = 2 * TILE * DP * sizeof(float);
    err = attn::allow_smem(reinterpret_cast<const void*>(dq_kernel<T, NC>),
                           q_smem);
    if (err != cudaSuccess) return err;
    dq_kernel<T, NC><<<grid, THREADS, q_smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), s, d, scale, causal,
        window);
    return cudaGetLastError();
  }
};

}  // namespace

// Launches the three kernels on `stream` without synchronising; returns the
// first launch error (cudaGetLastError()). q, k, v, out, dout, dq, dk, dv
// (b, h, s, d) contiguous, all of one dtype (attn::F32, F16 or BF16); lse
// and delta (b, h, s) f32, delta scratch that the pre-pass fills; d <= 128;
// window 0 means no sliding window; scale 1/sqrt(d), as the forward took.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* out,
                                     const void* dout, const float* lse,
                                     float* delta, void* dq, void* dk,
                                     void* dv, int b, int h, int s, int d,
                                     int causal, int window, float scale,
                                     int dtype, void* stream) {
  const Launch launch{q,  k,  v,      out,    dout,  lse,
                      delta, dq, dk, dv,     b,      h,
                      s,  d,  causal, window, scale,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(attn::dispatch(dtype, d, launch));
}
