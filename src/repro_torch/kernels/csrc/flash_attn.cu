// Flash attention (prefill) for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point loaded with ctypes (repro_torch/kernels/flash_attn.py).
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::flash_attention_pallas
// (_flash_kernel):
//
//   out[b,h,i,:] = sum_j softmax_j(q[b,h,i,:] . k[b,h,j,:] / sqrt(d)) v[b,h,j,:]
//
// over the keys j <= i (causal) and j > i - window (window > 0), with an
// online softmax whose row max, row sum and accumulator are f32. A row with
// no valid key writes 0, as the TPU kernel's max(l, 1e-30) does. q, k, v
// are (B, H, S, d) f32, f16 or bf16; the output is in q's type.
//
// What bounds it: with each input read once and the output written once,
// the work is bound by operations: 4*d FLOPs per valid (query, key) pair
// against 4*2*d bytes per row of q, k, v and out (at Yi-6B's prefill,
// d = 128, S = 4096: 1.4e11 FLOPs against 134 MB; chip_smoke.py reports
// the bound). The card reaches its bound only on the tensor cores; this
// first version runs plain f32 FMA, whose peak is 67 TFLOP/s.
//
// Design (a simple first version, not yet tuned):
//   * one thread block owns BQ = 64 query rows of one (b, h); the TPU grid's
//     sequential key-block axis becomes a loop inside the block that starts
//     at the window's lower edge and stops at the causal limit, so blocks
//     above the diagonal or outside the window cost nothing;
//   * each iteration stages a BK = 64-key tile of K and V, converted to f32,
//     in shared memory (64 KiB at d = 128, above the 48 KB default, so the
//     launch raises the dynamic-smem limit): every key is read from device
//     memory once per 64 query rows;
//   * four threads share a query row: each keeps a quarter of q and of the
//     accumulator in registers, in float4 chunks interleaved so that the
//     four read 64 contiguous bytes of a K or V row (the eight rows of a
//     warp read the same key: a broadcast, no bank conflict), and two xor
//     shuffles complete each dot product;
//   * the online softmax advances 16 keys at a time: one rescale of the
//     accumulator per 16 keys;
//   * the S edge is masked (S need not be a multiple of any block; the TPU
//     kernel asserts S % block == 0), and query tiles are scheduled longest
//     first so that the causal triangle's long rows do not trail.
#include "attention.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per shared-memory tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 256
constexpr int CHUNK = 16;            // keys per online-softmax step

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int S,
                      int d, float scale, int causal, int window) {
  constexpr int DP = 16 * NC;        // padded head dim
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // BK x DP
  float* vs = smem + BK * DP;        // BK x DP

  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
      static_cast<int64_t>(S) * d;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = q0 + row;

  // This thread's dims of the row: c * 16 + part * 4 + e, c < NC, e < 4.
  float qr[NC * 4];
  float acc[NC * 4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = c * 16 + part * 4 + e;
      qr[c * 4 + e] = (qi < S && dim < d)
                          ? attn::to_f32(q[base + static_cast<int64_t>(qi) * d + dim])
                          : 0.0f;
      acc[c * 4 + e] = 0.0f;
    }
  }
  float m = -INFINITY;
  float l = 0.0f;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int key = k0 + idx / DP;
      const int dim = idx % DP;
      const bool ok = key < S && dim < d;
      const int64_t off = base + static_cast<int64_t>(key) * d + dim;
      ks[idx] = ok ? attn::to_f32(k[off]) : 0.0f;
      vs[idx] = ok ? attn::to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += CHUNK) {
      float s[CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float* kr = ks + (j0 + jj) * DP + part * 4;
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + c * 16);
          dot = fmaf(qr[c * 4 + 0], kv.x, dot);
          dot = fmaf(qr[c * 4 + 1], kv.y, dot);
          dot = fmaf(qr[c * 4 + 2], kv.z, dot);
          dot = fmaf(qr[c * 4 + 3], kv.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int key = k0 + j0 + jj;
        bool valid = key < S && qi < S;
        if (causal) valid = valid && key <= qi;
        if (window > 0) valid = valid && key > qi - window;
        s[jj] = valid ? dot * scale : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      // Rows with no valid key so far keep m = -inf; exp(-inf) = 0 makes
      // both the rescale and the probabilities vanish without a NaN.
      const float m_new = fmaxf(m, cmax);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m - m_safe);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        s[jj] = expf(s[jj] - m_safe);
        psum += s[jj];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int e = 0; e < NC * 4; ++e) acc[e] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float* vr = vs + (j0 + jj) * DP + part * 4;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + c * 16);
          acc[c * 4 + 0] = fmaf(s[jj], vv.x, acc[c * 4 + 0]);
          acc[c * 4 + 1] = fmaf(s[jj], vv.y, acc[c * 4 + 1]);
          acc[c * 4 + 2] = fmaf(s[jj], vv.z, acc[c * 4 + 2]);
          acc[c * 4 + 3] = fmaf(s[jj], vv.w, acc[c * 4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (qi >= S) return;
  const float denom = fmaxf(l, 1e-30f);
  T* o = out + base + static_cast<int64_t>(qi) * d;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = c * 16 + part * 4 + e;
      if (dim < d) o[dim] = attn::from_f32<T>(acc[c * 4 + e] / denom);
    }
  }
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int b, h, s, d, causal, window;
  float scale;
  cudaStream_t stream;

  template <typename T, int NC>
  cudaError_t operator()() const {
    const size_t smem = 2 * BK * 16 * NC * sizeof(float);
    cudaError_t err = attn::allow_smem(
        reinterpret_cast<const void*>(flash_attn_kernel<T, NC>), smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s + BQ - 1) / BQ, h, b);
    flash_attn_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), s, d, scale, causal,
        window);
    return cudaGetLastError();
  }
};

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// q, k, v, out (b, h, s, d) contiguous, all of one dtype (attn::F32, F16 or
// BF16); d <= 128; window 0 means no sliding window.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int b, int h, int s, int d,
                                 int causal, int window, float scale,
                                 int dtype, void* stream) {
  const Launch launch{q,      k,      v,     out,
                      b,      h,      s,     d,
                      causal, window, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(attn::dispatch(dtype, d, launch));
}
