// GQA decode over a slice of the head dim, in two kernels, for Hopper
// (sm_90a), bound to PyTorch through plain C entry points loaded with ctypes
// (repro_torch/kernels/decode_attn.py).
//
// Replaces, beside decode_attn.cu, the TPU kernel
// repro/kernels/decode_attn.py::decode_attention_pallas where the decode
// step's caches are sharded along the head dim (launch/sharding.py's
// state_pspecs shards it when the KV heads do not divide over the model
// axis). A rank then holds q, k and v for d' of the d head dims, its scores
// q.k are partial sums, and the sum over the ranks must come before the
// softmax (models/transformer.py, _decode_attn_split_hd). So the decode is
// cut at that sum:
//
//   decode_scores:     s[b,h,g,t] = q[b,h,g,:] . k[b,h,t,:]  for t < lens[b]
//                                 = 0                         for t >= lens[b]
//   (the caller sums s over the ranks that hold the other head dims)
//   decode_softmax_v:  out[b,h,g,:] = sum_{t < lens[b]} p[b,h,g,t] v[b,h,t,:]
//                      p = softmax_t(cap(s[b,h,g,t] * scale)),
//
// cap(x) = softcap * tanh(x / softcap) with an attention softcap (Gemma-2's),
// x without. q, k, v are f32, f16 or bf16, one type; s, the softmax and the
// accumulator are f32; the output is in v's type; d' <= 256, group <= 16.
// A sequence with lens[b] = 0 gives 0, as decode_attn.cu's kernels do.
// Positions at or past lens[b] are never read.
//
// What bounds them: bytes. Each valid cache row of K (scores) and of V
// (softmax_v) is read once for 2 * group * d' FLOPs, and the scores
// (B, n_kv, group, S) f32 are written once; softmax_v reads them three
// times (max, sum, P), where its bound counts once. chip_smoke.py reports
// the bound. Both are the simple first version: one warp per cache
// position for the scores (the row read by the warp's lanes, coalesced,
// then a shuffle sum per query head), one block per (b, KV head) for
// softmax_v (a max and a sum pass over the scores, then P.V over tiles of
// TILE positions, one thread per (query head, column)).
#include "attention.cuh"

#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int POSITIONS = 64;        // cache positions per scores block
constexpr int TILE = 64;             // positions per P tile in softmax_v
constexpr int MAX_GROUP = 16;        // query heads per KV head
constexpr int MAX_D = 256;
constexpr int PAIRS = MAX_GROUP * MAX_D / THREADS;  // (g, column)s a thread

// Blocks of (POSITIONS positions, kv head, b); q's group rows in shared
// memory as f32 (group * d floats, dynamic).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const int32_t* __restrict__ lens,
                         float* __restrict__ s, int S, int d, int group) {
  extern __shared__ float q_s[];
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int len = max(0, min(lens[blockIdx.z], S));
  for (int e = threadIdx.x; e < group * d; e += THREADS)
    q_s[e] = attn::to_f32(q[bh * group * d + e]);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* k_bh = k + bh * S * d;
  float* s_bh = s + bh * group * S;
  for (int i = warp; i < POSITIONS; i += WARPS) {
    const int t = blockIdx.x * POSITIONS + i;
    if (t >= S) break;
    float acc[MAX_GROUP];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.0f;
    if (t < len) {
      const T* row = k_bh + static_cast<int64_t>(t) * d;
      for (int c = lane; c < d; c += 32) {
        const float kv = attn::to_f32(row[c]);
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
          if (g < group) acc[g] = fmaf(q_s[g * d + c], kv, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) {
        if (g < group) {
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g)
        if (g < group) s_bh[static_cast<int64_t>(g) * S + t] = acc[g];
    }
  }
}

__device__ __forceinline__ float capped(float x, float scale, float softcap) {
  x *= scale;
  return softcap > 0.0f ? softcap * tanhf(x / softcap) : x;
}

// The block's reduction of red[g] for g < group, by max (MAX) or sum,
// through shared memory `part` (WARPS x MAX_GROUP floats); every thread
// gets the results in red.
template <bool MAX>
__device__ __forceinline__ void block_reduce(float (&red)[MAX_GROUP],
                                             float* part, int group) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    if (g < group) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        const float o = __shfl_xor_sync(0xffffffffu, red[g], off);
        red[g] = MAX ? fmaxf(red[g], o) : red[g] + o;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g < group) part[warp * MAX_GROUP + g] = red[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    if (g < group) {
      float r = part[g];
      for (int w = 1; w < WARPS; ++w)
        r = MAX ? fmaxf(r, part[w * MAX_GROUP + g])
                : r + part[w * MAX_GROUP + g];
      red[g] = r;
    }
  }
  __syncthreads();
}

// Blocks of (kv head, b).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_softmax_v_kernel(const float* __restrict__ s,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ lens,
                            T* __restrict__ out, int S, int d, int group,
                            float scale, float softcap) {
  __shared__ float part[WARPS * MAX_GROUP];
  __shared__ float p_s[MAX_GROUP * TILE];
  const int64_t bh =
      static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int len = max(0, min(lens[blockIdx.y], S));
  const float* s_bh = s + bh * group * S;
  const T* v_bh = v + bh * S * d;

  float m[MAX_GROUP], l[MAX_GROUP];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) m[g] = -INFINITY;
  for (int t = threadIdx.x; t < len; t += THREADS) {
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g < group)
        m[g] = fmaxf(m[g], capped(s_bh[static_cast<int64_t>(g) * S + t],
                                  scale, softcap));
  }
  block_reduce<true>(m, part, group);
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) l[g] = 0.0f;
  for (int t = threadIdx.x; t < len; t += THREADS) {
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g < group)
        l[g] += expf(capped(s_bh[static_cast<int64_t>(g) * S + t], scale,
                            softcap) - m[g]);
  }
  block_reduce<false>(l, part, group);

  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.0f;
  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    for (int e = threadIdx.x; e < group * TILE; e += THREADS) {
      const int g = e / TILE;
      const int tt = e % TILE;
      float mg = 0.0f;
#pragma unroll
      for (int h = 0; h < MAX_GROUP; ++h)
        if (h == g) mg = m[h];
      p_s[e] = tt < n ? expf(capped(s_bh[static_cast<int64_t>(g) * S + t0 +
                                         tt],
                                    scale, softcap) - mg)
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e < group * d) {
        const int g = e / d;
        const int c = e % d;
        const T* col = v_bh + static_cast<int64_t>(t0) * d + c;
        float a = acc[i];
        for (int tt = 0; tt < n; ++tt)
          a = fmaf(p_s[g * TILE + tt],
                   attn::to_f32(col[static_cast<int64_t>(tt) * d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (e < group * d) {
      const int g = e / d;
      float lg = 0.0f;
#pragma unroll
      for (int h = 0; h < MAX_GROUP; ++h)
        if (h == g) lg = l[h];
      out[bh * group * d + e] = attn::from_f32<T>(acc[i] / fmaxf(lg, 1e-30f));
    }
  }
}

template <typename Fn>
cudaError_t by_dtype(int dtype, Fn fn) {
  if (dtype == attn::F32) return fn(float{});
  if (dtype == attn::F16) return fn(__half{});
  if (dtype == attn::BF16) return fn(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

bool bad_shape(int b, int n_kv, int group, int S, int d) {
  return b < 1 || n_kv < 1 || group < 1 || group > MAX_GROUP || S < 1 ||
         d < 1 || d > MAX_D || n_kv > 65535 || b > 65535;
}

}  // namespace

// Launches decode_scores_kernel on `stream` without synchronising; returns
// cudaGetLastError(). q (b, n_kv, group, d) and k (b, n_kv, S, d) contiguous
// and of one dtype (attn::F32, F16 or BF16); lens (b,) int32 on the card;
// s (b, n_kv, group, S) f32.
extern "C" int decode_scores_launch(const void* q, const void* k,
                                    const void* lens, void* s, int b,
                                    int n_kv, int group, int S, int d,
                                    int dtype, void* stream) {
  if (bad_shape(b, n_kv, group, S, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + POSITIONS - 1) / POSITIONS, n_kv, b);
  const size_t smem = static_cast<size_t>(group) * d * sizeof(float);
  return static_cast<int>(by_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    decode_scores_kernel<T><<<grid, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const int32_t*>(lens), static_cast<float*>(s), S, d,
        group);
    return cudaGetLastError();
  }));
}

// Launches decode_softmax_v_kernel on `stream` without synchronising;
// returns cudaGetLastError(). s (b, n_kv, group, S) f32, the scores summed
// over the head dim; v (b, n_kv, S, d) and out (b, n_kv, group, d)
// contiguous, of one dtype; lens (b,) int32 on the card; scale the scores'
// factor (1 / sqrt of the whole head dim); softcap 0 means none.
extern "C" int decode_softmax_v_launch(const void* s, const void* v,
                                       const void* lens, void* out, int b,
                                       int n_kv, int group, int S, int d,
                                       float scale, float softcap, int dtype,
                                       void* stream) {
  if (bad_shape(b, n_kv, group, S, d) ||
      !(softcap >= 0.0f && softcap < INFINITY))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_kv, b);
  return static_cast<int>(by_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    decode_softmax_v_kernel<T><<<grid, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(s), static_cast<const T*>(v),
        static_cast<const int32_t*>(lens), static_cast<T*>(out), S, d, group,
        scale, softcap);
    return cudaGetLastError();
  }));
}
