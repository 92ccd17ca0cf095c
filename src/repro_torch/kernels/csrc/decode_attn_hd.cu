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
// What bounds them: bytes. decode_scores reads each valid K row once and
// writes the (B, n_kv, group, S) f32 scores once; decode_softmax_v reads
// the scores and each valid V row once. At d' = 8 (Yi-6B's decode_32k over
// 16 model ranks) a K or V row is 16 bytes against 4 * group bytes of
// scores, so the scores are two thirds of the bytes; the work is 2 * group
// * d' FLOPs a row, far below the card's ratio at small d'.
// chip_smoke.py reports each kernel's bound. On an H100 at d' = 8,
// decode_scores takes 72% of the byte bound's speed and decode_softmax_v
// 37%: its split kernel is held back by instruction issue (a scale and an
// exp2 a score, the bf16 unpacking and 2 * group * d' FMAs a row, a
// shuffle sum a split, two barriers), not by bytes.
//
// The design (the first version, one warp a position and one block a
// (b, kv head), reached 1-3% of the bound):
//
// * decode_scores, blocks of (chunk of positions, kv head, b), enough
//   chunks for two waves of blocks over the SMs; q in shared memory as f32.
//   Route "fma" (f32, and 16-bit rows that are not a multiple of 16 dims):
//   neighbouring threads own neighbouring positions, TPR threads a row
//   (one at d' = 8 in 16 bits: the row is one 16-byte vector), each thread
//   reading its part of the row as 16-byte vectors (scalars where rows are
//   not 16-byte aligned) and keeping group sums in registers; the TPR lanes
//   of a row sum by shuffles, and the stores of s are coalesced for each g
//   (32 consecutive positions a warp). Route "mma" (f16, bf16, d' a
//   multiple of 16): at group 16 and large d' the FMA route would need
//   about 16 FLOP a byte, near the f32 FMA ridge, so each warp runs
//   mma.sync.m16n8k16 (f32 accumulate) with Q padded to 16 rows as A (held
//   in registers for every k-step) and 8 positions of K as B, loaded
//   straight from the rows; the f32 tile of 16 x 8 scores goes out as
//   32-byte segments a query head.
// * decode_softmax_v, split over the positions as decode_attn.cu's split
//   and combine are: blocks of (split of `chunk` positions, kv head, b);
//   each starts copying its split's V rows into shared memory by cp.async
//   (where they fit beside the scores: at d' = 8, 8 KiB), reads its
//   split's scores once, applies scale and cap once a score into shared
//   memory, and a warp a query head takes the max, the exponentials (kept
//   in shared memory as p) and their sum while V arrives; then P.V with
//   V rows read as 16-byte vectors, TP neighbouring lanes on neighbouring
//   rows and the other lanes on a row's other vectors, so that a warp reads
//   whole rows; the split's (max, sum, accumulator) go to f32 scratch that
//   the wrapper allocates, and a combine kernel joins the splits: a block
//   a (b, kv head), its threads over the splits and the output elements
//   (decode_attn.cu's combine, a thread an element walking every split,
//   took 0.031 ms over the 64 splits of a decode_32k slice on an H100).
//   A split that starts at or past lens[b] exits at once, and the combine
//   reads only the splits below lens[b].
#include "attention.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 16;        // query heads per KV head
constexpr int MAX_D = 256;
constexpr int MAX_ACC = 16;          // f32 accumulators a P.V thread holds
constexpr size_t SPLIT_SMEM = 48 * 1024;   // a split block's shared memory

// VEC elements of `src` as f32: one 16-byte load where VEC fills 16 bytes,
// else VEC scalar loads.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* src, float (&dst)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = attn::to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = attn::to_f32(src[i]);
  }
}

__device__ __forceinline__ float capped(float x, float scale, float softcap) {
  x *= scale;
  return softcap > 0.0f ? softcap * tanhf(x / softcap) : x;
}

// decode_softmax_v keeps its logits in base-2 units, cap(x) * log2(e), so
// that each exponential is one exp2f; the split maxima it leaves for the
// combine are in the same units.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float logit2(float x, float scale, float softcap) {
  return capped(x, scale, softcap) * LOG2E;
}

// ---- decode_scores, route "fma" -------------------------------------------
// Blocks of (chunk, kv head, b); TPR threads a position, VEC elements a
// load. The loop over the chunk is uniform across the block, so that every
// lane reaches the shuffles.
template <typename T, int VEC, int TPR>
__global__ void __launch_bounds__(THREADS)
    scores_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const int32_t* __restrict__ lens, float* __restrict__ s,
                      int S, int d, int group, int chunk) {
  extern __shared__ float q_s[];                 // group x d, f32
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int len = max(0, min(lens[blockIdx.z], S));
  for (int e = threadIdx.x; e < group * d; e += THREADS)
    q_s[e] = attn::to_f32(q[bh * group * d + e]);
  __syncthreads();
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, S);
  const int live_end = min(end, len);
  const int sub = threadIdx.x % TPR;
  const T* k_bh = k + bh * S * static_cast<int64_t>(d);
  float* s_bh = s + bh * group * static_cast<int64_t>(S);
  for (int base = start; base < end; base += THREADS / TPR) {
    const int t = base + threadIdx.x / TPR;
    float acc[MAX_GROUP];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.0f;
    if (t < live_end) {
      const T* row = k_bh + static_cast<int64_t>(t) * d;
      for (int c = sub * VEC; c < d; c += TPR * VEC) {
        float kv[VEC];
        load_vec<T, VEC>(row + c, kv);
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g) {
          if (g < group) {
            const float* qg = q_s + g * d + c;
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[g] = fmaf(qg[i], kv[i], acc[g]);
          }
        }
      }
    }
    if constexpr (TPR > 1) {
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) {
        if (g < group) {
#pragma unroll
          for (int off = TPR / 2; off > 0; off /= 2)
            acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
        }
      }
    }
    if (sub == 0 && t < end) {
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g)
        if (g < group) s_bh[static_cast<int64_t>(g) * S + t] = acc[g];
    }
  }
}

// ---- decode_scores, route "mma" -------------------------------------------
// Blocks of (chunk, kv head, b); each warp takes 8 positions at a time, the
// N of one m16n8k16 per 16 dims. A (Q, rows past `group` zero) stays in
// registers for all d / 16 k-steps; lane 4n + j reads B's dims 2j, 2j + 1
// and 2j + 8, 2j + 9 of position n as 32-bit pairs, zeros at or past
// lens[b].
__device__ __forceinline__ uint32_t ld_pair(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scores_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const int32_t* __restrict__ lens, float* __restrict__ s,
                      int S, int d, int group, int chunk) {
  constexpr int MAX_K = MAX_D / 16;
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int len = max(0, min(lens[blockIdx.z], S));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane / 4;              // A row, B column, C row
  const int j = lane % 4;
  const int nk = d / 16;
  const T* qb = q + bh * group * d;
  uint32_t a[MAX_K][4];
#pragma unroll
  for (int ks = 0; ks < MAX_K; ++ks) {
    if (ks < nk) {
      const int c = ks * 16 + 2 * j;
      a[ks][0] = r < group ? ld_pair(qb + r * d + c) : 0u;
      a[ks][1] = r + 8 < group ? ld_pair(qb + (r + 8) * d + c) : 0u;
      a[ks][2] = r < group ? ld_pair(qb + r * d + c + 8) : 0u;
      a[ks][3] = r + 8 < group ? ld_pair(qb + (r + 8) * d + c + 8) : 0u;
    }
  }
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, S);
  const int live_end = min(end, len);
  const T* k_bh = k + bh * S * static_cast<int64_t>(d);
  float* s_bh = s + bh * group * static_cast<int64_t>(S);
  for (int t0 = start + warp * 8; t0 < end; t0 += WARPS * 8) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool live = t0 + r < live_end;
    const T* kr = k_bh + static_cast<int64_t>(t0 + r) * d + 2 * j;
#pragma unroll
    for (int ks = 0; ks < MAX_K; ++ks) {
      if (ks < nk) {
        const uint32_t b0 = live ? ld_pair(kr + ks * 16) : 0u;
        const uint32_t b1 = live ? ld_pair(kr + ks * 16 + 8) : 0u;
        attn::mma_16816<T>(c, a[ks], b0, b1);
      }
    }
    const int t = t0 + 2 * j;
    if (r < group) {
      float* row = s_bh + static_cast<int64_t>(r) * S;
      if (t < end) row[t] = c[0];
      if (t + 1 < end) row[t + 1] = c[1];
    }
    if (r + 8 < group) {
      float* row = s_bh + static_cast<int64_t>(r + 8) * S;
      if (t < end) row[t] = c[2];
      if (t + 1 < end) row[t + 1] = c[3];
    }
  }
}

// ---- decode_softmax_v: split kernel ---------------------------------------
// Blocks of (split, kv head, b). p_s holds the split's group x chunk scores,
// then their exponentials. With STAGE_V the split's V rows are copied into
// v_s by cp.async at the start, in flight while the softmax runs (the
// wrapper's plan keeps them within shared memory); without it P.V reads
// them from global memory. In P.V a thread owns ITEMS (query head, VEC
// columns) items and the positions t = tp, tp + TP, ... of the split, TP =
// 2^tp_log2 neighbouring lanes sharing its items; the TP lanes then sum by
// shuffles.
template <typename T, int VEC, int ITEMS, bool STAGE_V>
__global__ void __launch_bounds__(THREADS)
    softmax_v_split_kernel(const float* __restrict__ s,
                           const T* __restrict__ v,
                           const int32_t* __restrict__ lens,
                           float* __restrict__ m_part,
                           float* __restrict__ l_part,
                           float* __restrict__ acc_part, int S, int d,
                           int group, int chunk, int tp_log2, float scale,
                           float softcap) {
  extern __shared__ __align__(16) float p_s[];   // group x chunk, then V
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int split = blockIdx.x;
  const int len = max(0, min(lens[blockIdx.z], S));
  const int start = split * chunk;
  if (start >= len) return;                      // nothing valid here
  const int n = min(chunk, len - start);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = (bh * gridDim.x + split) * group;
  const T* v_bh = v + (bh * S + start) * static_cast<int64_t>(d);
  T* v_s = reinterpret_cast<T*>(p_s + group * chunk);
  if constexpr (STAGE_V) {
    // The split's n rows are contiguous: n * d elements, 16-byte pieces.
    const int pieces = n * d * static_cast<int>(sizeof(T)) / 16;
    const uint32_t base = attn::smem_addr(v_s);
    for (int i = threadIdx.x; i < pieces; i += THREADS)
      attn::cp_async<16>(base + 16 * i,
                         reinterpret_cast<const char*>(v_bh) + 16 * i, 16);
    attn::cp_async_commit();
  }

  // The scores as float4 where the rows are 16-byte aligned (S a multiple
  // of 4; a split starts at a multiple of 32), four loads in flight a
  // thread; the last quad of a short split element by element.
  const float* s_bh = s + bh * group * static_cast<int64_t>(S) + start;
  if ((S & 3) == 0) {
    const int n4 = (n + 3) / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < group * n4; e += THREADS) {
      const int g = e / n4;
      const int t = 4 * (e - g * n4);
      const float* src = s_bh + static_cast<int64_t>(g) * S + t;
      float* dst = p_s + g * chunk + t;
      if (t + 4 <= n) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        *reinterpret_cast<float4*>(dst) =
            make_float4(logit2(x.x, scale, softcap), logit2(x.y, scale, softcap),
                        logit2(x.z, scale, softcap), logit2(x.w, scale, softcap));
      } else {
        for (int i = 0; t + i < n; ++i) dst[i] = logit2(src[i], scale, softcap);
      }
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < group * n; e += THREADS) {
      const int g = e / n;
      const int t = e - g * n;
      p_s[g * chunk + t] =
          logit2(s_bh[static_cast<int64_t>(g) * S + t], scale, softcap);
    }
  }
  __syncthreads();
  for (int g = warp; g < group; g += WARPS) {
    float* pg = p_s + g * chunk;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pg[t]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int t = lane; t < n; t += 32) {
      const float p = exp2f(pg[t] - mx);
      pg[t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_part[row0 + g] = mx;
      l_part[row0 + g] = sum;
    }
  }
  if constexpr (STAGE_V) attn::cp_async_wait<0>();
  __syncthreads();

  const int tp_n = 1 << tp_log2;
  const int tp = threadIdx.x & (tp_n - 1);
  const int slot = threadIdx.x >> tp_log2;
  const int slots = THREADS >> tp_log2;
  const int cv_n = d / VEC;
  const int items = group * cv_n;
  float acc[ITEMS][VEC];
  int p_off[ITEMS], v_off[ITEMS];     // an item's p row and V columns
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int item = slot + i * slots;
    const int g = item / cv_n;
    p_off[i] = item < items ? g * chunk : -1;
    v_off[i] = (item - g * cv_n) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.0f;
  }
  const T* v_rows = STAGE_V ? v_s : v_bh;
#pragma unroll 4
  for (int t = tp; t < n; t += tp_n) {
    const T* row = v_rows + static_cast<int64_t>(t) * d;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (p_off[i] >= 0) {
        float vv[VEC];
        load_vec<T, VEC>(row + v_off[i], vv);
        const float p = p_s[p_off[i] + t];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }
  for (int off = tp_n / 2; off > 0; off /= 2) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
  }
  if (tp == 0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int item = slot + i * slots;
      if (item < items) {
        const int g = item / cv_n;
        const int cv = item - g * cv_n;
        float* dst = acc_part + (row0 + g) * d + cv * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = acc[i][e];
      }
    }
  }
}

// ---- decode_softmax_v: combine --------------------------------------------
// Blocks of (kv head, b): out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s -
// M) over the splits below lens[b] (m in base-2 units), 0 where lens[b] is
// 0. A warp a query
// head finds M and the denominator with its lanes over the splits; then
// PARTS = THREADS / (group * d) threads (at least 1) share each output
// element's splits, and sum through shared memory. decode_attn.cu's
// combine gives each element one thread, which would walk all 64 splits of
// a decode_32k slice alone.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    softmax_v_combine_kernel(const float* __restrict__ m_part,
                             const float* __restrict__ l_part,
                             const float* __restrict__ acc_part,
                             const int32_t* __restrict__ lens,
                             T* __restrict__ out, int S, int d, int group,
                             int chunk, int n_splits) {
  __shared__ float big_s[MAX_GROUP];
  __shared__ float den_s[MAX_GROUP];
  __shared__ float part_s[THREADS];
  const int64_t bh =
      static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int len = max(0, min(lens[blockIdx.y], S));
  const int n_valid = (len + chunk - 1) / chunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* m_bh = m_part + bh * n_splits * group;
  const float* l_bh = l_part + bh * n_splits * group;
  const float* a_bh = acc_part + bh * n_splits * group * static_cast<int64_t>(d);
  for (int g = warp; g < group; g += WARPS) {
    float big = -INFINITY;
    for (int s = lane; s < n_valid; s += 32)
      big = fmaxf(big, m_bh[s * group + g]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
    float den = 0.0f;
    for (int s = lane; s < n_valid; s += 32)
      den = fmaf(l_bh[s * group + g], exp2f(m_bh[s * group + g] - big), den);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) {
      big_s[g] = big;
      den_s[g] = den;
    }
  }
  __syncthreads();
  const int elems = group * d;
  const int parts = max(1, THREADS / elems);
  const int part = threadIdx.x / elems;        // >= parts: no element
  for (int e0 = 0; e0 < elems; e0 += THREADS / parts) {
    const int e = e0 + threadIdx.x % elems;
    const bool mine = part < parts && e < elems && threadIdx.x % elems <
                      THREADS / parts;
    float num = 0.0f;
    if (mine) {
      const int g = e / d;
      const int c = e - g * d;
      const float big = big_s[g];
#pragma unroll 4
      for (int s = part; s < n_valid; s += parts)
        num = fmaf(a_bh[(static_cast<int64_t>(s) * group + g) * d + c],
                   exp2f(m_bh[s * group + g] - big), num);
    }
    if (parts > 1) {
      part_s[threadIdx.x] = num;
      __syncthreads();
      if (part == 0 && mine)
        for (int p = 1; p < parts; ++p) num += part_s[p * elems + threadIdx.x];
      __syncthreads();
    }
    if (part == 0 && mine)
      out[bh * elems + e] =
          attn::from_f32<T>(num / fmaxf(den_s[e / d], 1e-30f));
  }
}

template <typename Fn>
cudaError_t by_dtype(int dtype, Fn fn) {
  if (dtype == attn::F32) return fn(float{});
  if (dtype == attn::F16) return fn(__half{});
  if (dtype == attn::BF16) return fn(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

bool bad_shape(int b, int n_kv, int group, int S, int d, int chunk) {
  return b < 1 || n_kv < 1 || group < 1 || group > MAX_GROUP || S < 1 ||
         d < 1 || d > MAX_D || n_kv > 65535 || b > 65535 || chunk < 1;
}

// Elements a 16-byte load takes where every row of `d` elements starts on
// a 16-byte boundary (the base pointer too), else 1.
template <typename T>
int vector_width(const void* base, int d) {
  constexpr int V = 16 / sizeof(T);
  return d % V == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0 ? V : 1;
}

}  // namespace

// Launches decode_scores on `stream` without synchronising; returns
// cudaGetLastError() and writes the route taken to *route: 1 "mma" for f16
// and bf16 at d a multiple of 16, else 0 "fma". q (b, n_kv, group, d) and
// k (b, n_kv, S, d) contiguous and of one dtype (attn::F32, F16 or BF16);
// lens (b,) int32 on the card; s (b, n_kv, group, S) f32; chunk positions
// a block, a multiple of 256.
extern "C" int decode_scores_launch(const void* q, const void* k,
                                    const void* lens, void* s, int b,
                                    int n_kv, int group, int S, int d,
                                    int chunk, int dtype, int* route,
                                    void* stream) {
  if (bad_shape(b, n_kv, group, S, d, chunk) || chunk % THREADS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + chunk - 1) / chunk, n_kv, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  float* out = static_cast<float*>(s);
  return static_cast<int>(by_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    if constexpr (!std::is_same_v<T, float>) {
      if (d % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 4 == 0) {
        *route = 1;
        scores_mma_kernel<T><<<grid, THREADS, 0, st>>>(qt, kt, ln, out, S, d,
                                                       group, chunk);
        return cudaGetLastError();
      }
    }
    *route = 0;
    const size_t smem = static_cast<size_t>(group) * d * sizeof(float);
    const int vec = vector_width<T>(k, d);
    const int per_row = d / vec;
    auto run = [&](auto vec_tag, auto tpr_tag) {
      constexpr int V = decltype(vec_tag)::value;
      constexpr int R = decltype(tpr_tag)::value;
      scores_fma_kernel<T, V, R><<<grid, THREADS, smem, st>>>(
          qt, kt, ln, out, S, d, group, chunk);
    };
    using VFull = std::integral_constant<int, 16 / sizeof(T)>;
    using VOne = std::integral_constant<int, 1>;
    auto by_tpr = [&](auto vec_tag) {
      if (per_row >= 8) run(vec_tag, std::integral_constant<int, 8>{});
      else if (per_row >= 4) run(vec_tag, std::integral_constant<int, 4>{});
      else if (per_row >= 2) run(vec_tag, std::integral_constant<int, 2>{});
      else run(vec_tag, std::integral_constant<int, 1>{});
    };
    if (vec == 1) by_tpr(VOne{});
    else by_tpr(VFull{});
    return cudaGetLastError();
  }));
}

// Launches decode_softmax_v's split kernel and the combine on `stream`
// without synchronising; returns cudaGetLastError(). s (b, n_kv, group, S)
// f32, the scores summed over the head dim; v (b, n_kv, S, d) and out
// (b, n_kv, group, d) contiguous, of one dtype; lens (b,) int32 on the
// card; scale the scores' factor (1 / sqrt of the whole head dim); softcap
// 0 means none. chunk positions a split, a multiple of 32 with
// n_splits * chunk >= S and group * chunk * 4 bytes <= 48 KiB (the split's V
// rows are staged beside them where they fit). Scratch, f32:
// m_part and l_part (b, n_kv, n_splits, group), acc_part
// (b, n_kv, n_splits, group, d).
extern "C" int decode_softmax_v_launch(const void* s, const void* v,
                                       const void* lens, void* m_part,
                                       void* l_part, void* acc_part,
                                       void* out, int b, int n_kv, int group,
                                       int S, int d, int chunk, int n_splits,
                                       float scale, float softcap, int dtype,
                                       void* stream) {
  if (bad_shape(b, n_kv, group, S, d, chunk) || chunk % 32 != 0 ||
      static_cast<int64_t>(n_splits) * chunk < S ||
      static_cast<size_t>(group) * chunk * sizeof(float) > SPLIT_SMEM ||
      !(softcap >= 0.0f && softcap < INFINITY))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_splits, n_kv, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  const size_t p_bytes = static_cast<size_t>(group) * chunk * sizeof(float);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  return static_cast<int>(by_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    const T* vt = static_cast<const T*>(v);
    const int vec = vector_width<T>(v, d);
    // V staged in shared memory where its rows are 16-byte vectors and
    // the split's fit beside the scores in SPLIT_SMEM bytes.
    const size_t v_bytes = static_cast<size_t>(chunk) * d * sizeof(T);
    const bool stage = vec > 1 && p_bytes + v_bytes <= SPLIT_SMEM;
    const size_t smem = stage ? p_bytes + v_bytes : p_bytes;
    const int items = group * (d / vec);
    // TP lanes a thread's items: as many as leave every item a thread,
    // at most a warp; past THREADS items, ITEMS of them a thread.
    int tp_log2 = 0;
    while (tp_log2 < 5 && (items << (tp_log2 + 1)) <= THREADS) ++tp_log2;
    const int per_thread = (items + (THREADS >> tp_log2) - 1) /
                           (THREADS >> tp_log2);
    auto run = [&](auto vec_tag, auto items_tag) {
      constexpr int V = decltype(vec_tag)::value;
      constexpr int I = decltype(items_tag)::value;
      if (stage)
        softmax_v_split_kernel<T, V, I, true><<<grid, THREADS, smem, st>>>(
            static_cast<const float*>(s), vt, ln, mp, lp, ap, S, d, group,
            chunk, tp_log2, scale, softcap);
      else
        softmax_v_split_kernel<T, V, I, false><<<grid, THREADS, smem, st>>>(
            static_cast<const float*>(s), vt, ln, mp, lp, ap, S, d, group,
            chunk, tp_log2, scale, softcap);
    };
    // ITEMS * VEC accumulators stay within MAX_ACC: 512 items (16-bit,
    // d = 256, group 16) are 2 a thread, 1,024 (f32) 4, 4,096 scalars 16.
    auto by_items = [&](auto vec_tag) {
      constexpr int V = decltype(vec_tag)::value;
      constexpr int MOST = MAX_ACC / V;
      if (per_thread <= 1) run(vec_tag, std::integral_constant<int, 1>{});
      else if (per_thread <= 2) run(vec_tag, std::integral_constant<int, 2>{});
      else if (per_thread <= 4)
        run(vec_tag, std::integral_constant<int, (MOST < 4 ? MOST : 4)>{});
      else run(vec_tag, std::integral_constant<int, MOST>{});
    };
    if (vec == 1) by_items(std::integral_constant<int, 1>{});
    else by_items(std::integral_constant<int, 16 / sizeof(T)>{});
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    softmax_v_combine_kernel<T><<<dim3(n_kv, b), THREADS, 0, st>>>(
        mp, lp, ap, ln, static_cast<T*>(out), S, d, group, chunk, n_splits);
    return cudaGetLastError();
  }));
}
