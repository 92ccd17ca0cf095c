// GQA flash-decode for Hopper (sm_90a), bound to PyTorch through a plain C
// entry point loaded with ctypes (repro_torch/kernels/decode_attn.py).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py::decode_attention_pallas
// (_decode_kernel): the `group` query heads that share KV head h attend, one
// new token each, over the first lens[b] positions of the cache:
//
//   out[b,h,g,:] = sum_{t < lens[b]} softmax_t(q[b,h,g,:] . k[b,h,t,:] / sqrt(d))
//                  v[b,h,t,:]
//
// with an f32 softmax and accumulator. q (B, n_kv, group, d) and k, v
// (B, n_kv, S, d) are f32, f16 or bf16; the output is in q's type.
//
// What bounds it: bytes. Every valid cache row of K and V is read once for
// 4*group*d FLOPs, 2 FLOP per byte in bf16 at group 8, far below the card's
// ratio (at decode_32k, B = 128, S = 32768: 8.59 GB of K and V; chip_smoke.py
// reports the bound).
//
// Design (a simple first version, not yet tuned):
//   * split-KV flash-decoding: (b, kv head) alone gives 16 blocks at a batch
//     of 4, for 132 SMs, so the cache axis is cut into splits of `chunk`
//     positions and each (split, kv head, b) is a block. A split that starts
//     at or past lens[b] exits at once; positions >= lens[b] are masked
//     inside, so the cache is never padded or copied;
//   * each block stages a 64-position tile of K and V, converted to f32, in
//     shared memory once for all `group` query heads (the point of the
//     grouped layout), rows padded to d + 1 floats so that threads reading
//     one column of 32 rows hit 32 banks;
//   * scores: thread t owns position t % 64 and every other query head;
//     softmax: one warp per query head; P.V: thread t owns column t % d of
//     the accumulator for its query heads, in registers;
//   * each block leaves its split's (max, sum, accumulator) in f32 scratch
//     that the wrapper allocates; a second kernel combines the splits of each
//     (b, kv head). The pair is one launch of the Python wrapper.
#include "attention.cuh"

#include <math.h>

namespace {

constexpr int TILE = 64;             // cache positions per shared tile
constexpr int THREADS = 128;
constexpr int MAX_GROUP = 16;        // query heads per KV head

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lens,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part, int S, int d, int group,
                        int chunk, float scale) {
  constexpr int DP = 16 * NC;                 // padded head dim
  constexpr int KST = DP + 1;                 // shared row stride
  constexpr int GSTRIDE = THREADS / DP;       // query heads between a
  constexpr int NG = (MAX_GROUP + GSTRIDE - 1) / GSTRIDE;  // thread's own
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int len = max(0, min(lens[blockIdx.z], S));
  const int start = split * chunk;
  if (start >= len) return;          // nothing valid in this split
  const int end = min(start + chunk, len);

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // TILE x KST
  float* vs = ks + TILE * KST;       // TILE x KST
  float* qs = vs + TILE * KST;       // group x DP
  float* ps = qs + group * DP;       // group x TILE: scores, then probs
  float* m_s = ps + group * TILE;    // group: running max
  float* l_s = m_s + group;          // group: running sum
  float* a_s = l_s + group;          // group: this tile's rescale

  const int tid = threadIdx.x;
  const T* qb = q + bh * group * d;
  const T* kb = k + bh * S * static_cast<int64_t>(d);
  const T* vb = v + bh * S * static_cast<int64_t>(d);
  for (int i = tid; i < group * DP; i += THREADS) {
    const int c = i % DP;
    qs[i] = c < d ? attn::to_f32(qb[(i / DP) * d + c]) : 0.0f;
  }
  for (int g = tid; g < group; g += THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }

  const int pc = tid % DP;           // P.V: this thread's column
  const int pg = tid / DP;           // ... and its first query head
  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) acc[i] = 0.0f;

  for (int t0 = start; t0 < end; t0 += TILE) {
    __syncthreads();                 // the previous tile is consumed
    for (int idx = tid; idx < TILE * DP; idx += THREADS) {
      const int j = idx / DP;
      const int c = idx % DP;
      const bool ok = t0 + j < end && c < d;
      const int64_t off = static_cast<int64_t>(t0 + j) * d + c;
      ks[j * KST + c] = ok ? attn::to_f32(kb[off]) : 0.0f;
      vs[j * KST + c] = ok ? attn::to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();

    {  // scores: position j, query heads half, half + 2, ...
      const int j = tid % TILE;
      const int half = tid / TILE;
      float sc[MAX_GROUP / 2];
#pragma unroll
      for (int i = 0; i < MAX_GROUP / 2; ++i) sc[i] = 0.0f;
      const float* kr = ks + j * KST;
#pragma unroll 8
      for (int c = 0; c < DP; ++c) {
        const float kv = kr[c];
#pragma unroll
        for (int i = 0; i < MAX_GROUP / 2; ++i) {
          const int g = half + 2 * i;
          if (g < group) sc[i] = fmaf(qs[g * DP + c], kv, sc[i]);
        }
      }
      const bool valid = t0 + j < end;
#pragma unroll
      for (int i = 0; i < MAX_GROUP / 2; ++i) {
        const int g = half + 2 * i;
        if (g < group) ps[g * TILE + j] = valid ? sc[i] * scale : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax, one warp per query head
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int g = warp; g < group; g += THREADS / 32) {
        const float s0 = ps[g * TILE + lane];
        const float s1 = ps[g * TILE + lane + 32];
        float tmax = fmaxf(s0, s1);
        for (int o = 16; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        // Every tile holds at least one valid position: m_new is finite.
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, tmax);
        const float p0 = expf(s0 - m_new);
        const float p1 = expf(s1 - m_new);
        ps[g * TILE + lane] = p0;
        ps[g * TILE + lane + 32] = p1;
        float psum = p0 + p1;
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        __syncwarp();
        if (lane == 0) {
          m_s[g] = m_new;
          l_s[g] = l_s[g] * alpha + psum;
          a_s[g] = alpha;
        }
      }
    }
    __syncthreads();

    // P.V: column pc of query heads pg, pg + GSTRIDE, ...
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = pg + i * GSTRIDE;
      if (g < group) acc[i] *= a_s[g];
    }
    for (int j = 0; j < TILE; ++j) {
      const float vv = vs[j * KST + pc];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = pg + i * GSTRIDE;
        if (g < group) acc[i] = fmaf(ps[g * TILE + j], vv, acc[i]);
      }
    }
  }

  const int64_t row = (bh * n_splits + split) * group;
  for (int g = tid; g < group; g += THREADS) {
    m_part[row + g] = m_s[g];
    l_part[row + g] = l_s[g];
  }
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = pg + i * GSTRIDE;
    if (g < group && pc < d) acc_part[(row + g) * d + pc] = acc[i];
  }
}

// One block per (kv head, b): out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30) over the splits that hold a valid
// position; 0 where lens[b] is 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_combine_kernel(const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const float* __restrict__ acc_part,
                          const int32_t* __restrict__ lens,
                          T* __restrict__ out, int S, int d, int group,
                          int chunk, int n_splits) {
  const int64_t bh =
      static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int len = max(0, min(lens[blockIdx.y], S));
  const int n_valid = (len + chunk - 1) / chunk;
  for (int e = threadIdx.x; e < group * d; e += blockDim.x) {
    const int g = e / d;
    const int c = e % d;
    float big = -INFINITY;
    for (int s = 0; s < n_valid; ++s)
      big = fmaxf(big, m_part[(bh * n_splits + s) * group + g]);
    float den = 0.0f;
    float num = 0.0f;
    for (int s = 0; s < n_valid; ++s) {
      const int64_t row = (bh * n_splits + s) * group + g;
      const float w = expf(m_part[row] - big);
      den = fmaf(l_part[row], w, den);
      num = fmaf(acc_part[row * d + c], w, num);
    }
    out[(bh * group + g) * d + c] = attn::from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lens;
  float* m_part;
  float* l_part;
  float* acc_part;
  void* out;
  int b, n_kv, group, s, d, chunk, n_splits;
  float scale;
  cudaStream_t stream;

  template <typename T, int NC>
  cudaError_t operator()() const {
    constexpr int DP = 16 * NC;
    const size_t smem =
        (2 * TILE * (DP + 1) + group * DP + group * TILE + 3 * group) *
        sizeof(float);
    cudaError_t err = attn::allow_smem(
        reinterpret_cast<const void*>(decode_split_kernel<T, NC>), smem);
    if (err != cudaSuccess) return err;
    decode_split_kernel<T, NC>
        <<<dim3(n_splits, n_kv, b), THREADS, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), lens, m_part, l_part, acc_part, s, d,
            group, chunk, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<T><<<dim3(n_kv, b), THREADS, 0, stream>>>(
        m_part, l_part, acc_part, lens, static_cast<T*>(out), s, d, group,
        chunk, n_splits);
    return cudaGetLastError();
  }
};

}  // namespace

// Launches both kernels on `stream` without synchronising; returns
// cudaGetLastError(). q, out (b, n_kv, group, d); k, v (b, n_kv, s, d); all
// contiguous and of one dtype (attn::F32, F16 or BF16); lens (b,) int32 on
// the card; d <= 128, group <= 16; chunk a multiple of 64 with
// n_splits * chunk >= s. Scratch, f32: m_part and l_part
// (b, n_kv, n_splits, group), acc_part (b, n_kv, n_splits, group, d).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* lens, void* m_part,
                                  void* l_part, void* acc_part, void* out,
                                  int b, int n_kv, int group, int s, int d,
                                  int chunk, int n_splits, float scale,
                                  int dtype, void* stream) {
  if (group < 1 || group > MAX_GROUP || chunk % TILE != 0 ||
      static_cast<int64_t>(n_splits) * chunk < s) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch launch{q,
                      k,
                      v,
                      static_cast<const int32_t*>(lens),
                      static_cast<float*>(m_part),
                      static_cast<float*>(l_part),
                      static_cast<float*>(acc_part),
                      out,
                      b,
                      n_kv,
                      group,
                      s,
                      d,
                      chunk,
                      n_splits,
                      scale,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(attn::dispatch(dtype, d, launch));
}
