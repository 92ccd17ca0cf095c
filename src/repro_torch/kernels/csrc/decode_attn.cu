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
// (B, n_kv, S, d) are f32, f16 or bf16, d <= 256; the output is in q's
// type.
//
// With an attention softcap (softcap > 0, Gemma-2's; the TPU kernel has
// none, so this follows the reference's _decode_attn in
// repro/models/transformer.py), each valid score x = q.k * scale becomes
// softcap * tanh(x / softcap) before the softmax, and a masked one stays
// -inf. Each split kernel is a template on CAP, so without a softcap the
// instructions are those of the kernel before it. A sliding-window layer's
// ring cache comes with lens = min(pos + 1, ring size): its slots, in any
// order, are the window's keys (models/transformer.py says why).
//
// What bounds it: bytes. Every valid cache row of K and V is read once for
// 4*group*d FLOPs, 2 FLOP per byte in bf16 at group 8, far below the card's
// ratio (at decode_32k, B = 128, S = 32768: 8.59 GB of K and V, 2.56 ms at
// 3.35 TB/s; chip_smoke.py reports the bound). Scalar f32 FMA at that rate
// would need 40% of the card's FMA peak, so the 16-bit route multiplies on
// the tensor cores and spends its effort on keeping bytes in flight.
//
// Both routes cut the cache axis into splits of `chunk` positions (a batch
// of 4 gives only 16 (b, kv head) pairs for 132 SMs): each (split, kv head,
// b) is a block; a split that starts at or past lens[b] exits at once, and
// positions >= lens[b] are masked inside, so the cache is never padded or
// copied and the host never syncs. Each block leaves its split's (max, sum,
// accumulator) in f32 scratch that the wrapper allocates; a second kernel
// combines the splits of each (b, kv head). The pair is one launch of the
// Python wrapper.
//
// Two split kernels, chosen by dtype in decode_attn_launch:
//
// * f16 and bf16: the byte-streaming tensor-core kernel (namespace tc).
//   - A tile is 64 positions of one (b, kv head): 64 x d contiguous
//     elements, 16 KiB of K and 16 KiB of V at d = 128. Tiles stay in their
//     16-bit type in XOR-swizzled shared memory, copied by 16-byte cp.async
//     (8, 4 or 2 bytes where rows are not 16-byte aligned) into a ring of
//     STAGES = 3: two tiles are in flight while one is consumed, 64 KiB per
//     block and 128 KiB per SM at two blocks per SM.
//   - The group's query heads are the 16 rows of one MMA tile, rows past
//     `group` zero; Q stays in registers as A fragments. Each of the 4 warps
//     takes 16 of a tile's 64 positions and keeps its own online softmax
//     (max, sum, 16 x d accumulator in registers) over its positions of
//     every tile: S = Q·Kᵀ and P·V by mma.sync.m16n8k16 (f32 accumulate),
//     K through ldmatrix, V through ldmatrix.trans, P split into p_hi and
//     p_lo as in flash_attn.cu (attention.cuh, split_pair). At group 8 that
//     is 2 FLOP per byte; the MMAs take a small part of a tile's time.
//   - At the end the 4 warps merge through shared memory into the split's
//     (max, sum, accumulator).
//   At d = 128: 100 KiB of dynamic shared memory, two blocks per SM; ptxas
//   (CUDA 12.8) gives 199-202 registers and no spills. At d = 256 (NC = 16,
//   RecurrentGemma's MQA decode, group 10; 129-255 pad to it) the 16 x 256
//   accumulator takes 128 registers a lane, so Q is reloaded from shared
//   memory by ldmatrix at each k-step instead of held (8 k-steps unrolled
//   at once: 243-250 registers, no spills); the ring keeps STAGES = 3,
//   200 KiB, one block per SM, and the wrapper's split plan asks for half
//   the blocks (decode_attn.py, BLOCKS_PER_SM_WIDE). On an H100 80GB HBM3
//   at 700 W it reads decode_32k's 8.59 GB cache in 2.82-2.85 ms, 3.0 TB/s
//   and 90% of the bound.
// * f32: the FMA kernel of the port's first version (namespace f32fma),
//   kept as it was; the tensor cores take f32 only as TF32 (10 bits), which
//   the f32 route's per-element limit rules out. It stages each tile widened
//   to f32 in a (d + 1)-padded layout, one thread per position for the
//   scores, one warp per query head for the softmax, one thread per column
//   for P·V (two at d = 256).
//
// What the first version (now the f32 route) measured when it served every
// dtype, on an H100 80GB HBM3 at 700 W, bf16 at decode_32k: 21.09-21.33
// ms, 405 GB/s (12% of the HBM rate), against 2.70-2.86 ms for SDPA with
// enable_gqa. Its 2-byte synchronous loads and 66 KB f32 tiles left three
// 128-thread blocks per SM and no second tile in flight.
#include "attention.cuh"

#include <math.h>

namespace {

constexpr int TILE = 64;             // cache positions per shared tile
constexpr int THREADS = 128;
constexpr int MAX_GROUP = 16;        // query heads per KV head

namespace f32fma {

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lens,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part, int S, int d, int group,
                        int chunk, float scale, float softcap) {
  constexpr int DP = 16 * NC;                 // padded head dim
  const float inv_cap = CAP ? 1.0f / softcap : 0.0f;
  constexpr int KST = DP + 1;                 // shared row stride
  constexpr int COLS = DP < THREADS ? DP : THREADS;  // columns a pass takes
  constexpr int CPT = DP / COLS;              // a thread's columns (d = 256: 2)
  constexpr int GSTRIDE = THREADS / COLS;     // query heads between a
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

  const int pc = tid % COLS;         // P.V: this thread's first column
  const int pg = tid / COLS;         // ... and its first query head
  float acc[NG * CPT];
#pragma unroll
  for (int i = 0; i < NG * CPT; ++i) acc[i] = 0.0f;

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
        if (g < group) {
          float x = sc[i] * scale;
          if constexpr (CAP) x = softcap * tanhf(x * inv_cap);
          ps[g * TILE + j] = valid ? x : -INFINITY;
        }
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

    // P.V: columns pc, pc + COLS, ... of query heads pg, pg + GSTRIDE, ...
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = pg + i * GSTRIDE;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (g < group) acc[i * CPT + c] *= a_s[g];
    }
    for (int j = 0; j < TILE; ++j) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vs[j * KST + pc + c * COLS];
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int g = pg + i * GSTRIDE;
          if (g < group)
            acc[i * CPT + c] = fmaf(ps[g * TILE + j], vv, acc[i * CPT + c]);
        }
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
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = pc + c * COLS;
      if (g < group && col < d)
        acc_part[(row + g) * d + col] = acc[i * CPT + c];
    }
  }
}


}  // namespace f32fma

namespace tc {

constexpr int STAGES = 3;            // K/V tiles in the ring
constexpr int WARPS = THREADS / 32;  // each takes TILE / WARPS positions
static_assert(TILE == 16 * WARPS, "one 16-position MMA step per warp");

// d = 256 (NC = 16): the 16 x 256 accumulator takes 128 registers a lane,
// so Q's A fragments are not held for the tile loop (64 more) but reloaded
// from shared memory by ldmatrix at each k-step.
template <int NC>
constexpr bool WIDE = NC > 8;
// d = 256: the k-steps of Q.K^T unrolled at once. All 16 let ptxas hoist
// the fragment loads of every step and spill (16-20 bytes at 255
// registers); 8 spills none, and of 16, 8, 4, 2 and 1 it was the fastest
// flash at RecurrentGemma's prefill layer (H100 80GB HBM3, 700 W).
constexpr int WIDE_KK_UNROLL = 8;

template <int NC>
__host__ __device__ constexpr int smem_bytes() {
  return (MAX_GROUP + 2 * STAGES * TILE) * 16 * NC * 2;  // Q, then K, V
}

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(THREADS, 2)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lens,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part, int S, int d, int group,
                        int chunk, float scale, float softcap, int vec) {
  constexpr int DP = 16 * NC;                  // padded head dim
  constexpr int TB = TILE * DP * 2;            // bytes of a K or V tile
  constexpr int QB = MAX_GROUP * DP * 2;       // bytes of the Q tile
  constexpr int NO = DP / 8;                   // output n-tiles
  static_assert(smem_bytes<NC>() >= WARPS * MAX_GROUP * (DP + 2) * 4,
                "the warps' merge fits in the ring");
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int len = max(0, min(lens[blockIdx.z], S));
  const int start = split * chunk;
  if (start >= len) return;          // nothing valid in this split
  const int end = min(start + chunk, len);
  const int n_tiles = (end - start + TILE - 1) / TILE;

  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Scores stay in raw q.k units, scale folded into exp2 and m_part; with
  // the softcap they are softcapped scores, already in scaled units.
  const float unit = CAP ? 1.0f : scale;
  const float unit_log2 = unit * 1.4426950408889634f;
  const float cap_in = CAP ? scale / softcap : 0.0f;
  const T* kb = k + bh * S * static_cast<int64_t>(d);
  const T* vb = v + bh * S * static_cast<int64_t>(d);

  auto stage = [&](int it) { return smem + QB + 2 * TB * (it % STAGES); };
  auto load_kv = [&](int it) {
    const int t0 = start + it * TILE;
    const int64_t off = static_cast<int64_t>(t0) * d;
    attn::load_tile<T, TILE, DP, THREADS>(stage(it), kb + off, end - t0, d,
                                          vec, tid);
    attn::load_tile<T, TILE, DP, THREADS>(stage(it) + TB, vb + off, end - t0,
                                          d, vec, tid);
  };
  attn::load_tile<T, MAX_GROUP, DP, THREADS>(smem, q + bh * group * d, group,
                                             d, vec, tid);
  load_kv(0);
  attn::cp_async_commit();
#pragma unroll
  for (int it = 1; it < STAGES - 1; ++it) {
    if (it < n_tiles) load_kv(it);
    attn::cp_async_commit();
  }

  // Per-lane ldmatrix offsets, as in flash_attn.cu; this warp's positions
  // are kw .. kw + 15 of each tile.
  const int kw = warp * 16;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = kw + (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = kw + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;
  const int g = lane >> 2, t = lane & 3;

  const uint32_t qs = attn::smem_addr(smem);
  uint32_t qf[WIDE<NC> ? 1 : NC][4];  // Q's A fragments (d <= 128 only)
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    attn::cp_async_wait<STAGES - 2>();
    __syncthreads();                 // tile it landed; tile it - 1 consumed
    if constexpr (!WIDE<NC>) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < NC; ++kk)
          attn::ldmatrix_x4(
              qs + attn::swizzle<DP>((a_row * DP + kk * 16 + a_col) * 2),
              qf[kk]);
      }
    }
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    attn::cp_async_commit();

    const int t0 = start + it * TILE;
    const uint32_t ks = attn::smem_addr(stage(it));
    const uint32_t vs = ks + TB;

    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    if constexpr (WIDE<NC>) {
#pragma unroll(WIDE_KK_UNROLL)
      for (int kk = 0; kk < NC; ++kk) {
        uint32_t a[4], b[4];
        attn::ldmatrix_x4(
            qs + attn::swizzle<DP>((a_row * DP + kk * 16 + a_col) * 2), a);
        attn::ldmatrix_x4(
            ks + attn::swizzle<DP>((k_row * DP + kk * 16 + k_col) * 2), b);
        attn::mma_16816<T>(s[0], a, b[0], b[1]);
        attn::mma_16816<T>(s[1], a, b[2], b[3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) {
        uint32_t b[4];
        attn::ldmatrix_x4(
            ks + attn::swizzle<DP>((k_row * DP + kk * 16 + k_col) * 2), b);
        attn::mma_16816<T>(s[0], qf[kk], b[0], b[1]);
        attn::mma_16816<T>(s[1], qf[kk], b[2], b[3]);
      }
    }
    if constexpr (CAP) {             // every score of the tile, then mask
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = softcap * tanhf(s[n][e] * cap_in);
      }
    }
    if (t0 + TILE > end) {           // the split's last, ragged tile
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (t0 + kw + n * 8 + 2 * t + (e & 1) >= end) s[n][e] = -INFINITY;
        }
      }
    }
    attn::online_softmax(s, o, m, l, unit_log2);

    uint32_t hi[4], lo[4];
    attn::split_pair<T>(s[0][0], s[0][1], hi[0], lo[0]);
    attn::split_pair<T>(s[0][2], s[0][3], hi[1], lo[1]);
    attn::split_pair<T>(s[1][0], s[1][1], hi[2], lo[2]);
    attn::split_pair<T>(s[1][2], s[1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t b[4];
      attn::ldmatrix_x4_trans(
          vs + attn::swizzle<DP>((v_row * DP + np * 16 + v_col) * 2), b);
      attn::mma_16816<T>(o[2 * np], hi, b[0], b[1]);
      attn::mma_16816<T>(o[2 * np], lo, b[0], b[1]);
      attn::mma_16816<T>(o[2 * np + 1], hi, b[2], b[3]);
      attn::mma_16816<T>(o[2 * np + 1], lo, b[2], b[3]);
    }
  }
  attn::cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the merge

  // Merge the warps: each leaves (max, sum, accumulator) for the 16 rows.
  float* m_w = reinterpret_cast<float*>(smem);        // WARPS x 16
  float* l_w = m_w + WARPS * MAX_GROUP;               // WARPS x 16
  float* o_w = l_w + WARPS * MAX_GROUP;               // WARPS x 16 x DP
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    const float lsum = attn::quad_sum(l[r]);
    if (t == 0) {
      m_w[warp * MAX_GROUP + row] = m[r];
      l_w[warp * MAX_GROUP + row] = lsum;
    }
    float* orow = o_w + (warp * MAX_GROUP + row) * DP;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      orow[n * 8 + 2 * t] = o[n][2 * r];
      orow[n * 8 + 2 * t + 1] = o[n][2 * r + 1];
    }
  }
  __syncthreads();
  // m_part holds the max in scaled units (m · unit), as the f32 kernel's
  // does, for the combine kernel; a warp with no valid position (m = -inf)
  // weighs 0. Every split holds a valid position, so the max is finite.
  const int64_t row_base = (bh * n_splits + split) * group;
  for (int e = tid; e < group * DP; e += THREADS) {
    const int row = e / DP;
    const int c = e % DP;
    float big = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) big = fmaxf(big, m_w[w * MAX_GROUP + row]);
    float den = 0.0f;
    float num = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt =
          exp2f((m_w[w * MAX_GROUP + row] - big) * unit_log2);
      den = fmaf(l_w[w * MAX_GROUP + row], wt, den);
      num = fmaf(o_w[(w * MAX_GROUP + row) * DP + c], wt, num);
    }
    if (c < d) acc_part[(row_base + row) * d + c] = num;
    if (c == 0) {
      m_part[row_base + row] = big * unit;
      l_part[row_base + row] = den;
    }
  }
}

}  // namespace tc

// Blocks of (kv head, b, part): out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30) over the splits that hold a valid
// position; 0 where lens[b] is 0. Each thread takes one (query head,
// column) of the part's THREADS, so that a few (b, kv head) pairs over many
// splits (RecurrentGemma's MQA decode: 4 pairs, 32 splits) do not leave a
// few blocks to walk every split for 20 elements each.
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
  for (int e = blockIdx.z * blockDim.x + threadIdx.x; e < group * d;
       e += blockDim.x * gridDim.z) {
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
  float scale, softcap;
  cudaStream_t stream;

  // f32 takes the FMA split kernel, f16 and bf16 the tensor-core one; both
  // leave the same scratch for the one combine kernel.
  template <typename T, int NC, bool CAP>
  cudaError_t run() const {
    const dim3 grid(n_splits, n_kv, b);
    cudaError_t err;
    if constexpr (std::is_same_v<T, float>) {
      constexpr int DP = 16 * NC;
      const size_t smem =
          (2 * TILE * (DP + 1) + group * DP + group * TILE + 3 * group) *
          sizeof(float);
      err = attn::allow_smem(
          reinterpret_cast<const void*>(
              f32fma::decode_split_kernel<T, NC, CAP>),
          smem);
      if (err != cudaSuccess) return err;
      f32fma::decode_split_kernel<T, NC, CAP>
          <<<grid, THREADS, smem, stream>>>(
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), lens, m_part, l_part, acc_part, s,
              d, group, chunk, scale, softcap);
    } else {
      constexpr size_t smem = tc::smem_bytes<NC>();
      err = attn::allow_smem(
          reinterpret_cast<const void*>(tc::decode_split_kernel<T, NC, CAP>),
          smem);
      if (err != cudaSuccess) return err;
      const void* rows[3] = {q, k, v};
      const int vec = attn::copy_width(d, rows, 3);
      tc::decode_split_kernel<T, NC, CAP><<<grid, THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lens, m_part, l_part, acc_part, s, d,
          group, chunk, scale, softcap, vec);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const unsigned parts = (group * d + THREADS - 1) / THREADS;
    decode_combine_kernel<T><<<dim3(n_kv, b, parts), THREADS, 0, stream>>>(
        m_part, l_part, acc_part, lens, static_cast<T*>(out), s, d, group,
        chunk, n_splits);
    return cudaGetLastError();
  }

  template <typename T, int NC>
  cudaError_t operator()() const {
    return softcap > 0.0f ? run<T, NC, true>() : run<T, NC, false>();
  }
};

}  // namespace

// Launches both kernels on `stream` without synchronising; returns
// cudaGetLastError(). q, out (b, n_kv, group, d); k, v (b, n_kv, s, d); all
// contiguous and of one dtype (attn::F32, F16 or BF16); lens (b,) int32 on
// the card; d <= 256, group <= 16; chunk a multiple of 64 with
// n_splits * chunk >= s; softcap 0 means no attention softcap. Scratch,
// f32: m_part and l_part (b, n_kv, n_splits, group), acc_part
// (b, n_kv, n_splits, group, d).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* lens, void* m_part,
                                  void* l_part, void* acc_part, void* out,
                                  int b, int n_kv, int group, int s, int d,
                                  int chunk, int n_splits, float scale,
                                  float softcap, int dtype, void* stream) {
  if (group < 1 || group > MAX_GROUP || chunk % TILE != 0 ||
      static_cast<int64_t>(n_splits) * chunk < s ||
      !(softcap >= 0.0f && softcap < INFINITY)) {
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
                      softcap,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(attn::dispatch(dtype, d, launch));
}
