// Flash attention (prefill) for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point loaded with ctypes (repro_torch/kernels/flash_attn.py).
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::flash_attention_pallas
// (_flash_kernel):
//
//   out[b,h,i,:] = sum_j softmax_j(q[b,h,i,:] . k[b,h,j,:] / sqrt(d)) v[b,h,j,:]
//
// over the keys j <= max(i + off, P - 1) (causal, with a bidirectional
// prefix of P >= 0 positions: the reference's M-RoPE mask, below) and
// j > i + off - window (window > 0), with an online softmax whose row max,
// row sum and accumulator are f32. A row with no valid key writes 0, as the
// TPU kernel's max(l, 1e-30) does. q is (B, H, Sq, d) and k, v (B, H, Sk,
// d), f32, f16 or bf16, d <= 256 (the TPU kernel takes any d and one S);
// the output is in q's type. Neither length need be a multiple of any
// tile: the ragged edges are masked, never padded.
//
// The key length of its own serves the encoder-decoder (SeamlessM4T):
// cross-attention is non-causal with Sq != Sk (the decoder's queries over
// the encoder's frames), the encoder non-causal with Sq = Sk, and
// attention against a KV cache causal with off = Sk - Sq = the cache's
// length before the call, the reference's mask kv_pos <= q_pos for q_pos =
// len + i (repro/models/layers.py::attention). off is a runtime int that
// moves the loop limits and edge masks as P does; with Sq = Sk it is 0 and
// the mask is the one of one S. Each kernel shifts its k and v pointers by
// off rows and then runs in query positions (key j at j - off, j < Sk iff
// j - off < Sq): its loop and masks are those of one S = Sq, and off is
// dead after the first lines. Every way of carrying the second length
// tried (this one; query positions i + off tested against keys; keys
// j - off tested against queries on every tile; the query side kept on
// one base offset) moved the bf16 d = 128 instance from 20 to 68-100
// bytes of spill stores, and none changed the plain causal times beyond
// 1% in turns against the kernel of one S (PERF.md row 3). The entry
// point refuses causal with Sk < Sq, where a row would have no key, and a
// prefix with Sq != Sk.
//
// The prefix P (0 for plain causal attention) is Qwen2-VL's vision block:
// the reference's attention (repro/models/layers.py::attention) masks by
// the temporal position ids, key j valid for query i iff t_j <= t_i, and
// its M-RoPE layout (transformer.py::_build_positions) gives the first P
// positions t = 0 and text position i t = i - P + 1; by index that is
// j <= max(i, P - 1), so the P vision positions attend to each other in
// both directions. P is a runtime int that moves only the causal loop limit
// (max(q0 + BQ, P)) and the edge masks.
//
// With an attention softcap (softcap > 0, Gemma-2's; the TPU kernel has
// none, so this follows the reference's _attn_core in
// repro/models/layers.py), each valid score x = q.k * scale becomes
// softcap * tanh(x / softcap) before the online softmax; a masked score
// stays -inf (softcap * tanh(-inf) would be -softcap, which lets the key
// in). Each kernel is a template on CAP, so without a softcap the
// instructions are those of the kernel before it. The softcap costs a tanhf
// beside each exp2f, twice the special-function work per valid pair.
//
// For training, both routes also write each row's log-sum-exp lse (B, H, Sq)
// f32 = m + log l in natural-log units (-inf for a row with no valid key),
// which the backward (flash_attn_bwd.cu) reads to recompute P; inference
// passes a null pointer and writes none. With a softcap, lse is taken over
// the capped scores, which the backward's CAP instances read.
//
// What bounds it: operations. With each input read once and the output
// written once, the work is 4*d FLOPs per valid (query, key) pair against
// 4*2*d bytes per row of q, k, v and out; at Yi-6B's prefill (d = 128,
// S = 4096, 32 heads, causal) 1.37e11 FLOPs against 134 MB, 0.139 ms at the
// card's 989 TFLOP/s bf16 and 0.040 ms at 3.35 TB/s. Only the tensor cores
// come near that bound.
//
// Two routes, chosen by dtype in flash_attn_launch:
//
// * f16 and bf16: the tensor-core kernel (namespace tc), FlashAttention-2's
//   schedule written with mma.sync:
//   - one block of 8 warps owns BQ = 128 query rows of one (b, h), 16 rows
//     a warp; Q is copied to shared memory once and held in registers as
//     MMA A fragments for the whole key loop;
//   - the key loop runs from the window's lower edge to the causal limit,
//     BK = 64 keys a tile; K and V tiles stay in their 16-bit type in
//     XOR-swizzled shared memory, copied by cp.async (16 bytes a copy, or 8,
//     4 or 2 bytes where rows are not 16-byte aligned, as at d = 100) into a
//     ring of STAGES = 2, so the next tile is in flight while this one is
//     consumed;
//   - S = Q·Kᵀ by mma.sync.m16n8k16 (f32 accumulate; products of 16-bit
//     values are exact in f32), K through ldmatrix; the online softmax runs
//     on the accumulators in registers, row max and row sum by quad
//     shuffles, and masks only the tiles that cross the causal diagonal,
//     the window's edge or the end of the keys;
//   - P·V as two MMAs per fragment, on p_hi = T(p) and p_lo = T(p - p_hi),
//     V through ldmatrix.trans; P goes from the S accumulators to A
//     fragments in registers, never through shared memory. P rounded once
//     to 16 bits, as FlashAttention-2 and SDPA do, misses the port's
//     per-element limit against the f32 plain version (one output ulp) by
//     two orders of magnitude; hi + lo keeps it within (attention.cuh,
//     split_pair; tests/test_torch_attention.py emulates both);
//   - head dims are padded to DP = 16·NC with zeros in shared memory;
//     query tiles are scheduled longest first.
//   - d = 256 (NC = 16, RecurrentGemma's head dim; 129-255 pad to it) has
//     its own tile plan (tc::Plan): the 16 x 256 f32 accumulator alone takes
//     128 registers a lane, so Q is not held as A fragments (64 more) but
//     stays in shared memory, reloaded by ldmatrix at each k-step, 8 k-steps
//     unrolled at once; 4 warps over BQ = 64 query rows and 32-key tiles:
//     32 KiB of Q and 2 stages of 16 + 16 KiB, two blocks per SM. ptxas
//     (CUDA 12.8) gives 254 registers and 8 bytes of spills (all 16 k-steps
//     unrolled spill 16 bytes).
//   At d = 128: 32 KiB of Q and STAGES·2 tiles of 16 KiB = 96 KiB of dynamic
//   shared memory, one block (8 warps) per SM; ptxas (CUDA 12.8) gives 255
//   registers and 72 bytes of spill stores, 80 of loads in bf16 (20 and
//   64 with one S; fewer registers and no spills at d <= 64). On an H100 80GB
//   HBM3 at 700 W it takes 0.88-0.90
//   ms at the prefill shape above, 15-16% of the bound. Variants with 4
//   warps (twice the L2 traffic), 3 stages or 32-key tiles (three blocks
//   per SM) are no faster (scripts/flash_variants.py, PERF.md), so neither
//   L2, copy latency nor occupancy holds it back; what does is not measured
//   (no profiler counters on that machine).
//
// * f32: the FMA kernel of the port's first version (namespace f32fma), kept
//   as it was. Tensor cores take f32 only as TF32, which keeps 10 bits of
//   mantissa: the f32 route's per-element limit (atol 4e-6, rtol 0) rules
//   that out. One block of 256 threads per 64 query rows, four threads per
//   row, K and V tiles widened to f32 in shared memory, scalar fmaf.
//
// What the first version (now the f32 route) measured when it served every
// dtype, on an H100 80GB HBM3 at 700 W, bf16 at the prefill shape above:
// 10.23-10.34 ms, 1.3% of the bound and 20% of the f32 FMA rate, against
// 0.256-0.265 ms for SDPA; its 128 registers spilled 68 bytes.
#include "attention.cuh"

#include <math.h>

namespace {

// The first key a block of queries from q0 attends to, in query positions
// (key j at j - off): the window's lower edge rounded down to a tile of BK
// keys, else key 0. A prefix needs Sq = Sk (off = 0), so with it the
// causal limit max(q0 + BQ, prefix) is the same in both positions.
template <int BK>
__device__ __forceinline__ int key_begin(int q0, int off, int window) {
  return (window > 0 ? max(0, q0 + off - window + 1) / BK * BK : 0) - off;
}

namespace f32fma {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per shared-memory tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 256
constexpr int CHUNK = 16;            // keys per online-softmax step

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int d,
                      float scale, int causal, int window, int prefix,
                      float softcap) {
  constexpr int DP = 16 * NC;        // padded head dim
  const float inv_cap = CAP ? 1.0f / softcap : 0.0f;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // BK x DP
  float* vs = smem + BK * DP;        // BK x DP

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  // This (b, h)'s rows: q, out and lse at its queries; k and v at its
  // keys, shifted by off = Sk - Sq rows, so that row j of them is key
  // j + off and keys run in query positions (j in [-off, Sq)).
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int off = Sk - Sq;
  q += bh * Sq * d;
  out += bh * Sq * d;
  k += (bh * Sk + off) * d;
  v += (bh * Sk + off) * d;
  if (lse != nullptr) lse += bh * Sq;
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
      qr[c * 4 + e] = (qi < Sq && dim < d)
                          ? attn::to_f32(q[static_cast<int64_t>(qi) * d + dim])
                          : 0.0f;
      acc[c * 4 + e] = 0.0f;
    }
  }
  float m = -INFINITY;
  float l = 0.0f;

  const int k_end = causal ? min(Sq, max(q0 + BQ, prefix)) : Sq;
  const int k_begin = key_begin<BK>(q0, off, window);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int key = k0 + idx / DP;
      const int dim = idx % DP;
      const bool ok = key < Sq && dim < d;
      const int64_t at = static_cast<int64_t>(key) * d + dim;
      ks[idx] = ok ? attn::to_f32(k[at]) : 0.0f;
      vs[idx] = ok ? attn::to_f32(v[at]) : 0.0f;
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
        bool valid = key < Sq && qi < Sq;
        if (causal) valid = valid && key <= max(qi, prefix - 1);
        if (window > 0) valid = valid && key > qi - window;
        float x = dot * scale;
        if constexpr (CAP) x = softcap * tanhf(x * inv_cap);
        s[jj] = valid ? x : -INFINITY;
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

  if (qi >= Sq) return;
  if (lse != nullptr && part == 0)   // m is in scaled units here
    lse[qi] = m == -INFINITY ? -INFINITY : m + logf(l);
  const float denom = fmaxf(l, 1e-30f);
  T* o = out + static_cast<int64_t>(qi) * d;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = c * 16 + part * 4 + e;
      if (dim < d) o[dim] = attn::from_f32<T>(acc[c * 4 + e] / denom);
    }
  }
}

}  // namespace f32fma

namespace tc {

// The tile plan of d <= 128 (NC <= 8; the constants that
// scripts/flash_variants.py varies): 8 warps of 16 query rows, BQ = 128, Q
// held in registers as A fragments for the whole key loop, 64-key tiles in
// a ring of 2, one block per SM.
constexpr int WARPS = 8;
constexpr int STAGES = 2;
constexpr int MIN_BLOCKS = 1;
constexpr int BK = 64;

// d = 256 (NC = 16, WIDE): the O accumulator alone takes 128 registers a
// thread, so Q stays in shared memory and each k-step reloads its A
// fragment by ldmatrix (FlashAttention-2's choice at d = 256); 4 warps,
// BQ = 64, 32-key tiles, so that Q (32 KiB) and two stages of K and V
// (64 KiB) fit twice on an SM.
// d = 256: the k-steps of Q.K^T unrolled at once. All 16 let ptxas hoist
// the fragment loads of every step and spill (16-20 bytes at 255
// registers); 8 spills none, and of 16, 8, 4, 2 and 1 it was the fastest
// flash at RecurrentGemma's prefill layer (H100 80GB HBM3, 700 W).
constexpr int WIDE_KK_UNROLL = 8;

template <int NC>
struct Plan {
  static constexpr bool WIDE = NC > 8;
  static constexpr int WARPS = WIDE ? 4 : tc::WARPS;
  static constexpr int BQ = 16 * WARPS;          // query rows per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = WIDE ? 32 : tc::BK;  // keys per tile
  static constexpr int STAGES = tc::STAGES;      // K/V tiles in the ring
  static constexpr int MIN_BLOCKS = WIDE ? 2 : tc::MIN_BLOCKS;  // per SM
  // Q, then K, V per stage.
  static constexpr int SMEM = (BQ + 2 * STAGES * BK) * 16 * NC * 2;
};

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(Plan<NC>::THREADS, Plan<NC>::MIN_BLOCKS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int d,
                      float scale, int causal, int window, int prefix,
                      float softcap, int vec) {
  using P = Plan<NC>;
  constexpr int BQ = P::BQ, BK = P::BK, STAGES = P::STAGES;
  constexpr int THREADS = P::THREADS;
  constexpr int DP = 16 * NC;        // padded head dim
  constexpr int QB = BQ * DP * 2;    // bytes of the Q tile
  constexpr int TILE = BK * DP * 2;  // bytes of a K or V tile
  constexpr int NO = DP / 8;         // output n-tiles (8 dims each)
  extern __shared__ __align__(1024) char smem[];

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  // This (b, h)'s rows: q, out and lse at its queries; k and v at its
  // keys, shifted by off = Sk - Sq rows, so that row j of them is key
  // j + off and keys run in query positions (j in [-off, Sq)).
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int off = Sk - Sq;
  q += bh * Sq * d;
  out += bh * Sq * d;
  k += (bh * Sk + off) * d;
  v += (bh * Sk + off) * d;
  if (lse != nullptr) lse += bh * Sq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Scores stay in raw q.k units, scale folded into exp2 and lse; with
  // the softcap they are softcapped scores, already in scaled units.
  const float unit = CAP ? 1.0f : scale;
  const float unit_log2 = unit * 1.4426950408889634f;
  const float cap_in = CAP ? scale / softcap : 0.0f;

  const int k_end = causal ? min(Sq, max(q0 + BQ, prefix)) : Sq;
  const int k_begin = key_begin<BK>(q0, off, window);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;   // >= 1

  auto stage = [&](int it) { return smem + QB + 2 * TILE * (it % STAGES); };
  auto load_kv = [&](int it) {
    const int k0 = k_begin + it * BK;
    const int64_t at = static_cast<int64_t>(k0) * d;
    attn::load_tile<T, BK, DP, THREADS>(stage(it), k + at, Sq - k0, d, vec,
                                        tid);
    attn::load_tile<T, BK, DP, THREADS>(stage(it) + TILE, v + at, Sq - k0, d,
                                        vec, tid);
  };
  attn::load_tile<T, BQ, DP, THREADS>(
      smem, q + static_cast<int64_t>(q0) * d, Sq - q0, d, vec, tid);
  load_kv(0);
  attn::cp_async_commit();
#pragma unroll
  for (int it = 1; it < STAGES - 1; ++it) {
    if (it < n_tiles) load_kv(it);
    attn::cp_async_commit();
  }

  // Per-lane ldmatrix offsets: A (Q) rows lane % 16, column half lane / 16;
  // B (K) rows lane % 8 + 8 * (lane / 16), column half (lane / 8) % 2;
  // B (V, transposed) rows lane % 8 + 8 * ((lane / 8) % 2), column half
  // lane / 16.
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0 + 8
  const uint32_t qs = attn::smem_addr(smem);

  uint32_t qf[P::WIDE ? 1 : NC][4];  // Q's A fragments (d <= 128 only)
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    attn::cp_async_wait<STAGES - 2>();
    __syncthreads();                 // tile it landed; tile it - 1 consumed
    if constexpr (!P::WIDE) {
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

    const int k0 = k_begin + it * BK;
    const uint32_t ks = attn::smem_addr(stage(it));
    const uint32_t vs = ks + TILE;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    if constexpr (P::WIDE) {
#pragma unroll(WIDE_KK_UNROLL)
      for (int kk = 0; kk < NC; ++kk) {
        uint32_t a[4];                 // Q's fragment for this k-step
        attn::ldmatrix_x4(
            qs + attn::swizzle<DP>((a_row * DP + kk * 16 + a_col) * 2), a);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4];
          attn::ldmatrix_x4(
              ks + attn::swizzle<DP>(((np * 16 + k_row) * DP + kk * 16 + k_col) * 2),
              b);
          attn::mma_16816<T>(s[2 * np], a, b[0], b[1]);
          attn::mma_16816<T>(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4];
          attn::ldmatrix_x4(
              ks + attn::swizzle<DP>(((np * 16 + k_row) * DP + kk * 16 + k_col) * 2),
              b);
          attn::mma_16816<T>(s[2 * np], qf[kk], b[0], b[1]);
          attn::mma_16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }
    }

    if constexpr (CAP) {             // every score of the tile, then mask
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = softcap * tanhf(s[n][e] * cap_in);
      }
    }
    // Masks, only on tiles that cross the causal diagonal (the prefix's
    // keys are valid for every query), the window's lower edge or the end
    // of the keys (query position Sq, key Sk).
    const bool edge = (causal && k0 + BK - 1 > max(q0, prefix - 1)) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window) ||
                      k0 + BK > Sq;
    if (edge) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          bool valid = key < Sq;
          if (causal) valid = valid && key <= max(row, prefix - 1);
          if (window > 0) valid = valid && key > row - window;
          if (!valid) s[n][e] = -INFINITY;
        }
      }
    }
    attn::online_softmax(s, o, m, l, unit_log2);

    // O += P·V, P split into hi and lo, 16 keys per MMA step.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      attn::split_pair<T>(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      attn::split_pair<T>(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      attn::split_pair<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      attn::split_pair<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        attn::ldmatrix_x4_trans(
            vs + attn::swizzle<DP>(((kk * 16 + v_row) * DP + np * 16 + v_col) * 2),
            b);
        attn::mma_16816<T>(o[2 * np], hi, b[0], b[1]);
        attn::mma_16816<T>(o[2 * np], lo, b[0], b[1]);
        attn::mma_16816<T>(o[2 * np + 1], hi, b[2], b[3]);
        attn::mma_16816<T>(o[2 * np + 1], lo, b[2], b[3]);
      }
    }
  }
  attn::cp_async_wait<0>();          // no copy outlives the block

  const bool pairs =
      d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l_row = attn::quad_sum(l[r]);
    const float inv_l = 1.0f / fmaxf(l_row, 1e-30f);
    if (row >= Sq) continue;
    if (lse != nullptr && t == 0)    // m · unit is in scaled units
      lse[row] =
          m[r] == -INFINITY ? -INFINITY : fmaf(m[r], unit, logf(l_row));
    T* o_row = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      const float x0 = o[n][2 * r] * inv_l, x1 = o[n][2 * r + 1] * inv_l;
      if (pairs && c + 1 < d) {
        *reinterpret_cast<uint32_t*>(o_row + c) = attn::pack_pair<T>(x0, x1);
      } else {
        if (c < d) o_row[c] = attn::from_f32<T>(x0);
        if (c + 1 < d) o_row[c + 1] = attn::from_f32<T>(x1);
      }
    }
  }
}

}  // namespace tc

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int b, h, sq, sk, d, causal, window, prefix;
  float scale, softcap;
  cudaStream_t stream;

  // f32 takes the FMA kernel, f16 and bf16 the tensor-core kernel.
  template <typename T, int NC, bool CAP>
  cudaError_t run() const {
    if constexpr (std::is_same_v<T, float>) {
      const size_t smem = 2 * f32fma::BK * 16 * NC * sizeof(float);
      cudaError_t err = attn::allow_smem(
          reinterpret_cast<const void*>(f32fma::flash_attn_kernel<T, NC, CAP>),
          smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sq + f32fma::BQ - 1) / f32fma::BQ, h, b);
      f32fma::flash_attn_kernel<T, NC, CAP>
          <<<grid, f32fma::THREADS, smem, stream>>>(
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk,
              d, scale, causal, window, prefix, softcap);
    } else {
      using P = tc::Plan<NC>;
      constexpr size_t smem = P::SMEM;
      cudaError_t err = attn::allow_smem(
          reinterpret_cast<const void*>(tc::flash_attn_kernel<T, NC, CAP>),
          smem);
      if (err != cudaSuccess) return err;
      const void* rows[3] = {q, k, v};
      const int vec = attn::copy_width(d, rows, 3);
      const dim3 grid((sq + P::BQ - 1) / P::BQ, h, b);
      tc::flash_attn_kernel<T, NC, CAP><<<grid, P::THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, d,
          scale, causal, window, prefix, softcap, vec);
    }
    return cudaGetLastError();
  }

  template <typename T, int NC>
  cudaError_t operator()() const {
    return softcap > 0.0f ? run<T, NC, true>() : run<T, NC, false>();
  }
};

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// q, out (b, h, sq, d) and k, v (b, h, sk, d) contiguous, all of one dtype
// (attn::F32, F16 or BF16); lse (b, h, sq) f32, or null to write none;
// d <= 256. With off = sk - sq, key j is valid for query i iff j <=
// max(i + off, prefix - 1) (causal; prefix 0 is plain causal attention)
// and j > i + off - window (window > 0; 0 means no sliding window);
// softcap 0 means no attention softcap. Refused (cudaErrorInvalidValue):
// causal with sk < sq, where a row would have no key, and a prefix with
// sq != sk.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int b, int h, int sq,
                                 int sk, int d, int causal, int window,
                                 int prefix, float scale, float softcap,
                                 int dtype, void* stream) {
  if (!(softcap >= 0.0f && softcap < INFINITY) || prefix < 0 || sk < 1 ||
      (causal && sk < sq) || (prefix > 0 && sq != sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch launch{q,      k,      v,      out,    lse,
                      b,      h,      sq,     sk,     d,
                      causal, window, prefix, scale,  softcap,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(attn::dispatch(dtype, d, launch));
}
