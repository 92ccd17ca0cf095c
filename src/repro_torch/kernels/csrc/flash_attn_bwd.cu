// Flash-attention backward for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point loaded with ctypes (repro_torch/kernels/flash_attn.py,
// `flash_attention_bwd_cuda`, called by `FlashAttention.backward`).
//
// Replaces the gradient the JAX package takes by XLA's autodiff of the jnp
// attention core (repro/models/layers.py::_attn_core); the TPU package has
// no Pallas backward. It differentiates what flash_attn.cu computes, under
// the same causal, prefix and window masks (with off = Sk - Sq and causal,
// key j is valid for query i iff j <= max(i + off, P - 1), P the
// bidirectional prefix, 0 for plain causal attention; with a window w,
// iff also j > i + off - w), for q, out, dout (B, H, Sq, d) and k, v (B,
// H, Sk, d) of one type (f32, f16 or bf16), d <= 256
// (attn::MAX_BWD_HEAD_DIM), and the forward's row log-sum-exp lse (B, H,
// Sq) f32, in natural-log units:
//
//   D_i   = sum_d dO_i . O_i                       (pre-pass, f32)
//   P_ij  = exp(s q_i . k_j - lse_i)               (recomputed, never stored)
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dV_j  = sum_i P_ij dO_i,  dK_j = s sum_i dS_ij q_i,  dQ_i = s sum_j dS_ij k_j
//
// with s = 1/sqrt(d). Sums run in f32; dQ, dK, dV are written in q's type.
// A row whose lse is -inf (no valid key) contributes nothing.
//
// With an attention softcap c > 0 (Gemma-2's; the forward's CAP instances,
// flash_attn.cu), each valid score x_ij = s q_i . k_j became c t_ij with
// t_ij = tanh(x_ij / c) before the softmax, and lse is taken over the
// capped scores. Then
//
//   P_ij  = exp(c t_ij - lse_i),
//   dS_ij = P_ij (dO_i . v_j - D_i) (1 - t_ij^2)    (d(c tanh(x/c))/dx)
//
// and dK, dQ as above from this dS. D needs no change: sum_j P_ij dP_ij =
// dO_i . O_i for any scores, so delta_kernel is shared. The dK/dV and dQ
// kernels of both routes are templates on CAP, as the forward's are, so
// the instances without the softcap are the code they were (the same
// registers and spills); t is recomputed where P is, from the raw q.k,
// before the mask, on every tile. The tensor-core route keeps raw q.k
// and folds s into exp2; its CAP instances take unit 1 (the capped score
// is already in scaled units), as the forward's do.
//
// What bounds it: operations. The work is 10*d FLOPs per valid (query, key)
// pair (q.k, dO.v, dV, dK, dQ: 2*d each), against 8 rows of d in (q, k, v,
// out, dout) and 3 out (dq, dk, dv); at the training shape (4, 32, 512, 128)
// causal 2.15e10 FLOPs, 0.0218 ms at the card's 989 TFLOP/s bf16, and at
// Yi-6B's prefill (1, 32, 4096, 128) 3.44e11 FLOPs, 0.347 ms. Only the
// tensor cores come near that bound.
//
// The key length of its own (the encoder-decoder's cross-attention, its
// encoder and attention against a KV cache; flash_attn.cu says which is
// which): the D pre-pass runs over the Sq query rows, the dQ kernels' key
// loops run as the forward's, and the dK/dV kernels own Sk keys, each
// walking the query tiles from the first query the causal edge lets see
// its key block (i >= k0 - off) to the window's far edge. off is computed
// in each kernel from Sq and Sk, which shifts its k, v (and dk, dv)
// pointers by off rows and then runs in query positions (key j at j - off):
// its loops and masks are those of one S = Sq, as in flash_attn.cu.
//
// Every route is deterministic: no atomics, every sum in a fixed order, and
// each kernel owns the output rows it writes. Three kernels, launched in
// order on one stream: delta_kernel (D, one warp per row), a dK/dV kernel
// whose blocks own keys and walk the queries that see them, and a dQ kernel
// whose blocks own queries and walk their keys; both recompute P. Two
// routes, chosen by dtype in flash_attn_bwd_launch:
//
// * f16 and bf16: the tensor-core kernels (namespace tc), written with
//   mma.sync.m16n8k16 (f32 accumulate) from attention.cuh's pieces, as the
//   forward's tensor-core route is:
//   - dkdv_kernel: one block of 4 warps owns ROWS = 64 keys of one (b, h),
//     16 a warp; its K and V tiles are copied once into XOR-swizzled 16-bit
//     shared memory. It walks the query tiles that see those keys (from the
//     tile's first key under the causal mask to its last key plus the
//     window), TILE = 64 rows of Q and dO with their lse and D copied by
//     cp.async into a ring of STAGES = 2, and takes each tile in CHUNK = 32
//     query passes: S^T = K.Q^T and dP^T = V.dO^T by MMA (K, V as A
//     through ldmatrix, Q, dO as B), so that each lane's accumulators hold
//     P^T = exp2(S^T s log2e - lse_i log2e) and dS^T = P^T (dP^T - D_i) for
//     its keys; then dV += P^T.dO and dK += dS^T.Q, P^T and dS^T going from
//     the accumulators to A fragments in registers, dO and Q as B through
//     ldmatrix.trans. dK and dV stay in f32 registers for the whole walk.
//   - dq_kernel: one block of 4 warps owns 64 queries, 16 a warp, Q and dO
//     held in registers as A fragments, lse and D per row; the key loop
//     takes TILE = 64 keys of K and V a step through the same ring, in
//     CHUNK = 32 key passes: S = Q.K^T and dP = dO.V^T, then P and dS, and
//     dQ += dS.K with K through ldmatrix.trans.
//   - P and dS enter their products as hi + lo pairs (attention.cuh,
//     split_pair), two MMAs each: rounded once to 16 bits they miss the
//     port's per-element limit against the f32 plain version (one output
//     ulp, BWD_TOL) by 10-30x in bf16 and 2-5x in f16, where the split
//     meets it (tests/test_torch_attention.py emulates both). The tensor
//     cores so do 20*d FLOPs a valid pair: q.k and dO.v in both kernels,
//     and dV, dK, dQ twice each.
//   - Only the tiles that cross the causal diagonal, the window's edge or
//     the end of S are masked, and a warp skips a pass in which none of its
//     pairs is valid. Rows past S are copied as zeros; their lse and D are
//     never read for a valid pair. Head dims d <= 128 are padded to
//     DP = 16*NC with zeros in shared memory. Both kernels schedule their
//     longest tiles first.
//   - The prefix P moves only loop limits and edge masks: the dQ kernel's
//     keys run to max(q0 + 64, P), a key tile below P walks the queries
//     from 0, and a tile is masked where it crosses max(i, P - 1). The
//     dK/dV kernel, whose keys a lane holds are fixed, tests each key
//     against P where it tests `causal`.
//   - Registers: at d = 128 a warp's 16 keys hold 2 x 64 f32 of dK and dV
//     a lane, so K and V are read from shared memory by ldmatrix at each
//     pass, not held as fragments, and a pass takes 32 queries (S^T and
//     dP^T, 2 x 16 f32 a lane). ptxas (CUDA 12.8), registers for NC = 1,
//     2, 4, 8 in bf16 with one S: dq_kernel 96, 122, 172, 238, no spills;
//     dkdv_kernel 115, 128, 178, 255, with 56 bytes of spill stores and 92
//     of loads at NC = 8 (52 and 88 in f16; 44 and 80 in bf16 before the
//     prefix; with a key length of its own: dq 237, dkdv 52 and 60). At
//     d = 128 a block takes 97 KiB of shared memory (dQ 96), two blocks
//     (8 warps) per SM.
//   On an H100 80GB HBM3 at 700 W (scripts/flash_bwd_variants.py) it takes
//   0.297 ms at the training shape above and 2.73-2.75 ms at the prefill
//   shape, of which dK/dV 1.55 and dQ 1.14 ms: about 265 and 240 TFLOP/s
//   of MMA work, the forward's mma.sync rate. Passes of 16 rows (no
//   spills) or 64 (more), or 8 warps over 128-row tiles, are within 5%.
//   This design is mma.sync's; wgmma with a TMA producer warp is later work.
//   - d = 256 (NC = 16, RecurrentGemma's head dim; 129-255 pad to it) has
//     its own tile plan (tc::Plan). A warp's 16 keys would hold 2 x 128 f32
//     of dK and dV a lane, with 255 registers in all, so the dK/dV kernel
//     splits the head dim: each block owns 64 keys and one half (128 dims)
//     of their dK and dV, the grid twice as long along x, and recomputes
//     S^T and dP^T over the whole d for each half (q.k and dO.v twice).
//     This was chosen over splitting by output (one warp group on dV,
//     another on dK, P^T and dS^T through shared memory) because it keeps
//     the d <= 128 kernel's code, register profile and synchronisation
//     as they are: the accumulators are those of d = 128, only the S^T
//     k-loop is longer (8 k-steps unrolled at once, as the forward's
//     WIDE_KK_UNROLL). The dQ kernel keeps its 16 x 256 f32 accumulator
//     (128 registers) and reloads Q's and dO's A fragments from shared
//     memory at each k-step, as the d = 256 forward does. Both keep
//     TILE = 64 and two stages: 193 and 192 KiB of shared memory, one
//     block (4 warps) per SM. The hi + lo split, the fixed order of sums
//     and the absence of atomics are those of d <= 128. ptxas (CUDA 12.8):
//     dkdv_kernel 255 registers, no spills in bf16 (96 bytes of spill
//     stores and 668 of loads in f16, which no main path runs); dq_kernel
//     255, 24 bytes of spill stores (40 with the cap; 100 and 144 with a
//     key length of its own). On an
//     H100 80GB HBM3 at 700 W it takes 2.47-2.53 ms at RecurrentGemma's
//     training layer (1, 10, 4096, 256), window 2048, 6.4% of its 0.163 ms
//     bound (PERF.md row 3b).
//   The CAP instances (ptxas, CUDA 12.8) keep dq_kernel's registers within
//   +24 (244 at NC = 8, no spills) and dkdv_kernel's at 255 with 64 bytes
//   of spill stores and 100 of loads at NC = 8. On an H100 80GB HBM3 at
//   700 W the bf16 backward takes 0.34-0.38 ms with Gemma-2's cap at the
//   training shape above, 0.29-0.31 without (scripts/flash_causal_time.py,
//   chip_smoke.py timing).
//
// * f32: the FMA kernels of the first version (namespace f32fma), kept as
//   they were. Tensor cores take f32 only as TF32, which keeps 10 bits of
//   mantissa: the f32 limit (rtol 0, atol 2e-5 of the largest gradient)
//   rules that out. One block owns 32 keys (dK/dV) or 32 queries (dQ),
//   eight threads a row, the streamed operand widened to f32 in shared
//   memory 32 rows a step, scalar fmaf; it recomputes q.k and dO.v in both
//   kernels, 14*d FLOPs a pair, bounded at 0.32 ms and 5.1 ms at those
//   shapes by the 67 TFLOP/s FMA rate. On an H100 80GB HBM3 at 700 W it
//   took 1.9660 and 26.6042 ms there in bf16, when it served every dtype.
#include "attention.cuh"

#include <math.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// The first key a block of queries from q0 attends to, in query positions
// (key j at j - off): the window's lower edge rounded down to a tile of
// TILE keys, else key 0. A prefix needs Sq = Sk (off = 0), so with it the
// causal limit max(q0 + rows, prefix) is the same in both positions.
template <int TILE>
__device__ __forceinline__ int key_begin(int q0, int off, int window) {
  return (window > 0 ? max(0, q0 + off - window + 1) / TILE * TILE : 0) -
         off;
}

// Whether query qi attends to key kj under the masks, kj in query
// positions (key - off, off = Sk - Sq): the masks of one S = Sq, in which
// kj < Sq iff the key is below Sk.
__device__ __forceinline__ bool valid_pair(int qi, int kj, int S, int causal,
                                           int window, int prefix) {
  bool ok = qi < S && kj < S;
  if (causal) ok = ok && kj <= max(qi, prefix - 1);
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
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

namespace f32fma {


constexpr int TPR = 8;                 // threads per owned row
constexpr int ROWS = 32;               // rows (keys or queries) a block owns
constexpr int THREADS = ROWS * TPR;    // 256
constexpr int TILE = 32;               // rows of the streamed operand a step

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

// t = tanh(x / c) for the raw dot product q.k, x = q.k * scale, as the
// forward's f32 kernel takes it.
__device__ __forceinline__ float capped_tanh(float dot, float scale,
                                             float softcap) {
  return tanhf(dot * scale * (1.0f / softcap));
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

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Sk, int d, float scale,
                int causal, int window, int prefix, float softcap) {
  constexpr int NCH = nch<NC>();
  constexpr int DP = 32 * NCH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // TILE x DP
  float* gs = qs + TILE * DP;          // TILE x DP (dO)
  float* ls = gs + TILE * DP;          // TILE: lse_i * log2(e)
  float* ds = ls + TILE;               // TILE: D_i

  // This (b, h)'s rows: q, dout, lse, delta at its queries; k, v, dk, dv
  // at its keys, shifted by off = Sk - Sq rows, so that keys run in query
  // positions (row j is key j + off; j < Sq iff the key is below Sk).
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int off = Sk - Sq;
  q += bh * Sq * d;
  dout += bh * Sq * d;
  lse += bh * Sq;
  delta += bh * Sq;
  k += (bh * Sk + off) * d;
  v += (bh * Sk + off) * d;
  dk += (bh * Sk + off) * d;
  dv += (bh * Sk + off) * d;
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int k0 = static_cast<int>(blockIdx.x) * ROWS - off;
  const int kj = k0 + tid / TPR;

  float kr[NCH * 4], vr[NCH * 4], dka[NCH * 4], dva[NCH * 4];
  load_row<T, NCH>(kr, k, kj, Sq, d, part);
  load_row<T, NCH>(vr, v, kj, Sq, d, part);
#pragma unroll
  for (int e = 0; e < NCH * 4; ++e) dka[e] = dva[e] = 0.0f;

  const float scale_log2 = scale * LOG2E;
  // A key below the prefix is seen by every query; under the causal mask
  // key k0 (a query position, maybe below 0) is first seen by query k0.
  const int i_begin =
      (causal && k0 >= prefix ? max(0, k0) : 0) / TILE * TILE;
  const int i_end = window > 0 ? min(Sq, k0 + ROWS - 1 + window) : Sq;
  for (int i0 = i_begin; i0 < i_end; i0 += TILE) {
    __syncthreads();                   // the previous tile is consumed
    load_tiles<T, DP>(qs, gs, q, dout, i0, Sq, d, tid);
    if (tid < TILE) {
      const int qi = i0 + tid;
      ls[tid] = qi < Sq ? lse[qi] * LOG2E : -INFINITY;
      ds[tid] = qi < Sq ? delta[qi] : 0.0f;
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
      const bool ok = valid_pair(i0 + ii, kj, Sq, causal, window, prefix) &&
                      lse2 != -INFINITY;
      float p, dsv;
      if constexpr (CAP) {
        const float th = capped_tanh(dot, scale, softcap);
        p = ok ? exp2f(fmaf(softcap * th, LOG2E, -lse2)) : 0.0f;
        dsv = p * (dpv - ds[ii]) * fmaf(-th, th, 1.0f);
      } else {
        p = ok ? exp2f(fmaf(dot, scale_log2, -lse2)) : 0.0f;
        dsv = p * (dpv - ds[ii]);
      }
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
  store_row<T, NCH>(dk, dka, scale, kj, Sq, d, part);
  store_row<T, NCH>(dv, dva, 1.0f, kj, Sq, d, part);
}

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, int d, float scale,
              int causal, int window, int prefix, float softcap) {
  constexpr int NCH = nch<NC>();
  constexpr int DP = 32 * NCH;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // TILE x DP
  float* vs = ks + TILE * DP;          // TILE x DP

  // This (b, h)'s rows: q, dout, dq, lse, delta at its queries; k, v at
  // its keys, shifted by off = Sk - Sq rows (keys in query positions).
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int off = Sk - Sq;
  q += bh * Sq * d;
  dout += bh * Sq * d;
  dq += bh * Sq * d;
  lse += bh * Sq;
  delta += bh * Sq;
  k += (bh * Sk + off) * d;
  v += (bh * Sk + off) * d;
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int n_qt = (Sq + ROWS - 1) / ROWS;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * ROWS;
  const int qi = q0 + tid / TPR;

  float qr[NCH * 4], gr[NCH * 4], dqa[NCH * 4];
  load_row<T, NCH>(qr, q, qi, Sq, d, part);
  load_row<T, NCH>(gr, dout, qi, Sq, d, part);
#pragma unroll
  for (int e = 0; e < NCH * 4; ++e) dqa[e] = 0.0f;
  const float lse2 = qi < Sq ? lse[qi] * LOG2E : -INFINITY;
  const float di = qi < Sq ? delta[qi] : 0.0f;

  const float scale_log2 = scale * LOG2E;
  const int k_end = causal ? min(Sq, max(q0 + ROWS, prefix)) : Sq;
  const int k_begin = key_begin<TILE>(q0, off, window);
  for (int k0 = k_begin; k0 < k_end; k0 += TILE) {
    __syncthreads();                   // the previous tile is consumed
    load_tiles<T, DP>(ks, vs, k, v, k0, Sq, d, tid);
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
      const bool ok = valid_pair(qi, k0 + jj, Sq, causal, window, prefix) &&
                      lse2 != -INFINITY;
      float p, dsv;
      if constexpr (CAP) {
        const float th = capped_tanh(dot, scale, softcap);
        p = ok ? exp2f(fmaf(softcap * th, LOG2E, -lse2)) : 0.0f;
        dsv = p * (dpv - di) * fmaf(-th, th, 1.0f);
      } else {
        p = ok ? exp2f(fmaf(dot, scale_log2, -lse2)) : 0.0f;
        dsv = p * (dpv - di);
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        dqa[c * 4 + 0] = fmaf(dsv, kv[c].x, dqa[c * 4 + 0]);
        dqa[c * 4 + 1] = fmaf(dsv, kv[c].y, dqa[c * 4 + 1]);
        dqa[c * 4 + 2] = fmaf(dsv, kv[c].z, dqa[c * 4 + 2]);
        dqa[c * 4 + 3] = fmaf(dsv, kv[c].w, dqa[c * 4 + 3]);
      }
    }
  }
  store_row<T, NCH>(dq, dqa, scale, qi, Sq, d, part);
}

}  // namespace f32fma

namespace tc {

constexpr int WARPS = 4;               // of 16 owned rows each
constexpr int ROWS = 16 * WARPS;       // keys (dK/dV) or queries (dQ) a block owns
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 64;               // streamed rows a ring stage holds
constexpr int CHUNK = 32;              // streamed rows a register pass takes
constexpr int STAGES = 2;
constexpr int MIN_BLOCKS = 2;          // per SM, for the register budget
// d = 256: the k-steps of S^T = K.Q^T (dK/dV) and S = Q.K^T (dQ) unrolled
// at once, as the forward's WIDE_KK_UNROLL.
constexpr int WIDE_KK_UNROLL = 8;

// The tile plan by head-dim chunks NC: d <= 128 as above; d = 256 (WIDE)
// splits dK and dV into HALVES dim halves, one a block (the grid's x runs
// over key tiles times halves), and reloads the dQ kernel's A fragments
// from shared memory at each k-step.
template <int NC>
struct Plan {
  static constexpr bool WIDE = NC > 8;
  static constexpr int HALVES = WIDE ? 2 : 1;
  static constexpr int NO_KV = 2 * NC / HALVES;   // n-tiles of dK, dV a block
  static constexpr int KK_UNROLL = WIDE ? WIDE_KK_UNROLL : NC;
};

// Dynamic shared memory: two tiles of the owned rows (K and V, or Q and
// dO), then per stage two streamed tiles and, for dK/dV, TILE floats each
// of lse and D. Every tile starts at a multiple of 1024 bytes.
template <int NC>
__host__ __device__ constexpr int smem_bytes(bool with_rows) {
  return (2 * ROWS + STAGES * 2 * TILE) * 16 * NC * 2 +
         (with_rows ? STAGES * 2 * TILE * 4 : 0);
}

// Whether any (query, key) pair with query in [q_lo, q_hi] and key in
// [k_lo, k_hi] is valid, keys in query positions as in valid_pair.
__device__ __forceinline__ bool any_valid(int q_lo, int q_hi, int k_lo,
                                          int k_hi, int S, int causal,
                                          int window, int prefix) {
  bool ok = q_lo < S && k_lo < S;
  if (causal) ok = ok && k_lo <= max(q_hi, prefix - 1);
  if (window > 0) ok = ok && k_hi > q_lo - window;
  return ok;
}

// lse in log2 units for exp2, +inf for a row with no valid key (P = 0).
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * LOG2E;
}

// Writes rows [r0, r0 + 16) of the warp's f32 accumulator `acc` (NO
// n-tiles of 8 dims, from dim col0) times `mul` to the (S, d) matrix at
// `dst`, in pairs where rows and the pointer allow.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&acc)[NO][4],
                                           float mul, int r0, int S, int d,
                                           int lane, int col0 = 0) {
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(dst) % 4 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    T* out = dst + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = col0 + n * 8 + 2 * t;
      const float x0 = acc[n][2 * r] * mul, x1 = acc[n][2 * r + 1] * mul;
      if (pairs && c + 1 < d) {
        *reinterpret_cast<uint32_t*>(out + c) = attn::pack_pair<T>(x0, x1);
      } else {
        if (c < d) out[c] = attn::from_f32<T>(x0);
        if (c + 1 < d) out[c + 1] = attn::from_f32<T>(x1);
      }
    }
  }
}

// acc[2np], acc[2np + 1] += (hi + lo) . B for the 16x16 A fragment pair
// (hi, lo) and the 16 x (8 NO) columns from col0 of the 16 x DP matrix at
// `b` (rows of k, swizzled, `row0` its first row), B through
// ldmatrix.trans: the product of a split P or dS with dO, Q or K.
template <typename T, int DP, int NO = DP / 8>
__device__ __forceinline__ void mma_split_rows(float (&acc)[NO][4],
                                               const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               uint32_t b, int row0,
                                               int lane, int col0 = 0) {
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < NO / 2; ++np) {
    uint32_t f[4];
    attn::ldmatrix_x4_trans(
        b + attn::swizzle<DP>(((row0 + v_row) * DP + col0 + np * 16 + v_col) *
                              2),
        f);
    attn::mma_16816<T>(acc[2 * np], hi, f[0], f[1]);
    attn::mma_16816<T>(acc[2 * np], lo, f[0], f[1]);
    attn::mma_16816<T>(acc[2 * np + 1], hi, f[2], f[3]);
    attn::mma_16816<T>(acc[2 * np + 1], lo, f[2], f[3]);
  }
}

// The A fragment pair of k-step kk of a 16 x CHUNK accumulator `x`, split.
template <typename T>
__device__ __forceinline__ void split_fragment(const float (&x)[CHUNK / 8][4],
                                               int kk, uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  attn::split_pair<T>(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  attn::split_pair<T>(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  attn::split_pair<T>(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  attn::split_pair<T>(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Sk, int d, float scale,
                int causal, int window, int prefix, float softcap,
                int vec) {
  using P = Plan<NC>;
  constexpr int DP = 16 * NC;
  constexpr int TB = TILE * DP * 2;    // bytes of a tile
  constexpr int NO = P::NO_KV;         // n-tiles of dK, dV this block owns
  static_assert(ROWS == TILE, "key tiles align with query tiles");
  extern __shared__ __align__(1024) char smem[];
  char* stages = smem + 2 * TB;        // K, V, then per stage Q, dO
  float* rows = reinterpret_cast<float*>(stages + STAGES * 2 * TB);

  // This (b, h)'s rows: q, dout, lse, delta at its queries; k, v, dk, dv
  // at its keys, shifted by off = Sk - Sq rows (keys in query positions).
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int off = Sk - Sq;
  q += bh * Sq * d;
  dout += bh * Sq * d;
  lse += bh * Sq;
  delta += bh * Sq;
  k += (bh * Sk + off) * d;
  v += (bh * Sk + off) * d;
  dk += (bh * Sk + off) * d;
  dv += (bh * Sk + off) * d;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // Longest first: tile 0 sees most. With WIDE, blocks 2t and 2t + 1 own
  // the dim halves of key tile t.
  // This block's first key in query positions (maybe below 0).
  const int k0 = static_cast<int>(blockIdx.x / P::HALVES) * ROWS - off;
  const int dim0 = static_cast<int>(blockIdx.x % P::HALVES) * 8 * NO;
  const int kw = k0 + warp * 16;       // this warp's first key

  // A key tile below the prefix is seen by every query; under the causal
  // mask key k0 is first seen by query k0.
  const int i_begin = causal && k0 >= prefix ? max(0, k0) : 0;
  const int i_end = window > 0 ? min(Sq, k0 + ROWS - 1 + window) : Sq;
  const int n_tiles = max(0, (i_end - i_begin + TILE - 1) / TILE);

  auto load_qdo = [&](int it) {
    const int i0 = i_begin + it * TILE;
    char* st = stages + 2 * TB * (it % STAGES);
    const int64_t at = static_cast<int64_t>(i0) * d;
    attn::load_tile<T, TILE, DP, THREADS>(st, q + at, Sq - i0, d, vec, tid);
    attn::load_tile<T, TILE, DP, THREADS>(st + TB, dout + at, Sq - i0, d,
                                          vec, tid);
    float* r = rows + 2 * TILE * (it % STAGES);    // lse, then D
    const int i = tid % TILE;
    const bool ok = i0 + i < Sq;
    const float* src = (tid < TILE ? lse : delta) + (ok ? i0 + i : 0);
    attn::cp_async<4>(attn::smem_addr(r + tid), src, ok ? 4 : 0);
  };
  attn::load_tile<T, ROWS, DP, THREADS>(
      smem, k + static_cast<int64_t>(k0) * d, Sq - k0, d, vec, tid);
  attn::load_tile<T, ROWS, DP, THREADS>(
      smem + TB, v + static_cast<int64_t>(k0) * d, Sq - k0, d, vec, tid);
  if (n_tiles > 0) load_qdo(0);
  attn::cp_async_commit();

  // ldmatrix offsets: A (K, V) rows lane % 16 of the warp's, column half
  // lane / 16; B (Q, dO) rows lane % 8 + 8 * (lane / 16), column half
  // (lane / 8) % 2.
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const uint32_t ks = attn::smem_addr(smem), vs = ks + TB;
  const float scale_log2 = scale * LOG2E;
  const float cap_in = CAP ? scale / softcap : 0.0f;   // raw q.k to x / c
  const float cap_log2 = CAP ? softcap * LOG2E : 0.0f;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    attn::cp_async_wait<0>();
    __syncthreads();                   // tile it landed; tile it - 1 consumed
    if (it + 1 < n_tiles) load_qdo(it + 1);
    attn::cp_async_commit();

    const int i0 = i_begin + it * TILE;
    const uint32_t qs = attn::smem_addr(stages + 2 * TB * (it % STAGES));
    const uint32_t gs = qs + TB;
    const float* ls = rows + 2 * TILE * (it % STAGES);
    const float* ds = ls + TILE;
    // The causal mask applies to a key at or past the prefix; each test
    // below reads P as a kernel parameter beside `causal`, which kept the
    // plain causal kernel's time closest to its time without the prefix
    // (PERF.md §6, row 3b).
    const bool edge = (causal && k0 + ROWS > prefix && k0 + ROWS - 1 > i0) ||
                      (window > 0 && k0 <= i0 + TILE - 1 - window) ||
                      i0 + TILE > Sq || k0 + ROWS > Sq;

#pragma unroll 1
    for (int c = 0; c < TILE / CHUNK; ++c) {
      const int c0 = c * CHUNK;        // the pass's first row in the tile
      if (edge && !any_valid(i0 + c0, i0 + c0 + CHUNK - 1, kw, kw + 15, Sq,
                             causal && kw >= prefix, window, 0))
        continue;
      float st[CHUNK / 8][4], dpt[CHUNK / 8][4];
#pragma unroll
      for (int n = 0; n < CHUNK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll(P::KK_UNROLL)
      for (int kk = 0; kk < NC; ++kk) {
        uint32_t ka[4], va[4];
        const uint32_t a_off =
            attn::swizzle<DP>((a_row * DP + kk * 16 + a_col) * 2);
        attn::ldmatrix_x4(ks + a_off, ka);
        attn::ldmatrix_x4(vs + a_off, va);
#pragma unroll
        for (int np = 0; np < CHUNK / 16; ++np) {
          const uint32_t b_off = attn::swizzle<DP>(
              ((c0 + np * 16 + b_row) * DP + kk * 16 + b_col) * 2);
          uint32_t b[4];
          attn::ldmatrix_x4(qs + b_off, b);
          attn::mma_16816<T>(st[2 * np], ka, b[0], b[1]);
          attn::mma_16816<T>(st[2 * np + 1], ka, b[2], b[3]);
          attn::ldmatrix_x4(gs + b_off, b);
          attn::mma_16816<T>(dpt[2 * np], va, b[0], b[1]);
          attn::mma_16816<T>(dpt[2 * np + 1], va, b[2], b[3]);
        }
      }

      // P^T and dS^T in place: lane (g, t) holds keys kw + g (e < 2) and
      // kw + g + 8, queries i0 + c0 + 8n + 2t + (e & 1).
#pragma unroll
      for (int n = 0; n < CHUNK / 8; ++n) {
        const int col = c0 + n * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lrow = lse_log2(e & 1 ? l2.y : l2.x);
          const float drow = e & 1 ? d2.y : d2.x;
          float p, dcap = 1.0f;        // dcap: d(c t)/dx = 1 - t^2
          if constexpr (CAP) {         // every pair of the tile, then mask
            const float th = tanhf(st[n][e] * cap_in);
            p = exp2f(fmaf(th, cap_log2, -lrow));
            dcap = fmaf(-th, th, 1.0f);
          } else {
            p = exp2f(fmaf(st[n][e], scale_log2, -lrow));
          }
          if (edge && !valid_pair(i0 + col + (e & 1), kw + g + 8 * (e >> 1),
                                  Sq, causal && kw + g + 8 * (e >> 1) >= prefix,
                                  window, 0))
            p = 0.0f;
          st[n][e] = p;
          if constexpr (CAP)
            dpt[n][e] = p * (dpt[n][e] - drow) * dcap;
          else
            dpt[n][e] = p * (dpt[n][e] - drow);
        }
      }

      // dV += P^T.dO, dK += dS^T.Q over this block's dims, 16 queries a
      // k-step.
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_fragment<T>(st, kk, hi, lo);
        mma_split_rows<T, DP, NO>(dva, hi, lo, gs, c0 + kk * 16, lane, dim0);
        split_fragment<T>(dpt, kk, hi, lo);
        mma_split_rows<T, DP, NO>(dka, hi, lo, qs, c0 + kk * 16, lane, dim0);
      }
    }
  }
  attn::cp_async_wait<0>();            // no copy outlives the block

  store_rows<T, NO>(dk, dka, scale, kw, Sq, d, lane, dim0);
  store_rows<T, NO>(dv, dva, 1.0f, kw, Sq, d, lane, dim0);
}

template <typename T, int NC, bool CAP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, int d, float scale,
              int causal, int window, int prefix, float softcap, int vec) {
  using P = Plan<NC>;
  constexpr int DP = 16 * NC;
  constexpr int TB = TILE * DP * 2;    // bytes of a streamed tile
  constexpr int OB = ROWS * DP * 2;    // bytes of an owned tile
  constexpr int NO = DP / 8;           // n-tiles of dQ
  extern __shared__ __align__(1024) char smem[];
  char* stages = smem + 2 * OB;        // Q, dO, then per stage K, V

  // This (b, h)'s rows: q, dout, dq, lse, delta at its queries; k, v at
  // its keys, shifted by off = Sk - Sq rows (keys in query positions).
  const int64_t bh =
      static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int off = Sk - Sq;
  q += bh * Sq * d;
  dout += bh * Sq * d;
  dq += bh * Sq * d;
  lse += bh * Sq;
  delta += bh * Sq;
  k += (bh * Sk + off) * d;
  v += (bh * Sk + off) * d;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (Sq + ROWS - 1) / ROWS;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * ROWS;
  const int qw = q0 + warp * 16;       // this warp's first query

  const int k_end = causal ? min(Sq, max(q0 + ROWS, prefix)) : Sq;
  const int k_begin = key_begin<TILE>(q0, off, window);
  const int n_tiles = max(0, (k_end - k_begin + TILE - 1) / TILE);

  auto load_kv = [&](int it) {
    const int k0 = k_begin + it * TILE;
    char* st = stages + 2 * TB * (it % STAGES);
    const int64_t at = static_cast<int64_t>(k0) * d;
    attn::load_tile<T, TILE, DP, THREADS>(st, k + at, Sq - k0, d, vec, tid);
    attn::load_tile<T, TILE, DP, THREADS>(st + TB, v + at, Sq - k0, d, vec,
                                          tid);
  };
  attn::load_tile<T, ROWS, DP, THREADS>(
      smem, q + static_cast<int64_t>(q0) * d, Sq - q0, d, vec, tid);
  attn::load_tile<T, ROWS, DP, THREADS>(
      smem + OB, dout + static_cast<int64_t>(q0) * d, Sq - q0, d, vec, tid);
  if (n_tiles > 0) load_kv(0);
  attn::cp_async_commit();

  // This lane's rows qw + g and qw + g + 8: lse (log2 units) and D.
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    lrow[r] = row < Sq ? lse_log2(lse[row]) : INFINITY;
    drow[r] = row < Sq ? delta[row] : 0.0f;
  }

  // ldmatrix offsets: A (Q, dO) rows lane % 16 of the warp's, column half
  // lane / 16; B (K, V) rows lane % 8 + 8 * (lane / 16), column half
  // (lane / 8) % 2.
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const float scale_log2 = scale * LOG2E;
  const float cap_in = CAP ? scale / softcap : 0.0f;   // raw q.k to x / c
  const float cap_log2 = CAP ? softcap * LOG2E : 0.0f;

  const uint32_t qs = attn::smem_addr(smem), gs = qs + OB;
  // Q's and dO's A fragments, held for the whole key loop (d <= 128 only).
  uint32_t qf[P::WIDE ? 1 : NC][4], gf[P::WIDE ? 1 : NC][4];
  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    attn::cp_async_wait<0>();
    __syncthreads();                   // tile it landed; tile it - 1 consumed
    if constexpr (!P::WIDE) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < NC; ++kk) {
          const uint32_t off =
              attn::swizzle<DP>((a_row * DP + kk * 16 + a_col) * 2);
          attn::ldmatrix_x4(qs + off, qf[kk]);
          attn::ldmatrix_x4(gs + off, gf[kk]);
        }
      }
    }
    if (it + 1 < n_tiles) load_kv(it + 1);
    attn::cp_async_commit();

    const int k0 = k_begin + it * TILE;
    const uint32_t ks = attn::smem_addr(stages + 2 * TB * (it % STAGES));
    const uint32_t vs = ks + TB;
    const bool edge = (causal && k0 + TILE - 1 > max(q0, prefix - 1)) ||
                      (window > 0 && k0 <= q0 + ROWS - 1 - window) ||
                      k0 + TILE > Sq || q0 + ROWS > Sq;

#pragma unroll 1
    for (int c = 0; c < TILE / CHUNK; ++c) {
      const int c0 = c * CHUNK;        // the pass's first key in the tile
      if (edge && !any_valid(qw, qw + 15, k0 + c0, k0 + c0 + CHUNK - 1, Sq,
                             causal, window, prefix))
        continue;
      float s[CHUNK / 8][4], dp[CHUNK / 8][4];
#pragma unroll
      for (int n = 0; n < CHUNK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      if constexpr (P::WIDE) {
#pragma unroll(WIDE_KK_UNROLL)
        for (int kk = 0; kk < NC; ++kk) {
          uint32_t qa[4], ga[4];       // Q's and dO's fragments, reloaded
          const uint32_t a_off =
              attn::swizzle<DP>((a_row * DP + kk * 16 + a_col) * 2);
          attn::ldmatrix_x4(qs + a_off, qa);
          attn::ldmatrix_x4(gs + a_off, ga);
#pragma unroll
          for (int np = 0; np < CHUNK / 16; ++np) {
            const uint32_t b_off = attn::swizzle<DP>(
                ((c0 + np * 16 + b_row) * DP + kk * 16 + b_col) * 2);
            uint32_t b[4];
            attn::ldmatrix_x4(ks + b_off, b);
            attn::mma_16816<T>(s[2 * np], qa, b[0], b[1]);
            attn::mma_16816<T>(s[2 * np + 1], qa, b[2], b[3]);
            attn::ldmatrix_x4(vs + b_off, b);
            attn::mma_16816<T>(dp[2 * np], ga, b[0], b[1]);
            attn::mma_16816<T>(dp[2 * np + 1], ga, b[2], b[3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NC; ++kk) {
#pragma unroll
          for (int np = 0; np < CHUNK / 16; ++np) {
            const uint32_t b_off = attn::swizzle<DP>(
                ((c0 + np * 16 + b_row) * DP + kk * 16 + b_col) * 2);
            uint32_t b[4];
            attn::ldmatrix_x4(ks + b_off, b);
            attn::mma_16816<T>(s[2 * np], qf[kk], b[0], b[1]);
            attn::mma_16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
            attn::ldmatrix_x4(vs + b_off, b);
            attn::mma_16816<T>(dp[2 * np], gf[kk], b[0], b[1]);
            attn::mma_16816<T>(dp[2 * np + 1], gf[kk], b[2], b[3]);
          }
        }
      }

      // P and dS in place: lane (g, t) holds queries qw + g (e < 2) and
      // qw + g + 8, keys k0 + c0 + 8n + 2t + (e & 1).
#pragma unroll
      for (int n = 0; n < CHUNK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p, dcap = 1.0f;        // dcap: d(c t)/dx = 1 - t^2
          if constexpr (CAP) {         // every pair of the tile, then mask
            const float th = tanhf(s[n][e] * cap_in);
            p = exp2f(fmaf(th, cap_log2, -lrow[r]));
            dcap = fmaf(-th, th, 1.0f);
          } else {
            p = exp2f(fmaf(s[n][e], scale_log2, -lrow[r]));
          }
          if (edge && !valid_pair(qw + g + 8 * r,
                                  k0 + c0 + n * 8 + 2 * t + (e & 1), Sq,
                                  causal, window, prefix))
            p = 0.0f;
          if constexpr (CAP)
            s[n][e] = p * (dp[n][e] - drow[r]) * dcap;
          else
            s[n][e] = p * (dp[n][e] - drow[r]);
        }
      }

      // dQ += dS.K, 16 keys a k-step.
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_fragment<T>(s, kk, hi, lo);
        mma_split_rows<T, DP>(dqa, hi, lo, ks, c0 + kk * 16, lane);
      }
    }
  }
  attn::cp_async_wait<0>();            // no copy outlives the block

  store_rows<T, NO>(dq, dqa, scale, qw, Sq, d, lane);
}

}  // namespace tc

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
  int b, h, sq, sk, d, causal, window, prefix;
  float scale, softcap;
  cudaStream_t stream;

  template <typename T, int NC>
  cudaError_t operator()() const {
    return softcap > 0.0f ? run<T, NC, true>() : run<T, NC, false>();
  }

  // The D pre-pass, then the dK/dV and dQ kernels of the dtype's route:
  // f32 the FMA kernels, f16 and bf16 the tensor-core kernels.
  template <typename T, int NC, bool CAP>
  cudaError_t run() const {
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* gt = static_cast<const T*>(dout);
    const int64_t rows = static_cast<int64_t>(b) * h * sq;
    delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                      stream>>>(static_cast<const T*>(out), gt, delta, rows,
                                d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if constexpr (std::is_same_v<T, float>)
      return f32_kernels<NC, CAP>(qt, kt, vt, gt);
    else
      return tc_kernels<T, NC, CAP>(qt, kt, vt, gt);
  }

  template <int NC, bool CAP>
  cudaError_t f32_kernels(const float* qt, const float* kt, const float* vt,
                          const float* gt) const {
    using namespace f32fma;
    constexpr int DP = 32 * nch<NC>();
    const dim3 kv_grid((sk + ROWS - 1) / ROWS, h, b);
    const dim3 q_grid((sq + ROWS - 1) / ROWS, h, b);
    const size_t kv_smem = (2 * TILE * DP + 2 * TILE) * sizeof(float);
    cudaError_t err = attn::allow_smem(
        reinterpret_cast<const void*>(dkdv_kernel<float, NC, CAP>), kv_smem);
    if (err != cudaSuccess) return err;
    dkdv_kernel<float, NC, CAP><<<kv_grid, THREADS, kv_smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), sq, sk, d, scale, causal, window, prefix,
        softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t q_smem = 2 * TILE * DP * sizeof(float);
    err = attn::allow_smem(
        reinterpret_cast<const void*>(dq_kernel<float, NC, CAP>), q_smem);
    if (err != cudaSuccess) return err;
    dq_kernel<float, NC, CAP><<<q_grid, THREADS, q_smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), sq, sk, d,
        scale, causal, window, prefix, softcap);
    return cudaGetLastError();
  }

  template <typename T, int NC, bool CAP>
  cudaError_t tc_kernels(const T* qt, const T* kt, const T* vt,
                         const T* gt) const {
    const void* ptrs[4] = {q, k, v, dout};
    const int vec = attn::copy_width(d, ptrs, 4);
    const int n_kt = (sk + tc::ROWS - 1) / tc::ROWS;   // key tiles
    const dim3 q_grid((sq + tc::ROWS - 1) / tc::ROWS, h, b);
    constexpr size_t kv_smem = tc::smem_bytes<NC>(true);
    static_assert(tc::smem_bytes<NC>(true) <= 232448, "227 KiB a block");
    cudaError_t err = attn::allow_smem(
        reinterpret_cast<const void*>(tc::dkdv_kernel<T, NC, CAP>), kv_smem);
    if (err != cudaSuccess) return err;
    const dim3 kv_grid(n_kt * tc::Plan<NC>::HALVES, h, b);
    tc::dkdv_kernel<T, NC, CAP><<<kv_grid, tc::THREADS, kv_smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, sk, d, scale, causal, window, prefix, softcap, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    constexpr size_t q_smem = tc::smem_bytes<NC>(false);
    err = attn::allow_smem(
        reinterpret_cast<const void*>(tc::dq_kernel<T, NC, CAP>), q_smem);
    if (err != cudaSuccess) return err;
    tc::dq_kernel<T, NC, CAP><<<q_grid, tc::THREADS, q_smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), sq, sk, d, scale,
        causal, window, prefix, softcap, vec);
    return cudaGetLastError();
  }
};

}  // namespace

// Launches the three kernels on `stream` without synchronising; returns the
// first launch error (cudaGetLastError()). q, out, dout, dq (b, h, sq, d)
// and k, v, dk, dv (b, h, sk, d) contiguous, all of one dtype (attn::F32,
// F16 or BF16); lse and delta (b, h, sq) f32, delta scratch that the
// pre-pass fills; d <= 256; window 0 means no sliding window, prefix 0
// plain causal attention, with off = sk - sq as in flash_attn_launch;
// scale 1/sqrt(d), prefix and softcap (0: none) as the forward took them,
// lse the forward's over the capped scores. Refused as the forward refuses
// them: causal with sk < sq, a prefix with sq != sk.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* out,
                                     const void* dout, const float* lse,
                                     float* delta, void* dq, void* dk,
                                     void* dv, int b, int h, int sq, int sk,
                                     int d, int causal, int window,
                                     int prefix, float scale, float softcap,
                                     int dtype, void* stream) {
  if (!(softcap >= 0.0f && softcap < INFINITY) || prefix < 0 || sk < 1 ||
      (causal && sk < sq) || (prefix > 0 && sq != sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch launch{q,      k,      v,      out,     dout,   lse,
                      delta,  dq,     dk,     dv,      b,      h,
                      sq,     sk,     d,      causal,  window, prefix,
                      scale,  softcap, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      attn::dispatch<attn::MAX_BWD_HEAD_DIM>(dtype, d, launch));
}
