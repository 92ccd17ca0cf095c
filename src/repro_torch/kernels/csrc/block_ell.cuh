// The Block-ELL aggregation shared by the kernels of this directory: the sum
// over one row block's valid slots of brick @ H-tile, in f32 registers.
//
// Two routes:
//   * `warp_accumulate` (route "zero_skip", bricks of up to 8 rows of 8): one
//     warp owns one (row block, 256-column chunk) output tile and no barrier
//     wider than the warp is taken. It copies a batch of up to BATCH of the
//     row block's bricks into warp-private shared memory with cp.async, finds
//     each brick's nonzero columns (one lane per slot), compacts the
//     (H row, brick column) pairs of the batch into a list, and then gathers
//     only those H rows, UNROLL at a time, each once, with 16-byte loads where
//     the pointer and the width allow;
//   * `accumulate_row_block` (route "brick_loop", any brick shape): the first
//     version's loop, in which the block stages every brick and every thread
//     walks all bk rows of its H tile.
//
// Skipping is exact for finite H: a brick column is skipped only when all of
// its bm values are zero, so the result equals the dense product up to the
// order of the f32 sums. For a nonfinite H row under an all-zero column,
// 0 * inf gives 0 here where the Pallas kernel gives NaN, as torch.sparse.mm
// does. Rows of H at or past k_rows read as zero on both routes, so H needs
// no padding and the caller no host-side max over col_tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace block_ell {

constexpr int ROWS_PER_THREAD = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// Route "brick_loop".
// ---------------------------------------------------------------------------

// acc[r] += sum_{s < n_tiles[rb], col_tile[rb,s] >= 0}
//           sum_k blocks[rb, s, row0 + r, k] * H[col_tile[rb,s]*bk + k, col]
// for r < n_rows. The TPU grid's sequential slot axis is this loop, bounded
// by n_tiles[rb]. Every thread of the block must call it: the block stages
// each brick (converted to f32) in `brick` (bm * bk floats of shared memory)
// between two barriers, and every thread then reads it by broadcast.
// Threads with col >= f only help stage.
template <typename TA, typename TH>
__device__ __forceinline__ void accumulate_row_block(
    const TA* __restrict__ blocks, const int32_t* __restrict__ col_tile,
    const int32_t* __restrict__ n_tiles, const TH* __restrict__ h,
    float* brick, int64_t rb, int ell_w, int bm, int bk, int64_t k_rows,
    int f, int col, int row0, int n_rows, float (&acc)[ROWS_PER_THREAD]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int brick_elems = bm * bk;
  const int n_slots = min(n_tiles[rb], ell_w);
  for (int s = 0; s < n_slots; ++s) {
    const int t = col_tile[rb * ell_w + s];
    if (t < 0) continue;  // same value for the whole block: no divergence
    __syncthreads();      // the previous brick is fully consumed
    const TA* src = blocks + (rb * ell_w + s) * brick_elems;
    for (int i = tid; i < brick_elems; i += n_threads) brick[i] = to_f32(src[i]);
    __syncthreads();
    if (col >= f) continue;
    const int64_t k0 = static_cast<int64_t>(t) * bk;
    const int64_t k_left = k_rows - k0;
    const int k_end = k_left < bk ? static_cast<int>(k_left) : bk;
    const float* a = brick + row0 * bk;
    if (n_rows == ROWS_PER_THREAD) {
      for (int k = 0; k < k_end; ++k) {
        const float hv = to_f32(h[(k0 + k) * f + col]);
#pragma unroll
        for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] += a[r * bk + k] * hv;
      }
    } else {
      for (int k = 0; k < k_end; ++k) {
        const float hv = to_f32(h[(k0 + k) * f + col]);
        for (int r = 0; r < n_rows; ++r) acc[r] += a[r * bk + k] * hv;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Route "zero_skip".
// ---------------------------------------------------------------------------

constexpr int WARP = 32;
constexpr int MAX_BM = 8;          // rows of a brick on this route, at most
constexpr int BK = 8;              // columns of a brick on this route
constexpr int COLS_PER_LANE = 8;   // a warp covers 256 feature columns
                                   // (4 or 8)
constexpr int CHUNK = WARP * COLS_PER_LANE;
constexpr int UNROLL = 4;          // H rows gathered before their FMAs

// Whether warp_accumulate takes these operands: bricks of up to MAX_BM rows
// of BK columns (rows of 16 or 32 bytes, copied and read as 16-byte
// pieces), 16-byte aligned, and H rows an int32 list entry can name. The
// kernels' C entry points choose their route with it.
inline bool zero_skip_fits(int bm, int bk, int64_t k_rows,
                           const void* blocks) {
  return bm >= 1 && bm <= MAX_BM && bk == BK &&
         k_rows < (int64_t{1} << 31) - BK &&
         reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
}

// Shared memory one warp needs for a batch of `batch` slots: the bricks in
// their own type, then the compacted list (H row, brick offset) of up to
// BK entries per slot.
template <typename TA>
__host__ __device__ constexpr int warp_scratch_bytes(int batch) {
  return batch * MAX_BM * BK * static_cast<int>(sizeof(TA)) +
         batch * BK * 2 * static_cast<int>(sizeof(int32_t));
}

// Values of type T a lane reads as one vector: 16 bytes (4 f32, 8 16-bit)
// or its COLS_PER_LANE, if fewer.
template <typename T>
__host__ __device__ constexpr int lane_vec() {
  return 16 / static_cast<int>(sizeof(T)) < COLS_PER_LANE
             ? 16 / static_cast<int>(sizeof(T))
             : COLS_PER_LANE;
}

// Column of the j-th of a lane's COLS_PER_LANE values in a chunk starting at
// c0. With VEC the lane reads vectors of V = lane_vec values, and vector q
// of all lanes is one contiguous run; without it, one column in every 32
// (scalar reads that stay coalesced across the warp).
template <bool VEC, int V>
__device__ __forceinline__ int lane_col(int c0, int lane, int j) {
  return VEC ? c0 + (j / V) * (WARP * V) + lane * V + j % V
             : c0 + lane + WARP * j;
}

// The lane's COLS_PER_LANE values of one H row (zeros past f). With VEC the
// caller guarantees 16-byte alignment of the row and that f is a multiple
// of the values per 16 bytes, so each vector is wholly inside or outside f.
template <bool VEC>
__device__ __forceinline__ void load_h(const float* __restrict__ row, int c0,
                                       int lane, int f,
                                       float (&v)[COLS_PER_LANE]) {
  constexpr int V = lane_vec<float>();
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE / V; ++q) {
    if (VEC) {
      const int c = lane_col<true, V>(c0, lane, q * V);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < f) x = __ldg(reinterpret_cast<const float4*>(row + c));
      v[V * q] = x.x;
      v[V * q + 1] = x.y;
      v[V * q + 2] = x.z;
      v[V * q + 3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = lane_col<false, V>(c0, lane, V * q + i);
        v[V * q + i] = c < f ? __ldg(row + c) : 0.f;
      }
    }
  }
}

__device__ __forceinline__ float2 to_float2(__half2 x) {
  return __half22float2(x);
}
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}

template <bool VEC, typename T16>
__device__ __forceinline__ void load_h(const T16* __restrict__ row, int c0,
                                       int lane, int f,
                                       float (&v)[COLS_PER_LANE]) {
  constexpr int V = lane_vec<T16>();
  using Pair = typename std::conditional<std::is_same<T16, __half>::value,
                                         __half2, __nv_bfloat162>::type;
  using Vec = typename std::conditional<V == 8, uint4, uint2>::type;
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE / V; ++q) {
    if (VEC) {
      const int c = lane_col<true, V>(c0, lane, q * V);
      Vec u = {};
      if (c < f) u = __ldg(reinterpret_cast<const Vec*>(row + c));
      const Pair* p = reinterpret_cast<const Pair*>(&u);
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const float2 x = to_float2(p[i]);
        v[V * q + 2 * i] = x.x;
        v[V * q + 2 * i + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = lane_col<false, V>(c0, lane, V * q + i);
        v[V * q + i] = c < f ? to_f32(row[c]) : 0.f;
      }
    }
  }
}

// Writes a lane's COLS_PER_LANE f32 values of one row (global or shared
// memory) at the columns load_h<VEC> reads for H of type T; columns >= f are
// skipped. With VEC the row start is 16-byte aligned and f a multiple of 4.
template <bool VEC, typename T>
__device__ __forceinline__ void store_row(float* row, int c0, int lane, int f,
                                          const float (&v)[COLS_PER_LANE]) {
  constexpr int V = lane_vec<T>();
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE / 4; ++q) {
    const int c = lane_col<VEC, V>(c0, lane, 4 * q);
    if (VEC) {
      if (c < f) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = lane_col<false, V>(c0, lane, 4 * q + i);
        if (ci < f) row[ci] = v[4 * q + i];
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// acc[r][j] += sum over slots s in [s_begin, s_end) of row block rb with
// col_tile >= 0, and over the brick's nonzero columns k, of
// blocks[rb, s, r, k] * H[col_tile*bk + k, lane_col(c0, lane, j)],
// for r < bm <= MAX_BM, bk <= BK; rows r >= bm of acc hold values the
// caller must not store. Called by all 32 lanes of a warp with
// the same arguments; `scratch` is the warp's own warp_scratch_bytes<TA>
// (BATCH) bytes of shared memory, 16-byte aligned. The bricks of a row block
// are contiguous in `blocks` and a row of BK values is 16 or 32 bytes
// (zero_skip_fits routes other shapes elsewhere), so a batch is one
// contiguous range copied with 16-byte cp.async.
template <int BATCH, bool VEC, typename TA, typename TH>
__device__ __forceinline__ void warp_accumulate(
    const TA* __restrict__ blocks, const int32_t* __restrict__ col_tile,
    const TH* __restrict__ h, int64_t rb, int ell_w, int s_begin, int s_end,
    int bm, int64_t k_rows, int f, int c0, char* scratch,
    float (&acc)[MAX_BM][COLS_PER_LANE]) {
  static_assert(BATCH <= WARP, "one lane per slot of a batch");
  const int lane = threadIdx.x & (WARP - 1);
  const int nb = bm * BK;
  TA* sbrick = reinterpret_cast<TA*>(scratch);
  int32_t* srow = reinterpret_cast<int32_t*>(scratch + BATCH * MAX_BM * BK *
                                             sizeof(TA));
  int32_t* soff = srow + BATCH * BK;

  for (int s0 = s_begin; s0 < s_end; s0 += BATCH) {
    const int n = min(BATCH, s_end - s0);
    __syncwarp();  // the previous batch's list and bricks are consumed
    // Bricks of slots s0 .. s0 + n: one contiguous range, 16 bytes a copy.
    const int pieces = n * nb * static_cast<int>(sizeof(TA)) / 16;
    const char* src = reinterpret_cast<const char*>(
        blocks + (rb * ell_w + s0) * static_cast<int64_t>(nb));
    for (int i = lane; i < pieces; i += WARP)
      cp_async16(reinterpret_cast<char*>(sbrick) + 16 * i, src + 16 * i);
    const int t = lane < n ? col_tile[rb * ell_w + s0 + lane] : -1;
    cp_async_wait_all();
    __syncwarp();

    // Lane l finds the nonzero columns of slot s0 + l that lie inside H,
    // reading its brick's rows of 8 as 16-byte pieces; each lane starts at
    // another piece, so the lanes of a warp read other banks.
    unsigned mask = 0;
    if (t >= 0) {
      constexpr int PER = 16 / static_cast<int>(sizeof(TA));
      const int n_pieces = nb / PER;
      const uint4* b = reinterpret_cast<const uint4*>(sbrick + lane * nb);
      for (int i = 0; i < n_pieces; ++i) {
        int p = i + lane % n_pieces;
        if (p >= n_pieces) p -= n_pieces;
        const uint4 u = b[p];
        const TA* v = reinterpret_cast<const TA*>(&u);
        const int k0 = (p * PER) % BK;
#pragma unroll
        for (int j = 0; j < PER; ++j)
          if (to_f32(v[j]) != 0.f) mask |= 1u << (k0 + j);
      }
      const int64_t k_left = k_rows - static_cast<int64_t>(t) * BK;
      if (k_left < BK) mask &= k_left > 0 ? (1u << k_left) - 1u : 0u;
    }
    // Compact the (H row, brick offset) pairs of the batch into the list.
    const int count = __popc(mask);
    int offset = count;
#pragma unroll
    for (int d = 1; d < WARP; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, offset, d);
      if (lane >= d) offset += y;
    }
    const int total = __shfl_sync(0xffffffffu, offset, WARP - 1);
    offset -= count;
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1;
      srow[offset] = t * BK + k;
      soff[offset] = lane * nb + k;
      ++offset;
    }
    __syncwarp();

    // Gather each listed H row once, UNROLL rows in flight. Past the end of
    // the list a round repeats a listed row with zero weights, and every
    // entry updates all MAX_BM rows (rows >= bm are never stored), so the
    // loads and FMAs carry no branches and the brick values of an entry
    // are read together.
    for (int e0 = 0; e0 < total; e0 += UNROLL) {
      float hv[UNROLL][COLS_PER_LANE];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = min(e0 + u, total - 1);
        load_h<VEC>(h + static_cast<int64_t>(srow[e]) * f, c0, lane, f,
                    hv[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool listed = e0 + u < total;
        const TA* a = sbrick + soff[min(e0 + u, total - 1)];
        float av[MAX_BM];
#pragma unroll
        for (int r = 0; r < MAX_BM; ++r)
          av[r] = listed ? to_f32(a[r * BK]) : 0.f;
#pragma unroll
        for (int r = 0; r < MAX_BM; ++r) {
#pragma unroll
          for (int j = 0; j < COLS_PER_LANE; ++j)
            acc[r][j] = fmaf(av[r], hv[u][j], acc[r][j]);
        }
      }
    }
  }
}

}  // namespace block_ell
