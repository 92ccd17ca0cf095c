// What the attention kernels of this directory share: conversion of their
// three input types to and from f32 (by the cuda_fp16.h / cuda_bf16.h
// intrinsics), the padded head width a thread layout works in, the
// dispatch from a runtime dtype code and head dim to a template instance,
// and the pieces of the tensor-core route for 16-bit inputs: asynchronous
// 16-bit tile copies into XOR-swizzled shared memory, ldmatrix,
// mma.sync.m16n8k16 with f32 accumulation, and the split of f32
// probabilities into two 16-bit parts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

// dtype codes passed by the Python wrappers.
constexpr int F32 = 0;
constexpr int F16 = 1;
constexpr int BF16 = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Head dims are padded (with zeros, in shared memory and registers) to
// 16 * NC, NC in {1, 2, 4, 8, 16}: d <= 256 in every attention kernel. The
// backward's NC = 16 instances have tile plans of their own
// (flash_attn_bwd.cu, tc::Plan): its dK/dV kernel is at 255 registers at
// NC = 8 already.
constexpr int MAX_HEAD_DIM = 256;
constexpr int MAX_BWD_HEAD_DIM = 256;

// Calls fn.template operator()<T, NC>() for the dtype code and head dim,
// up to MAX_D; returns cudaErrorInvalidValue for a combination no instance
// covers.
template <int MAX_D = MAX_HEAD_DIM, typename Fn>
cudaError_t dispatch(int dtype, int d, Fn fn) {
  static_assert(MAX_D == 128 || MAX_D == 256, "NC 8 or 16 at most");
  auto by_dim = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    if (d <= 16) return fn.template operator()<T, 1>();
    if (d <= 32) return fn.template operator()<T, 2>();
    if (d <= 64) return fn.template operator()<T, 4>();
    if (d <= 128) return fn.template operator()<T, 8>();
    if constexpr (MAX_D == 256) {
      if (d <= 256) return fn.template operator()<T, 16>();
    }
    return cudaErrorInvalidValue;
  };
  if (d < 1) return cudaErrorInvalidValue;
  if (dtype == F32) return by_dim(float{});
  if (dtype == F16) return by_dim(__half{});
  if (dtype == BF16) return by_dim(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Tensor-core route (f16 and bf16 inputs).
//
// Tiles live in shared memory in their 16-bit type, row-major with rows of
// DP elements, XOR-swizzled: the 16-byte chunk c of row r is stored at
// chunk c ^ (r % 8) for rows of 128 bytes or more (DP >= 64); shorter rows
// are taken in 128-byte lines, chunk c of line n at c ^ (n % 8). ldmatrix
// reads eight consecutive rows at one column chunk; the swizzle sends those
// eight 16-byte reads to eight distinct groups of four banks, where the
// plain layout would serialise up to eight of them (rows of 256 or 512
// bytes all start in bank 0). Tiles start at offsets that are multiples of
// 1024 bytes.
// ---------------------------------------------------------------------------

template <int DP>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr int ROW_BYTES = 2 * DP;
  constexpr int SHIFT =                            // row (or line) index
      ROW_BYTES >= 512 ? 9 : ROW_BYTES >= 256 ? 8 : 7;
  static_assert(ROW_BYTES <= 512, "DP <= 256");
  return off ^ (((off >> SHIFT) & 7u) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of `bytes` (16, 8 or 4) from global to shared memory;
// src_bytes = 0 writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements per copy for rows of d 16-bit elements starting at each of
// `ptrs`: 8 (16-byte cp.async) where every row start is 16-byte aligned,
// else 4 or 2 (8- or 4-byte cp.async), else 1 (a plain 2-byte load).
inline int copy_width(int d, const void* const* ptrs, int n) {
  for (int vec = 8; vec > 1; vec /= 2) {
    bool ok = d % vec == 0;
    for (int i = 0; i < n; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % (2 * vec) == 0;
    if (ok) return vec;
  }
  return 1;
}

// Copies rows [0, ROWS) and dims [0, DP) of the row-major (rows, d) matrix
// at `src` into the swizzled tile at `dst`; rows >= n_valid and dims >= d
// become zeros (a P·V product then adds 0·0 for them, never 0·NaN). All
// THREADS threads of the block call it; copies of `vec` elements as
// copy_width chose. The caller commits the group and waits for it.
template <typename T, int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(char* dst, const T* src,
                                          int n_valid, int d, int vec,
                                          int tid) {
  constexpr int CPR = DP / 8;        // 16-byte chunks per row
  const uint32_t base = smem_addr(dst);
#pragma unroll 4
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int row = i / CPR;
    const int col = (i % CPR) * 8;
    const uint32_t off =
        swizzle<DP>(static_cast<uint32_t>(row * DP + col) * 2);
    const bool row_ok = row < n_valid;
    const T* g = src + static_cast<int64_t>(row) * d + col;
    if (vec == 8) {
      const bool ok = row_ok && col < d;
      cp_async<16>(base + off, ok ? g : src, ok ? 16 : 0);
    } else if (vec == 4) {
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const bool ok = row_ok && col + e < d;
        cp_async<8>(base + off + 2 * e, ok ? g + e : src, ok ? 8 : 0);
      }
    } else if (vec == 2) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const bool ok = row_ok && col + e < d;
        cp_async<4>(base + off + 2 * e, ok ? g + e : src, ok ? 4 : 0);
      }
    } else {
      T* s = reinterpret_cast<T*>(dst + off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s[e] = (row_ok && col + e < d) ? g[e] : from_f32<T>(0.0f);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a · b for a 16x16 A fragment, a 16x8 B fragment (b0, b1) and a 16x8
// f32 accumulator, as mma.sync.m16n8k16 lays them out: lane = 4 * g + t
// holds A (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); B
// (k 2t..2t+1, n g), (k 2t+8.., n g); C (g, 2t..2t+1), (g+8, 2t..2t+1).
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same_v<T, __half>, "f16 or bf16 only");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Splits the f32 pair (x0, x1) into 16-bit pairs hi = T(x) and
// lo = T(x - hi), packed as an MMA operand register (x0 in the low half).
// hi + lo carries 16 significant bits of each x in bf16 (22 in f16), where
// one rounding would keep 8 (11): P·V as hi·V + lo·V then stays within the
// f32 reference's one-ulp output rounding, which P rounded once does not.
template <typename T>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// (T(x0), T(x1)) rounded to nearest and packed, x0 in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack_pair(float x0, float x1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Max and sum over the four lanes of a quad (the lanes that share an
// accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax step for the two accumulator rows a lane holds (g and
// g + 8), over the n-tiles of scores `s` (-inf where masked), each a score
// in scaled units divided by `unit`: raw q·k (unit = 1 / sqrt(d)), or a
// softcapped score (unit = 1). Updates the row max m (in the scores'
// units), rescales o and the lane's partial row sum l by
// e^(unit·(m_old - m_new)), and turns s into e^(unit·(s - m_new)) in place;
// unit_log2 = unit · log2(e), so e^(unit·x) is exp2(x·unit_log2). A row
// with no valid score so far keeps m = -inf and gets p = 0.
template <int NT, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&o)[NO][4],
                                               float (&m)[2], float (&l)[2],
                                               float unit_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
    const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = exp2f((m[r] - m_safe) * unit_log2);
    const float mc = m_safe * unit_log2;
    m[r] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[n][e] = exp2f(fmaf(s[n][e], unit_log2, -mc));
        sum += s[n][e];
      }
    }
    l[r] = l[r] * alpha + sum;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * r] *= alpha;
      o[n][2 * r + 1] *= alpha;
    }
  }
}

}  // namespace attn
