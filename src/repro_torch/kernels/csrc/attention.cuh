// What the attention kernels of this directory share: conversion of their
// three input types to and from f32 (by the cuda_fp16.h / cuda_bf16.h
// intrinsics), the padded head width a thread layout works in, and the
// dispatch from a runtime dtype code and head dim to a template instance.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// 16 * NC, NC in {1, 2, 4, 8}: d <= 128.
constexpr int MAX_HEAD_DIM = 128;

// Calls fn.template operator()<T, NC>() for the dtype code and head dim;
// returns cudaErrorInvalidValue for a combination no instance covers.
template <typename Fn>
cudaError_t dispatch(int dtype, int d, Fn fn) {
  auto by_dim = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    if (d <= 16) return fn.template operator()<T, 1>();
    if (d <= 32) return fn.template operator()<T, 2>();
    if (d <= 64) return fn.template operator()<T, 4>();
    if (d <= MAX_HEAD_DIM) return fn.template operator()<T, 8>();
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

}  // namespace attn
