// Shared helpers of the LM kernels (rglru_scan.cu, ssd_scan.cu,
// flash_attention.cu): the element types they take and their
// conversions to and from the f32 they compute in.
//
// Every LM kernel takes float32 or bfloat16 tensors (kDtypeF32,
// kDtypeBF16, passed by the wrappers in repro_torch/kernels/*/ops.py)
// and accumulates in float32, as the TPU kernels do.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
// dynamic shared memory a block may use on Hopper (227 KB)
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast does
}

// Elements of T that make one 32-bit word: padding a shared row by this
// many elements shifts the next row by one bank.
template <typename T>
constexpr int word_pad() { return static_cast<int>(4 / sizeof(T)); }

}  // namespace repro_torch
