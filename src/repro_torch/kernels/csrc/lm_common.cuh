// Shared helpers of the LM kernels (rglru_scan.cu, ssd_scan.cu,
// ssd_scan_bwd.cu, flash_attention.cu): the element types they take and
// their conversions to and from the f32 they compute in, and the
// tensor-core building blocks of the bf16 bodies of flash_attention.cu,
// ssd_scan.cu and ssd_scan_bwd.cu (cp.async copies, ldmatrix,
// mma.sync.m16n8k16, the SSD kernels' hi/lo splits).
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

constexpr float kLog2e = 1.4426950408889634f;

// ---- tensor-core building blocks (sm_80 and later; built for sm_90a) ----
// Fragment layouts of mma.sync.m16n8k16 with lane = 4 g + t: A (16 x 16,
// row-major) a[0] = (row g, cols 2t, 2t+1), a[1] = row g + 8, a[2] and
// a[3] the same rows at cols 2t + 8, 2t + 9; B (16 x 8, k by n) b0 = (k
// 2t, 2t+1; col g), b1 = k + 8; C (16 x 8 f32) c[0..1] = (row g, cols 2t,
// 2t+1), c[2..3] = row g + 8.  Two neighbouring n-tiles of C are, packed
// to bf16 pairs, the A fragment of the next product.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a m16k16 (4 regs), b k16n8 (2 regs), c m16n8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the SSD kernels' tensor-core bodies (ssd_scan.cu, ssd_scan_bwd.cu)

// Q and N at most, and the tile the bodies always compute: shorter Q and
// N are zero-padded to it, so that every loop over it has a fixed trip
// count and no guard between an ldmatrix and the products it feeds
constexpr int kSsdTile = 128;
constexpr int kSsdTiles = kSsdTile / 16;  // m16 tiles of Q or N

// The body both SSD kernels run for a shape: the tensor cores for bf16
// chunks of at most 128 steps and states of at most 128 rows, FMA on the
// CUDA cores otherwise (TF32 keeps about three digits, too few for the
// f32 tolerance of 2e-5).
inline bool ssd_tensor_cores(int q, int n, int dtype) {
  return dtype == kDtypeBF16 && q <= kSsdTile && n <= kSsdTile;
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// An f32 operand goes in as hi + lo, two products against the same bf16
// fragment, keeping about 16 bits of it where one bf16 rounding keeps 8.

// a = hi + lo for a pair: hi = bf16(a), lo = bf16(a - hi)
__device__ __forceinline__ void split_bf16(float a0, float a1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a0 - hf.x, a1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 2^x, flushed to 0 below 2^-126 (decay weights that small vanish against
// their neighbours either way)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace repro_torch
