// rglru_scan: the RG-LRU linear recurrence of RecurrentGemma's recurrent
// blocks, elementwise over the LRU width,
//
//   h[b, t, w] = a[b, t, w] * h[b, t - 1, w] + x[b, t, w],
//   h[b, -1, w] = h0[b, w]  (0 without h0),
//
// with an f32 state; every step's state is written out (f32), so the
// caller takes h[:, -1] as the state it hands to decoding.
//
// Replaces the TPU kernel rglru_scan_kernel in
// src/repro/kernels/rglru_scan/kernel.py (launched by rglru_scan_pallas
// there, through rglru_scan in ops.py).  The prefill of every recurrent
// layer calls it once.
//
// What bounds it: memory.  It reads a and x once and writes h once,
// 12 bytes a cell in f32 (8 in bf16): at the recurrentgemma-9b prefill
// (B = 1, S = 2,048, W = 4,096) 100 MB, 0.03 ms at the H100 SXM's
// 3.35 TB/s.  The design is the plain one: a thread a (b, w) column
// walking S in order, so consecutive threads read and write consecutive
// w (coalesced), with the loads of kScanUnroll steps issued before the
// dependent chain of multiply-adds uses them.  It needs no padding: the
// grid covers W with a bounds check and each thread walks exactly S
// steps.  B x W threads is few (4,096 at B = 1), so the kernel runs far
// from the memory rate: the latency of the loads, not their bytes,
// sets its time; splitting S into chunks with a second fix-up pass is
// the lever for a later change.

#include "lm_common.cuh"

namespace repro_torch {

constexpr int kScanThreads = 64;
constexpr int kScanUnroll = 16;

template <typename T>
__global__ void rglru_scan_kernel(const T* __restrict__ a,
                                  const T* __restrict__ x,
                                  const float* __restrict__ h0,
                                  float* __restrict__ h, int s, int w) {
  const int col = blockIdx.x * kScanThreads + threadIdx.x;
  if (col >= w) return;
  const size_t row = blockIdx.y;
  const size_t base = row * static_cast<size_t>(s) * w + col;
  float state = h0 != nullptr ? h0[row * w + col] : 0.0f;
  int t = 0;
  for (; t + kScanUnroll <= s; t += kScanUnroll) {
    float av[kScanUnroll], xv[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const size_t i = base + static_cast<size_t>(t + u) * w;
      av[u] = to_f32(a[i]);
      xv[u] = to_f32(x[i]);
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      state = av[u] * state + xv[u];
      h[base + static_cast<size_t>(t + u) * w] = state;
    }
  }
  for (; t < s; ++t) {
    const size_t i = base + static_cast<size_t>(t) * w;
    state = to_f32(a[i]) * state + to_f32(x[i]);
    h[i] = state;
  }
}

template <typename T>
int launch_rglru(const void* a, const void* x, const void* h0, void* h,
                 int batch, int s, int w, cudaStream_t stream) {
  const dim3 grid((w + kScanThreads - 1) / kScanThreads, batch);
  rglru_scan_kernel<T><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h), s, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// a, x: (batch, s, w) of dtype; h0: (batch, w) f32 or null; h: (batch,
// s, w) f32.  Returns the cudaError_t of the launch.
extern "C" int rt_rglru_scan(const void* a, const void* x, const void* h0,
                             void* h, int batch, int s, int w, int dtype,
                             void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || s <= 0 || w <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_rglru<float>(a, x, h0, h, batch, s, w, st);
  if (dtype == kDtypeBF16)
    return launch_rglru<__nv_bfloat16>(a, x, h0, h, batch, s, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
