// retire_reduce: the per-column reductions the windowed engine retires
// columns from, once per segment — deliveries (cnt), deliveries by
// alive rows (alivedel), deliveries at or after the row's earliest open
// gate (blocked), first receipts arr < rounds (arrcnt) and the sum of
// delivery rounds (sumdel).
//
// Replaces the TPU kernel retire_reduce_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by retire_reduce in
// ops.py of that package).
//
// What bounds it: memory.  It must read the arr and delivered planes
// once: 1.31 GB at the sustained shape (N = 10,000, W = 16,384), 0.39 ms
// at the H100 SXM's 3.35 TB/s.  The design makes one pass: each thread
// owns one column and walks a chunk of rows, so a warp reads 32
// neighbouring columns of a row per step (coalesced); the row chunks
// give enough blocks to fill the card when W alone would not.  Each
// thread adds its five partials to the (W,) outputs with one atomicAdd
// each, skipped when zero.  sumdel accumulates in int64 and so equals
// the JAX kernel's int32 sum wherever that sum does not wrap
// (N * rounds < 2^31).
//
// With record = 0 the same kernel is retire_scan, the TPU kernel
// retire_scan_kernel of that kernel.py: it reads only delivered (arr
// may be null) and writes only cnt, alivedel and blocked, so it moves
// half the bytes.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kRetireCols = 128;

template <bool kRecord>
__global__ void retire_reduce_kernel(const int32_t* __restrict__ arr,
                                     const int32_t* __restrict__ delivered,
                                     const uint8_t* __restrict__ crashed,
                                     const int32_t* __restrict__ min_gate,
                                     int32_t* __restrict__ cnt,
                                     int32_t* __restrict__ alivedel,
                                     int32_t* __restrict__ blocked,
                                     int32_t* __restrict__ arrcnt,
                                     unsigned long long* __restrict__ sumdel,
                                     int n, int w, int rows_per_chunk,
                                     int rounds) {
  const int m = blockIdx.x * kRetireCols + threadIdx.x;
  if (m >= w) return;
  const int p0 = blockIdx.y * rows_per_chunk;
  const int p1 = min(n, p0 + rows_per_chunk);
  int c = 0, a = 0, b = 0, r = 0;
  long long s = 0;
  for (int p = p0; p < p1; ++p) {
    const size_t idx = static_cast<size_t>(p) * w + m;
    const int32_t d = delivered[idx];
    if (d >= 0) {
      c += 1;
      a += crashed[p] == 0;
      b += d >= min_gate[p];
      if (kRecord) s += d;
    }
    if (kRecord) r += arr[idx] < rounds;
  }
  if (c) atomicAdd(cnt + m, c);
  if (a) atomicAdd(alivedel + m, a);
  if (b) atomicAdd(blocked + m, b);
  if (kRecord) {
    if (r) atomicAdd(arrcnt + m, r);
    if (s) atomicAdd(sumdel + m, static_cast<unsigned long long>(s));
  }
}

}  // namespace repro_torch

extern "C" int rt_retire_reduce(const void* arr, const void* delivered,
                                const void* crashed, const void* min_gate,
                                void* cnt, void* alivedel, void* blocked,
                                void* arrcnt, void* sumdel, int n, int w,
                                int rows_per_chunk, int rounds, int record,
                                void* stream) {
  using namespace repro_torch;
  if (n > 0 && w > 0 && rows_per_chunk > 0) {
    const dim3 grid(static_cast<unsigned>((w + kRetireCols - 1) / kRetireCols),
                    static_cast<unsigned>((n + rows_per_chunk - 1) /
                                          rows_per_chunk));
    const auto kernel = record ? retire_reduce_kernel<true>
                               : retire_reduce_kernel<false>;
    kernel<<<grid, kRetireCols, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(arr),
        static_cast<const int32_t*>(delivered),
        static_cast<const uint8_t*>(crashed),
        static_cast<const int32_t*>(min_gate), static_cast<int32_t*>(cnt),
        static_cast<int32_t*>(alivedel), static_cast<int32_t*>(blocked),
        static_cast<int32_t*>(arrcnt),
        static_cast<unsigned long long*>(sumdel), n, w, rows_per_chunk,
        rounds);
  }
  return static_cast<int>(cudaGetLastError());
}
