// latency_hist: the per-column delivery-latency histogram the windowed
// engine folds at every retirement sweep that retires app columns.  Row
// p of output column j counts in bucket(delivered[p, m] - base[j]) when
// delivered[p, m] >= 0 and base[j] >= 0, where m = cols[j] (or j when
// cols is null), so retirement reads the retiring columns straight from
// the live (N, W) plane without an index_select copy.
//
// Buckets (the obs/hist.py contract, NB = 32): 0-15 exact, 16 + j for
// [2^(4+j), 2^(5+j)), 31 for >= 2^19.  For lat >= 16,
// floor(log2(lat)) = 31 - __clz(lat), so bucket = min(16 +
// floor(log2(lat)) - 4, 31): the 15 comparisons of the TPU kernel in one
// instruction.  Integer arithmetic only.
//
// Replaces the TPU kernel latency_hist_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by latency_hist in
// ops.py of that package).
//
// What bounds it: memory.  It must read the (N, C) int32 cells of the
// selected columns once and write C x 32 counters; at the serving shape
// (N = 65,536, a few hundred retiring columns) that is tens of MB, some
// 0.02 ms at the H100 SXM's 3.35 TB/s.  A thread a column walking all N
// rows (the retire_reduce layout) would give a few hundred threads, so
// the grid is 2-D instead: column tiles of 32 x row chunks.  A block is
// 32 columns x 8 rows of threads; a warp reads 32 columns of one row.
// Each block keeps a shared (32 buckets x 32 columns) counter array —
// laid out bucket-major so the 32 lanes of a warp, one column each,
// add into 32 different banks — folds its rows into it with shared
// atomicAdd, and adds each nonzero counter to the global (C, 32) output
// with one atomicAdd.  Integer adds commute, so the output equals the
// plain version byte for byte in every run.  Blocks stride over the row
// chunks, so more than 65,535 chunks need no taller grid.  The wrapper
// (ops.py) sizes the chunks for about 2,048 blocks, so on the engines'
// path the stride is a guard; chip_smoke.py raises that target for one
// launch to run it.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kNB = 32;
constexpr int kHistCols = 32;
constexpr int kHistRows = 8;

__device__ __forceinline__ int latency_bucket(int32_t lat) {
  if (lat < 16) return lat < 0 ? 0 : lat;
  const int lg = 31 - __clz(lat);  // floor(log2(lat)), >= 4 here
  return min(16 + lg - 4, kNB - 1);
}

__global__ void latency_hist_kernel(const int32_t* __restrict__ base,
                                    const int32_t* __restrict__ delivered,
                                    const int64_t* __restrict__ cols,
                                    int32_t* __restrict__ hist, int n, int w,
                                    int ncols, int rows_per_chunk,
                                    int nchunks) {
  __shared__ int32_t counts[kNB][kHistCols];
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kHistCols + tx;
  constexpr int kThreads = kHistCols * kHistRows;
  for (int i = tid; i < kNB * kHistCols; i += kThreads) {
    counts[i / kHistCols][i % kHistCols] = 0;
  }
  __syncthreads();

  const int j = blockIdx.x * kHistCols + tx;
  const int32_t b = j < ncols ? base[j] : -1;
  if (b >= 0) {
    const size_t m = cols != nullptr ? static_cast<size_t>(cols[j])
                                     : static_cast<size_t>(j);
    for (int chunk = blockIdx.y; chunk < nchunks; chunk += gridDim.y) {
      const int p0 = chunk * rows_per_chunk;
      const int p1 = min(n, p0 + rows_per_chunk);
      for (int p = p0 + threadIdx.y; p < p1; p += kHistRows) {
        const int32_t d = delivered[static_cast<size_t>(p) * w + m];
        if (d >= 0) atomicAdd(&counts[latency_bucket(d - b)][tx], 1);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < kNB * kHistCols; i += kThreads) {
    const int bucket = i / kHistCols;
    const int c = i % kHistCols;
    const int jj = blockIdx.x * kHistCols + c;
    const int32_t v = counts[bucket][c];
    if (v != 0 && jj < ncols) {
      atomicAdd(hist + static_cast<size_t>(jj) * kNB + bucket, v);
    }
  }
}

}  // namespace repro_torch

extern "C" int rt_latency_hist(const void* base, const void* delivered,
                               const void* cols, void* hist, int n, int w,
                               int ncols, int rows_per_chunk, void* stream) {
  using namespace repro_torch;
  if (n > 0 && ncols > 0 && rows_per_chunk > 0) {
    const int nchunks = (n + rows_per_chunk - 1) / rows_per_chunk;
    const dim3 grid(
        static_cast<unsigned>((ncols + kHistCols - 1) / kHistCols),
        static_cast<unsigned>(nchunks < 65535 ? nchunks : 65535));
    latency_hist_kernel<<<grid, dim3(kHistCols, kHistRows), 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(delivered),
        static_cast<const int64_t*>(cols), static_cast<int32_t*>(hist), n, w,
        ncols, rows_per_chunk, nchunks);
  }
  return static_cast<int>(cudaGetLastError());
}
