// frontier_sweep: phases 7 and 8 of a gated round on the card — the
// flush of buffered app messages over links whose pong arrived, and the
// forward of this round's deliveries over safe links, in one
// scatter-min, with the count of flushed sends.
//
// Replaces the TPU kernel frontier_sweep_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by frontier_sweep
// in ops.py of that package).
//
// What bounds it: memory.  It must read the post-delivery delivered
// plane once, the (N, K) slot tables of the rows that send, and the arr
// cells it lowers.  At the paper-scale churn shape (N = 50,000, W = 140,
// K = 17) the plane is 28 MB and the whole tables 11.9 MB, at most
// 0.012 ms at the H100 SXM's 3.35 TB/s; chip_smoke.py counts the bound
// from the run's own inputs.  The design makes one
// pass over the plane, one thread a cell (see sweep.cuh); a cell that
// can neither flush (an app column delivered before t) nor forward
// (delivered at t) skips the slot loop, whose per-row table reads are
// the same address across the warp.  The flushed-send count is reduced
// per warp and per block and added once per block to an int64 counter;
// it equals the JAX kernel's int32 sum wherever that sum does not wrap
// (N * W * K = 1.19e8 at the churn shape, far under 2^31).

#include "sweep.cuh"

namespace repro_torch {

__global__ void frontier_kernel(int32_t* arr,
                                const int32_t* __restrict__ delivered,
                                const int32_t* __restrict__ adj,
                                const int32_t* __restrict__ delay,
                                const int32_t* __restrict__ gate,
                                const uint8_t* __restrict__ flushing,
                                const uint8_t* __restrict__ fwd_ok,
                                const uint8_t* __restrict__ is_app,
                                unsigned long long* __restrict__ flush_sent,
                                int n, int w, int k, int t) {
  __shared__ int warp_sums[kSweepRows];
  const int m = blockIdx.x * kSweepCols + threadIdx.x;
  const bool in = m < w;
  const bool app = in && is_app[m] != 0;
  int flushed = 0;
  for (int p = blockIdx.y * kSweepRows + threadIdx.y; p < n;
       p += gridDim.y * kSweepRows) {
    if (!in) continue;
    const int32_t d = delivered[static_cast<size_t>(p) * w + m];
    const bool now = d == t;
    const bool before = app && d < t;
    if (!now && !before) continue;
    const size_t row = static_cast<size_t>(p) * k;
    for (int kk = 0; kk < k; ++kk) {
      const bool win = before && flushing[row + kk] && d >= gate[row + kk];
      flushed += win;
      if (win || (now && fwd_ok[row + kk])) {
        scatter_min(arr, adj[row + kk], n, w, m, t + delay[row + kk]);
      }
    }
  }
  flushed = __reduce_add_sync(kFullMask, flushed);
  if (threadIdx.x == 0) warp_sums[threadIdx.y] = flushed;
  __syncthreads();
  if (threadIdx.y == 0) {
    int v = threadIdx.x < kSweepRows ? warp_sums[threadIdx.x] : 0;
    v = __reduce_add_sync(kFullMask, v);
    if (threadIdx.x == 0 && v != 0) {
      atomicAdd(flush_sent, static_cast<unsigned long long>(v));
    }
  }
}

}  // namespace repro_torch

extern "C" int rt_frontier_sweep(void* arr, const void* delivered,
                                 const void* adj, const void* delay,
                                 const void* gate, const void* flushing,
                                 const void* fwd_ok, const void* is_app,
                                 void* flush_sent, int n, int w, int k, int t,
                                 void* stream) {
  using namespace repro_torch;
  if (n > 0 && w > 0) {
    frontier_kernel<<<sweep_grid(n, w), sweep_block(), 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(arr), static_cast<const int32_t*>(delivered),
        static_cast<const int32_t*>(adj), static_cast<const int32_t*>(delay),
        static_cast<const int32_t*>(gate),
        static_cast<const uint8_t*>(flushing),
        static_cast<const uint8_t*>(fwd_ok),
        static_cast<const uint8_t*>(is_app),
        static_cast<unsigned long long*>(flush_sent), n, w, k, t);
  }
  return static_cast<int>(cudaGetLastError());
}
