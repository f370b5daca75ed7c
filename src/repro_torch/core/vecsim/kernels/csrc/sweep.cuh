// Shared layout of the per-round delivery sweeps (fused_sweep.cu,
// deliver_sweep.cu, frontier_sweep.cu).
//
// The (N, W) planes are row-major int32: row p is a process, column m a
// live message column.  One thread owns one (p, m) cell.  A block is
// kSweepCols x kSweepRows threads; threadIdx.x runs along the columns,
// so a warp is 32 neighbouring columns of one row and its loads of a
// plane coalesce into one 128-byte line.  Blocks stride over the rows
// (gridDim.y is capped at 65535), so every warp stays on one row for
// each iteration and warp-wide ballots and reductions are well formed.
//
// Scatter-min into arr: a cell (p, m) that sends on slot k lowers
// arr[adj[p, k], m] to t + delay[p, k] with atomicMin.  int32 min
// commutes, so the plane after the sweep does not depend on the order
// of the atomics and equals the plain version byte for byte.  A target
// outside [0, N) is dropped.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSweepCols = 32;
constexpr int kSweepRows = 8;

inline dim3 sweep_grid(int n, int w) {
  unsigned gy = static_cast<unsigned>((n + kSweepRows - 1) / kSweepRows);
  if (gy > 65535u) gy = 65535u;
  return dim3(static_cast<unsigned>((w + kSweepCols - 1) / kSweepCols), gy);
}

inline dim3 sweep_block() { return dim3(kSweepCols, kSweepRows); }

__device__ __forceinline__ void scatter_min(int32_t* arr, int q, int n,
                                            int w, int m, int32_t value) {
  if (q >= 0 && q < n) {
    atomicMin(arr + static_cast<size_t>(q) * w + m, value);
  }
}

// Phase 5 and the per-row delivery counts; with kForward also the
// gating-free forward scatter (phase 8) of the cells delivered at t.
//
// arr is updated in place by the scatter while other threads read it.
// That is safe: every scattered value is t + delay >= t + 1, so no
// concurrent atomicMin can change whether a cell equals t, which is the
// only question this sweep asks of arr.  delivered is written only by
// the thread that owns the cell, and only where it changes.
template <bool kForward>
__global__ void deliver_kernel(int32_t* arr, int32_t* __restrict__ delivered,
                               const uint8_t* __restrict__ crashed,
                               const uint8_t* __restrict__ is_app,
                               const int32_t* __restrict__ adj,
                               const int32_t* __restrict__ delay,
                               const uint8_t* __restrict__ fwd_ok,
                               int32_t* __restrict__ napp,
                               int32_t* __restrict__ nping, int n, int w,
                               int k, int t) {
  const int m = blockIdx.x * kSweepCols + threadIdx.x;
  const bool in = m < w;
  const bool app = in && is_app[m] != 0;
  for (int p = blockIdx.y * kSweepRows + threadIdx.y; p < n;
       p += gridDim.y * kSweepRows) {
    const size_t idx = static_cast<size_t>(p) * w + m;
    bool now = false;  // the cell's delivery round is t after phase 5
    if (in) {
      const int32_t d = delivered[idx];
      if (d < 0) {
        if (crashed[p] == 0 && arr[idx] == t) {
          delivered[idx] = t;
          now = true;
        }
      } else {
        now = d == t;
      }
    }
    const unsigned ba = __ballot_sync(kFullMask, now && app);
    const unsigned bp = __ballot_sync(kFullMask, now && !app);
    if (threadIdx.x == 0) {
      if (ba) atomicAdd(napp + p, __popc(ba));
      if (bp) atomicAdd(nping + p, __popc(bp));
    }
    if (kForward && now) {
      const size_t row = static_cast<size_t>(p) * k;
      for (int kk = 0; kk < k; ++kk) {
        if (fwd_ok[row + kk]) {
          scatter_min(arr, adj[row + kk], n, w, m, t + delay[row + kk]);
        }
      }
    }
  }
}

}  // namespace repro_torch
