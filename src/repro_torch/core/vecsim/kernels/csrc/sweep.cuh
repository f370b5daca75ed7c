// Shared layout of the per-round delivery sweeps (frontier_sweep.cu;
// deliver_sweep.cu and fused_sweep.cu have their own walks and take only
// the constants).
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
// "never" in the arrival planes: scenario.INF of the Python package
constexpr int32_t kInf = 1 << 30;
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

}  // namespace repro_torch
