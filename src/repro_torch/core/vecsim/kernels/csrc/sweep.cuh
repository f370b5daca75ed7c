// Shared constants of the per-round sweeps, and the layout of
// slot_frontier.cu (deliver_sweep.cu, frontier_sweep.cu, fused_sweep.cu
// and ring_apply.cu have their own walks and take only the constants).
//
// The (N, W) planes are row-major int32: row p is a process, column m a
// live message column.  In the layout, one thread owns one (p, m) cell
// (or a 4-cell word).  A block is kSweepCols x kSweepRows threads;
// threadIdx.x runs along the columns, so a warp is 32 neighbouring
// columns of one row and its loads of a plane coalesce into one 128-byte
// line.  Blocks stride over the rows (gridDim.y is capped at 65535), so
// every warp stays on one row for each iteration and warp-wide ballots
// and reductions are well formed.

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

}  // namespace repro_torch
