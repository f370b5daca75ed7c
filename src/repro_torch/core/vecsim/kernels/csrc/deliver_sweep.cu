// deliver_sweep: phase 5 of a gated round on the card, with the per-row
// app/ping delivery counts.
//
// Replaces the TPU kernel deliver_sweep_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by deliver_sweep in
// ops.py of that package).  It runs every round of a run with link
// additions, before pong detection, which must see the round's
// deliveries.
//
// What bounds it: memory.  It must read the delivered plane once, and
// arr only where a cell is still undelivered on a live row.  At the
// paper-scale churn shape (N = 50,000, W = 140 columns) delivered is
// 28 MB, 0.008 ms at the H100 SXM's 3.35 TB/s, and arr adds up to as
// much again, counted in 32-byte sectors from the run's own inputs by
// chip_smoke.py.  The design is one pass over the plane (see
// sweep.cuh): one thread a cell, coalesced loads, arr read only where
// needed, delivered written only where it changes, counts folded by
// warp ballots.

#include "sweep.cuh"

namespace repro_torch {

// Phase 5 and the per-row delivery counts.  delivered is written only
// by the thread that owns the cell, and only where it changes.
__global__ void deliver_kernel(const int32_t* __restrict__ arr,
                               int32_t* __restrict__ delivered,
                               const uint8_t* __restrict__ crashed,
                               const uint8_t* __restrict__ is_app,
                               int32_t* __restrict__ napp,
                               int32_t* __restrict__ nping, int n, int w,
                               int t) {
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
  }
}

}  // namespace repro_torch

extern "C" int rt_deliver_sweep(void* arr, void* delivered,
                                const void* crashed, const void* is_app,
                                void* napp, void* nping, int n, int w, int t,
                                void* stream) {
  using namespace repro_torch;
  if (n > 0 && w > 0) {
    deliver_kernel<<<sweep_grid(n, w), sweep_block(), 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(arr), static_cast<int32_t*>(delivered),
        static_cast<const uint8_t*>(crashed),
        static_cast<const uint8_t*>(is_app), static_cast<int32_t*>(napp),
        static_cast<int32_t*>(nping), n, w, t);
  }
  return static_cast<int>(cudaGetLastError());
}
