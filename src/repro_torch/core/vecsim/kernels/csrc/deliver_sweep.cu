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
// chip_smoke.py.  The design is fused_sweep's single pass without the
// forward scatter (see sweep.cuh): one thread a cell, coalesced loads,
// arr read only where needed, delivered written only where it changes,
// counts folded by warp ballots.

#include "sweep.cuh"

extern "C" int rt_deliver_sweep(void* arr, void* delivered,
                                const void* crashed, const void* is_app,
                                void* napp, void* nping, int n, int w, int t,
                                void* stream) {
  using namespace repro_torch;
  if (n > 0 && w > 0) {
    deliver_kernel<false><<<sweep_grid(n, w), sweep_block(), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(arr), static_cast<int32_t*>(delivered),
        static_cast<const uint8_t*>(crashed),
        static_cast<const uint8_t*>(is_app), nullptr, nullptr, nullptr,
        static_cast<int32_t*>(napp), static_cast<int32_t*>(nping), n, w, 0,
        t);
  }
  return static_cast<int>(cudaGetLastError());
}
