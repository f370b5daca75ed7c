// fused_sweep: the gating-free round on the card (phases 5 and 8).
//
// Replaces the TPU kernel fused_sweep_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by fused_sweep in
// ops.py of that package).  It runs every round of a run without link
// additions: the sustained-traffic main path.
//
// What bounds it: memory.  Each round it must read the delivered plane
// once, and arr only where a cell is still undelivered on a live row
// (elsewhere the output ignores arr), plus the cells the scatter lowers.
// At the sustained shape (N = 10,000 processes, W = 16,384 live columns)
// delivered alone is 655 MB, 0.20 ms at the H100 SXM's 3.35 TB/s; arr
// adds up to another 655 MB, counted in 32-byte sectors from the run's
// own inputs by chip_smoke.py.  Its integer work is about ten operations
// a cell, far below the card's rate.  The design makes one pass over the
// planes: one thread a cell, coalesced row-major loads, arr read only
// where the cell is still undelivered, delivered written only where it
// changes, the per-row counts folded by warp ballots into one atomicAdd
// per warp and row, and the forward scatter done by the cells delivered
// this round with int32 atomicMin (see sweep.cuh).

#include "sweep.cuh"

extern "C" int rt_fused_sweep(void* arr, void* delivered, const void* crashed,
                              const void* is_app, const void* adj,
                              const void* delay, const void* fwd_ok,
                              void* napp, void* nping, int n, int w, int k,
                              int t, void* stream) {
  using namespace repro_torch;
  if (n > 0 && w > 0) {
    deliver_kernel<true><<<sweep_grid(n, w), sweep_block(), 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(arr), static_cast<int32_t*>(delivered),
        static_cast<const uint8_t*>(crashed),
        static_cast<const uint8_t*>(is_app),
        static_cast<const int32_t*>(adj), static_cast<const int32_t*>(delay),
        static_cast<const uint8_t*>(fwd_ok), static_cast<int32_t*>(napp),
        static_cast<int32_t*>(nping), n, w, k, t);
  }
  return static_cast<int>(cudaGetLastError());
}
