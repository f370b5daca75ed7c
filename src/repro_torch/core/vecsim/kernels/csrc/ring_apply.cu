// ring_apply: one hop of the sharded engine's frontier exchange.  The
// visiting plane vals (one link slot's contributions from the shard that
// built it) lowers the rows this shard owns:
//
//   dest[tgt[p] - off, m] = min(dest[tgt[p] - off, m], vals[p, m])
//
// for every visiting row p whose global target row tgt[p] lies in
// [off, off + n_loc); rows aimed at another shard are dropped (they are
// applied there, at another hop).  dest is updated in place.
//
// Replaces the TPU kernel ring_apply_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by ring_apply in
// ops.py of that package).  The generic round body calls it once per
// link slot per ring hop, world hops a slot.
//
// What bounds it: memory.  It must read tgt, the vals cells of owned
// rows, and read-modify-write the dest cells that a sent value lowers:
// at the paper-scale churn shape (N = 50,000, W = 140) the vals plane
// is 28 MB, 0.008 ms at the H100 SXM's 3.35 TB/s; chip_smoke.py counts
// the bound from the run's own inputs.  The design is the owner-local
// scatter-min: one thread a cell, a warp on 32 neighbouring columns of
// one visiting row (coalesced), each row's target read once; a cell is
// skipped when its row's target is not owned (so its vals are not even
// read) or its value is INF (nothing sent), else it does one int32
// atomicMin.  Duplicate targets are legal and int32 min commutes, so
// dest after the hop is byte-equal on every run and to the plain
// version.  In place is safe: dest is either the arrival plane, whose
// scattered values are all >= t + 1 and which nothing reads during the
// hop, or a fresh INF plane of pending contributions.

#include "sweep.cuh"

namespace repro_torch {

__global__ void ring_apply_kernel(int32_t* dest,
                                  const int32_t* __restrict__ vals,
                                  const int32_t* __restrict__ tgt, int n,
                                  int w, int off) {
  const int m = blockIdx.x * kSweepCols + threadIdx.x;
  if (m >= w) return;
  for (int p = blockIdx.y * kSweepRows + threadIdx.y; p < n;
       p += gridDim.y * kSweepRows) {
    const int tl = tgt[p] - off;
    if (tl < 0 || tl >= n) continue;
    const int32_t v = vals[static_cast<size_t>(p) * w + m];
    if (v != kInf) atomicMin(dest + static_cast<size_t>(tl) * w + m, v);
  }
}

}  // namespace repro_torch

extern "C" int rt_ring_apply(void* dest, const void* vals, const void* tgt,
                             int n, int w, int off, void* stream) {
  using namespace repro_torch;
  if (n > 0 && w > 0) {
    ring_apply_kernel<<<sweep_grid(n, w), sweep_block(), 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(dest), static_cast<const int32_t*>(vals),
        static_cast<const int32_t*>(tgt), n, w, off);
  }
  return static_cast<int>(cudaGetLastError());
}
