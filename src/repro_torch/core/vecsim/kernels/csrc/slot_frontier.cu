// slot_frontier: one link slot's contribution plane for the sharded
// engine's frontier exchange, with the count of flushed sends.  For the
// local rows p and every column m:
//
//   vals[p, m] = t + delay[p]  where the row forwards (fwd[p]) a
//                              delivery of this round (delivered == t),
//                              or, with gating, flushes (do[p]) an app
//                              column delivered in [gate[p], t);
//              = INF           elsewhere,
//
// and win_cnt counts the flushed (row, column) cells.
//
// Replaces the TPU kernel slot_frontier_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by slot_frontier in
// ops.py of that package).  The generic round body of the sharded
// engine calls it once per link slot per round; the plane then rides
// the ring and ring_apply.cu scatters it into the rows each shard owns.
//
// What bounds it: memory.  It must read the delivered plane once and
// write the vals plane once, 8 bytes a cell: 56 MB at the paper-scale
// churn shape (N = 50,000, W = 140), 0.017 ms at the H100 SXM's
// 3.35 TB/s; chip_smoke.py recounts it from the run's own inputs.  A
// few integer operations a cell are far below the card's rate.  The
// design is one elementwise pass on a 2-D grid, column tiles x row
// blocks that stride over the rows (gridDim.y is capped at 65,535): a
// thread owns one column, or four neighbouring columns read and written
// as one 16-byte vector when W % 4 == 0 (and the planes are 16-byte
// aligned), and loads each row's gate,
// delay, do and fwd once for all of them.  The whole plane is written,
// INF where nothing is sent, so the output needs no memset.  The
// flushed count is reduced per warp and per block and added once per
// block to an int32 counter; the wrapper (ops.py) refuses planes of
// 2^31 cells or more, so the count cannot wrap.

#include "sweep.cuh"

namespace repro_torch {

template <int V>
__device__ __forceinline__ void load_cells(const int32_t* p, int32_t* d) {
  if constexpr (V == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
  } else {
    d[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_cells(int32_t* p, const int32_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// V cells a thread: 4 (vectorized, W % 4 == 0) or 1.
template <int V>
__global__ void slot_frontier_kernel(const int32_t* __restrict__ delivered,
                                     const int32_t* __restrict__ gate,
                                     const int32_t* __restrict__ delay,
                                     const uint8_t* __restrict__ do_k,
                                     const uint8_t* __restrict__ fwd_k,
                                     const uint8_t* __restrict__ is_app,
                                     int32_t* __restrict__ vals,
                                     int32_t* __restrict__ win_cnt, int n,
                                     int w, int t, int gating) {
  __shared__ int warp_sums[kSweepRows];
  const int m0 = (blockIdx.x * kSweepCols + threadIdx.x) * V;
  const bool in = m0 < w;
  bool app[V];
#pragma unroll
  for (int v = 0; v < V; ++v) app[v] = in && gating && is_app[m0 + v] != 0;
  int flushed = 0;
  for (int p = blockIdx.y * kSweepRows + threadIdx.y; p < n;
       p += gridDim.y * kSweepRows) {
    if (!in) continue;
    const int32_t dk = t + delay[p];
    const bool fwd = fwd_k[p] != 0;
    const bool fl = gating && do_k[p] != 0;
    const int32_t g = gate[p];
    const size_t idx = static_cast<size_t>(p) * w + m0;
    int32_t d[V], out[V];
    load_cells<V>(delivered + idx, d);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool win = fl && app[v] && d[v] >= g && d[v] < t;
      flushed += win;
      // forward and flush both send t + delay over this link
      out[v] = (win || (fwd && d[v] == t)) ? dk : kInf;
    }
    store_cells<V>(vals + idx, out);
  }
  flushed = __reduce_add_sync(kFullMask, flushed);
  if (threadIdx.x == 0) warp_sums[threadIdx.y] = flushed;
  __syncthreads();
  if (threadIdx.y == 0) {
    int s = threadIdx.x < kSweepRows ? warp_sums[threadIdx.x] : 0;
    s = __reduce_add_sync(kFullMask, s);
    if (threadIdx.x == 0 && s != 0) atomicAdd(win_cnt, s);
  }
}

}  // namespace repro_torch

extern "C" int rt_slot_frontier(const void* delivered, const void* gate,
                                const void* delay, const void* do_k,
                                const void* fwd_k, const void* is_app,
                                void* vals, void* win_cnt, int n, int w,
                                int t, int gating, void* stream) {
  using namespace repro_torch;
  if (n > 0 && w > 0) {
    // 16-byte cells need W % 4 == 0 and 16-byte aligned planes
    const bool vec = w % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(delivered) |
                       reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
    const int cols = vec ? w / 4 : w;
    const dim3 grid = sweep_grid(n, cols);
    const auto kernel = vec ? slot_frontier_kernel<4>
                            : slot_frontier_kernel<1>;
    kernel<<<grid, sweep_block(), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(delivered),
        static_cast<const int32_t*>(gate), static_cast<const int32_t*>(delay),
        static_cast<const uint8_t*>(do_k), static_cast<const uint8_t*>(fwd_k),
        static_cast<const uint8_t*>(is_app), static_cast<int32_t*>(vals),
        static_cast<int32_t*>(win_cnt), n, w, t, gating);
  }
  return static_cast<int>(cudaGetLastError());
}
