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
// What bounds it: memory.  It must read tgt, the vals cells of the rows
// whose target is owned, and read and write each 32-byte dest sector
// that a sent value lowers (chip_smoke.py's _bound counts exactly these
// from the run's inputs): 0.0105 ms at the paper-scale churn shape (N =
// 50,000, W = 140, a 28 MB plane) and 0.179 ms at BENCH_scale's (N =
// 2^20, W = 128, 536 MB) on the H100 SXM's 3.35 TB/s.  The planes there
// are mostly INF, so the vals read is nearly all of it.  The design
// streams vals at the memory rate:
//
//   * a warp per unit of visiting rows: R whole rows (R = 512 / W, 1 to
//     32: 4 at W = 128, 3 at W = 140), or a 512-cell piece of one row
//     when W > 512, so a unit is at most 128 16-byte words, four a lane;
//     lane r < R reads row r's target, and the warp skips a unit whose
//     targets are all foreign, and a word whose rows are, without
//     reading their vals;
//   * vals read as 4-cell words (16-byte streaming loads) over the
//     unit's cells, which are contiguous.  When W is a multiple of 4
//     (and the planes 16-byte aligned) every word lies in one row and
//     the dest cells it may lower form one aligned word too, read at
//     once (ROW_WORDS: the general walk, dest cell by cell, measured
//     1.9x slower at the scale_scan_off shape); otherwise a word may
//     straddle two rows and a scalar head and tail cover the cells
//     before the unit's first and after its last whole word;
//   * a grid sized to the card (SMs x resident blocks, asked of the
//     runtime once a device: the queries cost as much host time as the
//     launch) whose warps walk the units in a pipeline: the targets of
//     the unit after next and the vals of the next unit are in flight
//     while the warp lowers dest by the current one.  Four words a lane
//     measured faster than eight on the card at both main-path shapes:
//     fewer registers, more warps;
//   * few atomics: an INF cell sends nothing; a sent value is first
//     compared with a plain read of its dest cell through L2 (coherent
//     with the atomics, not the read-only path), and atomicMin is issued
//     only where it is lower.  dest only falls during a hop, so a stale
//     read can only let a no-op atomic through.
//
// Duplicate targets are legal and int32 min commutes, so dest after the
// hop is byte-equal on every run and to the plain version.  In place is
// safe: dest is either the arrival plane, whose scattered values are all
// >= t + 1 and which nothing reads during the hop, or a fresh INF plane
// of pending contributions.

#include <atomic>

#include "sweep.cuh"

namespace repro_torch {

constexpr int kRingThreads = 128;
constexpr int kRingBatch = 4;                  // words a lane has in flight
constexpr int kRingWords = 32 * kRingBatch;    // words a unit at most
constexpr int kRingUnitCells = 4 * kRingWords;

// A warp's unit of work: R whole visiting rows (R = 512 / W, at most
// 32) when W <= 512, else a 512-cell piece of one row.
struct RingWalk {
  int rows;                   // visiting rows a unit, 1 to 32
  int per_row;                // units a row: 1, or ceil(W / 512)
  int units;
  unsigned long long div_w;   // ceil(2^32 / w): offset in a unit -> row
  int lead;                   // cells before vals' first 16-byte boundary
};

struct RingUnit {
  long long base;  // first cell of the unit's first row
  long long c0;    // its cells [c0, c1)
  long long c1;
  long long k0;    // its whole words [k0, k0 + nwords), at cells lead + 4 k
  int nwords;
  int row0, rows;
};

__device__ __forceinline__ RingUnit ring_unit(const RingWalk& rw, int n,
                                              int w, int u) {
  RingUnit un;
  if (rw.per_row == 1) {
    un.row0 = u * rw.rows;
    un.rows = min(rw.rows, n - un.row0);
    un.base = static_cast<long long>(un.row0) * w;
    un.c0 = un.base;
    un.c1 = un.base + static_cast<long long>(un.rows) * w;
  } else {
    un.row0 = u / rw.per_row;
    un.rows = 1;
    un.base = static_cast<long long>(un.row0) * w;
    un.c0 = un.base + static_cast<long long>(u % rw.per_row) * kRingUnitCells;
    un.c1 = min(un.c0 + kRingUnitCells, un.base + w);
  }
  un.k0 = (un.c0 - rw.lead + 3) >> 2;
  const long long k1 = (un.c1 - rw.lead) >> 2;
  un.nwords = k1 > un.k0 ? static_cast<int>(k1 - un.k0) : 0;
  return un;
}

// the row, within its unit, of the cell base + rel (exact while rel w <
// 2^32: a unit of more than one row has rel < 512)
__device__ __forceinline__ int ring_row(const RingWalk& rw, long long rel) {
  return rw.rows == 1 ? 0
                      : static_cast<int>(
                            (static_cast<unsigned long long>(rel) * rw.div_w) >>
                            32);
}

// one cell: lower dest[tq, col] to v where v is sent and lower
__device__ __forceinline__ void ring_cell(int32_t* dest, int tq, int w,
                                          int col, int32_t v) {
  if (tq < 0 || v == kInf) return;
  int32_t* cell = dest + static_cast<size_t>(tq) * w + col;
  if (v < __ldcg(cell)) atomicMin(cell, v);
}

// The raw target of lane r's row of unit u, read ahead of its use so
// that the load stays in flight; off - 1 (foreign) past the unit's rows.
__device__ __forceinline__ int ring_target(const RingWalk& rw, int n, int w,
                                           const int32_t* __restrict__ tgt,
                                           int off, int u, int lane) {
  int raw = off - 1;
  if (u < rw.units) {
    const RingUnit un = ring_unit(rw, n, w, u);
    if (lane < un.rows) raw = __ldg(tgt + un.row0 + lane);
  }
  return raw;
}

// A unit's words in flight: their vals and each cell's local target row.
template <bool ROW_WORDS>
struct RingBatch {
  int4 v[kRingBatch];
  int tq[kRingBatch][ROW_WORDS ? 1 : 4];
};

// Issue the vals loads of every word of unit u that holds a cell of an
// owned row; tl is the lane's local target (-1 foreign).
template <bool ROW_WORDS>
__device__ __forceinline__ void ring_issue(const RingWalk& rw, int n, int w,
                                           const int32_t* __restrict__ vals,
                                           int u, int tl, int lane,
                                           RingBatch<ROW_WORDS>& bt) {
  const RingUnit un = ring_unit(rw, n, w, u);
  const bool any = __ballot_sync(kFullMask, tl >= 0) != 0;
#pragma unroll
  for (int i = 0; i < kRingBatch; ++i) {
    const int idx = i * 32 + lane;
    const long long f = rw.lead + 4 * (un.k0 + idx);  // the word's first cell
    const bool has = any && idx < un.nwords;
    bool owned = false;
#pragma unroll
    for (int e = 0; e < (ROW_WORDS ? 1 : 4); ++e) {
      const int r = has ? ring_row(rw, f + e - un.base) : 0;
      bt.tq[i][e] = __shfl_sync(kFullMask, tl, r & 31);
      owned |= has && bt.tq[i][e] >= 0;
    }
    bt.v[i] = owned ? __ldcs(reinterpret_cast<const int4*>(vals + f))
                    : make_int4(kInf, kInf, kInf, kInf);
  }
}

// Lower dest by unit u's words (loaded by ring_issue) and, when words may
// straddle rows, by its head and tail cells.
template <bool ROW_WORDS>
__device__ __forceinline__ void ring_process(
    const RingWalk& rw, int n, int w, int32_t* dest,
    const int32_t* __restrict__ vals, int u, int tl, int lane,
    const RingBatch<ROW_WORDS>& bt) {
  const RingUnit un = ring_unit(rw, n, w, u);
  if (ROW_WORDS) {
    // every dest word first, then the compares and atomics
    int4 d[kRingBatch];
    int32_t* cell[kRingBatch];
#pragma unroll
    for (int i = 0; i < kRingBatch; ++i) {
      const int4 x = bt.v[i];
      cell[i] = nullptr;
      d[i] = make_int4(kInf, kInf, kInf, kInf);
      if (x.x == kInf && x.y == kInf && x.z == kInf && x.w == kInf) continue;
      const long long rel = rw.lead + 4 * (un.k0 + i * 32 + lane) - un.base;
      const int r = ring_row(rw, rel);
      const int col = static_cast<int>(rel - static_cast<long long>(r) * w);
      cell[i] = dest + static_cast<size_t>(bt.tq[i][0]) * w + col;
      d[i] = __ldcg(reinterpret_cast<const int4*>(cell[i]));
    }
#pragma unroll
    for (int i = 0; i < kRingBatch; ++i) {
      if (cell[i] == nullptr) continue;
      const int4 x = bt.v[i];
      if (x.x != kInf && x.x < d[i].x) atomicMin(cell[i], x.x);
      if (x.y != kInf && x.y < d[i].y) atomicMin(cell[i] + 1, x.y);
      if (x.z != kInf && x.z < d[i].z) atomicMin(cell[i] + 2, x.z);
      if (x.w != kInf && x.w < d[i].w) atomicMin(cell[i] + 3, x.w);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kRingBatch; ++i) {
    const int4 x = bt.v[i];
    if (x.x == kInf && x.y == kInf && x.z == kInf && x.w == kInf) continue;
    const long long rel = rw.lead + 4 * (un.k0 + i * 32 + lane) - un.base;
    const int32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ring_row(rw, rel + e);
      ring_cell(dest, bt.tq[i][ROW_WORDS ? 0 : e], w,
                static_cast<int>(rel + e - static_cast<long long>(r) * w),
                xs[e]);
    }
  }
  // the head (before the first whole word) and tail (after the last)
  // cells, a lane each; all cells when there is no whole word (at most
  // 6 then)
  const long long wa = un.nwords > 0 ? rw.lead + 4 * un.k0 : un.c1;
  const long long wb = un.nwords > 0 ? wa + 4LL * un.nwords : un.c1;
  const int nhead = static_cast<int>(wa - un.c0);
  const int ntail = static_cast<int>(un.c1 - wb);
  long long f = -1;
  if (lane < nhead) {
    f = un.c0 + lane;
  } else if (lane < nhead + ntail) {
    f = wb + lane - nhead;
  }
  const int r = f >= 0 ? ring_row(rw, f - un.base) : 0;
  const int tq = __shfl_sync(kFullMask, tl, r & 31);
  if (f >= 0 && tq >= 0) {
    ring_cell(dest, tq, w,
              static_cast<int>(f - un.base - static_cast<long long>(r) * w),
              __ldcs(vals + f));
  }
}

__device__ __forceinline__ int ring_local(int raw, int off, int n) {
  const long long v = static_cast<long long>(raw) - off;
  return v >= 0 && v < n ? static_cast<int>(v) : -1;
}

// ROW_WORDS: w % 4 == 0 and both planes 16-byte aligned (lead 0), so
// every word lies in one row and its dest cells form one aligned word.
// A warp walks the units u, u + warps, ... in a pipeline: the targets
// of the unit after next and the vals of the next unit are in flight
// while it lowers dest by the current one.
template <bool ROW_WORDS>
__global__ void __launch_bounds__(kRingThreads)
    ring_apply_kernel(int32_t* dest, const int32_t* __restrict__ vals,
                      const int32_t* __restrict__ tgt, int n, int w, int off,
                      RingWalk rw) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kRingThreads / 32);
  int u = blockIdx.x * (kRingThreads / 32) + (threadIdx.x >> 5);
  if (u >= rw.units) return;
  int tl = ring_local(ring_target(rw, n, w, tgt, off, u, lane), off, n);
  RingBatch<ROW_WORDS> cur, nxt;
  ring_issue<ROW_WORDS>(rw, n, w, vals, u, tl, lane, cur);
  int raw_next = ring_target(rw, n, w, tgt, off, u + warps, lane);
  for (; u < rw.units; u += warps) {
    const int un = u + warps;
    const int tl_next = ring_local(raw_next, off, n);
    if (un < rw.units)
      ring_issue<ROW_WORDS>(rw, n, w, vals, un, tl_next, lane, nxt);
    raw_next = ring_target(rw, n, w, tgt, off, un + warps, lane);
    ring_process<ROW_WORDS>(rw, n, w, dest, vals, u, tl, lane, cur);
    cur = nxt;
    tl = tl_next;
  }
}

template <bool ROW_WORDS>
int launch_ring(int32_t* dest, const int32_t* vals, const int32_t* tgt,
                int n, int w, int off, const RingWalk& rw,
                cudaStream_t stream) {
  const auto kernel = ring_apply_kernel<ROW_WORDS>;
  // the resident blocks of the card (SMs x blocks an SM), asked once a
  // device: the queries cost as much host time as a launch
  constexpr int kDevices = 64;
  static std::atomic<int> fill_of[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int fill = fill_of[dev].load(std::memory_order_relaxed);
  if (fill == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kRingThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    fill = sms * (per_sm > 0 ? per_sm : 1);
    fill_of[dev].store(fill, std::memory_order_relaxed);
  }
  constexpr int kWarps = kRingThreads / 32;
  const long long need = (static_cast<long long>(rw.units) + kWarps - 1) /
                         kWarps;
  const int blocks = static_cast<int>(need < fill ? need : fill);
  kernel<<<blocks, kRingThreads, 0, stream>>>(dest, vals, tgt, n, w, off, rw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" int rt_ring_apply(void* dest, const void* vals, const void* tgt,
                             int n, int w, int off, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  RingWalk rw;
  if (w <= kRingUnitCells) {
    const int rows = kRingUnitCells / w;
    rw.rows = rows > 32 ? 32 : rows;
    rw.per_row = 1;
    rw.units = (n + rw.rows - 1) / rw.rows;
  } else {
    rw.rows = 1;
    rw.per_row = (w + kRingUnitCells - 1) / kRingUnitCells;
    const long long units = static_cast<long long>(n) * rw.per_row;
    if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    rw.units = static_cast<int>(units);
  }
  rw.div_w = ((1ull << 32) + w - 1) / w;
  const uintptr_t va = reinterpret_cast<uintptr_t>(vals);
  rw.lead = static_cast<int>(((16 - va % 16) % 16) / 4);
  const bool row_words = w % 4 == 0 && rw.lead == 0 &&
                         reinterpret_cast<uintptr_t>(dest) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<int32_t*>(dest);
  const auto* v = static_cast<const int32_t*>(vals);
  const auto* t = static_cast<const int32_t*>(tgt);
  return row_words ? launch_ring<true>(d, v, t, n, w, off, rw, st)
                   : launch_ring<false>(d, v, t, n, w, off, rw, st);
}
