// deliver_sweep: phase 5 of a gated round on the card, with the per-row
// app/ping delivery counts:
//
//   delivered[p, m] = t  where delivered[p, m] < 0, row p is not crashed
//                        and arr[p, m] == t;
//   napp[p] / nping[p] = the app / ping columns m of row p with
//                        delivered[p, m] == t afterwards.
//
// Replaces the TPU kernel deliver_sweep_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by deliver_sweep in
// ops.py of that package).  It runs every round of a run with link
// additions, before pong detection, which must see the round's
// deliveries, and every round of the sharded engine's generic body.
//
// What bounds it: memory.  It must read the delivered plane once, arr
// only where a cell is still undelivered on a live row, and write the
// delivered sectors that change: at the paper-scale churn shape (N =
// 50,000, W = 140) 0.014 ms, at BENCH_scale's (N = 2^20, W = 128, a
// 512 MiB plane) 0.31 ms on the H100 SXM's 3.35 TB/s (chip_smoke.py's
// _bound counts these bytes from the run's inputs).  A thread a cell
// (the design this replaces) left a dependent chain of three loads
// (delivered, crashed, arr) on every cell, lanes idle past W in the last
// column block, and two atomics a warp and row.  The design:
//
//   * a warp per unit of rows: R = 512 / W whole rows (1 to 32: 3 at W =
//     140, 4 at W = 128), read as 4-cell words (16-byte loads) from
//     delivered's first 16-byte boundary, at most 128 words a unit, four
//     a lane; past W = 512 a unit is one row, walked in pieces of 512
//     cells.  R rows rather than a 128-column tile: a tile leaves lanes
//     idle past W (29 of 64 at W = 140), a unit at most the last
//     quarter's;
//   * crashed read once a row (a lane a row, one ballot), issued with the
//     delivered words; the arr word only where one of its cells is
//     undelivered on a live row, after all the delivered words are in
//     flight; a delivered word written only where a cell changes;
//   * when W is a multiple of 4 (and the planes and is_app are aligned)
//     every word lies in one row and its is_app bytes are one 32-bit
//     load (ROW_WORDS); otherwise words may straddle rows and a scalar
//     head and tail cover the cells before the unit's first and after
//     its last whole word (a lane each);
//   * the counts folded by warp reductions, the app count in the low and
//     the ping count in the high half of one integer (at most 512 a row
//     and piece), into lane r for row r; one plain store of napp[p] and
//     nping[p] a row: no atomics, so the wrapper allocates them without
//     a fill.
//
// A warp a unit and a grid of one warp a unit measured fastest at both
// main-path shapes: persistent warps with the next unit's words in
// flight, 8 words a lane, blocks of 128 threads and a cap of 64 registers
// were each no faster at one shape or slower at the other, and
// evict-first reads of delivered slower at N = 2^20, where the words it
// then writes must come back (PERF.md).

#include "sweep.cuh"

namespace repro_torch {

constexpr int kDeliverThreads = 256;
constexpr int kDeliverBatch = 4;                        // words a lane
constexpr int kDeliverPieceCells = 4 * 32 * kDeliverBatch;  // 512
constexpr int kPingUnit = 1 << 16;  // a ping delivery in a packed count

// A warp's unit of work: R whole rows (R = 512 / W, at most 32) when W
// <= 512, else one row in pieces of 512 cells.
struct DeliverWalk {
  int rows;                   // rows of a unit, 1 to 32
  int units;
  unsigned long long div_w;   // ceil(2^32 / w): offset in a unit -> row
  int lead;                   // cells before delivered's first 16-byte
                              // boundary
  int arr_words;              // arr has the same lead: int4 loads
};

// the row, within its unit, of the cell base + rel (exact while rel w <
// 2^32: a unit of more than one row has rel < 512)
__device__ __forceinline__ int unit_row(const DeliverWalk& dw,
                                        long long rel) {
  return dw.rows == 1
             ? 0
             : static_cast<int>(
                   (static_cast<unsigned long long>(rel) * dw.div_w) >> 32);
}

__device__ __forceinline__ int word_cell(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Cells [p0, p1) of the unit whose first cell is base: deliver them and
// add each row's packed count to lane r for row r (app, ping).
template <bool ROW_WORDS>
__device__ __forceinline__ void deliver_piece(
    const DeliverWalk& dw, const int32_t* __restrict__ arr,
    int32_t* __restrict__ delivered, const uint8_t* __restrict__ is_app,
    int w, int t, long long base, long long p0, long long p1,
    uint8_t crashed_lane, int lane, int& app, int& ping) {
  // the piece's whole words: cells lead + 4 k, k in [k0, k0 + nwords)
  const long long k0 = (p0 - dw.lead + 3) >> 2;
  const long long k1 = (p1 - dw.lead) >> 2;
  const int nwords = k1 > k0 ? static_cast<int>(k1 - k0) : 0;
  // the head (before the first whole word) and tail (after the last)
  // cells, a lane each; every cell when there is no whole word (at most 6)
  const long long wa = nwords > 0 ? dw.lead + 4 * k0 : p1;
  const long long wb = nwords > 0 ? wa + 4LL * nwords : p1;
  const int nhead = static_cast<int>(wa - p0);
  const int ntail = static_cast<int>(p1 - wb);
  long long hf = -1;  // this lane's head or tail cell
  if (!ROW_WORDS) {
    if (lane < nhead) {
      hf = p0 + lane;
    } else if (lane < nhead + ntail) {
      hf = wb + lane - nhead;
    }
  }

  // 1. every delivered word (and head or tail cell) in flight
  int4 d[kDeliverBatch];
#pragma unroll
  for (int i = 0; i < kDeliverBatch; ++i) {
    const int idx = i * 32 + lane;
    d[i] = idx < nwords ? *reinterpret_cast<const int4*>(
                              delivered + dw.lead + 4 * (k0 + idx))
                        : make_int4(0, 0, 0, 0);
  }
  const int32_t hd = hf >= 0 ? delivered[hf] : 0;
  const unsigned dead = __ballot_sync(kFullMask, crashed_lane != 0);

  // 2. each cell's row; the arr words a live undelivered cell needs
  int row[kDeliverBatch][ROW_WORDS ? 1 : 4];
  unsigned need[kDeliverBatch];
  int4 av[kDeliverBatch];
#pragma unroll
  for (int i = 0; i < kDeliverBatch; ++i) {
    const long long f = dw.lead + 4 * (k0 + i * 32 + lane) - base;
    const bool has = i * 32 + lane < nwords;
    need[i] = 0;
#pragma unroll
    for (int e = 0; e < (ROW_WORDS ? 1 : 4); ++e)
      row[i][e] = has ? unit_row(dw, f + e) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[i][ROW_WORDS ? 0 : e];
      if (has && word_cell(d[i], e) < 0 && !(dead >> r & 1u))
        need[i] |= 1u << e;
    }
    av[i] = make_int4(0, 0, 0, 0);
    if (need[i]) {
      const int32_t* src = arr + (base + f);
      if (ROW_WORDS || dw.arr_words) {
        av[i] = __ldcs(reinterpret_cast<const int4*>(src));
      } else {
        av[i].x = need[i] & 1u ? __ldcs(src) : 0;
        av[i].y = need[i] & 2u ? __ldcs(src + 1) : 0;
        av[i].z = need[i] & 4u ? __ldcs(src + 2) : 0;
        av[i].w = need[i] & 8u ? __ldcs(src + 3) : 0;
      }
    }
  }
  const int hrow = hf >= 0 ? unit_row(dw, hf - base) : -1;
  const bool hneed = hf >= 0 && hd < 0 && !(dead >> hrow & 1u);
  const int32_t ha = hneed ? __ldcs(arr + hf) : 0;

  // 3. deliver, write the words that change, and each cell's packed count
  int cnt[kDeliverBatch][ROW_WORDS ? 1 : 4];
#pragma unroll
  for (int i = 0; i < kDeliverBatch; ++i) {
    const long long f = dw.lead + 4 * (k0 + i * 32 + lane) - base;
    const bool has = i * 32 + lane < nwords;
    int dv[4];
    unsigned fresh = 0, now = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dv[e] = word_cell(d[i], e);
      if ((need[i] >> e & 1u) && word_cell(av[i], e) == t) {
        fresh |= 1u << e;
        dv[e] = t;
      }
      if (has && dv[e] == t) now |= 1u << e;
    }
    if (fresh)
      *reinterpret_cast<int4*>(delivered + (base + f)) =
          make_int4(dv[0], dv[1], dv[2], dv[3]);
    if (ROW_WORDS) {
      // the word's 4 columns start on a 4-byte boundary of is_app
      const int col = static_cast<int>(f - static_cast<long long>(
                                               row[i][0]) * w);
      const unsigned appw =
          now ? __ldg(reinterpret_cast<const unsigned*>(is_app + col)) : 0u;
      int c = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (now >> e & 1u) c += (appw >> (8 * e) & 0xffu) ? 1 : kPingUnit;
      cnt[i][0] = c;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = static_cast<int>(
            f + e - static_cast<long long>(row[i][ROW_WORDS ? 0 : e]) * w);
        cnt[i][ROW_WORDS ? 0 : e] =
            now >> e & 1u ? (__ldg(is_app + col) ? 1 : kPingUnit) : 0;
      }
    }
  }
  int hcnt = 0;
  if (hf >= 0) {
    const bool fresh = hneed && ha == t;
    if (fresh) delivered[hf] = t;
    if (fresh || hd == t) {
      const int col = static_cast<int>(hf - base -
                                       static_cast<long long>(hrow) * w);
      hcnt = __ldg(is_app + col) ? 1 : kPingUnit;
    }
  }

  // 4. each row's counts: a warp reduction over the rows of the piece
  const int r_first = unit_row(dw, p0 - base);
  const int r_last = unit_row(dw, p1 - 1 - base);
  for (int rr = r_first; rr <= r_last; ++rr) {
    int mine = hrow == rr ? hcnt : 0;
#pragma unroll
    for (int i = 0; i < kDeliverBatch; ++i) {
#pragma unroll
      for (int e = 0; e < (ROW_WORDS ? 1 : 4); ++e)
        mine += row[i][e] == rr ? cnt[i][e] : 0;
    }
    const int v = __reduce_add_sync(kFullMask, mine);
    if (lane == rr) {
      app += v & (kPingUnit - 1);
      ping += v >> 16;
    }
  }
}

// A warp a unit: R rows, or one row past W = 512 in pieces of 512 cells.
template <bool ROW_WORDS>
__global__ void __launch_bounds__(kDeliverThreads)
    deliver_kernel(const int32_t* __restrict__ arr,
                   int32_t* __restrict__ delivered,
                   const uint8_t* __restrict__ crashed,
                   const uint8_t* __restrict__ is_app,
                   int32_t* __restrict__ napp, int32_t* __restrict__ nping,
                   int n, int w, int t, DeliverWalk dw) {
  const int lane = threadIdx.x & 31;
  const long long u =
      static_cast<long long>(blockIdx.x) * (kDeliverThreads / 32) +
      (threadIdx.x >> 5);
  if (u >= dw.units) return;
  const int row0 = static_cast<int>(u * dw.rows);
  const int rows = min(dw.rows, n - row0);
  const uint8_t crashed_lane = lane < rows ? crashed[row0 + lane] : 0;
  const long long base = static_cast<long long>(row0) * w;
  const long long end = base + static_cast<long long>(rows) * w;
  int app = 0, ping = 0;
  for (long long p0 = base; p0 < end; p0 += kDeliverPieceCells) {
    const long long p1 = min(p0 + kDeliverPieceCells, end);
    deliver_piece<ROW_WORDS>(dw, arr, delivered, is_app, w, t, base, p0, p1,
                             crashed_lane, lane, app, ping);
  }
  if (lane < rows) {
    napp[row0 + lane] = app;
    nping[row0 + lane] = ping;
  }
}

}  // namespace repro_torch

extern "C" int rt_deliver_sweep(void* arr, void* delivered,
                                const void* crashed, const void* is_app,
                                void* napp, void* nping, int n, int w, int t,
                                void* stream) {
  using namespace repro_torch;
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  DeliverWalk dw;
  dw.rows = w <= kDeliverPieceCells ? kDeliverPieceCells / w : 1;
  if (dw.rows > 32) dw.rows = 32;
  dw.units = (n + dw.rows - 1) / dw.rows;
  dw.div_w = ((1ull << 32) + w - 1) / w;
  const uintptr_t da = reinterpret_cast<uintptr_t>(delivered);
  const uintptr_t aa = reinterpret_cast<uintptr_t>(arr);
  dw.lead = static_cast<int>(((16 - da % 16) % 16) / 4);
  dw.arr_words = da % 16 == aa % 16;
  const bool row_words = w % 4 == 0 && dw.lead == 0 && dw.arr_words &&
                         reinterpret_cast<uintptr_t>(is_app) % 4 == 0;
  const unsigned blocks = static_cast<unsigned>(
      (dw.units + kDeliverThreads / 32 - 1) / (kDeliverThreads / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(arr);
  auto* d = static_cast<int32_t*>(delivered);
  const auto* c = static_cast<const uint8_t*>(crashed);
  const auto* app = static_cast<const uint8_t*>(is_app);
  auto* na = static_cast<int32_t*>(napp);
  auto* np = static_cast<int32_t*>(nping);
  if (row_words) {
    deliver_kernel<true><<<blocks, kDeliverThreads, 0, st>>>(
        a, d, c, app, na, np, n, w, t, dw);
  } else {
    deliver_kernel<false><<<blocks, kDeliverThreads, 0, st>>>(
        a, d, c, app, na, np, n, w, t, dw);
  }
  return static_cast<int>(cudaGetLastError());
}
