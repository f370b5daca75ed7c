// fused_sweep: the gating-free round on the card (phases 5 and 8).
//
// Replaces the TPU kernel fused_sweep_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by fused_sweep in
// ops.py of that package).  It runs every round of a run without link
// additions: the sustained-traffic and serving main path.
//
// What bounds it: memory.  Each round it must read the delivered plane
// once, arr only where a cell is still undelivered on a live row
// (elsewhere the output ignores arr), and read and write the cells the
// forward lowers.  At the sustained shape (N = 10,000 processes,
// W = 16,384 live columns) delivered alone is 655 MB, 0.20 ms at the
// H100 SXM's 3.35 TB/s; arr adds up to another 655 MB, counted in
// 32-byte sectors from the run's own inputs by chip_smoke.py.  Its
// integer work is about ten operations a cell, far below the card's
// rate.
//
// The design is a pull in two launches.  A push (each cell delivered at
// t sends K atomicMin into arr[adj[p, k], m]) spends a read-modify-write
// of a 32-byte sector of a plane far larger than the 50 MB L2 on every
// send, and with max_delay 1 the first send to a cell decides it, so
// most of the K sends to a cell change nothing.
//
//   * Pass 1, the plane pass (plane_kernel): phase 5 and the per-row
//     counts, and a mask of the cells delivered at t, one bit a cell:
//     rows of `wwords` = 4 ceil(W / 128) uint32 words, the words past W
//     written as 0.  It runs at the bytes' rate: a lane owns 4
//     neighbouring columns, read as one 16-byte vector when W % 4 == 0
//     (and the planes are 16-byte aligned), a warp 128 columns of
//     kPlaneRows rows whose loads are all issued before any is used, arr
//     read only by a lane with an undelivered cell on a live row,
//     delivered written only where it changes.  The mask is 4 bytes for
//     32 cells (20.5 MB at the sustained shape).
//   * Pass 2, the forward (forward_kernel): every arr cell (q, m) is
//     owned by one lane, which takes the min of t + delay[p, k] over the
//     in-edges (p, k) of q with fwd_ok[p, k] set and bit (p, m) set,
//     reads arr[q, m] only where that min is below INF and stores it
//     only where it is lower: no atomics.  int32 min is order-free, so
//     the plane equals the scatter-min of the plain version byte for
//     byte.  The in-edges come from an inverse adjacency table, CSR by
//     target row (in_ptr (N + 1), in_slot = p * K + k), which the
//     wrapper builds on the card and caches (ops.py).  A warp owns one
//     row q and up to kSpansPerWarp spans of 32 mask words (1,024
//     columns); lane e holds in-edge e (slot, fwd_ok, delay), loaded
//     once.  Per span, lane l reads word l of each sender's mask row
//     (one coalesced 128-byte line a sender), the words of the senders
//     of one value are OR-ed (one value when every delay is equal, as on
//     the main path), and each non-zero word is spread by one shuffle to
//     the 32 lanes of its columns: a few instructions a word, not a
//     shuffle a sender and a word.  Then the lanes read the arr cells
//     their candidates reach, 16 loads in flight, and store the lower.
//
// passes = 1 runs pass 1 alone (chip_smoke.py times it as the plane
// pass).

#include "sweep.cuh"

namespace repro_torch {

constexpr int kPlaneWarps = 8;   // warps of a pass-1 block
constexpr int kPlaneRows = 4;    // rows a warp keeps in flight
constexpr int kPlaneCols = 128;  // columns of a warp: 4 a lane

// The 4 cells of a row from column c0 (nc of them inside the plane), 0
// past the plane.
template <bool kVec>
__device__ __forceinline__ void load4(const int32_t* row, int c0, int nc,
                                      int32_t (&x)[4]) {
  if (kVec && nc == 4) {
    const int4 v = *reinterpret_cast<const int4*>(row + c0);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = j < nc ? row[c0 + j] : 0;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kPlaneWarps * 32)
    plane_kernel(const int32_t* __restrict__ arr,
                 int32_t* __restrict__ delivered,
                 const uint8_t* __restrict__ crashed,
                 const uint8_t* __restrict__ is_app,
                 uint32_t* __restrict__ bits, int32_t* __restrict__ napp,
                 int32_t* __restrict__ nping, int n, int w, int wwords,
                 int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kPlaneCols + lane * 4;
  const int nc = max(0, min(4, w - c0));
  unsigned appmask = 0;  // bit j: column c0 + j is an app column
#pragma unroll
  for (int j = 0; j < 4; ++j)
    appmask |= (j < nc && is_app[c0 + j] != 0) ? 1u << j : 0u;
  const int word = blockIdx.x * (kPlaneCols / 32) + (lane >> 3);
  for (int p0 = (blockIdx.y * kPlaneWarps + warp) * kPlaneRows; p0 < n;
       p0 += gridDim.y * kPlaneWarps * kPlaneRows) {
    int32_t d[kPlaneRows][4], a[kPlaneRows][4];
    bool live[kPlaneRows];
#pragma unroll
    for (int r = 0; r < kPlaneRows; ++r) {
      const int p = p0 + r;
      live[r] = p < n && crashed[p] == 0;
      load4<kVec>(delivered + static_cast<size_t>(p) * w, c0,
                  p < n ? nc : 0, d[r]);
    }
#pragma unroll
    for (int r = 0; r < kPlaneRows; ++r) {
      const bool need = live[r] && (d[r][0] < 0 || d[r][1] < 0 ||
                                    d[r][2] < 0 || d[r][3] < 0);
      load4<kVec>(arr + static_cast<size_t>(p0 + r) * w, c0, need ? nc : 0,
                  a[r]);
    }
#pragma unroll
    for (int r = 0; r < kPlaneRows; ++r) {
      const int p = p0 + r;
      if (p >= n) break;  // warp-uniform
      unsigned now = 0, fresh = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nc) continue;
        if (d[r][j] < 0) {
          if (live[r] && a[r][j] == t) fresh |= 1u << j;
        } else if (d[r][j] == t) {
          now |= 1u << j;
        }
      }
      if (fresh) {
        int32_t* row = delivered + static_cast<size_t>(p) * w;
        if (kVec && nc == 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) d[r][j] = fresh >> j & 1 ? t : d[r][j];
          *reinterpret_cast<int4*>(row + c0) =
              make_int4(d[r][0], d[r][1], d[r][2], d[r][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (fresh >> j & 1) row[c0 + j] = t;
        }
        now |= fresh;
      }
      const int na = __reduce_add_sync(kFullMask, __popc(now & appmask));
      const int np = __reduce_add_sync(kFullMask, __popc(now & ~appmask));
      if (lane == 0) {
        if (na) atomicAdd(napp + p, na);
        if (np) atomicAdd(nping + p, np);
      }
      // lanes 8i..8i+7 hold the 32 columns of the warp's word i
      unsigned x = now << (4 * (lane & 7));
      x |= __shfl_xor_sync(kFullMask, x, 1);
      x |= __shfl_xor_sync(kFullMask, x, 2);
      x |= __shfl_xor_sync(kFullMask, x, 4);
      if ((lane & 7) == 0 && word < wwords)
        bits[static_cast<size_t>(p) * wwords + word] = x;
    }
  }
}

// One batch of up to 32 in-edges of a row, a lane each.
struct InEdge {
  bool ok;          // fwd_ok of the edge's slot
  int32_t value;    // t + delay of the slot
  size_t row;       // the sender's mask row, in words
};

__device__ __forceinline__ InEdge load_edge(
    int e, int e_end, const int32_t* __restrict__ in_slot,
    const int32_t* __restrict__ delay, const uint8_t* __restrict__ fwd_ok,
    int k, int wwords, int t) {
  InEdge edge{false, 0, 0};
  if (e < e_end) {
    const int s = in_slot[e];
    if (fwd_ok[s]) {
      edge.ok = true;
      edge.value = t + delay[s];
      edge.row = static_cast<size_t>(s / k) * wwords;
    }
  }
  return edge;
}

constexpr int kSpanWords = 32;   // a pass-2 span: 32 mask words
constexpr int kSpansPerWarp = 4;

// Fold a batch of up to 32 in-edges (a lane each) into span s's
// candidates: lane l reads mask word s * 32 + l of each sender.  The
// edges are taken by value, smallest first (a warp-wide min a round):
// the words of one value are OR-ed and their bits not yet taken by a
// smaller value are spread, word by word, to the lanes of their
// columns, so cand[j], column (s * 32 + j) * 32 + lane, gets the least
// value that reaches it.  Across batches the min is taken.
__device__ __forceinline__ void fold_batch(const InEdge& edge, int nb, int s,
                                           const uint32_t* __restrict__ bits,
                                           int wwords, int lane,
                                           int32_t (&cand)[kSpanWords]) {
  const int wi = s * kSpanWords + lane;
  const bool inw = wi < wwords;
  const long long row = static_cast<long long>(edge.row);
  uint32_t covered = 0;
  unsigned left = __ballot_sync(kFullMask, edge.ok);
  while (left) {
    const bool mine = left >> lane & 1;
    const int32_t value =
        __reduce_min_sync(kFullMask, mine ? edge.value : INT32_MAX);
    const unsigned cls = __ballot_sync(kFullMask, mine && edge.value == value);
    left &= ~cls;
    uint32_t acc = 0;
    for (int base = 0; base < nb; base += 8) {
      uint32_t words[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = (base + u) & 31;
        const long long r = __shfl_sync(kFullMask, row, e);
        words[u] = base + u < nb && (cls >> e & 1) && inw ? bits[r + wi] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc |= words[u];
    }
    const uint32_t fresh = acc & ~covered;
    covered |= acc;
    const unsigned any = __ballot_sync(kFullMask, fresh != 0);
#pragma unroll
    for (int j = 0; j < kSpanWords; ++j) {
      if (any >> j & 1) {  // warp-uniform
        const uint32_t x = __shfl_sync(kFullMask, fresh, j);
        if (x >> lane & 1) cand[j] = min(cand[j], value);
      }
    }
  }
}

__global__ void __launch_bounds__(256, 3)
    forward_kernel(int32_t* __restrict__ arr,
                        const uint32_t* __restrict__ bits,
                        const int32_t* __restrict__ in_ptr,
                        const int32_t* __restrict__ in_slot,
                        const int32_t* __restrict__ delay,
                        const uint8_t* __restrict__ fwd_ok, int n, int w,
                        int wwords, int k, int t, int warps_per_row) {
  const int lane = threadIdx.x & 31;
  const long long gw =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int q = static_cast<int>(gw / warps_per_row);
  if (q >= n) return;  // warp-uniform
  const int nspans = (wwords + kSpanWords - 1) / kSpanWords;
  const int s_begin = static_cast<int>(gw % warps_per_row) * kSpansPerWarp;
  const int s_end = min(nspans, s_begin + kSpansPerWarp);
  const int e_beg = in_ptr[q], e_end = in_ptr[q + 1];
  // the first 32 in-edges stay in registers across the spans
  const int nb = min(e_end - e_beg, 32);
  const InEdge first = load_edge(e_beg + lane, e_beg + nb, in_slot, delay,
                                 fwd_ok, k, wwords, t);
  if (e_end - e_beg <= 32 && !__any_sync(kFullMask, first.ok)) return;
  int32_t* row = arr + static_cast<size_t>(q) * w;
  for (int s = s_begin; s < s_end; ++s) {
    int32_t cand[kSpanWords];
#pragma unroll
    for (int j = 0; j < kSpanWords; ++j) cand[j] = kInf;
    fold_batch(first, nb, s, bits, wwords, lane, cand);
    for (int e0 = e_beg + 32; e0 < e_end; e0 += 32) {
      fold_batch(load_edge(e0 + lane, e_end, in_slot, delay, fwd_ok, k,
                           wwords, t),
                 min(e_end - e0, 32), s, bits, wwords, lane, cand);
    }
    // read the cells a send reaches, 16 at a time, then store where lower
#pragma unroll
    for (int h = 0; h < kSpanWords; h += 16) {
      int32_t cur[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int m = (s * kSpanWords + h + j) * 32 + lane;
        cur[j] = cand[h + j] < kInf && m < w ? row[m] : kInf;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (cand[h + j] < cur[j])
          row[(s * kSpanWords + h + j) * 32 + lane] = cand[h + j];
      }
    }
  }
}

}  // namespace repro_torch

// bits: (n, wwords) uint32 scratch, wwords = 4 * ceil(w / 128); in_ptr
// (n + 1) and in_slot int32, the inverse table of adj.  passes: 3 runs
// both passes, 1 the plane pass alone.
extern "C" int rt_fused_sweep(void* arr, void* delivered, const void* crashed,
                              const void* is_app, const void* delay,
                              const void* fwd_ok, const void* in_ptr,
                              const void* in_slot, void* bits, void* napp,
                              void* nping, int n, int w, int k, int t,
                              int passes, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wwords = 4 * ((w + kPlaneCols - 1) / kPlaneCols);
  const bool vec = w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(arr) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(delivered) % 16 == 0;
  const int rows_per_block = kPlaneWarps * kPlaneRows;
  unsigned gy = static_cast<unsigned>((n + rows_per_block - 1) /
                                      rows_per_block);
  if (gy > 65535u) gy = 65535u;
  const dim3 grid1(static_cast<unsigned>(wwords / 4), gy);
  const auto plane = vec ? plane_kernel<true> : plane_kernel<false>;
  plane<<<grid1, kPlaneWarps * 32, 0, st>>>(
      static_cast<const int32_t*>(arr), static_cast<int32_t*>(delivered),
      static_cast<const uint8_t*>(crashed),
      static_cast<const uint8_t*>(is_app), static_cast<uint32_t*>(bits),
      static_cast<int32_t*>(napp), static_cast<int32_t*>(nping), n, w,
      wwords, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || passes == 1) return static_cast<int>(err);
  const int spans = (wwords + kSpanWords - 1) / kSpanWords;
  const int warps_per_row = (spans + kSpansPerWarp - 1) / kSpansPerWarp;
  const long long warps = static_cast<long long>(n) * warps_per_row;
  forward_kernel<<<static_cast<unsigned>((warps + 7) / 8), 256, 0, st>>>(
      static_cast<int32_t*>(arr), static_cast<const uint32_t*>(bits),
      static_cast<const int32_t*>(in_ptr),
      static_cast<const int32_t*>(in_slot),
      static_cast<const int32_t*>(delay),
      static_cast<const uint8_t*>(fwd_ok), n, w, wwords, k, t,
      warps_per_row);
  return static_cast<int>(cudaGetLastError());
}
