// frontier_sweep: phases 7 and 8 of a gated round on the card — the
// flush of buffered app messages over links whose pong arrived, and the
// forward of this round's deliveries over safe links, in one
// scatter-min, with the count of flushed sends:
//
//   for every cell (p, m) and slot k: send t + delay[p, k] to
//   arr[adj[p, k], m] (min) when
//     delivered[p, m] == t and fwd_ok[p, k]               (forward), or
//     is_app[m], gate[p, k] <= delivered[p, m] < t and do[p, k]  (flush);
//   flush_sent = the number of flush (p, k, m) triples.
//
// Replaces the TPU kernel frontier_sweep_kernel in
// src/repro/core/vecsim/kernels/kernel.py (launched by frontier_sweep
// in ops.py of that package).  It runs every round of a run with link
// additions, after pong detection.
//
// What bounds it: memory.  It must read the delivered plane once, the
// slot flags of the rows that can send, the gates of the flushing slots,
// adj and delay of the slots that send, and read and write each arr
// sector a send lowers (chip_smoke.py's _bound counts these bytes from
// the run's inputs): at the paper-scale churn shape (N = 50,000, W =
// 140, K = 17) the plane alone is 28 MB, 0.0084 ms at the H100 SXM's
// 3.35 TB/s.  After the broadcasts have spread, most rounds send nothing
// at all, and a busy one sends millions of times, mostly to cells an
// earlier arrival has already lowered.  The design (a thread a cell,
// each active one looping over all K slots with scalar table reads and
// an atomic a send, is what it replaces):
//
//   * a warp per unit of rows, deliver_sweep.cu's walk: R = 512 / W whole
//     rows (1 to 32: 3 at W = 140), read as 4-cell words (16-byte loads)
//     from delivered's first 16-byte boundary, four a lane, with a scalar
//     head and tail; past W = 512 a unit is one row in pieces of 512
//     cells;
//   * the unit's slot flags (do and fwd_ok, R x K contiguous bytes) read
//     once, a lane a slot, beside its first words; a vote says whether
//     any slot flushes.  Only a unit with a candidate cell (below) keeps
//     them, as ballot words in the warp's shared memory; lane r turns
//     them into row r's do and fwd masks of a group of 32 slots (any K,
//     a group at a time), also in shared memory, so the cells read them
//     without shuffles in divergent code;
//   * the candidate cells (d == t; d < t too in a unit with a flushing
//     slot) compacted, in cell order, into a list in shared memory (a
//     packed warp scan of per-word counts); a piece with none is done
//     after its compares, which is every piece of an idle round.  The
//     lanes then share the list out, a cell each, so that the few
//     sending cells of a unit fill the warp rather than leave one lane in
//     32 looping while the rest wait;
//   * a listed cell's sending slots are one bit mask: the fwd mask at d
//     == t; for an app column with d < t, the do slots whose gate is <=
//     d (is_app and gate read only there, for a row with a do slot), the
//     flushed count its popcount.  The mask is walked with __ffs, eight
//     sends in flight;
//   * a send reads its arr cell through L2 (coherent with the atomics)
//     and issues atomicMin only where its value is lower.  arr only
//     falls during the sweep, so a stale read can only let a no-op
//     atomic through;
//   * the flushed count folded by a warp reduction and added by the warp
//     to the int64 counter (flushes are rare), so that no warp waits for
//     its block; blocks of two warps, at most 80 registers a thread, so
//     that a busy unit holds up little of an SM.
//
// Measured on the card (PERF.md, section 6), the round's sends cost
// their atomics: the same sweep without them (the reads and compares
// kept) was no slower than with no sends at all, and with an atomic for
// every send (no read) no slower than with the filtered ones.  Two passes a cell
// (all reads, then the atomics), blocks of 4 or 8 warps, 4 or 16 sends
// in flight, and uncached reads of arr were no faster.
//
// int32 min commutes, so arr after the sweep is byte-equal on every run
// and to the plain version.  Targets outside [0, N) are dropped.  The
// count equals the JAX kernel's int32 sum wherever that sum does not wrap
// (N * W * K = 1.19e8 at the churn shape, far under 2^31).

#include "sweep.cuh"

namespace repro_torch {

constexpr int kFrontierThreads = 64;
constexpr int kFrontierWarps = kFrontierThreads / 32;
constexpr int kFrontierBatch = 4;                          // words a lane
constexpr int kFrontierPieceCells = 4 * 32 * kFrontierBatch;  // 512
constexpr int kSendsInFlight = 8;
constexpr int kFlagBatch = 4;   // groups of 32 slot flags in flight

// A warp's unit of work, as deliver_sweep.cu's DeliverWalk (kept apart:
// shared through sweep.cuh, deliver_sweep measured 7% slower at N = 2^20),
// and the layout of its shared memory, in 32-bit words: the do and fwd_ok
// ballot words of the unit's R x K slots (flag_words each, one spare),
// row r's masks of the current slot group, and the list of candidate
// cells.
struct FrontierWalk {
  int rows;                   // rows of a unit, 1 to 32
  int units;
  unsigned long long div_w;   // ceil(2^32 / w): offset in a unit -> row
  int lead;                   // cells before delivered's first 16-byte
                              // boundary
  int flag_words;             // ceil(rows * k / 32) + 1
  int warp_words;             // 2 flag_words + 2 * 32 + 512
};

// the row, within its unit, of the cell base + rel (exact while rel w <
// 2^32: a unit of more than one row has rel < 512)
__device__ __forceinline__ int frontier_row(const FrontierWalk& fw,
                                            long long rel) {
  return fw.rows == 1
             ? 0
             : static_cast<int>(
                   (static_cast<unsigned long long>(rel) * fw.div_w) >> 32);
}

__device__ __forceinline__ int frontier_cell(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// nb bits of a bit array from bit pos (nb <= 32; the word after pos's
// lies inside the array)
__device__ __forceinline__ unsigned bit_field(const unsigned* bits, int pos,
                                              int nb) {
  const int q = pos >> 5, s = pos & 31;
  unsigned v = bits[q] >> s;
  if (s) v |= bits[q + 1] << (32 - s);
  return nb == 32 ? v : v & ((1u << nb) - 1u);
}

struct FrontierShared {
  unsigned* do_bits;
  unsigned* fwd_bits;
  unsigned* row_do;
  unsigned* row_fwd;
  int* list;             // a candidate cell's offset in its unit
};

// A unit's slot flags: this lane's of the first 128, slot 32 i + lane in
// byte i, whether any slot flushes, and whether the ballot words are
// staged.
struct FrontierFlags {
  unsigned fd;
  unsigned ff;
  bool any_do;
  bool staged;
};

struct FrontierArgs {
  int32_t* arr;
  const int32_t* __restrict__ delivered;
  const int32_t* __restrict__ adj;
  const int32_t* __restrict__ delay;
  const int32_t* __restrict__ gate;
  const uint8_t* __restrict__ flushing;
  const uint8_t* __restrict__ fwd_ok;
  const uint8_t* __restrict__ is_app;
  int n, w, k, t;
};

// The sending slots of the group grp of a listed cell of value dv (row r
// of the unit, column col): the forward mask at d == t; else d < t, and
// for an app column the flushing slots whose gate is at most d, added to
// the flushed count.
__device__ __forceinline__ unsigned cell_mask(const FrontierArgs& a,
                                              const FrontierShared& sh,
                                              int row0, int r, long long col,
                                              int grp, int32_t dv,
                                              unsigned& flushed) {
  if (dv == a.t) return sh.row_fwd[r];
  unsigned dm = sh.row_do[r];
  if (!dm || !__ldg(a.is_app + col)) return 0u;
  const int32_t* g =
      a.gate + (static_cast<size_t>(row0) + r) * a.k + 32 * grp;
  unsigned fm = 0;
  while (dm) {
    const int j = __ffs(dm) - 1;
    dm &= dm - 1u;
    if (dv >= __ldg(g + j)) fm |= 1u << j;
  }
  flushed += __popc(fm);
  return fm;
}

// The listed cells, a cell a lane: each sends t + delay[p, k] to
// arr[adj[p, k], m] over the slots of its mask, kSendsInFlight at once,
// reading the arr cell first.
__device__ __forceinline__ void send_list(const FrontierArgs& a,
                                          const FrontierWalk& fw,
                                          const FrontierShared& sh,
                                          int row0, long long base, int grp,
                                          int count, int lane,
                                          unsigned& flushed) {
  for (int i = lane; i < count; i += 32) {
    const long long rel = sh.list[i];
    const int r = frontier_row(fw, rel);
    const long long col = rel - static_cast<long long>(r) * a.w;
    unsigned mask = cell_mask(a, sh, row0, r, col, grp,
                              __ldg(a.delivered + base + rel), flushed);
    const size_t slot0 = (static_cast<size_t>(row0) + r) * a.k + 32 * grp;
    while (mask) {
      int32_t* cell[kSendsInFlight];
      int32_t v[kSendsInFlight];
#pragma unroll
      for (int b = 0; b < kSendsInFlight; ++b) {
        cell[b] = nullptr;
        v[b] = 0;
        if (mask) {
          const int j = __ffs(mask) - 1;
          mask &= mask - 1u;
          const int q = __ldg(a.adj + slot0 + j);
          v[b] = a.t + __ldg(a.delay + slot0 + j);
          if (q >= 0 && q < a.n)
            cell[b] = a.arr + static_cast<size_t>(q) * a.w + col;
        }
      }
      int32_t cur[kSendsInFlight];
#pragma unroll
      for (int b = 0; b < kSendsInFlight; ++b)
        cur[b] = cell[b] ? __ldcg(cell[b]) : 0;
#pragma unroll
      for (int b = 0; b < kSendsInFlight; ++b)
        if (cell[b] && v[b] < cur[b]) atomicMin(cell[b], v[b]);
    }
  }
}

// Cells [p0, p1) of the unit whose first cell is base (row row0): the
// candidates (d == t, or d < t in a unit with a flushing slot) listed,
// then each slot group's masks and sends.
__device__ __forceinline__ void frontier_piece(
    const FrontierArgs& a, const FrontierWalk& fw, const FrontierShared& sh,
    int row0, int rows, long long base, long long p0, long long p1,
    FrontierFlags& fl, int lane, unsigned& flushed) {
  // the piece's whole words: cells lead + 4 k, k in [k0, k0 + nwords)
  const long long k0 = (p0 - fw.lead + 3) >> 2;
  const long long k1 = (p1 - fw.lead) >> 2;
  const int nwords = k1 > k0 ? static_cast<int>(k1 - k0) : 0;
  // the head (before the first whole word) and tail (after the last)
  // cells, a lane each; every cell when there is no whole word (at most 6)
  const long long wa = nwords > 0 ? fw.lead + 4 * k0 : p1;
  const long long wb = nwords > 0 ? wa + 4LL * nwords : p1;
  const int nhead = static_cast<int>(wa - p0);
  const int ntail = static_cast<int>(p1 - wb);
  long long hf = -1;  // this lane's head or tail cell
  if (lane < nhead) {
    hf = p0 + lane;
  } else if (lane < nhead + ntail) {
    hf = wb + lane - nhead;
  }

  // 1. every delivered word (and head or tail cell) in flight
  int4 d[kFrontierBatch];
#pragma unroll
  for (int i = 0; i < kFrontierBatch; ++i) {
    const int idx = i * 32 + lane;
    d[i] = idx < nwords ? __ldg(reinterpret_cast<const int4*>(
                              a.delivered + fw.lead + 4 * (k0 + idx)))
                        : make_int4(-1, -1, -1, -1);
  }
  const int32_t hd = hf >= 0 ? __ldg(a.delivered + hf) : -1;

  // 2. first piece: the unit's first 128 slot flags (R x K contiguous
  // bytes, a lane a slot) into registers, and whether any slot flushes
  const int slots = rows * a.k;
  const size_t s0 = static_cast<size_t>(row0) * a.k;
  if (p0 == base) {
    fl.fd = fl.ff = 0u;
#pragma unroll
    for (int i = 0; i < kFlagBatch; ++i) {
      const int e = 32 * i + lane;
      if (e < slots) {
        fl.fd |= static_cast<unsigned>(a.flushing[s0 + e] != 0) << (8 * i);
        fl.ff |= static_cast<unsigned>(a.fwd_ok[s0 + e] != 0) << (8 * i);
      }
    }
    bool any = fl.fd != 0u;
    for (int e = 32 * kFlagBatch + lane; e < slots; e += 32)
      any |= a.flushing[s0 + e] != 0;
    fl.any_do = __any_sync(kFullMask, any);
    fl.staged = false;
  }
  const bool any_do = fl.any_do;

  // 3. the candidates, listed in cell order: word slot i's cells of all
  // lanes (a packed scan of per-word counts, each byte <= 128), then the
  // head and tail; a piece without one is done
  unsigned cand = 0;     // bit 4 i + e: cell e of word i
  unsigned packed = 0;   // candidates of word i in byte i
#pragma unroll
  for (int i = 0; i < kFrontierBatch; ++i) {
    unsigned c = 0;
    if (i * 32 + lane < nwords) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int32_t dv = frontier_cell(d[i], e);
        if (dv == a.t || (any_do && dv < a.t)) {
          cand |= 1u << (4 * i + e);
          ++c;
        }
      }
    }
    packed |= c << (8 * i);
  }
  const bool hcand = hf >= 0 && (hd == a.t || (any_do && hd < a.t));
  if (!__any_sync(kFullMask, cand != 0u || hcand)) return;
  unsigned scan = packed;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned up = __shfl_up_sync(kFullMask, scan, s);
    if (lane >= s) scan += up;
  }
  const unsigned totals = __shfl_sync(kFullMask, scan, 31);
  const unsigned hb = __ballot_sync(kFullMask, hcand);
  int start = 0;
#pragma unroll
  for (int i = 0; i < kFrontierBatch; ++i) {
    int pos = start + static_cast<int>(((scan - packed) >> (8 * i)) & 0xffu);
    const long long f = fw.lead + 4 * (k0 + i * 32 + lane) - base;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (cand >> (4 * i + e) & 1u) sh.list[pos++] = static_cast<int>(f + e);
    start += static_cast<int>((totals >> (8 * i)) & 0xffu);
  }
  if (hcand)
    sh.list[start + __popc(hb & ((1u << lane) - 1u))] =
        static_cast<int>(hf - base);
  const int count = start + __popc(hb);

  // 4. once a unit, at its first piece with a candidate: the flags as
  // ballot words
  if (!fl.staged) {
#pragma unroll
    for (int i = 0; i < kFlagBatch; ++i) {
      if (32 * i >= slots) break;
      const unsigned db = __ballot_sync(kFullMask, fl.fd >> (8 * i) & 1u);
      const unsigned fb = __ballot_sync(kFullMask, fl.ff >> (8 * i) & 1u);
      if (lane == 0) {
        sh.do_bits[i] = db;
        sh.fwd_bits[i] = fb;
      }
    }
    for (int e0 = 32 * kFlagBatch; e0 < slots; e0 += 32) {
      const int e = e0 + lane;
      const unsigned db =
          __ballot_sync(kFullMask, e < slots && a.flushing[s0 + e] != 0);
      const unsigned fb =
          __ballot_sync(kFullMask, e < slots && a.fwd_ok[s0 + e] != 0);
      if (lane == 0) {
        sh.do_bits[e0 >> 5] = db;
        sh.fwd_bits[e0 >> 5] = fb;
      }
    }
    if (lane == 0) {
      sh.do_bits[(slots + 31) >> 5] = 0u;
      sh.fwd_bits[(slots + 31) >> 5] = 0u;
    }
    fl.staged = true;
    __syncwarp();
  }

  // 5. each slot group: row r's masks by lane r, then the sends
  for (int grp = 0; grp * 32 < a.k; ++grp) {
    const int nb = min(32, a.k - 32 * grp);
    if (lane < rows) {
      sh.row_do[lane] = bit_field(sh.do_bits, lane * a.k + 32 * grp, nb);
      sh.row_fwd[lane] = bit_field(sh.fwd_bits, lane * a.k + 32 * grp, nb);
    }
    __syncwarp();
    send_list(a, fw, sh, row0, base, grp, count, lane, flushed);
    __syncwarp();
  }
}

// A warp a unit: R rows, or one row past W = 512 in pieces of 512 cells.
__global__ void __launch_bounds__(kFrontierThreads, 12)
    frontier_kernel(FrontierArgs a, FrontierWalk fw,
                    unsigned long long* __restrict__ flush_sent) {
  extern __shared__ unsigned frontier_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* mine = frontier_smem + static_cast<size_t>(warp) * fw.warp_words;
  FrontierShared sh;
  sh.do_bits = mine;
  sh.fwd_bits = mine + fw.flag_words;
  sh.row_do = mine + 2 * fw.flag_words;
  sh.row_fwd = sh.row_do + 32;
  sh.list = reinterpret_cast<int*>(sh.row_fwd + 32);

  unsigned flushed = 0;
  const long long u =
      static_cast<long long>(blockIdx.x) * kFrontierWarps + warp;
  if (u < fw.units) {
    const int row0 = static_cast<int>(u * fw.rows);
    const int rows = min(fw.rows, a.n - row0);
    const long long base = static_cast<long long>(row0) * a.w;
    const long long end = base + static_cast<long long>(rows) * a.w;
    FrontierFlags fl;
    for (long long p0 = base; p0 < end; p0 += kFrontierPieceCells) {
      frontier_piece(a, fw, sh, row0, rows, base, p0,
                     min(p0 + kFrontierPieceCells, end), fl, lane, flushed);
    }
  }
  // flushes are rare: a warp adds its own count, and its block does not
  // wait for it
  flushed = __reduce_add_sync(kFullMask, flushed);
  if (lane == 0 && flushed != 0u) {
    atomicAdd(flush_sent, static_cast<unsigned long long>(flushed));
  }
}

}  // namespace repro_torch

extern "C" int rt_frontier_sweep(void* arr, const void* delivered,
                                 const void* adj, const void* delay,
                                 const void* gate, const void* flushing,
                                 const void* fwd_ok, const void* is_app,
                                 void* flush_sent, int n, int w, int k, int t,
                                 void* stream) {
  using namespace repro_torch;
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  FrontierArgs a;
  a.arr = static_cast<int32_t*>(arr);
  a.delivered = static_cast<const int32_t*>(delivered);
  a.adj = static_cast<const int32_t*>(adj);
  a.delay = static_cast<const int32_t*>(delay);
  a.gate = static_cast<const int32_t*>(gate);
  a.flushing = static_cast<const uint8_t*>(flushing);
  a.fwd_ok = static_cast<const uint8_t*>(fwd_ok);
  a.is_app = static_cast<const uint8_t*>(is_app);
  a.n = n;
  a.w = w;
  a.k = k;
  a.t = t;
  FrontierWalk fw;
  fw.rows = w <= kFrontierPieceCells ? kFrontierPieceCells / w : 1;
  if (fw.rows > 32) fw.rows = 32;
  fw.units = (n + fw.rows - 1) / fw.rows;
  fw.div_w = ((1ull << 32) + w - 1) / w;
  const uintptr_t da = reinterpret_cast<uintptr_t>(delivered);
  fw.lead = static_cast<int>(((16 - da % 16) % 16) / 4);
  fw.flag_words = static_cast<int>(
      (static_cast<long long>(fw.rows) * k + 31) / 32) + 1;
  fw.warp_words = 2 * fw.flag_words + 2 * 32 + kFrontierPieceCells;
  const size_t smem =
      static_cast<size_t>(kFrontierWarps) * fw.warp_words * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frontier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(
      (fw.units + kFrontierWarps - 1) / kFrontierWarps);
  frontier_kernel<<<blocks, kFrontierThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      a, fw, static_cast<unsigned long long*>(flush_sent));
  return static_cast<int>(cudaGetLastError());
}
