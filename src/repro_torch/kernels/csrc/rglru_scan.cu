// rglru_scan: the RG-LRU linear recurrence of RecurrentGemma's recurrent
// blocks, elementwise over the LRU width,
//
//   h[b, t, w] = a[b, t, w] * h[b, t - 1, w] + x[b, t, w],
//   h[b, -1, w] = h0[b, w]  (0 without h0),
//
// with an f32 state; every step's state is written out (f32), so the
// caller takes h[:, -1] as the state it hands to decoding.
//
// Replaces the TPU kernel rglru_scan_kernel in
// src/repro/kernels/rglru_scan/kernel.py (launched by rglru_scan_pallas
// there, through rglru_scan in ops.py).  The prefill of every recurrent
// layer calls it once.
//
// What bounds it: memory.  It reads a and x once and writes h once,
// 12 bytes a cell in f32 (8 in bf16): at the recurrentgemma-9b prefill
// (B = 1, S = 2,254, W = 4,096, f32) 110.8 MB, 0.033 ms at the H100
// SXM's 3.35 TB/s.  A thread a (b, w) column walking S in order (the
// design this replaces) gives B x W threads, 4,096 at B = 1: 128 warps
// on 132 SMs, too few loads in flight to reach that rate (0.221 ms).
//
// The design is a single-pass chunked scan with decoupled look-back:
//
//   * S is cut into chunks of kScanL = 16 rows and W into tiles of 512
//     columns; a block takes one (chunk, b, tile), a warp 128 columns of
//     it, a lane kCols = 4 neighbouring columns (one 16-byte load of f32,
//     8 bytes of bf16, when W % 4 == 0 and the tensors are aligned).  At
//     the prefill shape that is 141 x 8 = 1,128 blocks, two an SM (178
//     registers).
//   * A lane issues the loads of all its chunk's rows of a and x before
//     it uses any, and keeps them in registers until it writes h: a and
//     x are read once, h written once.
//   * The chunk's aggregate per column is (D, H): D = 1 - A, A the
//     product of its a, and H its own scan from 0.  Aggregates compose as
//     (D1, H1) then (D2, H2) = (D1 + D2 - D1 D2, H1 - D2 H1 + H2), and a
//     carry h enters as h - D h + H.  The complement keeps the digits of a
//     product near 1 (a near 1 is the model's long memory), which A
//     itself would lose (tests/test_torch_rglru_chunked.py holds both
//     forms against float64).  The carry into chunk c is the state at the
//     end of chunk c - 1: h0 for chunk 0.
//   * Blocks take their work in chunk order by an atomic ticket, so a
//     block's predecessors have all started and none waits on a later
//     one: the spin below always ends.  The block with the last ticket
//     puts the counter back to 0 for the next launch.
//   * A lane publishes its chunk's aggregate with a flag, then looks
//     back over the chunks before it: it composes each predecessor's
//     aggregate until it finds one whose inclusive prefix (the state at
//     its end) is published, which gives its carry.  It runs the
//     recurrence over the registers from the carry, publishes the state
//     at its chunk's end as its own prefix, and writes h.  Flags are per
//     lane (kCols columns), so no lane waits on another lane's columns.
//   * The flags carry the launch's epoch (flag = epoch << 2 | state), so
//     the scratch (flags, aggregates, prefixes, ticket) is zeroed once
//     when the wrapper allocates it, not before every launch.
//
// What holds it above its bound at B = 1 is the filling and draining of
// ~4 generations of resident blocks, not the chain of prefixes: chunks
// of 32 rows (half the chain) were no faster at the prefill shape, nor
// were 2 or 1 columns a lane, a register cap for three blocks an SM, or a
// look-back that reads 4 predecessors a step (PERF.md).
//
// Where every lane finds its predecessor's prefix, h is the step by step
// recurrence; each aggregate composed instead reassociates it, as an
// associative scan does.  How far back a lane composes depends on
// timing, so two launches may differ in the last bits.
// tests/test_torch_rglru_chunked.py mirrors the arithmetic on the CPU.

#include <cstring>

#include "lm_common.cuh"

namespace repro_torch {

constexpr int kScanL = 16;       // rows of a chunk
constexpr int kCols = 4;         // neighbouring columns of a lane
constexpr int kScanWarps = 4;    // warps of a block
constexpr int kScanThreads = kScanWarps * 32;
constexpr unsigned kScanLanes = 0xffffffffu;  // a whole warp
constexpr int kScanTileCols = kScanThreads * kCols;  // columns of a block
constexpr int kFlagAggregate = 1;
constexpr int kFlagPrefix = 2;
// epochs run from 1 below this; the wrapper zeroes the scratch anew when
// its count reaches it
constexpr int kScanEpochs = 1 << 29;
// polls of a predecessor's flag before a lane gives up (seconds)
constexpr int kScanMaxPolls = 1 << 26;

// the scratch of a launch, carved from one int32 buffer the wrapper
// allocates and zeroes once (rt_rglru_scan_scratch gives its size)
struct ScanScratch {
  unsigned int* ticket;
  int* flags;      // (B, chunks, G): G = ceil(W / kCols) lanes' columns
  float* agg_d;    // (B, chunks, G, kCols): 1 - the chunk's product of a
  float* agg_h;    // the chunk's own scan from 0
  float* prefix;   // the state at the chunk's end
};

__host__ __device__ inline long long scan_groups(int b, int s, int w) {
  const long long chunks = (s + kScanL - 1) / kScanL;
  return static_cast<long long>(b) * chunks * ((w + kCols - 1) / kCols);
}

// int32 words of the scratch: the ticket (padded to 16 bytes), the flags
// (padded to 16 bytes), three float arrays of kCols a flag
inline long long scan_scratch_words(int b, int s, int w) {
  const long long g = scan_groups(b, s, w);
  return 4 + (g + 3) / 4 * 4 + 3 * kCols * g;
}

inline ScanScratch scan_scratch(void* base, int b, int s, int w) {
  const long long g = scan_groups(b, s, w);
  int* p = static_cast<int*>(base);
  ScanScratch sc;
  sc.ticket = reinterpret_cast<unsigned int*>(p);
  sc.flags = p + 4;
  float* v = reinterpret_cast<float*>(p + 4 + (g + 3) / 4 * 4);
  sc.agg_d = v;
  sc.agg_h = v + kCols * g;
  sc.prefix = v + 2 * kCols * g;
  return sc;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// one vector access of N bytes: its register type
template <int N> struct Bits;
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };

// kCols neighbouring elements from p (nc of them in the plane; 0 past
// it), streamed: each is read once
template <typename T, bool kVec>
__device__ __forceinline__ void load_cols(const T* p, int nc,
                                          T (&v)[kCols]) {
  if (kVec && nc == kCols) {
    using B = typename Bits<kCols * sizeof(T)>::type;
    const B q = __ldcs(reinterpret_cast<const B*>(p));
    memcpy(v, &q, sizeof(B));
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = j < nc ? p[j] : from_f32<T>(0.f);
  }
}

// a lane's kCols floats of a scratch array, through L2 (coherent across
// SMs), and h's
__device__ __forceinline__ void store_cg(float* p, const float (&v)[kCols]) {
  using B = typename Bits<kCols * 4>::type;
  B q;
  memcpy(&q, v, sizeof(B));
  __stcg(reinterpret_cast<B*>(p), q);
}

__device__ __forceinline__ void load_cg(const float* p, float (&v)[kCols]) {
  using B = typename Bits<kCols * 4>::type;
  const B q = __ldcg(reinterpret_cast<const B*>(p));
  memcpy(v, &q, sizeof(B));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kScanThreads)
    rglru_chunk_kernel(const T* __restrict__ a, const T* __restrict__ x,
                       const float* __restrict__ h0, float* __restrict__ h,
                       int batch, int s, int w, int chunks, int tiles,
                       ScanScratch sc, int epoch) {
  __shared__ unsigned int s_ticket;
  if (threadIdx.x == 0) {
    const unsigned int tk = atomicAdd(sc.ticket, 1u);
    if (tk == gridDim.x - 1) atomicExch(sc.ticket, 0u);  // the last ticket
    s_ticket = tk;
  }
  __syncthreads();
  const int tk = static_cast<int>(s_ticket);
  const int chunk = tk / (batch * tiles);
  const int b = tk % (batch * tiles) / tiles;
  const int tile = tk % tiles;
  const int lane = threadIdx.x & 31;
  const int g = (tile * kScanWarps + (threadIdx.x >> 5)) * 32 + lane;
  const int groups = (w + kCols - 1) / kCols;
  const int c0 = kCols * g;
  const bool in = g < groups;
  const int nc = in ? min(kCols, w - c0) : 0;
  const int t0 = chunk * kScanL;
  const int rows = min(kScanL, s - t0);

  // every row's a and x in flight before any is used
  T av[kScanL][kCols], xv[kScanL][kCols];
  const size_t base = (static_cast<size_t>(b) * s + t0) * w + c0;
#pragma unroll
  for (int r = 0; r < kScanL; ++r) {
    const int m = r < rows ? nc : 0;
    load_cols<T, kVec>(a + base + static_cast<size_t>(r) * w, m, av[r]);
    load_cols<T, kVec>(x + base + static_cast<size_t>(r) * w, m, xv[r]);
  }

  // the chunk's aggregate (D, H), rows in order
  float D[kCols], H[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) D[j] = H[j] = 0.f;
#pragma unroll
  for (int r = 0; r < kScanL; ++r) {
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float ar = to_f32(av[r][j]);
        H[j] = ar * H[j] + to_f32(xv[r][j]);
        D[j] = fmaf(1.f - ar, 1.f - D[j], D[j]);
      }
    }
  }

  const long long slot =
      (static_cast<long long>(b) * chunks + chunk) * groups + g;
  float carry[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) carry[j] = 0.f;
  if (chunk == 0) {
    if (h0 != nullptr) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nc) carry[j] = h0[static_cast<size_t>(b) * w + c0 + j];
    }
  } else {
    if (in) {
      store_cg(sc.agg_d + kCols * slot, D);
      store_cg(sc.agg_h + kCols * slot, H);
      st_release(sc.flags + slot, epoch << 2 | kFlagAggregate);
    }
    // look back: (Dacc, Hacc) composes the chunks after `prev` up to
    // chunk - 1
    float Dacc[kCols], Hacc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) Dacc[j] = Hacc[j] = 0.f;
    long long prev = slot - groups;
    bool done = !in;
    int polls = 0;
    while (__any_sync(kScanLanes, !done)) {
      if (!done) {
        const int f = ld_acquire(sc.flags + prev);
        if (f == (epoch << 2 | kFlagPrefix)) {
          float P[kCols];
          load_cg(sc.prefix + kCols * prev, P);
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            carry[j] = fmaf(-Dacc[j], P[j], P[j]) + Hacc[j];
          done = true;
        } else if (f == (epoch << 2 | kFlagAggregate)) {
          float Dj[kCols], Hj[kCols];
          load_cg(sc.agg_d + kCols * prev, Dj);
          load_cg(sc.agg_h + kCols * prev, Hj);
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            Hacc[j] = fmaf(-Dacc[j], Hj[j], Hj[j]) + Hacc[j];
            Dacc[j] = fmaf(-Dj[j], Dacc[j], Dj[j] + Dacc[j]);
          }
          prev -= groups;
        } else {
          // a flag that never comes (a broken scratch) fails the launch
          // instead of hanging the card: ~2^26 polls of 64 ns and more
          if (++polls > kScanMaxPolls) __trap();
          __nanosleep(64);
        }
      }
    }
  }
  if (!in) return;

  // the recurrence over the registers from the carry; the state at the
  // chunk's end is its inclusive prefix, published before h is written
  // (the release would otherwise wait for h's stores too)
  float y[kScanL][kCols];
#pragma unroll
  for (int r = 0; r < kScanL; ++r) {
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        carry[j] = to_f32(av[r][j]) * carry[j] + to_f32(xv[r][j]);
        y[r][j] = carry[j];
      }
    }
  }
  if (chunk + 1 < chunks) {  // a whole chunk: rows == kScanL
    store_cg(sc.prefix + kCols * slot, carry);
    st_release(sc.flags + slot, epoch << 2 | kFlagPrefix);
  }
  float* out = h + base;
#pragma unroll
  for (int r = 0; r < kScanL; ++r) {
    if (r < rows) {
      float* o = out + static_cast<size_t>(r) * w;
      if (kVec && nc == kCols) {
        using B = typename Bits<kCols * 4>::type;
        B q;
        memcpy(&q, y[r], sizeof(B));
        *reinterpret_cast<B*>(o) = q;
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j < nc) o[j] = y[r][j];
      }
    }
  }
}

template <typename T>
int launch_rglru(const void* a, const void* x, const void* h0, void* h,
                 void* scratch, int batch, int s, int w, int epoch,
                 cudaStream_t stream) {
  const int chunks = (s + kScanL - 1) / kScanL;
  const int tiles = (w + kScanTileCols - 1) / kScanTileCols;
  const long long blocks = static_cast<long long>(chunks) * batch * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // vector loads and stores: every row starts on a kCols-element
  // boundary and the tensors do too
  const auto al = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const bool vec = w % kCols == 0 && al(a, kCols * sizeof(T)) &&
                   al(x, kCols * sizeof(T)) && al(h, kCols * 4);
  const ScanScratch sc = scan_scratch(scratch, batch, s, w);
  const auto* at = static_cast<const T*>(a);
  const auto* xt = static_cast<const T*>(x);
  const auto* ht0 = static_cast<const float*>(h0);
  auto* ht = static_cast<float*>(h);
  if (vec) {
    rglru_chunk_kernel<T, true><<<static_cast<unsigned>(blocks),
                                  kScanThreads, 0, stream>>>(
        at, xt, ht0, ht, batch, s, w, chunks, tiles, sc, epoch);
  } else {
    rglru_chunk_kernel<T, false><<<static_cast<unsigned>(blocks),
                                   kScanThreads, 0, stream>>>(
        at, xt, ht0, ht, batch, s, w, chunks, tiles, sc, epoch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// int32 words of the scratch rt_rglru_scan needs at this shape (zeroed
// once by the caller, reused by every launch of a lower epoch); -1 past
// 2^31 words.
extern "C" int rt_rglru_scan_scratch(int batch, int s, int w) {
  using namespace repro_torch;
  if (batch <= 0 || s <= 0 || w <= 0) return 4;
  const long long words = scan_scratch_words(batch, s, w);
  return words > 0x7fffffffLL ? -1 : static_cast<int>(words);
}

// The epoch a launch's flags carry runs from 1 to rt_rglru_scan_epochs()
// - 1; the caller zeroes the scratch before it starts again at 1.
extern "C" int rt_rglru_scan_epochs() { return repro_torch::kScanEpochs; }

// a, x: (batch, s, w) of dtype; h0: (batch, w) f32 or null; h: (batch,
// s, w) f32; scratch: rt_rglru_scan_scratch(batch, s, w) int32 words,
// 16-byte aligned, zeroed before the first launch of epoch 1; epoch: one
// more than the launch before on this scratch.  Launches on one scratch
// must run in order (one stream).  Returns the cudaError_t of the
// launch.
extern "C" int rt_rglru_scan(const void* a, const void* x, const void* h0,
                             void* h, void* scratch, int batch, int s, int w,
                             int dtype, int epoch, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || s <= 0 || w <= 0) return 0;
  if (epoch <= 0 || epoch >= kScanEpochs ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_rglru<float>(a, x, h0, h, scratch, batch, s, w, epoch, st);
  if (dtype == kDtypeBF16)
    return launch_rglru<__nv_bfloat16>(a, x, h0, h, scratch, batch, s, w,
                                       epoch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
