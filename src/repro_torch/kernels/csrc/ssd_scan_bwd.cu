// ssd_scan_bwd: the backward of the chunked SSD scan (ssd_scan.cu,
// n_groups = 1).  For one batch row b, head h and chunk of Q steps, with
// the forward's notation — l the within-chunk cumsum of the log decay,
// L_ij = exp(l_i - l_j) for j <= i and 0 above, CB = C B^T, M = CB o L,
// w_j = exp(l_{Q-1} - l_j), H_prev the chunk's incoming (N, P) state —
// and dY, dH the gradients of the chunk's outputs and of its outgoing
// state (dh at the last chunk):
//
//   dX      = M^T dY + diag(w) B dH
//   dM      = (dY X^T) o tril,  dCB = dM o L,  G = dM o M
//   dC      = sum_h [dCB B + diag(e^l) dY H_prev^T]
//   dB      = sum_h [dCB^T C + diag(w) X dH^T]
//   dH_prev = e^{l_{Q-1}} dH + C^T diag(e^l) dY
//   dl_i    = sum_j G_ij - sum_k G_ki + e^{l_i} <dY_i, C_i H_prev> - r_i,
//             r_j = w_j <X_j, (B dH)_j>; at the last step also
//             + e^{l_{Q-1}} <H_prev, dH> + sum_j r_j
//   da_log  = the reverse cumsum of dl within the chunk.
//
// It is what autograd through the port's plain forward
// (kernels/ssd_scan/ref.py, ssd_chunk_scan_ref) computes for f32 and
// bf16 inputs, every product accumulated in f32 as there;
// ssd_chunk_scan_bwd_ref in the same file holds the formulas.  It replaces no TPU kernel of its
// own: the TPU kernel ssd_scan_kernel (src/repro/kernels/ssd_scan/
// kernel.py) has no backward, and the JAX package trains by
// differentiating ssd_chunk_scan_ref (src/repro/models/ssm.py).
//
// What bounds it: memory, at the mamba2-2.7b training shape (B = 1,
// S = 2,048, H = 80, P = 64, N = 128, Q = 128, bf16): x, a_log, B, C,
// dy and dh read once and the four gradients written once, 69 MB, 0.0206
// ms at 3.35 TB/s, against 16.2 GFLOP of products (a head's dY X^T and
// M^T dY on the lower triangle, B dH, dY H_prev^T, X dH^T and the two
// state walks' terms; a chunk's C B^T, S B and S^T C, S the heads' dCB
// summed), 0.0164 ms at the tensor cores' 989 TFLOP/s (chip_smoke.py's
// _ssd_bwd_bound counts both).  It is a pipeline of launches through an
// f32 scratch, so that every launch fills the card whatever the shape:
//
//   1. decay: l, e^l and w of every (b, chunk, h);
//   2. chunk_state: each chunk's own state terms B^T diag(w) X and
//      C^T diag(e^l) dY (N x P a head);
//   3. state_scan: a block a (b, h, 1,024 cells of the state) walks the
//      chunks forward (H_prev of each chunk) and back from dh (dH of
//      each), in place, with each slice's share of <H_prev, dH>;
//   4. cb: C B^T of each chunk's lower triangle, shared by the heads;
//   5. dcb: dY X^T on the lower triangle, for a group of 8 heads a
//      block: dCB summed over the group's heads in registers (a partial
//      per group, so no f32 atomic is used and the sums are
//      deterministic), each head's G summed along its rows and columns;
//   6. dx: M^T dY (M from C B^T and l) + diag(w) B dH, with C H_prev; r
//      and the e^l <dY, C H_prev> term summed along P;
//   7. dl: dl from those sums, then da_log;
//   8. dbc: dC = S B + sum_h diag(e^l) dY H_prev^T and dB = S^T C +
//      sum_h diag(w) X dH^T, S = the groups' dCB summed in order, the
//      head sums split by group into an f32 partial;
//   9. reduce: the groups' partials summed in order, cast to Bm's type.
//
// Two bodies run those steps, chosen by the shape alone as ssd_scan.cu
// chooses its forward's (rt_ssd_scan_bwd_body reports which):
//
//   * bf16 with Q <= 128 and N <= 128 (the main path's): the products of
//     steps 2, 4, 5, 6 and 8 on mma.sync.m16n8k16, bf16 in and f32
//     accumulated, fed by ldmatrix from cp.async-staged tiles zero-padded
//     to 128 rows of Q and N and 64 columns of P, so that no guard
//     separates an ldmatrix from its mma (the forward's lesson).  A bf16
//     input goes in as it is; an f32 intermediate goes in as its hi/lo
//     split, two products against the same bf16 fragment (about 16 bits
//     kept where one bf16 rounding keeps 8): M = CB o L, built and split
//     in registers from CB and l; S, split as it is summed from the
//     groups' partials; the states H_prev and dH, split as they are
//     staged; and the weighted w X and e^l dY of step 2, whose weight
//     runs along the reduction, split in registers.  diag(w) and
//     diag(e^l) that scale an output's rows are applied after the
//     product, so the bf16 side stays exact.  On the card the launches
//     were bound by the latency of their loads, not by the products, so
//     each keeps its loads in flight ahead of its products: chunk_state
//     and dcb walk a group of heads with the next head's tiles in flight
//     (chunk_state's B or C tile and dcb's CB staged once), dbc the same
//     with the next head's state loaded into registers, dx reads CB a
//     k-step ahead; and each weighted X is split by one warp only.  The
//     e^l <dY, C H_prev> term of dl comes from dbc's dY H_prev^T (the
//     rows of C o e^l dY H_prev^T summed), so dx keeps neither C nor
//     H_prev and two of its blocks fit an SM; dl runs after dbc.  Steps
//     1 and 7 are a warp a (b, c, h) (four steps a lane and a warp scan,
//     as the forward's warp 0 sums l); G's sums need no tiles (each row
//     tile belongs to one warp, each column's shares are summed in order
//     through shared memory).
//   * float32, or bf16 with a larger Q or N: every product on the CUDA
//     cores in f32 (TF32 keeps about three digits and would break the
//     f32 tolerance of 2e-5), a 64 x 64 output tile a block of 256
//     threads (4 x 4 outputs a thread, staged 32 deep through shared
//     memory, the next step's loads in flight during the current step's
//     products but in dx, which keeps three accumulator tiles); steps 1
//     and 7 a thread a (b, c, h).
//
// The scratch (rt_ssd_scan_bwd_scratch f32 words, 117 MB at the training
// shape for either body, two (B, NC, H, N, P) states among it) is the
// caller's and is dropped when the backward returns; nothing is saved
// from the forward.

#include "lm_common.cuh"

namespace repro_torch {

using bf16 = __nv_bfloat16;

constexpr int kBwdThreads = 256;
constexpr int kTile = 64;             // output tile of a product
constexpr int kStep = 32;             // depth staged a step
constexpr int kHeadsPerGroup = 8;     // heads a dcb / dbc block sums
constexpr int kScanSlice = 1024;      // state cells a state_scan block walks
constexpr int kScanPer = kScanSlice / kBwdThreads;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the staged operands of one step, rows padded to a 16-byte multiple; also
// a 64 x 65 f32 tile for the epilogues' sums (2 * 32 * 68 >= 64 * 65)
constexpr int kLd = kTile + 4;
// elements of A (and of B) a thread stages a step
constexpr int kStaged = kStep * kTile / kBwdThreads;
struct __align__(16) TileSmem {
  float a[kStep][kLd];
  float b[kStep][kLd];
};
typedef float SumTile[kTile + 1];

// the rows (columns) of a tile thread ty (tx) owns
__device__ __forceinline__ int owned(int t, int u) { return 4 * t + u; }

// acc[u][v] += sum_{k_begin <= k < k_end} A(m0 + 4 ty + u, k) B(k, n0 +
// 4 tx + v) for the rows below m and the columns below nn (ty = tid / 16,
// tx = tid % 16), with A and B read through la(i, k) and lb(k, j).  kA:
// A's k is contiguous in memory, so consecutive threads stage consecutive
// k (else consecutive rows); kB the same for B.  kPrefetch: the next
// step's elements are loaded into registers while the current step is
// multiplied (16 more registers a thread: on the card it pays where a
// block keeps one accumulator tile, and costs occupancy where it keeps
// three).  A thread reads its 4 rows of A and 4 columns of B of a k as
// two 16-byte words.  Every thread of the block calls it; it ends with a
// barrier, so the caller may reuse sm.
template <bool kA, bool kB, bool kPrefetch, class LA, class LB>
__device__ __forceinline__ void tile_product(TileSmem& sm, float (&acc)[4][4],
                                             int m0, int n0, int m, int nn,
                                             int k_begin, int k_end,
                                             const LA& la, const LB& lb) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float ra[kStaged], rb[kStaged];
  // element s of a step is (row or column, k) of A and of B
  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < kStaged; ++s) {
      const int e = tid + s * kBwdThreads;
      const int r = kA ? e / kStep : e % kTile;
      const int ka = kA ? e % kStep : e / kTile;
      const int c = kB ? e / kStep : e % kTile;
      const int kb = kB ? e % kStep : e / kTile;
      ra[s] = m0 + r < m && k0 + ka < k_end ? la(m0 + r, k0 + ka) : 0.0f;
      rb[s] = n0 + c < nn && k0 + kb < k_end ? lb(k0 + kb, n0 + c) : 0.0f;
    }
  };
  if (kPrefetch && k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kStep) {
    __syncthreads();  // the previous step is done with the tiles
    if (!kPrefetch) load(k0);
#pragma unroll
    for (int s = 0; s < kStaged; ++s) {
      const int e = tid + s * kBwdThreads;
      sm.a[kA ? e % kStep : e / kTile][kA ? e / kStep : e % kTile] = ra[s];
      sm.b[kB ? e % kStep : e / kTile][kB ? e / kStep : e % kTile] = rb[s];
    }
    __syncthreads();
    if (kPrefetch && k0 + kStep < k_end) load(k0 + kStep);
#pragma unroll 8
    for (int k = 0; k < kStep; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[k][4 * tx]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a4[u] * b4[v];
    }
  }
  __syncthreads();
}

// ---- loaders: (r, c) -> f32 element ------------------------------------ //
template <typename T>
struct RowMajor {  // m[r ld + c]
  const T* m;
  size_t ld;
  __device__ float operator()(int r, int c) const {
    return to_f32(m[r * ld + c]);
  }
};

template <typename T>
struct ColMajor {  // m[c ld + r]
  const T* m;
  size_t ld;
  __device__ float operator()(int r, int c) const {
    return to_f32(m[c * ld + r]);
  }
};

template <typename T>
struct ColMajorScaled {  // s[c] m[c ld + r]
  const T* m;
  const float* s;
  size_t ld;
  __device__ float operator()(int r, int c) const {
    return s[c] * to_f32(m[c * ld + r]);
  }
};

// M^T: (j, i) -> M_ij = CB_ij exp(l_i - l_j) for i >= j, masked before exp
struct MaskedT {
  const float* cb;  // (Q, Q) of the chunk
  const float* l;   // (Q,) of the chunk and head
  int q;
  __device__ float operator()(int j, int i) const {
    return i >= j ? cb[static_cast<size_t>(i) * q + j] * expf(l[i] - l[j])
                  : 0.0f;
  }
};

// S = the groups' dCB partials summed in order, masked to j <= i; kTrans
// reads S^T
template <bool kTrans>
struct GroupSum {
  const float* sp;  // (G, Q, Q) of the chunk
  int q, groups;
  __device__ float operator()(int r, int c) const {
    const int i = kTrans ? c : r, j = kTrans ? r : c;
    if (j > i) return 0.0f;
    const size_t qq = static_cast<size_t>(q) * q;
    const float* e = sp + static_cast<size_t>(i) * q + j;
    float acc = 0.0f;
    for (int g = 0; g < groups; ++g) acc += e[g * qq];
    return acc;
  }
};

template <typename T>
struct RowMajorScaled {  // s[r] m[r ld + c]
  const T* m;
  const float* s;
  size_t ld;
  __device__ float operator()(int r, int c) const {
    return s[r] * to_f32(m[r * ld + c]);
  }
};

// ---- 1. decay ----------------------------------------------------------- //
// al: (B, NC Q, H) f32; l, el, wl: (B, NC, H, Q).  Thread (b, c, h), in
// blocks of kRowThreads; the loads of kBatch steps are issued together.
constexpr int kRowThreads = 64;
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kRowThreads)
    ssd_bwd_decay_kernel(const float* __restrict__ al, float* __restrict__ l,
                         float* __restrict__ el, float* __restrict__ wl,
                         long long rows, int q, int nh) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (idx >= rows) return;
  const long long bc = idx / nh;
  const int hh = static_cast<int>(idx % nh);
  const float* a = al + static_cast<size_t>(bc) * q * nh + hh;
  float* lo = l + static_cast<size_t>(idx) * q;
  float acc = 0.0f;
  for (int i0 = 0; i0 < q; i0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = i0 + u < q ? a[static_cast<size_t>(i0 + u) * nh] : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u < q) {
        acc += v[u];
        lo[i0 + u] = acc;
      }
    }
  }
  for (int i = 0; i < q; ++i) {
    el[static_cast<size_t>(idx) * q + i] = expf(lo[i]);
    wl[static_cast<size_t>(idx) * q + i] = expf(acc - lo[i]);
  }
}

// ---- 2. chunk_state ----------------------------------------------------- //
// hs = B^T diag(w) X (z = 0), gs = C^T diag(e^l) dY (z = 1), (N, P) f32
// a (b, c, h).  Block (b, c, h), a tile of (N, P), z.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_chunk_state_kernel(const T* __restrict__ xb,
                               const T* __restrict__ dy,
                               const T* __restrict__ bm,
                               const T* __restrict__ cm,
                               const float* __restrict__ el,
                               const float* __restrict__ wl,
                               float* __restrict__ hs, float* __restrict__ gs,
                               int q, int nh, int p, int n) {
  __shared__ TileSmem sm;
  const size_t bch = blockIdx.x;
  const size_t bc = bch / nh, hh = bch % nh;
  const int tp = cdiv(p, kTile);
  const int n0 = (blockIdx.y / tp) * kTile, p0 = (blockIdx.y % tp) * kTile;
  const bool grad = blockIdx.z == 1;
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  const ColMajorScaled<T> a{(grad ? cm : bm) + row0 * n,
                            (grad ? el : wl) + bch * q,
                            static_cast<size_t>(n)};
  const RowMajor<T> b{(grad ? dy : xb) + row0 * ld + hh * p, ld};
  float acc[4][4] = {};
  tile_product<false, false, true>(sm, acc, n0, p0, n, p, 0, q, a, b);
  float* out = (grad ? gs : hs) + bch * n * p;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int nn = n0 + owned(ty, u);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int pp = p0 + owned(tx, v);
      if (nn < n && pp < p) out[static_cast<size_t>(nn) * p + pp] = acc[u][v];
    }
  }
}

// ---- 3. state_scan ------------------------------------------------------ //
// hs, gs: (B, NC, H, N P) f32, each chunk's own terms in, H_prev and dH of
// each chunk out; dh: (B, H, N P) f32; hd: (B, NC, H, slices), each
// slice's sum of H_prev dH.  Block (b, h), a slice of kScanSlice cells;
// the loads of kBatch chunks are issued before their stores, and their
// sums share one tree.
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_state_scan_kernel(float* __restrict__ hs, float* __restrict__ gs,
                              const float* __restrict__ dh,
                              const float* __restrict__ l,
                              float* __restrict__ hd, int nc, int q, int nh,
                              int cells) {
  __shared__ float red[kBatch][kBwdThreads];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x / nh, hh = blockIdx.x % nh;
  const int slice = blockIdx.y;
  const int first = slice * kScanSlice + tid;
  const size_t head0 = b * nc * nh + hh;  // (b, chunk 0, h)
  float run[kScanPer];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) run[k] = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float own[kBatch][kScanPer];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float* st = hs + (head0 + (c0 + u) * static_cast<size_t>(nh)) *
                                 cells;
#pragma unroll
      for (int k = 0; k < kScanPer; ++k) {
        const int cell = first + k * kBwdThreads;
        own[u][k] = c0 + u < nc && cell < cells ? st[cell] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u >= nc) break;
      const size_t bch = head0 + (c0 + u) * static_cast<size_t>(nh);
      const float dec = expf(l[bch * q + q - 1]);
      float* st = hs + bch * cells;
#pragma unroll
      for (int k = 0; k < kScanPer; ++k) {
        const int cell = first + k * kBwdThreads;
        if (cell < cells) st[cell] = run[k];
        run[k] = run[k] * dec + own[u][k];
      }
    }
  }
  const float* d0 = dh + (b * nh + hh) * cells;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    const int cell = first + k * kBwdThreads;
    run[k] = cell < cells ? d0[cell] : 0.0f;
  }
  for (int top = nc - 1; top >= 0; top -= kBatch) {
    // chunks top, top - 1, ..., down to top - kBatch + 1
    float own[kBatch][kScanPer], prev[kBatch][kScanPer];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = top - u;
      const size_t bch = head0 + static_cast<size_t>(c < 0 ? 0 : c) * nh;
#pragma unroll
      for (int k = 0; k < kScanPer; ++k) {
        const int cell = first + k * kBwdThreads;
        const bool in = c >= 0 && cell < cells;
        own[u][k] = in ? gs[bch * cells + cell] : 0.0f;
        prev[u][k] = in ? hs[bch * cells + cell] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = top - u;
      float part = 0.0f;
      if (c >= 0) {
        const size_t bch = head0 + static_cast<size_t>(c) * nh;
        const float dec = expf(l[bch * q + q - 1]);
#pragma unroll
        for (int k = 0; k < kScanPer; ++k) {
          const int cell = first + k * kBwdThreads;
          if (cell < cells) gs[bch * cells + cell] = run[k];
          part += prev[u][k] * run[k];
          run[k] = run[k] * dec + own[u][k];
        }
      }
      red[u][tid] = part;
    }
    __syncthreads();
    for (int s = kBwdThreads / 2; s > 0; s >>= 1) {
      if (tid < s) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) red[u][tid] += red[u][tid + s];
      }
      __syncthreads();
    }
    if (tid < kBatch && top - tid >= 0)
      hd[(head0 + static_cast<size_t>(top - tid) * nh) * gridDim.y + slice] =
          red[tid][0];
    __syncthreads();  // red is written again for the next batch
  }
}

// ---- 4. cb -------------------------------------------------------------- //
// cb: (B, NC, Q, Q) f32, C B^T of each chunk, 0 above the diagonal (the
// tiles wholly above it are not written and never read).  Block (b, c), a
// tile of (Q, Q).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                      float* __restrict__ cb, int q, int n) {
  __shared__ TileSmem sm;
  const size_t bc = blockIdx.x;
  const int tq = cdiv(q, kTile);
  const int i0 = (blockIdx.y / tq) * kTile, j0 = (blockIdx.y % tq) * kTile;
  if (j0 > i0) return;
  const size_t row0 = bc * q;
  float acc[4][4] = {};
  tile_product<true, true, true>(
      sm, acc, i0, j0, q, q, 0, n,
      RowMajor<T>{cm + row0 * n, static_cast<size_t>(n)},
      ColMajor<T>{bm + row0 * n, static_cast<size_t>(n)});
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + owned(ty, u);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + owned(tx, v);
      if (i < q && j < q)
        cb[(row0 + i) * q + j] = j <= i ? acc[u][v] : 0.0f;
    }
  }
}

// ---- 5. dcb ------------------------------------------------------------- //
// sp: (B, NC, G, Q, Q), the group's sum of dCB (lower tiles only); rowg:
// (B, NC, H, TQ, Q), G's row sums over each column tile; colg: the same
// for its column sums over each row tile.  Block (b, c), a lower tile of
// (Q, Q), a group of heads.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_dcb_kernel(const T* __restrict__ xb, const T* __restrict__ dy,
                       const float* __restrict__ cb,
                       const float* __restrict__ l, float* __restrict__ sp,
                       float* __restrict__ rowg, float* __restrict__ colg,
                       int q, int nh, int p) {
  __shared__ TileSmem sm;
  const size_t bc = blockIdx.x;
  const int tq = cdiv(q, kTile);
  const int ti = blockIdx.y / tq, tj = blockIdx.y % tq;
  if (tj > ti) return;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int groups = gridDim.z, g = blockIdx.z;
  const int h_end = min(nh, (g + 1) * kHeadsPerGroup);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  float cbv[4][4], s[4][4] = {};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + owned(ty, u);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + owned(tx, v);
      cbv[u][v] = i < q && j <= i ? cb[(row0 + i) * q + j] : 0.0f;
    }
  }
  SumTile* gt = reinterpret_cast<SumTile*>(&sm);
  for (int hh = g * kHeadsPerGroup; hh < h_end; ++hh) {
    const size_t bch = bc * nh + hh;
    const float* lv = l + bch * q;
    float acc[4][4] = {};
    tile_product<true, true, true>(sm, acc, i0, j0, q, q, 0, p,
                                   RowMajor<T>{dy + row0 * ld + hh * p, ld},
                                   ColMajor<T>{xb + row0 * ld + hh * p, ld});
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + owned(ty, u);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = j0 + owned(tx, v);
        float gv = 0.0f;
        if (i < q && j <= i) {  // masked before exp
          const float dcb = acc[u][v] * expf(lv[i] - lv[j]);
          s[u][v] += dcb;
          gv = dcb * cbv[u][v];  // dM M = dCB CB
        }
        gt[owned(ty, u)][owned(tx, v)] = gv;
      }
    }
    __syncthreads();
    if (tid < kTile) {
      if (i0 + tid < q) {
        float acc_r = 0.0f;
        for (int c = 0; c < kTile; ++c) acc_r += gt[tid][c];
        rowg[(bch * tq + tj) * q + i0 + tid] = acc_r;
      }
    } else if (tid < 2 * kTile) {
      const int c = tid - kTile;
      if (j0 + c < q) {
        float acc_c = 0.0f;
        for (int r = 0; r < kTile; ++r) acc_c += gt[r][c];
        colg[(bch * tq + ti) * q + j0 + c] = acc_c;
      }
    }
    // the next head's tile_product starts with a barrier
  }
  float* out = sp + (bc * groups + g) * q * q;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + owned(ty, u);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + owned(tx, v);
      if (i < q && j < q) out[static_cast<size_t>(i) * q + j] = s[u][v];
    }
  }
}

// ---- 6. dx -------------------------------------------------------------- //
// dx: (B, NC Q, H, P) in T; rp, ip: (B, NC, H, TP, Q), r and e^l <dY, C
// H_prev> summed over each tile of P.  Block (b, c, h), a tile of (Q, P).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_dx_kernel(const T* __restrict__ xb, const T* __restrict__ dy,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ cb,
                      const float* __restrict__ l,
                      const float* __restrict__ el,
                      const float* __restrict__ wl,
                      const float* __restrict__ hs,
                      const float* __restrict__ gs, T* __restrict__ dx,
                      float* __restrict__ rp, float* __restrict__ ip, int q,
                      int nh, int p, int n) {
  __shared__ TileSmem sm;
  __shared__ float it[kTile][kTile + 1];
  const size_t bch = blockIdx.x;
  const size_t bc = bch / nh, hh = bch % nh;
  const int tp = cdiv(p, kTile);
  const int ptile = blockIdx.y % tp;
  const int j0 = (blockIdx.y / tp) * kTile, p0 = ptile * kTile;
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  const T* dyh = dy + row0 * ld + hh * p;
  const T* xh = xb + row0 * ld + hh * p;
  float a1[4][4] = {}, a2[4][4] = {}, a3[4][4] = {};
  // M^T dY: only i >= j >= j0 contributes (three accumulator tiles: no
  // prefetch)
  tile_product<false, false, false>(sm, a1, j0, p0, q, p, j0, q,
                             MaskedT{cb + row0 * q, l + bch * q, q},
                             RowMajor<T>{dyh, ld});
  // B dH and C H_prev
  tile_product<true, false, false>(
      sm, a2, j0, p0, q, p, 0, n,
      RowMajor<T>{bm + row0 * n, static_cast<size_t>(n)},
      RowMajor<float>{gs + bch * n * p, static_cast<size_t>(p)});
  tile_product<true, false, false>(
      sm, a3, j0, p0, q, p, 0, n,
      RowMajor<T>{cm + row0 * n, static_cast<size_t>(n)},
      RowMajor<float>{hs + bch * n * p, static_cast<size_t>(p)});
  SumTile* rt = reinterpret_cast<SumTile*>(&sm);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + owned(ty, u);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int pp = p0 + owned(tx, v);
      float rv = 0.0f, iv = 0.0f;
      if (j < q && pp < p) {
        const float w = wl[bch * q + j];
        const size_t at = j * ld + pp;
        dx[row0 * ld + hh * p + at] = from_f32<T>(a1[u][v] + w * a2[u][v]);
        rv = w * to_f32(xh[at]) * a2[u][v];
        iv = el[bch * q + j] * to_f32(dyh[at]) * a3[u][v];
      }
      rt[owned(ty, u)][owned(tx, v)] = rv;
      it[owned(ty, u)][owned(tx, v)] = iv;
    }
  }
  __syncthreads();
  if (tid < 2 * kTile) {
    const int r = tid % kTile;
    if (j0 + r < q) {
      const float(*src)[kTile + 1] = tid < kTile ? rt : it;
      float acc = 0.0f;
      for (int c = 0; c < kTile; ++c) acc += src[r][c];
      (tid < kTile ? rp : ip)[(bch * tp + ptile) * q + j0 + r] = acc;
    }
  }
}

// ---- 7. dl -------------------------------------------------------------- //
// da: (B, NC Q, H) f32.  Thread (b, c, h), in blocks of kRowThreads; the
// sums of kBatch steps are loaded together.  (The partial sums laid out
// for neighbouring threads to read neighbouring words, (tiles, Q,
// B NC H), ran slower on the card, here and in the kernels writing them.)
__global__ void __launch_bounds__(kRowThreads)
    ssd_bwd_dl_kernel(const float* __restrict__ rowg,
                      const float* __restrict__ colg,
                      const float* __restrict__ rp,
                      const float* __restrict__ ip,
                      const float* __restrict__ hd,
                      const float* __restrict__ el, float* __restrict__ da,
                      long long rows, int q, int nh, int tq, int tp,
                      int slices) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (idx >= rows) return;
  const size_t bch = static_cast<size_t>(idx);
  const size_t bc = bch / nh, hh = bch % nh;
  const float* rg = rowg + bch * tq * q;
  const float* cg = colg + bch * tq * q;
  const float* r = rp + bch * tp * q;
  const float* in = ip + bch * tp * q;
  float rsum = 0.0f, hdot = 0.0f;
  for (int j = 0; j < tp * q; ++j) rsum += r[j];
  for (int s = 0; s < slices; ++s) hdot += hd[bch * slices + s];
  float acc = 0.0f;
  for (int top = q - 1; top >= 0; top -= kBatch) {
    float d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = top - u;
      d[u] = 0.0f;
      if (i < 0) continue;
      const int ti = i / kTile;
      for (int t = 0; t <= ti; ++t) d[u] += rg[t * q + i];
      for (int t = ti; t < tq; ++t) d[u] -= cg[t * q + i];
      for (int t = 0; t < tp; ++t) d[u] += in[t * q + i] - r[t * q + i];
    }
    if (top == q - 1) d[0] += el[bch * q + q - 1] * hdot + rsum;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = top - u;
      if (i < 0) break;
      acc += d[u];
      da[(bc * q + i) * nh + hh] = acc;
    }
  }
}

// ---- 8. dbc ------------------------------------------------------------- //
// pc, pb: (B, NC, G, Q, N) f32, a group's share of dC and dB (group 0 adds
// the dCB terms).  Block (b, c), a tile of (Q, N), z = 2 g + (0 dC, 1 dB).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_dbc_kernel(const T* __restrict__ xb, const T* __restrict__ dy,
                       const T* __restrict__ bm, const T* __restrict__ cm,
                       const float* __restrict__ sp,
                       const float* __restrict__ el,
                       const float* __restrict__ wl,
                       const float* __restrict__ hs,
                       const float* __restrict__ gs, float* __restrict__ pc,
                       float* __restrict__ pb, int q, int nh, int p, int n) {
  __shared__ TileSmem sm;
  const size_t bc = blockIdx.x;
  const int tn = cdiv(n, kTile);
  const int r0 = (blockIdx.y / tn) * kTile, n0 = (blockIdx.y % tn) * kTile;
  const int groups = gridDim.z / 2, g = blockIdx.z / 2;
  const bool db = blockIdx.z % 2 == 1;
  const int h0 = g * kHeadsPerGroup, h_end = min(nh, h0 + kHeadsPerGroup);
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  const float* sp_c = sp + bc * groups * q * q;
  float acc[4][4] = {};
  if (!db) {
    // S B: S_ij = 0 for j > i, so j < r0 + kTile
    if (g == 0)
      tile_product<true, false, true>(
          sm, acc, r0, n0, q, n, 0, min(q, r0 + kTile),
          GroupSum<false>{sp_c, q, groups},
          RowMajor<T>{bm + row0 * n, static_cast<size_t>(n)});
    // diag(e^l) dY H_prev^T of each head of the group (a product a head
    // ran faster on the card than one product over the group's (h, p),
    // whose loads must find each k's head)
    for (int hh = h0; hh < h_end; ++hh) {
      const size_t bch = bc * nh + hh;
      tile_product<true, true, true>(
          sm, acc, r0, n0, q, n, 0, p,
          RowMajorScaled<T>{dy + row0 * ld + hh * p, el + bch * q, ld},
          ColMajor<float>{hs + bch * n * p, static_cast<size_t>(p)});
    }
  } else {
    // S^T C: only i >= j >= r0
    if (g == 0)
      tile_product<false, false, true>(
          sm, acc, r0, n0, q, n, r0, q, GroupSum<true>{sp_c, q, groups},
          RowMajor<T>{cm + row0 * n, static_cast<size_t>(n)});
    // diag(w) X dH^T of each head of the group
    for (int hh = h0; hh < h_end; ++hh) {
      const size_t bch = bc * nh + hh;
      tile_product<true, true, true>(
          sm, acc, r0, n0, q, n, 0, p,
          RowMajorScaled<T>{xb + row0 * ld + hh * p, wl + bch * q, ld},
          ColMajor<float>{gs + bch * n * p, static_cast<size_t>(p)});
    }
  }
  float* out = (db ? pb : pc) + (bc * groups + g) * q * n;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + owned(ty, u);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int nn = n0 + owned(tx, v);
      if (r < q && nn < n) out[static_cast<size_t>(r) * n + nn] = acc[u][v];
    }
  }
}

// ---- 9. reduce ---------------------------------------------------------- //
// dc, db: (B, NC Q, N) in T, the groups' partials summed in order.  Thread
// (b, row, n), y = 0 dC, 1 dB.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_reduce_kernel(const float* __restrict__ pc,
                          const float* __restrict__ pb, T* __restrict__ dc,
                          T* __restrict__ db, long long cells, int q, int n,
                          int groups) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (idx >= cells) return;
  const bool is_b = blockIdx.y == 1;
  const size_t row = static_cast<size_t>(idx / n), nn = idx % n;
  const size_t bc = row / q, i = row % q;
  const float* part = (is_b ? pb : pc) + (bc * groups * q + i) * n + nn;
  const size_t stride = static_cast<size_t>(q) * n;
  float acc = 0.0f;
  for (int g = 0; g < groups; ++g) acc += part[g * stride];
  (is_b ? db : dc)[idx] = from_f32<T>(acc);
}

// ======================================================================= //
// The tensor-core body (bf16, Q <= 128, N <= 128): steps 1', 2', 4', 5',
// 6', 7' and 8' below, with steps 3 and 9 above.  P is cut into tiles of
// 64 (kTile), so the partial sums keep the FMA body's layout.
// ======================================================================= //
constexpr int kBwdBodyFma = 0;
constexpr int kBwdBodyMma = 1;
constexpr int kMmaPt = kTile;                // the P tile
// row strides of 128- and 64-wide bf16 tiles: odd numbers of 16-byte
// chunks, so the eight rows of an ldmatrix fall in different banks
constexpr int kLdT = kSsdTile + 8;
constexpr int kLdP = kMmaPt + 8;
constexpr int kRowWarps = 4;                 // warps a block of steps 1, 7
constexpr unsigned kFull = 0xffffffffu;

// The body a shape runs (lm_common.cuh's rule, the forward's).
inline int ssd_bwd_body(int q, int n, int dtype) {
  return ssd_tensor_cores(q, n, dtype) ? kBwdBodyMma : kBwdBodyFma;
}

// ldmatrix row addresses of a lane in a 16 x 16 block: (lrow_a, lcol_a)
// for A row-major and B [k][n] transposed, (lrow_b, lcol_b) for B [n][k]
// and A [k][m] transposed
__device__ __forceinline__ int lrow_a() {
  const int l = threadIdx.x & 31;
  return (l & 7) + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ int lcol_a() { return ((threadIdx.x & 31) >> 4) * 8; }
__device__ __forceinline__ int lrow_b() {
  const int l = threadIdx.x & 31;
  return (l & 7) + (l >> 4) * 8;
}
__device__ __forceinline__ int lcol_b() { return ((threadIdx.x >> 3) & 1) * 8; }

// A of rows m0.. and k0.. of a row-major [m][k] tile
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int ld,
                                    int m0, int k0) {
  ldsm_x4(a, smem_addr(t + (m0 + lrow_a()) * ld + k0 + lcol_a()));
}
// A of rows m0.. and k0.. from a [k][m] tile
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* t, int ld,
                                      int m0, int k0) {
  ldsm_x4_trans(a, smem_addr(t + (k0 + lrow_b()) * ld + m0 + lcol_b()));
}
// B of k0.. for the n8 tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]), from
// a [n][k] tile
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* t,
                                       int ld, int n0, int k0) {
  ldsm_x4(b, smem_addr(t + (n0 + lrow_b()) * ld + k0 + lcol_b()));
}
// the same from a [k][n] tile
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* t,
                                       int ld, int n0, int k0) {
  ldsm_x4_trans(b, smem_addr(t + (k0 + lrow_a()) * ld + n0 + lcol_a()));
}

// c[0..1] += a b of the n8 tiles b[0..1] and b[2..3]
__device__ __forceinline__ void mma2(float (&c)[2][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma_bf16(c[0], a, b[0], b[1]);
  mma_bf16(c[1], a, b[2], b[3]);
}

// Rows [0, R) and columns [0, C) of a bf16 tile (row stride ld) from the
// rows of src (row stride sld): (r, c) from src when r < rv and c < cv,
// zero past them.  vec: 16-byte cp.async copies (cv and sld multiples of
// 8, src 16-byte aligned), in flight until cp_async_wait; else element
// copies.  Every thread of the block calls it.
template <int R, int C>
__device__ __forceinline__ void stage(bf16* t, int ld, const bf16* src,
                                      size_t sld, int rv, int cv, int vec) {
  if (vec) {
    constexpr int kChunks = C / 8;
    for (int i = threadIdx.x; i < R * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool in = r < rv && c < cv;
      cp_async16(smem_addr(t + r * ld + c), in ? src + r * sld + c : src, in);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      t[r * ld + c] = r < rv && c < cv ? src[r * sld + c] : zero;
    }
  }
}

// Rows [0, R) and columns [0, 64) of an f32 plane (row stride sld),
// zero past rv rows and cv columns, THREADS threads each holding its
// share in registers (load_plane; 16-byte loads when vec4: sld and cv
// multiples of 4, src 16-byte aligned), then stored as the plane's hi
// and lo bf16 tiles (store_split, row stride kLdP).  Split so that a
// block can start the next plane's loads before it computes on this one.
template <int R, int THREADS>
struct PlaneRegs {
  static constexpr int kPer = R * (kMmaPt / 4) / THREADS;
  float4 v[kPer];
};

template <int R, int THREADS>
__device__ __forceinline__ void load_plane(PlaneRegs<R, THREADS>& pr,
                                           const float* src, int sld, int rv,
                                           int cv, int vec4) {
#pragma unroll
  for (int u = 0; u < PlaneRegs<R, THREADS>::kPer; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / (kMmaPt / 4), c = 4 * (i % (kMmaPt / 4));
    const float* at = src + static_cast<size_t>(r) * sld + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rv) {
      if (vec4) {
        if (c < cv) v = *reinterpret_cast<const float4*>(at);
      } else {
        if (c < cv) v.x = at[0];
        if (c + 1 < cv) v.y = at[1];
        if (c + 2 < cv) v.z = at[2];
        if (c + 3 < cv) v.w = at[3];
      }
    }
    pr.v[u] = v;
  }
}

template <int R, int THREADS>
__device__ __forceinline__ void store_split(const PlaneRegs<R, THREADS>& pr,
                                            bf16* hi, bf16* lo) {
#pragma unroll
  for (int u = 0; u < PlaneRegs<R, THREADS>::kPer; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / (kMmaPt / 4), c = 4 * (i % (kMmaPt / 4));
    uint2 h, l;
    split_bf16(pr.v[u].x, pr.v[u].y, h.x, l.x);
    split_bf16(pr.v[u].z, pr.v[u].w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * kLdP + c) = h;
    *reinterpret_cast<uint2*>(lo + r * kLdP + c) = l;
  }
}

// out[0..1] = (a, b) where in (and b where in1): one 8-byte store when
// pair (an even row stride and column), else two
__device__ __forceinline__ void store_pair(float* out, float a, float b,
                                           bool in, bool in1, bool pair) {
  if (!in) return;
  if (pair && in1) {
    *reinterpret_cast<float2*>(out) = make_float2(a, b);
  } else {
    out[0] = a;
    if (in1) out[1] = b;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---- 1'. decay: a warp a (b, c, h) -------------------------------------- //
__global__ void __launch_bounds__(32 * kRowWarps)
    ssd_bwd_decay_warp_kernel(const float* __restrict__ al,
                              float* __restrict__ l, float* __restrict__ el,
                              float* __restrict__ wl, long long rows, int q,
                              int nh) {
  const long long idx = static_cast<long long>(blockIdx.x) * kRowWarps +
                        threadIdx.x / 32;
  if (idx >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long bc = idx / nh;
  const int hh = static_cast<int>(idx % nh);
  const float* a = al + static_cast<size_t>(bc) * q * nh + hh;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    v[k] = i < q ? a[static_cast<size_t>(i) * nh] : 0.0f;
  }
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float incl = v[3];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  const float excl = incl - v[3];
  // l_{q-1}: the zero decays past q keep it
  const float lq = __shfl_sync(kFull, incl, 31);
  const size_t base = static_cast<size_t>(idx) * q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    if (i < q) {
      const float li = v[k] + excl;
      l[base + i] = li;
      el[base + i] = expf(li);
      wl[base + i] = expf(lq - li);
    }
  }
}

// ---- 2'. chunk_state ---------------------------------------------------- //
// hs = B^T diag(w) X (z = 0), gs = C^T diag(e^l) dY (z = 1).  Block (b,
// c), a group of heads, z; warp w all of N and the columns 16 w.. of the
// P tile, so each weighted X is split once, in registers.  The chunk's B
// (C) tile is staged once; each (head, P tile) step's X (dY) tile and
// weights are double-buffered.  A = B^T by ldmatrix.trans of the [j][n]
// tile.
constexpr int kCsThreads = 128;
constexpr size_t kCsSmem =
    2 * (static_cast<size_t>(kSsdTile) * kLdT + 2 * kSsdTile * kLdP) +
    2 * 4 * kSsdTile;

__global__ void __launch_bounds__(kCsThreads, 3)
    ssd_bwd_chunk_state_mma_kernel(const bf16* __restrict__ xb,
                                   const bf16* __restrict__ dy,
                                   const bf16* __restrict__ bm,
                                   const bf16* __restrict__ cm,
                                   const float* __restrict__ el,
                                   const float* __restrict__ wl,
                                   float* __restrict__ hs,
                                   float* __restrict__ gs, int q, int nh,
                                   int p, int n, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bt = reinterpret_cast<bf16*>(smem);  // (128, kLdT) B or C, [j][n]
  bf16* xts = bt + kSsdTile * kLdT;  // two (128, kLdP) X or dY, [j][p]
  float* wts = reinterpret_cast<float*>(xts + 2 * kSsdTile * kLdP);
  const size_t bc = blockIdx.x;
  const int h0 = blockIdx.y * kHeadsPerGroup;
  const int h_end = min(nh, h0 + kHeadsPerGroup);
  const bool grad = blockIdx.z == 1;
  const int tp = cdiv(p, kMmaPt), steps = (h_end - h0) * tp;
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  const bf16* src = grad ? dy : xb;
  const float* wv = grad ? el : wl;
  stage<kSsdTile, kSsdTile>(bt, kLdT, (grad ? cm : bm) + row0 * n, n, q, n,
                            vec);
  // step st's X (dY) tile and weights into buffer st % 2
  const auto prefetch = [&](int st) {
    const size_t bch = bc * nh + h0 + st / tp;
    const int pt = (st % tp) * kMmaPt;
    stage<kSsdTile, kMmaPt>(xts + (st % 2) * kSsdTile * kLdP, kLdP,
                            src + row0 * ld + (bch % nh) * p + pt, ld, q,
                            p - pt, vec);
    for (int i = threadIdx.x; i < kSsdTile; i += kCsThreads) {
      float* w = wts + (st % 2) * kSsdTile + i;
      if (i < q)
        cp_async4(smem_addr(w), wv + bch * q + i);
      else
        *w = 0.0f;
    }
    cp_async_commit();
  };
  prefetch(0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      prefetch(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's tiles are in
    const bf16* xt = xts + (st % 2) * kSsdTile * kLdP;
    const float* wt = wts + (st % 2) * kSsdTile;
    float acc[kSsdTiles][2][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kSsdTiles; ++kk) {
      const int j0 = 16 * kk;
      const float w0 = wt[j0 + 2 * t], w1 = wt[j0 + 2 * t + 1];
      const float w2 = wt[j0 + 2 * t + 8], w3 = wt[j0 + 2 * t + 9];
      uint32_t xf[4];
      ldb_kn(xf, xt, kLdP, 16 * warp, j0);
      uint32_t whi[2][2], wlo[2][2];  // [n8 tile][k 2t.. or 2t + 8..]
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 xa = unpack_bf16(xf[2 * hf]);      // k 2t, 2t + 1
        const float2 xc = unpack_bf16(xf[2 * hf + 1]);  // k 2t + 8, 2t + 9
        split_bf16(xa.x * w0, xa.y * w1, whi[hf][0], wlo[hf][0]);
        split_bf16(xc.x * w2, xc.y * w3, whi[hf][1], wlo[hf][1]);
      }
#pragma unroll
      for (int mi = 0; mi < kSsdTiles; ++mi) {
        uint32_t af[4];
        lda_t(af, bt, kLdT, 16 * mi, j0);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mma_bf16(acc[mi][hf], af, whi[hf][0], whi[hf][1]);
          mma_bf16(acc[mi][hf], af, wlo[hf][0], wlo[hf][1]);
        }
      }
    }
    const size_t bch = bc * nh + h0 + st / tp;
    const int p0 = (st % tp) * kMmaPt + 16 * warp;
    float* out = (grad ? gs : hs) + bch * n * p;
#pragma unroll
    for (int mi = 0; mi < kSsdTiles; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * mi + g + 8 * hr;
          const int col = p0 + 8 * hf + 2 * t;
          store_pair(out + static_cast<size_t>(row) * p + col,
                     acc[mi][hf][2 * hr], acc[mi][hf][2 * hr + 1],
                     row < n && col < p, col + 1 < p, p % 2 == 0);
        }
    __syncthreads();  // buffer st % 2 is free again
  }
}

// ---- 4'. cb ------------------------------------------------------------- //
// cb as step 4 writes it; block (b, c), warp w the row tiles w and 7 - w
// (the lower triangle's column tiles even across the warps).
constexpr int kCbThreads = 128;
constexpr size_t kCbSmem = 2 * 2 * static_cast<size_t>(kSsdTile) * kLdT;

__global__ void __launch_bounds__(kCbThreads)
    ssd_bwd_cb_mma_kernel(const bf16* __restrict__ bm,
                          const bf16* __restrict__ cm, float* __restrict__ cb,
                          int q, int n, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ct = reinterpret_cast<bf16*>(smem);  // (128, kLdT) C, [i][n]
  bf16* bt = ct + kSsdTile * kLdT;           // (128, kLdT) B, [j][n]
  const size_t row0 = static_cast<size_t>(blockIdx.x) * q;
  stage<kSsdTile, kSsdTile>(ct, kLdT, cm + row0 * n, n, q, n, vec);
  stage<kSsdTile, kSsdTile>(bt, kLdT, bm + row0 * n, n, q, n, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int rt = pass ? kSsdTiles - 1 - warp : warp, i0 = 16 * rt;
    uint32_t cf[kSsdTiles][4];
#pragma unroll
    for (int kk = 0; kk < kSsdTiles; ++kk) lda(cf[kk], ct, kLdT, i0, 16 * kk);
#pragma unroll 1
    for (int kc = 0; kc <= rt; ++kc) {
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kSsdTiles; ++kk) {
        uint32_t bf[4];
        ldb_nk(bf, bt, kLdT, 16 * kc, 16 * kk);
        mma2(s, cf[kk], bf);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = i0 + g + 8 * hr, j = 16 * kc + 8 * nt + 2 * t;
          store_pair(cb + (row0 + i) * q + j, j <= i ? s[nt][2 * hr] : 0.0f,
                     j + 1 <= i ? s[nt][2 * hr + 1] : 0.0f, i < q && j < q,
                     j + 1 < q, q % 2 == 0);
        }
    }
  }
}

// ---- 5'. dcb ------------------------------------------------------------ //
// sp as step 5 writes it; rowg, colg: (B, NC, H, Q), G's sums along each
// row and each column.  Block (b, c), a group of heads; warp w the row
// tiles w and 7 - w, its 9 column tiles k = 0..8 (k <= w: row tile w,
// column tile k; else row tile 7 - w, column tile k - w - 1).  dY X^T
// takes bf16 operands as they are; the group's dCB stays in registers.
// The chunk's CB (its lower triangle, packed by rows) is staged once; the
// (head, P tile) steps' dY and X tiles and l are double-buffered: the
// next step's copies are in flight while this one's products run.
constexpr int kDcbThreads = 128;
constexpr int kDcbCols = kSsdTiles + 1;  // column tiles a warp owns
constexpr int kTri = kSsdTile * (kSsdTile + 1) / 2;
constexpr size_t kDcbSmem = 2 * 4 * static_cast<size_t>(kSsdTile) * kLdP +
                            4 * (kTri + 2 * kSsdTile +
                                 (kDcbThreads / 32) * 2 * kSsdTile);

__global__ void __launch_bounds__(kDcbThreads, 2)
    ssd_bwd_dcb_mma_kernel(const bf16* __restrict__ xb,
                           const bf16* __restrict__ dy,
                           const float* __restrict__ cb,
                           const float* __restrict__ l,
                           float* __restrict__ sp, float* __restrict__ rowg,
                           float* __restrict__ colg, int q, int nh, int p,
                           int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  // buffer u: dY (128, kLdP) [i][p] at tiles + 2 u, X [j][p] at 2 u + 1
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  float* cbt = reinterpret_cast<float*>(tiles + 4 * kSsdTile * kLdP);
  float* ls = cbt + kTri;  // l of buffer u at ls + 128 u
  // (warps, 2 row tiles, 128): each row tile's share of G's column sums
  float* colp = ls + 2 * kSsdTile;
  const size_t bc = blockIdx.x;
  const int groups = gridDim.y, grp = blockIdx.y;
  const int h0 = grp * kHeadsPerGroup, h_end = min(nh, h0 + kHeadsPerGroup);
  const int tp = cdiv(p, kMmaPt), steps = (h_end - h0) * tp;
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // CB_ij (j <= i) at cbt[i (i + 1) / 2 + j], zero past q
  const float* cbc = cb + row0 * q;
  for (int e = tid; e < kSsdTile * kSsdTile; e += kDcbThreads) {
    const int i = e / kSsdTile, j = e % kSsdTile;
    if (j > i) continue;
    float* at = cbt + i * (i + 1) / 2 + j;
    if (i < q)
      cp_async4(smem_addr(at), cbc + static_cast<size_t>(i) * q + j);
    else
      *at = 0.0f;
  }
  // step st's dY and X tiles and l into buffer st % 2
  const auto stage_step = [&](int st) {
    const int hh = h0 + st / tp, pt = (st % tp) * kMmaPt;
    bf16* yt = tiles + (st % 2) * 2 * kSsdTile * kLdP;
    const size_t off = row0 * ld + hh * p + pt;
    stage<kSsdTile, kMmaPt>(yt, kLdP, dy + off, ld, q, p - pt, vec);
    stage<kSsdTile, kMmaPt>(yt + kSsdTile * kLdP, kLdP, xb + off, ld, q,
                            p - pt, vec);
    for (int i = tid; i < kSsdTile; i += kDcbThreads) {
      float* at = ls + (st % 2) * kSsdTile + i;
      if (i < q)
        cp_async4(smem_addr(at), l + (bc * nh + hh) * q + i);
      else
        *at = 0.0f;
    }
    cp_async_commit();
  };
  stage_step(0);
  float s[kDcbCols][2][4] = {};
  float d[kDcbCols][2][4];
  for (int st = 0; st < steps; ++st) {
    const int hh = h0 + st / tp, pt = (st % tp) * kMmaPt;
    if (st + 1 < steps) {
      stage_step(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step st's tiles (and CB) are in
    const bf16* yt = tiles + (st % 2) * 2 * kSsdTile * kLdP;
    const bf16* xt = yt + kSsdTile * kLdP;
    if (pt == 0) {
#pragma unroll
      for (int k = 0; k < kDcbCols; ++k)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[k][nt][e] = 0.0f;
    }
    uint32_t af[kMmaPt / 16][4];
#pragma unroll
    for (int k = 0; k < kDcbCols; ++k) {
      const bool second = k > warp;
      const int rt = second ? kSsdTiles - 1 - warp : warp;
      const int kc = second ? k - warp - 1 : k;
      if (k == 0 || k == warp + 1) {
#pragma unroll
        for (int kk = 0; kk < kMmaPt / 16; ++kk)
          lda(af[kk], yt, kLdP, 16 * rt, 16 * kk);
      }
#pragma unroll
      for (int kk = 0; kk < kMmaPt / 16; ++kk) {
        uint32_t bf[4];
        ldb_nk(bf, xt, kLdP, 16 * kc, 16 * kk);
        mma2(d[k], af[kk], bf);
      }
    }
    if (pt + kMmaPt >= p) {
      // the head's last P tile: dCB = (dY X^T) o L on j <= i (masked
      // before exp), summed into the group's; G = dCB o CB summed along
      // its rows and columns
      const size_t bch = bc * nh + hh;
      const float* lh = ls + (st % 2) * kSsdTile;
      float rs[2][2] = {};  // [row tile w, 7 - w][row g, g + 8]
#pragma unroll
      for (int k = 0; k < kDcbCols; ++k) {
        const bool second = k > warp;
        const int rt = second ? kSsdTiles - 1 - warp : warp;
        const int kc = second ? k - warp - 1 : k;
        float cs[2][2] = {};  // [n8 tile][column 2t, 2t + 1]
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * rt + g + 8 * (e >> 1);
            const int j = 16 * kc + 8 * nt + 2 * t + (e & 1);
            // (within the tile's rows, so in the packed triangle for any j)
            const float cbv = cbt[i * (i + 1) / 2 + j];
            const float dcb =
                i < q && j <= i
                    ? d[k][nt][e] * exp2_ftz((lh[i] - lh[j]) * kLog2e)
                    : 0.0f;
            s[k][nt][e] += dcb;
            const float gv = dcb * cbv;
            if (second)
              rs[1][e >> 1] += gv;
            else
              rs[0][e >> 1] += gv;
            cs[nt][e & 1] += gv;
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = cs[nt][c];
            v += __shfl_xor_sync(kFull, v, 4);
            v += __shfl_xor_sync(kFull, v, 8);
            v += __shfl_xor_sync(kFull, v, 16);
            if (g == 0)
              colp[(warp * 2 + second) * kSsdTile + 16 * kc + 8 * nt +
                   2 * t + c] = v;
          }
      }
#pragma unroll
      for (int pass = 0; pass < 2; ++pass)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float v = rs[pass][hr];
          v += __shfl_xor_sync(kFull, v, 1);
          v += __shfl_xor_sync(kFull, v, 2);
          const int i =
              16 * (pass ? kSsdTiles - 1 - warp : warp) + g + 8 * hr;
          if (t == 0 && i < q) rowg[bch * q + i] = v;
        }
      __syncthreads();
      // column j: the shares of the row tiles at or below its tile, in
      // order
      for (int j = tid; j < q; j += kDcbThreads) {
        float acc = 0.0f;
        for (int w = 0; w < kDcbThreads / 32; ++w)
          for (int sl = 0; sl < 2; ++sl) {
            const int rt = sl ? kSsdTiles - 1 - w : w;
            if (rt >= j / 16) acc += colp[(w * 2 + sl) * kSsdTile + j];
          }
        colg[bch * q + j] = acc;
      }
    }
    __syncthreads();  // buffer st % 2 and colp are free again
  }
  float* out = sp + (bc * groups + grp) * q * q;
#pragma unroll
  for (int k = 0; k < kDcbCols; ++k) {
    const bool second = k > warp;
    const int rt = second ? kSsdTiles - 1 - warp : warp;
    const int kc = second ? k - warp - 1 : k;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 16 * rt + g + 8 * hr;
        const int j = 16 * kc + 8 * nt + 2 * t;
        store_pair(out + static_cast<size_t>(i) * q + j, s[k][nt][2 * hr],
                   s[k][nt][2 * hr + 1], i < q && j < q, j + 1 < q,
                   q % 2 == 0);
      }
  }
}

// ---- 6'. dx ------------------------------------------------------------- //
// dx and rp as step 6 writes them (e^l <dY, C H_prev> comes from step 8').
// Block (b, c, h), a P tile; warp w the row tile w of dX.  B dH: B as it
// is, dH split, diag(w) applied after the product; M^T dY: M = CB o L
// split in registers as it is built from CB (read a k-step ahead) and l,
// dY as it is.
constexpr int kDxThreads = 256;
constexpr size_t kDxSmem = 2 * static_cast<size_t>(kSsdTile) * kLdT +
                           3 * 2 * static_cast<size_t>(kSsdTile) * kLdP +
                           2 * 4 * kSsdTile;

__global__ void __launch_bounds__(kDxThreads, 2)
    ssd_bwd_dx_mma_kernel(const bf16* __restrict__ xb,
                          const bf16* __restrict__ dy,
                          const bf16* __restrict__ bm,
                          const float* __restrict__ cb,
                          const float* __restrict__ l,
                          const float* __restrict__ wl,
                          const float* __restrict__ gs, bf16* __restrict__ dx,
                          float* __restrict__ rp, int q, int nh, int p, int n,
                          int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bt = reinterpret_cast<bf16*>(smem);  // (128, kLdT) B, [j][n]
  bf16* yt = bt + kSsdTile * kLdT;           // (128, kLdP) dY, [i][p]
  bf16* dhh = yt + kSsdTile * kLdP;          // (128, kLdP) dH hi, [n][p]
  bf16* dhl = dhh + kSsdTile * kLdP;         // dH lo
  float* l2s = reinterpret_cast<float*>(dhl + kSsdTile * kLdP);
  float* wls = l2s + kSsdTile;
  const size_t bch = blockIdx.x;
  const size_t bc = bch / nh, hh = bch % nh;
  const int tp = gridDim.y, ptile = blockIdx.y, p0 = ptile * kMmaPt;
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  stage<kSsdTile, kSsdTile>(bt, kLdT, bm + row0 * n, n, q, n, vec);
  stage<kSsdTile, kMmaPt>(yt, kLdP, dy + row0 * ld + hh * p + p0, ld, q,
                          p - p0, vec);
  cp_async_commit();
  {
    PlaneRegs<kSsdTile, kDxThreads> dh_regs;
    load_plane(dh_regs, gs + bch * n * p + p0, p, n, p - p0, p % 4 == 0);
    for (int i = threadIdx.x; i < kSsdTile; i += kDxThreads) {
      const bool in = i < q;
      l2s[i] = in ? l[bch * q + i] * kLog2e : 0.0f;
      wls[i] = in ? wl[bch * q + i] : 0.0f;
    }
    store_split(dh_regs, dhh, dhl);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = 16 * warp;
  // M^T dY (a1) from the row tile's first k-step on; the A fragment of a
  // k-step: register r holds rows j0 + g + 8 (r & 1), columns i0 + 2t +
  // 8 (r >> 1) and the next; CB read a k-step ahead
  const float* cbc = cb + row0 * q;
  const auto load_cb = [&](int kk, float (&v)[8]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + g + 8 * (r & 1);
        const int i = 16 * kk + 2 * t + 8 * (r >> 1) + c;
        v[2 * r + c] = kk < kSsdTiles && i >= j && i < q
                           ? __ldg(cbc + static_cast<size_t>(i) * q + j)
                           : 0.0f;
      }
  };
  float cur[8];
  load_cb(warp, cur);
  // B dH (a2) over the padded N
  float a2[8][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < kSsdTiles; ++kk) {
    uint32_t bf[4];
    lda(bf, bt, kLdT, j0, 16 * kk);
#pragma unroll
    for (int pn = 0; pn < kMmaPt / 16; ++pn) {
      uint32_t hi[4], lo[4];
      ldb_kn(hi, dhh, kLdP, 16 * pn, 16 * kk);
      ldb_kn(lo, dhl, kLdP, 16 * pn, 16 * kk);
      mma_bf16(a2[2 * pn], bf, hi[0], hi[1]);
      mma_bf16(a2[2 * pn + 1], bf, hi[2], hi[3]);
      mma_bf16(a2[2 * pn], bf, lo[0], lo[1]);
      mma_bf16(a2[2 * pn + 1], bf, lo[2], lo[3]);
    }
  }
  float a1[8][4] = {};
  const float lj[2] = {l2s[j0 + g], l2s[j0 + g + 8]};
#pragma unroll 1
  for (int kk = warp; kk < kSsdTiles; ++kk) {
    const int i0 = 16 * kk;
    float nxt[8];
    load_cb(kk + 1, nxt);
    // A (j, i) = M_ij = CB_ij exp(l_i - l_j) for i >= j, masked before
    // exp, split
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + g + 8 * (r & 1);
      float m[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + 2 * t + 8 * (r >> 1) + c;
        m[c] = i >= j && i < q
                   ? cur[2 * r + c] * exp2_ftz(l2s[i] - lj[r & 1])
                   : 0.0f;
      }
      split_bf16(m[0], m[1], ahi[r], alo[r]);
    }
#pragma unroll
    for (int pn = 0; pn < kMmaPt / 16; ++pn) {
      uint32_t yf[4];
      ldb_kn(yf, yt, kLdP, 16 * pn, i0);
      mma_bf16(a1[2 * pn], ahi, yf[0], yf[1]);
      mma_bf16(a1[2 * pn + 1], ahi, yf[2], yf[3]);
      mma_bf16(a1[2 * pn], alo, yf[0], yf[1]);
      mma_bf16(a1[2 * pn + 1], alo, yf[2], yf[3]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) cur[e] = nxt[e];
  }
  // dX = M^T dY + diag(w) B dH; r summed along the tile's P
  const bf16* xh = xb + row0 * ld + hh * p;
  bf16* dxh = dx + row0 * ld + hh * p;
  float rsum[2] = {};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = j0 + g + 8 * hr, pc = p0 + 8 * nt + 2 * t;
      if (j >= q || pc >= p) continue;
      const float w = wls[j];
      const size_t at = static_cast<size_t>(j) * ld + pc;
      const float d0 = a1[nt][2 * hr] + w * a2[nt][2 * hr];
      const float d1 = a1[nt][2 * hr + 1] + w * a2[nt][2 * hr + 1];
      if (vec) {  // pc + 1 < p, and a 4-byte boundary
        *reinterpret_cast<__nv_bfloat162*>(dxh + at) =
            __floats2bfloat162_rn(d0, d1);
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xh + at));
        rsum[hr] += w * (xv.x * a2[nt][2 * hr] + xv.y * a2[nt][2 * hr + 1]);
      } else {
        dxh[at] = __float2bfloat16(d0);
        rsum[hr] += w * to_f32(xh[at]) * a2[nt][2 * hr];
        if (pc + 1 < p) {
          dxh[at + 1] = __float2bfloat16(d1);
          rsum[hr] += w * to_f32(xh[at + 1]) * a2[nt][2 * hr + 1];
        }
      }
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float rv = rsum[hr];
    rv += __shfl_xor_sync(kFull, rv, 1);
    rv += __shfl_xor_sync(kFull, rv, 2);
    const int j = j0 + g + 8 * hr;
    if (t == 0 && j < q) rp[(bch * tp + ptile) * q + j] = rv;
  }
}

// ---- 7'. dl: a warp a (b, c, h) ----------------------------------------- //
// rowg and colg (B, NC, H, Q) as step 5' writes them, rp (B, NC, H, TP, Q)
// as step 6' writes it, ip (B, NC, H, TN, Q) as step 8' writes it, hd as
// step 3 does.  dl of the lane's four steps, then da by a reverse scan
// along the lane's steps and down the lanes.
__global__ void __launch_bounds__(32 * kRowWarps)
    ssd_bwd_dl_warp_kernel(const float* __restrict__ rowg,
                           const float* __restrict__ colg,
                           const float* __restrict__ rp,
                           const float* __restrict__ ip,
                           const float* __restrict__ hd,
                           const float* __restrict__ el, float* __restrict__ da,
                           long long rows, int q, int nh, int tp, int tn,
                           int slices) {
  const long long idx = static_cast<long long>(blockIdx.x) * kRowWarps +
                        threadIdx.x / 32;
  if (idx >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t bch = static_cast<size_t>(idx);
  const size_t bc = bch / nh, hh = bch % nh;
  const float* r = rp + bch * tp * q;
  const float* in = ip + bch * tn * q;
  float rsum = 0.0f, hdot = 0.0f;
  for (int j = lane; j < tp * q; j += 32) rsum += r[j];
  for (int s = lane; s < slices; s += 32) hdot += hd[bch * slices + s];
  rsum = warp_sum(rsum);
  hdot = warp_sum(hdot);
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    d[k] = 0.0f;
    if (i < q) {
      d[k] = rowg[bch * q + i] - colg[bch * q + i];
      for (int tt = 0; tt < tn; ++tt) d[k] += in[tt * q + i];
      for (int tt = 0; tt < tp; ++tt) d[k] -= r[tt * q + i];
      if (i == q - 1) d[k] += el[bch * q + i] * hdot + rsum;
    }
  }
  // suffix sums of the lane's steps, then of the lanes above
  d[2] += d[3];
  d[1] += d[2];
  d[0] += d[1];
  float incl = d[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += u;
  }
  const float above = incl - d[0];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    if (i < q) da[(bc * q + i) * nh + hh] = d[k] + above;
  }
}

// ---- 8'. dbc ------------------------------------------------------------ //
// pc, pb as step 8 writes them; ip: (B, NC, H, TN, Q), e^l <dY, C H_prev>
// summed over each tile of N.  Block (b, c), a tile of 64 columns of N,
// z = 2 g + (0 dC, 1 dB); warp w the row tile w.  Group 0 first adds S B
// (dC) or S^T C (dB), S split as it is summed from the groups' partials.
// Then each (head, P tile) step adds dY H_prev^T (X dH^T), dY (X) as it
// is and the state split, scaled by diag(e^l) (diag(w)) after the
// product; the next step's copies and state loads are in flight during
// this step's products.  The dC blocks also take e^l <dY, C H_prev> =
// the rows of C o (e^l dY H_prev^T) summed, from the same product.
constexpr int kDbcThreads = 256;
constexpr int kDbcSPer = kSsdTile * kSsdTile / 2 / kDbcThreads;  // S pairs
constexpr size_t kDbcHeadSmem = 2 * (3 * static_cast<size_t>(kSsdTile) *
                                         kLdP +
                                     2 * static_cast<size_t>(kMmaPt) * kLdP);
constexpr size_t kDbcSSmem = 2 * (2 * static_cast<size_t>(kSsdTile) * kLdT +
                                  static_cast<size_t>(kSsdTile) * kLdP);
constexpr size_t kDbcSmem =
    kDbcSSmem > kDbcHeadSmem ? kDbcSSmem : kDbcHeadSmem;

__global__ void __launch_bounds__(kDbcThreads, 2)
    ssd_bwd_dbc_mma_kernel(const bf16* __restrict__ xb,
                           const bf16* __restrict__ dy,
                           const bf16* __restrict__ bm,
                           const bf16* __restrict__ cm,
                           const float* __restrict__ sp,
                           const float* __restrict__ el,
                           const float* __restrict__ wl,
                           const float* __restrict__ hs,
                           const float* __restrict__ gs,
                           float* __restrict__ pc, float* __restrict__ pb,
                           float* __restrict__ ip, int q, int nh, int p,
                           int n, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  // group 0's S phase: S hi and lo (128, kLdT) [i][j], B or C (128, kLdP)
  bf16* sh = reinterpret_cast<bf16*>(smem);
  bf16* sl = sh + kSsdTile * kLdT;
  bf16* ot = sl + kSsdTile * kLdT;
  // the steps, over the same bytes: dY or X (128, kLdP) [r][p] in two
  // buffers, H_prev or dH hi and lo (64, kLdP) [n][p], C (128, kLdP)
  // [i][n] for the dC blocks' e^l <dY, C H_prev>
  bf16* tt = reinterpret_cast<bf16*>(smem);
  bf16* sth = tt + 2 * kSsdTile * kLdP;
  bf16* stl = sth + kMmaPt * kLdP;
  bf16* cts = stl + kMmaPt * kLdP;
  const size_t bc = blockIdx.x;
  const int tn = gridDim.y, ntile = blockIdx.y, n0 = ntile * kMmaPt;
  const int groups = gridDim.z / 2, grp = blockIdx.z / 2;
  const bool db = blockIdx.z % 2 == 1;
  const int h0 = grp * kHeadsPerGroup, h_end = min(nh, h0 + kHeadsPerGroup);
  const int tp = cdiv(p, kMmaPt), steps = (h_end - h0) * tp;
  const size_t row0 = bc * q, ld = static_cast<size_t>(nh) * p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  float acc[8][4] = {};
  if (grp == 0) {
    // S = the groups' dCB partials summed in order, masked to j <= i, a
    // half of the rows at a time: a group's loads all in flight before
    // the next group's
    const size_t qq = static_cast<size_t>(q) * q;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float v[kDbcSPer / 2][2] = {};
      for (int gg = 0; gg < groups; ++gg) {
        const float* spg = sp + (bc * groups + gg) * qq;
#pragma unroll
        for (int u = 0; u < kDbcSPer / 2; ++u) {
          const int e = tid + (u + half * kDbcSPer / 2) * kDbcThreads;
          const int i = e / (kSsdTile / 2), j = 2 * (e % (kSsdTile / 2));
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (i < q && j + c <= i)
              v[u][c] += spg[static_cast<size_t>(i) * q + j + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kDbcSPer / 2; ++u) {
        const int e = tid + (u + half * kDbcSPer / 2) * kDbcThreads;
        const int i = e / (kSsdTile / 2), j = 2 * (e % (kSsdTile / 2));
        uint32_t h, lw;
        split_bf16(v[u][0], v[u][1], h, lw);
        *reinterpret_cast<uint32_t*>(sh + i * kLdT + j) = h;
        *reinterpret_cast<uint32_t*>(sl + i * kLdT + j) = lw;
      }
    }
    stage<kSsdTile, kMmaPt>(ot, kLdP, (db ? cm : bm) + row0 * n + n0, n, q,
                            n - n0, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // dC: S B on the rows i of the tile, j <= i; dB: S^T C on the rows j
    // of the tile, i >= j
#pragma unroll 1
    for (int kk = db ? warp : 0; kk < (db ? kSsdTiles : warp + 1); ++kk) {
      uint32_t ahi[4], alo[4];
      if (db) {
        lda_t(ahi, sh, kLdT, r0, 16 * kk);
        lda_t(alo, sl, kLdT, r0, 16 * kk);
      } else {
        lda(ahi, sh, kLdT, r0, 16 * kk);
        lda(alo, sl, kLdT, r0, 16 * kk);
      }
#pragma unroll
      for (int pn = 0; pn < kMmaPt / 16; ++pn) {
        uint32_t bf[4];
        ldb_kn(bf, ot, kLdP, 16 * pn, 16 * kk);
        mma_bf16(acc[2 * pn], ahi, bf[0], bf[1]);
        mma_bf16(acc[2 * pn + 1], ahi, bf[2], bf[3]);
        mma_bf16(acc[2 * pn], alo, bf[0], bf[1]);
        mma_bf16(acc[2 * pn + 1], alo, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the S phase's bytes are free
  }
  const bf16* src = db ? xb : dy;
  const float* state = db ? gs : hs;
  const float* scale = db ? wl : el;
  if (!db)
    stage<kSsdTile, kMmaPt>(cts, kLdP, cm + row0 * n + n0, n, q, n - n0,
                            vec);
  PlaneRegs<kMmaPt, kDbcThreads> pr;
  // step st's dY (X) tile into buffer st % 2, and its state into pr
  const auto prefetch = [&](int st) {
    const int hh = h0 + st / tp, pt = (st % tp) * kMmaPt;
    stage<kSsdTile, kMmaPt>(tt + (st % 2) * kSsdTile * kLdP, kLdP,
                            src + row0 * ld + hh * p + pt, ld, q, p - pt,
                            vec);
    cp_async_commit();
    load_plane(pr,
               state + (bc * nh + hh) * n * p + static_cast<size_t>(n0) * p +
                   pt,
               p, n - n0, p - pt, p % 4 == 0);
  };
  prefetch(0);
  float tmp[8][4];
  for (int st = 0; st < steps; ++st) {
    const int hh = h0 + st / tp, pt = (st % tp) * kMmaPt;
    __syncthreads();  // the last step is done with the state and buffer
    store_split(pr, sth, stl);
    if (st + 1 < steps) {
      prefetch(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's tiles are in
    if (pt == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.0f;
    }
    const bf16* tb = tt + (st % 2) * kSsdTile * kLdP;
#pragma unroll
    for (int kk = 0; kk < kMmaPt / 16; ++kk) {
      uint32_t af[4];
      lda(af, tb, kLdP, r0, 16 * kk);
#pragma unroll
      for (int pn = 0; pn < kMmaPt / 16; ++pn) {
        uint32_t hi[4], lo[4];
        ldb_nk(hi, sth, kLdP, 16 * pn, 16 * kk);
        ldb_nk(lo, stl, kLdP, 16 * pn, 16 * kk);
        mma_bf16(tmp[2 * pn], af, hi[0], hi[1]);
        mma_bf16(tmp[2 * pn + 1], af, hi[2], hi[3]);
        mma_bf16(tmp[2 * pn], af, lo[0], lo[1]);
        mma_bf16(tmp[2 * pn + 1], af, lo[2], lo[3]);
      }
    }
    if (pt + kMmaPt >= p) {
      // the head's last P tile: its row scale, after the product
      const size_t bch = bc * nh + hh;
      float sc[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + g + 8 * hr;
        sc[hr] = r < q ? __ldg(scale + bch * q + r) : 0.0f;
      }
      float iv[2] = {};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sc[e >> 1] * tmp[nt][e];
          acc[nt][e] += v;
          if (!db) {
            const int r = r0 + g + 8 * (e >> 1);
            iv[e >> 1] +=
                to_f32(cts[r * kLdP + 8 * nt + 2 * t + (e & 1)]) * v;
          }
        }
      if (!db) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float v = iv[hr];
          v += __shfl_xor_sync(kFull, v, 1);
          v += __shfl_xor_sync(kFull, v, 2);
          const int r = r0 + g + 8 * hr;
          if (t == 0 && r < q) ip[(bch * tn + ntile) * q + r] = v;
        }
      }
    }
  }
  float* out = (db ? pb : pc) + (bc * groups + grp) * q * n;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + 8 * hr, col = n0 + 8 * nt + 2 * t;
      store_pair(out + static_cast<size_t>(r) * n + col, acc[nt][2 * hr],
                 acc[nt][2 * hr + 1], r < q && col < n, col + 1 < n,
                 n % 2 == 0);
    }
}

// ---- the scratch and the launches --------------------------------------- //
struct BwdScratch {
  float *l, *el, *wl, *hs, *gs, *hd, *cb, *sp, *rowg, *colg, *rp, *ip, *pc,
      *pb;
};

// f32 words of the scratch of a body, each array from a 16-byte
// boundary; with base, its arrays' addresses go to sc.  The tensor-core
// body sums G in one tile of Q and e^l <dY, C H_prev> over the tiles of N
// (step 8'), not of P.
inline long long bwd_scratch(int batch, int nc, int q, int nh, int p, int n,
                             bool mma, float* base, BwdScratch* sc) {
  const long long bc = static_cast<long long>(batch) * nc;
  const long long bch = bc * nh;
  const long long groups = cdiv(nh, kHeadsPerGroup);
  const long long tq = mma ? 1 : cdiv(q, kTile), tp = cdiv(p, kTile);
  const long long ti = mma ? cdiv(n, kTile) : tp;  // tiles of ip
  const long long slices = cdiv(n * p, kScanSlice);
  const long long states = bch * n * p;
  const long long sizes[14] = {bch * q,         bch * q,
                               bch * q,         states,
                               states,          bch * slices,
                               bc * q * q,      bc * groups * q * q,
                               bch * tq * q,    bch * tq * q,
                               bch * tp * q,    bch * ti * q,
                               bc * groups * q * n, bc * groups * q * n};
  float** slots[14] = {};
  if (sc) {
    float** all[14] = {&sc->l,  &sc->el,   &sc->wl,   &sc->hs, &sc->gs,
                       &sc->hd, &sc->cb,   &sc->sp,   &sc->rowg,
                       &sc->colg, &sc->rp, &sc->ip,   &sc->pc, &sc->pb};
    for (int i = 0; i < 14; ++i) slots[i] = all[i];
  }
  long long off = 0;
  for (int i = 0; i < 14; ++i) {
    if (sc) *slots[i] = base + off;
    off += (sizes[i] + 3) / 4 * 4;
  }
  return off;
}

template <typename T>
int launch_ssd_bwd(const float* al, const T* xb, const T* bm, const T* cm,
                   const T* dy, const float* dh, T* dx, float* da, T* db,
                   T* dc, float* scratch, int batch, int nc, int q, int nh,
                   int p, int n, cudaStream_t st) {
  BwdScratch sc;
  bwd_scratch(batch, nc, q, nh, p, n, false, scratch, &sc);
  const long long bc = static_cast<long long>(batch) * nc;
  const long long bch = bc * nh;
  const int groups = cdiv(nh, kHeadsPerGroup);
  const int tq = cdiv(q, kTile), tp = cdiv(p, kTile), tn = cdiv(n, kTile);
  const int slices = cdiv(n * p, kScanSlice);
  const int rows_blocks = static_cast<int>((bch + kRowThreads - 1) /
                                           kRowThreads);
  cudaError_t err;

  ssd_bwd_decay_kernel<<<rows_blocks, kRowThreads, 0, st>>>(
      al, sc.l, sc.el, sc.wl, bch, q, nh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 state_grid(static_cast<unsigned>(bch), tn * tp, 2);
  ssd_bwd_chunk_state_kernel<T><<<state_grid, kBwdThreads, 0, st>>>(
      xb, dy, bm, cm, sc.el, sc.wl, sc.hs, sc.gs, q, nh, p, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 scan_grid(static_cast<unsigned>(batch * nh), slices);
  ssd_bwd_state_scan_kernel<<<scan_grid, kBwdThreads, 0, st>>>(
      sc.hs, sc.gs, dh, sc.l, sc.hd, nc, q, nh, n * p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 cb_grid(static_cast<unsigned>(bc), tq * tq);
  ssd_bwd_cb_kernel<T><<<cb_grid, kBwdThreads, 0, st>>>(bm, cm, sc.cb, q, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 dcb_grid(static_cast<unsigned>(bc), tq * tq, groups);
  ssd_bwd_dcb_kernel<T><<<dcb_grid, kBwdThreads, 0, st>>>(
      xb, dy, sc.cb, sc.l, sc.sp, sc.rowg, sc.colg, q, nh, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 dx_grid(static_cast<unsigned>(bch), tq * tp);
  ssd_bwd_dx_kernel<T><<<dx_grid, kBwdThreads, 0, st>>>(
      xb, dy, bm, cm, sc.cb, sc.l, sc.el, sc.wl, sc.hs, sc.gs, dx, sc.rp,
      sc.ip, q, nh, p, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dl_kernel<<<rows_blocks, kRowThreads, 0, st>>>(
      sc.rowg, sc.colg, sc.rp, sc.ip, sc.hd, sc.el, da, bch, q, nh, tq, tp,
      slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 dbc_grid(static_cast<unsigned>(bc), tq * tn, 2 * groups);
  ssd_bwd_dbc_kernel<T><<<dbc_grid, kBwdThreads, 0, st>>>(
      xb, dy, bm, cm, sc.sp, sc.el, sc.wl, sc.hs, sc.gs, sc.pc, sc.pb, q, nh,
      p, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long cells = bc * q * n;
  const dim3 reduce_grid(
      static_cast<unsigned>((cells + kBwdThreads - 1) / kBwdThreads), 2);
  ssd_bwd_reduce_kernel<T><<<reduce_grid, kBwdThreads, 0, st>>>(
      sc.pc, sc.pb, dc, db, cells, q, n, groups);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core body's launches (steps 1', 2', 3, 4', 5', 6', 8', 7', 9:
// step 7' reads what step 8' adds)
int launch_ssd_bwd_mma(const float* al, const bf16* xb, const bf16* bm,
                       const bf16* cm, const bf16* dy, const float* dh,
                       bf16* dx, float* da, bf16* db, bf16* dc,
                       float* scratch, int batch, int nc, int q, int nh,
                       int p, int n, cudaStream_t st) {
  BwdScratch sc;
  bwd_scratch(batch, nc, q, nh, p, n, true, scratch, &sc);
  const long long bc = static_cast<long long>(batch) * nc;
  const long long bch = bc * nh;
  const int groups = cdiv(nh, kHeadsPerGroup);
  const int tp = cdiv(p, kMmaPt), tn = cdiv(n, kMmaPt);
  const int slices = cdiv(n * p, kScanSlice);
  const int warp_blocks = static_cast<int>((bch + kRowWarps - 1) / kRowWarps);
  const int vec = aligned16(xb) && aligned16(dy) && aligned16(bm) &&
                  aligned16(cm) && p % 8 == 0 && n % 8 == 0;
  cudaError_t err;
  // the dynamic shared memory of the product launches
  const auto smem = [](auto kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  };
  if ((err = smem(ssd_bwd_chunk_state_mma_kernel, kCsSmem)) != cudaSuccess ||
      (err = smem(ssd_bwd_cb_mma_kernel, kCbSmem)) != cudaSuccess ||
      (err = smem(ssd_bwd_dcb_mma_kernel, kDcbSmem)) != cudaSuccess ||
      (err = smem(ssd_bwd_dx_mma_kernel, kDxSmem)) != cudaSuccess ||
      (err = smem(ssd_bwd_dbc_mma_kernel, kDbcSmem)) != cudaSuccess)
    return static_cast<int>(err);

  ssd_bwd_decay_warp_kernel<<<warp_blocks, 32 * kRowWarps, 0, st>>>(
      al, sc.l, sc.el, sc.wl, bch, q, nh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 state_grid(static_cast<unsigned>(bc), groups, 2);
  ssd_bwd_chunk_state_mma_kernel<<<state_grid, kCsThreads, kCsSmem, st>>>(
      xb, dy, bm, cm, sc.el, sc.wl, sc.hs, sc.gs, q, nh, p, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 scan_grid(static_cast<unsigned>(batch * nh), slices);
  ssd_bwd_state_scan_kernel<<<scan_grid, kBwdThreads, 0, st>>>(
      sc.hs, sc.gs, dh, sc.l, sc.hd, nc, q, nh, n * p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_cb_mma_kernel<<<static_cast<unsigned>(bc), kCbThreads, kCbSmem,
                          st>>>(bm, cm, sc.cb, q, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 dcb_grid(static_cast<unsigned>(bc), groups);
  ssd_bwd_dcb_mma_kernel<<<dcb_grid, kDcbThreads, kDcbSmem, st>>>(
      xb, dy, sc.cb, sc.l, sc.sp, sc.rowg, sc.colg, q, nh, p, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 dx_grid(static_cast<unsigned>(bch), tp);
  ssd_bwd_dx_mma_kernel<<<dx_grid, kDxThreads, kDxSmem, st>>>(
      xb, dy, bm, sc.cb, sc.l, sc.wl, sc.gs, dx, sc.rp, q, nh, p, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 dbc_grid(static_cast<unsigned>(bc), tn, 2 * groups);
  ssd_bwd_dbc_mma_kernel<<<dbc_grid, kDbcThreads, kDbcSmem, st>>>(
      xb, dy, bm, cm, sc.sp, sc.el, sc.wl, sc.hs, sc.gs, sc.pc, sc.pb, sc.ip,
      q, nh, p, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dl_warp_kernel<<<warp_blocks, 32 * kRowWarps, 0, st>>>(
      sc.rowg, sc.colg, sc.rp, sc.ip, sc.hd, sc.el, da, bch, q, nh, tp, tn,
      slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long cells = bc * q * n;
  const dim3 reduce_grid(
      static_cast<unsigned>((cells + kBwdThreads - 1) / kBwdThreads), 2);
  ssd_bwd_reduce_kernel<bf16><<<reduce_grid, kBwdThreads, 0, st>>>(
      sc.pc, sc.pb, dc, db, cells, q, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// Which body rt_ssd_scan_bwd runs for a chunk of q steps, N = n and the
// element type dtype: 1 the tensor-core body, 0 the FMA body.
extern "C" int rt_ssd_scan_bwd_body(int q, int n, int dtype) {
  return repro_torch::ssd_bwd_body(q, n, dtype);
}

// f32 words of the scratch rt_ssd_scan_bwd takes at this shape and
// element type, -1 at 2^31 words or more.
extern "C" int rt_ssd_scan_bwd_scratch(int batch, int nc, int q, int nh,
                                       int p, int n, int dtype) {
  using namespace repro_torch;
  if (batch <= 0 || nc <= 0 || q <= 0 || nh <= 0 || p <= 0 || n <= 0)
    return 4;
  const long long words =
      bwd_scratch(batch, nc, q, nh, p, n,
                  ssd_bwd_body(q, n, dtype) == kBwdBodyMma, nullptr, nullptr);
  return words > 0x7fffffffLL ? -1 : static_cast<int>(words);
}

// xb, dy: (batch, nc q, nh, p) of dtype; al: (batch, nc q, nh) f32; bm, cm:
// (batch, nc q, n) of dtype; dh: (batch, nh, n, p) f32.  Writes dx (as xb),
// da (as al, f32), db and dc (as bm).  scratch: rt_ssd_scan_bwd_scratch
// f32 words.  Returns the cudaError_t of the first launch that failed.
extern "C" int rt_ssd_scan_bwd(const void* xb, const void* al, const void* bm,
                               const void* cm, const void* dy, const void* dh,
                               void* dx, void* da, void* db, void* dc,
                               void* scratch, int batch, int nc, int q,
                               int nh, int p, int n, int dtype,
                               void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || nh <= 0 || nc <= 0 || q <= 0 || p <= 0 || n <= 0)
    return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const float* a = static_cast<const float*>(al);
  const float* g = static_cast<const float*>(dh);
  float* d = static_cast<float*>(da);
  if (dtype == kDtypeF32)
    return launch_ssd_bwd<float>(
        a, static_cast<const float*>(xb), static_cast<const float*>(bm),
        static_cast<const float*>(cm), static_cast<const float*>(dy), g,
        static_cast<float*>(dx), d, static_cast<float*>(db),
        static_cast<float*>(dc), sc, batch, nc, q, nh, p, n, st);
  if (ssd_bwd_body(q, n, dtype) == kBwdBodyMma)
    return launch_ssd_bwd_mma(
        a, static_cast<const bf16*>(xb), static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), static_cast<const bf16*>(dy), g,
        static_cast<bf16*>(dx), d, static_cast<bf16*>(db),
        static_cast<bf16*>(dc), sc, batch, nc, q, nh, p, n, st);
  if (dtype == kDtypeBF16)
    return launch_ssd_bwd<bf16>(
        a, static_cast<const bf16*>(xb), static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), static_cast<const bf16*>(dy), g,
        static_cast<bf16*>(dx), d, static_cast<bf16*>(db),
        static_cast<bf16*>(dc), sc, batch, nc, q, nh, p, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
