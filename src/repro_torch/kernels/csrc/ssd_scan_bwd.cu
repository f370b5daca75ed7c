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
// (kernels/ssd_scan/ref.py, ssd_chunk_scan_ref) computes, every product
// in f32 as there, for f32 and bf16 inputs; ssd_chunk_scan_bwd_ref in
// the same file holds the formulas.  It replaces no TPU kernel of its
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
// _ssd_bwd_bound counts both).  This first design runs every product
// on the CUDA cores in f32 (TF32 keeps about three digits and would
// break the f32 tolerance of 2e-5), so the products and not the bytes
// set its pace.  It is a pipeline of plain launches through an f32
// scratch, each product a 64 x 64 output tile a block of 256 threads
// (4 x 4 outputs a thread, staged 32 deep through shared memory, the
// next step's loads in flight during the current step's products but in
// dx, which keeps three accumulator tiles), so that every launch fills
// the card whatever the shape:
//
//   1. decay: l, e^l and w of every (b, chunk, h), a thread each, l
//      summed in order as the forward sums it;
//   2. chunk_state: each chunk's own state terms B^T diag(w) X and
//      C^T diag(e^l) dY (N x P, a block a tile and head);
//   3. state_scan: a block a (b, h, 1,024 cells of the state) walks the
//      chunks forward (H_prev of each chunk) and back from dh (dH of
//      each), in place, with each slice's share of <H_prev, dH>;
//   4. cb: C B^T of each chunk's lower triangle, shared by the heads;
//   5. dcb: dY X^T on the lower tiles, for a group of 8 heads a block:
//      dCB summed over the group's heads in registers (a partial per
//      group, so no f32 atomic is used and the sums are deterministic),
//      each head's G summed along its rows and columns;
//   6. dx: M^T dY (M from C B^T and l as it is staged) + diag(w) B dH,
//      with C H_prev; r and the e^l <dY, C H_prev> term summed along P;
//   7. dl: dl from those sums, then da_log, a thread a (b, chunk, h);
//   8. dbc: dC = S B + sum_h diag(e^l) dY H_prev^T and dB = S^T C +
//      sum_h diag(w) X dH^T, S = the groups' dCB summed as it is staged,
//      the head sums split by group into an f32 partial;
//   9. reduce: the groups' partials summed in order, cast to Bm's type.
//
// The scratch (rt_ssd_scan_bwd_scratch f32 words; at the training shape
// 117 MB, two (B, NC, H, N, P) states among it) is the caller's and is
// dropped when the backward returns; nothing is saved from the forward.

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

// ---- the scratch and the launches --------------------------------------- //
struct BwdScratch {
  float *l, *el, *wl, *hs, *gs, *hd, *cb, *sp, *rowg, *colg, *rp, *ip, *pc,
      *pb;
};

// f32 words of the scratch, each array from a 16-byte boundary; with
// base, its arrays' addresses go to sc
inline long long bwd_scratch(int batch, int nc, int q, int nh, int p, int n,
                             float* base, BwdScratch* sc) {
  const long long bc = static_cast<long long>(batch) * nc;
  const long long bch = bc * nh;
  const long long groups = cdiv(nh, kHeadsPerGroup);
  const long long tq = cdiv(q, kTile), tp = cdiv(p, kTile);
  const long long slices = cdiv(n * p, kScanSlice);
  const long long states = bch * n * p;
  const long long sizes[14] = {bch * q,         bch * q,
                               bch * q,         states,
                               states,          bch * slices,
                               bc * q * q,      bc * groups * q * q,
                               bch * tq * q,    bch * tq * q,
                               bch * tp * q,    bch * tp * q,
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
  bwd_scratch(batch, nc, q, nh, p, n, scratch, &sc);
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

}  // namespace repro_torch

// f32 words of the scratch rt_ssd_scan_bwd takes at this shape, -1 at
// 2^31 words or more.
extern "C" int rt_ssd_scan_bwd_scratch(int batch, int nc, int q, int nh,
                                       int p, int n) {
  if (batch <= 0 || nc <= 0 || q <= 0 || nh <= 0 || p <= 0 || n <= 0)
    return 4;
  const long long words =
      repro_torch::bwd_scratch(batch, nc, q, nh, p, n, nullptr, nullptr);
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
  if (dtype == kDtypeBF16)
    return launch_ssd_bwd<bf16>(
        a, static_cast<const bf16*>(xb), static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), static_cast<const bf16*>(dy), g,
        static_cast<bf16*>(dx), d, static_cast<bf16*>(db),
        static_cast<bf16*>(dc), sc, batch, nc, q, nh, p, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
