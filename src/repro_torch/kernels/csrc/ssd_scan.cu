// ssd_scan: the chunked SSD scan of a Mamba-2 layer (state-space
// duality, n_groups = 1).  For one (batch b, head h) and one chunk of Q
// steps, with l the within-chunk cumulative sum of the log decay al,
//
//   y[i]   = sum_{j <= i} (C_i . B_j) exp(l_i - l_j) x[j]      (intra)
//          + exp(l_i) C_i . H                                  (inter)
//   H_next = exp(l_{Q-1}) H + sum_j exp(l_{Q-1} - l_j) B_j x[j]^T
//
// where H is the (N, P) f32 state carried from chunk to chunk (zero at
// the first), x the (Q, P) dt-scaled inputs of the head and B, C the
// (Q, N) projections of the batch row, shared by all heads.  The final
// state is written out in f32, y in the input type, rounded once.
//
// Replaces the TPU kernel ssd_scan_kernel in
// src/repro/kernels/ssd_scan/kernel.py (launched by ssd_scan_pallas
// there, through ssd_chunk_scan in ops.py).  The prefill of every Mamba-2
// layer calls it once.
//
// What bounds it: memory.  It must read x, al, B and C once and write y
// and the final state once: at the mamba2-2.7b prefill (B = 1, S = 1,819,
// H = 80, P = 64, N = 128, bf16) 41.4 MB, 0.0124 ms at the H100 SXM's
// 3.35 TB/s, against 8.8 GFLOP of products on the lower triangles (C B^T,
// att x) and of C H and the state update, 0.0089 ms at its 989 TFLOP/s of
// dense bf16 (chip_smoke.py's _lm_bound counts both from the run's
// inputs).  Both are far below what a chunk walk in order can reach, so
// the design aims at the tensor cores and at filling the card:
//
//   * bf16 with Q <= 128 and N <= 128 (ssd_scan_mma_kernel, the main
//     path's body): a block of 4 warps per (b, h, slice of PS = 32
//     columns of P; 16 when P <= 16), 160 blocks at the mamba2-2.7b
//     prefill instead of 80, two resident an SM (100 KB of shared
//     memory each).  The block walks the chunks in order; its slice of
//     the state stays in registers in f32 (each warp owns two 16-row
//     tiles of N), so no per-chunk state goes to device memory, and the
//     only traffic beyond the bound's is B and C read again from L2 by
//     each slice and head.  Each chunk's x slice, B, C and al arrive by
//     cp.async (16-byte copies), zero-padded to a full 128 x 128 tile in
//     shared memory, so that every loop over the tile has a fixed trip
//     count: an ldmatrix is never separated by a guard (and the
//     compiler's branch and warp sync) from the products it feeds; on
//     the card, guarded loops left the ldmatrix latency exposed at every
//     k-step.  Warp 0 sums l by a warp scan.  All four products run on
//     mma.sync.m16n8k16, bf16 in and f32 accumulated, fed by ldmatrix:
//       - C B^T on the lower triangle, 16 columns at a time (four
//         accumulator chains); its products are exact (bf16 inputs);
//       - att = C B^T exp(l_i - l_j), masked before exp (only j <= i is
//         exponentiated: above the diagonal l_i - l_j is large and
//         positive), is an f32 intermediate.  It is split as hi =
//         bf16(att), lo = bf16(att - hi), two products against the same
//         x fragment, so att x keeps about 16 bits of att where one bf16
//         rounding keeps 8 (the JAX reference's rounding, 1.3x the bf16
//         tolerance from a float64 evaluation on mamba2's activations);
//       - C H reads H from two bf16 copies in shared memory, hi and lo,
//         refreshed from the registers after each chunk;
//       - the state update takes B^T (ldmatrix.trans of the B tile) and
//         exp(l_{Q-1} - l_j) x_j, weighted and split into hi and lo in
//         registers.
//     C B^T depends only on (b, chunk), but each block recomputes it:
//     on the tensor cores that is ~600 products a chunk, cheaper than a
//     round trip through device memory.  A warp takes the row tiles w
//     and 7 - w, so the triangle's work is even across the 4 warps.  On
//     the card a warp is still bound by the latency of its chains, not
//     by the tensor cores' rate, and the chunk's copies are overlapped
//     only where an SM holds two blocks (copying the next chunk's C
//     during the state update cost more in its extra barrier than it
//     hid).
//   * float32, or bf16 with a larger Q or N (ssd_scan_fma_kernel): FMA
//     on the CUDA cores, because TF32 products keep about three decimal
//     digits and would break the f32 tolerance of 2e-5.  Its note says
//     more.
//
// rt_ssd_scan_body reports which body a shape runs.

#include "lm_common.cuh"

namespace repro_torch {

using bf16 = __nv_bfloat16;

constexpr int kSsdBodyFma = 0;
constexpr int kSsdBodyMma = 1;

// ---- the FMA body ----------------------------------------------------- //
// One block of 256 threads a (b, h) walks the chunks in order, so the
// state never leaves shared memory; every product is f32 FMA on
// shared-memory tiles, each thread computing a 4 x 4 block of outputs
// whose columns are strided by the tile count (so neighbouring threads
// read neighbouring columns, and rows padded by one 32-bit word put the
// transposed reads of B in different banks).  Shared memory: the state
// (N x P f32), l and its two exponentials (3Q f32), x, B and C of the
// chunk in the input type, and a tile of R rows of the (Q, Q) matrix in
// f32, R as large as fits the 227 KB a block may use: all 128 rows in
// bf16, 60 in f32 at Q = N = 128, P = 64.  The mask is applied before
// exp.  The within-chunk cumsum runs in order on one thread.

constexpr int kSsdThreads = 256;

struct SsdFmaLayout {
  int ldn, ldp, ldq, rows;  // padded row strides (elements), tile rows
  size_t bytes;
};

template <typename T>
SsdFmaLayout ssd_fma_layout(int q, int p, int n) {
  SsdFmaLayout lay;
  lay.ldn = n + word_pad<T>();
  lay.ldp = p + word_pad<T>();
  lay.ldq = q + 1;
  const size_t fixed = 4 * (static_cast<size_t>(n) * p + 3 * q) +
                       sizeof(T) * (static_cast<size_t>(q) * lay.ldp +
                                    2 * static_cast<size_t>(q) * lay.ldn);
  lay.rows = 0;
  if (fixed < static_cast<size_t>(kMaxSmemBytes)) {
    size_t r = (kMaxSmemBytes - fixed) / (4 * static_cast<size_t>(lay.ldq));
    if (r >= static_cast<size_t>(q)) {
      r = q;
    } else {
      r -= r % 4;
    }
    lay.rows = static_cast<int>(r);
  }
  lay.bytes = fixed + 4 * static_cast<size_t>(lay.rows) * lay.ldq;
  return lay;
}

// xb, y: (B, NC * Q, H, P); al: (B, NC * Q, H) f32; bm, cm: (B, NC * Q, N);
// hout: (B, H, N, P) f32.  Block (b * H + h).
template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_scan_fma_kernel(const T* __restrict__ xb, const float* __restrict__ al,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    T* __restrict__ y, float* __restrict__ hout, int nc,
                    int q, int nh, int p, int n, SsdFmaLayout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);  // (n, p) state
  float* l = hs + n * p;                       // (q,) cumulative log decay
  float* el = l + q;                           // exp(l_i)
  float* wl = el + q;                          // exp(l_{q-1} - l_j)
  float* att = wl + q;                         // (rows, ldq) tile of (q, q)
  T* xs = reinterpret_cast<T*>(att + lay.rows * lay.ldq);  // (q, ldp)
  T* bs = xs + q * lay.ldp;                                // (q, ldn)
  T* cs = bs + q * lay.ldn;                                // (q, ldn)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / nh;
  const int hh = blockIdx.x % nh;
  const size_t s_pad = static_cast<size_t>(nc) * q;
  const int ldn = lay.ldn, ldp = lay.ldp, ldq = lay.ldq;

  for (int i = tid; i < n * p; i += kSsdThreads) hs[i] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const size_t t0 = static_cast<size_t>(b) * s_pad +
                      static_cast<size_t>(c) * q;  // first row of the chunk
    __syncthreads();  // the previous chunk is done with the tiles
    for (int i = tid; i < q * p; i += kSsdThreads) {
      const int r = i / p, col = i % p;
      xs[r * ldp + col] = xb[((t0 + r) * nh + hh) * p + col];
    }
    for (int i = tid; i < q * n; i += kSsdThreads) {
      const int r = i / n, col = i % n;
      bs[r * ldn + col] = bm[(t0 + r) * n + col];
      cs[r * ldn + col] = cm[(t0 + r) * n + col];
    }
    // l = cumsum(al): the chunk's log decays staged in l, then summed in
    // order by one thread — the order of torch.cumsum along this axis,
    // so the plain version's l equals the kernel's bit for bit
    for (int i = tid; i < q; i += kSsdThreads) l[i] = al[(t0 + i) * nh + hh];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int i = 0; i < q; ++i) {
        acc += l[i];
        l[i] = acc;
      }
    }
    __syncthreads();
    const float lq = l[q - 1];
    for (int i = tid; i < q; i += kSsdThreads) {
      el[i] = expf(l[i]);
      wl[i] = expf(lq - l[i]);
    }
    __syncthreads();

    // y of the chunk, R rows at a time
    for (int r0 = 0; r0 < q; r0 += lay.rows) {
      const int rows = min(lay.rows, q - r0);
      const int jmax = r0 + rows;  // no row of the tile sees j >= jmax
      // att[i - r0, j] = (C_i . B_j) exp(l_i - l_j) for j <= i, else 0
      {
        const int ti_n = (rows + 3) / 4, tj_n = (jmax + 3) / 4;
        for (int tile = tid; tile < ti_n * tj_n; tile += kSsdThreads) {
          const int i0 = r0 + (tile / tj_n) * 4, tj = tile % tj_n;
          float acc[4][4] = {};
          if (tj <= i0 + 3) {  // else every j of the tile is above i
            for (int k = 0; k < n; ++k) {
              float av[4], bv[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                av[u] = i0 + u < jmax ? to_f32(cs[(i0 + u) * ldn + k]) : 0.f;
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const int j = tj + v * tj_n;
                bv[v] = j < jmax ? to_f32(bs[j * ldn + k]) : 0.f;
              }
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * bv[v];
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u;
            if (i >= jmax) continue;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int j = tj + v * tj_n;
              if (j >= jmax) continue;
              att[(i - r0) * ldq + j] =
                  j <= i ? acc[u][v] * expf(l[i] - l[j]) : 0.0f;
            }
          }
        }
      }
      __syncthreads();
      // y[i, :] = att[i, :i+1] x + exp(l_i) C_i H
      {
        const int ti_n = (rows + 3) / 4, tp_n = (p + 3) / 4;
        for (int tile = tid; tile < ti_n * tp_n; tile += kSsdThreads) {
          const int i0 = r0 + (tile / tp_n) * 4, tp = tile % tp_n;
          const int jend = min(i0 + 4, jmax);
          float acc[4][4] = {}, inter[4][4] = {};
          for (int j = 0; j < jend; ++j) {
            float av[4], xv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              av[u] = i0 + u < jmax ? att[(i0 + u - r0) * ldq + j] : 0.f;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int col = tp + v * tp_n;
              xv[v] = col < p ? to_f32(xs[j * ldp + col]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * xv[v];
          }
          for (int k = 0; k < n; ++k) {
            float cv[4], hv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              cv[u] = i0 + u < jmax ? to_f32(cs[(i0 + u) * ldn + k]) : 0.f;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int col = tp + v * tp_n;
              hv[v] = col < p ? hs[k * p + col] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) inter[u][v] += cv[u] * hv[v];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u;
            if (i >= jmax) continue;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int col = tp + v * tp_n;
              if (col >= p) continue;
              y[((t0 + i) * nh + hh) * p + col] =
                  from_f32<T>(acc[u][v] + inter[u][v] * el[i]);
            }
          }
        }
      }
      __syncthreads();  // the next row tile overwrites att
    }

    // H = exp(l_{q-1}) H + sum_j exp(l_{q-1} - l_j) B_j x_j^T; each thread
    // rewrites only the state cells it read
    {
      const float dec = expf(lq);
      const int tn_n = (n + 3) / 4, tp_n = (p + 3) / 4;
      for (int tile = tid; tile < tn_n * tp_n; tile += kSsdThreads) {
        const int n0 = (tile / tp_n) * 4, tp = tile % tp_n;
        float acc[4][4] = {};
        for (int j = 0; j < q; ++j) {
          float bv[4], xv[4];
          const float wj = wl[j];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            bv[u] = n0 + u < n ? to_f32(bs[j * ldn + n0 + u]) : 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int col = tp + v * tp_n;
            xv[v] = col < p ? wj * to_f32(xs[j * ldp + col]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] += bv[u] * xv[v];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (n0 + u >= n) continue;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int col = tp + v * tp_n;
            if (col >= p) continue;
            float* cell = hs + (n0 + u) * p + col;
            *cell = *cell * dec + acc[u][v];
          }
        }
      }
    }
  }
  __syncthreads();
  float* out = hout + static_cast<size_t>(blockIdx.x) * n * p;
  for (int i = tid; i < n * p; i += kSsdThreads) out[i] = hs[i];
}


// ---- the tensor-core body --------------------------------------------- //
constexpr int kSsdMmaWarps = 4;
constexpr int kSsdMmaThreads = 32 * kSsdMmaWarps;
// row stride of the B and C tiles: an odd number of 16-byte chunks, so
// the eight rows of an ldmatrix fall in different banks
constexpr int kSsdLdn = kSsdTile + 8;

// the slice's row stride (PS + 8, PS / 8 even: odd 16-byte chunks)
template <int PS>
__host__ __device__ constexpr int ssd_ldp() { return PS + 8; }

template <int PS>
constexpr size_t ssd_mma_smem() {
  return 2 * (2 * static_cast<size_t>(kSsdTile) * kSsdLdn +
              3 * static_cast<size_t>(kSsdTile) * ssd_ldp<PS>()) +
         4 * (4 * static_cast<size_t>(kSsdTile) + 4);
}

// xb, y: (B, NC * Q, H, P) bf16; al: (B, NC * Q, H) f32; bm, cm: (B, NC *
// Q, N) bf16; hout: (B, H, N, P) f32.  Block ((b * H + h) * slices + s)
// owns columns [s PS, s PS + PS) of P; warp w the row tiles w and 7 - w
// of y and the N tiles w and w + 4 of the state.  vec: 16-byte copies of
// x, B and C (P and N multiples of 8, aligned planes), else element
// copies.
template <int PS>
__global__ void __launch_bounds__(kSsdMmaThreads, 2)
    ssd_scan_mma_kernel(const bf16* __restrict__ xb,
                        const float* __restrict__ al,
                        const bf16* __restrict__ bm,
                        const bf16* __restrict__ cm, bf16* __restrict__ y,
                        float* __restrict__ hout, int nc, int q, int nh,
                        int p, int n, int vec) {
  constexpr int LDP = ssd_ldp<PS>();
  constexpr int LDN = kSsdLdn;
  constexpr int QT = kSsdTiles;
  constexpr int NT = PS / 8;  // n8 tiles of the slice
  extern __shared__ __align__(128) unsigned char ssmem[];
  bf16* bs = reinterpret_cast<bf16*>(ssmem);  // (128, LDN) B of the chunk
  bf16* cs = bs + kSsdTile * LDN;             // (128, LDN) C
  bf16* xs = cs + kSsdTile * LDN;             // (128, LDP) x slice
  bf16* hhi = xs + kSsdTile * LDP;            // (128, LDP) H, hi part
  bf16* hlo = hhi + kSsdTile * LDP;           // (128, LDP) H, lo part
  float* raw = reinterpret_cast<float*>(hlo + kSsdTile * LDP);  // al
  float* l2 = raw + kSsdTile;  // l log2(e)
  float* el = l2 + kSsdTile;   // exp(l_i)
  float* wl = el + kSsdTile;   // exp(l_{Q-1} - l_j)
  float* dec_s = wl + kSsdTile;  // exp(l_{Q-1})

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slices = (p + PS - 1) / PS;
  const int bh = blockIdx.x / slices;
  const int p0 = (blockIdx.x % slices) * PS;
  const int b = bh / nh, hh = bh % nh;
  const size_t s_pad = static_cast<size_t>(nc) * q;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int i = tid; i < 2 * kSsdTile * LDP; i += kSsdMmaThreads) hhi[i] = zero;

  // ldmatrix lane addresses: A row-major and B [k][n] transposed share
  // one pattern, B [n][k] and A [k][m] transposed the other
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8, ca = (lane >> 4) * 8;
  const int rb = (lane & 7) + (lane >> 4) * 8, cb = ((lane >> 3) & 1) * 8;
  const uint32_t cs_a = smem_addr(cs + ra * LDN + ca);
  const uint32_t bs_b = smem_addr(bs + rb * LDN + cb);
  const uint32_t xs_b = smem_addr(xs + ra * LDP + ca);
  const uint32_t hhi_b = smem_addr(hhi + ra * LDP + ca);
  const uint32_t hlo_b = smem_addr(hlo + ra * LDP + ca);

  // the state: rows of N tiles warp and warp + 4, the slice's columns
  float hreg[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hreg[mi][nt][e] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const size_t t0 = static_cast<size_t>(b) * s_pad +
                      static_cast<size_t>(c) * q;  // first row of the chunk
    // 1. x slice, B, C and al of the chunk into shared memory, zero past
    // Q, N and P (the previous chunk's readers finished at its last
    // __syncthreads)
    if (vec) {
      constexpr int XC = PS / 8;  // 16-byte chunks a row of the slice
      for (int i = tid; i < kSsdTile * XC; i += kSsdMmaThreads) {
        const int r = i / XC, cc = i % XC;
        const bool in = r < q && p0 + cc * 8 < p;
        const bf16* src =
            in ? xb + ((t0 + r) * nh + hh) * p + p0 + cc * 8 : xb;
        cp_async16(smem_addr(xs + r * LDP + cc * 8), src, in);
      }
      constexpr int NC8 = kSsdTile / 8;  // 16-byte chunks a row of B, C
      for (int i = tid; i < kSsdTile * NC8; i += kSsdMmaThreads) {
        const int r = i / NC8, cc = i % NC8;
        const bool in = r < q && cc * 8 < n;
        const size_t off = (t0 + r) * n + cc * 8;
        cp_async16(smem_addr(bs + r * LDN + cc * 8), in ? bm + off : bm, in);
        cp_async16(smem_addr(cs + r * LDN + cc * 8), in ? cm + off : cm, in);
      }
    } else {
      for (int i = tid; i < kSsdTile * PS; i += kSsdMmaThreads) {
        const int r = i / PS, col = i % PS;
        xs[r * LDP + col] = r < q && p0 + col < p
                                ? xb[((t0 + r) * nh + hh) * p + p0 + col]
                                : zero;
      }
      for (int i = tid; i < kSsdTile * kSsdTile; i += kSsdMmaThreads) {
        const int r = i / kSsdTile, col = i % kSsdTile;
        const bool in = r < q && col < n;
        bs[r * LDN + col] = in ? bm[(t0 + r) * n + col] : zero;
        cs[r * LDN + col] = in ? cm[(t0 + r) * n + col] : zero;
      }
    }
    for (int i = tid; i < kSsdTile; i += kSsdMmaThreads) {
      if (i < q) {
        cp_async4(smem_addr(raw + i), al + (t0 + i) * nh + hh);
      } else {
        raw[i] = 0.0f;  // decay 1 past Q: l stays l_{Q-1}
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 2. l = cumsum(al): four steps a lane in order, then a warp scan
    if (warp == 0) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = raw[4 * lane + k];
      v[1] += v[0];
      v[2] += v[1];
      v[3] += v[2];
      float incl = v[3];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float excl = incl - v[3];
      const float lq = __shfl_sync(0xffffffffu, incl, 31);  // l_{Q-1}
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * lane + k;
        const float li = v[k] + excl;
        l2[i] = li * kLog2e;
        el[i] = expf(li);
        wl[i] = expf(lq - li);
      }
      if (lane == 0) *dec_s = expf(lq);
    }
    __syncthreads();

    // 3. y of the row tiles warp and 7 - warp
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int rt = pass == 0 ? warp : QT - 1 - warp;
      const int i0 = 16 * rt;
      uint32_t cf[QT][4];  // C rows i0.. as A, all of N
#pragma unroll
      for (int kk = 0; kk < QT; ++kk)
        ldsm_x4(cf[kk], cs_a + (i0 * LDN + kk * 16) * 2);
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      const int ia = i0 + g, ib = ia + 8;  // this lane's two rows
      const float la = l2[ia], lb = l2[ib];

      // intra: the lower triangle, 16 columns j a step
#pragma unroll 1
      for (int kc = 0; kc <= rt; ++kc) {
        const int j0 = 16 * kc;
        // C B^T in four accumulator chains: two n-tiles, the k-steps
        // split by parity
        float s2[2][2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s2[a][nt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < QT; ++kk) {
          uint32_t bf[4];
          ldsm_x4(bf, bs_b + (j0 * LDN + kk * 16) * 2);
          mma_bf16(s2[kk & 1][0], cf[kk], bf[0], bf[1]);
          mma_bf16(s2[kk & 1][1], cf[kk], bf[2], bf[3]);
        }
        // att, masked before exp, split into the A fragments hi and lo
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = j0 + 8 * nt + 2 * t;
          const float l0 = l2[j], l1 = l2[j + 1];
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int jj = j + (e & 1);
            const float d = (e < 2 ? la : lb) - ((e & 1) ? l1 : l0);
            v[e] = jj <= i ? (s2[0][nt][e] + s2[1][nt][e]) * exp2_ftz(d)
                           : 0.0f;
          }
          split_bf16(v[0], v[1], ahi[2 * nt], alo[2 * nt]);
          split_bf16(v[2], v[3], ahi[2 * nt + 1], alo[2 * nt + 1]);
        }
#pragma unroll
        for (int pn = 0; pn < NT / 2; ++pn) {
          uint32_t xf[4];
          ldsm_x4_trans(xf, xs_b + (j0 * LDP + pn * 16) * 2);
          mma_bf16(acc[2 * pn], ahi, xf[0], xf[1]);
          mma_bf16(acc[2 * pn + 1], ahi, xf[2], xf[3]);
          mma_bf16(acc[2 * pn], alo, xf[0], xf[1]);
          mma_bf16(acc[2 * pn + 1], alo, xf[2], xf[3]);
        }
      }
      // inter: C H, H = hi + lo (zero before the second chunk), the hi
      // and lo products in separate chains
      float inter[2][NT][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) inter[a][nt][e] = 0.0f;
      if (c > 0) {
#pragma unroll
        for (int kk = 0; kk < QT; ++kk) {
#pragma unroll
          for (int pn = 0; pn < NT / 2; ++pn) {
            uint32_t hf[4], lf[4];
            ldsm_x4_trans(hf, hhi_b + (kk * 16 * LDP + pn * 16) * 2);
            ldsm_x4_trans(lf, hlo_b + (kk * 16 * LDP + pn * 16) * 2);
            mma_bf16(inter[0][2 * pn], cf[kk], hf[0], hf[1]);
            mma_bf16(inter[0][2 * pn + 1], cf[kk], hf[2], hf[3]);
            mma_bf16(inter[1][2 * pn], cf[kk], lf[0], lf[1]);
            mma_bf16(inter[1][2 * pn + 1], cf[kk], lf[2], lf[3]);
          }
        }
      }
      // y = intra + exp(l_i) inter, rounded to bf16 once
      const float ea = el[ia], eb = el[ib];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = p0 + 8 * nt + 2 * t;
        if (col >= p) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = hr ? ib : ia;
          if (i >= q) continue;
          const float e = hr ? eb : ea;
          const int e0 = 2 * hr, e1 = 2 * hr + 1;
          const float y0 =
              acc[nt][e0] + e * (inter[0][nt][e0] + inter[1][nt][e0]);
          const float y1 =
              acc[nt][e1] + e * (inter[0][nt][e1] + inter[1][nt][e1]);
          bf16* dst = y + ((t0 + i) * nh + hh) * p + col;
          if (p % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            dst[0] = __float2bfloat16(y0);
            if (col + 1 < p) dst[1] = __float2bfloat16(y1);
          }
        }
      }
    }

    // 4. H = exp(l_{Q-1}) H + sum_j B_j^T (exp(l_{Q-1} - l_j) x_j), the
    // weighted x split into hi and lo in registers
    const float dec = *dec_s;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hreg[mi][nt][e] *= dec;
#pragma unroll
    for (int kk = 0; kk < QT; ++kk) {
      const int j0 = 16 * kk;
      const float w0 = wl[j0 + 2 * t], w1 = wl[j0 + 2 * t + 1];
      const float w2 = wl[j0 + 2 * t + 8], w3 = wl[j0 + 2 * t + 9];
      uint32_t af[2][4];  // B^T rows of the warp's N tiles, k = j
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_trans(af[mi], bs_b + (j0 * LDN + (warp + 4 * mi) * 16) * 2);
#pragma unroll
      for (int pn = 0; pn < NT / 2; ++pn) {
        uint32_t xf[4];
        ldsm_x4_trans(xf, xs_b + (j0 * LDP + pn * 16) * 2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 xa = unpack_bf16(xf[2 * hf]);      // rows 2t, 2t+1
          const float2 xc = unpack_bf16(xf[2 * hf + 1]);  // rows 2t+8, 2t+9
          uint32_t hi0, lo0, hi1, lo1;
          split_bf16(xa.x * w0, xa.y * w1, hi0, lo0);
          split_bf16(xc.x * w2, xc.y * w3, hi1, lo1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(hreg[mi][2 * pn + hf], af[mi], hi0, hi1);
            mma_bf16(hreg[mi][2 * pn + hf], af[mi], lo0, lo1);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the chunk's tiles and H

    // 5. the new H as its hi and lo bf16 copies, for the next chunk's C H
    if (c + 1 < nc) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int mt = warp + 4 * mi;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int off = (16 * mt + g + 8 * hr) * LDP + 8 * nt + 2 * t;
            uint32_t hi, lo;
            split_bf16(hreg[mi][nt][2 * hr], hreg[mi][nt][2 * hr + 1], hi,
                       lo);
            *reinterpret_cast<uint32_t*>(hhi + off) = hi;
            *reinterpret_cast<uint32_t*>(hlo + off) = lo;
          }
        }
      }
    }
  }

  // the final state, f32
  float* out = hout + static_cast<size_t>(bh) * n * p;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int mt = warp + 4 * mi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
        const int col = p0 + 8 * nt + 2 * t;
        if (row >= n) continue;
        if (col < p) out[static_cast<size_t>(row) * p + col] =
            hreg[mi][nt][2 * hr];
        if (col + 1 < p) out[static_cast<size_t>(row) * p + col + 1] =
            hreg[mi][nt][2 * hr + 1];
      }
    }
  }
}

// ---- launchers ---------------------------------------------------------- //
// The body a shape runs (lm_common.cuh's rule).
inline int ssd_body(int q, int n, int dtype) {
  return ssd_tensor_cores(q, n, dtype) ? kSsdBodyMma : kSsdBodyFma;
}

template <int PS>
int launch_ssd_mma(const void* xb, const void* al, const void* bm,
                   const void* cm, void* y, void* hout, int batch, int nc,
                   int q, int nh, int p, int n, cudaStream_t stream) {
  constexpr size_t bytes = ssd_mma_smem<PS>();
  static_assert(bytes <= kMaxSmemBytes / 2, "two blocks an SM");
  const int vec = aligned16(xb) && aligned16(bm) && aligned16(cm) &&
                  p % 8 == 0 && n % 8 == 0;
  const auto kernel = ssd_scan_mma_kernel<PS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(batch) * nh * ((p + PS - 1) / PS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kSsdMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(xb), static_cast<const float*>(al),
      static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
      static_cast<bf16*>(y), static_cast<float*>(hout), nc, q, nh, p, n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ssd_fma(const void* xb, const void* al, const void* bm,
                   const void* cm, void* y, void* hout, int batch, int nc,
                   int q, int nh, int p, int n, cudaStream_t stream) {
  const SsdFmaLayout lay = ssd_fma_layout<T>(q, p, n);
  if (lay.rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_fma_kernel<T><<<batch * nh, kSsdThreads, lay.bytes, stream>>>(
      static_cast<const T*>(xb), static_cast<const float*>(al),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), static_cast<float*>(hout), nc, q, nh, p, n, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// Which body rt_ssd_scan runs for a chunk of q steps, N = n and the
// element type dtype: 1 the tensor-core body, 0 the FMA body.
extern "C" int rt_ssd_scan_body(int q, int n, int dtype) {
  return repro_torch::ssd_body(q, n, dtype);
}

// Shapes as at the kernels above; dtype is that of xb, bm, cm and y.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue when a
// chunk's tiles do not fit in shared memory).
extern "C" int rt_ssd_scan(const void* xb, const void* al, const void* bm,
                           const void* cm, void* y, void* hout, int batch,
                           int nc, int q, int nh, int p, int n, int dtype,
                           void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || nh <= 0 || nc <= 0 || q <= 0 || p <= 0 || n <= 0)
    return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ssd_body(q, n, dtype) == kSsdBodyMma) {
    if (p <= 16)
      return launch_ssd_mma<16>(xb, al, bm, cm, y, hout, batch, nc, q, nh, p,
                                n, st);
    return launch_ssd_mma<32>(xb, al, bm, cm, y, hout, batch, nc, q, nh, p,
                              n, st);
  }
  if (dtype == kDtypeF32)
    return launch_ssd_fma<float>(xb, al, bm, cm, y, hout, batch, nc, q, nh,
                                 p, n, st);
  if (dtype == kDtypeBF16)
    return launch_ssd_fma<bf16>(xb, al, bm, cm, y, hout, batch, nc, q, nh, p,
                                n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
