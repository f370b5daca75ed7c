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
// state is written out in f32, y in the input type.
//
// Replaces the TPU kernel ssd_scan_kernel in
// src/repro/kernels/ssd_scan/kernel.py (launched by ssd_scan_pallas
// there, through ssd_chunk_scan in ops.py).  The prefill of every Mamba-2
// layer calls it once.
//
// What bounds it: operations.  A chunk of a head does the (Q, N) x (N, Q)
// product C B^T, the masked (Q, Q) x (Q, P) product, C H and the (N, Q) x
// (Q, P) state update: at Q = N = 128, P = 64 about 10 MFLOP for 100 KB
// read in bf16.  At the mamba2-2.7b prefill (80 heads, S = 2,048) that is
// some 13 GFLOP, 0.014 ms at the H100 SXM's 989 TFLOP/s in bf16 — a bound
// only a tensor-core kernel could approach.  This one is the simple
// design: one block of 256 threads a (b, h) walks the chunks in order,
// so the state never leaves shared memory; every product is f32 FMA on
// shared-memory tiles, each thread computing a 4 x 4 block of outputs
// whose columns are strided by the tile count (so neighbouring threads
// read neighbouring columns, and rows padded by one 32-bit word put the
// transposed reads of B in different banks).
//
// Shared memory: the state (N x P f32), l and its two exponentials (3Q
// f32), x, B and C of the chunk in the input type, and a tile of R rows
// of the (Q, Q) matrix in f32.  At the full width (Q = N = 128, P = 64)
// the whole f32 working set (state 32 KB, (Q, Q) 64 KB, B and C 64 KB
// each, x 32 KB) does not fit the 227 KB a block may use, so the (Q, Q)
// product is split into row tiles of R rows, R as large as fits: all
// 128 rows in bf16, 60 in f32.  The mask is applied before exp: only
// j <= i is ever exponentiated, so exp never overflows into inf * 0.
// The grid is B x H blocks: 80 at the mamba2-2.7b prefill, fewer than
// the card's 132 SMs.

#include "lm_common.cuh"

namespace repro_torch {

constexpr int kSsdThreads = 256;

struct SsdLayout {
  int ldn, ldp, ldq, rows;  // padded row strides (elements), tile rows
  size_t bytes;
};

template <typename T>
SsdLayout ssd_layout(int q, int p, int n) {
  SsdLayout lay;
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
    ssd_scan_kernel(const T* __restrict__ xb, const float* __restrict__ al,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    T* __restrict__ y, float* __restrict__ hout, int nc,
                    int q, int nh, int p, int n, SsdLayout lay) {
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

template <typename T>
int launch_ssd(const void* xb, const void* al, const void* bm, const void* cm,
           void* y, void* hout, int batch, int nc, int q, int nh, int p,
           int n, cudaStream_t stream) {
  const SsdLayout lay = ssd_layout<T>(q, p, n);
  if (lay.rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<batch * nh, kSsdThreads, lay.bytes, stream>>>(
      static_cast<const T*>(xb), static_cast<const float*>(al),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), static_cast<float*>(hout), nc, q, nh, p, n, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// Shapes as at ssd_scan_kernel; dtype is that of xb, bm, cm and y.
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
  if (dtype == kDtypeF32)
    return launch_ssd<float>(xb, al, bm, cm, y, hout, batch, nc, q, nh, p, n,
                             st);
  if (dtype == kDtypeBF16)
    return launch_ssd<__nv_bfloat16>(xb, al, bm, cm, y, hout, batch, nc, q,
                                     nh, p, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
