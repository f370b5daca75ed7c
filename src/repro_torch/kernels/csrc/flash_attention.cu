// flash_attention: attention forward with an online softmax, GQA,
//
//   o[b, h, i] = sum_j softmax_j(s_ij) v[b, g, j],
//   s_ij = scale q[b, h, i] . k[b, g, j],  g = h / (H / KV),
//
// over the keys j < seq_kv (the rest is padding) and, when causal, j <= i
// — the causal mask aligned at the start of both sequences, as the TPU
// kernel's is.  A row with no key left gives 0.  Accumulators are f32;
// the output takes q's type.
//
// Replaces the TPU kernel flash_attention_kernel in
// src/repro/kernels/flash_attention/kernel.py (launched by
// flash_attention_pallas there, through flash_attention in ops.py).  No
// model of either package calls it: it is its own op.
//
// What bounds it: operations.  Causal attention over S keys does about
// 2 S^2 D multiply-adds a head: at the recurrentgemma-9b prefill shape
// (H = 16, KV = 1, S = 2,048, D = 256) 34 GFLOP, 0.035 ms at the H100
// SXM's 989 TFLOP/s in bf16, against 17 MB of bytes.  Both variants are
// the simple design: one block of 256 threads a (b * h, 64-row q tile)
// walks the 64-key tiles (only those left of the diagonal when causal,
// and before seq_kv) and keeps the running max, sum and rescale factor
// of each row in shared memory, four threads a row.  Key tiles that the
// mask empties entirely are skipped: they would rescale by exp(0) and
// add 0, as the TPU kernel's masked no-op steps do.
//
//   * bf16 with D a multiple of 16 (flash_attention_wmma_kernel): the
//     two products on the tensor cores as 16 x 16 x 16 WMMA with f32
//     accumulation, the o accumulator in shared memory (195 KB at
//     D = 256);
//   * float32, or another D (flash_attention_kernel): FMA on the CUDA
//     cores, the scaled q tile in f32 in shared memory, each thread a
//     4 x 4 block of scores (k's rows padded by one 32-bit word, so the
//     16 key columns a thread group reads fall in 16 banks) and 4 rows
//     x D/16 columns of the f32 accumulator in registers (214 KB of
//     shared memory at D = 256 in f32).
//
// Both need more than the 48 KB of shared memory a kernel gets by
// default, so each launch raises the dynamic limit first.

#include <mma.h>

#include "lm_common.cuh"

namespace repro_torch {

constexpr int kFlashThreads = 256;
constexpr int kFlashBQ = 64;          // q rows a block
constexpr int kFlashBK = 64;          // keys a tile
constexpr int kFlashLds = kFlashBK + 1;
constexpr float kFlashNegInf = -1e30f;  // NEG_INF of the TPU kernel

template <typename T>
size_t flash_smem_bytes(int d, int ldk) {
  return 4 * (static_cast<size_t>(kFlashBQ) * d + kFlashBQ * kFlashLds +
              3 * kFlashBQ) +
         sizeof(T) * (static_cast<size_t>(kFlashBK) * ldk +
                      static_cast<size_t>(kFlashBK) * d);
}

// q, o: (B, H, sq, d); k, v: (B, KV, skv, d).  Grid (q tiles, B * H).
// DC is the number of 16-column groups of the accumulator (d <= 16 DC).
template <typename T, int DC>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int nh,
                           int nkv, int sq, int skv, int d, int seq_kv,
                           int causal, float scale, int ldk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // (BQ, d) scaled q
  float* ss = qs + kFlashBQ * d;               // (BQ, Lds) scores, then p
  float* m_s = ss + kFlashBQ * kFlashLds;      // running max
  float* l_s = m_s + kFlashBQ;                 // running sum
  float* a_s = l_s + kFlashBQ;                 // this tile's rescale
  T* ks = reinterpret_cast<T*>(a_s + kFlashBQ);  // (BK, ldk)
  T* vs = ks + kFlashBK * ldk;                   // (BK, d)

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int g = h / (nh / nkv);
  const int q0 = blockIdx.x * kFlashBQ;
  const int qrows = min(kFlashBQ, sq - q0);
  const size_t qbase = (static_cast<size_t>(bh) * sq + q0) * d;
  const size_t kbase = static_cast<size_t>(b * nkv + g) * skv * d;

  for (int i = tid; i < kFlashBQ * d; i += kFlashThreads) {
    qs[i] = i / d < qrows ? to_f32(q[qbase + i]) * scale : 0.0f;
  }
  for (int i = tid; i < kFlashBQ; i += kFlashThreads) {
    m_s[i] = kFlashNegInf;
    l_s[i] = 0.0f;
  }
  int kend = min(seq_kv, skv);
  if (causal) kend = min(kend, q0 + kFlashBQ);
  const int ntiles = (kend + kFlashBK - 1) / kFlashBK;

  const int r4 = (tid / 16) * 4;  // first of the 4 rows a thread owns
  const int c16 = tid % 16;       // its column within each 16 group
  const int prow = tid / 4, psub = tid % 4;  // softmax: 4 threads a row
  float acc[4][DC] = {};

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kFlashBK;
    __syncthreads();  // the previous tile is done with ks, vs and ss
    for (int i = tid; i < kFlashBK * d; i += kFlashThreads) {
      const int r = i / d, c = i % d;
      const bool in = k0 + r < skv;
      const size_t src = kbase + static_cast<size_t>(k0 + r) * d + c;
      ks[r * ldk + c] = in ? k[src] : from_f32<T>(0.0f);
      vs[r * d + c] = in ? v[src] : from_f32<T>(0.0f);
    }
    __syncthreads();

    // scores, masked: NEG_INF where the key is padding or in the future
    {
      float sacc[4][4] = {};
      for (int dd = 0; dd < d; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) qv[u] = qs[(r4 + u) * d + dd];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          kv[w] = to_f32(ks[(c16 + 16 * w) * ldk + dd]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) sacc[u][w] += qv[u] * kv[w];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int qpos = q0 + r4 + u;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = c16 + 16 * w, kpos = k0 + j;
          const bool valid = kpos < seq_kv && (!causal || kpos <= qpos);
          ss[(r4 + u) * kFlashLds + j] = valid ? sacc[u][w] : kFlashNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: new max, p = exp(s - max) (0 where masked), sums
    {
      const int qpos = q0 + prow;
      float* srow = ss + prow * kFlashLds;
      float mx = kFlashNegInf;
#pragma unroll
      for (int c = 0; c < kFlashBK / 4; ++c) mx = fmaxf(mx, srow[psub + 4 * c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[prow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kFlashBK / 4; ++c) {
        const int j = psub + 4 * c, kpos = k0 + j;
        const bool valid = kpos < seq_kv && (!causal || kpos <= qpos);
        const float p = valid ? expf(srow[j] - m_new) : 0.0f;
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (psub == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[prow] = l_s[prow] * alpha + sum;
        m_s[prow] = m_new;
        a_s[prow] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
    {
      const int jend = min(kFlashBK, kend - k0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float alpha = a_s[r4 + u];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[u][c] *= alpha;
      }
      for (int j = 0; j < jend; ++j) {
        float pv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) pv[u] = ss[(r4 + u) * kFlashLds + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = c16 + 16 * c;
          const float vv = col < d ? to_f32(vs[j * d + col]) : 0.0f;
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u][c] += pv[u] * vv;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = r4 + u;
    if (row >= qrows) continue;
    const float denom = fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = c16 + 16 * c;
      if (col < d) {
        o[qbase + static_cast<size_t>(row) * d + col] =
            from_f32<T>(acc[u][c] / denom);
      }
    }
  }
}

// The tensor-core variant for bf16 with D a multiple of 16: the same
// blocks, tiles, mask and online softmax, with the two products as
// 16 x 16 x 16 bf16 WMMA (f32 accumulation).  The scores S = q k^T come
// out of the tensor cores unscaled and are scaled in f32 before the
// mask; p is rounded to bf16 for p v (the row sums stay f32); the f32
// accumulator of o lives in shared memory, where each row is rescaled
// by its running-max factor before the tile's p v is added to it.
constexpr int kWmmaPad = 8;  // bf16 elements (16 bytes) a padded row
constexpr int kWmmaLds = kFlashBK + 4;  // f32 score row
constexpr int kWmmaLdp = kFlashBK + kWmmaPad;  // bf16 p row

struct WmmaLayout {
  int ld, ldo;                            // bf16 q/k/v row, f32 o row
  size_t qs, ks, vs, ss, ps, os, st, bytes;  // byte offsets
};

inline WmmaLayout wmma_layout(int d) {
  WmmaLayout L;
  L.ld = d + kWmmaPad;
  L.ldo = d + 4;
  size_t off = 0;
  // each region starts on a 128-byte boundary (WMMA wants 32)
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off = (off + bytes + 127) & ~static_cast<size_t>(127);
    return at;
  };
  const size_t bq = kFlashBQ, bk = kFlashBK;
  L.qs = take(2 * bq * L.ld);
  L.ks = take(2 * bk * L.ld);
  L.vs = take(2 * bk * L.ld);
  L.ss = take(4 * bq * kWmmaLds);
  L.ps = take(2 * bq * kWmmaLdp);
  L.os = take(4 * bq * L.ldo);
  L.st = take(4 * 3 * bq);
  L.bytes = off;
  return L;
}

__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_wmma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int nh,
                                int nkv, int sq, int skv, int d, int seq_kv,
                                int causal, float scale, WmmaLayout L) {
  namespace wm = nvcuda::wmma;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char wsmem[];
  bf16* qs = reinterpret_cast<bf16*>(wsmem + L.qs);    // (BQ, ld)
  bf16* ks = reinterpret_cast<bf16*>(wsmem + L.ks);    // (BK, ld)
  bf16* vs = reinterpret_cast<bf16*>(wsmem + L.vs);    // (BK, ld)
  float* ss = reinterpret_cast<float*>(wsmem + L.ss);  // (BQ, Lds) scores
  bf16* ps = reinterpret_cast<bf16*>(wsmem + L.ps);    // (BQ, Ldp) p
  float* os = reinterpret_cast<float*>(wsmem + L.os);  // (BQ, ldo) o acc
  float* m_s = reinterpret_cast<float*>(wsmem + L.st);
  float* l_s = m_s + kFlashBQ;
  float* a_s = l_s + kFlashBQ;
  const int ld = L.ld, ldo = L.ldo;

  const int tid = threadIdx.x, warp = tid / 32;
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int g = h / (nh / nkv);
  const int q0 = blockIdx.x * kFlashBQ;
  const int qrows = min(kFlashBQ, sq - q0);
  const size_t qbase = (static_cast<size_t>(bh) * sq + q0) * d;
  const size_t kbase = static_cast<size_t>(b * nkv + g) * skv * d;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int i = tid; i < kFlashBQ * d; i += kFlashThreads) {
    const int r = i / d, c = i % d;
    qs[r * ld + c] = r < qrows ? q[qbase + i] : zero;
    os[r * ldo + c] = 0.0f;
  }
  for (int i = tid; i < kFlashBQ; i += kFlashThreads) {
    m_s[i] = kFlashNegInf;
    l_s[i] = 0.0f;
  }
  int kend = min(seq_kv, skv);
  if (causal) kend = min(kend, q0 + kFlashBQ);
  const int ntiles = (kend + kFlashBK - 1) / kFlashBK;
  const int prow = tid / 4, psub = tid % 4;
  const int dt = d / 16;  // 16-column tiles of q, k, v, o

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kFlashBK;
    __syncthreads();  // the previous tile is done with ks, vs, ss, ps
    for (int i = tid; i < kFlashBK * d; i += kFlashThreads) {
      const int r = i / d, c = i % d;
      const bool in = k0 + r < skv;
      const size_t src = kbase + static_cast<size_t>(k0 + r) * d + c;
      ks[r * ld + c] = in ? k[src] : zero;
      vs[r * ld + c] = in ? v[src] : zero;
    }
    __syncthreads();

    // S = q k^T: 4 x 4 tiles of 16 x 16, two a warp
    for (int t = warp; t < 16; t += kFlashThreads / 32) {
      const int rt = t / 4, ct = t % 4;
      wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
      wm::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < dt; ++kk) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb;
        wm::load_matrix_sync(fa, qs + rt * 16 * ld + kk * 16, ld);
        wm::load_matrix_sync(fb, ks + ct * 16 * ld + kk * 16, ld);
        wm::mma_sync(acc, fa, fb, acc);
      }
      wm::store_matrix_sync(ss + rt * 16 * kWmmaLds + ct * 16, acc, kWmmaLds,
                            wm::mem_row_major);
    }
    __syncthreads();

    // online softmax on the scaled, masked scores; p to bf16
    {
      const int qpos = q0 + prow;
      const float* srow = ss + prow * kWmmaLds;
      float sv[kFlashBK / 4];
      float mx = kFlashNegInf;
#pragma unroll
      for (int c = 0; c < kFlashBK / 4; ++c) {
        const int j = psub + 4 * c, kpos = k0 + j;
        const bool valid = kpos < seq_kv && (!causal || kpos <= qpos);
        sv[c] = valid ? srow[j] * scale : kFlashNegInf;
        mx = fmaxf(mx, sv[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[prow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kFlashBK / 4; ++c) {
        const int j = psub + 4 * c, kpos = k0 + j;
        const bool valid = kpos < seq_kv && (!causal || kpos <= qpos);
        const float p = valid ? expf(sv[c] - m_new) : 0.0f;
        ps[prow * kWmmaLdp + j] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (psub == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[prow] = l_s[prow] * alpha + sum;
        m_s[prow] = m_new;
        a_s[prow] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < kFlashBQ * d; i += kFlashThreads) {
      const int r = i / d, c = i % d;
      os[r * ldo + c] *= a_s[r];
    }
    __syncthreads();

    // o += p v: 4 x (d / 16) tiles of 16 x 16
    for (int t = warp; t < 4 * dt; t += kFlashThreads / 32) {
      const int rt = t % 4, ct = t / 4;
      wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
      float* tile = os + rt * 16 * ldo + ct * 16;
      wm::load_matrix_sync(acc, tile, ldo, wm::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kFlashBK / 16; ++kk) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
        wm::load_matrix_sync(fa, ps + rt * 16 * kWmmaLdp + kk * 16,
                             kWmmaLdp);
        wm::load_matrix_sync(fb, vs + kk * 16 * ld + ct * 16, ld);
        wm::mma_sync(acc, fa, fb, acc);
      }
      wm::store_matrix_sync(tile, acc, ldo, wm::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < kFlashBQ * d; i += kFlashThreads) {
    const int r = i / d, c = i % d;
    if (r < qrows) {
      o[qbase + i] = __float2bfloat16(os[r * ldo + c] /
                                      fmaxf(l_s[r], 1e-30f));
    }
  }
}

int launch_flash_wmma(const void* q, const void* k, const void* v, void* o,
                      int batch, int nh, int nkv, int sq, int skv, int d,
                      int seq_kv, int causal, float scale,
                      cudaStream_t stream) {
  const WmmaLayout L = wmma_layout(d);
  if (L.bytes > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch * nh);
  flash_attention_wmma_kernel<<<grid, kFlashThreads, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      nh, nkv, sq, skv, d, seq_kv, causal, scale, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DC>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int batch, int nh, int nkv, int sq, int skv, int d,
                 int seq_kv, int causal, float scale, cudaStream_t stream) {
  const int ldk = d + word_pad<T>();
  const size_t bytes = flash_smem_bytes<T>(d, ldk);
  if (bytes > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch * nh);
  flash_attention_kernel<T, DC><<<grid, kFlashThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nh, nkv, sq, skv, d,
      seq_kv, causal, scale, ldk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_flash(const void* q, const void* k, const void* v, void* o,
                   int batch, int nh, int nkv, int sq, int skv, int d,
                   int seq_kv, int causal, float scale,
                   cudaStream_t stream) {
  if (d <= 64)
    return launch_flash<T, 4>(q, k, v, o, batch, nh, nkv, sq, skv, d,
                              seq_kv, causal, scale, stream);
  if (d <= 128)
    return launch_flash<T, 8>(q, k, v, o, batch, nh, nkv, sq, skv, d,
                              seq_kv, causal, scale, stream);
  return launch_flash<T, 16>(q, k, v, o, batch, nh, nkv, sq, skv, d, seq_kv,
                             causal, scale, stream);
}

}  // namespace repro_torch

// Shapes as at flash_attention_kernel; d <= 256, nh a multiple of nkv,
// batch * nh <= 65,535.  Returns the cudaError_t of the launch.
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int batch, int nh,
                                  int nkv, int sq, int skv, int d,
                                  int seq_kv, int causal, int dtype,
                                  float scale, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || nh <= 0 || sq <= 0 || d <= 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || d > 256 ||
      static_cast<long long>(batch) * nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return dispatch_flash<float>(q, k, v, o, batch, nh, nkv, sq, skv, d,
                                 seq_kv, causal, scale, st);
  if (dtype == kDtypeBF16 && d % 16 == 0)
    return launch_flash_wmma(q, k, v, o, batch, nh, nkv, sq, skv, d, seq_kv,
                             causal, scale, st);
  if (dtype == kDtypeBF16)
    return dispatch_flash<__nv_bfloat16>(q, k, v, o, batch, nh, nkv, sq, skv,
                                         d, seq_kv, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
