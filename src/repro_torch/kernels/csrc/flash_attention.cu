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
// SXM's 989 TFLOP/s in bf16, against 17 MB of bytes.  So the products
// must run on the tensor cores and be fed from registers and shared
// memory, not from device memory, and the softmax between them must not
// leave the registers.
//
//   * bf16 with D a multiple of 16 (flash_attention_mma_kernel, below):
//     FlashAttention-2 on mma.sync.m16n8k16 — the score and o
//     accumulators in registers, rescaled in place by each row's running
//     max; K/V tiles double-buffered by cp.async so that the copies
//     overlap the products; q in shared memory, fed by ldmatrix; the
//     query heads of one kv group packed into a block, so that a K/V
//     tile loaded once serves all of them (16 heads at recurrentgemma's
//     MQA); blocks ordered longest first.  Its note says more.  (It
//     replaced a WMMA kernel whose opaque accumulator layout kept o in
//     shared memory, 195 KB at D = 256, one block an SM.)
//   * float32, or bf16 with another D (flash_attention_kernel): FMA on
//     the CUDA cores, because TF32 products keep about three decimal
//     digits and would break the f32 tolerance of 2e-5.  One block of
//     256 threads a (b * h, 64-row q tile) walks the 64-key tiles (only
//     those left of the diagonal when causal, and before seq_kv) and
//     keeps the running max, sum and rescale factor of each row in
//     shared memory, four threads a row; the scaled q tile in f32 in
//     shared memory, each thread a 4 x 4 block of scores (k's rows
//     padded by one 32-bit word, so the 16 key columns a thread group
//     reads fall in 16 banks) and 4 rows x D/16 columns of the f32
//     accumulator in registers (214 KB of shared memory at D = 256 in
//     f32).  Key tiles that the mask empties entirely are skipped: they
//     would rescale by exp(0) and add 0, as the TPU kernel's masked
//     no-op steps do.
//
// Both need more than the 48 KB of shared memory a kernel gets by
// default, so each launch raises the dynamic limit first.

#include <algorithm>
#include <cmath>

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

// The tensor-core variant for bf16 with D a multiple of 16, in the
// FlashAttention-2 manner: both products as mma.sync.m16n8k16 (bf16 in,
// f32 accumulate), with the score and o accumulators in registers.
//
// A block is kMmaWarps warps; a warp owns MT row tiles of 16 rows (two
// up to D = 128, one at D = 256), so that each K and V fragment it reads
// from shared memory feeds MT products.  The rows are query heads that
// share one kv head, packed: row r is head h0 + r % gc at query position
// p0 + r / gc (gc heads of the group a block, rows / gc positions), so a
// K/V tile loaded once serves every head of the group.  The block walks
// BK-key tiles up to its last row's diagonal (causal) and seq_kv: tile
// kt + 1 is copied by cp.async into the other half of a double buffer
// while tile kt is multiplied.  The q tile stays in shared memory and is
// fed by ldmatrix.
// K feeds S = q k^T through ldmatrix, V feeds o += p v through
// ldmatrix.trans, and p goes from the S accumulator to the A operand in
// registers (the m16n8 accumulator layout of two neighbouring n-tiles
// is the m16k16 A layout).  Each lane holds two rows' running max and
// partial sum a row tile; the row max is reduced over the four lanes of
// a row by shuffles and the accumulators are rescaled in place.  Scores
// are scaled in f32 after the product, exponentiated as exp2 with
// log2(e) folded into the scale; p is rounded to bf16 for p v, the sums
// stay f32.  Masked scores are -inf, and a row whose keys are all masked
// keeps max -inf, p 0, sum 0 and gives 0.  Only the tiles that cross
// seq_kv or the block's first diagonal are masked.  The blocks are
// ordered longest first (the last position tiles, which walk the most
// keys when causal, launch first).  The output goes through the q
// tile's shared memory to 16-byte stores.
//
// D is rounded up to DMAX (32, 64, 128 or 256) with zero columns; the
// key tile is 64 keys, 32 at DMAX = 256, so that 2 blocks fit an SM:
// (rows + 4 BK) (DMAX + 8) bf16 of shared memory, 101 KB at DMAX = 256
// and 104 KB at DMAX = 128.  At D = 128 the two row tiles take all 255
// registers and spill about 100 bytes a thread; on the card that still
// beat one row tile with q kept in registers.
constexpr int kMmaWarps = 4;

struct MmaGrid {
  int gc;             // heads of one kv group a block
  int hchunks;        // blocks across one group's heads
  int pos_per_block;  // query positions a block
  int pos_tiles;      // blocks along the query positions
};

// A block of kMmaWarps warps, each MT m16 row tiles (16 MT rows), BK
// keys a tile.
template <int DMAX, int MT, int BK>
struct MmaTile {
  static constexpr int kRows = 16 * MT * kMmaWarps;
  static constexpr size_t kSmem = 2ull * (kRows + 4 * BK) * (DMAX + 8);
};

// q, o: (B, H, sq, d); k, v: (B, KV, skv, d), bf16.  A 1-D grid of
// pos_tiles * B * KV * hchunks blocks of kMmaWarps warps.
template <int DMAX, int MT, int BK>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ o, int nh,
                               int nkv, int sq, int skv, int d, int seq_kv,
                               int causal, float scale, MmaGrid grid) {
  using bf16 = __nv_bfloat16;
  constexpr int kRows = MmaTile<DMAX, MT, BK>::kRows;
  constexpr int LD = DMAX + 8;    // padded shared row: 16 bytes a row
  constexpr int CH = DMAX / 8;    // 16-byte chunks a row
  constexpr int DK = DMAX / 16;   // k-steps of q k^T
  constexpr int DN = DMAX / 8;    // n-tiles of o
  constexpr int KN = BK / 8;      // n-tiles of S
  constexpr int KK = BK / 16;     // k-steps of p v
  constexpr int kThreads = kMmaWarps * 32;
  extern __shared__ __align__(128) unsigned char msmem[];
  bf16* qs = reinterpret_cast<bf16*>(msmem);  // (rows, LD)
  bf16* ks = qs + kRows * LD;                 // 2 x (BK, LD)
  bf16* vs = ks + 2 * BK * LD;                // 2 x (BK, LD)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_tile = gridDim.x / grid.pos_tiles;
  const int pt = grid.pos_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int hc = rest % grid.hchunks;
  rest /= grid.hchunks;
  const int g = rest % nkv, b = rest / nkv;
  const int group = nh / nkv;
  const int h0 = g * group + hc * grid.gc;
  const int heads = min(grid.gc, group - hc * grid.gc);
  const int p0 = pt * grid.pos_per_block;
  const int pos_end = min(sq, p0 + grid.pos_per_block);
  const size_t kbase = static_cast<size_t>(b * nkv + g) * skv * d;

  // the q row of block row r, or -1 past the heads or positions
  auto q_row = [&](int r) -> long long {
    const int pos = p0 + r / grid.gc, hi = r % grid.gc;
    if (r / grid.gc >= grid.pos_per_block || hi >= heads || pos >= sq)
      return -1;
    return (static_cast<long long>(b) * nh + h0 + hi) * sq + pos;
  };

  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const long long row = q_row(r);
    const bool in = row >= 0 && c * 8 < d;
    cp_async16(smem_addr(qs + r * LD + c * 8),
               in ? q + row * d + c * 8 : q, in);
  }
  cp_async_commit();

  const int nkeys = min(seq_kv, skv);
  const int kend = causal ? min(nkeys, pos_end) : nkeys;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
    bf16* kd = ks + (kt & 1) * BK * LD;
    bf16* vd = vs + (kt & 1) * BK * LD;
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < skv && c * 8 < d;
      const size_t src = kbase + static_cast<size_t>(k0 + r) * d + c * 8;
      cp_async16(smem_addr(kd + r * LD + c * 8), in ? k + src : k, in);
      cp_async16(smem_addr(vd + r * LD + c * 8), in ? v + src : v, in);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_tile(0);

  // this lane's rows: gq and gq + 8 of each of the warp's MT row tiles
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16 * MT;  // the warp's first block row
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      pos[mt][hr] = p0 + (wrow + 16 * mt + gq + 8 * hr) / grid.gc;
  const float sl2 = scale * kLog2e;

  float acc[MT][DN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < DN; ++i)
      acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.0f;
  float mrow[MT][2], lrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mrow[mt][0] = mrow[mt][1] = -INFINITY;
    lrow[mt][0] = lrow[mt][1] = 0.0f;
  }

  // ldmatrix lane addressing: matrix lane >> 3, its row lane & 7
  const int lrow8 = lane & 7, lmat = lane >> 3;
  const uint32_t q_lane = smem_addr(
      qs + (wrow + lrow8 + (lmat & 1) * 8) * LD + (lmat >> 1) * 8);

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      load_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = ks + (kt & 1) * BK * LD;
    const bf16* vt_s = vs + (kt & 1) * BK * LD;

    // S = q k^T; each K fragment serves the warp's MT row tiles
    float s[MT][KN][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < KN; ++i)
        s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.0f;
    const uint32_t k_lane = smem_addr(
        kt_s + (lrow8 + (lmat >> 1) * 8) * LD + (lmat & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], q_lane + (mt * 16 * LD + kk * 16) * 2);
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_lane + (np * 16 * LD + kk * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // mask: key j is seen by a row at position i iff j < seq_kv and,
    // when causal, j <= i
    const int k0 = kt * BK;
    if (k0 + BK > nkeys || (causal && k0 + BK - 1 > p0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < KN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + nt * 8 + 2 * tq + (e & 1);
            if (j >= nkeys || (causal && j > pos[mt][e >> 1]))
              s[mt][nt][e] = -INFINITY;
          }
    }

    // online softmax, two rows a lane a row tile, four lanes a row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < KN; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hr], s[mt][nt][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[mt][hr], mx);
        // a row with no key yet keeps -inf: exponentiate against 0 then
        const float m_use = m_new == -INFINITY ? 0.0f : m_new * sl2;
        const float alpha = exp2f(mrow[mt][hr] * sl2 - m_use);
        mrow[mt][hr] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < KN; ++nt) {
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const float p = exp2f(s[mt][nt][e] * sl2 - m_use);
            s[mt][nt][e] = p;
            sum += p;
          }
        }
        lrow[mt][hr] = lrow[mt][hr] * alpha + sum;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          acc[mt][dn][2 * hr] *= alpha;
          acc[mt][dn][2 * hr + 1] *= alpha;
        }
      }
    }

    // o += p v; each V fragment serves the warp's MT row tiles
    const uint32_t v_lane = smem_addr(
        vt_s + (lrow8 + (lmat & 1) * 8) * LD + (lmat >> 1) * 8);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_lane + (kk * 16 * LD + dp * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], a[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // tile kt's buffers are free for tile kt + 2
  }
  cp_async_wait<0>();  // the q tile, when no key tile was walked
  __syncthreads();

  // o = acc / l, staged in the warp's own q rows, then 16-byte stores
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = lrow[mt][hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;
      bf16* srow = qs + (wrow + 16 * mt + gq + 8 * hr) * LD + 2 * tq;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        *reinterpret_cast<__nv_bfloat162*>(srow + dn * 8) =
            __floats2bfloat162_rn(acc[mt][dn][2 * hr] * inv,
                                  acc[mt][dn][2 * hr + 1] * inv);
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * MT * CH; i += 32) {
    const int r = wrow + i / CH, c = i % CH;
    const long long row = q_row(r);
    if (row >= 0 && c * 8 < d) {
      *reinterpret_cast<uint4*>(o + row * d + c * 8) =
          *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);
    }
  }
}

template <int DMAX, int MT, int BK>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o,
                     int batch, int nh, int nkv, int sq, int skv, int d,
                     int seq_kv, int causal, float scale,
                     cudaStream_t stream) {
  using Tile = MmaTile<DMAX, MT, BK>;
  static_assert(Tile::kSmem <= kMaxSmemBytes, "flash tile over shared memory");
  const auto kernel = flash_attention_mma_kernel<DMAX, MT, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  MmaGrid grid;
  const int group = nh / nkv;
  grid.gc = std::min(group, Tile::kRows);
  grid.hchunks = (group + grid.gc - 1) / grid.gc;
  grid.pos_per_block = Tile::kRows / grid.gc;
  grid.pos_tiles = (sq + grid.pos_per_block - 1) / grid.pos_per_block;
  const long long blocks = static_cast<long long>(grid.pos_tiles) * batch *
                           nkv * grid.hchunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kMmaWarps * 32, Tile::kSmem,
           stream>>>(static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v),
                     static_cast<__nv_bfloat16*>(o), nh, nkv, sq, skv, d,
                     seq_kv, causal, scale, grid);
  return static_cast<int>(cudaGetLastError());
}

// D rounded up to DMAX with zero columns; the tile by DMAX: two row
// tiles a warp (128 rows a block) up to D = 128, so that each K and V
// fragment read from shared memory feeds two products; one at D = 256,
// where o alone takes 128 registers a lane.
int launch_flash_bf16(const void* q, const void* k, const void* v, void* o,
                      int batch, int nh, int nkv, int sq, int skv, int d,
                      int seq_kv, int causal, float scale,
                      cudaStream_t stream) {
  if (d <= 32)
    return launch_flash_mma<32, 2, 64>(q, k, v, o, batch, nh, nkv, sq, skv, d,
                                       seq_kv, causal, scale, stream);
  if (d <= 64)
    return launch_flash_mma<64, 2, 64>(q, k, v, o, batch, nh, nkv, sq, skv, d,
                                       seq_kv, causal, scale, stream);
  if (d <= 128)
    return launch_flash_mma<128, 2, 64>(q, k, v, o, batch, nh, nkv, sq, skv,
                                        d, seq_kv, causal, scale, stream);
  return launch_flash_mma<256, 1, 32>(q, k, v, o, batch, nh, nkv, sq, skv, d,
                                      seq_kv, causal, scale, stream);
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
    return launch_flash_bf16(q, k, v, o, batch, nh, nkv, sq, skv, d, seq_kv,
                             causal, scale, st);
  if (dtype == kDtypeBF16)
    return dispatch_flash<__nv_bfloat16>(q, k, v, o, batch, nh, nkv, sq, skv,
                                         d, seq_kv, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
