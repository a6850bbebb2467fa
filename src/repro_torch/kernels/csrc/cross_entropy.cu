// Fused vocab-softmax cross-entropy for Hopper (sm_90a): forward, dH, dW.
//
// Replaces the TPU kernels in src/repro/kernels/cross_entropy.py:
// `_ce_kernel` behind `fused_cross_entropy` (its pallas_call at :120) and
// `_ce_dh_kernel` / `_ce_dw_kernel` behind `fused_cross_entropy_bwd` (:266,
// :287). Same contract: hidden h (T, D) and the output weight W (D, Vpad)
// in bf16, int32 targets (T,) and the true vocab (columns >= vocab are
// masked):
//   forward   logits = h W (fp32), lse = logsumexp over the vocab,
//             loss = lse - logit[target]           -> loss, lse (T,) fp32
//   backward  dlogits = (g_loss + g_lse) p - g_loss onehot(target),
//             p = exp(min(logit - lse, 0)) on valid columns, 0 on padding
//             dH = dlogits W^T (T, D), dW = h^T dlogits (D, Vpad)
// A target outside [0, vocab) has no logit: its loss is lse + 1e30, as the
// reference's. dW's padded columns are exactly 0. No atomics: a repeated
// call gives the same bits.
//
// Layouts. W is read where the model holds it: the untied head as a
// row-major (D, Vpad) matrix, the tied head (W = embed^T) as the row-major
// (Vpad, D) embedding table behind that view; dW is written in the same
// layout (for the tied head as dW^T, the table's gradient). Every product
// goes through the GEMM mainloop of ce_gemm.cuh (TMA into a 5-stage ring,
// wgmma m64n128k16 with fp32 accumulation, a producer warpgroup and two
// consumers), which takes each operand K-major or MN-major, so nothing is
// transposed or copied.
//
// Design. The TPU kernels carry the online LSE (forward) and the dH / dW
// sums across a sequential grid axis in VMEM, and keep the dlogits block of
// a grid step in VMEM for both products. Hopper blocks run in no order and
// a block's shared memory holds a few 128 x 128 tiles, so:
//   forward   the grid is (token tiles) x (vocab splits): a block walks its
//             split's run of 128 x 128 logits tiles through one ring,
//             keeping each row's running (max, sum, target logit) in
//             registers, and writes one fp32 (m, l, tl) a row; a second
//             kernel merges each row's splits in split order into lse and
//             loss. The splits end at the last live vocab tile,
//             ceil(vocab / 128), not at Vpad, and there are enough of them
//             for about 16 waves of one block an SM.
//   backward  the vocabulary in chunks of whole tiles, the (T, chunk) bf16
//             dlogits within a 256 MB scratch buffer (4 chunks of 50 560
//             columns at T 2 048; one at ESM-2's 33 live columns). For each
//             chunk, in stream order, each a persistent grid of one block
//             an SM: (i) logits = h W[:, chunk] with the dlogits epilogue,
//             rounded to bf16 into the buffer, each tile computed once;
//             (ii) dH += dlogits W[:, chunk]^T into an fp32 (T, D) sum,
//             chunk after chunk (bf16 dH written by the last); (iii)
//             dW[:, chunk] = h^T dlogits, written once; when a chunk makes
//             too few output tiles to fill the card (ESM-2: 10), the token
//             contraction splits into shares whose fp32 sums are added in
//             share order over the live columns only. The padded columns
//             [vocab, Vpad) of dW are zero-filled, no product. Where the
//             TPU kernel keeps a dlogits block in VMEM, here the logits
//             would be recomputed once per output tile of dH and dW (D /
//             128 = 40 times at D 5 120) unless stored: a bounded chunk
//             stores them once and reads them twice, 3 x 207 MB at Scout's
//             shape, and the work is the 6 T D vocab FLOP of the bound.
// bf16 x bf16 products are exact in fp32, so logits match the TPU kernel's
// fp32 dot of upcast values up to summation order. dlogits is rounded to
// bf16 before the dH and dW products (the TPU kernel keeps it fp32): at
// most 2^-9 relative per element, which is the stated tolerance.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), counting only
// the work the function needs, on the `vocab` live columns of W: the
// forward is 2*T*D*vocab FLOP against h and W's live columns read once, the
// targets read and loss and lse written; the backward 6*T*D*vocab FLOP
// against the same reads plus lse and the two cotangents, dh written and
// dW written whole (D, Vpad). At the ESM-2 training shape T = 8192,
// D = 1280, Vpad = 256, vocab = 33: 0.69 GFLOP (0.7 us) against 21.2 MB
// (6.3 us) forward, 2.1 GFLOP (2.1 us) against 42.8 MB (12.8 us) backward,
// bytes bound both. At Llama-4-Scout's training shape T = 2048, D = 5120,
// Vpad = 202 240, vocab = 202 048: 4.24 TFLOP (4.28 ms) against 2.09 GB
// (0.62 ms) forward, 12.7 TFLOP (12.85 ms) against 4.18 GB (1.25 ms)
// backward, operations bound both.

#include <cuda.h>
#include <cuda_runtime.h>

#include "ce_gemm.cuh"
#include "mma.cuh"

namespace {

using ce::kAcc;
using ce::kBM;
using ce::Operand;
using M = Mma<__nv_bfloat16>;
constexpr float kNegInf = -1e30f;
// the forward's logits are summed 8 slices (512 of D) at a time on the
// tensor cores (ce_gemm.cuh): at Scout's shape that takes its lse from
// ~1e-4 to ~1e-5 of an fp64 one (cuBLAS's fp32 product: ~1.6e-5) for ~3%
// of its time
constexpr int kFwdFlush = 8;

__host__ __device__ __forceinline__ unsigned cdiv(long long a, long long b) {
  return unsigned((a + b - 1) / b);
}

// ---- forward
struct FwdParams {
  const int* tgt;
  float* part;      // (3, splits, T): each split's m, l, tl of every row
  int T, D, vocab, n_live, tiles_per_split, splits;
};

// the block's run of vocab tiles for its token tile, each over all of D
struct RunSeq {
  int n, m0, v_lo, D;
  __device__ __forceinline__ int4 at(int j) const { return make_int4(m0, (v_lo + j) * kBM, 0, D); }
};

// the running (max, sum of exp, target logit) of a thread's 2 rows over
// its 32 columns of each tile
struct OnlineLse {
  float m[2], l[2], tl[2];
  int tgt[2];
  int vocab;
  ce::Frag f;

  __device__ __forceinline__ OnlineLse(const FwdParams& p, int m0) : vocab(p.vocab) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + f.row0 + 8 * hh;
      tgt[hh] = row < p.T ? p.tgt[row] : -1;
      m[hh] = kNegInf;
      l[hh] = 0.f;
      tl[hh] = kNegInf;
    }
  }

  __device__ __forceinline__ void operator()(const int4& t, float (&acc)[kAcc]) {
    const int c0 = t.y + f.col0;  // the column of acc[0]
    const int lim = vocab - c0;   // column 8 i + e is live when below lim
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tc = tgt[hh] - c0;
      float mx = m[hh];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + e;
          const float x = acc[4 * i + 2 * hh + e];
          if (c < lim) {
            mx = fmaxf(mx, x);
            if (c == tc) tl[hh] = x;
          }
        }
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * i + e < lim) s += expf(acc[4 * i + 2 * hh + e] - mx);
      l[hh] = l[hh] * expf(m[hh] - mx) + s;
      m[hh] = mx;
    }
  }

  // merge the 4 lanes of a row and write the block's (m, l, tl) for its split
  __device__ __forceinline__ void finish(const FwdParams& p, int m0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[hh], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[hh], off);
        const float to = __shfl_xor_sync(0xffffffffu, tl[hh], off);
        const float mn = fmaxf(m[hh], mo);
        l[hh] = l[hh] * expf(m[hh] - mn) + lo * expf(mo - mn);
        m[hh] = mn;
        tl[hh] = fmaxf(tl[hh], to);
      }
      const int row = m0 + f.row0 + 8 * hh;
      if ((threadIdx.x & 3) == 0 && row < p.T) {
        const long long T = p.T, s = blockIdx.y, S = p.splits;
        p.part[(0 * S + s) * T + row] = m[hh];
        p.part[(1 * S + s) * T + row] = l[hh];
        p.part[(2 * S + s) * T + row] = tl[hh];
      }
    }
  }
};

// h through mh (K-major), W through mw: MN-major untied, K-major tied
template <bool kTied>
__global__ void __launch_bounds__(ce::kThreads, 1)
    ce_fwd_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mw,
                  const FwdParams p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int m0 = blockIdx.x * kBM, v_lo = blockIdx.y * p.tiles_per_split;
  const RunSeq seq{max(0, min(p.n_live, v_lo + p.tiles_per_split) - v_lo), m0, v_lo, p.D};
  OnlineLse epi(p, m0);
  ce::gemm_tiles<true, kTied, kFwdFlush>(smem, &mh, &mw, seq, epi);
  if (threadIdx.x < ce::kConsumers * 128) epi.finish(p, m0);
}

// each row's splits merged in split order
__global__ void __launch_bounds__(256) ce_fwd_merge_kernel(const float* part, int splits, int T,
                                                           float* loss, float* lse) {
  const int row = blockIdx.x * 256 + threadIdx.x;
  if (row >= T) return;
  const float* pm = part;
  const float* pl = part + (long long)splits * T;
  const float* pt = part + 2LL * splits * T;
  float mx = kNegInf, tl = kNegInf;
  for (int s = 0; s < splits; ++s) {
    mx = fmaxf(mx, pm[(long long)s * T + row]);
    tl = fmaxf(tl, pt[(long long)s * T + row]);
  }
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l += pl[(long long)s * T + row] * expf(pm[(long long)s * T + row] - mx);
  const float v = mx + logf(fmaxf(l, 1e-30f));
  lse[row] = v;
  loss[row] = v - tl;
}

// ---- backward
struct BwdParams {
  const int* tgt;
  const float* lse;
  const float* gl;  // the loss cotangent
  const float* gs;  // the lse cotangent
  int T, D, vocab;
};

// (i) the chunk's dlogits, bf16, into dl (T, ldl) at column n0 - c0
struct Dlogits {
  BwdParams p;
  uint16_t* dl;
  int ldl, c0;
  ce::Frag f;

  __device__ __forceinline__ void operator()(const int4& t, float (&acc)[kAcc]) {
    const int cc = t.y + f.col0, lim = p.vocab - cc;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = t.x + f.row0 + 8 * hh;
      if (row >= p.T) continue;
      const float lse = p.lse[row], gl = p.gl[row], g = p.gl[row] + p.gs[row];
      const int tc = p.tgt[row] - cc;
      uint16_t* out = dl + (long long)row * ldl + (cc - c0);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + e;
          const float pr = expf(fminf(acc[4 * i + 2 * hh + e] - lse, 0.f));
          v[e] = c < lim ? g * pr - (c == tc ? gl : 0.f) : 0.f;
        }
        *reinterpret_cast<uint32_t*>(out + 8 * i) = M::pack(v[0], v[1]);
      }
    }
  }
};

template <bool kTied>
__global__ void __launch_bounds__(ce::kThreads, 1)
    ce_bwd_dlogits_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mw,
                          const BwdParams p, uint16_t* dl, int ldl, int c0, int tiles_n) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const ce::GridSeq seq(int(cdiv(p.T, kBM)), tiles_n, 1, p.D, p.D, c0);
  Dlogits epi{p, dl, ldl, c0};
  ce::gemm_tiles<true, kTied, 0>(smem, &mh, &mw, seq, epi);
}

// (ii) dH (+)= dlogits W[:, chunk]^T
struct DhParams {
  float* sum;       // (T, D) fp32: the earlier chunks' sum
  uint16_t* dh;     // (T, D)
  int T, D, ncols, first, last;
};

struct DhOut {
  DhParams q;
  ce::Frag f;

  __device__ __forceinline__ void operator()(const int4& t, float (&acc)[kAcc]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = t.x + f.row0 + 8 * hh;
      if (row >= q.T) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = t.y + f.col0 + 8 * i;
        if (col >= q.D) continue;
        const long long o = (long long)row * q.D + col;
        float x0 = acc[4 * i + 2 * hh], x1 = acc[4 * i + 2 * hh + 1];
        if (!q.first) {
          const float2 pv = *reinterpret_cast<const float2*>(q.sum + o);
          x0 = pv.x + x0;
          x1 = pv.y + x1;
        }
        if (q.last)
          *reinterpret_cast<uint32_t*>(q.dh + o) = M::pack(x0, x1);
        else
          *reinterpret_cast<float2*>(q.sum + o) = make_float2(x0, x1);
      }
    }
  }
};

// dlogits through mdl (K-major); W[:, chunk]^T through mwt: K-major
// untied, MN-major tied
template <bool kTied>
__global__ void __launch_bounds__(ce::kThreads, 1)
    ce_bwd_dh_kernel(const __grid_constant__ CUtensorMap mdl, const __grid_constant__ CUtensorMap mwt,
                     const DhParams q) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const ce::GridSeq seq(int(cdiv(q.T, kBM)), int(cdiv(q.D, kBM)), 1, q.ncols, q.ncols, 0);
  DhOut epi{q};
  ce::gemm_tiles<true, !kTied, 0>(smem, &mdl, &mwt, seq, epi);
}

// (iii) a chunk of dW (untied: h^T dlogits) or dW^T (tied: dlogits^T h);
// with shares > 1, each share of the tokens into its fp32 partial sum
struct DwParams {
  uint16_t* out;      // the chunk's corner of dW (or dW^T), row stride ldo
  long long ldo;
  float* partial;     // (shares, m_lim, n_lim) fp32 when shares > 1
  int m_lim, n_lim;   // the live extent (n_lim even)
  int tiles_m, tiles_n, k_total, k_per_share, shares;
};

struct DwOut {
  DwParams q;
  ce::Frag f;

  __device__ __forceinline__ void operator()(const int4& t, float (&acc)[kAcc]) {
    const long long z = t.z / q.k_per_share;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = t.x + f.row0 + 8 * hh;
      if (row >= q.m_lim) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = t.y + f.col0 + 8 * i;
        if (col >= q.n_lim) continue;
        const float x0 = acc[4 * i + 2 * hh], x1 = acc[4 * i + 2 * hh + 1];
        if (q.shares == 1)
          *reinterpret_cast<uint32_t*>(q.out + row * q.ldo + col) = M::pack(x0, x1);
        else
          *reinterpret_cast<float2*>(q.partial + (z * q.m_lim + row) * q.n_lim + col) =
              make_float2(x0, x1);
      }
    }
  }
};

// both operands MN-major, the contraction over the tokens
__global__ void __launch_bounds__(ce::kThreads, 1)
    ce_bwd_dw_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                     const DwParams q) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const ce::GridSeq seq(q.tiles_m, q.tiles_n, q.shares, q.k_per_share, q.k_total, 0);
  DwOut epi{q};
  ce::gemm_tiles<false, false, 0>(smem, &ma, &mb, seq, epi);
}

// the shares of a dW chunk added in share order, rounded to bf16
__global__ void __launch_bounds__(256) ce_bwd_dw_sum_kernel(const float* partial, int shares,
                                                            int m_lim, int n_lim, uint16_t* out,
                                                            long long ldo) {
  const long long n = (long long)m_lim * n_lim;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < shares; ++z) s += partial[z * n + i];
  out[(i / n_lim) * ldo + i % n_lim] = __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

// dW's padded columns (dW^T's padded rows): rows x cols zeros at out
__global__ void __launch_bounds__(256) ce_bwd_zero_kernel(uint16_t* out, long long ldo, int rows,
                                                          int cols) {
  const long long n = (long long)rows * cols;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
    out[(i / cols) * ldo + i % cols] = 0;
}

Operand op(const void* p, long long ld, int mn, int k_ext) {
  return Operand{static_cast<const uint16_t*>(p), ld, mn, k_ext};
}

// the persistent grid of a GridSeq: at most one block an SM
unsigned persistent(long long tiles) {
  return unsigned(tiles < ce::num_sms() ? tiles : ce::num_sms());
}

template <bool kTied>
int launch_fwd(const Operand& h, const Operand& w, const FwdParams& p, float* loss, float* lse,
               cudaStream_t st) {
  CUtensorMap mh, mw;
  if (!ce::make_map(&mh, h, true) || !ce::make_map(&mw, w, kTied)) return cudaErrorInvalidValue;
  cudaError_t e = ce::allow_smem(ce_fwd_kernel<kTied>);
  if (e != cudaSuccess) return e;
  ce_fwd_kernel<kTied><<<dim3(cdiv(p.T, kBM), p.splits), ce::kThreads, ce::kSmemBytes, st>>>(mh, mw, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ce_fwd_merge_kernel<<<cdiv(p.T, 256), 256, 0, st>>>(p.part, p.splits, p.T, loss, lse);
  return cudaGetLastError();
}

template <bool kTied>
int launch_bwd(const Operand& h, const Operand& w, const BwdParams& p, int Vp, void* dh, void* dw,
               uint16_t* dl, float* dh_sum, float* partial, int chunk_tiles, int k_per_share,
               cudaStream_t st) {
  cudaError_t e;
  if ((e = ce::allow_smem(ce_bwd_dlogits_kernel<kTied>)) != cudaSuccess) return e;
  if ((e = ce::allow_smem(ce_bwd_dh_kernel<kTied>)) != cudaSuccess) return e;
  if ((e = ce::allow_smem(ce_bwd_dw_kernel)) != cudaSuccess) return e;
  CUtensorMap mh, mw;
  if (!ce::make_map(&mh, h, true) || !ce::make_map(&mw, w, kTied)) return cudaErrorInvalidValue;
  const int T = p.T, D = p.D, vocab = p.vocab, ldl = chunk_tiles * kBM;
  const int n_live = (vocab + kBM - 1) / kBM;
  const int shares = (T + k_per_share - 1) / k_per_share;
  const uint16_t* w16 = w.p;
  uint16_t* dw16 = static_cast<uint16_t*>(dw);
  for (int t0 = 0; t0 < n_live; t0 += chunk_tiles) {
    const int nt = min(chunk_tiles, n_live - t0), c0 = t0 * kBM, ncols = nt * kBM;
    // (i)
    ce_bwd_dlogits_kernel<kTied><<<persistent((long long)cdiv(T, kBM) * nt), ce::kThreads,
                                   ce::kSmemBytes, st>>>(mh, mw, p, dl, ldl, c0, nt);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    // (ii) W[:, chunk]^T: (d, v) is W[d, c0 + v] (untied) or E[c0 + v, d] (tied)
    CUtensorMap mdl, mwt;
    const Operand wt = kTied ? op(w16 + (long long)c0 * w.ld, w.ld, D, Vp - c0)
                             : op(w16 + c0, w.ld, D, Vp - c0);
    if (!ce::make_map(&mdl, op(dl, ldl, T, ncols), true) || !ce::make_map(&mwt, wt, !kTied))
      return cudaErrorInvalidValue;
    DhParams q;
    q.sum = dh_sum;
    q.dh = static_cast<uint16_t*>(dh);
    q.T = T;
    q.D = D;
    q.ncols = ncols;
    q.first = t0 == 0;
    q.last = t0 + nt >= n_live;
    ce_bwd_dh_kernel<kTied><<<persistent((long long)cdiv(T, kBM) * cdiv(D, kBM)), ce::kThreads,
                              ce::kSmemBytes, st>>>(mdl, mwt, q);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    // (iii) both operands MN-major: h^T is (d, t), dlogits^T (v, t)
    const Operand hT = op(h.p, h.ld, D, T), dlT = op(dl, ldl, ncols, T);
    CUtensorMap ma, mb;
    if (!ce::make_map(&ma, kTied ? dlT : hT, false) || !ce::make_map(&mb, kTied ? hT : dlT, false))
      return cudaErrorInvalidValue;
    DwParams r;
    const int live = min(ncols, vocab - c0);
    if (kTied) {  // dW^T[chunk] = dlogits^T h
      r.out = dw16 + (long long)c0 * D;
      r.ldo = D;
      r.m_lim = live;
      r.n_lim = D;
      r.tiles_m = nt;
      r.tiles_n = int(cdiv(D, kBM));
    } else {      // dW[:, chunk] = h^T dlogits; n_lim even, within Vpad
      r.out = dw16 + c0;
      r.ldo = Vp;
      r.m_lim = D;
      r.n_lim = min(ncols, (live + 1) & ~1);
      r.tiles_m = int(cdiv(D, kBM));
      r.tiles_n = nt;
    }
    r.partial = partial;
    r.k_total = T;
    r.k_per_share = k_per_share;
    r.shares = shares;
    ce_bwd_dw_kernel<<<persistent((long long)r.tiles_m * r.tiles_n * shares), ce::kThreads,
                       ce::kSmemBytes, st>>>(ma, mb, r);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (shares > 1) {
      ce_bwd_dw_sum_kernel<<<cdiv((long long)r.m_lim * r.n_lim, 256), 256, 0, st>>>(
          partial, shares, r.m_lim, r.n_lim, r.out, r.ldo);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  if (vocab < Vp) {  // the padded columns, after every chunk's writes
    const int pad = Vp - vocab;
    const long long n = (long long)pad * D;
    const unsigned blocks = n < 4096LL * 256 ? cdiv(n, 256) : 4096u;
    if (kTied)
      ce_bwd_zero_kernel<<<blocks, 256, 0, st>>>(dw16 + (long long)vocab * D, D, pad, D);
    else
      ce_bwd_zero_kernel<<<blocks, 256, 0, st>>>(dw16 + vocab, Vp, D, pad);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// h (T, D) bf16 with contiguous rows of stride h_st; w bf16: the untied
// (D, Vp) layout, w[d * w_ld + v], or (tied) the (Vp, D) table behind the
// view, w[v * w_ld + d]. Strides are multiples of 8 elements and pointers
// 16-byte aligned; D and (untied) Vp are multiples of 8. part is fp32
// scratch of 3 * splits * T, the splits tiles_per_split live vocab tiles
// each. Returns the cudaError_t of the launches (0 = launched; a tensor map
// the driver refuses gives cudaErrorInvalidValue).
extern "C" int cross_entropy_fwd(const void* h, const void* w, const int* tgt, float* loss,
                                 float* lse, float* part, int T, int D, int Vp, int vocab,
                                 long long h_st, long long w_ld, int tied, int tiles_per_split,
                                 int splits, void* stream) {
  if (T <= 0 || D <= 0 || vocab <= 0 || vocab > Vp || tiles_per_split <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  const Operand oh = op(h, h_st, T, D), ow = op(w, w_ld, Vp, D);  // (v, d)
  FwdParams p;
  p.tgt = tgt;
  p.part = part;
  p.T = T;
  p.D = D;
  p.vocab = vocab;
  p.n_live = (vocab + kBM - 1) / kBM;
  p.tiles_per_split = tiles_per_split;
  p.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tied ? launch_fwd<true>(oh, ow, p, loss, lse, st) : launch_fwd<false>(oh, ow, p, loss, lse, st);
}

// dh (T, D) contiguous bf16; dw the gradient in w's layout, contiguous:
// (D, Vp) untied, (Vp, D) tied. Scratch: dl bf16 (T, chunk_tiles * 128);
// dh_sum fp32 (T, D) when the live vocab takes more than one chunk;
// partial fp32 of shares * chunk_tiles * 128 * D elements when the token
// shares of k_per_share tokens (a multiple of 64) are more than one.
extern "C" int cross_entropy_bwd(const void* h, const void* w, const int* tgt, const float* lse,
                                 const float* g_loss, const float* g_lse, void* dh, void* dw,
                                 void* dl, float* dh_sum, float* partial, int T, int D, int Vp,
                                 int vocab, long long h_st, long long w_ld, int tied,
                                 int chunk_tiles, int k_per_share, void* stream) {
  if (T <= 0 || D <= 0 || vocab <= 0 || vocab > Vp || chunk_tiles <= 0 || k_per_share <= 0)
    return cudaErrorInvalidValue;
  const Operand oh = op(h, h_st, T, D), ow = op(w, w_ld, Vp, D);
  BwdParams p;
  p.tgt = tgt;
  p.lse = lse;
  p.gl = g_loss;
  p.gs = g_lse;
  p.T = T;
  p.D = D;
  p.vocab = vocab;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint16_t* dl16 = static_cast<uint16_t*>(dl);
  return tied ? launch_bwd<true>(oh, ow, p, Vp, dh, dw, dl16, dh_sum, partial, chunk_tiles,
                                 k_per_share, st)
              : launch_bwd<false>(oh, ow, p, Vp, dh, dw, dl16, dh_sum, partial, chunk_tiles,
                                  k_per_share, st);
}
