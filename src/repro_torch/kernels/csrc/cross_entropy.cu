// Fused vocab-softmax cross-entropy for Hopper (sm_90a): forward, dH, dW.
//
// Replaces the TPU kernels in src/repro/kernels/cross_entropy.py:
// `_ce_kernel` behind `fused_cross_entropy` (forward) and `_ce_dh_kernel` /
// `_ce_dw_kernel` behind `fused_cross_entropy_bwd`. Same contract: hidden h
// (T, D) and the output weight W (D, Vpad) in bf16, int32 targets (T,) and
// the true vocab (columns >= vocab are masked):
//   forward   logits = h W (fp32), lse = logsumexp over the vocab,
//             loss = lse - logit[target]           -> loss, lse (T,) fp32
//   backward  dlogits = (g_loss + g_lse) p - g_loss onehot(target),
//             p = exp(min(logit - lse, 0)) on valid columns, 0 on padding
//             dH = dlogits W^T (T, D), dW = h^T dlogits (D, Vpad)
// The (T, Vpad) logits never reach device memory in either direction.
//
// Layout. The kernels take W^T, a row-major (Vpad, D) matrix, so that a
// vocab row's D values are contiguous and every operand tile is read with
// 16-byte loads. For the tied head W = embed.T, W^T is the embedding table
// itself and the wrapper passes it without a copy. dW is written as dW^T
// (Vpad, D).
//
// Design. The TPU kernels carry the online LSE (forward) and the dH / dW
// accumulators across a sequential grid axis in VMEM; Hopper blocks run in
// no order, so each block loops over the tiles itself:
//   forward  a block of 4 warps owns 64 token rows and loops over 64-column
//            vocab tiles, the contraction over D in 64-wide chunks staged
//            through shared memory; running max, sum and target logit stay
//            in registers (the online LSE of the TPU kernel).
//   dH       a block owns (64 tokens, 128 columns of D) and loops over vocab
//            tiles: it recomputes the tile's logits over all of D, forms
//            dlogits in registers and multiplies them into its dH columns.
//   dW       a block owns (64 vocab rows, 128 columns of D, one share of the
//            token tiles): per token tile it recomputes logits^T, forms
//            dlogits^T and adds h^T dlogits into its dW^T tile, an fp32
//            partial sum per share; a last pass adds the shares in a fixed
//            order. No atomics: every run gives the same bits.
// Products are mma.sync m16n8k16 with fp32 accumulation; bf16 x bf16
// products are exact in fp32, so logits match the TPU kernel's fp32 dot of
// upcast values up to summation order. dlogits is rounded to bf16 before
// the dH and dW products (the TPU kernel keeps it fp32): at most 2^-9
// relative per element, which is the stated tolerance. Padded vocab
// columns give dlogits of exactly 0, so their dW
// columns are exactly 0. Each backward block recomputes the logits of its
// tiles: D / 128 times over for dH and dW each (10 times at D = 1280), the
// price of keeping dlogits out of device memory without a cross-block sum.
// The loops also run over the padded vocab tiles, which only add zeros.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), counting only
// the work the function needs, on the `vocab` live columns of W: the
// forward is 2*T*D*vocab FLOP against h and W's live columns read once, the
// targets read and loss and lse written; the backward 6*T*D*vocab FLOP
// against the same reads plus lse and the two cotangents, dh written and
// dW written whole (D, Vpad). At the ESM-2 training shape T = 8192,
// D = 1280, Vpad = 256, vocab = 33 that is 0.69 GFLOP (0.7 us) against
// 21.2 MB (6.3 us) forward, and 2.1 GFLOP (2.1 us) against 42.8 MB
// (12.8 us) backward: bytes bound both.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;    // rows a block owns: 4 warps x 16
constexpr int kBlockN = 64;    // vocab columns (forward, dH) or tokens (dW) per tile
constexpr int kChunk = 64;     // D per contraction chunk
constexpr int kOut = 128;      // D columns of the dH / dW output a block owns
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Params {
  const uint16_t* h;     // (T, D), row stride h_st
  const uint16_t* wt;    // (Vp, D), row stride w_st
  const int* tgt;        // (T,)
  const float* lse;      // (T,), backward
  const float* gl;       // (T,), backward
  const float* gs;       // (T,), backward: the lse cotangent
  float* loss;           // (T,), forward
  float* lse_out;        // (T,), forward
  uint16_t* dh;          // (T, D) contiguous
  float* partial;        // (splits, Vp, D) fp32, dW
  int T, D, Vp, vocab;
  long long h_st, w_st;
  int tiles_per_split;   // dW: token tiles per share
};

using M = Mma<__nv_bfloat16>;

// rows [row0, row0 + 64), columns [col0, col0 + COLS) of a row-major matrix
// into shared memory (row length COLS + kPad); rows >= nrows and columns
// >= ncols are zero-filled (ncols is a multiple of 8)
template <int COLS>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* base, long long row_stride,
                                          int row0, int nrows, int col0, int ncols) {
  constexpr int kVec = 8;  // 8 x 16 bit = one 16-byte load
  constexpr int kPerRow = COLS / kVec;
  for (int c = threadIdx.x; c < 64 * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && col0 + col < ncols)
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + col0 + col);
    *reinterpret_cast<uint4*>(dst + r * (COLS + kPad) + col) = val;
  }
}

// acc[n] (warp rows x 64 columns) += rows [arow0 + wrow, +16) of A . rows
// [brow0, +64) of B^T, both row-major with D along the row: the contraction
// over all of D in kChunk-wide steps through sA / sB
__device__ __forceinline__ void dot_tiles(float (&acc)[kBlockN / 8][4], uint16_t* sA,
                                          const uint16_t* a, long long a_st, int arow0, int anrows,
                                          uint16_t* sB, const uint16_t* b, long long b_st,
                                          int brow0, int bnrows, int D, int wrow, int g, int t) {
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    __syncthreads();  // every warp is done with the previous chunk
    load_tile<kChunk>(sA, a, a_st, arow0, anrows, d0, D);
    load_tile<kChunk>(sB, b, b_st, brow0, bnrows, d0, D);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t fa[4];
      a_frag<kChunk>(fa, sA, wrow, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        uint32_t b0, b1;
        b_frag_rows<kChunk>(b0, b1, sB, n * 8, kk * 16, g, t);
        M::run(acc[n], fa, b0, b1);
      }
    }
  }
}

__device__ __forceinline__ float dlogit(float logit, bool valid, bool hit, float lse, float gl,
                                        float gs) {
  const float pr = valid ? expf(fminf(logit - lse, 0.f)) : 0.f;
  return (gl + gs) * pr - (valid && hit ? gl : 0.f);
}

// ---- forward: a block owns 64 token rows, online LSE over vocab tiles
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sH[kBlockM * (kChunk + kPad)];
  __shared__ __align__(16) uint16_t sW[kBlockN * (kChunk + kPad)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockM, wrow = warp * 16;

  int tgt[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tl[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wrow + g + 8 * r;
    tgt[r] = row < p.T ? p.tgt[row] : -1;
  }

  for (int v0 = 0; v0 < p.Vp; v0 += kBlockN) {
    float acc[kBlockN / 8][4];
    dot_tiles(acc, sH, p.h, p.h_st, row0, p.T, sW, p.wt, p.w_st, v0, p.Vp, p.D, wrow, g, t);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, col = v0 + n * 8 + 2 * t + (i & 1);
        const float x = col < p.vocab ? acc[n][i] : kNegInf;
        acc[n][i] = x;
        mx[r] = fmaxf(mx[r], x);
        if (col == tgt[r]) tl[r] = fmaxf(tl[r], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      l[r] *= expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i >> 1] += expf(acc[n][i] - m[i >> 1]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    tl[r] = fmaxf(tl[r], __shfl_xor_sync(0xffffffffu, tl[r], 1));
    tl[r] = fmaxf(tl[r], __shfl_xor_sync(0xffffffffu, tl[r], 2));
    const int row = row0 + wrow + g + 8 * r;
    if (t == 0 && row < p.T) {
      const float lse = m[r] + logf(fmaxf(l[r], 1e-30f));
      p.lse_out[row] = lse;
      p.loss[row] = lse - tl[r];
    }
  }
}

// ---- dH: a block owns (64 tokens, kOut columns of D), loops over vocab tiles
__global__ void __launch_bounds__(kThreads) ce_dh_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sH[kBlockM * (kChunk + kPad)];
  __shared__ __align__(16) uint16_t sW[kBlockN * (kChunk + kPad)];
  __shared__ __align__(16) uint16_t sWd[kBlockN * (kOut + kPad)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockM, wrow = warp * 16;
  const int c0 = blockIdx.y * kOut;

  int tgt[2];
  float lse[2], gl[2], gs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wrow + g + 8 * r;
    const bool in = row < p.T;
    tgt[r] = in ? p.tgt[row] : -1;
    lse[r] = in ? p.lse[row] : 0.f;
    gl[r] = in ? p.gl[row] : 0.f;
    gs[r] = in ? p.gs[row] : 0.f;
  }
  float out[kOut / 8][4];
#pragma unroll
  for (int j = 0; j < kOut / 8; ++j) out[j][0] = out[j][1] = out[j][2] = out[j][3] = 0.f;

  for (int v0 = 0; v0 < p.Vp; v0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous W^T tile
    load_tile<kOut>(sWd, p.wt, p.w_st, v0, p.Vp, c0, p.D);
    float acc[kBlockN / 8][4];
    dot_tiles(acc, sH, p.h, p.h_st, row0, p.T, sW, p.wt, p.w_st, v0, p.Vp, p.D, wrow, g, t);
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, col = v0 + n * 8 + 2 * t + (i & 1);
        acc[n][i] = dlogit(acc[n][i], col < p.vocab, col == tgt[r], lse[r], gl[r], gs[r]);
      }
    // dH += dlogits W^T-tile: two adjacent 8-column accumulators make the A
    // fragment of one 16-deep step over the vocab
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = M::pack(acc[2 * kk][0], acc[2 * kk][1]);
      a[1] = M::pack(acc[2 * kk][2], acc[2 * kk][3]);
      a[2] = M::pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
      a[3] = M::pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j) {
        uint32_t b0, b1;
        b_frag_cols<kOut>(b0, b1, sWd, kk * 16, j * 8, g, t);
        M::run(out[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wrow + g + 8 * r;
    if (row >= p.T) continue;
#pragma unroll
    for (int j = 0; j < kOut / 8; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<uint32_t*>(p.dh + (long long)row * p.D + col) =
            M::pack(out[j][2 * r], out[j][2 * r + 1]);
    }
  }
}

// ---- dW^T: a block owns (64 vocab rows, kOut columns of D, one share of
// the token tiles) and writes its fp32 partial sum
__global__ void __launch_bounds__(kThreads) ce_dw_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sW[kBlockM * (kChunk + kPad)];
  __shared__ __align__(16) uint16_t sH[kBlockN * (kChunk + kPad)];
  __shared__ __align__(16) uint16_t sHd[kBlockN * (kOut + kPad)];
  __shared__ float sLse[kBlockN], sGl[kBlockN], sGs[kBlockN];
  __shared__ int sTgt[kBlockN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * kBlockM, wrow = warp * 16;
  const int c0 = blockIdx.y * kOut;
  const int vrow[2] = {v0 + wrow + g, v0 + wrow + g + 8};

  float out[kOut / 8][4];
#pragma unroll
  for (int j = 0; j < kOut / 8; ++j) out[j][0] = out[j][1] = out[j][2] = out[j][3] = 0.f;

  const int tile0 = blockIdx.z * p.tiles_per_split;
  const int t_end = min(p.T, (tile0 + p.tiles_per_split) * kBlockN);
  for (int t0 = tile0 * kBlockN; t0 < t_end; t0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous token tile
    load_tile<kOut>(sHd, p.h, p.h_st, t0, p.T, c0, p.D);
    for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
      const bool in = t0 + i < p.T;
      sLse[i] = in ? p.lse[t0 + i] : 0.f;
      sGl[i] = in ? p.gl[t0 + i] : 0.f;
      sGs[i] = in ? p.gs[t0 + i] : 0.f;
      sTgt[i] = in ? p.tgt[t0 + i] : -1;
    }
    // logits^T (warp's 16 vocab rows x 64 tokens)
    float acc[kBlockN / 8][4];
    dot_tiles(acc, sW, p.wt, p.w_st, v0, p.Vp, sH, p.h, p.h_st, t0, p.T, p.D, wrow, g, t);
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n * 8 + 2 * t + (i & 1);  // token within the tile
        const int v = vrow[i >> 1];
        acc[n][i] = dlogit(acc[n][i], v < p.vocab, v == sTgt[c], sLse[c], sGl[c], sGs[c]);
      }
    // dW^T += dlogits^T h-tile over the tile's tokens
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = M::pack(acc[2 * kk][0], acc[2 * kk][1]);
      a[1] = M::pack(acc[2 * kk][2], acc[2 * kk][3]);
      a[2] = M::pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
      a[3] = M::pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j) {
        uint32_t b0, b1;
        b_frag_cols<kOut>(b0, b1, sHd, kk * 16, j * 8, g, t);
        M::run(out[j], a, b0, b1);
      }
    }
  }

  float* part = p.partial + (long long)blockIdx.z * p.Vp * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (vrow[r] >= p.Vp) continue;
#pragma unroll
    for (int j = 0; j < kOut / 8; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < p.D)
        *reinterpret_cast<float2*>(part + (long long)vrow[r] * p.D + col) =
            make_float2(out[j][2 * r], out[j][2 * r + 1]);
    }
  }
}

// ---- the shares of dW^T added in a fixed order, rounded to bf16
__global__ void __launch_bounds__(256) ce_dw_sum_kernel(const float* partial, uint16_t* dwt,
                                                        long long n, int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(long long)z * n + i];
  dwt[i] = __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

Params make_params(const void* h, const void* wt, const int* tgt, int T, int D, int Vp, int vocab,
                   long long h_st, long long w_st) {
  Params p = {};
  p.h = static_cast<const uint16_t*>(h);
  p.wt = static_cast<const uint16_t*>(wt);
  p.tgt = tgt;
  p.T = T;
  p.D = D;
  p.Vp = Vp;
  p.vocab = vocab;
  p.h_st = h_st;
  p.w_st = w_st;
  return p;
}

}  // namespace

// h (T, D) and W^T (Vp, D) are bf16 with contiguous rows of the given
// strides (elements); D is a multiple of 8. Each returns the cudaError_t of
// its launches (0 = launched).
extern "C" int cross_entropy_fwd(const void* h, const void* wt, const int* tgt, float* loss,
                                 float* lse, int T, int D, int Vp, int vocab,
                                 long long h_st, long long w_st, void* stream) {
  Params p = make_params(h, wt, tgt, T, D, Vp, vocab, h_st, w_st);
  p.loss = loss;
  p.lse_out = lse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kBlockM - 1) / kBlockM);
  ce_fwd_kernel<<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// dh (T, D) and dwt (Vp, D) are contiguous bf16; partial is fp32 scratch
// of splits * Vp * D elements.
extern "C" int cross_entropy_bwd(const void* h, const void* wt, const int* tgt, const float* lse,
                                 const float* g_loss, const float* g_lse, void* dh, void* dwt,
                                 float* partial, int splits, int T, int D, int Vp,
                                 int vocab, long long h_st, long long w_st, void* stream) {
  Params p = make_params(h, wt, tgt, T, D, Vp, vocab, h_st, w_st);
  p.lse = lse;
  p.gl = g_loss;
  p.gs = g_lse;
  p.dh = static_cast<uint16_t*>(dh);
  p.partial = partial;
  const int t_tiles = (T + kBlockN - 1) / kBlockN;
  p.tiles_per_split = (t_tiles + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 dh_grid((T + kBlockM - 1) / kBlockM, (D + kOut - 1) / kOut);
  const dim3 dw_grid((Vp + kBlockM - 1) / kBlockM, (D + kOut - 1) / kOut, splits);
  const long long n = (long long)Vp * D;
  const unsigned sum_blocks = unsigned((n + 255) / 256);
  ce_dh_kernel<<<dh_grid, kThreads, 0, st>>>(p);
  ce_dw_kernel<<<dw_grid, kThreads, 0, st>>>(p);
  ce_dw_sum_kernel<<<sum_blocks, 256, 0, st>>>(partial, static_cast<uint16_t*>(dwt), n, splits);
  return cudaGetLastError();
}
