// Mamba-2 SSD chunked scan for Hopper (sm_90a), backward: the gradient of
// every SSM layer in training.
//
// The port's own kernel: the reference's TPU kernel (`_ssd_kernel` in
// src/repro/kernels/ssd_scan.py) is forward-only, and the reference trains
// through XLA's autodiff of its jnp scan `_ssd_chunked_xla`
// (src/repro/kernels/ops.py). Contract: the forward's inputs (x (B, S, H,
// P) bf16, dt (B, S, H) fp32, A and D (H,) fp32, B and C (B, S, G, N) bf16,
// x, B and C possibly strided views with the last dim contiguous), the
// state entering each chunk of 64 rows (B, nc, H, P, N) fp32 from
// ssd_scan_states, dy (B, S, H, P) bf16 and the final state's gradient
// dstate (B, H, P, N) fp32 or null -> dx (B, S, H, P) bf16, ddt (B, S, H)
// fp32, dB and dC (B, S, G, N) bf16, dA and dD (H,) fp32. ref.py's
// ssd_scan_bwd_ref is the same decomposition in torch.
//
// Per chunk of L = 64 rows, head and batch row, rows t >= s, with cum the
// prefix sum of dt A, seg = cum[L-1], G = C B^T, E_ts = exp(cum_t - cum_s),
// M = G o E o dt_s, w_s = dt_s exp(seg - cum_s), dM = dy x^T, and the
// chunk's h_in and dh_out (the gradient of the state leaving it):
//   dx_s  = sum_t M_ts dy_t + w_s (dh_out B_s) + D dy_s
//   dB_s  = sum_t dM_ts E_ts dt_s C_t + w_s V_s,       V_s = dh_out^T x_s
//   dC_t  = sum_s dM_ts E_ts dt_s B_s + exp(cum_t) Z_t, Z_t = h_in^T dy_t
//   ddt_s = sum_t dM_ts G_ts E_ts + dw_s exp(seg - cum_s) + A rc_s
//   dA   += sum_r dt_r rc_r,   dD += sum dy . x
// with dw_s = B_s . V_s, rc_r = sum_{t >= r} dcum_t and, with R = dM o G o
// E, dcum_t = sum_s R_ts dt_s - dt_t sum_t' R_t't + exp(cum_t) C_t . Z_t
// - dw_t w_t, the last row adding sum_s dw_s w_s + exp(seg) <dh_out, h_in>.
// dh_out is dstate for the last chunk, and dh_in = exp(seg) dh_out +
// sum_t exp(cum_t) dy_t C_t^T carries it back. The causal decay is
// selected, never multiplied by a mask: every exponent taken is <= 0.
// Rows past S count as x = 0, dt = 0, dy = 0, as in the forward.
//
// Design: the per-chunk parallel form, three passes. (1) ssd_bwd_state_kernel:
// one block a (batch, head, 32 rows of P) walks the chunks in reverse with
// its slice of dh in registers and stores each chunk's dh_out (B, nc, H, P,
// N) fp32. (2) ssd_bwd_chunk_kernel: one block a (chunk, head, batch row)
// -- given h_in and dh_out the chunks are independent -- forms G and dM,
// the L x L terms and their row and column sums, dB, dC and ddt over the
// whole chunk and dx a 32-column slice of P at a time, and writes dB and dC
// per head and dA and dD per chunk as fp32 partials. (3)
// ssd_bwd_group_sum_kernel and ssd_bwd_head_sum_kernel sum the partials
// over a group's heads and over (batch, chunk) in a fixed order. The
// forward's form (one block walking all chunks of a head) would give
// Mamba2's batch-1 shape 80 blocks; the chunk grid gives 1 280 (16
// chunks), so every SM holds work. No sum goes through atomics: the
// backward is deterministic, run to run.
//
// Arithmetic: fp32 FMA on the CUDA cores from fp32 shared-memory tiles
// (x, dy, B and C widened from bf16, exactly), register tiles of 4 x 4 to
// 8 x 4 outputs a thread. A simple kernel first, not a fast one: it does
// not use the tensor cores.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 989
// bf16, 3.35 TB/s): the bytes that must move -- x, dy, B, C, dt read, the
// chunk states read, dx, ddt, dB, dC written -- over the memory rate,
// against the chunked form's products at the bf16 tensor-core rate;
// chip_smoke.ssd_bwd_bound reckons both from the shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kL = 64;       // rows per chunk (the forward's)
constexpr int kPT = 32;      // rows of P per tile
constexpr int kThreads = 256;
constexpr int kMaxN = 128;
constexpr int kNP = kMaxN + 1;  // pitch of the (.., N) tiles: odd, conflict-free columns
constexpr int kXP = kPT + 1;    // of the (L, 32) tiles
constexpr int kLP = kL + 1;     // of the (L, L) tiles

struct Params {
  const uint16_t* x;    // (B, S, H, P), p contiguous
  const float* dt;      // (B, S, H), h contiguous
  const float* A;       // (H,)
  const uint16_t* Bm;   // (B, S, G, N), n contiguous
  const uint16_t* Cm;   // the same strides as Bm
  const float* D;       // (H,)
  const float* hin;     // (B, nc, H, P, N): the state entering each chunk
  const uint16_t* dy;   // (B, S, H, P) contiguous
  const float* dstate;  // (B, H, P, N) or null
  float* dh;            // (B, nc, H, P, N): the gradient of the state leaving each chunk
  uint16_t* dx;         // (B, S, H, P)
  float* ddt;           // (B, S, H)
  float* dBp;           // (B, S, H, N): dB of each head, before the group sum
  float* dCp;           // (B, S, H, N)
  float* dAp;           // (B, nc, H): dA of each chunk
  float* dDp;           // (B, nc, H)
  uint16_t* dB;         // (B, S, G, N)
  uint16_t* dC;         // (B, S, G, N)
  float* dA;            // (H,)
  float* dD;            // (H,)
  long long xs_b, xs_s, xs_h;  // element strides of x
  long long bs_b, bs_s, bs_g;  // of Bm and Cm
  long long ds_b, ds_s;        // of dt
  int B, S, H, P, G, N, nc;
};

__device__ __forceinline__ float bf(uint16_t v) { return __uint_as_float(uint32_t(v) << 16); }

__device__ __forceinline__ uint16_t to_bf(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// dt of chunk c (zero past S) into sdt and its inclusive prefix sum times a
// into cum, summed in order by one thread (the same order in every kernel)
__device__ __forceinline__ void chunk_cum(const Params& p, int b, int h, int c0, int rows, float a,
                                          float* sdt, float* cum) {
  const float* dtb = p.dt + b * p.ds_b + h;
  for (int i = threadIdx.x; i < kL; i += kThreads)
    sdt[i] = i < rows ? dtb[(long long)(c0 + i) * p.ds_s] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < kL; ++i) {
      acc += sdt[i] * a;
      cum[i] = acc;
    }
  }
  __syncthreads();
}

// rows [c0, c0 + kL) of a (rows, N) bf16 matrix with row stride `stride`
// into an fp32 tile of pitch kNP; rows past `rows` zero
__device__ __forceinline__ void load_bn(float* dst, const uint16_t* src, long long stride, int n,
                                        int rows) {
  for (int i = threadIdx.x; i < kL * n; i += kThreads) {
    const int r = i / n, c = i % n;
    dst[r * kNP + c] = r < rows ? bf(src[r * stride + c]) : 0.f;
  }
}

// pass 1: dh_out of every chunk, walking them in reverse. Block (P / 32
// slices, H, B); thread (wy, lane) holds rows 4 wy + i and columns lane +
// 32 j of the slice's dh.
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(const Params p) {
  __shared__ float sC[kL * kNP];
  __shared__ float sE[kL * kXP];  // exp(cum_t) dy_t over the slice's columns
  __shared__ float sdt[kL], cum[kL];
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (p.H / p.G), N = p.N;
  const int wy = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float a = p.A[h];
  float carry[4][4] = {};
  const long long base = ((long long)b * p.H + h) * p.P + p0;  // row p0 of this head's state
  if (p.dstate) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (lane + 32 * j < N) carry[i][j] = p.dstate[(base + 4 * wy + i) * N + lane + 32 * j];
  }
  for (int c = p.nc - 1; c >= 0; --c) {
    float* dst = p.dh + ((((long long)b * p.nc + c) * p.H + h) * p.P + p0) * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (lane + 32 * j < N) dst[(4 * wy + i) * N + lane + 32 * j] = carry[i][j];
    if (c == 0) break;
    const int c0 = c * kL, rows = min(kL, p.S - c0);
    chunk_cum(p, b, h, c0, rows, a, sdt, cum);
    load_bn(sC, p.Cm + b * p.bs_b + grp * p.bs_g + c0 * p.bs_s, p.bs_s, N, rows);
    const uint16_t* dyb = p.dy + (((long long)b * p.S + c0) * p.H + h) * p.P + p0;
    for (int i = threadIdx.x; i < kL * kPT; i += kThreads) {
      const int r = i / kPT, q = i % kPT;
      sE[r * kXP + q] = r < rows ? expf(cum[r]) * bf(dyb[(long long)r * p.H * p.P + q]) : 0.f;
    }
    __syncthreads();
    const float es = expf(cum[kL - 1]);
    float u[4][4] = {};
    for (int t = 0; t < kL; ++t) {
      float ev[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ev[i] = sE[t * kXP + 4 * wy + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = sC[t * kNP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] += ev[i] * cv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) carry[i][j] = es * carry[i][j] + u[i][j];
    __syncthreads();  // before the next chunk's tiles overwrite these
  }
}

// the fp32 shared memory of the chunk kernel, in floats
struct ChunkSmem {
  static constexpr int kB = 0;                       // B (L, N)
  static constexpr int kC = kB + kL * kNP;           // C (L, N)
  static constexpr int kX = kC + kL * kNP;           // x (L, 32)
  static constexpr int kDY = kX + kL * kXP;          // dy (L, 32)
  static constexpr int kH = kDY + kL * kXP;          // dh_out or h_in (32, N)
  static constexpr int kG = kH + kPT * kNP;          // G, then M (L, L)
  static constexpr int kDM = kG + kL * kLP;          // dM, then dM o E o dt_s (L, L)
  static constexpr int kVec = kDM + kL * kLP;        // the vectors below, kL each
  static constexpr int kDt = kVec, kCum = kVec + kL, kW = kVec + 2 * kL, kEcum = kVec + 3 * kL,
                       kDw = kVec + 4 * kL, kHt = kVec + 5 * kL, kRowQ = kVec + 6 * kL,
                       kColR = kVec + 7 * kL, kRed = kVec + 8 * kL;  // kRed: kThreads floats
  static constexpr int kFloats = kRed + kThreads;
  static constexpr int kBytes = kFloats * 4;
};

// the sum of v over the block in a fixed order (a tree over shared memory);
// every thread gets it
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

// pass 2: one chunk's gradients. Block (nc, H, B).
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  using L = ChunkSmem;
  float *sB = sm + L::kB, *sC = sm + L::kC, *sX = sm + L::kX, *sDY = sm + L::kDY,
        *sH = sm + L::kH, *sG = sm + L::kG, *sDM = sm + L::kDM;
  float *sdt = sm + L::kDt, *cum = sm + L::kCum, *w = sm + L::kW, *ecum = sm + L::kEcum,
        *dw = sm + L::kDw, *ht = sm + L::kHt, *rowQ = sm + L::kRowQ, *colR = sm + L::kColR,
        *red = sm + L::kRed;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int N = p.N, P = p.P, grp = h / (p.H / p.G);
  const int c0 = c * kL, rows = min(kL, p.S - c0);
  const float a = p.A[h], dsc = p.D[h];
  const long long dy_row = (long long)p.H * P;
  const uint16_t* xb = p.x + b * p.xs_b + h * p.xs_h + c0 * p.xs_s;
  const uint16_t* dyb = p.dy + ((long long)b * p.S + c0) * dy_row + (long long)h * P;
  const long long st = (((long long)b * p.nc + c) * p.H + h) * P * N;  // this chunk's states
  const float* hinb = p.hin + st;
  const float* dhb = p.dh + st;

  chunk_cum(p, b, h, c0, rows, a, sdt, cum);
  load_bn(sB, p.Bm + b * p.bs_b + grp * p.bs_g + c0 * p.bs_s, p.bs_s, N, rows);
  load_bn(sC, p.Cm + b * p.bs_b + grp * p.bs_g + c0 * p.bs_s, p.bs_s, N, rows);
  const float seg = cum[kL - 1], eseg = expf(seg);
  for (int i = tid; i < kL; i += kThreads) {
    w[i] = sdt[i] * expf(seg - cum[i]);
    ecum[i] = expf(cum[i]);
  }
  __syncthreads();

  // the (L, L) products: thread (ty, tx) holds rows t = 4 ty + i, columns
  // s = tx + 16 j of G = C B^T and of dM = dy x^T
  const int ty = tid >> 4, tx = tid & 15;
  {
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = sC[(4 * ty + i) * kNP + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * kNP + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sG[(4 * ty + i) * kLP + tx + 16 * j] = acc[i][j];
  }

  // over the slices of P: dM, V = dh_out^T x and Z = h_in^T dy (thread (wy,
  // lane) holds rows 8 wy + i and columns lane + 32 j of V and Z), dD and
  // <dh_out, h_in>
  const int wy = tid >> 5, lane = tid & 31;
  float dm[4][4] = {}, V[8][4] = {}, Z[8][4] = {};
  float dd = 0.f, hh = 0.f;
  for (int q0 = 0; q0 < P; q0 += kPT) {
    __syncthreads();  // the last slice's tiles are done with
    for (int i = tid; i < kL * kPT; i += kThreads) {
      const int r = i / kPT, q = i % kPT;
      const bool live = r < rows;
      sX[r * kXP + q] = live ? bf(xb[r * p.xs_s + q0 + q]) : 0.f;
      sDY[r * kXP + q] = live ? bf(dyb[r * dy_row + q0 + q]) : 0.f;
    }
    for (int i = tid; i < kPT * N; i += kThreads) {
      const int q = i / N, n = i % N;
      const float v = dhb[(long long)(q0 + q) * N + n];
      sH[q * kNP + n] = v;
      hh += v * hinb[(long long)(q0 + q) * N + n];
    }
    __syncthreads();
    for (int q = 0; q < kPT; ++q) {
      float dv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = sDY[(4 * ty + i) * kXP + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = sX[(tx + 16 * j) * kXP + q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dm[i][j] += dv[i] * xv[j];
    }
    for (int i = tid; i < kL * kPT; i += kThreads) {
      const int r = i / kPT, q = i % kPT;
      dd += sX[r * kXP + q] * sDY[r * kXP + q];
    }
    for (int q = 0; q < kPT; ++q) {
      float xv[8], hv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = sX[(8 * wy + i) * kXP + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = lane + 32 * j < N ? sH[q * kNP + lane + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) V[i][j] += xv[i] * hv[j];
    }
    __syncthreads();
    for (int i = tid; i < kPT * N; i += kThreads) {
      const int q = i / N, n = i % N;
      sH[q * kNP + n] = hinb[(long long)(q0 + q) * N + n];
    }
    __syncthreads();
    for (int q = 0; q < kPT; ++q) {
      float dv[8], hv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) dv[i] = sDY[(8 * wy + i) * kXP + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = lane + 32 * j < N ? sH[q * kNP + lane + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Z[i][j] += dv[i] * hv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sDM[(4 * ty + i) * kLP + tx + 16 * j] = dm[i][j];
  // dw_s = B_s . V_s and ht_t = exp(cum_t) C_t . Z_t: a warp holds whole
  // rows, summed over its lanes by a butterfly
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * wy + i;
    float pv = 0.f, pz = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = lane + 32 * j;
      if (n < N) {
        pv += sB[r * kNP + n] * V[i][j];
        pz += sC[r * kNP + n] * Z[i][j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      pv += __shfl_xor_sync(0xffffffffu, pv, o);
      pz += __shfl_xor_sync(0xffffffffu, pz, o);
    }
    if (lane == 0) {
      dw[r] = pv;
      ht[r] = ecum[r] * pz;
    }
  }
  const float hh_all = block_sum(hh, red);   // syncs: sDM, dw and ht are in place
  const float dd_all = block_sum(dd, red);

  // the row sums of R dt_s and the column sums of R, R = dM o G o E
  if (tid < kL) {
    const int t = tid;
    float s_ = 0.f;
    for (int s = 0; s <= t; ++s)
      s_ += sDM[t * kLP + s] * sG[t * kLP + s] * expf(cum[t] - cum[s]) * sdt[s];
    rowQ[t] = s_;
  } else if (tid < 2 * kL) {
    const int s = tid - kL;
    float s_ = 0.f;
    for (int t = s; t < kL; ++t) s_ += sDM[t * kLP + s] * sG[t * kLP + s] * expf(cum[t] - cum[s]);
    colR[s] = s_;
  }
  __syncthreads();
  // G -> M = G o E o dt_s and dM -> dS = dM o E o dt_s, zero above the diagonal
  for (int i = tid; i < kL * kL; i += kThreads) {
    const int t = i / kL, s = i % kL;
    const float e = s <= t ? expf(cum[t] - cum[s]) * sdt[s] : 0.f;
    sG[t * kLP + s] *= e;
    sDM[t * kLP + s] *= e;
  }
  if (tid == 0) {  // dcum, its reverse prefix sum rc, ddt and dA, in order
    float dww = 0.f;
    for (int s = 0; s < kL; ++s) dww += dw[s] * w[s];
    float rc = 0.f, da = 0.f;
    for (int r = kL - 1; r >= 0; --r) {
      float dcum = rowQ[r] - sdt[r] * colR[r] + ht[r] - dw[r] * w[r];
      if (r == kL - 1) dcum += dww + eseg * hh_all;
      rc += dcum;
      da += sdt[r] * rc;
      if (r < rows)
        p.ddt[((long long)b * p.S + c0 + r) * p.H + h] =
            colR[r] + dw[r] * expf(seg - cum[r]) + a * rc;
    }
    p.dAp[((long long)b * p.nc + c) * p.H + h] = da;
    p.dDp[((long long)b * p.nc + c) * p.H + h] = dd_all;
  }
  __syncthreads();

  // dB (rows s) and dC (rows t) of this head: thread (wy, lane) as V and Z
  {
    float db[8][4], dc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        db[i][j] = w[8 * wy + i] * V[i][j];
        dc[i][j] = ecum[8 * wy + i] * Z[i][j];
      }
    for (int k = 0; k < kL; ++k) {
      float cv[4], bv[4], sv[8], tv[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = lane + 32 * j;
        cv[j] = n < N ? sC[k * kNP + n] : 0.f;
        bv[j] = n < N ? sB[k * kNP + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sv[i] = sDM[k * kLP + 8 * wy + i];   // dS[t = k][s = row]
        tv[i] = sDM[(8 * wy + i) * kLP + k];  // dS[t = row][s = k]
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          db[i][j] += sv[i] * cv[j];
          dc[i][j] += tv[i] * bv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * wy + i;
      if (r >= rows) continue;
      const long long o = (((long long)b * p.S + c0 + r) * p.H + h) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = lane + 32 * j;
        if (n < N) {
          p.dBp[o + n] = db[i][j];
          p.dCp[o + n] = dc[i][j];
        }
      }
    }
  }

  // dx over the slices of P: thread (wy, lane) holds rows s = 8 wy + i of
  // column lane
  for (int q0 = 0; q0 < P; q0 += kPT) {
    __syncthreads();
    for (int i = tid; i < kL * kPT; i += kThreads) {
      const int r = i / kPT, q = i % kPT;
      sDY[r * kXP + q] = r < rows ? bf(dyb[r * dy_row + q0 + q]) : 0.f;
    }
    for (int i = tid; i < kPT * N; i += kThreads) {
      const int q = i / N, n = i % N;
      sH[q * kNP + n] = dhb[(long long)(q0 + q) * N + n];
    }
    __syncthreads();
    float acc[8] = {}, hb[8] = {};
    for (int t = 0; t < kL; ++t) {
      const float dv = sDY[t * kXP + lane];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += sG[t * kLP + 8 * wy + i] * dv;
    }
    for (int n = 0; n < N; ++n) {
      const float hv = sH[lane * kNP + n];
#pragma unroll
      for (int i = 0; i < 8; ++i) hb[i] += hv * sB[(8 * wy + i) * kNP + n];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = 8 * wy + i;
      if (s >= rows) continue;
      const float v = acc[i] + w[s] * hb[i] + dsc * sDY[s * kXP + lane];
      p.dx[((long long)b * p.S + c0 + s) * dy_row + (long long)h * P + q0 + lane] = to_bf(v);
    }
  }
}

// pass 3a: dB and dC, each head's partial summed over its group in head
// order, in bf16. One thread an element of (B, S, G, N).
__global__ void ssd_bwd_group_sum_kernel(const Params p) {
  const long long total = (long long)p.B * p.S * p.G * p.N;
  const int rep = p.H / p.G;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int n = i % p.N;
    const long long bsg = i / p.N;  // (b, s) * G + g
    const int g = bsg % p.G;
    const long long bs = bsg / p.G;
    const long long base = (bs * p.H + (long long)g * rep) * p.N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < rep; ++k) {
      sb += p.dBp[base + (long long)k * p.N];
      sc += p.dCp[base + (long long)k * p.N];
    }
    p.dB[i] = to_bf(sb);
    p.dC[i] = to_bf(sc);
  }
}

// pass 3b: dA and dD, each summed over (batch, chunk) in order
__global__ void ssd_bwd_head_sum_kernel(const Params p) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.H) return;
  float sa = 0.f, sd = 0.f;
  for (int bc = 0; bc < p.B * p.nc; ++bc) {
    sa += p.dAp[(long long)bc * p.H + h];
    sd += p.dDp[(long long)bc * p.H + h];
  }
  p.dA[h] = sa;
  p.dD[h] = sd;
}

}  // namespace

// The backward of ssd_scan, in four launches on `stream`. x, B and C bf16
// with the last dim contiguous (strides in elements), dt fp32 with h
// contiguous, A and D fp32 (H,), hin (B, ceil(S / 64), H, P, N) fp32 from
// ssd_scan_states, dy bf16 (B, S, H, P) contiguous, dstate fp32 (B, H, P, N)
// contiguous or null; the scratch dh (as hin), dBp and dCp (B, S, H, N),
// dAp and dDp (B, nc, H) fp32 and the outputs dx (B, S, H, P) bf16, ddt (B,
// S, H) fp32, dB and dC (B, S, G, N) bf16, dA and dD (H,) fp32, all
// contiguous. H a multiple of G, P of 32, N of 4 and at most 128. Returns
// the cudaError_t of the launches (0 = launched).
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* D, const float* hin, const void* dy,
                            const float* dstate, float* dh, void* dx, float* ddt, float* dBp,
                            float* dCp, float* dAp, float* dDp, void* dB, void* dC, float* dA,
                            float* dD, long long xs_b, long long xs_s, long long xs_h,
                            long long bs_b, long long bs_s, long long bs_g, long long ds_b,
                            long long ds_s, int B, int S, int H, int P, int G, int N,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % kPT || N <= 0 || N % 4 ||
      N > kMaxN)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.dt = dt;
  p.A = A;
  p.Bm = static_cast<const uint16_t*>(Bm);
  p.Cm = static_cast<const uint16_t*>(Cm);
  p.D = D;
  p.hin = hin;
  p.dy = static_cast<const uint16_t*>(dy);
  p.dstate = dstate;
  p.dh = dh;
  p.dx = static_cast<uint16_t*>(dx);
  p.ddt = ddt;
  p.dBp = dBp;
  p.dCp = dCp;
  p.dAp = dAp;
  p.dDp = dDp;
  p.dB = static_cast<uint16_t*>(dB);
  p.dC = static_cast<uint16_t*>(dC);
  p.dA = dA;
  p.dD = dD;
  p.xs_b = xs_b;
  p.xs_s = xs_s;
  p.xs_h = xs_h;
  p.bs_b = bs_b;
  p.bs_s = bs_s;
  p.bs_g = bs_g;
  p.ds_b = ds_b;
  p.ds_s = ds_s;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (S + kL - 1) / kL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_bwd_state_kernel<<<dim3(P / kPT, H, B), kThreads, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int kBytes = ChunkSmem::kBytes;
  e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<<<dim3(p.nc, H, B), kThreads, kBytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long blocks = ((long long)B * S * G * N + kThreads - 1) / kThreads;
  ssd_bwd_group_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_head_sum_kernel<<<(H + 127) / 128, 128, 0, s>>>(p);
  return cudaGetLastError();
}
