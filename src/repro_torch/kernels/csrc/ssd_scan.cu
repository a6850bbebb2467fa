// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// forward: the prefill of every SSM layer.
//
// Replaces the TPU kernel `_ssd_kernel` behind `ssd_scan` in
// src/repro/kernels/ssd_scan.py (its pallas_call). Same contract: x (B, S,
// H, P) bf16, dt (B, S, H) fp32 (positive), A and D (H,) fp32, B and C (B,
// S, G, N) bf16 with head h reading group h / (H / G) -> y (B, S, H, P) bf16
// and the final state (B, H, P, N) fp32, for the recurrence per head
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t.
// Per chunk of L rows, with cum the inclusive prefix sum of dt A (fp32; the
// kernel keeps it in base-2 units and takes 2^x on the special-function
// unit) and seg = cum[L-1]:
//   att   = (C B^T) o exp(cum_t - cum_s)[s <= t] o dt_s       (L x L)
//   y     = att x + exp(cum) o (C h_in^T) + D x
//   h_out = h_in exp(seg) + (x o w)^T B,   w_s = dt_s exp(seg - cum_s)
// The causal decay is selected, never multiplied by a mask: cum_t - cum_s
// for s > t is positive and can pass fp32's range, and inf * 0 is NaN.
//
// Design. The TPU kernel walks the chunks along a sequential grid axis and
// carries the (P x N) state in VMEM scratch. Hopper blocks run in no order,
// so one block owns one (batch, head, slice of kPT = 64 rows of P; 32
// where P is not a multiple of 64) and walks the chunks itself; the state
// slice lives in the registers of its eight warps as mma accumulators for
// the whole sequence and goes to device memory once, at the end. At
// Mamba2's batch-1 admission that is 80 blocks, one an SM: C B^T is formed
// once a head, not once a slice. Chunks are L = 64 rows (the TPU kernel's
// is the config's 128; the function does not depend on it beyond fp32
// rounding).
//
// All four products run on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators). x, B and C arrive in bf16, so C B^T is
// exact up to summation order. The fp32 operands -- att, the carried state
// h in C h^T, and x o w in the state update -- are split into a bf16 high
// part and a bf16 low part (hi = bf16(v), lo = bf16(v - hi)) and each
// product is issued twice, leaving ~2^-16 of each element: bf16 update
// weights alone miss the state's 1e-4 gate by 50x (ssd_route_faults.py),
// and TF32's 10-bit mantissa is only 8x finer. Two warps share each 16-row
// block of the chunk, each computing half of y's columns: both form the
// block's rows of C B^T (only the tiles on or below the diagonal), the
// decay and att in registers, which become att x's A fragments without a
// trip through shared memory, then C h^T from the last chunk's state (held
// in shared memory in hi / lo halves, double-buffered, so one barrier a
// chunk suffices). The warps of one sub-partition take a heavy and a light
// block of the causal triangle. Then each warp updates a 16-row block of
// the state over a part of its columns (the accumulators are scaled by
// exp(seg), then (x o w)^T B is added) and writes them back as hi / lo
// halves for the next chunk. Each warp computes
// the prefix sum of dt A for itself (a warp scan, no barrier). The next
// chunk's x, B, C and dt are copied with cp.async into the second stage of
// a two-stage ring while this chunk computes (bf16 tiles, rows padded for
// conflict-free ldmatrix); rows past S are zero-filled (x = 0, dt = 0: they
// add nothing to the state and do not decay it, so the final state is
// exact, and their y is not stored). Inputs whose rows are not 16-byte
// aligned are copied element by element, in the same place.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): bytes. At
// Mamba2's largest prefill (B 1, S 1024, H 80, P 64, N 128, G 1) x, y, dt,
// B, C and the state are 24.4 MB (0.0073 ms); the chunked form's products
// at L = 64 (C B^T once a group and chunk, the causal half of it and of
// att x, C h^T and the update) are 3.0 GFLOP, 0.0031 ms at the bf16 rate.
// (The sequential recurrence at fp32's 67 TFLOP/s is 0.0503 ms: the
// bound while the products ran on fp32 FMA, still printed beside it.)
//
// Training. The backward (ssd_scan_bwd.cu) needs the state entering each
// chunk. The entry ssd_scan_states has the warps that hold the state store
// it at each chunk's start, before the chunk's update: one (P x N) fp32
// store a chunk and head into hin (B, nc, H, P, N), the first chunk's
// zero. That is the state the kernel carries anyway, so nothing is
// recomputed; at Mamba2's training shape (1 x 1024) it is 42 MB a layer,
// 2.7 GB over 64 layers, which a recomputing backward would save at the
// cost of a second pass of the forward's update products. y and the final
// state keep their bits: the arithmetic is the same, with or without hin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kL = 64;       // rows per chunk
constexpr int kWarps = 8;    // two warps a 16-row block of the chunk (4 warps: one)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 128;
constexpr float kLog2e = 1.4426950408889634f;
using T = __nv_bfloat16;

struct Params {
  const uint16_t* x;   // (B, S, H, P), p contiguous
  const float* dt;     // (B, S, H), h contiguous
  const float* A;      // (H,)
  const uint16_t* Bm;  // (B, S, G, N), n contiguous
  const uint16_t* Cm;  // the same strides as Bm
  const float* D;      // (H,)
  uint16_t* y;         // (B, S, H, P) contiguous
  float* hout;         // (B, H, P, N) contiguous
  float* hin;          // (B, nc, H, P, N) contiguous: the state entering each chunk, or null
  long long xs_b, xs_s, xs_h;  // element strides of x
  long long bs_b, bs_s, bs_g;  // of Bm and Cm
  long long ds_b, ds_s;        // of dt
  int S, H, P, G, N;
  int vec16;           // rows of x, B and C 16-byte aligned: cp.async; else element copies
};

// shared memory of a block (bytes): a two-stage ring of (C, B, x, dt) tiles
// and the state's hi / lo halves, double-buffered; NP is N rounded up to
// 16 (the columns past N stay zero)
template <int kPT, int NP>
struct Smem {
  static constexpr int kNPitch = NP + kPad;  // elements a row of C, B and the state
  static constexpr int kXPitch = kPT + kPad;
  static constexpr int kCB = kL * kNPitch * 2;
  static constexpr int kX = kL * kXPitch * 2;
  static constexpr int kStage = 2 * kCB + kX + kL * 4;
  static constexpr int kH = kPT * kNPitch;  // elements of one half of the state
  static constexpr int kBytes = 2 * kStage + 4 * kH * 2 + kWarps * kL * 4;
};

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices, lane l addressing row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(su32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(su32(p))
               : "memory");
}

// Fragment addresses for lane l into tiles of `pitch` elements a row:
// the A fragment (16 x 16) at (m0, k0) of a tile stored [m][k] (ldsm4);
__device__ __forceinline__ const uint16_t* a_rows(const uint16_t* s, int pitch, int m0, int k0,
                                                  int lane) {
  return s + (m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8;
}
// the A fragment at (m0, k0) of a tile stored [k][m] (ldsm4t);
__device__ __forceinline__ const uint16_t* a_cols(const uint16_t* s, int pitch, int m0, int k0,
                                                  int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + m0 + (((lane >> 3) & 1) << 3);
}
// the B fragments of n8 tiles n0 and n0 + 8 at depth k0 of a tile stored
// [n][k] (ldsm4: r[0], r[1] tile n0; r[2], r[3] tile n0 + 8);
__device__ __forceinline__ const uint16_t* b_rows(const uint16_t* s, int pitch, int n0, int k0,
                                                  int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + (((lane >> 3) & 1) << 3);
}
// the same of a tile stored [k][n] (ldsm4t)
__device__ __forceinline__ const uint16_t* b_cols(const uint16_t* s, int pitch, int n0, int k0,
                                                  int lane) {
  return s + (k0 + (lane & 15)) * pitch + n0 + (lane >> 4) * 8;
}

// 2^x by the special-function unit (ex2.approx.ftz: ~2^-22 relative)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (v0, v1) -> their bf16 high parts and the bf16 of what is left
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - f.x, v1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(su32(dst)), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

// rows [c0, c0 + kL) of a (rows, cols) bf16 matrix at `src` (row stride in
// elements, cols <= kCols) into a tile of `kPitch`; rows at or past S are
// zero-filled, columns past cols left as they are
template <int kPitch, int kCols>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src, long long stride,
                                          int cols, int rows, bool vec16) {
  if (vec16) {
    constexpr int kPer = kCols / 8;  // 16-byte pieces of a row
#pragma unroll
    for (int i = threadIdx.x; i < kL * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * 8;
      if (c >= cols) continue;
      const bool live = r < rows;
      cp_async16(dst + r * kPitch + c, src + (live ? r * stride + c : 0), live);
    }
  } else {
    for (int i = threadIdx.x; i < kL * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      dst[r * kPitch + c] = r < rows ? src[r * stride + c] : uint16_t(0);
    }
  }
}

template <int kPT, int NP>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Params p) {
  using L = Smem<kPT, NP>;
  constexpr int kNP = L::kNPitch, kXP = L::kXPitch;
  constexpr int kPB = kPT / 16;                                // 16-row blocks of the state
  constexpr int kParts = kWarps / kPB < NP / 16 ? kWarps / kPB : NP / 16;  // n ranges a block
  // the column parts of y each 16-row block of the chunk is cut into, and
  // the columns of y a warp computes
  constexpr int kYParts = kWarps / 4 < kPT / 16 ? kWarps / 4 : kPT / 16;
  constexpr int kYC = kPT / kYParts;
  constexpr int kNT = NP / kParts / 8;                         // n8 tiles of a warp's state
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* sH = reinterpret_cast<uint16_t*>(smem + 2 * L::kStage);  // [buf][hi, lo][p][n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  float* cum = reinterpret_cast<float*>(smem + 2 * L::kStage + 4 * L::kH * 2) + warp * kL;

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (p.H / p.G);
  const float a2 = p.A[h] * kLog2e, dsc = p.D[h];
  const uint16_t* xb = p.x + b * p.xs_b + h * p.xs_h + p0;
  const float* dtb = p.dt + b * p.ds_b + h;
  const uint16_t* Bb = p.Bm + b * p.bs_b + grp * p.bs_g;
  const uint16_t* Cb = p.Cm + b * p.bs_b + grp * p.bs_g;
  const long long y_row = (long long)p.H * p.P;
  uint16_t* yb = p.y + (long long)b * p.S * y_row + (long long)h * p.P + p0;
  const bool vec16 = p.vec16;

  // the ring's columns past N must read as zero: clear both stages once
  for (int i = tid; i < 2 * L::kStage / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_chunk = [&](int c0, int st) {
    uint8_t* s = smem + st * L::kStage;
    const int rows = min(kL, p.S - c0);
    load_rows<kNP, NP>(reinterpret_cast<uint16_t*>(s), Cb + c0 * p.bs_s, p.bs_s, p.N, rows,
                       vec16);
    load_rows<kNP, NP>(reinterpret_cast<uint16_t*>(s + L::kCB), Bb + c0 * p.bs_s, p.bs_s, p.N,
                       rows, vec16);
    load_rows<kXP, kPT>(reinterpret_cast<uint16_t*>(s + 2 * L::kCB), xb + c0 * p.xs_s, p.xs_s,
                        kPT, rows, vec16);
    float* sdt = reinterpret_cast<float*>(s + 2 * L::kCB + L::kX);
    for (int i = tid; i < kL; i += kThreads)
      cp_async4(sdt + i, dtb + (i < rows ? (c0 + i) * p.ds_s : 0), i < rows);
    cp_async_commit();
  };

  // this warp's rows [16 pb, 16 pb + 16) of the state slice over columns
  // [n0, n0 + 8 kNT): an mma accumulator for the whole sequence
  const int pb = warp % kPB, n0 = (warp / kPB) * (NP / kParts);
  const bool owns_state = warp < kPB * kParts;
  float hs[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) hs[j][0] = hs[j][1] = hs[j][2] = hs[j][3] = 0.f;
  // this warp's part of the state slice into a (P, N) fp32 matrix at dst
  auto store_state = [&](float* dst) {
    float* hb = dst + (long long)p0 * p.N;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      if (col >= p.N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * pb + g + 8 * r;
        *reinterpret_cast<float2*>(hb + (long long)row * p.N + col) =
            make_float2(hs[j][2 * r], hs[j][2 * r + 1]);
      }
    }
  };

  const int n_chunks = (p.S + kL - 1) / kL;
  load_chunk(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1, c0 = c * kL, rows = min(kL, p.S - c0);
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c - 1 is done with the other stage
    if (c + 1 < n_chunks) load_chunk(c0 + kL, st ^ 1);
    const uint8_t* s = smem + st * L::kStage;
    const uint16_t* sC = reinterpret_cast<const uint16_t*>(s);
    const uint16_t* sB = reinterpret_cast<const uint16_t*>(s + L::kCB);
    const uint16_t* sX = reinterpret_cast<const uint16_t*>(s + 2 * L::kCB);
    const float* dts = reinterpret_cast<const float*>(s + 2 * L::kCB + L::kX);

    {  // cum, in base-2 units: lane l sums rows 2l and 2l + 1, then a warp scan
      const int r = 2 * lane;
      const float d0 = dts[r], d1 = dts[r + 1];
      const float v0 = d0 * a2, v1 = v0 + d1 * a2;
      float incl = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      cum[r] = excl + v0;
      cum[r + 1] = excl + v1;
      __syncwarp();
    }
    const float seg = cum[kL - 1];

    if (warp < 4 * kYParts) {
      // rows [t0, t0 + 16) x columns [y0, y0 + kYC) of y: C h_in^T, C B^T ->
      // att, att x. Row block rb holds rb + 1 tiles of the causal triangle:
      // the warps of a sub-partition (w, w + 4, ...) take blocks rb and 3 - rb
      // in turn.
      const int rb = (warp >> 2) & 1 ? 3 - (warp & 3) : warp & 3, y0 = (warp >> 2) * kYC;
      const int t0 = 16 * rb, ta = t0 + g, tb = ta + 8;
      const uint16_t* hHi = sH + ((c + 1) & 1) * 2 * L::kH;  // the last chunk's state
      const uint16_t* hLo = hHi + L::kH;
      float y[kYC / 8][4], cb[kL / 8][4];
#pragma unroll
      for (int j = 0; j < kYC / 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kL / 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t ca[4];
        ldsm4(ca, a_rows(sC, kNP, t0, 16 * kk, lane));
        if (c > 0) {
#pragma unroll
          for (int jp = 0; jp < kYC / 16; ++jp) {
            uint32_t bh[4], bl[4];
            ldsm4(bh, b_rows(hHi, kNP, y0 + 16 * jp, 16 * kk, lane));
            ldsm4(bl, b_rows(hLo, kNP, y0 + 16 * jp, 16 * kk, lane));
            Mma<T>::run(y[2 * jp], ca, bh[0], bh[1]);
            Mma<T>::run(y[2 * jp + 1], ca, bh[2], bh[3]);
            Mma<T>::run(y[2 * jp], ca, bl[0], bl[1]);
            Mma<T>::run(y[2 * jp + 1], ca, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int js = 0; js < kL / 16; ++js) {
          if (js > rb) continue;  // above the diagonal
          uint32_t bb[4];
          ldsm4(bb, b_rows(sB, kNP, 16 * js, 16 * kk, lane));
          Mma<T>::run(cb[2 * js], ca, bb[0], bb[1]);
          Mma<T>::run(cb[2 * js + 1], ca, bb[2], bb[3]);
        }
      }
      const float ca_ = cum[ta], cb_ = cum[tb];
      const float ea = ex2(ca_), eb = ex2(cb_);
#pragma unroll
      for (int j = 0; j < kYC / 8; ++j) {
        y[j][0] *= ea;
        y[j][1] *= ea;
        y[j][2] *= eb;
        y[j][3] *= eb;
      }
      // att, selected on and below the diagonal
#pragma unroll
      for (int j = 0; j < kL / 8; ++j) {
        if (j / 2 > rb) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = i < 2 ? ta : tb, sidx = 8 * j + 2 * tq + (i & 1);
          cb[j][i] = sidx <= t ? cb[j][i] * ex2(cum[t] - cum[sidx]) * dts[sidx] : 0.f;
        }
      }
      // y += att x, att split into hi and lo A fragments straight from cb
#pragma unroll
      for (int ks = 0; ks < kL / 16; ++ks) {
        if (ks > rb) continue;
        uint32_t ah[4], al[4];
        split2(cb[2 * ks][0], cb[2 * ks][1], ah[0], al[0]);
        split2(cb[2 * ks][2], cb[2 * ks][3], ah[1], al[1]);
        split2(cb[2 * ks + 1][0], cb[2 * ks + 1][1], ah[2], al[2]);
        split2(cb[2 * ks + 1][2], cb[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
        for (int jp = 0; jp < kYC / 16; ++jp) {
          uint32_t bx[4];
          ldsm4t(bx, b_cols(sX, kXP, y0 + 16 * jp, 16 * ks, lane));
          Mma<T>::run(y[2 * jp], ah, bx[0], bx[1]);
          Mma<T>::run(y[2 * jp + 1], ah, bx[2], bx[3]);
          Mma<T>::run(y[2 * jp], al, bx[0], bx[1]);
          Mma<T>::run(y[2 * jp + 1], al, bx[2], bx[3]);
        }
      }
      // + D x, stored in bf16
#pragma unroll
      for (int j = 0; j < kYC / 8; ++j) {
        const int col = y0 + 8 * j + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = r ? tb : ta;
          if (t >= rows) continue;
          const float2 xv = bf2(*reinterpret_cast<const uint32_t*>(sX + t * kXP + col));
          *reinterpret_cast<uint32_t*>(yb + (long long)(c0 + t) * y_row + col) =
              Mma<T>::pack(y[j][2 * r] + xv.x * dsc, y[j][2 * r + 1] + xv.y * dsc);
        }
      }
    }

    if (owns_state) {  // the state: h exp(seg) + (x o w)^T B
      if (p.hin)
        store_state(p.hin + (((long long)b * n_chunks + c) * p.H + h) * p.P * p.N);
      const float es = ex2(seg);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        hs[j][0] *= es;
        hs[j][1] *= es;
        hs[j][2] *= es;
        hs[j][3] *= es;
      }
#pragma unroll
      for (int ks = 0; ks < kL / 16; ++ks) {
        if (16 * ks >= rows) break;  // x is zero past S
        const int s0 = 16 * ks + 2 * tq;
        const float w0 = dts[s0] * ex2(seg - cum[s0]);
        const float w1 = dts[s0 + 1] * ex2(seg - cum[s0 + 1]);
        const float w8 = dts[s0 + 8] * ex2(seg - cum[s0 + 8]);
        const float w9 = dts[s0 + 9] * ex2(seg - cum[s0 + 9]);
        uint32_t xa[4], ah[4], al[4];
        ldsm4t(xa, a_cols(sX, kXP, 16 * pb, 16 * ks, lane));
        const float2 x0 = bf2(xa[0]), x1 = bf2(xa[1]), x2 = bf2(xa[2]), x3 = bf2(xa[3]);
        split2(x0.x * w0, x0.y * w1, ah[0], al[0]);
        split2(x1.x * w0, x1.y * w1, ah[1], al[1]);
        split2(x2.x * w8, x2.y * w9, ah[2], al[2]);
        split2(x3.x * w8, x3.y * w9, ah[3], al[3]);
#pragma unroll
        for (int jn = 0; jn < kNT / 2; ++jn) {
          uint32_t bb[4];
          ldsm4t(bb, b_cols(sB, kNP, n0 + 16 * jn, 16 * ks, lane));
          Mma<T>::run(hs[2 * jn], ah, bb[0], bb[1]);
          Mma<T>::run(hs[2 * jn + 1], ah, bb[2], bb[3]);
          Mma<T>::run(hs[2 * jn], al, bb[0], bb[1]);
          Mma<T>::run(hs[2 * jn + 1], al, bb[2], bb[3]);
        }
      }
      if (c + 1 < n_chunks) {  // hi / lo halves for the next chunk's C h^T
        uint16_t* wHi = sH + (c & 1) * 2 * L::kH;
        uint16_t* wLo = wHi + L::kH;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * pb + g + 8 * r;
            uint32_t hi, lo;
            split2(hs[j][2 * r], hs[j][2 * r + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(wHi + row * kNP + col) = hi;
            *reinterpret_cast<uint32_t*>(wLo + row * kNP + col) = lo;
          }
        }
      }
    }
  }

  if (owns_state) store_state(p.hout + ((long long)b * p.H + h) * p.P * p.N);
}

template <int kPT, int NP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int kBytes = Smem<kPT, NP>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<kPT, NP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  ssd_scan_kernel<kPT, NP><<<dim3(p.P / kPT, p.H, B), kThreads, kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int kPT>
cudaError_t launch_n(const Params& p, int B, cudaStream_t stream) {
  if (p.N <= 16) return launch<kPT, 16>(p, B, stream);
  if (p.N <= 32) return launch<kPT, 32>(p, B, stream);
  if (p.N <= 64) return launch<kPT, 64>(p, B, stream);
  return launch<kPT, 128>(p, B, stream);
}

int run(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
        const float* D, void* y, float* hout, float* hin, long long xs_b, long long xs_s,
        long long xs_h, long long bs_b, long long bs_s, long long bs_g, long long ds_b,
        long long ds_s, int B, int S, int H, int P, int G, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 32 || N <= 0 || N % 4 ||
      N > kMaxN)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.dt = dt;
  p.A = A;
  p.Bm = static_cast<const uint16_t*>(Bm);
  p.Cm = static_cast<const uint16_t*>(Cm);
  p.D = D;
  p.y = static_cast<uint16_t*>(y);
  p.hout = hout;
  p.hin = hin;
  p.xs_b = xs_b;
  p.xs_s = xs_s;
  p.xs_h = xs_h;
  p.bs_b = bs_b;
  p.bs_s = bs_s;
  p.bs_g = bs_g;
  p.ds_b = ds_b;
  p.ds_s = ds_s;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                         reinterpret_cast<uintptr_t>(Cm);
  p.vec16 = ptrs % 16 == 0 && N % 8 == 0 && (xs_b | xs_s | xs_h | bs_b | bs_s | bs_g) % 8 == 0;
  const int pt = P % 64 == 0 ? 64 : 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pt == 64 ? launch_n<64>(p, B, s) : launch_n<32>(p, B, s);
}

}  // namespace

// x, B and C bf16 with the last dim contiguous (strides in elements), dt
// fp32 with h contiguous, A and D fp32 (H,), y and hout contiguous; H a
// multiple of G, P of 32, N of 4 and at most 128. Returns the cudaError_t
// of the launch (0 = launched).
extern "C" int ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* D, void* y, float* hout, long long xs_b,
                        long long xs_s, long long xs_h, long long bs_b, long long bs_s,
                        long long bs_g, long long ds_b, long long ds_s, int B, int S, int H,
                        int P, int G, int N, void* stream) {
  return run(x, dt, A, Bm, Cm, D, y, hout, nullptr, xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, ds_b,
             ds_s, B, S, H, P, G, N, stream);
}

// The same, and the state entering each chunk of 64 rows into hin (B,
// ceil(S / 64), H, P, N) fp32 contiguous, for the backward.
extern "C" int ssd_scan_states(const void* x, const float* dt, const float* A, const void* Bm,
                               const void* Cm, const float* D, void* y, float* hout, float* hin,
                               long long xs_b, long long xs_s, long long xs_h, long long bs_b,
                               long long bs_s, long long bs_g, long long ds_b, long long ds_s,
                               int B, int S, int H, int P, int G, int N, void* stream) {
  return run(x, dt, A, Bm, Cm, D, y, hout, hin, xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, ds_b, ds_s,
             B, S, H, P, G, N, stream);
}
