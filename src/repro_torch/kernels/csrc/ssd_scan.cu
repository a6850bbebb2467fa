// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// forward: the prefill of every SSM layer.
//
// Replaces the TPU kernel `_ssd_kernel` behind `ssd_scan` in
// src/repro/kernels/ssd_scan.py (its pallas_call). Same contract: x (B, S,
// H, P) bf16, dt (B, S, H) fp32 (positive), A and D (H,) fp32, B and C (B,
// S, G, N) bf16 with head h reading group h / (H / G) -> y (B, S, H, P) bf16
// and the final state (B, H, P, N) fp32, for the recurrence per head
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t.
// Per chunk of L rows, all in fp32, with cum the inclusive prefix sum of
// dt A and seg = cum[L-1]:
//   att   = (C B^T) o exp(cum_t - cum_s)[s <= t] o dt_s       (L x L)
//   y     = att x + (C o exp(cum)) h_in^T + D x
//   h_out = h_in exp(seg) + (x o dt o exp(seg - cum))^T B
// The causal decay is selected, never multiplied by a mask: cum_t - cum_s
// for s > t is positive and can pass fp32's range, and inf * 0 is NaN.
//
// Design. The TPU kernel walks the chunks along a sequential grid axis and
// carries the (P x N) state in VMEM scratch. Hopper blocks run in no order,
// so here one block owns one (batch, head, 32-row slice of P) and loops
// over the chunks itself, keeping its (32 x N) slice of the state in shared
// memory for the whole sequence: the state never goes to device memory
// until the final store. Rows p of the state and columns p of y depend only
// on x[:, p], so the P slices are independent; each recomputes the chunk's
// C B^T scores, and Mamba2-2.7B's 80 heads x 2 slices fill 160 blocks on
// 132 SMs at batch 1. A chunk is L = 64 rows (the TPU kernel's is the
// config's 128): the function does not depend on it beyond fp32 rounding,
// and at 64 the block's B^T, C^T, x, att^T and state tiles take 111 KB at
// N = 128, so two blocks fit an SM. Every product runs in fp32 FMA on the
// CUDA cores (no tensor cores: the TPU kernel keeps fp32 products, and so
// does this one). Rows past S (the tail of the last chunk) read as x = 0,
// dt = 0: they add nothing to the state and do not decay it, so the final
// state is exact, and their y is not stored.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35
// TB/s): operations. At Mamba2's largest prefill (B 1, S 1024, H 80, P 64,
// N 128) the cheapest exact form, the sequential recurrence (5 P N + 3 P a
// token and head), is 3.37 GFLOP (0.0503 ms) against 24.4 MB of x, y, dt,
// B, C and the state (0.0073 ms). This kernel does about 4.5 GFLOP: the
// causal chunked form at L = 64 is 3.7, and each P slice recomputes the
// C B^T scores. It runs on shared-memory loads (about one per four FMAs)
// and one warp's serial prefix sum per chunk; tensor-core products (TF32
// or bf16 mma) and a deeper pipeline are the faster design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;        // rows per chunk
constexpr int kPT = 32;       // rows of the state (columns p of x and y) per block
constexpr int kLP = kL + 4;   // padded row of the transposed B and C tiles (16-byte aligned)
constexpr int kMaxN = 128;
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
  long long xs_b, xs_s, xs_h;  // element strides of x
  long long bs_b, bs_s, bs_g;  // of Bm and Cm
  long long ds_b, ds_s;        // of dt
  int S, H, P, G, N;
};

size_t smem_bytes(int N) {
  // B^T, C^T: N x kLP; state^T: N x kPT; x: kL x kPT; att^T: kL x kL; cum, dt, w: kL
  return sizeof(float) * (size_t(2 * N * kLP + N * kPT) + kL * kPT + kL * kL + 3 * kL);
}

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N;
  float* Ct = smem;              // [n][s]: C^T of the chunk
  float* Bt = Ct + N * kLP;      // [n][s]: B^T
  float* ht = Bt + N * kLP;      // [n][p]: the block's slice of the state, transposed
  float* xs = ht + N * kPT;      // [s][p]
  float* attT = xs + kL * kPT;   // [s][t]: att^T
  float* cum = attT + kL * kL;   // [t]
  float* dts = cum + kL;         // [s]
  float* ws = dts + kL;          // [s]: dt_s exp(seg - cum_s)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (p.H / p.G);
  const float a = p.A[h], dsc = p.D[h];
  const uint16_t* xb = p.x + b * p.xs_b + h * p.xs_h + p0;
  const float* dtb = p.dt + b * p.ds_b + h;
  const uint16_t* Bb = p.Bm + b * p.bs_b + grp * p.bs_g;
  const uint16_t* Cb = p.Cm + b * p.bs_b + grp * p.bs_g;
  const long long y_row = (long long)p.H * p.P;
  uint16_t* yb = p.y + (long long)b * p.S * y_row + (long long)h * p.P + p0;

  for (int i = tid; i < N * kPT; i += kThreads) ht[i] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += kL) {
    const int rows = min(kL, p.S - c0);

    // 1. the chunk's B^T, C^T and x slice in fp32 (zeros past S), and cum
    for (int i = tid; i < kL * N; i += kThreads) {
      const int s = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (s < rows) {
        const long long off = (long long)(c0 + s) * p.bs_s + n;
        bv = Mma<T>::to_float(Bb[off]);
        cv = Mma<T>::to_float(Cb[off]);
      }
      Bt[n * kLP + s] = bv;
      Ct[n * kLP + s] = cv;
    }
    for (int i = tid; i < kL * kPT; i += kThreads) {
      const int s = i / kPT, q = i % kPT;
      xs[i] = s < rows ? Mma<T>::to_float(xb[(long long)(c0 + s) * p.xs_s + q]) : 0.f;
    }
    if (tid < 32) {  // warp 0: lane l sums rows 2l and 2l + 1, then a warp scan
      const int r = 2 * tid;
      const float d0 = r < rows ? dtb[(long long)(c0 + r) * p.ds_s] : 0.f;
      const float d1 = r + 1 < rows ? dtb[(long long)(c0 + r + 1) * p.ds_s] : 0.f;
      const float v0 = d0 * a, v1 = v0 + d1 * a;
      float incl = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      cum[r] = excl + v0;
      cum[r + 1] = excl + v1;
      dts[r] = d0;
      dts[r + 1] = d1;
    }
    __syncthreads();
    const float seg = cum[kL - 1];
    if (tid < kL) ws[tid] = dts[tid] * expf(seg - cum[tid]);

    // 2. att^T: thread (ti, si) computes rows t = 4 ti + i against s = 4 si + j
    {
      const int ti = tid % 16, si = tid / 16;
      float acc[4][4] = {};
      if (si <= ti) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(Ct + n * kLP + 4 * ti);
          const float4 bv = *reinterpret_cast<const float4*>(Bt + n * kLP + 4 * si);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * si + j;
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * ti + i;
          o[i] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
        *reinterpret_cast<float4*>(attT + s * kL + 4 * ti) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // 3. y: thread (tt, pp) computes rows t = 2 tt + i, columns p = 4 pp + k
    {
      const int pp = tid % 8, t0 = 2 * (tid / 8);
      float ya[2][4] = {}, yc[2][4] = {};
      for (int s = 0; s <= t0 + 1; ++s) {
        const float2 av = *reinterpret_cast<const float2*>(attT + s * kL + t0);
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * kPT + 4 * pp);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ya[0][k] = fmaf(av.x, xr[k], ya[0][k]);
          ya[1][k] = fmaf(av.y, xr[k], ya[1][k]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float2 cv = *reinterpret_cast<const float2*>(Ct + n * kLP + t0);
        const float4 hv = *reinterpret_cast<const float4*>(ht + n * kPT + 4 * pp);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          yc[0][k] = fmaf(cv.x, hr[k], yc[0][k]);
          yc[1][k] = fmaf(cv.y, hr[k], yc[1][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t0 + i;
        if (t >= rows) continue;
        const float e = expf(cum[t]);
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = ya[i][k] + e * yc[i][k] + xs[t * kPT + 4 * pp + k] * dsc;
        *reinterpret_cast<uint2*>(yb + (long long)(c0 + t) * y_row + 4 * pp) =
            make_uint2(Mma<T>::pack(v[0], v[1]), Mma<T>::pack(v[2], v[3]));
      }
    }
    __syncthreads();

    // 4. the state: thread (nn, pp) updates n = 4 nn + i (+ 128 per pass), p = 4 pp + k
    {
      const int pp = tid % 8;
      const float es = expf(seg);
      for (int n0 = 4 * (tid / 8); n0 < N; n0 += 4 * (kThreads / 8)) {
        float acc[4][4] = {};
        for (int s = 0; s < rows; ++s) {
          const float w = ws[s];
          const float4 xv = *reinterpret_cast<const float4*>(xs + s * kPT + 4 * pp);
          const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float bv = Bt[(n0 + i) * kLP + s];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(xw[k], bv, acc[i][k]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* hp = reinterpret_cast<float4*>(ht + (n0 + i) * kPT + 4 * pp);
          const float4 hv = *hp;
          *hp = make_float4(hv.x * es + acc[i][0], hv.y * es + acc[i][1], hv.z * es + acc[i][2],
                            hv.w * es + acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  float* hb = p.hout + (((long long)b * p.H + h) * p.P + p0) * N;
  for (int i = tid; i < kPT * N; i += kThreads) {
    const int q = i / N, n = i % N;
    hb[(long long)q * N + n] = ht[n * kPT + q];
  }
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
  p.y = static_cast<uint16_t*>(y);
  p.hout = hout;
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
  const size_t smem = smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(P / kPT, H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
