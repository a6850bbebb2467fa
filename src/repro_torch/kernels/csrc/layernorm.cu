// LayerNorm for Hopper (sm_90a), forward and backward, over the last dim:
// y = (x - mu) * rsqrt(var + eps) * w (+ b), fp32 moments, output in x's
// dtype; and its gradient (dx, dw, db).
//
// The forward replaces the TPU kernel `_layernorm_kernel` behind `layernorm`
// in src/repro/kernels/rmsnorm.py (its pallas_call). Same contract: x (rows,
// d) with any row stride and a contiguous last dim, w (d,), an optional b
// (d,), eps; mu = mean(x), var = mean((x - mu)^2) (two passes, both in
// fp32), the product in fp32, one rounding to x's dtype. x is fp32, bf16 or
// fp16; w and b each any of the three, independently of x.
//
// The backward is the port's own: the reference pairs its Pallas forward
// with an XLA backward (`_ln_bwd` in src/repro/kernels/ops.py), which this
// kernel computes with the moments recomputed from x (the forward saves
// nothing else). Per row: mu and rstd, x^ = (x - mu) * rstd, dyw = dy * w
// rounded to the dtype torch promotes dy and w to (bf16 only when both are
// bf16, fp16 only when both are fp16), c1 = mean(dyw), c2 = mean(dyw * x^),
// dx = (dyw - c1 - x^ * c2) * rstd in x's dtype; over the rows, dw =
// sum(dy * x^) in w's dtype and db = sum(dy) in b's dtype.
//
// Why CUDA C++ and not Triton: at the decode shapes (32 rows of 512-8192)
// the device work is 1.6-2.5 us, and Triton's Python launcher cost 54-76 us
// a call on the H100 (the Triton RMSNorm measured the same, and its CUDA C++
// successor 0.0214 ms back to back). The norm runs 19-73 times in each
// decode step of the encoder-decoder models and 134 times in each ESM-2
// training step, so its cost at small row counts is the host path: this
// source is launched through ctypes with a plain C interface, and its
// wrapper does nothing else but attribute checks and the allocations.
//
// Forward design (rmsnorm.cu's, on a resident grid). One thread per
// 8-element vector of a row (up to 512 threads, then two or four vectors a
// thread): no lane is masked past d, as a power-of-two row tile masks
// 37.5% of d 1280's. A block takes a row at a time; the grid is as many
// blocks as the card holds at once (or the rows, when fewer), and block g
// takes rows g, g + G, ..., loading the next row's x before the current
// row's two reductions, so x's loads stay in flight through the barriers
// (one row a block, as the Triton kernel ran, read 28% slower at (32 768,
// 1280): layernorm_variants.py). x is read once and y written
// once; at one vector a thread w and b stay in registers. The two moments
// are summed from the registers: warp shuffles, then the warps' partials
// through shared memory, summed by every thread in warp order. The threads
// a block depend on d alone and a row's arithmetic does not depend on the
// block that takes it, so its bits do not depend on the other rows.
//
// Backward design. Three passes in two launches, no atomics:
//  1. layernorm_bwd_kernel: G blocks (G from rows and d alone,
//     layernorm_bwd_grid: as many as an H100's 132 SMs hold at once, 6 an
//     SM at d 1280, 10 at 768, 16 at 512, one past d 4096), each over a run
//     of R consecutive rows (the last run shorter), one thread per
//     8-element vector of the row (up to 512 threads, then two vectors a
//     thread: d up to 8192). Per row it reduces the mean, the variance and
//     then (c1, c2) over the block as the forward does (three barriers),
//     writes dx, and adds dy * x^ and dy to fp32 accumulators in registers
//     for its columns, in row order. The next row's x and dy are loaded
//     before the current row's reductions. At the end each block writes its
//     accumulators as one fp32 row of partials: part[g] for dw, part[G + g]
//     for db. A grid of resident blocks keeps the most rows in flight (half
//     as many blocks, or twice as many in two waves, read slower:
//     layernorm_variants.py); its cost is ~1 M partials an array.
//  2. layernorm_bwd_sum_kernel: for each column, the G partial rows summed
//     in a fixed order: 128 segments of ceil(G / 128) consecutive blocks
//     each summed in block order, then the 128 segment sums in segment
//     order, and written in w's (b's) dtype.
// Every sum has a fixed order, so a repeat is bit-identical; dx of a row
// depends on that row alone. The products and sums of the partials use
// __fmul_rn / __fadd_rn, so the plain schedule-following version
// (ref.layernorm_bwd_sched_ref) forms them the same way.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Forward: read x, write y (plus
// w and b): at ESM-2's serving shape (32 768, 1280) bf16 168 MB, 50 us; at
// the decode shape (32, 1024) 0.13 MB, far below a launch and one DRAM
// round trip (~1.5 us). Backward: read x and dy, write dx (plus w, dw and
// db): at ESM-2's training shape (8192, 1280) bf16 63 MB, 18.8 us. The
// partials are this design's own cost, not the gradient's (G * d * 4 bytes
// an array, written and read back: 15 MB there, 4.6 us more).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kFwdMaxThreads = 512;    // forward: threads a block (then 2 or 4 vectors a thread)
constexpr int kBwdMaxThreads = 512;    // backward: threads a block (then 2 vectors a thread)
constexpr int kBwdSMs = 132;           // an H100 SXM's SMs (the backward's grid, below)
constexpr int kBwdResident = 1024;     // threads an SM holds at 64 registers a thread
constexpr int kSumSegs = 128;          // the partials' segments: short runs, many loads in flight
constexpr int kSumCols = 8;            // columns a sum block
constexpr int kNone = 3;               // dtype code: no tensor

// 8 consecutive elements <-> 8 floats
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  struct Raw {
    float4 a, b;
  };
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return Raw{reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
    f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <typename T>
struct Vec8Half {  // bf16 and fp16: one 16-byte vector
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&r);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = Mma<T>::to_float(h[e]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(Mma<T>::pack(f[0], f[1]), Mma<T>::pack(f[2], f[3]),
                                              Mma<T>::pack(f[4], f[5]), Mma<T>::pack(f[6], f[7]));
  }
  // v rounded to T and back
  static __device__ __forceinline__ float round(float v) {
    return Mma<T>::to_float(uint16_t(Mma<T>::pack(v, 0.f) & 0xffffu));
  }
};

template <>
struct Vec8<__nv_bfloat16> : Vec8Half<__nv_bfloat16> {};
template <>
struct Vec8<__half> : Vec8Half<__half> {};

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]) {
  Vec8<T>::unpack(Vec8<T>::load_raw(p), f);
}

// 8 elements of a weight whose dtype is known at run time (the branch is
// uniform over the grid)
__device__ __forceinline__ void load8_coded(const void* p, int code, int col, float (&f)[8]) {
  if (code == 0)
    load8(static_cast<const float*>(p) + col, f);
  else if (code == 1)
    load8(static_cast<const __nv_bfloat16*>(p) + col, f);
  else
    load8(static_cast<const __half*>(p) + col, f);
}

// the sum of v over the block, the same in every thread: warp shuffles,
// then the warps' partials in warp order. red: one slot a warp, not
// reused before the block's next barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

// two sums at once (one barrier): red holds 2 slots a warp
__device__ __forceinline__ void block_sum2(float& a, float& b, float2* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  a = b = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    a += red[i].x;
    b += red[i].y;
  }
}

// ---------------------------------------------------------------- forward
// y is contiguous: its rows are d apart. codes: w's | b's << 2 (kNone: no
// b). Block g takes rows g, g + G, g + 2G, ... (G = gridDim.x), the next
// row's x loaded before the current row's reductions; a row's arithmetic
// does not depend on which block takes it. At one vector a thread w and b
// stay in registers; at more they are read again for each row (from L1),
// which keeps the registers, and so the blocks an SM holds, at the level of
// one vector a thread.
template <typename TX, int VPT>
__global__ void __launch_bounds__(kFwdMaxThreads) layernorm_kernel(
    const TX* __restrict__ x, const void* __restrict__ w, const void* __restrict__ b,
    TX* __restrict__ y, int rows, int d, long long x_rs, int codes, float eps) {
  __shared__ float red[2][kFwdMaxThreads / 32];
  const int nvec = d >> 3, tid = threadIdx.x, G = gridDim.x;
  const int w_code = codes & 3, b_code = codes >> 2;
  using Raw = typename Vec8<TX>::Raw;

  float wv[8], bv[8];
  if (VPT == 1 && tid < nvec) {
    load8_coded(w, w_code, 8 * tid, wv);
    if (b_code != kNone) load8_coded(b, b_code, 8 * tid, bv);
  }
  Raw nx[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < nvec) nx[i] = Vec8<TX>::load_raw(x + blockIdx.x * x_rs + 8 * c);
  }
  for (int row = blockIdx.x; row < rows; row += G) {
    float v[VPT][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < nvec) {
        Vec8<TX>::unpack(nx[i], v[i]);
        if (row + G < rows) nx[i] = Vec8<TX>::load_raw(x + (row + G) * x_rs + 8 * c);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[i][e];
      }
    }
    const float mu = block_sum(s, red[0]) / float(d);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (tid + i * blockDim.x < nvec) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[i][e] -= mu;
          ss = fmaf(v[i][e], v[i][e], ss);
        }
      }
    }
    const float rstd = 1.f / sqrtf(block_sum(ss, red[1]) / float(d) + eps);
    TX* yr = y + (long long)row * d;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < nvec) {
        if (VPT > 1) {
          load8_coded(w, w_code, 8 * c, wv);
          if (b_code != kNone) load8_coded(b, b_code, 8 * c, bv);
        }
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = v[i][e] * rstd * wv[e];
          if (b_code != kNone) o[e] += bv[e];
        }
        Vec8<TX>::store(yr + 8 * c, o);
      }
    }
  }
}

// threads a block (one a vector up to kFwdMaxThreads) and vectors a thread
int fwd_threads(int d) {
  const int nvec = d / 8;
  return nvec > kFwdMaxThreads ? kFwdMaxThreads : (nvec + 31) / 32 * 32;
}

// the blocks the card holds at once for a kernel of `threads`, asked once
// a (kernel, threads) pair: the grid is never larger, so every block is
// resident from the start and loops over its rows
template <typename K>
int resident_blocks(K kernel, int threads, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    *cache = sms * (per_sm > 0 ? per_sm : 1);
  }
  return *cache;
}

template <typename TX, int VPT>
cudaError_t launch_fwd_vpt(const TX* x, const void* w, const void* b, TX* y, int rows, int d,
                           long long x_rs, int codes, float eps, cudaStream_t s) {
  static int cache[kFwdMaxThreads / 32 + 1];
  const int threads = fwd_threads(d);
  const int held = resident_blocks(layernorm_kernel<TX, VPT>, threads, &cache[threads / 32]);
  const int grid = rows < held ? rows : held;
  layernorm_kernel<TX, VPT><<<grid, threads, 0, s>>>(x, w, b, y, rows, d, x_rs, codes, eps);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y, int rows, int d,
                       long long x_rs, int codes, float eps, cudaStream_t s) {
  const int nvec = d / 8, threads = fwd_threads(d);
  const int vpt = (nvec + threads - 1) / threads;
  const TX* px = static_cast<const TX*>(x);
  TX* py = static_cast<TX*>(y);
  if (vpt == 1) return launch_fwd_vpt<TX, 1>(px, w, b, py, rows, d, x_rs, codes, eps, s);
  if (vpt == 2) return launch_fwd_vpt<TX, 2>(px, w, b, py, rows, d, x_rs, codes, eps, s);
  return launch_fwd_vpt<TX, 4>(px, w, b, py, rows, d, x_rs, codes, eps, s);
}

// ---------------------------------------------------------------- backward
// threads a block: one a vector, up to kBwdMaxThreads, then two vectors a
// thread
int bwd_threads(int d) {
  const int nvec = d / 8;
  return nvec > kBwdMaxThreads ? kBwdMaxThreads : (nvec + 31) / 32 * 32;
}

// G blocks of R rows (the last run shorter), from rows and d alone: as
// many blocks as an H100's SMs hold at once (kBwdSMs times the blocks that
// kBwdResident threads make; one an SM at two vectors a thread), so that
// each block is resident from the start and walks its run of rows
int bwd_grid(int rows, int d, int* rows_per_block) {
  const int threads = bwd_threads(d);
  const int per_sm = d / 8 > kBwdMaxThreads ? 1 : kBwdResident / threads;
  const int target = kBwdSMs * per_sm;
  const int r = (rows + target - 1) / target;
  *rows_per_block = r;
  return (rows + r - 1) / r;
}

// dx is contiguous. codes: x's | w's << 2 | b's << 4 (kNone: no b).
// part: (2 if b else 1, gridDim.x, d) fp32 partials. Block g takes rows
// [g * R, min(rows, (g + 1) * R)) in order.
template <typename TX, int VPT>
__global__ void __launch_bounds__(kBwdMaxThreads) layernorm_bwd_kernel(
    const TX* __restrict__ x, const TX* __restrict__ dy, const void* __restrict__ w,
    TX* __restrict__ dx, float* __restrict__ part, int rows, int d, long long x_rs,
    long long dy_rs, int rows_per_block, int codes, float eps) {
  __shared__ float red_mu[kBwdMaxThreads / 32], red_var[kBwdMaxThreads / 32];
  __shared__ float2 red_c[kBwdMaxThreads / 32];
  const int nvec = d >> 3, tid = threadIdx.x;
  const int x_code = codes & 3, w_code = (codes >> 2) & 3;
  const bool has_b = (codes >> 4) != kNone;
  // dy * w is rounded to x's (= dy's) dtype when w has the same 16-bit dtype
  const bool round_dyw = x_code != 0 && w_code == x_code;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  using Raw = typename Vec8<TX>::Raw;

  float wv[VPT][8], acc_w[VPT][8], acc_b[VPT][8];
  Raw nx[VPT], ndy[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_w[i][e] = acc_b[i][e] = 0.f;
    if (c < nvec) {
      load8_coded(w, w_code, 8 * c, wv[i]);
      nx[i] = Vec8<TX>::load_raw(x + r0 * x_rs + 8 * c);
      ndy[i] = Vec8<TX>::load_raw(dy + r0 * dy_rs + 8 * c);
    }
  }

  for (int r = r0; r < r1; ++r) {
    float xv[VPT][8], gv[VPT][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < nvec) {
        Vec8<TX>::unpack(nx[i], xv[i]);
        Vec8<TX>::unpack(ndy[i], gv[i]);
        if (r + 1 < r1) {  // the next row's loads, in flight through the barriers
          nx[i] = Vec8<TX>::load_raw(x + (r + 1) * x_rs + 8 * c);
          ndy[i] = Vec8<TX>::load_raw(dy + (r + 1) * dy_rs + 8 * c);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) s += xv[i][e];
      }
    }
    const float mu = block_sum(s, red_mu) / float(d);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (tid + i * blockDim.x < nvec) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[i][e] -= mu;
          ss = fmaf(xv[i][e], xv[i][e], ss);
        }
      }
    }
    const float rstd = 1.f / sqrtf(block_sum(ss, red_var) / float(d) + eps);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (tid + i * blockDim.x < nvec) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[i][e] = __fmul_rn(xv[i][e], rstd);  // x^
          float g = __fmul_rn(gv[i][e], wv[i][e]);
          if (round_dyw) g = Vec8<TX>::round(g);
          c1 += g;
          c2 = fmaf(g, xv[i][e], c2);
        }
      }
    }
    block_sum2(c1, c2, red_c);
    c1 /= float(d);
    c2 /= float(d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < nvec) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float g = __fmul_rn(gv[i][e], wv[i][e]);
          if (round_dyw) g = Vec8<TX>::round(g);
          o[e] = (g - c1 - xv[i][e] * c2) * rstd;
          acc_w[i][e] = __fadd_rn(acc_w[i][e], __fmul_rn(gv[i][e], xv[i][e]));
          acc_b[i][e] = __fadd_rn(acc_b[i][e], gv[i][e]);
        }
        Vec8<TX>::store(dx + (long long)r * d + 8 * c, o);
      }
    }
  }

  float* pw = part + (long long)blockIdx.x * d;
  float* pb = part + (long long)(gridDim.x + blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < nvec) {
      Vec8<float>::store(pw + 8 * c, acc_w[i]);
      if (has_b) Vec8<float>::store(pb + 8 * c, acc_b[i]);
    }
  }
}

__device__ __forceinline__ void store_coded(void* p, int code, int col, float v) {
  if (code == 0)
    static_cast<float*>(p)[col] = v;
  else if (code == 1)
    static_cast<__nv_bfloat16*>(p)[col] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(p)[col] = __float2half_rn(v);
}

// blockIdx.y 0: dw from part[0:G], 1: db from part[G:2G]. A block takes
// kSumCols columns: thread (seg, q) sums columns [4q, 4q + 4) over the
// partial rows of segment seg in order, then thread t < kSumCols sums
// column t over the segments in order.
__global__ void __launch_bounds__(kSumSegs * kSumCols / 4) layernorm_bwd_sum_kernel(
    const float* __restrict__ part, void* __restrict__ dw, void* __restrict__ db, int G, int d,
    int codes) {
  __shared__ float seg_sum[kSumSegs][kSumCols];
  const int tid = threadIdx.x, seg = tid / (kSumCols / 4), q = tid % (kSumCols / 4);
  const int col0 = blockIdx.x * kSumCols;
  const float* p = part + (long long)blockIdx.y * G * d;
  const int len = (G + kSumSegs - 1) / kSumSegs;
  const int g0 = min(G, seg * len), g1 = min(G, g0 + len);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int col = col0 + 4 * q;
  if (col < d) {
#pragma unroll 8
    for (int g = g0; g < g1; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(p + (long long)g * d + col);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
  }
  seg_sum[seg][4 * q] = acc.x;
  seg_sum[seg][4 * q + 1] = acc.y;
  seg_sum[seg][4 * q + 2] = acc.z;
  seg_sum[seg][4 * q + 3] = acc.w;
  __syncthreads();
  if (tid < kSumCols && col0 + tid < d) {
    float t = 0.f;
    for (int s = 0; s < kSumSegs; ++s) t = __fadd_rn(t, seg_sum[s][tid]);
    if (blockIdx.y == 0)
      store_coded(dw, (codes >> 2) & 3, col0 + tid, t);
    else
      store_coded(db, codes >> 4, col0 + tid, t);
  }
}

template <typename TX>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w, void* dx, float* part,
                       int rows, int d, long long x_rs, long long dy_rs, int G, int R, int codes,
                       float eps, cudaStream_t s) {
  const int nvec = d / 8, threads = bwd_threads(d);
  const TX* px = static_cast<const TX*>(x);
  const TX* pdy = static_cast<const TX*>(dy);
  TX* pdx = static_cast<TX*>(dx);
  if (nvec <= kBwdMaxThreads)
    layernorm_bwd_kernel<TX, 1><<<G, threads, 0, s>>>(px, pdy, w, pdx, part, rows, d, x_rs, dy_rs,
                                                      R, codes, eps);
  else
    layernorm_bwd_kernel<TX, 2><<<G, threads, 0, s>>>(px, pdy, w, pdx, part, rows, d, x_rs, dy_rs,
                                                      R, codes, eps);
  return cudaGetLastError();
}

}  // namespace

// The widest row each pass takes (the wrapper checks against them).
extern "C" int layernorm_max_width() { return kFwdMaxThreads * 4 * 8; }
extern "C" int layernorm_bwd_max_width() { return kBwdMaxThreads * 2 * 8; }

// The backward's block count for (rows, d); *rows_per_block its run of
// rows (ref.layernorm_bwd_blocks mirrors it).
extern "C" int layernorm_bwd_grid(int rows, int d, int* rows_per_block) {
  return bwd_grid(rows, d, rows_per_block);
}

// fp32 workspace elements that hold the backward's partials at any (rows,
// d): G <= kBwdSMs * per_sm and per_sm * d <= 8 * kBwdResident (threads >=
// d / 8; one block an SM past kBwdMaxThreads vectors, d <= 8 * 1024), two
// arrays with a bias. The wrapper asks for it once, so its workspace does
// not depend on the row count.
extern "C" long long layernorm_bwd_workspace() { return 2LL * kBwdSMs * kBwdResident * 8; }

// x (rows, d) with row stride x_rs in elements, y (rows, d) contiguous, w
// and b (d,) contiguous, b may be null. dtypes = x's code | w's << 2 | b's
// << 4, each 0 fp32, 1 bf16, 2 fp16 (b's 3 when there is none; few
// arguments: the host's cost of a ctypes call grows with them). d a
// multiple of 8 up to layernorm_max_width(), rows >= 1, every row 16-byte
// aligned. Returns the cudaError_t of the launch (0 = launched).
extern "C" int layernorm(const void* x, const void* w, const void* b, void* y, int rows, int d,
                         long long x_rs, int dtypes, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 || d > layernorm_max_width()) return cudaErrorInvalidValue;
  const int x_code = dtypes & 3, codes = dtypes >> 2;
  if ((codes & 3) == kNone || (codes >> 2) > kNone || ((codes >> 2) != kNone) != (b != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_code == 0) return launch_fwd<float>(x, w, b, y, rows, d, x_rs, codes, eps, s);
  if (x_code == 1) return launch_fwd<__nv_bfloat16>(x, w, b, y, rows, d, x_rs, codes, eps, s);
  if (x_code == 2) return launch_fwd<__half>(x, w, b, y, rows, d, x_rs, codes, eps, s);
  return cudaErrorInvalidValue;
}

// The gradient of layernorm: x and dy (rows, d) with row strides x_rs and
// dy_rs in elements and x's dtype, w (d,), dx (rows, d) contiguous, dw
// (d,) in w's dtype, db (d,) in b's dtype or null without a bias; part a
// fp32 workspace of ws_elems >= (2 with a bias, else 1) * G * d elements,
// G = layernorm_bwd_grid(rows, d) (layernorm_bwd_workspace() always is). dtypes as layernorm's; d a multiple of
// 8 up to layernorm_bwd_max_width(), rows >= 1, every row 16-byte aligned.
// Two launches; returns the first cudaError_t (0 = launched).
extern "C" int layernorm_bwd(const void* x, const void* dy, const void* w, void* dx, void* dw,
                             void* db, float* part, long long ws_elems, int rows, int d,
                             long long x_rs, long long dy_rs, int dtypes, float eps,
                             void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 || d > layernorm_bwd_max_width()) return cudaErrorInvalidValue;
  const int x_code = dtypes & 3, w_code = (dtypes >> 2) & 3, b_code = dtypes >> 4;
  if (w_code == kNone || b_code > kNone || (b_code != kNone) != (db != nullptr))
    return cudaErrorInvalidValue;
  int R;
  const int G = bwd_grid(rows, d, &R);
  if ((long long)(b_code != kNone ? 2 : 1) * G * d > ws_elems) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_code == 0)
    err = launch_bwd<float>(x, dy, w, dx, part, rows, d, x_rs, dy_rs, G, R, dtypes, eps, s);
  else if (x_code == 1)
    err = launch_bwd<__nv_bfloat16>(x, dy, w, dx, part, rows, d, x_rs, dy_rs, G, R, dtypes, eps,
                                    s);
  else if (x_code == 2)
    err = launch_bwd<__half>(x, dy, w, dx, part, rows, d, x_rs, dy_rs, G, R, dtypes, eps, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + kSumCols - 1) / kSumCols, b_code != kNone ? 2 : 1);
  layernorm_bwd_sum_kernel<<<grid, kSumSegs * kSumCols / 4, 0, s>>>(part, dw, db, G, d, dtypes);
  return cudaGetLastError();
}
