// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w over the
// last dim, fp32 moments, output in x's dtype.
//
// Replaces the TPU kernel `_rmsnorm_kernel` behind `rmsnorm` in
// src/repro/kernels/rmsnorm.py (its pallas_call). Same contract: x (rows, d)
// with any row stride and a contiguous last dim, w (d,), eps; the mean of
// squares in fp32, the product in fp32, one rounding to x's dtype. x is
// fp32, bf16 or fp16; w any of the three, independently of x.
//
// Why CUDA C++ and not Triton: at Qwen2-7B's decode shape (32, 3584) the
// device work is ~1.6 us, and Triton's Python launcher costs ~40x that on
// every call (0.0635 ms back to back on the H100). The norm runs 57 times
// in each decode step, so its cost is the host path: this kernel is
// launched through ctypes with a plain C interface, and its wrapper does
// nothing else but cheap checks and one allocation.
//
// Design. One block per row, one thread per 8-element vector of it (up to
// 1024 threads, then two vectors a thread): 448 threads at d 3584, 640 at
// 5120, 320 at 2560, 32 at Jamba's reduced 256. Each thread holds its
// vectors of x (one 16-byte load each in bf16/fp16, two in fp32) and the
// matching slices of w in registers, both loads issued before any use, so
// x is read once and y written once. The fp32 sum of squares goes through
// warp shuffles, then the warps' partials through shared memory, summed by
// every thread in warp order: the launch shape depends on d alone, so a
// row's bits do not depend on the number of rows. Many short threads keep
// many loads in flight per SM, as the Triton kernel's 16 warps a row did
// (decode_variants.py: 128 threads of four vectors read 13% slower at
// (2048, 3584) over inputs rotated past L2).
// d must be a multiple of 8 and the rows 16-byte aligned (the wrapper
// checks both).
//
// Bound on an H100 SXM (3.35 TB/s): memory. At Qwen2-7B's prefill shape
// (2048, 3584) bf16 the norm moves 29 MB: 8.8 us; at the decode shape 0.46
// MB: 0.14 us, far below a launch and one DRAM round trip (~1.5 us).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxVpt = 2;

// 8 consecutive elements <-> 8 floats
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T>
struct Vec8Half {  // bf16 and fp16: one 16-byte vector
  static __device__ __forceinline__ void load(const T* p, float (&f)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = Mma<T>::to_float(h[e]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(Mma<T>::pack(f[0], f[1]), Mma<T>::pack(f[2], f[3]),
                                              Mma<T>::pack(f[4], f[5]), Mma<T>::pack(f[6], f[7]));
  }
};

template <>
struct Vec8<__nv_bfloat16> : Vec8Half<__nv_bfloat16> {};
template <>
struct Vec8<__half> : Vec8Half<__half> {};

// y is contiguous: its rows are d apart
template <typename TX, typename TW, int VPT>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(const TX* __restrict__ x,
                                                              const TW* __restrict__ w,
                                                              TX* __restrict__ y, int d,
                                                              long long x_rs, float eps) {
  __shared__ float red[kMaxThreads / 32];
  const int nvec = d >> 3, tid = threadIdx.x;
  const TX* xr = x + blockIdx.x * x_rs;
  TX* yr = y + (long long)blockIdx.x * d;

  float v[VPT][8], wv[VPT][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < nvec) {
      Vec8<TX>::load(xr + 8 * c, v[i]);
      Vec8<TW>::load(w + 8 * c, wv[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (tid + i * blockDim.x < nvec) {
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += red[i];
  const float rstd = 1.f / sqrtf(total / float(d) + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < nvec) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = v[i][e] * rstd * wv[i][e];
      Vec8<TX>::store(yr + 8 * c, o);
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d, long long x_rs,
                   float eps, cudaStream_t s) {
  const int nvec = d / 8;
  const int threads = nvec > kMaxThreads ? kMaxThreads : (nvec + 31) / 32 * 32;
  const TX* px = static_cast<const TX*>(x);
  const TW* pw = static_cast<const TW*>(w);
  TX* py = static_cast<TX*>(y);
  if (nvec <= kMaxThreads)
    rmsnorm_kernel<TX, TW, 1><<<rows, threads, 0, s>>>(px, pw, py, d, x_rs, eps);
  else
    rmsnorm_kernel<TX, TW, kMaxVpt><<<rows, threads, 0, s>>>(px, pw, py, d, x_rs, eps);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_w(int w_code, const void* x, const void* w, void* y, int rows, int d,
                     long long x_rs, float eps, cudaStream_t s) {
  if (w_code == 0) return launch<TX, float>(x, w, y, rows, d, x_rs, eps, s);
  if (w_code == 1) return launch<TX, __nv_bfloat16>(x, w, y, rows, d, x_rs, eps, s);
  if (w_code == 2) return launch<TX, __half>(x, w, y, rows, d, x_rs, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The widest row the kernel takes (the wrapper checks against it).
extern "C" int rmsnorm_max_width() { return kMaxThreads * kMaxVpt * 8; }

// x (rows, d) with row stride x_rs in elements, y (rows, d) contiguous, w
// (d,) contiguous. dtypes = x's code | w's code << 2, each 0 fp32, 1 bf16,
// 2 fp16 (few arguments: the host's cost of a ctypes call grows with
// them). d a multiple of 8 up to rmsnorm_max_width(), rows >= 1, every row
// 16-byte aligned. Returns the cudaError_t of the launch (0 = launched).
extern "C" int rmsnorm(const void* x, const void* w, void* y, int rows, int d, long long x_rs,
                       int dtypes, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 || d > rmsnorm_max_width()) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int x_code = dtypes & 3, w_code = dtypes >> 2;
  if (x_code == 0) return launch_w<float>(w_code, x, w, y, rows, d, x_rs, eps, s);
  if (x_code == 1) return launch_w<__nv_bfloat16>(w_code, x, w, y, rows, d, x_rs, eps, s);
  if (x_code == 2) return launch_w<__half>(w_code, x, w, y, rows, d, x_rs, eps, s);
  return cudaErrorInvalidValue;
}
