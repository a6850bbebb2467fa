// Fused per-row sampling for Hopper (sm_90a): temperature, top-k and top-p
// by dual bisection, and counter-hash Gumbel-max.
//
// Replaces the TPU kernel `_sample_kernel` behind `fused_sample` in
// src/repro/kernels/sampling.py (its pallas_call). Same contract: logits
// (B,V) (masked vocabulary at -1e30), per-row temperature (<= 0: greedy),
// top_k (0: off), top_p (1: off), seed and generation step -> tok (B,) int32
// and logp (B,) fp32, the chosen token's log-probability under the kept,
// temperature-scaled, renormalized distribution. The row math is the
// reference's `_sample_rows`: z = x / t on the valid columns; the top-k and
// top-p thresholds by a 32-step bisection over [min z, max z + 1] that keeps
// count(z >= lo_k) >= k and mass(z >= lo_p) >= p * Z; kept set z >= min(
// max(lo_k, lo_p), max z); noise -log(-log u) with u from the murmur3 fmix32
// hash of (seed, step, vocab id); the first index of the largest z + noise.
// A greedy row keeps every valid column and adds no noise, so it returns
// the first-index argmax; it skips the bisection and the hash, as the
// reference's lax.cond does, decided here per row on the device.
//
// Design. One block of 1024 threads per row. The TPU kernel holds the row
// in VMEM; the 152064-column bf16 row of Qwen2 (304 KB; 608 KB as fp32)
// does not fit in shared memory (228 KB), so every pass re-reads the row (from L2 after the first):
// pass 1 finds max z and min z, pass 2 the softmax mass Z, each bisection
// step one pass that counts z >= mid_k and sums the mass of z >= mid_p
// together, and a last pass the Gumbel argmax and the kept mass. Block
// reductions go through warp shuffles and a fixed tree, so the result
// repeats bit for bit. The uint32 hash is plain unsigned arithmetic;
// expf and logf (not the fast intrinsics) keep the noise and the masses
// equal to the plain PyTorch version's on the card; the sums differ from it
// only in order. The top-k bisection is skipped when top_k is off (its
// threshold then stays min z exactly).
//
// Bound on an H100 SXM: memory, once. The row is read once and two scalars
// written: at Qwen2-7B's decode shape (32, 152064) bf16 that is 9.7 MB,
// 2.9 us. The ~34 passes of a sampled row (division and exp per element
// per pass) on one SM per row keep this design far above that bound; a
// cluster of blocks per row holding the row in distributed shared memory
// is the later design.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 32;
constexpr float kNegInf = -1e30f;

struct Params {
  const uint16_t* logits;  // bf16 bits
  const float* temp;
  const int* top_k;
  const float* top_p;
  const uint32_t* seed;
  const uint32_t* step;
  int* tok;
  float* logp;
  int V;
  long long row_stride;
};

__device__ __forceinline__ float load(const uint16_t* row, long long i) {
  return Mma<__nv_bfloat16>::to_float(row[i]);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// block-wide reductions; every thread gets the result. The lane partials
// go through a fixed tree, so the result does not depend on timing.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op, float ident) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : ident;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// (value, index) of the largest value, the smaller index on ties
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads) fused_sample_kernel(const Params p) {
  __shared__ float red[kWarps];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int row = blockIdx.x, tid = threadIdx.x, V = p.V;
  const uint16_t* x = p.logits + (long long)row * p.row_stride;
  const float temp = p.temp[row];
  const bool greedy = temp <= 0.f;
  const float t = greedy ? 1.f : temp;

  // pass 1: m = max of z over all columns (masked ones count -1e30), and
  // the min over the valid ones; mn = min over valid of z, or m if none
  float mx = -INFINITY, mn_valid = INFINITY, any_valid = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float xi = load(x, i);
    if (xi > kNegInf * 0.5f) {
      const float z = xi / t;
      mx = fmaxf(mx, z);
      mn_valid = fminf(mn_valid, z);
      any_valid = 1.f;
    } else {
      mx = fmaxf(mx, kNegInf);
    }
  }
  const float m = block_reduce(mx, red, Max(), -INFINITY);
  mn_valid = block_reduce(mn_valid, red, Min(), INFINITY);
  const float mn = block_reduce(any_valid, red, Max(), 0.f) > 0.f ? mn_valid : m;

  // pass 2: Z = sum of exp(z - m) over the valid columns
  float zs = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float xi = load(x, i);
    if (xi > kNegInf * 0.5f) zs += expf(xi / t - m);
  }
  const float Z = block_reduce(zs, red, Add(), 0.f);

  float tau = mn;
  uint32_t h0 = 0;
  if (!greedy) {
    const int tk = p.top_k[row];
    const float k = float(tk <= 0 ? V : min(max(tk, 1), V));
    const float pZ = fminf(fmaxf(p.top_p[row], 1e-9f), 1.f) * Z;
    const bool k_on = tk > 0 && tk < V;
    float lo_k = mn, hi_k = m + 1.f, lo_p = mn, hi_p = m + 1.f;
    for (int it = 0; it < kIters; ++it) {
      const float mid_k = 0.5f * (lo_k + hi_k), mid_p = 0.5f * (lo_p + hi_p);
      float cnt = 0.f, mass = 0.f;
      for (int i = tid; i < V; i += kThreads) {
        const float xi = load(x, i);
        const bool valid = xi > kNegInf * 0.5f;
        const float z = valid ? xi / t : kNegInf;
        if (k_on && z >= mid_k) cnt += 1.f;
        if (valid && z >= mid_p) mass += expf(z - m);
      }
      if (k_on) {
        cnt = block_reduce(cnt, red, Add(), 0.f);
        if (cnt >= k) lo_k = mid_k; else hi_k = mid_k;
      }
      mass = block_reduce(mass, red, Add(), 0.f);
      if (mass >= pZ) lo_p = mid_p; else hi_p = mid_p;
    }
    tau = fminf(fmaxf(lo_k, lo_p), m);
    h0 = fmix32(fmix32(p.seed[row] + 0x9E3779B9u) ^ (p.step[row] * 0x85EBCA77u));
  }

  // last pass: the first index of the largest z + noise over the kept set,
  // and the kept mass
  float best = -INFINITY, zf = 0.f;
  int best_i = V;
  for (int i = tid; i < V; i += kThreads) {
    const float xi = load(x, i);
    const bool valid = xi > kNegInf * 0.5f;
    const float z = valid ? xi / t : kNegInf;
    float y = kNegInf;
    if (valid && z >= tau) {
      float g = 0.f;
      if (!greedy) {
        const uint32_t u = fmix32(h0 ^ (uint32_t(i) * 0x9E3779B1u));
        const float uf = (float(u >> 8) + 0.5f) * (1.0f / 16777216.0f);
        g = -logf(-logf(uf));
      }
      y = z + g;
      zf += expf(z - m);
    }
    better(best, best_i, y, i);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    better(best, best_i, __shfl_xor_sync(0xffffffffu, best, o),
           __shfl_xor_sync(0xffffffffu, best_i, o));
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = best_i;
  }
  const float Zf = block_reduce(zf, red, Add(), 0.f);  // its barriers publish red_v, red_i
  if (warp == 0) {
    best = red_v[lane];
    best_i = red_i[lane];
#pragma unroll
    for (int o = 16; o; o >>= 1)
      better(best, best_i, __shfl_xor_sync(0xffffffffu, best, o),
             __shfl_xor_sync(0xffffffffu, best_i, o));
    if (lane == 0) {
      const int tok = best_i < V ? best_i : 0;
      const float xt = load(x, tok);
      const float z_tok = best_i < V && xt > kNegInf * 0.5f ? xt / t : kNegInf;
      p.tok[row] = best_i;
      p.logp[row] = z_tok - m - logf(fmaxf(Zf, 1e-30f));
    }
  }
}

}  // namespace

// bf16 logits (every served config runs in bf16). The vocab dim is
// contiguous; rows are row_stride elements apart. seed and step are uint32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int fused_sample(const void* logits, int B, int V, long long row_stride,
                            const float* temp, const int* top_k, const float* top_p,
                            const uint32_t* seed, const uint32_t* step, int* tok, float* logp,
                            void* stream) {
  Params p;
  p.logits = static_cast<const uint16_t*>(logits);
  p.temp = temp;
  p.top_k = top_k;
  p.top_p = top_p;
  p.seed = seed;
  p.step = step;
  p.tok = tok;
  p.logp = logp;
  p.V = V;
  p.row_stride = row_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_sample_kernel<<<B, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}
