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
// Design. The TPU kernel holds a row in VMEM and sweeps it 35 times. On
// this card a row (304 KB of bf16 at Qwen2's 152 064 columns, 608 KB as
// fp32 z) does not fit one SM, so a row is spread over a thread-block
// cluster of kCluster blocks on neighbouring SMs. Each block reads its
// slice of the row from HBM once, computes z = x / t there (IEEE division)
// and keeps z in shared memory for every later pass (fp32; a masked column
// is stored as NaN, which no comparison keeps, and counts as -1e30 where
// the reference counts it). A slice longer than the shared memory holds
// keeps its tail in HBM and recomputes z there each pass, so any V works.
// kCluster does not depend on B, so a row's bits do not move with its
// batch mates. With a block an SM (the slices fill shared memory) an H100
// holds 30 clusters of 4: 32 rows take a second wave, whose rows start as
// the first wave's greedy rows finish.
//
// Passes over the slice: the load (max z, min valid z); then the
// bisection, kLevels levels a pass: the midpoints of the next kLevels
// steps depend only on (lo, hi), so one pass evaluates all 2^kLevels - 1
// of them for each search, computed in fp32 as the sequential loop would
// (0.5f * (lo + hi)), and counts (int, exact) and sums the mass of the
// columns at or above each; the walk then descends kLevels levels exactly
// as 32 sequential steps would. The first pass also sums Z and what lies
// at or above hi; later passes carry that count and mass (hi only falls:
// the node whose midpoint becomes hi adds its own), so they read only the
// columns in [lo, hi). The last pass draws the noise for the kept columns
// and finds the first-index argmax of z + noise and the kept mass. A
// sampled row makes 2 + ceil(32 / kLevels) passes, a greedy row 2. The top-k
// search is skipped when top_k is off (its threshold then stays min z
// exactly), both for a greedy row. kLevels = 3 and 1024 threads a block
// were the fastest of the levels and block sizes that decode_variants.py
// measures: four or five levels need more registers than 1024 threads
// leave, and the passes are bound by the instructions they execute, not by
// shared memory.
//
// Reductions: warp shuffles in a fixed butterfly, warps summed in warp
// order, then across the cluster through distributed shared memory: each
// block writes its partials to its own slot, cluster.sync(), and every
// block sums the kCluster slots in rank order, so all blocks hold
// bit-identical totals and walk the same branch. No atomics: a step
// repeats bit for bit. Counts are integers, so the top-k threshold is the
// reference's bit for bit; masses differ from the plain version only in
// summation order. The uint32 hash is plain unsigned arithmetic; expf and
// logf (not the fast intrinsics) keep the noise and the masses equal to
// the plain PyTorch version's on the card. Clusters and distributed shared
// memory are not reachable from Triton, hence CUDA C++.
//
// Bound on an H100 SXM: memory, once. The row is read once and two scalars
// written: at Qwen2-7B's decode shape (32, 152064) bf16 that is 9.7 MB,
// 2.9 us. The passes over shared memory (an expf a column a pass, the
// midpoint loop for the columns still in range) keep the kernel above it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;                    // blocks a row
constexpr int kLevels = 3;                     // bisection levels a pass
// threads a block: as many as the registers of kLevels' midpoints allow
constexpr int kThreads = kLevels <= 3 ? 1024 : kLevels == 4 ? 512 : 256;
constexpr int kWarps = kThreads / 32;
constexpr int kN = 1 << kLevels;               // a search's sums a pass: kN - 1 midpoints, above
constexpr int kNodes = kN - 1;                 // midpoints a pass, a search
constexpr int kIters = 32;
constexpr int kNF = kN + 1;                    // floats a round: the masses, above, Z
constexpr int kNC = kN;                        // ints a round: the counts, above
constexpr int kIntT = 64;                      // the first thread that sums the ints
constexpr float kNegInf = -1e30f;
static_assert(kNF <= kIntT && kIntT + kNC <= kThreads, "a round's sums need a thread each");

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
  int cap;  // columns of a slice held in shared memory
  long long row_stride;
};

__device__ __forceinline__ float bf16(uint16_t v) { return Mma<__nv_bfloat16>::to_float(v); }

// z of one logit: x / t on a valid column, NaN on a masked one
__device__ __forceinline__ float z_of(float x, float t) {
  return x > kNegInf * 0.5f ? x / t : __int_as_float(0x7fffffff);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// (value, index) of the largest value, the smaller index on ties
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// a round's partials: what one block contributes, and the cluster's totals
struct Round {
  float f[kNF];
  int c[kNC];
};

struct Smem {
  float wf[kWarps][kNF];
  int wc[kWarps][kNC];
  Round slot[2];  // this block's partials, double-buffered across rounds
  Round tot;      // the cluster's totals
};

// v[N] of every lane -> lane l holds the warp's sum of value l % N (N a
// power of 2 up to 32). Five butterfly steps: one whose offset o is below
// N halves what a lane carries (the lanes with bit o keep the upper half),
// so a warp sums N values in 31 shuffles, not 5 N. The order of the sums is
// fixed.
template <int N, typename T>
__device__ __forceinline__ T warp_sum_spread(T (&v)[N], int lane) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    if (o < N) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const T send = up ? v[i] : v[i + o];
        const T keep = up ? v[i + o] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
  }
  return v[0];
}

// Sum a pass's kN masses (f), kN counts (c, when `counts`) and Z (when
// `with_z`) over every thread of the cluster: warps by warp_sum_spread,
// warps in order, blocks in rank order, so every thread of every block of
// the cluster gets bit-identical totals in s.tot. `buf` alternates between
// rounds: a block rewrites a slot only after the next round's
// cluster.sync, which every block passes only once it has read the slot.
__device__ __forceinline__ void cluster_sum(float (&f)[kN], int (&c)[kN], float z, bool counts,
                                            bool with_z, Smem& s, int buf,
                                            cg::cluster_group& cluster) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float fv = warp_sum_spread(f, lane);
  if (lane < kN) s.wf[warp][lane] = fv;
  if (counts) {
    const int cv = warp_sum_spread(c, lane);
    if (lane < kN) s.wc[warp][lane] = cv;
  }
  if (with_z) {
#pragma unroll
    for (int o = 16; o; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (lane == 0) s.wf[warp][kN] = z;
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int nf = with_z ? kNF : kN;
  if (t < nf) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += s.wf[w][t];
    s.slot[buf].f[t] = v;
  } else if (counts && t >= kIntT && t < kIntT + kNC) {
    int v = 0;
    for (int w = 0; w < kWarps; ++w) v += s.wc[w][t - kIntT];
    s.slot[buf].c[t - kIntT] = v;
  }
  cluster.sync();
  if (t < nf) {  // the kCluster reads in flight together, summed in rank order
    float part[kCluster], v = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) part[r] = cluster.map_shared_rank(&s.slot[buf], r)->f[t];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += part[r];
    s.tot.f[t] = v;
  } else if (counts && t >= kIntT && t < kIntT + kNC) {
    int part[kCluster], v = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      part[r] = cluster.map_shared_rank(&s.slot[buf], r)->c[t - kIntT];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += part[r];
    s.tot.c[t - kIntT] = v;
  }
  __syncthreads();
}

// fn(column of the slice, z) for each of this thread's columns: those held
// in shared memory, then the tail re-read from HBM
template <typename Fn>
__device__ __forceinline__ void for_cols(const float* sz, int held, int n, const uint16_t* x,
                                         float t, Fn fn) {
  for (int i = threadIdx.x; i < held; i += kThreads) fn(i, sz[i]);
  for (int i = held + threadIdx.x; i < n; i += kThreads) fn(i, z_of(bf16(x[i]), t));
}

__global__ void __launch_bounds__(kThreads, 1) fused_sample_kernel(const Params p) {
  extern __shared__ __align__(16) float sz[];
  __shared__ Smem s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int row = blockIdx.x / kCluster, tid = threadIdx.x, V = p.V;
  // this block's slice [c0, c0 + n): slices of a multiple of 8 columns, so a
  // slice of an aligned row starts 16-byte aligned
  const int slice = ((V + kCluster - 1) / kCluster + 7) & ~7;
  const int c0 = min(rank * slice, V);
  const int n = min(slice, V - c0);
  const int held = min(n, p.cap);
  const uint16_t* xrow = p.logits + (long long)row * p.row_stride;
  const uint16_t* x = xrow + c0;
  const float temp = p.temp[row];
  const bool greedy = temp <= 0.f;
  const float t = greedy ? 1.f : temp;
  int buf = 0;

  // load: z into shared memory; max z over all columns (a masked one counts
  // -1e30), min z over the valid ones, whether any is valid
  float mx = -INFINITY, mn_valid = INFINITY, any = 0.f;
  auto stat = [&](float z) {
    const bool valid = z == z;
    mx = fmaxf(mx, valid ? z : kNegInf);
    if (valid) {
      mn_valid = fminf(mn_valid, z);
      any = 1.f;
    }
  };
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int n8 = n / 8;
#pragma unroll 4
    for (int v = tid; v < n8; v += kThreads) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + 8 * v);
      const uint16_t* h = reinterpret_cast<const uint16_t*>(&raw);
      float z[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        z[e] = z_of(bf16(h[e]), t);
        stat(z[e]);
      }
      if (8 * v + 8 <= held) {
        *reinterpret_cast<float4*>(&sz[8 * v]) = make_float4(z[0], z[1], z[2], z[3]);
        *reinterpret_cast<float4*>(&sz[8 * v + 4]) = make_float4(z[4], z[5], z[6], z[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * v + e < held) sz[8 * v + e] = z[e];
      }
    }
    done = 8 * n8;
  }
  for (int i = done + tid; i < n; i += kThreads) {
    const float z = z_of(bf16(x[i]), t);
    stat(z);
    if (i < held) sz[i] = z;
  }
  float m, mn;
  {
    // max and min by the sum's machinery would round; reduce them exactly
    float f[3] = {mx, -mn_valid, any};
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int o = 16; o; o >>= 1) f[j] = fmaxf(f[j], __shfl_xor_sync(0xffffffffu, f[j], o));
    const int warp = tid >> 5, lane = tid & 31;
    if (lane == 0)
      for (int j = 0; j < 3; ++j) s.wf[warp][j] = f[j];
    __syncthreads();
    if (tid < 3) {
      float v = -INFINITY;
      for (int w = 0; w < kWarps; ++w) v = fmaxf(v, s.wf[w][tid]);
      s.slot[buf].f[tid] = v;
    }
    cluster.sync();
    if (tid < 3) {
      float v = -INFINITY;
      for (int r = 0; r < kCluster; ++r) v = fmaxf(v, cluster.map_shared_rank(&s.slot[buf], r)->f[tid]);
      s.tot.f[tid] = v;
    }
    __syncthreads();
    m = s.tot.f[0];
    mn = s.tot.f[2] > 0.f ? -s.tot.f[1] : m;
    buf ^= 1;
  }

  float tau = mn;
  uint32_t h0 = 0;
  if (!greedy) {
    const int tk = p.top_k[row];
    const float k = float(tk <= 0 ? V : min(max(tk, 1), V));
    const float pf = fminf(fmaxf(p.top_p[row], 1e-9f), 1.f);
    const bool k_on = tk > 0 && tk < V;
    float lo_k = mn, hi_k = m + 1.f, lo_p = mn, hi_p = m + 1.f, pZ = 0.f;
    // what lies at or above hi: its count and mass, carried from pass to
    // pass (hi only falls), so a later pass reads only the columns in
    // [lo, hi)
    int above_k = 0;
    float above_p = 0.f;
    for (int it = 0; it < kIters; it += kLevels) {
      // the subtree's midpoints in heap order (node 1 the root, children 2i
      // and 2i + 1), each 0.5f * (lo + hi) of its interval
      float mk[kN], mp[kN];
      {
        float lk[kN], hk[kN], lp[kN], hp[kN];
        lk[1] = lo_k, hk[1] = hi_k, lp[1] = lo_p, hp[1] = hi_p;
#pragma unroll
        for (int i = 1; i <= kNodes; ++i) {
          mk[i] = 0.5f * (lk[i] + hk[i]);
          mp[i] = 0.5f * (lp[i] + hp[i]);
          if (2 * i + 1 <= kNodes) {
            lk[2 * i] = lk[i], hk[2 * i] = mk[i], lk[2 * i + 1] = mk[i], hk[2 * i + 1] = hk[i];
            lp[2 * i] = lp[i], hp[2 * i] = mp[i], lp[2 * i + 1] = mp[i], hp[2 * i + 1] = hp[i];
          }
        }
      }
      // f, c: mass and count at or above node j + 1, then ([kNodes]) at or
      // above hi in the first pass (later passes carry it); zs: Z
      float f[kN], zs = 0.f;
      int c[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) f[j] = 0.f, c[j] = 0;
      const bool first = it == 0;
      const float lk0 = lo_k, hk0 = hi_k, lp0 = lo_p, hp0 = hi_p;
      for_cols(sz, held, n, x, t, [&](int, float z) {
        const bool valid = z == z;
        if (k_on) {
          const float zk = valid ? z : kNegInf;
          if (zk >= hk0) {
            if (first) c[kNodes] += 1;
          } else if (zk >= lk0) {
#pragma unroll
            for (int j = 0; j < kNodes; ++j) c[j] += zk >= mk[j + 1];
          }
        }
        if (first ? valid : z < hp0 && z >= lp0) {
          const float e = expf(z - m);
          if (first) {
            zs += e;
            if (z >= hp0) {
              f[kNodes] += e;
              return;
            }
          }
#pragma unroll
          for (int j = 0; j < kNodes; ++j) f[j] += z >= mp[j + 1] ? e : 0.f;
        }
      });
      cluster_sum(f, c, zs, k_on, first, s, buf, cluster);
      buf ^= 1;
      if (first) pZ = pf * s.tot.f[kN];
      if (k_on) above_k += s.tot.c[kNodes];
      above_p += s.tot.f[kNodes];
      // descend as the sequential bisection would; a node's midpoint is
      // 0.5f * (lo + hi) of the interval reached, bit for bit mk / mp. The
      // node whose midpoint becomes hi carries its count and mass on.
      const int levels = min(kLevels, kIters - it);
      int nk = 1, np = 1, hi_nk = 0, hi_np = 0;
      for (int l = 0; l < levels; ++l) {
        if (k_on) {
          const float mid = 0.5f * (lo_k + hi_k);
          if (float(above_k + s.tot.c[nk - 1]) >= k) {
            lo_k = mid;
            nk = 2 * nk + 1;
          } else {
            hi_k = mid;
            hi_nk = nk;
            nk = 2 * nk;
          }
        }
        const float mid = 0.5f * (lo_p + hi_p);
        if (above_p + s.tot.f[np - 1] >= pZ) {
          lo_p = mid;
          np = 2 * np + 1;
        } else {
          hi_p = mid;
          hi_np = np;
          np = 2 * np;
        }
      }
      if (hi_nk) above_k += s.tot.c[hi_nk - 1];
      if (hi_np) above_p += s.tot.f[hi_np - 1];
    }
    tau = fminf(fmaxf(lo_k, lo_p), m);
    h0 = fmix32(fmix32(p.seed[row] + 0x9E3779B9u) ^ (p.step[row] * 0x85EBCA77u));
  }

  // last pass: the first index of the largest z + noise over the kept set,
  // and the kept mass
  float best = -INFINITY, zf = 0.f;
  int best_i = V;
  for_cols(sz, held, n, x, t, [&](int i, float z) {
    const int gi = c0 + i;
    float y = kNegInf;
    if (z >= tau) {  // false for a masked column (NaN)
      float g = 0.f;
      if (!greedy) {
        const uint32_t u = fmix32(h0 ^ (uint32_t(gi) * 0x9E3779B1u));
        const float uf = (float(u >> 8) + 0.5f) * (1.0f / 16777216.0f);
        g = -logf(-logf(uf));
      }
      y = z + g;
      zf += expf(z - m);
    }
    better(best, best_i, y, gi);
  });
#pragma unroll
  for (int o = 16; o; o >>= 1)
    better(best, best_i, __shfl_xor_sync(0xffffffffu, best, o),
           __shfl_xor_sync(0xffffffffu, best_i, o));
  const float bf[2] = {zf, best};
  const int bc[1] = {best_i};
  {
    // zf sums; (best, best_i) takes the better pair, which is exact in any
    // order: each warp's pair rides in the float and int slots of its lane 0
    const int warp = tid >> 5, lane = tid & 31;
    float v = bf[0];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) {
      s.wf[warp][0] = v;
      s.wf[warp][1] = bf[1];
      s.wc[warp][0] = bc[0];
    }
    __syncthreads();
    if (tid == 0) {
      float z = 0.f, bv = -INFINITY;
      int bi = V;
      for (int w = 0; w < kWarps; ++w) {
        z += s.wf[w][0];
        better(bv, bi, s.wf[w][1], s.wc[w][0]);
      }
      s.slot[buf].f[0] = z;
      s.slot[buf].f[1] = bv;
      s.slot[buf].c[0] = bi;
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
      float Zf = 0.f, bv = -INFINITY;
      int bi = V;
      for (int r = 0; r < kCluster; ++r) {
        const Round* o = cluster.map_shared_rank(&s.slot[buf], r);
        Zf += o->f[0];
        better(bv, bi, o->f[1], o->c[0]);
      }
      const int tok = bi < V ? bi : 0;
      const float xt = bf16(xrow[tok]);
      const float z_tok = bi < V && xt > kNegInf * 0.5f ? xt / t : kNegInf;
      p.tok[row] = bi;
      p.logp[row] = z_tok - m - logf(fmaxf(Zf, 1e-30f));
    }
    cluster.sync();  // no block leaves while another reads its slots
  }
}

int g_max_cols = -1;  // columns of z a block can hold, once set up

int setup() {
  if (g_max_cols < 0) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fused_sample_kernel);
    if (err != cudaSuccess) return -int(err);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return -int(err);
    const int bytes = (optin - int(a.sharedSizeBytes)) & ~15;
    err = cudaFuncSetAttribute(fused_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return -int(err);
    g_max_cols = bytes / 4;
  }
  return g_max_cols;
}

}  // namespace

// Blocks a row, the constant the wrapper and the tests read.
extern "C" int fused_sample_cluster() { return kCluster; }

// bf16 logits (every served config runs in bf16). The vocab dim is
// contiguous; rows are row_stride elements apart. seed and step are uint32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int fused_sample(const void* logits, int B, int V, long long row_stride,
                            const float* temp, const int* top_k, const float* top_p,
                            const uint32_t* seed, const uint32_t* step, int* tok, float* logp,
                            void* stream) {
  if (B <= 0 || V <= 0 || B > 0x7fffffff / kCluster) return cudaErrorInvalidValue;
  const int max_cols = setup();
  if (max_cols < 0) return -max_cols;
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
  const int slice = ((V + kCluster - 1) / kCluster + 7) & ~7;
  p.cap = min(slice, max_cols & ~7);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(p.cap) * 4;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fused_sample_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of the kernel can be resident at once at this V (the
// rows a wave takes), or minus a cudaError_t.
extern "C" int fused_sample_max_clusters(int V) {
  const int max_cols = setup();
  if (max_cols < 0) return max_cols;
  const int slice = ((V + kCluster - 1) / kCluster + 7) & ~7;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(min(slice, max_cols & ~7)) * 4;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fused_sample_kernel, &cfg);
  return err == cudaSuccess ? n : -int(err);
}
