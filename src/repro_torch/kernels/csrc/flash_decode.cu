// Flash-decoding for Hopper (sm_90a): one query token per row against a
// dense KV cache, bf16 in, fp32 softmax.
//
// Replaces the TPU kernel `_fd_kernel` behind `flash_decode` in
// src/repro/kernels/flash_decode.py (its pallas_call). Same contract:
// q (B,1,H,D), k/v (B,T,Hkv,D), lengths (B,) -> out (B,1,H,D) in q's dtype;
// scale 1/sqrt(D); optional logit softcap; keys at positions >= length are
// masked; GQA as query head h reading kv head h / group; a row with length
// 0 (an idle serving slot) gives exactly 0.
//
// Design. The TPU kernel walks the cache along a sequential grid axis of
// 512-key blocks and carries (m, l, acc) in VMEM scratch. Hopper blocks run
// in no order, so the cache is split instead (flash-decoding): grid
// (splits, Hkv, B), one block per (row, kv head, 256-key chunk), holding the
// group's query heads. The chunk size is fixed, so the split of a row
// depends on neither the batch nor the other rows: a request's bits do not
// move with its batch mates. A block computes the exact softmax of its
// chunk (scores staged in shared memory: no online rescaling inside the
// block) and writes fp32 partials (m, l, acc); a second small kernel
// combines the partials of each (row, head) in split order. No atomics, so a
// step repeats bit for bit. Blocks whose chunk starts at or past the row's
// length return before any load, and the combine reads only the live
// splits. The QK and PV products are fp32 FMAs on the CUDA cores: a panel
// of `group` (7 for Qwen2) query rows underfills an mma tile, and the
// kernel is bound by memory. K and V tiles go through shared memory in
// 16-byte vector loads; P stays fp32 (the plain version rounds the
// normalized P to the input dtype, as the reference's XLA path does).
//
// Bound on an H100 SXM (3.35 TB/s): memory. Each live cache row is read
// once for K and once for V: at Qwen2-7B's decode shape (B=32, T=2048,
// Hkv=4, D=128 bf16) a full cache is 134 MB (40 us); a ragged batch reads
// sum(lengths) * Hkv * D * 4 B. The FMAs (4 * H * D per live key) are a
// third of what the CUDA cores do in that time.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kChunk = 256;   // keys per split
constexpr int kTile = 64;     // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1e30f;
using T = __nv_bfloat16;  // every served config runs in bf16

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const int* lengths;
  uint16_t* o;
  float* part_m;    // (B*H, splits)
  float* part_l;    // (B*H, splits)
  float* part_acc;  // (B*H, splits, D)
  int T, H, group, splits;
  long long q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

__device__ __forceinline__ int row_length(const Params& p, int b) {
  return min(max(p.lengths[b], 0), p.T);
}

// cache rows [row0, row0 + kTile) into shared memory; rows >= row_end are
// zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[D + kPad], const uint16_t* base,
                                          long long row_stride, int row0, int row_end) {
  constexpr int kVec = 8;  // 8 x 16 bit = one 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < row_end)
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sKV[kTile][D + kPad];
  __shared__ __align__(16) float sQ[kMaxGroup][D];
  __shared__ __align__(16) float sS[kMaxGroup][kChunk];
  __shared__ float sM[kMaxGroup], sL[kMaxGroup];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = row_length(p, b);
  const int k0 = split * kChunk;
  if (k0 >= len) return;  // past the row's length: no loads, no partials
  const int k_end = min(k0 + kChunk, len);
  const int n = k_end - k0;
  const int n_pad = (n + kTile - 1) / kTile * kTile;
  const int g = p.group, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < g * D; i += kThreads) {
    const int h = i / D, d = i % D;
    sQ[h][d] = Mma<T>::to_float(p.q[b * p.q_sb + (hk * g + h) * p.q_sh + d]);
  }
  const uint16_t* kbase = p.k + b * p.k_sb + hk * p.k_sh;
  const uint16_t* vbase = p.v + b * p.v_sb + hk * p.v_sh;

  // scores: thread tid owns key tid % kTile of each tile and the heads
  // h = tid / kTile + 2i
  const int j = tid % kTile, hset = tid / kTile;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();  // sQ written; the previous tile's readers done
    load_tile<D>(sKV, kbase, p.k_st, k0 + t0, k_end);
    __syncthreads();
    if (t0 + j >= n) continue;
    float acc[kMaxGroup / 2];
#pragma unroll
    for (int i = 0; i < kMaxGroup / 2; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(&sKV[j][c]);
      const uint16_t* kh = reinterpret_cast<const uint16_t*>(&raw);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = Mma<T>::to_float(kh[e]);
#pragma unroll
      for (int i = 0; i < kMaxGroup / 2; ++i) {
        const int h = hset + 2 * i;
        if (h < g) {
          const float4 qa = *reinterpret_cast<const float4*>(&sQ[h][c]);
          const float4 qb = *reinterpret_cast<const float4*>(&sQ[h][c + 4]);
          float s = acc[i];
          s = fmaf(qa.x, kf[0], s);
          s = fmaf(qa.y, kf[1], s);
          s = fmaf(qa.z, kf[2], s);
          s = fmaf(qa.w, kf[3], s);
          s = fmaf(qb.x, kf[4], s);
          s = fmaf(qb.y, kf[5], s);
          s = fmaf(qb.z, kf[6], s);
          s = fmaf(qb.w, kf[7], s);
          acc[i] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxGroup / 2; ++i) {
      const int h = hset + 2 * i;
      if (h < g) {
        float s = acc[i] * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        sS[h][t0 + j] = s;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per head: p = exp(s - m) in place, zero
  // past n up to the tile edge; (m, l) to shared memory
  for (int h = warp; h < g; h += kThreads / 32) {
    float mx = kNegInf;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sS[h][t]);
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < n_pad; t += 32) {
      const float e = t < n ? expf(sS[h][t] - mx) : 0.f;
      sS[h][t] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      sM[h] = mx;
      sL[h] = sum;
    }
  }

  // O = P V: thread tid owns column d = tid % D of the heads
  // h = tid / D + kSets * i
  constexpr int kSets = kThreads / D;
  constexpr int kPerThread = kMaxGroup / kSets;
  const int d = tid % D, oset = tid / D;
  float o[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) o[i] = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();  // the softmax is done; the previous tile's readers done
    load_tile<D>(sKV, vbase, p.v_st, k0 + t0, k_end);
    __syncthreads();
    for (int t = 0; t < kTile; t += 4) {
      float vf[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vf[e] = Mma<T>::to_float(sKV[t + e][d]);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int h = oset + kSets * i;
        if (h < g) {
          const float4 pr = *reinterpret_cast<const float4*>(&sS[h][t0 + t]);
          float s = o[i];
          s = fmaf(pr.x, vf[0], s);
          s = fmaf(pr.y, vf[1], s);
          s = fmaf(pr.z, vf[2], s);
          s = fmaf(pr.w, vf[3], s);
          o[i] = s;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int h = oset + kSets * i;
    if (h < g) {
      const long long idx = (long long)(b * p.H + hk * g + h) * p.splits + split;
      p.part_acc[idx * D + d] = o[i];
      if (d == 0) {
        p.part_m[idx] = sM[h];
        p.part_l[idx] = sL[h];
      }
    }
  }
}

// one block per (row, query head), D / 2 threads of two columns each: the
// live splits combined in split order
template <int D>
__global__ void __launch_bounds__(D / 2) flash_decode_combine_kernel(const Params p) {
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int ns = (row_length(p, b) + kChunk - 1) / kChunk;
  const float* m = p.part_m + (long long)bh * p.splits;
  const float* l = p.part_l + (long long)bh * p.splits;
  const float* acc = p.part_acc + (long long)bh * p.splits * D;
  const int d = 2 * threadIdx.x;
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, m[s]);
  float sum = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float w = expf(m[s] - mx);
    sum = fmaf(l[s], w, sum);
    a0 = fmaf(acc[s * D + d], w, a0);
    a1 = fmaf(acc[s * D + d + 1], w, a1);
  }
  const bool empty = ns == 0 || mx <= kNegInf / 2;
  const float denom = fmaxf(sum, 1e-30f);
  *reinterpret_cast<uint32_t*>(p.o + b * p.o_sb + h * p.o_sh + d) =
      Mma<T>::pack(empty ? 0.f : a0 / denom, empty ? 0.f : a1 / denom);
}

template <int D>
cudaError_t launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
  flash_decode_split_kernel<D><<<dim3(p.splits, Hkv, B), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<D><<<B * p.H, D / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The number of splits a cache of T rows is cut into (the wrapper sizes
// the partials with it).
extern "C" int flash_decode_splits(int T) { return (T + kChunk - 1) / kChunk; }

// bf16 operands. Strides are in elements; the head dim is
// contiguous; out is written through its batch and head strides. part_m,
// part_l and part_acc are fp32 scratch of B*H*splits (and *D) elements.
// Returns the cudaError_t of the launches (0 = launched).
extern "C" int flash_decode(
    const void* q, const void* k, const void* v, const int* lengths, void* out,
    float* part_m, float* part_l, float* part_acc,
    int B, int T, int H, int Hkv, int D,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_sh, float softcap, void* stream) {
  if (Hkv <= 0 || H % Hkv || H / Hkv > kMaxGroup) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.lengths = lengths;
  p.o = static_cast<uint16_t*>(out);
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.T = T;
  p.H = H;
  p.group = H / Hkv;
  p.splits = flash_decode_splits(T);
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(p, B, Hkv, s);
  if (D == 128) return launch<128>(p, B, Hkv, s);
  return cudaErrorInvalidValue;
}
