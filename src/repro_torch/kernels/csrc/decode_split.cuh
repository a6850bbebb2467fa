// The flash-decoding split and combine bodies shared by flash_decode.cu (a
// dense KV cache) and paged_attention.cu (pools read through a block table).
//
// One query token a row, bf16 in, fp32 softmax: the cache is cut into fixed
// 256-key chunks, one block a (row, kv head, chunk) holding the group's
// query heads (the chunk size fixed, a row's split depends on neither the
// batch nor the other rows; chunks at or past the row's length return
// before any load). Four warps take the chunk's 16-key stages in turn
// (warp w: stages w, w + 4, ...), each streaming them through its own ring
// of kStages shared-memory stages (K and V of one stage) with 16-byte
// cp.async copies; rows past the length are zero-filled, not read. A
// stage's K and V are consumed together with an online softmax (fp32 m and
// l, expf): S = Q K^T and O += P V on the tensor cores as mma.sync
// m16n8k16, the group's query heads on M padded to 16 rows with zeros, P
// rounded to bf16 from the S accumulators in registers, V's fragments read
// with ldmatrix.trans. The four warps merge (m, l, O) through shared memory
// in warp order, the block writes fp32 partials (m, l, acc) for its chunk,
// and the combine kernel merges a (row, head)'s partials in chunk order. No
// atomics: a step repeats bit for bit.
//
// Only the address of a stage differs between the callers, so the split
// body is a template on an addressing policy with one member,
//   stage(dstK, dstV, b, hk, k0, key0, n, lane)
// which copies the chunk's rows [key0, key0 + 16) (rows at or past n
// zero-filled). The arithmetic, the stage order and the merges are the
// same, so a paged row gives bit for bit what the dense kernel gives on
// the same rows.
#pragma once

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {
namespace decode {

constexpr int kChunk = 256;   // keys per split
constexpr int kSub = 16;      // keys per ring stage
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;    // ring stages per warp
constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1e30f;
using T = __nv_bfloat16;  // every served config runs in bf16

// what both callers share: the query, the lengths, the output, the fp32
// partials (m, l: B*H*splits each; acc: B*H*splits*D)
struct Split {
  const uint16_t* q;
  const int* lengths;
  uint16_t* o;
  float* part_m;
  float* part_l;
  float* part_acc;
  int T;  // the cache's capacity in rows: lengths are clamped to it
  int H, group, splits;
  long long q_sb, q_sh, o_sb, o_sh;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

__device__ __forceinline__ int row_length(const Split& p, int b) {
  return min(max(p.lengths[b], 0), p.T);
}

// shared memory of one block: each warp's ring (K and V of kStages
// sub-tiles, rows of D + kPad), later reused for the warps' O to merge
template <int D>
struct Smem {
  static constexpr int kPitch = D + kPad;
  static constexpr int kTile = kSub * kPitch;              // 16-bit elements
  static constexpr int kRing = kStages * 2 * kTile;        // a warp's ring
  static constexpr int kOPitch = D + 8;                    // fp32 merge rows
  static constexpr int kRingBytes = kWarps * kRing * 2;
  static constexpr int kMergeBytes = kWarps * 16 * kOPitch * 4;
  static constexpr int kBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

// one warp copies rows [key0, key0 + kSub) of a strided matrix at `base`
// into a stage; rows at or past `end` are zero-filled without a read
template <int D>
__device__ __forceinline__ void kv_stage(uint16_t* dst, const uint16_t* base, long long row_stride,
                                         int key0, int end, int lane) {
  constexpr int kPerRow = D / 8;  // 16-byte pieces
#pragma unroll
  for (int i = 0; i < kSub * kPerRow / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / kPerRow, col = (c % kPerRow) * 8;
    const bool live = key0 + r < end;
    cp_async16(dst + r * Smem<D>::kPitch + col,
               base + (long long)(live ? key0 + r : key0) * row_stride + col, live);
  }
}

template <int D, typename Addr>
__device__ __forceinline__ void split_body(const Split& p, const Addr& addr, uint8_t* smem) {
  __shared__ float sM[kWarps][16], sL[kWarps][16];
  using S = Smem<D>;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = row_length(p, b);
  const int k0 = split * kChunk;
  if (k0 >= len) return;  // past the row's length: no loads, no partials
  const int n = min(kChunk, len - k0);
  const int grp = p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  uint16_t* ring = reinterpret_cast<uint16_t*>(smem) + warp * S::kRing;
  const int nsub = (n + kSub - 1) / kSub;
  const int mine = warp < nsub ? (nsub - warp + kWarps - 1) / kWarps : 0;

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < mine)
      addr.template stage<D>(ring + 2 * st * S::kTile, ring + (2 * st + 1) * S::kTile, b, hk, k0,
                             (warp + st * kWarps) * kSub, n, lane);
    cp_async_commit();
  }

  // Q as the A operand: rows g and g + 8 are query heads hk * group + row,
  // zero past the group
  uint32_t qa[D / 16][4];
  {
    const uint16_t* q0 = p.q + b * p.q_sb + (long long)(hk * grp) * p.q_sh;
    const bool r0 = g < grp, r1 = g + 8 < grp;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = r0 ? *reinterpret_cast<const uint32_t*>(q0 + g * p.q_sh + c) : 0u;
      qa[kk][1] = r1 ? *reinterpret_cast<const uint32_t*>(q0 + (g + 8) * p.q_sh + c) : 0u;
      qa[kk][2] = r0 ? *reinterpret_cast<const uint32_t*>(q0 + g * p.q_sh + c + 8) : 0u;
      qa[kk][3] = r1 ? *reinterpret_cast<const uint32_t*>(q0 + (g + 8) * p.q_sh + c + 8) : 0u;
    }
  }

  // this thread's rows g (index 0) and g + 8 (index 1): running max, its
  // columns' share of the sum, and O's columns 8 j + 2 t, + 1
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < mine; ++it) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int st = it % kStages;
    const uint16_t* sK = ring + 2 * st * S::kTile;
    const uint16_t* sV = sK + S::kTile;
    const int key0 = (warp + it * kWarps) * kSub;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b0, b1;
        b_frag_rows<D>(b0, b1, sK, nt * 8, kk * 16, g, t);
        Mma<T>::run(s[nt], qa[kk], b0, b1);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (key0 + nt * 8 + 2 * t + (e & 1) >= n) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        ps[e >> 1] += s[nt][e];
      }
    }
    l[0] = l[0] * alpha[0] + ps[0];
    l[1] = l[1] * alpha[1] + ps[1];
    // P as the A operand (16 heads x 16 keys) straight from S's registers
    const uint32_t pa[4] = {Mma<T>::pack(s[0][0], s[0][1]), Mma<T>::pack(s[0][2], s[0][3]),
                            Mma<T>::pack(s[1][0], s[1][1]), Mma<T>::pack(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t vb[4];
      b_frag_cols_x2<D>(vb, sV, 0, j * 8, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* c = o[j + h];
        c[0] *= alpha[0];
        c[1] *= alpha[0];
        c[2] *= alpha[1];
        c[3] *= alpha[1];
        Mma<T>::run(o[j + h], pa, vb[2 * h], vb[2 * h + 1]);
      }
    }
    __syncwarp();  // every lane is done with this stage: refill it
    const int next = it + kStages;
    if (next < mine)
      addr.template stage<D>(ring + 2 * st * S::kTile, ring + (2 * st + 1) * S::kTile, b, hk, k0,
                             (warp + next * kWarps) * kSub, n, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the four warps in warp order: row max M, each warp's O scaled by
  // exp(m_w - M), summed; l likewise
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t == 0) {
    sM[warp][g] = m[0];
    sM[warp][g + 8] = m[1];
    sL[warp][g] = l[0];
    sL[warp][g + 8] = l[1];
  }
  __syncthreads();  // (m, l) written; every warp done with its ring
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sM[w][g + 8 * r]);
    f[r] = expf(m[r] - mm);
  }
  float* sO = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<float2*>(&sO[(warp * 16 + g) * S::kOPitch + col]) =
        make_float2(o[j][0] * f[0], o[j][1] * f[0]);
    *reinterpret_cast<float2*>(&sO[(warp * 16 + g + 8) * S::kOPitch + col]) =
        make_float2(o[j][2] * f[1], o[j][3] * f[1]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < grp * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sO[(w * 16 + h) * S::kOPitch + d];
    const long long idx = (long long)(b * p.H + hk * grp + h) * p.splits + split;
    p.part_acc[idx * D + d] = acc;
    if (d == 0) {
      float mm = kNegInf, ll = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sM[w][h]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ll += sL[w][h] * expf(sM[w][h] - mm);
      p.part_m[idx] = mm;
      p.part_l[idx] = ll;
    }
  }
}

// one block per (row, query head), D / 2 threads of two columns each: the
// live splits combined in split order
template <int D>
__device__ __forceinline__ void combine_body(const Split& p) {
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

// The splits a cache of T rows is cut into.
__host__ __device__ inline int splits_of(int T) { return (T + kChunk - 1) / kChunk; }

// Fill the shared fields of a Split; the caller sets T and splits.
inline Split make_split(const void* q, const int* lengths, void* out, float* part_m,
                        float* part_l, float* part_acc, int H, int Hkv, int D, long long q_sb,
                        long long q_sh, long long o_sb, long long o_sh, float softcap) {
  Split p;
  p.q = static_cast<const uint16_t*>(q);
  p.lengths = lengths;
  p.o = static_cast<uint16_t*>(out);
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.H = H;
  p.group = H / Hkv;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  return p;
}

}  // namespace decode
}  // namespace
