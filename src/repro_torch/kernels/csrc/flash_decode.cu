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
// move with its batch mates. Blocks whose chunk starts at or past the row's
// length return before any load.
//
// Inside a block, four warps share the chunk's 16-key sub-tiles, warp w
// taking sub-tiles w, w + 4, ... (balanced when the row ends inside the
// chunk). Each warp streams its sub-tiles through its own ring of
// shared-memory stages (kStages deep, K and V of one sub-tile a stage) with
// 16-byte cp.async copies: the next stages are in flight while the warp
// computes on this one, and a row past the length is zero-filled, not
// read. A sub-tile's K and V are consumed together, in one pass, with an
// online softmax across the warp's sub-tiles (fp32 m and l, expf): S = Q K^T
// and O += P V run on the tensor cores as mma.sync m16n8k16, the group's
// query heads on the M side padded to 16 rows with zeros, P rounded to bf16
// from the S accumulators in registers (the plain version rounds the
// normalized P to bf16 too), V's fragments read with ldmatrix.trans. At the
// end the four warps' (m, l, O) merge through shared memory in warp order,
// and the block writes fp32 partials (m, l, acc) for its chunk; a second
// small kernel combines the partials of each (row, head) in split order. No
// atomics, so a step repeats bit for bit. A stage is 16 keys, one page of
// the paged cache: the row addresses of a stage come from one base pointer
// and the row stride (`kv_stage`), which a block-table lookup can replace.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Each live cache row is read
// once for K and once for V: at Qwen2-7B's decode shape (B=32, T=2048,
// Hkv=4, D=128 bf16) a full cache is 134 MB (40 us); a ragged batch reads
// sum(lengths) * Hkv * D * 4 B. The products (4 * H * D per live key, 16/7
// of that with the padded rows) take ~2 us of the tensor cores.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kChunk = 256;   // keys per split
constexpr int kSub = 16;      // keys per ring stage
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;    // ring stages per warp
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

// one warp copies cache rows [key0, key0 + kSub) of a (row, kv head) into a
// stage; rows at or past `end` are zero-filled without a read
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
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
  const uint16_t* kbase = p.k + b * p.k_sb + hk * p.k_sh + k0 * p.k_st;
  const uint16_t* vbase = p.v + b * p.v_sb + hk * p.v_sh + k0 * p.v_st;
  const int nsub = (n + kSub - 1) / kSub;
  const int mine = warp < nsub ? (nsub - warp + kWarps - 1) / kWarps : 0;

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < mine) {
      const int key0 = (warp + st * kWarps) * kSub;
      kv_stage<D>(ring + 2 * st * S::kTile, kbase, p.k_st, key0, n, lane);
      kv_stage<D>(ring + (2 * st + 1) * S::kTile, vbase, p.v_st, key0, n, lane);
    }
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
    if (next < mine) {
      const int key1 = (warp + next * kWarps) * kSub;
      kv_stage<D>(ring + 2 * st * S::kTile, kbase, p.k_st, key1, n, lane);
      kv_stage<D>(ring + (2 * st + 1) * S::kTile, vbase, p.v_st, key1, n, lane);
    }
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
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  flash_decode_split_kernel<D><<<dim3(p.splits, Hkv, B), kThreads, Smem<D>::kBytes, stream>>>(p);
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
