// Flash-attention backward for Hopper (sm_90a): bf16/fp16 in, fp32 math.
//
// Replaces the TPU kernels behind `flash_attention_bwd` in
// src/repro/kernels/flash_attention.py: `_fa_delta_kernel` (pallas_call at
// :451), `_fa_dq_kernel` (:481) and `_fa_dkv_kernel` (:526). Same contract:
// q, out, dO (B,S,H,D), k/v (B,T,Hkv,D) and the forward's lse (B*H, S) fp32
// -> dq (B,S,H,D), dk/dv (B,T,Hkv,D) in the input dtype; scale 1/sqrt(D);
// mask k_pos < T plus causal / sliding window / q_offset; optional logit
// softcap; GQA as head h reading kv head h / group, with dK/dV summed over
// the group.
//
// Math, per (query row i, key j), as `_recompute_p_ds` does it:
//   s = q_i.k_j * scale;  z = softcap ? softcap*tanh(s/softcap) : s
//   p = mask ? exp(min(z - lse_i, 0)) : 0     (the mask gates p: a fully
//       masked row has lse = -1e30 and would otherwise give exp(0) = 1; the
//       clamp keeps rows with a garbage lse finite)
//   dp = dO_i.v_j;  ds = p*(dp - delta_i) * (softcap ? 1 - t^2 : 1) * scale
//   dq_i = sum_j ds k_j;  dk_j = sum_i ds q_i;  dv_j = sum_i p dO_i
// with delta_i = rowsum(dO_i * O_i) in fp32. Exponentials are taken in base
// 2 with the scale and log2(e) folded in.
//
// Design. The TPU kernels carry dQ across a sequential kv grid axis and
// dK/dV across a sequential (group x q) grid axis in VMEM scratch. Hopper
// blocks run in no order, so each pass owns whole output tiles and loops
// over the input tiles itself, in a fixed order: no sum crosses blocks and
// nothing is added with atomics, so a repeated backward gives the same
// bits, which a repeatable train step and a bit-exact resume need.
//   1. delta: rowsum(dO * O), D/8 threads a row, 16-byte loads.
//   2. dQ pass: a work item is 128 query rows of one (b, h). Q and dO come
//      once, K and V tiles of 64 keys stream through a ring; S = Q K^T and
//      dP = dO V^T by wgmma m64n64k16 (both operands K-major), dS formed
//      in fp32 registers, then dQ += dS K by wgmma with dS as the register
//      A operand and K read MN-major.
//   3. dK/dV pass: a work item is 128 keys of one (b, hkv). K and V come
//      once; the Q and dO tiles (64 rows) with their lse and delta, of
//      every query tile of every head of the GQA group, stream through the
//      ring in a fixed order; S^T = K Q^T and dP^T = V dO^T by wgmma, then
//      dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A and
//      dO, Q read MN-major.
// Both passes are persistent grids of two consumer warpgroups (64 rows of
// the output tile each) and a producer warp (of a warpgroup that gives up
// its registers: the others exit at once) that feeds them through the
// Tensor Memory Accelerator from the caller's strided layouts (4-D tensor
// maps over (D, L, heads, B), boxes of 64 x 64, 128-byte swizzle; rows past
// S or T land as zeros). setmaxnreg moves registers from the producer to
// the consumers: at D = 128 the dK/dV pass holds dK and dV (64 + 64 fp32 a
// thread) beside S^T and dP^T (32 + 32). Under causal masking the dQ pass
// takes its heaviest (last) query tiles first and the dK/dV pass its
// heaviest (first) key tiles first. The mask is applied only on tiles that
// cross S or T, the causal diagonal or the window edge; tiles that no
// entry can see are skipped. bf16 x bf16 products are exact in fp32; P and
// dS are rounded to the input dtype once, before the three products that
// take them (the TPU kernels keep them fp32): at most 2^-9 relative per
// element in bf16, the kernel's stated tolerance. Each warpgroup waits for
// its products at once: deferring the register-A products' wait by one
// tile measured slower on an H100 at both training shapes.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), counted as
// chip_smoke.py counts it: the five products the gradients need (QK^T, dO
// V^T, dQ, dK, dV; the kernels compute the first two in both passes, seven
// in all) are 10*B*H*S*T*D FLOP (the visible half under causal masking),
// against q, k, v, out, dO, lse read once and dq, dk, dv written once. ESM-2 training (B=8, S=T=1024, H=20, D=64): 1.07e11 FLOP,
// 0.109 ms, against 0.13 GB (0.04 ms): operations bound it.
// Llama-4-Scout training (B=2, S=T=1024, 40 q / 8 kv heads, D=128,
// causal, window 8192): 5.4e10 FLOP, 0.054 ms, against 0.04 GB.

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;  // rows of a work item's output tile: two warpgroups of 64
constexpr int kBN = 64;   // rows of a streamed tile: keys (dQ pass) or queries (dK/dV pass)
constexpr int kBox = 64;  // rows and 16-bit columns of one TMA box (128 bytes a row)
constexpr int kConsumers = 2;
// and a producer warpgroup, of which one warp works: setmaxnreg trades
// registers within the block's pool, and ptxas gives these kernels 168 a
// thread, so 384 x 168 = 128 x 24 (producer) + 256 x 240 (consumers)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of a pass: two resident tiles of kBM rows (Q and dO, or K
// and V), then the ring of stages, each two streamed tiles of kBN rows and,
// in the dK/dV pass, their lse * log2(e) and delta * scale (kBN fp32 each,
// in 1024 bytes).
// A tile of R rows x D is D / 64 column halves of R rows x 128 bytes.
template <int D>
struct Layout {
  static constexpr int kResBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;
  static constexpr int kStages = D == 64 ? 6 : 4;
  static constexpr int kSmem = 2 * kResBytes + kStages * kStageBytes + 1024;  // + alignment
};

struct Params {
  const uint16_t* o;
  const uint16_t* dout;
  const float* lse;
  float* delta;
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  int S, T, H, Hkv, group;
  int n_tiles, n_items;  // of the pass being run
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh;
  int causal, window, q_offset;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int key) {
  bool ok = key < p.T;
  if (p.causal) ok = ok && key <= qpos;
  if (p.window > 0) ok = ok && key > qpos - p.window;
  return ok;
}

// s (a raw score) -> p and dp -> ds for one entry, with lse2 = lse *
// log2(e) and dsc = delta * scale: p = 2^min(z log2(e) - lse2, 0), ds = p
// (dp scale - dsc) dz; a masked entry (kMask and !ok) gives 0 and 0
template <bool kSoftcap, bool kMask>
__device__ __forceinline__ void p_ds(const Params& p, bool ok, float lse2, float dsc, float& s,
                                     float& dp) {
  float pr, ds;
  if constexpr (kSoftcap) {
    const float th = tanhf(s * (p.scale / p.softcap));
    pr = ex2(fminf(fmaf(p.softcap * kLog2e, th, -lse2), 0.f));
    ds = pr * fmaf(dp, p.scale, -dsc) * (1.f - th * th);
  } else {
    pr = ex2(fminf(fmaf(s, p.scale * kLog2e, -lse2), 0.f));
    ds = pr * fmaf(dp, p.scale, -dsc);
  }
  s = kMask && !ok ? 0.f : pr;
  dp = kMask && !ok ? 0.f : ds;
}

// the dQ pass's tile: rows are this thread's two query rows, columns keys
template <bool kSoftcap, bool kMask, int N>
__device__ __forceinline__ void dq_tile_p_ds(const Params& p, float (&s)[N], float (&dp)[N],
                                             const float (&lse2)[2], const float (&dsc)[2],
                                             const int (&qpos)[2], int k0, int t) {
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = (x >> 1) & 1;
    const bool ok = !kMask || visible(p, qpos[r], k0 + 8 * (x >> 2) + 2 * t + (x & 1));
    p_ds<kSoftcap, kMask>(p, ok, lse2[r], dsc[r], s[x], dp[x]);
  }
}

// the dK/dV pass's tile: rows are this thread's two keys, columns queries,
// whose lse2 and dsc lie in shared memory (st, st + kBN)
template <bool kSoftcap, bool kMask, int N>
__device__ __forceinline__ void dkv_tile_p_ds(const Params& p, float (&s)[N], float (&dp)[N],
                                              const float* st, int q0, const int (&key)[2],
                                              int t) {
#pragma unroll
  for (int c8 = 0; c8 < N / 4; ++c8) {
    const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * c8 + 2 * t);
    const float2 dc = *reinterpret_cast<const float2*>(st + kBN + 8 * c8 + 2 * t);
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int x = 4 * c8 + y, e = y & 1;
      const int qrow = q0 + 8 * c8 + 2 * t + e;
      const bool ok = !kMask || (qrow < p.S && visible(p, qrow + p.q_offset, key[y >> 1]));
      p_ds<kSoftcap, kMask>(p, ok, e ? l2.y : l2.x, e ? dc.y : dc.x, s[x], dp[x]);
    }
  }
}

// work item i -> (output tile, b*heads): under causal masking tile-major
// with the heaviest tile first (the last query tile in the dQ pass, the
// first key tile in the dK/dV pass), else head-major
__device__ __forceinline__ int2 item_at(const Params& p, int i, bool heavy_last) {
  const int heads = p.n_items / p.n_tiles;
  if (p.causal) {
    const int tile = i / heads;
    return make_int2(heavy_last ? p.n_tiles - 1 - tile : tile, i % heads);
  }
  return make_int2(i % p.n_tiles, i / p.n_tiles);
}

// rows [r0, r0 + R) x all D of the (D, L, heads, B) map into a tile at dst
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int r0, int head,
                                          int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < R / kBox; ++r)
      tma_load(dst + c * R * 128 + r * kBox * 128, map, 64 * c, r0 + r * kBox, head, b, bar);
}

// ---- 1. delta = rowsum(dO * O) in fp32, one (b*h, s) row per D/8 threads
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_attention_bwd_delta_kernel(const Params p,
                                                                        long long rows) {
  constexpr int kPerRow = D / 8;
  const long long row = (long long)blockIdx.x * (256 / kPerRow) + threadIdx.x / kPerRow;
  const int lane = threadIdx.x % kPerRow;
  float acc = 0.f;
  if (row < rows) {
    const int bh = int(row / p.S), s = int(row % p.S), b = bh / p.H, h = bh % p.H;
    const uint4 ov = *reinterpret_cast<const uint4*>(p.o + b * p.o_sb + s * p.o_ss + h * p.o_sh + lane * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(p.dout + b * p.do_sb + s * p.do_ss + h * p.do_sh + lane * 8);
    const uint16_t* oe = reinterpret_cast<const uint16_t*>(&ov);
    const uint16_t* de = reinterpret_cast<const uint16_t*>(&dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += Mma<T>::to_float(oe[i]) * Mma<T>::to_float(de[i]);
  }
#pragma unroll
  for (int off = kPerRow / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) p.delta[row] = acc;
}

// the key tiles [*begin, + n * kBN) that the query tile at q0 (kBM rows) can see
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int* begin) {
  const int q_last = min(q0 + kBM, p.S) - 1 + p.q_offset;
  int end = p.T, b = 0;
  if (p.causal) end = min(end, q_last + 1);
  if (p.window > 0) b = max(0, q0 + p.q_offset - p.window + 1);
  b = (b / kBN) * kBN;
  *begin = b;
  return end > b ? (end - b + kBN - 1) / kBN : 0;
}

// the query tiles [*begin, + n * kBN) that can see the key tile at k0 (kBM keys)
__device__ __forceinline__ int query_tiles(const Params& p, int k0, int* begin) {
  int b = 0, end = p.S;
  if (p.causal) b = max(0, k0 - p.q_offset);
  if (p.window > 0) end = min(end, max(0, k0 + kBM - 1 + p.window - p.q_offset));
  b = (b / kBN) * kBN;
  *begin = b;
  return end > b ? (end - b + kBN - 1) / kBN : 0;
}

// ---- 2. dQ: a work item is (128 query rows, b*h); 64-key tiles stream
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                                  const __grid_constant__ CUtensorMap mk,
                                  const __grid_constant__ CUtensorMap mv,
                                  const __grid_constant__ CUtensorMap mdo, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t full[L::kStages], empty[L::kStages], res_full, res_empty;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = base + L::kResBytes, ring = base + 2 * L::kResBytes;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(&res_full, 1);
    mbar_init(&res_empty, kConsumers * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0, res_phase = 0;
      for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
        const int2 it = item_at(p, i, true);
        const int q0 = it.x * kBM, b = it.y / p.H, h = it.y % p.H, hk = h / p.group;
        int k_begin;
        const int n = key_tiles(p, q0, &k_begin);
        if (n == 0) continue;
        mbar_wait(&res_empty, res_phase ^ 1);
        res_phase ^= 1;
        mbar_expect_tx(&res_full, 2 * L::kResBytes);
        load_tile<D, kBM>(sq, &mq, q0, h, b, &res_full);
        load_tile<D, kBM>(sdo, &mdo, q0, h, b, &res_full);
        for (int j = 0; j < n; ++j) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * L::kTileBytes);
          const uint32_t sk = ring + stage * L::kStageBytes;
          load_tile<D, kBN>(sk, &mk, k_begin + j * kBN, hk, b, &full[stage]);
          load_tile<D, kBN>(sk + L::kTileBytes, &mv, k_begin + j * kBN, hk, b, &full[stage]);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row_in_tile = 64 * wg + 16 * ((tid >> 5) & 3) + g;  // and + 8
    const uint32_t sq_wg = sq + wg * 64 * 128, sdo_wg = sdo + wg * 64 * 128;
    int stage = 0;
    uint32_t phase = 0, res_phase = 0;
    for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
      const int2 it = item_at(p, i, true);
      const int q0 = it.x * kBM, bh = it.y, b = bh / p.H, h = bh % p.H;
      int k_begin;
      const int n = key_tiles(p, q0, &k_begin);
      // rows past S keep lse = delta = 0; their Q and dO are zeros, so
      // they add nothing, and they are not written
      float lse2[2], dsc[2];
      int qpos[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + row_in_tile + 8 * r;
        const bool in = row < p.S;
        lse2[r] = in ? p.lse[(long long)bh * p.S + row] * kLog2e : 0.f;
        dsc[r] = in ? p.delta[(long long)bh * p.S + row] * p.scale : 0.f;
        qpos[r] = row + p.q_offset;
      }
      float dq[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
      if (n > 0) {
        mbar_wait(&res_full, res_phase);
        res_phase ^= 1;
      }
      // per key tile: S and dP, dS in registers, then dQ += dS K
      for (int j = 0; j < n; ++j) {
        const int k0 = k_begin + j * kBN;
        mbar_wait(&full[stage], phase);
        const uint32_t sk = ring + stage * L::kStageBytes, sv = sk + L::kTileBytes;
        float s[kBN / 2], dp[kBN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T>::template ss<0, 0>(s, kmajor_desc(sq_wg + (kk / 4) * kBM * 128, kk % 4),
                                      kmajor_desc(sk + (kk / 4) * kBN * 128, kk % 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T>::template ss<0, 0>(dp, kmajor_desc(sdo_wg + (kk / 4) * kBM * 128, kk % 4),
                                      kmajor_desc(sv + (kk / 4) * kBN * 128, kk % 4), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        if (j == n - 1 && lane == 0) mbar_arrive(&res_empty);  // done with Q and dO

        const bool edge = k0 + kBN > p.T || (p.causal && k0 + kBN - 1 > q0 + p.q_offset) ||
                          (p.window > 0 && k0 <= q0 + kBM - 1 + p.q_offset - p.window);
        if (p.softcap > 0.f && edge)
          dq_tile_p_ds<true, true>(p, s, dp, lse2, dsc, qpos, k0, t);
        else if (p.softcap > 0.f)
          dq_tile_p_ds<true, false>(p, s, dp, lse2, dsc, qpos, k0, t);
        else if (edge)
          dq_tile_p_ds<false, true>(p, s, dp, lse2, dsc, qpos, k0, t);
        else
          dq_tile_p_ds<false, false>(p, s, dp, lse2, dsc, qpos, k0, t);

        uint32_t da[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) pack_a<T>(da[kk], dp, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          Wgmma<T>::template rs<1>(dq, da[kk], mnmajor_desc(sk, kk, kBN * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) reg_fence(da[kk]);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + row_in_tile + 8 * r;
        if (row >= p.S) continue;
        uint16_t* out = p.dq + b * p.dq_sb + h * p.dq_sh + (long long)row * p.dq_ss;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<uint32_t*>(out + c * 8 + 2 * t) =
              Mma<T>::pack(dq[4 * c + 2 * r], dq[4 * c + 2 * r + 1]);
      }
    }
  }
}

// ---- 3. dK/dV: a work item is (128 keys, b*hkv); the Q and dO tiles of
// every head of its GQA group stream
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                                   const __grid_constant__ CUtensorMap mk,
                                   const __grid_constant__ CUtensorMap mv,
                                   const __grid_constant__ CUtensorMap mdo, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t full[L::kStages], empty[L::kStages], res_full, res_empty;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const gbase = smem + (base - smem_u32(smem));  // base as a generic pointer
  const uint32_t sk = base, sv = base + L::kResBytes, ring = base + 2 * L::kResBytes;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the copies' arrival and one a producer lane (lse, delta)
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(&res_full, 1);
    mbar_init(&res_empty, kConsumers * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: lane 0 copies tiles, every lane of its
                           // first warp lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int lane = tid & 31;
    if (tid >= kConsumers * 128 + 32) return;
    int stage = 0;
    uint32_t phase = 0, res_phase = 0;
    for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
      const int2 it = item_at(p, i, false);
      const int k0 = it.x * kBM, b = it.y / p.Hkv, hk = it.y % p.Hkv;
      int q_begin;
      const int nq = query_tiles(p, k0, &q_begin);
      if (nq == 0) continue;
      if (lane == 0) {
        mbar_wait(&res_empty, res_phase ^ 1);
        mbar_expect_tx(&res_full, 2 * L::kResBytes);
        load_tile<D, kBM>(sk, &mk, k0, hk, b, &res_full);
        load_tile<D, kBM>(sv, &mv, k0, hk, b, &res_full);
      }
      res_phase ^= 1;
      for (int hq = 0; hq < p.group; ++hq) {
        const int h = hk * p.group + hq, bh = b * p.H + h;
        for (int j = 0; j < nq; ++j) {
          const int q0 = q_begin + j * kBN;
          mbar_wait(&empty[stage], phase ^ 1);
          const uint32_t sq = ring + stage * L::kStageBytes;
          if (lane == 0) {
            mbar_expect_tx(&full[stage], 2 * L::kTileBytes);
            load_tile<D, kBN>(sq, &mq, q0, h, b, &full[stage]);
            load_tile<D, kBN>(sq + L::kTileBytes, &mdo, q0, h, b, &full[stage]);
          }
          float* st = reinterpret_cast<float*>(gbase + (sq - base) + 2 * L::kTileBytes);
#pragma unroll
          for (int r = lane; r < kBN; r += 32) {
            const bool in = q0 + r < p.S;
            st[r] = in ? p.lse[(long long)bh * p.S + q0 + r] * kLog2e : 0.f;
            st[kBN + r] = in ? p.delta[(long long)bh * p.S + q0 + r] * p.scale : 0.f;
          }
          mbar_arrive(&full[stage]);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int key_in_tile = 64 * wg + 16 * ((tid >> 5) & 3) + g;  // and + 8
    const uint32_t sk_wg = sk + wg * 64 * 128, sv_wg = sv + wg * 64 * 128;
    int stage = 0;
    uint32_t phase = 0, res_phase = 0;
    for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
      const int2 it = item_at(p, i, false);
      const int k0 = it.x * kBM, b = it.y / p.Hkv, hk = it.y % p.Hkv;
      int q_begin;
      const int nq = query_tiles(p, k0, &q_begin);
      const int n = nq * p.group;
      const int key[2] = {k0 + key_in_tile, k0 + key_in_tile + 8};
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
      if (n > 0) {
        mbar_wait(&res_full, res_phase);
        res_phase ^= 1;
      }
      // per query tile: S^T and dP^T, P^T and dS^T in registers, then dV +=
      // P^T dO and dK += dS^T Q
      for (int j = 0; j < n; ++j) {
        const int q0 = q_begin + (j % nq) * kBN;
        mbar_wait(&full[stage], phase);
        const uint32_t sq = ring + stage * L::kStageBytes, sdo = sq + L::kTileBytes;
        const float* st = reinterpret_cast<const float*>(gbase + (sq - base) + 2 * L::kTileBytes);
        float s[kBN / 2], dp[kBN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T>::template ss<0, 0>(s, kmajor_desc(sk_wg + (kk / 4) * kBM * 128, kk % 4),
                                      kmajor_desc(sq + (kk / 4) * kBN * 128, kk % 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T>::template ss<0, 0>(dp, kmajor_desc(sv_wg + (kk / 4) * kBM * 128, kk % 4),
                                      kmajor_desc(sdo + (kk / 4) * kBN * 128, kk % 4), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        if (j == n - 1 && lane == 0) mbar_arrive(&res_empty);  // done with K and V

        const bool edge = q0 + kBN > p.S || k0 + kBM > p.T ||
                          (p.causal && k0 + kBM - 1 > q0 + p.q_offset) ||
                          (p.window > 0 && k0 <= q0 + kBN - 1 + p.q_offset - p.window);
        if (p.softcap > 0.f && edge)
          dkv_tile_p_ds<true, true>(p, s, dp, st, q0, key, t);
        else if (p.softcap > 0.f)
          dkv_tile_p_ds<true, false>(p, s, dp, st, q0, key, t);
        else if (edge)
          dkv_tile_p_ds<false, true>(p, s, dp, st, q0, key, t);
        else
          dkv_tile_p_ds<false, false>(p, s, dp, st, q0, key, t);

        uint32_t pa[kBN / 16][4], da[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          pack_a<T>(pa[kk], s, kk);
          pack_a<T>(da[kk], dp, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          Wgmma<T>::template rs<1>(dv, pa[kk], mnmajor_desc(sdo, kk, kBN * 128), 1);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          Wgmma<T>::template rs<1>(dk, da[kk], mnmajor_desc(sq, kk, kBN * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          reg_fence(pa[kk]);
          reg_fence(da[kk]);
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= p.T) continue;
        uint16_t* krow = p.dk + b * p.dk_sb + hk * p.dk_sh + (long long)key[r] * p.dk_st;
        uint16_t* vrow = p.dv + b * p.dv_sb + hk * p.dv_sh + (long long)key[r] * p.dv_st;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          *reinterpret_cast<uint32_t*>(krow + c * 8 + 2 * t) =
              Mma<T>::pack(dk[4 * c + 2 * r], dk[4 * c + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(vrow + c * 8 + 2 * t) =
              Mma<T>::pack(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// the 4-D map of a (B, L, heads, D) operand from geo = {D, L, heads, B,
// byte strides of L, heads, B}: boxes of 64 columns x 64 rows
bool make_operand_map(CUtensorMap* map, int dtype, const void* p, const long long* geo) {
  const cuuint64_t dims[4] = {cuuint64_t(geo[0]), cuuint64_t(geo[1]), cuuint64_t(geo[2]),
                              cuuint64_t(geo[3])};
  const cuuint64_t strides[3] = {cuuint64_t(geo[4]), cuuint64_t(geo[5]), cuuint64_t(geo[6])};
  const cuuint32_t box[4] = {64, kBox, 1, 1};
  return make_map(map, dtype ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, p, dims, strides, box);
}

template <typename T, int D>
int launch(const CUtensorMap* maps, Params p, int B, cudaStream_t stream) {
  const long long rows = (long long)B * p.H * p.S;
  constexpr int kRowsPerBlock = 256 / (D / 8);
  if (rows > 0)
    flash_attention_bwd_delta_kernel<T, D>
        <<<unsigned((rows + kRowsPerBlock - 1) / kRowsPerBlock), 256, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int sms = num_sms();
  auto dq_kernel = flash_attention_bwd_dq_kernel<T, D>;
  auto dkv_kernel = flash_attention_bwd_dkv_kernel<T, D>;
  constexpr int kSmem = Layout<D>::kSmem;
  if ((err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmem)) != cudaSuccess)
    return err;
  p.n_tiles = (p.S + kBM - 1) / kBM;
  p.n_items = p.n_tiles * B * p.H;
  if (p.n_items > 0) {
    dq_kernel<<<p.n_items < sms ? p.n_items : sms, kThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  p.n_tiles = (p.T + kBM - 1) / kBM;
  p.n_items = p.n_tiles * B * p.Hkv;
  if (p.n_items > 0) {
    dkv_kernel<<<p.n_items < sms ? p.n_items : sms, kThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. geo: for q, k, v, dout in turn, the
// tensor map's {D, L, heads, B} and the byte strides of L, heads, B (7
// values each). strides: out, dout, dq, dk, dv in elements, each group of
// three (batch, sequence, head); the head dim is contiguous. `delta` is
// fp32 scratch of B*H*S elements. Returns the cudaError_t of the launches
// (0 = all launched), or -1 if the driver refused a tensor map.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int S, int T, int H, int Hkv, int D, const long long* geo,
    const long long* strides, int causal, int window, float softcap, int q_offset,
    void* stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (!make_operand_map(&maps[i], dtype, ptrs[i], geo + 7 * i)) return -1;
  Params p;
  p.o = static_cast<const uint16_t*>(out);
  p.dout = static_cast<const uint16_t*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<uint16_t*>(dq);
  p.dk = static_cast<uint16_t*>(dk);
  p.dv = static_cast<uint16_t*>(dv);
  p.S = S;
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.group = H / Hkv;
  const long long* s = strides;
  p.o_sb = s[0]; p.o_ss = s[1]; p.o_sh = s[2];
  p.do_sb = s[3]; p.do_ss = s[4]; p.do_sh = s[5];
  p.dq_sb = s[6]; p.dq_ss = s[7]; p.dq_sh = s[8];
  p.dk_sb = s[9]; p.dk_st = s[10]; p.dk_sh = s[11];
  p.dv_sb = s[12]; p.dv_st = s[13]; p.dv_sh = s[14];
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(maps, p, B, st);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(maps, p, B, st);
  if (dtype == 1 && D == 64) return launch<__half, 64>(maps, p, B, st);
  if (dtype == 1 && D == 128) return launch<__half, 128>(maps, p, B, st);
  return cudaErrorInvalidValue;
}
