// The flash-attention forward's consumer side for Hopper (sm_90a), shared
// by the dense forward (flash_attention_fwd.cu) and the paged chunk prefill
// (paged_attention.cu): the block's shape, its shared-memory layout, the
// online softmax, and one work item of a consumer warpgroup (S = Q K^T on
// wgmma, the softmax in registers, O += P V on wgmma, the output written).
// The two kernels differ only in their producers, which fill the same ring
// of (K tile, V tile) stages: one copies boxes of a dense (B, L, heads, D)
// operand, the other gathers the rows of each tile through a block table.
// flash_attention_fwd.cu's source note gives the design and its reasons.
#pragma once

#include "hopper.cuh"

namespace {
namespace attn {

using namespace hopper;

constexpr int kBM = 128;  // query rows of a work item: two warpgroups of 64
constexpr int kBox = 64;  // rows and 16-bit columns of one dense TMA box (128 bytes a row)
constexpr int kConsumers = 2;
// and a producer warpgroup, of which one warp works: setmaxnreg trades
// registers within the block's pool, and ptxas gives these kernels 168 a
// thread, so 384 x 168 = 128 x 24 (producer) + 256 x 240 (consumers)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;  // a masked score, and the lse of a row with no key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// keys per tile: 128 at D = 64; at D = 128, 64 as in the mma.sync kernel
// this one replaced, whose results it then reproduces bit for bit (the
// tensor cores sum a wgmma k-step as they sum an mma.sync one). A 128-key
// tile there gives more RMS error against an fp64 reference (fewer rows
// see their running max's P exactly 1), and its ulp-level differences move
// the Llama-4-Scout route check's router flips past their bound
// (attention_variants.py measures both).
template <int D>
constexpr int keys_per_tile() {
  return D == 64 ? 128 : 64;
}

// shared memory: the Q tile, then the ring of (K tile, V tile) stages. A
// tile of R rows x D is D / 64 column halves of R rows x 128 bytes.
template <int D>
struct Layout {
  static constexpr int kBN = keys_per_tile<D>();
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  // up to 4 stages within 200 KB of shared memory (4 at both head dims)
  static constexpr int kStages = (200 * 1024 - kQBytes) / kStageBytes < 4
                                     ? (200 * 1024 - kQBytes) / kStageBytes : 4;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;  // + swizzle alignment
};

// 2^x by the special-function unit (ex2.approx.ftz): the same bits as
// exp2f here, whose denormal handling around it makes the forward ~1.5x
// slower at D = 64 (attention_variants.py)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile at k0 for this thread's two rows: S's
// raw scores in, P (fp32, unnormalised, base 2) out in place; m is the
// running row max in base-2 units, l this thread's part of the row sum
// (its 2 of every 8 columns, added in key order), alpha what the output so
// far is to be scaled by. The arithmetic is the replaced mma.sync
// kernel's, step for step (at D = 128 the same bits); the mask runs
// only on a tile that crosses T, the causal diagonal or the window edge.
// P is the item's mask: T (keys), causal, window, q_offset, scale, softcap.
template <int kBN, typename P>
__device__ __forceinline__ void online_softmax(const P& p, float (&s)[kBN / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2], int q0, int k0,
                                               const int (&qpos)[2], int t) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) s[x] = p.softcap * tanhf(s[x] * p.scale / p.softcap) * kLog2e;
  } else {
    const float scale_log2 = p.scale * kLog2e;
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) s[x] *= scale_log2;
  }
  const bool edge = k0 + kBN > p.T || (p.causal && k0 + kBN - 1 > q0 + p.q_offset) ||
                    (p.window > 0 && k0 <= q0 + kBM - 1 + p.q_offset - p.window);
  if (edge) {
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) {
      const int key = k0 + 8 * (x >> 2) + 2 * t + (x & 1), qp = qpos[(x >> 1) & 1];
      bool ok = key < p.T;
      if (p.causal) ok = ok && key <= qp;
      if (p.window > 0) ok = ok && key > qp - p.window;
      if (!ok) s[x] = kNegInf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < kBN / 2; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    l[r] *= alpha[r];
    m[r] = mx[r];
  }
#pragma unroll
  for (int x = 0; x < kBN / 2; ++x) {
    const int r = (x >> 1) & 1;
    // a row with no visible key so far stays inert
    s[x] = mx[r] <= kNegInf / 2 ? 0.f : ex2(s[x] - mx[r]);
    l[r] += s[x];
  }
}

// One work item of consumer warpgroup wg (0 or 1): the query tile at q0 of
// (b, h) over the n key tiles from k_begin that the producer streams into
// the ring of stages at `ring` (full / empty barriers; stage and phase carry
// over from one item to the next); writes the rows below p.S of p.o and,
// with kLse, p.lse. kFence: the ring is filled by cp.async (the generic
// proxy), so wgmma needs a proxy fence after the wait.
template <typename T, int D, bool kLse, bool kFence, typename P>
__device__ __forceinline__ void consume_item(const P& p, int q0, int n, int k_begin, int b, int h,
                                             int bh, uint32_t sq, uint32_t ring, uint64_t* full,
                                             uint64_t* empty, uint64_t* q_full, uint64_t* q_empty,
                                             int& stage, uint32_t& phase, uint32_t& q_phase) {
  using L = Layout<D>;
  constexpr int kBN = L::kBN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row_in_tile = 64 * wg + 16 * ((tid >> 5) & 3) + g;  // and + 8
  const int qpos[2] = {q0 + row_in_tile + p.q_offset, q0 + row_in_tile + 8 + p.q_offset};
  // m, l: see online_softmax; l is summed over the row's 4 threads at
  // the end
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  if (n > 0) {
    mbar_wait(q_full, q_phase);
    q_phase ^= 1;
  }
  const uint32_t sq_wg = sq + wg * 64 * 128;
  for (int j = 0; j < n; ++j) {
    const int k0 = k_begin + j * kBN;
    mbar_wait(&full[stage], phase);
    if (kFence) fence_proxy_async();
    const uint32_t sk = ring + stage * L::kStageBytes, sv = sk + L::kTileBytes;
    float s[kBN / 2], alpha[2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<T>::template ss<0, 0>(s, kmajor_desc(sq_wg + (kk / 4) * kBM * 128, kk % 4),
                                  kmajor_desc(sk + (kk / 4) * kBN * 128, kk % 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    online_softmax<kBN>(p, s, m, l, alpha, q0, k0, qpos, t);
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) pack_a<T>(pa[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      Wgmma<T>::template rs<1>(o, pa[kk], mnmajor_desc(sv, kk, kBN * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) reg_fence(pa[kk]);
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (n > 0 && lane == 0) mbar_arrive(q_empty);  // this warp is done with Q

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_in_tile + 8 * r;
    if (row >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    uint16_t* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * t) =
          Mma<T>::pack(o[4 * c + 2 * r] / denom, o[4 * c + 2 * r + 1] / denom);
    if (kLse && t == 0)
      p.lse[(long long)bh * p.S + row] =
          m[r] <= kNegInf / 2 ? kNegInf : m[r] * kLn2 + logf(denom);
  }
}

}  // namespace attn
}  // namespace
