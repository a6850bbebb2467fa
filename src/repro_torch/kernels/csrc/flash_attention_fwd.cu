// Flash-attention forward for Hopper (sm_90a): bf16/fp16 in, fp32 softmax.
//
// Replaces the TPU kernel `_fa_kernel` behind `flash_attention_fwd` in
// src/repro/kernels/flash_attention.py (its pallas_call). Same contract:
// q (B,S,H,D), k/v (B,T,Hkv,D) -> out (B,S,H,D) in q's dtype and the per-row
// log-sum-exp lse (B*H, S) fp32; scale 1/sqrt(D); mask k_pos < T plus
// causal / sliding window / q_offset; optional logit softcap; GQA as head
// h reading kv head h / group. A row that sees no key gives output 0 and
// lse = -1e30.
//
// Design. The TPU kernel walks a sequential kv grid axis and carries
// (m, l, acc) in VMEM scratch between grid steps; Hopper blocks run in no
// order, so one thread block owns one (b*h, 64-query tile) and loops over
// 64-key tiles itself, carrying m/l/acc in registers (FlashAttention-2
// register layout). Four warps each own 16 query rows. QK^T and PV run on
// the tensor cores with mma.sync m16n8k16 and fp32 accumulation: bf16 x bf16
// products are exact in fp32, so S matches an fp32 QK^T up to summation
// order. P is rounded to the input dtype once, before the PV product (the
// TPU kernel keeps P in fp32): a relative error of at most 2^-9 (bf16) per
// probability, which the row normaliser l (summed from the unrounded fp32
// P) does not see. Tiles are read through the caller's strides: no
// head-major transpose copy and no padding; the ragged tail is zero-filled
// in shared memory and masked. Key tiles that no row of the block can see
// (causal / window) are skipped. Loads are plain 16-byte vector loads,
// synchronous, single-buffered: TMA, cp.async pipelining and wgmma are left
// for a later version.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the ESM-2
// serving shape B=32, S=T=1024, H=20, D=64 the work is 4*B*H*S*T*D =
// 1.7e11 FLOP (0.17 ms) against q, k, v read once and out written once,
// 4*B*S*H*D*2 B + lse = 0.34 GB (0.10 ms): operations bound it.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kBlockQ = 64;    // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* o;
  float* lse;
  int S, T, H, group;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

// rows [row0, row0+64) of a (rows, D) matrix with the given row stride into
// shared memory; rows >= nrows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[D + kPad], const uint16_t* base,
                                          long long row_stride, int row0, int nrows) {
  constexpr int kVec = 8;  // 8 x 16 bit = one 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < kBlockK * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sK[kBlockK][D + kPad];
  __shared__ __align__(16) uint16_t sV[kBlockK][D + kPad];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = blockIdx.x * kBlockQ;
  const int wrow = warp * 16;

  // the Q tile, staged through sK, stays in registers as mma A fragments
  load_tile<D>(sK, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) a_frag<D>(qa[kk], &sK[0][0], wrow, kk * 16, g, t);

  // this thread's rows are g and g + 8 of the warp's 16. m is the running
  // max in log2 units; l is this thread's partial row sum (its 2 of every
  // 8 columns), reduced across the 4 threads of the row at the end
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int qpos[2] = {q0 + wrow + g + p.q_offset, q0 + wrow + g + 8 + p.q_offset};

  // the keys any row of this block can see
  const int q_last = min(q0 + kBlockQ, p.S) - 1 + p.q_offset;
  int kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q0 + p.q_offset - p.window + 1);
  kv_begin = (kv_begin / kBlockK) * kBlockK;

  const uint16_t* kbase = p.k + b * p.k_sb + hk * p.k_sh;
  const uint16_t* vbase = p.v + b * p.v_sb + hk * p.v_sh;
  const float scale_log2 = p.scale * kLog2e;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(sK, kbase, p.k_st, k0, p.T);
    load_tile<D>(sV, vbase, p.v_st, k0, p.T);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        uint32_t b0, b1;
        b_frag_rows<D>(b0, b1, &sK[0][0], n * 8, kk * 16, g, t);
        Mma<T>::run(s[n], qa[kk], b0, b1);
      }
    }

    // scale, softcap, mask; row max over the tile
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        float x = p.softcap > 0.f ? p.softcap * tanhf(s[n][i] * p.scale / p.softcap) * kLog2e
                                  : s[n][i] * scale_log2;
        bool ok = key < p.T;
        if (p.causal) ok = ok && key <= qpos[r];
        if (p.window > 0) ok = ok && key > qpos[r] - p.window;
        x = ok ? x : kNegInf;
        s[n][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      l[r] *= alpha[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        // a row with no visible key so far stays inert
        const float pr = mx[r] <= kNegInf / 2 ? 0.f : exp2f(s[n][i] - mx[r]);
        s[n][i] = pr;
        l[r] += pr;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two adjacent 8-key tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        b_frag_cols<D>(b0, b1, &sV[0][0], kk * 16, j * 8, g, t);
        Mma<T>::run(acc[j], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    uint16_t* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          Mma<T>::pack(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
    if (t == 0)
      p.lse[(long long)bh * p.S + row] = m[r] <= kNegInf / 2 ? kNegInf : m[r] * kLn2 + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, BH);
  flash_attention_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Strides are in elements; the head dim is
// contiguous. Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
    int B, int S, int T, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, int q_offset, void* stream) {
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.o = static_cast<uint16_t*>(out);
  p.lse = lse;
  p.S = S;
  p.T = T;
  p.H = H;
  p.group = H / Hkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(p, BH, s);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(p, BH, s);
  if (dtype == 1 && D == 64) return launch<__half, 64>(p, BH, s);
  if (dtype == 1 && D == 128) return launch<__half, 128>(p, BH, s);
  return cudaErrorInvalidValue;
}
