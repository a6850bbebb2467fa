// Flash-attention backward for Hopper (sm_90a): bf16/fp16 in, fp32 math.
//
// Replaces the TPU kernels behind `flash_attention_bwd` in
// src/repro/kernels/flash_attention.py: `_fa_delta_kernel` (its first
// pallas_call), `_fa_dq_kernel` (the second) and `_fa_dkv_kernel` (the
// third). Same contract: q, out, dO (B,S,H,D), k/v (B,T,Hkv,D) and the
// forward's lse (B*H, S) fp32 -> dq (B,S,H,D), dk/dv (B,T,Hkv,D) in the
// input dtype; scale 1/sqrt(D); mask k_pos < T plus causal / sliding window
// / q_offset; optional logit softcap; GQA as head h reading kv head
// h / group, with dK/dV summed over the group.
//
// Math, per (query row i, key j), as `_recompute_p_ds` does it:
//   s = q_i.k_j * scale;  z = softcap ? softcap*tanh(s/softcap) : s
//   p = mask ? exp(min(z - lse_i, 0)) : 0     (the mask gates p: a fully
//       masked row has lse = -1e30 and would otherwise give exp(0) = 1; the
//       clamp keeps rows with a garbage lse finite)
//   dp = dO_i.v_j;  ds = p*(dp - delta_i) * (softcap ? 1 - t^2 : 1) * scale
//   dq_i = sum_j ds k_j;  dk_j = sum_i ds q_i;  dv_j = sum_i p dO_i
// with delta_i = rowsum(dO_i * O_i) in fp32.
//
// Design. The TPU kernels carry dQ across a sequential kv grid axis and
// dK/dV across a sequential (group x q) grid axis in VMEM scratch. Hopper
// blocks run in no order, so each pass loops over the tiles itself and no
// sum crosses blocks: the result is the same bit for bit on every run
// (no atomics), which a repeatable train step and a bit-exact resume need.
//   1. delta pre-pass: D/8 threads per row, 16-byte loads, shuffle sum.
//   2. dQ pass: a block of 4 warps owns (b*h, 64 query rows) and loops over
//      64-key tiles; S = QK^T and dP = dO V^T on the tensor cores, dS in
//      fp32 registers, then dQ += dS K.
//   3. dK/dV pass: a block owns (b*hkv, 64 key rows) and loops over every
//      query tile of every head of its GQA group; S^T = K Q^T and
//      dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
// Products are mma.sync m16n8k16 with fp32 accumulation (bf16 x bf16
// products are exact in fp32). P and dS are rounded to the input dtype
// before the three products that take them as an operand (the TPU kernels
// keep them fp32): that rounding, at most 2^-9 relative per element in
// bf16, is the kernel's stated tolerance. Tiles are read through the
// caller's strides; ragged tails are zero-filled in shared memory and
// masked. Query or key tiles that no entry of the block can see (causal /
// window) are skipped. Loads are plain synchronous 16-byte loads into
// dynamic shared memory; for D = 128 the dK/dV pass takes 32-query tiles so
// that its fp32 accumulators (dK and dV, 2 x 64 per thread) stay in
// registers.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the five
// products (QK^T twice, dO V^T twice, and dQ, dK, dV) with QK^T and dO V^T
// recomputed in the second pass come to 10*B*H*S*T*D FLOP minus the
// skipped tiles; the bytes are q, k, v, out, dO, lse read once and dq, dk,
// dv written once. At the ESM-2 training shape B=8, S=T=1024, H=20, D=64
// that is 1.07e11 FLOP (0.109 ms) against 0.13 GB (0.04 ms): operations
// bound it.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;    // rows a block owns: 4 warps x 16
constexpr int kBlockN = 64;    // keys per tile in the dQ pass
constexpr int kThreads = 128;

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* o;
  const uint16_t* dout;
  const float* lse;
  float* delta;
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  int S, T, H, Hkv, group;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh;
  int causal, window, q_offset;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

// rows [row0, row0 + ROWS) of a (rows, D) matrix with the given row stride
// into shared memory; rows >= nrows are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* base,
                                          long long row_stride, int row0, int nrows) {
  constexpr int kVec = 8;  // 8 x 16 bit = one 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) = val;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int key) {
  bool ok = key < p.T;
  if (p.causal) ok = ok && key <= qpos;
  if (p.window > 0) ok = ok && key > qpos - p.window;
  return ok;
}

// p and the pre-scale score gradient factor for one entry: on return
// `sv` holds p and `dpv` holds ds (scale included)
__device__ __forceinline__ void p_ds(const Params& p, bool ok, float lse, float delta,
                                     float& sv, float& dpv) {
  float z = sv * p.scale, dz = 1.f;
  if (p.softcap > 0.f) {
    const float th = tanhf(z / p.softcap);
    z = p.softcap * th;
    dz = 1.f - th * th;
  }
  const float pr = ok ? expf(fminf(z - lse, 0.f)) : 0.f;
  sv = pr;
  dpv = pr * (dpv - delta) * dz * p.scale;
}

// ---- 1. delta = rowsum(dO * O) in fp32, one (b*h, s) row per D/8 threads
template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(const Params p, long long rows) {
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

// ---- 2. dQ: a block owns (b*h, 64 query rows), loops over 64-key tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sdO = sQ + kBlockM * (D + kPad);
  uint16_t* sK = sdO + kBlockM * (D + kPad);
  uint16_t* sV = sK + kBlockN * (D + kPad);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = blockIdx.x * kBlockM;
  const int wrow = warp * 16;

  load_tile<kBlockM, D>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S);
  load_tile<kBlockM, D>(sdO, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S);

  // this thread's rows are g and g + 8 of the warp's 16; rows past S keep
  // lse = 0 and delta = 0 (their dO is zero-filled, so they add nothing)
  float lse[2], dl[2];
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    const bool in = row < p.S;
    lse[r] = in ? p.lse[(long long)bh * p.S + row] : 0.f;
    dl[r] = in ? p.delta[(long long)bh * p.S + row] : 0.f;
    qpos[r] = row + p.q_offset;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // the keys any row of this block can see
  const int q_last = min(q0 + kBlockM, p.S) - 1 + p.q_offset;
  int kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q0 + p.q_offset - p.window + 1);
  kv_begin = (kv_begin / kBlockN) * kBlockN;

  const uint16_t* kbase = p.k + b * p.k_sb + hk * p.k_sh;
  const uint16_t* vbase = p.v + b * p.v_sb + hk * p.v_sh;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<kBlockN, D>(sK, kbase, p.k_st, k0, p.T);
    load_tile<kBlockN, D>(sV, vbase, p.v_st, k0, p.T);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      a_frag<D>(qa, sQ, wrow, kk * 16, g, t);
      a_frag<D>(da, sdO, wrow, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        uint32_t b0, b1;
        b_frag_rows<D>(b0, b1, sK, n * 8, kk * 16, g, t);
        Mma<T>::run(s[n], qa, b0, b1);
        b_frag_rows<D>(b0, b1, sV, n * 8, kk * 16, g, t);
        Mma<T>::run(dp[n], da, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        p_ds(p, visible(p, qpos[r], key), lse[r], dl[r], s[n][i], dp[n][i]);
      }

    // dQ += dS K: dS's accumulators of two adjacent 8-key tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(dp[2 * kk][0], dp[2 * kk][1]);
      a[1] = Mma<T>::pack(dp[2 * kk][2], dp[2 * kk][3]);
      a[2] = Mma<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      a[3] = Mma<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        b_frag_cols<D>(b0, b1, sK, kk * 16, j * 8, g, t);
        Mma<T>::run(acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= p.S) continue;
    uint16_t* out = p.dq + b * p.dq_sb + h * p.dq_sh + (long long)row * p.dq_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) =
          Mma<T>::pack(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// ---- 3. dK/dV: a block owns (b*hkv, 64 key rows), loops over every query
// tile of every head in its GQA group
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sK = smem;
  uint16_t* sV = sK + kBlockM * (D + kPad);
  uint16_t* sQ = sV + kBlockM * (D + kPad);
  uint16_t* sdO = sQ + BQ * (D + kPad);
  float* sLse = reinterpret_cast<float*>(sdO + BQ * (D + kPad));
  float* sDelta = sLse + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bk = blockIdx.y, b = bk / p.Hkv, hk = bk % p.Hkv;
  const int k0 = blockIdx.x * kBlockM;
  const int wrow = warp * 16;

  load_tile<kBlockM, D>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_st, k0, p.T);
  load_tile<kBlockM, D>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_st, k0, p.T);

  const int key[2] = {k0 + wrow + g, k0 + wrow + g + 8};

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  // the query rows that can see any key of this block
  int q_begin = 0, q_end = p.S;
  if (p.causal) q_begin = max(0, k0 - p.q_offset);
  if (p.window > 0) q_end = min(q_end, max(0, k0 + kBlockM - 1 + p.window - p.q_offset));
  q_begin = (q_begin / BQ) * BQ;

  for (int hq = 0; hq < p.group; ++hq) {
    const int h = hk * p.group + hq, bh = b * p.H + h;
    const uint16_t* qbase = p.q + b * p.q_sb + h * p.q_sh;
    const uint16_t* dobase = p.dout + b * p.do_sb + h * p.do_sh;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile<BQ, D>(sQ, qbase, p.q_ss, q0, p.S);
      load_tile<BQ, D>(sdO, dobase, p.do_ss, q0, p.S);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < p.S;
        sLse[i] = in ? p.lse[(long long)bh * p.S + q0 + i] : 0.f;
        sDelta[i] = in ? p.delta[(long long)bh * p.S + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x BQ queries
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        a_frag<D>(ka, sK, wrow, kk * 16, g, t);
        a_frag<D>(va, sV, wrow, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          uint32_t b0, b1;
          b_frag_rows<D>(b0, b1, sQ, n * 8, kk * 16, g, t);
          Mma<T>::run(s[n], ka, b0, b1);
          b_frag_rows<D>(b0, b1, sdO, n * 8, kk * 16, g, t);
          Mma<T>::run(dp[n], va, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = n * 8 + 2 * t + (i & 1);  // query within the tile
          const int qrow = q0 + c;
          const bool ok = qrow < p.S && visible(p, qrow + p.q_offset, key[i >> 1]);
          p_ds(p, ok, sLse[c], sDelta[c], s[n][i], dp[n][i]);
        }

      // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = Mma<T>::pack(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = Mma<T>::pack(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = Mma<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = Mma<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          uint32_t b0, b1;
          b_frag_cols<D>(b0, b1, sdO, kk * 16, j * 8, g, t);
          Mma<T>::run(dv[j], pa, b0, b1);
          b_frag_cols<D>(b0, b1, sQ, kk * 16, j * 8, g, t);
          Mma<T>::run(dk[j], da, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.T) continue;
    uint16_t* krow = p.dk + b * p.dk_sb + hk * p.dk_sh + (long long)key[r] * p.dk_st;
    uint16_t* vrow = p.dv + b * p.dv_sb + hk * p.dv_sh + (long long)key[r] * p.dv_st;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + j * 8 + 2 * t) = Mma<T>::pack(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + j * 8 + 2 * t) = Mma<T>::pack(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int BQ = D == 128 ? 32 : 64;
  const long long rows = (long long)B * p.H * p.S;
  constexpr int kRowsPerBlock = 256 / (D / 8);
  delta_kernel<T, D><<<unsigned((rows + kRowsPerBlock - 1) / kRowsPerBlock), 256, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int dq_smem = (2 * kBlockM + 2 * kBlockN) * (D + kPad) * 2;
  err = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3((p.S + kBlockM - 1) / kBlockM, B * p.H), kThreads, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int dkv_smem = (2 * kBlockM + 2 * BQ) * (D + kPad) * 2 + 2 * BQ * 4;
  err = cudaFuncSetAttribute(dkv_kernel<T, D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<T, D, BQ><<<dim3((p.T + kBlockM - 1) / kBlockM, B * p.Hkv), kThreads, dkv_smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Strides are in elements, each group of
// three is (batch, sequence, head); the head dim is contiguous. `delta` is
// fp32 scratch of B*H*S elements. Returns the cudaError_t of the launches
// (0 = all launched).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int S, int T, int H, int Hkv, int D,
    const long long* strides,  // q, k, v, out, dout, dq, dk, dv: 8 x 3
    int causal, int window, float softcap, int q_offset, void* stream) {
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
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
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_st = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_st = s[7]; p.v_sh = s[8];
  p.o_sb = s[9]; p.o_ss = s[10]; p.o_sh = s[11];
  p.do_sb = s[12]; p.do_ss = s[13]; p.do_sh = s[14];
  p.dq_sb = s[15]; p.dq_ss = s[16]; p.dq_sh = s[17];
  p.dk_sb = s[18]; p.dk_st = s[19]; p.dk_sh = s[20];
  p.dv_sb = s[21]; p.dv_st = s[22]; p.dv_sh = s[23];
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(p, B, st);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(p, B, st);
  if (dtype == 1 && D == 64) return launch<__half, 64>(p, B, st);
  if (dtype == 1 && D == 128) return launch<__half, 128>(p, B, st);
  return cudaErrorInvalidValue;
}
