// Paged-KV attention for Hopper (sm_90a): decode and chunk prefill through
// a block table, and the per-token K/V insert. bf16 only, the compute dtype
// of every served config.
//
// Replaces the three TPU kernels of src/repro/kernels/paged_attention.py
// (their pallas_calls):
//   * `_pa_kernel` behind `paged_flash_decode`: one query token per row
//     against the pages its block-table row maps; keys at positions >=
//     length are masked; a row of length 0 gives exactly 0;
//   * `_pp_kernel` behind `paged_flash_prefill`: query row i of batch b sits
//     at position starts[b] + i and attends to the keys k <= starts[b] + i
//     with k < lengths[b]; a fully masked row gives 0;
//   * `_kv_write_kernel` behind `paged_kv_write`: pool[page_idx[b], row[b]]
//     = new[b] for K and V, in place.
// Pools are (num_pages, page, Hkv, D); the block table is (B, n) int32 of
// physical page ids; page 0 is the null page, which holds no sequence.
// Scale 1/sqrt(D), optional logit softcap, GQA as query head h reading kv
// head h / group.
//
// Design. On the TPU the block table is scalar-prefetched and each grid
// step's BlockSpec DMAs one page; here every kernel reads the table itself
// and computes each K/V row's address as
//   pool + bt[b, pos / page] * page_stride + (pos % page) * row_stride
// (64-bit), so no dense (B, T) cache is ever built.
//   * decode: the design of flash_decode.cu with that address, computed
//     once a row for the block's chunk and kept in shared memory. Hopper
//     blocks run in no order, so the TPU's sequential page axis becomes
//     fixed 256-key chunks (16 pages of 16): one block per (row, kv head,
//     chunk), an exact softmax over the chunk in shared memory, fp32
//     partials (m, l, acc), and a combine kernel in chunk order. No
//     atomics, so a step repeats bit for bit, and a row's split depends
//     only on its own length. Chunks past the row's length return before
//     any load. fp32 FMAs on the CUDA cores (7 query rows underfill an mma
//     tile).
//   * prefill: tensor-core work (a 512-token chunk at group 7 is 3 584
//     query rows per kv head), so it is flash_attention_fwd.cu's design:
//     one block per (b, query head, 64-query tile), four warps of 16 rows,
//     mma.sync m16n8k16 with fp32 accumulation, (m, l, acc) in registers.
//     K/V tiles of 64 keys are gathered row by row through the table (each
//     row's offset computed once, in shared memory, for K and V). Key
//     tiles are aligned to absolute positions (multiples of 64), not to the
//     chunk's start, so a query row's result does not depend on where the
//     chunk boundaries fell; the key loop stops at min(lengths[b],
//     starts[b] + tile_end + 1). Rows past the chunk's valid rows are
//     computed (the caller discards them), as in the reference.
//   * insert: one block per slot writes that slot's one K row and one V row
//     (Hkv * D values each) with 16-byte stores; the TPU kernel rewrites the
//     whole page because its BlockSpec works in pages, which gives the same
//     result. Idle slots all write to row 0 of the null page 0: blocks may
//     race there, which is benign, since page 0 holds no sequence and is
//     read only by rows that no result depends on.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode is bound by memory: each live cache row is read once for K
//     and once for V. At Qwen2-7B's decode shape (B 32, capacity 2048,
//     Hkv 4, D 128) with 31 163 live rows that is 64 MB, 0.019 ms.
//   * prefill: the larger of 4 * H * D * (visible keys summed over the
//     query rows) operations and the bytes of q, out and the live K/V rows
//     read once; a 512-token chunk at start 512 (B 1, 5.6 GFLOP) is ~0.0057 ms
//     by operations.
//   * insert: 2 * B * Hkv * D * 2 bytes read and written, 0.13 MB at B 32
//     (0.04 us): its time is the launch.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kChunk = 256;   // decode: keys per split
constexpr int kTile = 64;     // keys per shared-memory tile (both kernels)
constexpr int kBlockQ = 64;   // prefill: query rows per block, 4 warps x 16
constexpr int kThreads = 128;
constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
using T = __nv_bfloat16;

// the pool offset of each of the n rows at positions [row0, row0 + n) of
// one block-table row, -1 at positions >= row_end: the table is read and
// the position divided once a row, not once a 16-byte load. The caller
// syncs before the offsets are read.
__device__ __forceinline__ void row_offsets(long long* off, int n, const int* bt_row, int page,
                                            long long page_stride, long long row_stride, int row0,
                                            int row_end) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const int pos = row0 + r;
    off[r] = pos < row_end
                 ? (long long)bt_row[pos / page] * page_stride + (long long)(pos % page) * row_stride
                 : -1;
  }
}

// kTile pool rows at the offsets `off` into shared memory; rows at offset
// -1 are zero-filled. `pool` is offset to the kv head.
template <int D>
__device__ __forceinline__ void load_paged_tile(uint16_t (*dst)[D + kPad], const uint16_t* pool,
                                                const long long* off) {
  constexpr int kVec = 8;  // 8 x 16 bit = one 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    const long long o = off[r];
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (o >= 0) val = *reinterpret_cast<const uint4*>(pool + o + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

// rows [row0, row0 + kTile) of a (rows, D) strided matrix; rows >= nrows
// are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[D + kPad], const uint16_t* base,
                                          long long row_stride, int row0, int nrows) {
  constexpr int kVec = 8;
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

struct Pool {
  const uint16_t* k;
  const uint16_t* v;
  const int* bt;        // (B, n_tables)
  int page, n_tables;
  long long page_stride, row_stride, head_stride, bt_sb;
};

// ------------------------------------------------------------------ decode
struct DecodeParams {
  Pool pool;
  const uint16_t* q;
  const int* lengths;
  uint16_t* o;
  float* part_m;    // (B*H, splits)
  float* part_l;    // (B*H, splits)
  float* part_acc;  // (B*H, splits, D)
  int H, group, splits;
  long long q_sb, q_sh, o_sb, o_sh;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

__device__ __forceinline__ int row_length(const DecodeParams& p, int b) {
  return min(max(p.lengths[b], 0), p.pool.n_tables * p.pool.page);
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(const DecodeParams p) {
  __shared__ __align__(16) uint16_t sKV[kTile][D + kPad];
  __shared__ __align__(16) float sQ[kMaxGroup][D];
  __shared__ __align__(16) float sS[kMaxGroup][kChunk];
  __shared__ float sM[kMaxGroup], sL[kMaxGroup];
  __shared__ long long sOff[kChunk];   // the chunk's row offsets, for K and for V

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = row_length(p, b);
  const int k0 = split * kChunk;
  if (k0 >= len) return;  // past the row's length: no loads, no partials
  const int k_end = min(k0 + kChunk, len);
  const int n = k_end - k0;
  const int n_pad = (n + kTile - 1) / kTile * kTile;
  const int g = p.group, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Pool pl = p.pool;

  for (int i = tid; i < g * D; i += kThreads) {
    const int h = i / D, d = i % D;
    sQ[h][d] = Mma<T>::to_float(p.q[b * p.q_sb + (hk * g + h) * p.q_sh + d]);
  }
  row_offsets(sOff, kChunk, pl.bt + b * pl.bt_sb, pl.page, pl.page_stride, pl.row_stride, k0,
              k_end);
  const uint16_t* kbase = pl.k + hk * pl.head_stride;
  const uint16_t* vbase = pl.v + hk * pl.head_stride;

  // scores: thread tid owns key tid % kTile of each tile and the heads
  // h = tid / kTile + 2i
  const int j = tid % kTile, hset = tid / kTile;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();  // sQ and sOff written; the previous tile's readers done
    load_paged_tile<D>(sKV, kbase, sOff + t0);
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
    load_paged_tile<D>(sKV, vbase, sOff + t0);
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
__global__ void __launch_bounds__(D / 2) paged_decode_combine_kernel(const DecodeParams p) {
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
cudaError_t launch_decode(const DecodeParams& p, int B, int Hkv, cudaStream_t stream) {
  paged_decode_split_kernel<D><<<dim3(p.splits, Hkv, B), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<D><<<B * p.H, D / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- prefill
struct PrefillParams {
  Pool pool;
  const uint16_t* q;
  const int* starts;
  const int* lengths;
  uint16_t* o;
  int S, H, group;
  long long q_sb, q_ss, q_sh, o_sb, o_ss, o_sh;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

template <int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(const PrefillParams p) {
  __shared__ __align__(16) uint16_t sK[kTile][D + kPad];
  __shared__ __align__(16) uint16_t sV[kTile][D + kPad];
  __shared__ long long sOff[kTile];    // the tile's row offsets, for K and for V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = blockIdx.x * kBlockQ;
  const int wrow = warp * 16;
  const Pool pl = p.pool;

  // the Q tile, staged through sK, stays in registers as mma A fragments
  load_tile<D>(sK, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) a_frag<D>(qa[kk], &sK[0][0], wrow, kk * 16, g, t);

  const int start = p.starts[b];
  const int len = min(max(p.lengths[b], 0), pl.n_tables * pl.page);
  // this thread's rows are g and g + 8 of the warp's 16; m is the running
  // max in log2 units, l this thread's partial row sum
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int qpos[2] = {start + q0 + wrow + g, start + q0 + wrow + g + 8};

  // the keys any row of this block can see, in tiles aligned to absolute
  // positions
  const int q_last = start + min(q0 + kBlockQ, p.S) - 1;
  const int kv_end = min(len, q_last + 1);
  const int* bt_row = pl.bt + b * pl.bt_sb;
  const uint16_t* kbase = pl.k + hk * pl.head_stride;
  const uint16_t* vbase = pl.v + hk * pl.head_stride;
  const float scale_log2 = p.scale * kLog2e;

  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    row_offsets(sOff, kTile, bt_row, pl.page, pl.page_stride, pl.row_stride, k0, kv_end);
    __syncthreads();
    load_paged_tile<D>(sK, kbase, sOff);
    load_paged_tile<D>(sV, vbase, sOff);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        b_frag_rows<D>(b0, b1, &sK[0][0], n * 8, kk * 16, g, t);
        Mma<T>::run(s[n], qa[kk], b0, b1);
      }
    }

    // scale, softcap, the shifted causal mask and the length; row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        float x = p.softcap > 0.f ? p.softcap * tanhf(s[n][i] * p.scale / p.softcap) * kLog2e
                                  : s[n][i] * scale_log2;
        x = (key < len && key <= qpos[r]) ? x : kNegInf;
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
    for (int n = 0; n < kTile / 8; ++n) {
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
    for (int kk = 0; kk < kTile / 16; ++kk) {
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
    const float denom = fmaxf(l[r], 1e-30f);   // a fully masked row: acc = 0, out = 0
    uint16_t* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          Mma<T>::pack(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
  }
}

// ------------------------------------------------------------------ insert
struct WriteParams {
  uint16_t* k_pool;
  uint16_t* v_pool;
  const uint16_t* k_new;
  const uint16_t* v_new;
  const int* page_idx;
  const int* row;
  int Hkv, D;
  long long page_stride, row_stride, head_stride, kn_sb, kn_sh, vn_sb, vn_sh;
};

__global__ void __launch_bounds__(kThreads) paged_kv_write_kernel(const WriteParams p) {
  const int b = blockIdx.x;
  const long long dst = (long long)p.page_idx[b] * p.page_stride + (long long)p.row[b] * p.row_stride;
  const int per_head = p.D / 8;
  for (int c = threadIdx.x; c < p.Hkv * per_head; c += kThreads) {
    const int h = c / per_head, col = (c % per_head) * 8;
    const long long o = dst + h * p.head_stride + col;
    *reinterpret_cast<uint4*>(p.k_pool + o) =
        *reinterpret_cast<const uint4*>(p.k_new + b * p.kn_sb + h * p.kn_sh + col);
    *reinterpret_cast<uint4*>(p.v_pool + o) =
        *reinterpret_cast<const uint4*>(p.v_new + b * p.vn_sb + h * p.vn_sh + col);
  }
}

Pool make_pool(const void* k_pool, const void* v_pool, const int* bt, int page, int n_tables,
               long long page_stride, long long row_stride, long long head_stride,
               long long bt_sb) {
  Pool pl;
  pl.k = static_cast<const uint16_t*>(k_pool);
  pl.v = static_cast<const uint16_t*>(v_pool);
  pl.bt = bt;
  pl.page = page;
  pl.n_tables = n_tables;
  pl.page_stride = page_stride;
  pl.row_stride = row_stride;
  pl.head_stride = head_stride;
  pl.bt_sb = bt_sb;
  return pl;
}

}  // namespace

// The number of splits a table of `capacity` = n_tables * page rows is cut
// into (the wrapper sizes the partials with it).
extern "C" int paged_decode_splits(int capacity) { return (capacity + kChunk - 1) / kChunk; }

// bf16 operands; strides in elements, the head dim contiguous; K and V
// pools share one layout. part_m, part_l and part_acc are fp32 scratch of
// B*H*splits (and *D) elements. Returns the cudaError_t of the launches
// (0 = launched).
extern "C" int paged_flash_decode(
    const void* q, const void* k_pool, const void* v_pool, const int* block_table,
    const int* lengths, void* out, float* part_m, float* part_l, float* part_acc,
    int B, int H, int Hkv, int D, int page, int n_tables,
    long long q_sb, long long q_sh,
    long long page_stride, long long row_stride, long long head_stride, long long bt_sb,
    long long o_sb, long long o_sh, float softcap, void* stream) {
  if (Hkv <= 0 || H % Hkv || H / Hkv > kMaxGroup || page <= 0) return cudaErrorInvalidValue;
  DecodeParams p;
  p.pool = make_pool(k_pool, v_pool, block_table, page, n_tables, page_stride, row_stride,
                     head_stride, bt_sb);
  p.q = static_cast<const uint16_t*>(q);
  p.lengths = lengths;
  p.o = static_cast<uint16_t*>(out);
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.H = H;
  p.group = H / Hkv;
  p.splits = paged_decode_splits(n_tables * page);
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_decode<64>(p, B, Hkv, s);
  if (D == 128) return launch_decode<128>(p, B, Hkv, s);
  return cudaErrorInvalidValue;
}

// bf16 operands; strides in elements, the head dim contiguous. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int paged_flash_prefill(
    const void* q, const void* k_pool, const void* v_pool, const int* block_table,
    const int* starts, const int* lengths, void* out,
    int B, int S, int H, int Hkv, int D, int page, int n_tables,
    long long q_sb, long long q_ss, long long q_sh,
    long long page_stride, long long row_stride, long long head_stride, long long bt_sb,
    long long o_sb, long long o_ss, long long o_sh, float softcap, void* stream) {
  if (Hkv <= 0 || H % Hkv || page <= 0) return cudaErrorInvalidValue;
  PrefillParams p;
  p.pool = make_pool(k_pool, v_pool, block_table, page, n_tables, page_stride, row_stride,
                     head_stride, bt_sb);
  p.q = static_cast<const uint16_t*>(q);
  p.starts = starts;
  p.lengths = lengths;
  p.o = static_cast<uint16_t*>(out);
  p.S = S;
  p.H = H;
  p.group = H / Hkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  if (D == 64) paged_prefill_kernel<64><<<grid, kThreads, 0, s>>>(p);
  else if (D == 128) paged_prefill_kernel<128><<<grid, kThreads, 0, s>>>(p);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// bf16 pools (num_pages, page, Hkv, D) with the head dim contiguous and
// 8-element strides; k_new / v_new (B, 1, Hkv, D) through their batch and
// head strides. Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_kv_write(
    void* k_pool, void* v_pool, const void* k_new, const void* v_new,
    const int* page_idx, const int* row, int B, int Hkv, int D,
    long long page_stride, long long row_stride, long long head_stride,
    long long kn_sb, long long kn_sh, long long vn_sb, long long vn_sh, void* stream) {
  if (D % 8 || B <= 0) return cudaErrorInvalidValue;
  WriteParams p;
  p.k_pool = static_cast<uint16_t*>(k_pool);
  p.v_pool = static_cast<uint16_t*>(v_pool);
  p.k_new = static_cast<const uint16_t*>(k_new);
  p.v_new = static_cast<const uint16_t*>(v_new);
  p.page_idx = page_idx;
  p.row = row;
  p.Hkv = Hkv;
  p.D = D;
  p.page_stride = page_stride;
  p.row_stride = row_stride;
  p.head_stride = head_stride;
  p.kn_sb = kn_sb; p.kn_sh = kn_sh;
  p.vn_sb = vn_sb; p.vn_sh = vn_sh;
  paged_kv_write_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
