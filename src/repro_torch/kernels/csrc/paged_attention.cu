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
//   * decode: flash_decode.cu's split and combine kernels, whose bodies it
//     shares (decode_split.cuh): fixed 256-key chunks, one block per (row,
//     kv head, chunk), four warps streaming 16-key K/V stages through
//     cp.async rings, QK^T and PV on mma.sync with an online softmax, fp32
//     partials combined in chunk order. Only a stage's address differs.
//     At a page that is a multiple of 16 (the served 16) a stage lies in
//     one page: one table read gives its base, `pool + bt[b, pos / page] *
//     page_stride + (pos % page) * row_stride`, and the rows follow at the
//     row stride. At any other page (8, 12, ...) a stage spans pages, and
//     lane r of the warp looks up row r's offset, which the copy reads by
//     shuffle. The arithmetic and its order are flash_decode's, so at page
//     16 a paged row gives bit for bit what flash_decode gives over the
//     same rows gathered into a dense cache. No atomics, so a step repeats
//     bit for bit, and a row's split depends only on its own length.
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

#include "decode_split.cuh"
#include "mma.cuh"

namespace {

constexpr int kTile = 64;     // prefill: keys per shared-memory tile
constexpr int kBlockQ = 64;   // prefill: query rows per block, 4 warps x 16
constexpr int kThreads = 128;
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
// one warp copies the kSub rows whose pool offsets lane r < kSub holds in
// `off` (-1: not live, zero-filled without a read) into a stage
template <int D>
__device__ __forceinline__ void kv_stage_rows(uint16_t* dst, const uint16_t* base, long long off,
                                              int lane) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int i = 0; i < decode::kSub * kPerRow / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / kPerRow, col = (c % kPerRow) * 8;
    const long long o = __shfl_sync(0xffffffffu, off, r);
    cp_async16(dst + r * decode::Smem<D>::kPitch + col, base + (o < 0 ? 0 : o) + col, o >= 0);
  }
}

// a stage's K and V rows through the block table: kByRow false, the page a
// multiple of 16, so the stage lies in one page; kByRow true, any page,
// each row looked up by its own lane
template <bool kByRow>
struct Paged {
  const uint16_t* k;
  const uint16_t* v;
  const int* bt;  // (B, n_tables)
  int page;
  long long page_stride, row_stride, head_stride, bt_sb;

  template <int D>
  __device__ __forceinline__ void stage(uint16_t* dk, uint16_t* dv, int b, int hk, int k0,
                                        int key0, int n, int lane) const {
    const int* row = bt + b * bt_sb;
    const int pos0 = k0 + key0;
    const long long head = hk * head_stride;
    if (!kByRow) {
      const long long base = (long long)row[pos0 / page] * page_stride +
                             (long long)(pos0 % page) * row_stride + head;
      decode::kv_stage<D>(dk, k + base, row_stride, 0, n - key0, lane);
      decode::kv_stage<D>(dv, v + base, row_stride, 0, n - key0, lane);
    } else {
      long long off = -1;
      if (lane < decode::kSub && key0 + lane < n) {
        const int pos = pos0 + lane;
        off = (long long)row[pos / page] * page_stride + (long long)(pos % page) * row_stride;
      }
      kv_stage_rows<D>(dk, k + head, off, lane);
      kv_stage_rows<D>(dv, v + head, off, lane);
    }
  }
};

template <int D, bool kByRow>
__global__ void __launch_bounds__(decode::kThreads)
    paged_decode_split_kernel(const decode::Split p, const Paged<kByRow> a) {
  extern __shared__ __align__(16) uint8_t smem[];
  decode::split_body<D>(p, a, smem);
}

template <int D>
__global__ void __launch_bounds__(D / 2) paged_decode_combine_kernel(const decode::Split p) {
  decode::combine_body<D>(p);
}

template <int D, bool kByRow>
cudaError_t launch_decode(const decode::Split& p, const Paged<kByRow>& a, int B, int Hkv,
                          cudaStream_t stream) {
  constexpr int kBytes = decode::Smem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_split_kernel<D, kByRow>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  paged_decode_split_kernel<D, kByRow>
      <<<dim3(p.splits, Hkv, B), decode::kThreads, kBytes, stream>>>(p, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<D><<<B * p.H, D / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_decode(const decode::Split& p, const Pool& pl, int B, int Hkv,
                          cudaStream_t stream) {
  const bool by_row = pl.page % decode::kSub != 0;
  if (by_row) {
    const Paged<true> a{pl.k, pl.v, pl.bt, pl.page, pl.page_stride, pl.row_stride,
                        pl.head_stride, pl.bt_sb};
    return launch_decode<D, true>(p, a, B, Hkv, stream);
  }
  const Paged<false> a{pl.k, pl.v, pl.bt, pl.page, pl.page_stride, pl.row_stride,
                       pl.head_stride, pl.bt_sb};
  return launch_decode<D, false>(p, a, B, Hkv, stream);
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
extern "C" int paged_decode_splits(int capacity) { return decode::splits_of(capacity); }

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
  if (Hkv <= 0 || H % Hkv || H / Hkv > decode::kMaxGroup || page <= 0)
    return cudaErrorInvalidValue;
  decode::Split p = decode::make_split(q, lengths, out, part_m, part_l, part_acc, H, Hkv, D, q_sb,
                                       q_sh, o_sb, o_sh, softcap);
  p.T = n_tables * page;
  p.splits = decode::splits_of(p.T);
  const Pool pl = make_pool(k_pool, v_pool, block_table, page, n_tables, page_stride, row_stride,
                            head_stride, bt_sb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_decode<64>(p, pl, B, Hkv, s);
  if (D == 128) return launch_decode<128>(p, pl, B, Hkv, s);
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
