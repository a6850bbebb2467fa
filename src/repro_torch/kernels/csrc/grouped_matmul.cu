// Ragged grouped matmul for Hopper (sm_90a): the MoE expert GEMMs after
// sort-by-expert dispatch and their backward, bf16 in, fp32 accumulation.
//
// gmm_kernel replaces the TPU kernel `_gmm_kernel` behind `gmm` in
// src/repro/kernels/grouped_matmul.py (its pallas_call). Same contract:
// x (M, K) with rows sorted by group, w (E, K, N), group_sizes (E,) int32 on
// the device -> y (M, N) with y[i] = x[i] @ w[g(i)], where group g owns the
// contiguous rows [sum(sizes[:g]), sum(sizes[:g+1])); rows at or past
// sum(group_sizes) are exactly 0; an empty group costs no work. Its
// transposed mode (kTransW) computes the backward's dx = dy @ w[g]^T, which
// the reference gets by calling gmm on swapaxes(w, 1, 2), from the same
// (E, K, N) weights: a row-major (K, N) w[g] is the column-major B operand
// of mma.sync .row.col for a product of depth N, so nothing is copied.
//
// gmm_dw_kernel replaces `_tgmm_kernel` behind `gmm_dw` (its pallas_call):
// x (M, K) and dy (M, N) sorted by group -> dw (E, K, N) with dw[g] =
// x_g^T @ dy_g over group g's rows, fp32 sums written once in fp32 or bf16;
// an empty group's slice is exactly 0 and rows past sum(sizes) are never
// read.
//
// Design of gmm. The TPU kernel gets a flattened (group, m-tile) schedule
// from scalar prefetch and walks it along a sequential grid axis, revisiting
// an output block while its groups change. Hopper blocks run in no order
// and share nothing, so here every block derives the schedule itself, on
// the device, from the sizes: a block-wide prefix sum of the sizes gives
// each group's rows, a second one of each group's m-tile count gives the
// work list, and block x of the grid takes item x. The grid is fixed by
// static bounds, (num_m_tiles + E) items x (N / 128) column tiles, as the
// TPU kernel's L = num_m_tiles + E: items past the list return at once, so
// the host never reads the sizes. An item (g, m-tile) computes the tile's
// rows against w[g] and stores only the rows group g owns; a group that
// spans a tile boundary gets one item per tile. The items of one tile own
// disjoint rows, so no two blocks write one element: no atomics, and a call
// repeats bit for bit. The items past the groups zero-fill the rows from
// sum(sizes) to M. The product runs on the tensor cores through mma.sync
// m16n8k16 (mma.cuh): 4 warps, each 32 of the block's 128 columns and
// every row of its m-tile (16 rows at decode sizes, 64 above), fed by a
// 3-stage cp.async ring of 32-deep slices of x and w in shared memory.
// Rows outside the item's group load as zeros and are not stored.
//
// Design of gmm_dw. The TPU kernel walks the same (group, m-tile) list and
// accumulates a group's (K, 128) gradient block in place across the grid
// steps of that group, first visit initialising it. Here a block owns one
// (group g, 128 rows of K, 128 columns of N) tile of dw and walks all of
// g's rows itself: the block-wide prefix sum gives [start_g, end_g), a
// 3-stage cp.async ring brings 32 of those rows of x and dy at a time
// (rows at or past end_g load as zeros), and the 4 warps (2 x 2, each 64 x
// 64 of the tile) accumulate x^T dy in fp32 registers through mma.sync.
// Both operands are read down their rows, so their fragments come through
// ldmatrix .trans. The sum runs in one fixed order inside one block and the
// tile is written once: no atomics, no cross-block sum, a call repeats bit
// for bit; an empty group's blocks write zeros. The grid is (N / 128) x
// (K / 128) x E, fixed by static bounds.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16). gmm: memory. Each
// live group's (K, N) weight is read at least once: Llama-4-Scout's w_in at
// decode (16 live experts, K 5120, N 8192) is 1.34 GB, 0.40 ms, against
// 2 * M * K * N FLOP, 2.7 GFLOP at M = 32; the transposed mode at training
// (M 2048) reads the same bytes. A group that straddles an m-tile boundary
// reads its weight slice once per tile (from L2 when the blocks run close
// together). gmm_dw at Scout's w_in training shape (M 2048, K 5120, N 8192,
// E 16): 172 GFLOP (0.17 ms) against x + dy + dw = 2.73 GB with dw in fp32
// (0.82 ms) or 1.39 GB in bf16 (0.42 ms): memory, by the write of dw. Each
// block re-reads its group's rows of x and dy (from L2: a group's rows are
// ~3 MB); wgmma, TMA and a persistent schedule are the faster design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;       // output columns per block, 32 per warp
constexpr int kBK = 32;        // depth of one pipeline stage
constexpr int kStages = 3;
constexpr int kMaxGroups = kThreads;  // the schedule scans one group per thread
using T = __nv_bfloat16;              // every served config runs in bf16

struct Params {
  const uint16_t* x;  // (M, K)
  const uint16_t* w;  // (E, K, N)
  const int* sizes;   // (E,)
  uint16_t* y;        // (M, N)
  int M, K, N, E;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = full ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// inclusive prefix sum over the block, one value per thread; `total` gets
// the block's sum
__device__ __forceinline__ int block_scan(int v, int& total, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    before += i < warp ? s_warp[i] : 0;
    total += s_warp[i];
  }
  __syncthreads();  // s_warp free for the next scan
  return v + before;
}

// kTransW: w[g] is read as (N, K) row-major, i.e. y = x @ w[g]^T for a
// stored (E, N, K) w
template <int BM, bool kTransW>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sX[kStages][BM][kBK + kPad];
  // one stage of w: (k, n) rows of 128 columns, or in the transposed mode
  // (n, k) rows of 32
  __shared__ __align__(16) uint16_t sW[kStages][kTransW ? kBN : kBK][(kTransW ? kBK : kBN) + kPad];
  __shared__ int s_warp[kWarps];
  __shared__ int s_kind, s_g, s_lo, s_hi, s_m0;  // kind: 0 none, 1 group rows, 2 zero rows

  const int tid = threadIdx.x, item = blockIdx.x;

  // ---- the schedule, from the sizes on the device
  if (tid == 0) s_kind = 0;
  const int e = tid;
  const int sz = e < p.E ? max(p.sizes[e], 0) : 0;
  int sum;
  const int end_raw = block_scan(sz, sum, s_warp);
  const int start = min(end_raw - sz, p.M), end = min(end_raw, p.M);
  const int total = min(sum, p.M);
  const int tiles = end > start ? (end - 1) / BM - start / BM + 1 : 0;
  int n_group_items;
  const int cum = block_scan(tiles, n_group_items, s_warp);
  if (tiles > 0 && item >= cum - tiles && item < cum) {
    s_kind = 1;
    s_g = e;
    s_lo = start;
    s_hi = end;
    s_m0 = (start / BM + item - (cum - tiles)) * BM;
  }
  if (tid == 0 && total < p.M) {  // the zero tail: rows [total, M)
    const int first = total / BM, n_tail = (p.M - 1) / BM - first + 1;
    if (item >= n_group_items && item < n_group_items + n_tail) {
      s_kind = 2;
      s_lo = total;
      s_hi = p.M;
      s_m0 = (first + item - n_group_items) * BM;
    }
  }
  __syncthreads();
  const int kind = s_kind;
  if (kind == 0) return;  // past the work list
  const int m0 = s_m0, n0 = blockIdx.y * kBN;
  const int lo = max(s_lo, m0), hi = min(s_hi, m0 + BM);

  if (kind == 2) {
    for (int c = tid; c < BM * (kBN / 2); c += kThreads) {
      const int row = m0 + c / (kBN / 2), col = n0 + (c % (kBN / 2)) * 2;
      if (row >= lo && row < hi && col < p.N)
        *reinterpret_cast<uint32_t*>(p.y + (long long)row * p.N + col) = 0u;
    }
    return;
  }

  // ---- y[lo:hi, n0:n0+128] = x[lo:hi] @ w[g][:, n0:n0+128]
  const uint16_t* wg = p.w + (long long)s_g * p.K * p.N;
  const int nk = (p.K + kBK - 1) / kBK;
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const int row = m0 + r, k = k0 + col;
      const bool ok = row >= lo && row < hi && k < p.K;
      cp_async16(&sX[stage][r][col], ok ? p.x + (long long)row * p.K + k : p.x, ok);
    }
    if constexpr (kTransW) {
      for (int c = tid; c < kBN * (kBK / 8); c += kThreads) {
        const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
        const int n = n0 + r, k = k0 + col;
        const bool ok = k < p.K && n < p.N;
        cp_async16(&sW[stage][r][col], ok ? wg + (long long)n * p.K + k : p.w, ok);
      }
    } else {
      for (int c = tid; c < kBK * (kBN / 8); c += kThreads) {
        const int r = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
        const int k = k0 + r, n = n0 + col;
        const bool ok = k < p.K && n < p.N;
        cp_async16(&sW[stage][r][col], ok ? wg + (long long)k * p.N + n : p.w, ok);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[BM / 16][4][4];
#pragma unroll
  for (int mi = 0; mi < BM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed
    __syncthreads();               // ... for every thread; slice kt - 1 is consumed
    const int pre = kt + kStages - 1;
    if (pre < nk) load_stage(pre % kStages, pre);
    cp_async_commit();
    const uint16_t* xs = &sX[kt % kStages][0][0];
    const uint16_t* ws = &sW[kt % kStages][0][0];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if constexpr (kTransW)
          b_frag_rows<kBK>(b[ni][0], b[ni][1], ws, warp * 32 + ni * 8, kk, g, t);
        else
          b_frag_cols<kBN>(b[ni][0], b[ni][1], ws, kk, warp * 32 + ni * 8, g, t);
      }
#pragma unroll
      for (int mi = 0; mi < BM / 16; ++mi) {
        uint32_t a[4];
        a_frag<kBK>(a, xs, mi * 16, kk, g, t);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Mma<T>::run(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): rows m0 + 16 mi + g (+ 8), columns 2t, 2t + 1 of
  // the warp's n8 tile ni; only the group's rows are stored
#pragma unroll
  for (int mi = 0; mi < BM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + warp * 32 + ni * 8 + 2 * t;
      if (col >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mi * 16 + g + 8 * h;
        if (row >= lo && row < hi)
          *reinterpret_cast<uint32_t*>(p.y + (long long)row * p.N + col) =
              Mma<T>::pack(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

template <int BM, bool kTransW>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM + p.E, (p.N + kBN - 1) / kBN);
  gmm_kernel<BM, kTransW><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---- gmm_dw
constexpr int kDwBK = 128;                // rows of K per block
constexpr int kDwBN = 128;                // columns of N per block
constexpr int kDwBM = 32;                 // rows of x and dy per pipeline stage
constexpr int kDwStages = 3;
constexpr int kDwRow = 128 + kPad;        // shared row of a stage, both operands
constexpr int kDwTile = kDwBM * kDwRow;   // elements of one operand's stage
constexpr int kDwSmem = kDwStages * 2 * kDwTile * 2;  // bytes, 52 224

struct DwParams {
  const uint16_t* x;   // (M, K)
  const uint16_t* dy;  // (M, N)
  const int* sizes;    // (E,)
  void* dw;            // (E, K, N), fp32 or bf16
  int M, K, N, E;
};

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads) gmm_dw_kernel(const DwParams p) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sX = smem;                           // [stage][row][k]
  uint16_t* sD = smem + kDwStages * kDwTile;     // [stage][row][n]
  __shared__ int s_warp[kWarps];
  __shared__ int s_lo, s_hi;

  const int tid = threadIdx.x, grp = blockIdx.z;
  const int n0 = blockIdx.x * kDwBN, k0 = blockIdx.y * kDwBK;

  // ---- the group's rows, from the sizes on the device
  const int sz = tid < p.E ? max(p.sizes[tid], 0) : 0;
  int sum;
  const int end_raw = block_scan(sz, sum, s_warp);
  if (tid == grp) {
    s_lo = min(end_raw - sz, p.M);
    s_hi = min(end_raw, p.M);
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  const int nt = hi > lo ? (hi - lo + kDwBM - 1) / kDwBM : 0;

  auto load_stage = [&](int stage, int it) {
    const int m0 = lo + it * kDwBM;
    uint16_t* xs = sX + stage * kDwTile;
    uint16_t* ds = sD + stage * kDwTile;
    for (int c = tid; c < kDwBM * (kDwBK / 8); c += kThreads) {
      const int r = c / (kDwBK / 8), col = (c % (kDwBK / 8)) * 8;
      const int row = m0 + r, k = k0 + col;
      const bool ok = row < hi && k < p.K;
      cp_async16(xs + r * kDwRow + col, ok ? p.x + (long long)row * p.K + k : p.x, ok);
    }
    for (int c = tid; c < kDwBM * (kDwBN / 8); c += kThreads) {
      const int r = c / (kDwBN / 8), col = (c % (kDwBN / 8)) * 8;
      const int row = m0 + r, n = n0 + col;
      const bool ok = row < hi && n < p.N;
      cp_async16(ds + r * kDwRow + col, ok ? p.dy + (long long)row * p.N + n : p.dy, ok);
    }
  };

  // warp (wm, wn) owns rows [64 wm, 64 wm + 64) of the tile's K and columns
  // [64 wn, 64 wn + 64) of its N
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int lr = lane & 7, lt = lane >> 3;  // ldmatrix: row within tile lt
  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < nt) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kDwStages - 2>();  // rows of step it have landed
    __syncthreads();                 // ... for every thread; step it - 1 is consumed
    const int pre = it + kDwStages - 1;
    if (pre < nt) load_stage(pre % kDwStages, pre);
    cp_async_commit();
    const uint16_t* xs = sX + (it % kDwStages) * kDwTile;
    const uint16_t* ds = sD + (it % kDwStages) * kDwTile;
#pragma unroll
    for (int kk = 0; kk < kDwBM; kk += 16) {
      // A = x^T (16 of K x 16 rows), from the four 8 x 8 tiles of x:
      // a[0] K 0-7 rows 0-7, a[1] K 8-15 rows 0-7, a[2] K 0-7 rows 8-15,
      // a[3] K 8-15 rows 8-15
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_trans(a[mi], xs + (kk + lr + ((lt >> 1) << 3)) * kDwRow + wm * 64 + mi * 16 +
                                 ((lt & 1) << 3));
      // B = dy (16 rows x 8 N), two n8 tiles a load: b[2j] from tiles 0
      // (rows 0-7) and 1 (rows 8-15), b[2j + 1] from tiles 2 and 3
      uint32_t b[8][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, ds + (kk + lr + ((lt & 1) << 3)) * kDwRow + wn * 64 + nj * 16 +
                             ((lt >> 1) << 3));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) Mma<T>::run(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): K rows k0 + 64 wm + 16 mi + g (+ 8), N columns
  // n0 + 64 wn + 8 ni + 2t, + 1
  const long long base = (long long)grp * p.K;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn * 64 + ni * 8 + 2 * t;
      if (col >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wm * 64 + mi * 16 + g + 8 * h;
        if (k >= p.K) continue;
        const long long off = (base + k) * p.N + col;
        if constexpr (kBf16Out)
          *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(p.dw) + off) =
              Mma<T>::pack(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.dw) + off) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

template <bool kBf16Out>
int launch_dw(const DwParams& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_dw_kernel<kBf16Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + kDwBN - 1) / kDwBN, (p.K + kDwBK - 1) / kDwBK, p.E);
  gmm_dw_kernel<kBf16Out><<<grid, kThreads, kDwSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 operands, all contiguous; sizes is (E,) int32 on the device; K and N
// multiples of 8 (16-byte rows); block_m is 16 or 64 (rows per m-tile).
// trans_w = 0: y (M, N) = x (M, K) @ w[g], w stored (E, K, N);
// trans_w = 1: y (M, N) = x (M, K) @ w[g]^T, w stored (E, N, K).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int grouped_matmul(const void* x, const void* w, const int* sizes, void* y, int M,
                              int K, int N, int E, int block_m, int trans_w, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0 || E > kMaxGroups || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.w = static_cast<const uint16_t*>(w);
  p.sizes = sizes;
  p.y = static_cast<uint16_t*>(y);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_m == 16) return trans_w ? launch<16, true>(p, s) : launch<16, false>(p, s);
  if (block_m == 64) return trans_w ? launch<64, true>(p, s) : launch<64, false>(p, s);
  return cudaErrorInvalidValue;
}

// dw (E, K, N) = per group x_g^T @ dy_g: x (M, K) and dy (M, N) bf16,
// contiguous; sizes (E,) int32 on the device; K and N multiples of 8; dw in
// bf16 when out_bf16, else fp32. Returns the cudaError_t of the launch.
extern "C" int grouped_matmul_dw(const void* x, const void* dy, const int* sizes, void* dw, int M,
                                 int K, int N, int E, int out_bf16, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || E <= 0 || E > kMaxGroups || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  DwParams p;
  p.x = static_cast<const uint16_t*>(x);
  p.dy = static_cast<const uint16_t*>(dy);
  p.sizes = sizes;
  p.dw = dw;
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_dw<true>(p, s) : launch_dw<false>(p, s);
}
