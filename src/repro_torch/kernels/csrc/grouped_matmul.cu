// Ragged grouped matmul for Hopper (sm_90a): the MoE expert GEMMs after
// sort-by-expert dispatch and their backward, bf16 in, fp32 accumulation.
//
// gmm_kernel replaces the TPU kernel `_gmm_kernel` behind `gmm` in
// src/repro/kernels/grouped_matmul.py (its pallas_call): x (M, K) with rows
// sorted by group, w (E, K, N), group_sizes (E,) int32 on the device -> y
// (M, N) with y[i] = x[i] @ w[g(i)], where group g owns the contiguous rows
// [sum(sizes[:g]), sum(sizes[:g+1])); rows at or past sum(group_sizes) are
// exactly 0; an empty group costs no work. gmm_dx_kernel is gmm's
// transposed mode, the backward's dx = dy @ w[g]^T, which the reference
// gets by calling gmm on swapaxes(w, 1, 2): it reads the same (E, K, N)
// weights, stored rows of w being output columns with their depth
// contiguous, so nothing is copied. gmm_dw_kernel replaces `_tgmm_kernel`
// behind `gmm_dw` (its pallas_call): x (M, K) and dy (M, N) sorted by
// group -> dw (E, K, N) with dw[g] = x_g^T @ dy_g over group g's rows, fp32
// sums written once in fp32 or bf16; an empty group's slice is exactly 0 and
// rows past sum(sizes) are never summed.
//
// No kernel here uses atomics or sums across blocks: each output element is
// summed in one fixed order by one block and written once, so a call
// repeats bit for bit. Every block derives its work from the sizes on the
// device; the grids are fixed by static bounds, so the host never reads the
// sizes and a call makes no host sync. E is at most 128.
//
// The forward, gmm_kernel (mma.sync). The TPU kernel walks a flattened
// (group, m-tile) schedule from scalar prefetch along a sequential grid
// axis. Here a block-wide prefix sum of the sizes gives each group's rows,
// a second one of each group's m-tile count gives the work list, and block
// x of a grid of (num_m_tiles + E) items x (N / 128) column tiles takes
// item x; items past the list return at once, those past the groups
// zero-fill rows [sum(sizes), M). An item (g, m-tile) computes the tile's
// rows against w[g] through mma.sync m16n8k16 (mma.cuh; 4 warps, 16 rows
// at decode sizes, 64 above, a 3-stage cp.async ring of 32-deep slices) and
// stores only the rows group g owns. It serves Llama-4-Scout's generation,
// whose route check (chip_smoke.py) reads the largest router margin among
// the routes' differing decisions against a bound that equally accurate
// kernels straddle, so any change to this kernel's bits can trip that
// check: it keeps the mma.sync design and its summation order.
//
// The backward kernels are persistent (one block an SM, block b taking
// items b, b + grid, ...) wgmma + TMA kernels on hopper.cuh: a producer
// warpgroup, of which one thread has the Tensor Memory Accelerator copy
// 64-deep slices (128-byte swizzle) into rings of stages with full / empty
// mbarriers, and two consumer warpgroups that run wgmma with fp32
// accumulators in registers (setmaxnreg: 24 registers a producer thread, 240
// a consumer thread).
//
// gmm_dw_kernel. The TPU kernel accumulates a group's (K, 128) block in
// place across the grid steps of the group. Here a block owns whole tiles
// of dw, (group g, 128 rows of K, 256 columns of N), taken group by group;
// the two consumer warpgroups (64 rows of K each, two m64n128k16 products a
// 16-deep step) sum x_g^T dy_g over g's rows in 64-row slices, both
// operands read MN-major (a stored row is one token) straight from x and dy
// into a 3-stage ring: boxes start at the group's first row, whatever it
// is. TMA zero-fills only past the tensors' extents, so in a group's last
// slice the consumers zero the rows past the group's end (the next group's
// or the dropped tail's, which may hold anything finite: 1e30 * -1e30 would
// give -inf) in shared memory, whole 128-byte stored rows that the swizzle
// leaves intact, then fence the proxy and meet at a barrier before wgmma
// reads them. The epilogue rounds the accumulators once to the output
// dtype into a 128-byte-swizzled staging tile (one per consumer warpgroup)
// and one thread writes it with TMA stores through a 3-D (N, K, E) map, so
// rows past K and columns past N are clipped and never touch the next
// group's slice. The stores carry an L2 evict-first policy, so the stream
// of dw does not push the operands' slices out of L2; they drain while the
// next tile's products run, and a staging tile is written again only after
// its last store has read it. An empty group's tiles are stored as zeros;
// the host does nothing for them. Each tile re-reads its group's slices of
// x and dy from L2 (~2.5 GB at Scout's w_in shape); keeping dy's slices
// resident across a group's K tiles cut that 2.5x and measured no faster
// once the stores were evict-first (gmm_variants.py, on an H100): the
// write of dw, not the operands' L2 traffic, bounds the kernel.
//
// gmm_dx_kernel. Both operands are K-major (the TN case): A is x's rows
// (here dy; depth contiguous), B is w[g] through a 3-D (depth, N, E) map,
// 128 output columns an item. Row tiles start at the group's first row:
// group g's rows split into ceil(size_g / 256) tiles of 256 from start_g,
// so no tile spans two groups; a tile is four m64 blocks, two a consumer
// warpgroup, and only the blocks holding the group's rows are loaded and
// multiplied (a 160-row group computes 192 rows). Items run group by group,
// column tile major and row tile minor, so each live group's weights are
// read from device memory about once a call. Stores go straight from the
// accumulators, masked to the group's rows; items past the groups write
// rows [sum(sizes), M) as zeros.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), at Llama-4-Scout's
// w_in training shape (M 2048, K 5120, N 8192, E 16): gmm_dw is 2 * rows *
// K * N = 172 GFLOP (0.17 ms) against the dw write, 1.34 GB in bf16 (0.41
// ms with x and dy) or 2.68 GB in fp32 (0.81 ms): memory, by the write.
// The transposed gmm reads each live group's (K, N) weight once, 1.34 GB
// (0.42 ms), against the same 172 GFLOP: memory. The forward at decode
// (16 live experts, M 32) reads the same weights for 2.7 GFLOP.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

// ==== the forward: gmm_kernel, mma.sync

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

template <int BM>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sX[kStages][BM][kBK + kPad];
  // one stage of w: (k, n) rows of 128 columns
  __shared__ __align__(16) uint16_t sW[kStages][kBK][kBN + kPad];
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
    for (int c = tid; c < kBK * (kBN / 8); c += kThreads) {
      const int r = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
      const int k = k0 + r, n = n0 + col;
      const bool ok = k < p.K && n < p.N;
      cp_async16(&sW[stage][r][col], ok ? wg + (long long)k * p.N + n : p.w, ok);
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
      for (int ni = 0; ni < 4; ++ni)
        b_frag_cols<kBN>(b[ni][0], b[ni][1], ws, kk, warp * 32 + ni * 8, g, t);
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

template <int BM>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM + p.E, (p.N + kBN - 1) / kBN);
  gmm_kernel<BM><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ==== the backward: gmm_dw_kernel and gmm_dx_kernel, wgmma fed by TMA
namespace bwd {

using namespace hopper;

constexpr int kThreads = 384;  // two consumer warpgroups and a producer warpgroup
constexpr int kBox = 8192;     // bytes of one 64 x 64 box of 16-bit values (64 rows of 128 bytes)
constexpr int kScan = 160;     // entries of a schedule's prefix sums: 5 a lane of one warp

// The exclusive prefix sums of value(0 .. n - 1) into out[0 .. n], each
// capped at cap; out[n] is the (capped) total. n < kScan; one warp calls it.
template <class F>
__device__ __forceinline__ void warp_prefix(int n, int cap, F value, int* out) {
  const int lane = threadIdx.x & 31;
  int v[5], run = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int e = 5 * lane + j;
    v[j] = e < n ? value(e) : 0;
    run += v[j];
  }
  int inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  int ex = inc - run;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int e = 5 * lane + j;
    if (e <= n) out[e] = min(ex, cap);
    ex += v[j];
  }
  __syncwarp();
}

// s_start[g] = the first row of group g, s_start[E] = min(sum(sizes), M),
// every start capped at M (rows past M belong to no group); warp 0 writes
// it, the block's barrier then publishes it
__device__ __forceinline__ void group_starts(const int* sizes, int E, int M, int* s_start) {
  warp_prefix(E, M, [&](int e) { return max(sizes[e], 0); }, s_start);
}

// ---- gmm_dw: dw[g] (K, N) = x_g^T dy_g
namespace dw {
constexpr int kBK = 128;                   // rows of dw (K) a tile: 64 a consumer warpgroup
constexpr int kBN = 256;                   // columns of dw (N) a tile: two n128 products
constexpr int kSliceRows = 64;             // rows of x and dy (tokens) a slice
constexpr int kABytes = 2 * kBox;          // x's slice: 64 tokens x 128 of K, 16 KB
constexpr int kBBytes = 4 * kBox;          // dy's slice: 64 tokens x 256 of N, 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 3;
constexpr int kOut = 64 * kBN * 2;         // a warpgroup's staging tile: 64 x 256 bf16 (or 64 x 128 fp32)
constexpr int kSmem = kStages * kStageBytes + 2 * kOut + 1024;  // + swizzle alignment
}  // namespace dw

struct DwParams {
  int M, K, N, E, tiles_k, tiles_n, n_tiles;
};

// tile t -> (group, first row of K, first column of N): group-major, then N
// tile, then K tile, so the blocks at work at once share a group's rows
struct DwTile {
  int g, k0, n0;
  __device__ __forceinline__ DwTile(const DwParams& p, int t) {
    k0 = (t % p.tiles_k) * dw::kBK;
    n0 = (t / p.tiles_k % p.tiles_n) * dw::kBN;
    g = t / (p.tiles_k * p.tiles_n);
  }
};

// Zero the 128-byte stored rows [r0, 64) of the n boxes at dst: rows past
// the group's end in an MN-major slice (the 128-byte swizzle permutes 16-byte
// chunks within a stored row, so a stored row stays whole)
__device__ __forceinline__ void zero_rows(uint8_t* dst, int n, int r0, int tid) {
  const int per_box = (64 - r0) * 8;  // 16-byte chunks
  for (int c = tid; c < n * per_box; c += 128) {
    const int b = c / per_box, o = c % per_box;
    *reinterpret_cast<uint4*>(dst + b * kBox + r0 * 128 + o * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_dw_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdy,
                  const __grid_constant__ CUtensorMap mdw, const int* __restrict__ sizes,
                  const DwParams p) {
  using namespace dw;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int s_start[kScan];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const gbase = smem + (base - smem_u32(smem));  // the same bytes, generic address
  const uint32_t out = base + kStages * kStageBytes;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid < 32) group_starts(sizes, p.E, p.M, s_start);
  if (tid == 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        const DwTile it(p, t);
        for (int m0 = s_start[it.g]; m0 < s_start[it.g + 1]; m0 += kSliceRows) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageBytes);
          const uint32_t st = base + stage * kStageBytes;
#pragma unroll
          for (int c = 0; c < 2; ++c) tma_load(st + c * kBox, &mx, it.k0 + 64 * c, m0, &full[stage]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            tma_load(st + kABytes + c * kBox, &mdy, it.n0 + 64 * c, m0, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups: wg owns rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wtid = tid & 127, lane = tid & 31;
  const int row = 16 * (wtid >> 5) + (lane >> 2), col = 2 * (lane & 3);  // and row + 8
  uint8_t* const stage_out = gbase + (out - base) + wg * kOut;
  const uint32_t out_wg = out + wg * kOut;
  // dW is written once and read by no block: evict-first stores keep the
  // operands' slices in L2 (1-4% faster in bf16 and 3-10% in fp32 at
  // Scout's training shapes on an H100, gmm_variants.py)
  const uint64_t store_policy = l2_evict_first();
  int stage = 0;
  uint32_t phase = 0;
  float acc[2][64];  // columns [128 h, 128 h + 128) of the tile's 256
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const DwTile it(p, t);
    const int start = s_start[it.g], end = s_start[it.g + 1];
    int prev = -1;
    for (int m0 = start; m0 < end; m0 += kSliceRows) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = base + stage * kStageBytes;
      if (end - m0 < kSliceRows) {  // the group's last slice: zero the rows past its end
        uint8_t* const gst = gbase + (st - base);
        zero_rows(gst + wg * kBox, 1, end - m0, wtid);               // this warpgroup's x box
        zero_rows(gst + kABytes + 2 * wg * kBox, 2, end - m0, wtid);  // half of dy's boxes
        fence_proxy_async();
        named_barrier(1, 256);  // both halves of dy's slice are zeroed
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          Wgmma<__nv_bfloat16>::ss<1, 1>(acc[h], mnmajor_desc(st + wg * kBox, kk, kBox),
                                         mnmajor_desc(st + kABytes + 2 * h * kBox, kk, kBox),
                                         m0 > start || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the slice before this one is read
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: round once to the output dtype into the staging tile (the
    // TMA store's boxes, 128-byte swizzled), then one thread stores it; an
    // empty group's tile is written as zeros
    const int k0 = it.k0 + 64 * wg;
    const bool zero = end == start;
#pragma unroll
    for (int h = 0; h < (kBf16Out ? 1 : 2); ++h) {
      if (wtid == 0) bulk_wait_read<0>();  // the staging tile's last store has read it
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int hh = 0; hh < (kBf16Out ? 2 : 1); ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r8 = 0; r8 < 2; ++r8) {
            const int r = row + 8 * r8, x = 4 * j + 2 * r8;
            if constexpr (kBf16Out) {
              const int c = 128 * hh + 8 * j + col, cb = c & 63;  // box c / 64
              const int off = (c >> 6) * kBox + r * 128 + ((((cb >> 3) ^ (r & 7)) << 4) | ((cb & 7) << 1));
              *reinterpret_cast<uint32_t*>(stage_out + off) =
                  zero ? 0u : Mma<__nv_bfloat16>::pack(acc[hh][x], acc[hh][x + 1]);
            } else {
              const int c = 8 * j + col, cb = c & 31;  // box c / 32 of this half
              const int off = (c >> 5) * kBox + r * 128 + ((((cb >> 2) ^ (r & 7)) << 4) | ((cb & 3) << 2));
              *reinterpret_cast<float2*>(stage_out + off) =
                  zero ? make_float2(0.f, 0.f) : make_float2(acc[h][x], acc[h][x + 1]);
            }
          }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (wtid == 0 && k0 < p.K) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c0 = it.n0 + (kBf16Out ? 64 * b : 128 * h + 32 * b);
          if (c0 < p.N) tma_store(&mdw, out_wg + b * kBox, c0, k0, it.g, store_policy);
        }
        bulk_commit();
      }
    }
  }
  if (wtid == 0) bulk_wait<0>();  // every store has landed before the block ends
}

// ---- gmm (transposed): y (M, N) = x_g (depth K) @ w[g]^T, w stored (E, N, K)
namespace dx {
constexpr int kBM = 256;                   // rows a tile: four m64 blocks, two a consumer warpgroup
constexpr int kBN = 128;                   // output columns a tile
constexpr int kABytes = 4 * kBox;          // x's slice: 256 rows x 64 deep, 32 KB
constexpr int kBBytes = 2 * kBox;          // w's slice: 128 rows (output columns) x 64 deep, 16 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 4;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + swizzle alignment
}  // namespace dx

struct DxParams {
  uint16_t* y;
  int M, K, N, E, tiles_n;
};

// The work list: each group's rows split into tiles of kBM rows from its
// start, so that no tile spans two groups, then the rows [sum(sizes), M) as
// a last pseudo-group E that is written as zeros. s_tiles[q] counts the row
// tiles before pseudo-group q. Item i: pseudo-group q, then column tile
// major and row tile minor (a group's row tiles of one weight tile run
// side by side, so the weight tile comes from device memory once).
struct DxItem {
  int q, m0, hi, n0;
  __device__ __forceinline__ DxItem(const DxParams& p, const int* s_start, const int* s_tiles,
                                    int i) {
    int lo = 0, up = p.E;  // the last q with s_tiles[q] * tiles_n <= i
    while (lo < up) {
      const int mid = (lo + up + 1) >> 1;
      if (s_tiles[mid] * p.tiles_n <= i)
        lo = mid;
      else
        up = mid - 1;
    }
    q = lo;
    const int nt = s_tiles[q + 1] - s_tiles[q], local = i - s_tiles[q] * p.tiles_n;
    const int start = s_start[q], end = q < p.E ? s_start[q + 1] : p.M;
    m0 = start + (local % nt) * dx::kBM;
    hi = min(end, m0 + dx::kBM);
    n0 = (local / nt) * dx::kBN;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    gmm_dx_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                  const int* __restrict__ sizes, const DxParams p) {
  using namespace dx;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int s_start[kScan], s_tiles[kScan];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid < 32) {
    group_starts(sizes, p.E, p.M, s_start);
    warp_prefix(p.E + 1, 1 << 30, [&](int q) {
      const int rows = q < p.E ? s_start[q + 1] - s_start[q] : p.M - s_start[p.E];
      return (rows + kBM - 1) / kBM;
    }, s_tiles);
  }
  if (tid == 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_items = s_tiles[p.E + 1] * p.tiles_n;
  const int n_slices = (p.K + 63) / 64;

  if (wg == 2) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const DxItem it(p, s_start, s_tiles, i);
        if (it.q == p.E) continue;  // the zero tail: nothing to read
        const int nblk = (it.hi - it.m0 + 63) / 64;  // m64 blocks holding the group's rows
        for (int s = 0; s < n_slices; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], nblk * kBox + kBBytes);
          const uint32_t st = base + stage * kStageBytes;
          for (int b = 0; b < nblk; ++b) tma_load(st + b * kBox, &mx, 64 * s, it.m0 + 64 * b, &full[stage]);
          tma_load(st + kABytes, &mw, 64 * s, it.n0, it.q, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups: wg owns m64 blocks wg and wg + 2 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ctid = tid, lane = tid & 31;
  const int row = 16 * ((tid >> 5) & 3) + (lane >> 2), col = 2 * (lane & 3);  // and row + 8
  int stage = 0;
  uint32_t phase = 0;
  float acc[2][64];
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const DxItem it(p, s_start, s_tiles, i);
    if (it.q == p.E) {  // rows past the groups: exactly 0
      for (int c = ctid; c < kBM * (kBN / 2); c += 256) {
        const int r = it.m0 + c / (kBN / 2), n = it.n0 + 2 * (c % (kBN / 2));
        if (r < it.hi && n < p.N) *reinterpret_cast<uint32_t*>(p.y + (long long)r * p.N + n) = 0u;
      }
      continue;
    }
    const int nblk = (it.hi - it.m0 + 63) / 64;
    int prev = -1;
    for (int s = 0; s < n_slices; ++s) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = base + stage * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (wg + 2 * j < nblk) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<__nv_bfloat16>::ss<0, 0>(acc[j], kmajor_desc(st + (wg + 2 * j) * kBox, kk),
                                           kmajor_desc(st + kABytes, kk), s > 0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait<1>();  // the slice before this one is read
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    // the group's rows of the tile, rounded once to bf16
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int blk = wg + 2 * j;
      if (blk >= nblk) continue;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int n = it.n0 + 8 * x + col;
        if (n >= p.N) continue;
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          const int r = it.m0 + 64 * blk + row + 8 * r8;
          if (r < it.hi)
            *reinterpret_cast<uint32_t*>(p.y + (long long)r * p.N + n) =
                Mma<__nv_bfloat16>::pack(acc[j][4 * x + 2 * r8], acc[j][4 * x + 2 * r8 + 1]);
        }
      }
    }
  }
}

// 16-bit 2-D map: rows of `cols` elements (contiguous), box 64 x box_rows
bool map2d(CUtensorMap* m, const void* p, int cols, int rows, int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims, strides, box);
}

// 3-D map of a contiguous (d2, d1, d0) tensor of elem-byte values, box
// (128 bytes of d0) x box1 x 1
bool map3d(CUtensorMap* m, const void* p, CUtensorMapDataType type, int elem, int d0, int d1,
           int d2, int box1) {
  const cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1), cuuint64_t(d2)};
  const cuuint64_t strides[2] = {cuuint64_t(d0) * elem, cuuint64_t(d0) * d1 * elem};
  const cuuint32_t box[3] = {cuuint32_t(128 / elem), cuuint32_t(box1), 1};
  return make_map(m, type, 3, p, dims, strides, box);
}

template <bool kBf16Out>
int launch_dw(const void* x, const void* dy, const int* sizes, void* dwp, int M, int K, int N,
              int E, cudaStream_t stream) {
  // the dynamic shared memory, granted once per process (the attribute
  // stays set for the function)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_dw_kernel<kBf16Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, dw::kSmem);
  if (attr != cudaSuccess) return attr;
  // with M = 0 every group is empty and nothing is read: the maps then
  // point at dw, one row deep
  CUtensorMap mx, mdy, mdw;
  const int rows = M > 0 ? M : 1;
  if (!map2d(&mx, M > 0 ? x : dwp, K, rows, 64) || !map2d(&mdy, M > 0 ? dy : dwp, N, rows, 64) ||
      !map3d(&mdw, dwp, kBf16Out ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             kBf16Out ? 2 : 4, N, K, E, 64))
    return -1;
  DwParams p;
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  p.tiles_k = (K + dw::kBK - 1) / dw::kBK;
  p.tiles_n = (N + dw::kBN - 1) / dw::kBN;
  p.n_tiles = E * p.tiles_k * p.tiles_n;
  const int grid = p.n_tiles < num_sms() ? p.n_tiles : num_sms();
  gmm_dw_kernel<kBf16Out><<<grid, kThreads, dw::kSmem, stream>>>(mx, mdy, mdw, sizes, p);
  return cudaGetLastError();
}

int launch_dx(const void* x, const void* w, const int* sizes, void* y, int M, int K, int N, int E,
              cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gmm_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dx::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mx, mw;
  if (!map2d(&mx, x, K, M, 64) || !map3d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, E, dx::kBN))
    return -1;
  DxParams p;
  p.y = static_cast<uint16_t*>(y);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  p.tiles_n = (N + dx::kBN - 1) / dx::kBN;
  // static bound of the work list: sum over groups of ceil(rows / kBM) <=
  // M / kBM + E, and the tail's tiles
  const long long bound = ((long long)(M + dx::kBM - 1) / dx::kBM + E + 1) * p.tiles_n;
  const int grid = int(bound < num_sms() ? bound : num_sms());
  gmm_dx_kernel<<<grid, kThreads, dx::kSmem, stream>>>(mx, mw, sizes, p);
  return cudaGetLastError();
}

}  // namespace bwd

}  // namespace

// bf16 operands, all contiguous and 16-byte aligned; sizes is (E,) int32 on
// the device; K and N multiples of 8 (16-byte rows); E at most 128.
// trans_w = 0: y (M, N) = x (M, K) @ w[g], w stored (E, K, N), by
// gmm_kernel with block_m (16 or 64) rows per m-tile;
// trans_w = 1: y (M, N) = x (M, K) @ w[g]^T, w stored (E, N, K), by
// gmm_dx_kernel (block_m is not read).
// Returns the cudaError_t of the launch (0 = launched), or -1 if the driver
// refused a tensor map.
extern "C" int grouped_matmul(const void* x, const void* w, const int* sizes, void* y, int M,
                              int K, int N, int E, int block_m, int trans_w, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0 || E > kMaxGroups || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_w) return bwd::launch_dx(x, w, sizes, y, M, K, N, E, s);
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.w = static_cast<const uint16_t*>(w);
  p.sizes = sizes;
  p.y = static_cast<uint16_t*>(y);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  if (block_m == 16) return launch<16>(p, s);
  if (block_m == 64) return launch<64>(p, s);
  return cudaErrorInvalidValue;
}

// dw (E, K, N) = per group x_g^T @ dy_g: x (M, K) and dy (M, N) bf16,
// contiguous and 16-byte aligned; sizes (E,) int32 on the device; K and N
// multiples of 8; E at most 128; dw in bf16 when out_bf16, else fp32.
// Returns the cudaError_t of the launch, or -1 if the driver refused a
// tensor map.
extern "C" int grouped_matmul_dw(const void* x, const void* dy, const int* sizes, void* dw, int M,
                                 int K, int N, int E, int out_bf16, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || E <= 0 || E > kMaxGroups || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? bwd::launch_dw<true>(x, dy, sizes, dw, M, K, N, E, s)
                  : bwd::launch_dw<false>(x, dy, sizes, dw, M, K, N, E, s);
}
