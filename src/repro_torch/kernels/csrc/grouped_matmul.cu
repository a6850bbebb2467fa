// Ragged grouped matmul for Hopper (sm_90a): the MoE expert GEMMs after
// sort-by-expert dispatch and their backward, bf16 in, fp32 accumulation.
//
// The forward (gmm_fwd_rows_kernel, or gmm_fwd_split_kernel and
// gmm_fwd_sum_kernel) replaces the TPU kernel `_gmm_kernel` behind `gmm` in
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
// No kernel here uses atomics: each output element is summed in one fixed
// order and written once (the forward's decode mode sums its K splits'
// partials in a second pass, in order), so a call repeats bit for bit.
// Every block derives its work from the sizes on the device; the grids are
// fixed by static bounds, so the host never reads the sizes and a call
// makes no host sync. E is at most 128.
//
// The forward. The TPU kernel walks a flattened (group, m-tile) schedule
// from scalar prefetch along a sequential grid axis, its m-tiles counted
// from row 0, so a group that straddles tiles reads its weights once a tile.
// Here both modes are persistent wgmma + TMA kernels (below), and neither
// reads a weight tile twice within an item:
//
// gmm_fwd_rows_kernel (M > 128: admissions, prefill chunks, training) is the
// transposed mode's design (gmm_dx_kernel, below) with w[g] read MN-major:
// row tiles of 256 from each group's first row, only the m64 blocks holding
// the group's rows loaded and multiplied, 128 output columns an item, items
// group by group, column tile major, so each live group's weights come from
// device memory about once a call. w[g] (K, N) is read through a 3-D (N, K,
// E) map in boxes of 64 columns x 64 deep, as wgmma's B with the transpose
// flag, as gmm_dw_kernel reads dy.
//
// gmm_fwd_split_kernel and gmm_fwd_sum_kernel (M <= 128: decode) stream the
// weights. A live group holds a few of the rows, so the weights go on
// wgmma's M side, y_g^T = w_g^T x_g^T: A is 64 output columns of w[g], 64
// deep, read MN-major through the same map; B is the group's rows in chunks
// of 32 read K-major, the product n = 8, 16 or 32 wide (a 2-row group pads
// to 8, not to 64). A product's columns are independent, so a chunk loads
// whatever rows follow the group and stores only the group's. An item is
// (live group, 128 output columns, 1 / S of K): S is chosen on the device
// from the number of live groups, so that the items fill whole waves of the
// SMs (pick_split). Each split writes its fp32 partial sums to its own slice
// of a workspace, and gmm_fwd_sum_kernel adds the S partials in order,
// rounds once to bf16 and writes the rows past the groups as zeros. A ring
// of 6 stages of 32 KB keeps up to 96 KB of weights in flight an SM.
//
// The backward kernels, like the forward, are persistent (one block an SM,
// block b taking items b, b + grid, ...) wgmma + TMA kernels on hopper.cuh:
// a producer
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
// (0.42 ms), against the same 172 GFLOP: memory, and so does the forward
// at prefill. The forward at decode (16 live experts, M 32) reads the same
// weights for 2.7 GFLOP.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {
namespace persistent {

using namespace hopper;

constexpr int kThreads = 384;  // two consumer warpgroups and a producer warpgroup
constexpr int kBox = 8192;     // bytes of one 64 x 64 box of 16-bit values (64 rows of 128 bytes)
constexpr int kScan = 160;     // entries of a schedule's prefix sums: 5 a lane of one warp
constexpr int kMaxGroups = 128;

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

// ---- the row-tile kernels: gmm (transposed), y (M, N) = x_g (depth K) @
// w[g]^T with w stored (E, N, K), and the forward's row-tile mode, y = x_g @
// w[g] with w stored (E, K, N)
namespace dx {
constexpr int kBM = 256;                   // rows a tile: four m64 blocks, two a consumer warpgroup
constexpr int kBN = 128;                   // output columns a tile
constexpr int kABytes = 4 * kBox;          // x's slice: 256 rows x 64 deep, 32 KB
constexpr int kBBytes = 2 * kBox;          // w's slice: 128 output columns x 64 deep, 16 KB
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

// Both row-tile kernels: A is x's rows, K-major; B is w[g], K-major through
// a 3-D (depth, N, E) map in one 128 x 64 box for the transposed mode, or
// MN-major through a 3-D (N, K, E) map in two 64 x 64 boxes for the forward
// (kFwd).
template <bool kFwd>
__device__ __forceinline__ void rows_body(const CUtensorMap* mx, const CUtensorMap* mw,
                                          const int* __restrict__ sizes, const DxParams& p) {
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
          for (int b = 0; b < nblk; ++b) tma_load(st + b * kBox, mx, 64 * s, it.m0 + 64 * b, &full[stage]);
          if constexpr (kFwd) {
            tma_load(st + kABytes, mw, it.n0, 64 * s, it.q, &full[stage]);
            tma_load(st + kABytes + kBox, mw, it.n0 + 64, 64 * s, it.q, &full[stage]);
          } else {
            tma_load(st + kABytes, mw, 64 * s, it.n0, it.q, &full[stage]);
          }
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
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (kFwd)
              Wgmma<__nv_bfloat16>::ss<0, 1>(acc[j], kmajor_desc(st + (wg + 2 * j) * kBox, kk),
                                             mnmajor_desc(st + kABytes, kk, kBox), s > 0 || kk > 0);
            else
              Wgmma<__nv_bfloat16>::ss<0, 0>(acc[j], kmajor_desc(st + (wg + 2 * j) * kBox, kk),
                                             kmajor_desc(st + kABytes, kk), s > 0 || kk > 0);
          }
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

__global__ void __launch_bounds__(kThreads, 1)
    gmm_dx_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                  const int* __restrict__ sizes, const DxParams p) {
  rows_body<false>(&mx, &mw, sizes, p);
}

__global__ void __launch_bounds__(kThreads, 1)
    gmm_fwd_rows_kernel(const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mw, const int* __restrict__ sizes,
                        const DxParams p) {
  rows_body<true>(&mx, &mw, sizes, p);
}

// ---- the forward's decode mode: y_g^T = w_g^T x_g^T, split over K
namespace split {
constexpr int kMaxRows = 128;                   // M at most: a group's rows in up to 4 chunks
constexpr int kChunk = 32;                      // rows a chunk, the widest product of this mode
constexpr int kChunkBytes = kChunk * 128;       // a chunk's slice: 32 rows x 64 deep, 4 KB
constexpr int kBN = 128;                        // output columns an item: 64 a consumer warpgroup
constexpr int kABytes = 2 * kBox;               // w's slice: 64 deep x 128 columns, 16 KB
constexpr int kBBytes = (kMaxRows / kChunk) * kChunkBytes;  // x's slice, 16 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 6;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + swizzle alignment
constexpr int kMaxSplit = 8;                    // the workspace holds this many partials
constexpr int kItemCost = 1;                    // an item's fixed cost, in 64-deep slices
}  // namespace split

struct SplitParams {
  float* ws;  // (kMaxSplit, M, N): split s's partial sums of row r in ws[s][r]
  uint16_t* y;
  int M, K, N, E, tiles_n, n_slices, sms;
};

// The number of K splits: the S in 1 .. kMaxSplit (at most one a slice)
// whose items, `tiles` (live group, column tile) pairs times S, take the
// fewest slices on the busiest of `sms` blocks, counting each item's fixed
// cost; the smaller S on a tie. Every block of both decode-mode kernels
// computes it from the same sizes.
__device__ __forceinline__ int pick_split(int tiles, int n_slices, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= split::kMaxSplit && s <= n_slices; ++s) {
    const long long waves = ((long long)tiles * s + sms - 1) / sms;
    const long long cost = waves * ((n_slices + s - 1) / s + split::kItemCost);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// s_live[0 .. L) = the groups that own rows, in order; returns L. One warp
// calls it after group_starts.
__device__ __forceinline__ int live_groups(int E, const int* s_start, int* s_live) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const bool live = e < E && s_start[e + 1] > s_start[e];
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) s_live[count + __popc(mask & ((1u << lane) - 1))] = e;
    count += __popc(mask);
  }
  __syncwarp();
  return count;
}

// Item i: (live group j, column tile t, split k), split fastest, then
// column tile: i = (j * tiles_n + t) * S + k. Split k sums the 64-deep
// slices [k * n_slices / S, (k + 1) * n_slices / S).
struct SplitItem {
  int g, start, end, n0, s0, s1, k;
  __device__ __forceinline__ SplitItem(const SplitParams& p, const int* s_start,
                                       const int* s_live, int n_split, int i) {
    k = i % n_split;
    const int t = i / n_split;
    n0 = (t % p.tiles_n) * split::kBN;
    g = s_live[t / p.tiles_n];
    start = s_start[g];
    end = s_start[g + 1];
    s0 = k * p.n_slices / n_split;
    s1 = (k + 1) * p.n_slices / n_split;
  }
};

// One item's products and partial sums for a product NR rows wide (8, 16 or
// 32): chunk c of the group's rows is B's columns, A is this warpgroup's 64
// output columns of the weight slice.
template <int NR>
__device__ __forceinline__ void split_item(const SplitParams& p, const SplitItem& it, uint32_t base,
                                           uint64_t* full, uint64_t* empty, int& stage,
                                           uint32_t& phase, int wg, int wtid) {
  using namespace split;
  const int lane = wtid & 31, nch = (it.end - it.start + kChunk - 1) / kChunk;
  float acc[kMaxRows / kChunk][NR / 2];
  int prev = -1;
  for (int s = it.s0; s < it.s1; ++s) {
    mbar_wait(&full[stage], phase);
    const uint32_t st = base + stage * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kMaxRows / kChunk; ++c)
        if (c < nch)
          Wgmma<__nv_bfloat16>::ss<1, 0>(acc[c], mnmajor_desc(st + wg * kBox, kk, kBox),
                                         kmajor_desc(st + kABytes + c * kChunkBytes, kk),
                                         s > it.s0 || kk > 0);
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
#pragma unroll
  for (int c = 0; c < kMaxRows / kChunk; ++c) reg_fence(acc[c]);
  if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
  // acc[c][4 i + 2 hh + e]: output column n0 + 64 wg + 16 w + g + 8 hh, row
  // start + 32 c + 8 i + 2 t + e of the group; only the group's rows stored
  float* const out = p.ws + (long long)it.k * p.M * p.N;
  const int col = it.n0 + 64 * wg + 16 * (wtid >> 5) + (lane >> 2);
#pragma unroll
  for (int c = 0; c < kMaxRows / kChunk; ++c) {
    if (c >= nch) continue;
#pragma unroll
    for (int i = 0; i < NR / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = it.start + kChunk * c + 8 * i + 2 * (lane & 3) + e, n = col + 8 * hh;
          if (r < it.end && n < p.N) out[(long long)r * p.N + n] = acc[c][4 * i + 2 * hh + e];
        }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    gmm_fwd_split_kernel(const __grid_constant__ CUtensorMap mx,
                         const __grid_constant__ CUtensorMap mw, const int* __restrict__ sizes,
                         const SplitParams p) {
  using namespace split;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int s_start[kScan], s_live[kScan], s_count;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid < 32) {
    group_starts(sizes, p.E, p.M, s_start);
    const int n_live = live_groups(p.E, s_start, s_live);
    if (tid == 0) s_count = n_live;
  }
  if (tid == 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_split = pick_split(s_count * p.tiles_n, p.n_slices, p.sms);
  const int n_items = s_count * p.tiles_n * n_split;

  if (wg == 2) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const SplitItem it(p, s_start, s_live, n_split, i);
        const int nch = (it.end - it.start + kChunk - 1) / kChunk;
        for (int s = it.s0; s < it.s1; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kABytes + nch * kChunkBytes);
          const uint32_t st = base + stage * kStageBytes;
          tma_load(st, &mw, it.n0, 64 * s, it.g, &full[stage]);
          tma_load(st + kBox, &mw, it.n0 + 64, 64 * s, it.g, &full[stage]);
          for (int c = 0; c < nch; ++c)
            tma_load(st + kABytes + c * kChunkBytes, &mx, 64 * s, it.start + kChunk * c, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups: wg owns output columns [64 wg, 64 wg + 64) of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wtid = tid & 127;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const SplitItem it(p, s_start, s_live, n_split, i);
    const int rows = it.end - it.start;
    if (rows <= 8)
      split_item<8>(p, it, base, full, empty, stage, phase, wg, wtid);
    else if (rows <= 16)
      split_item<16>(p, it, base, full, empty, stage, phase, wg, wtid);
    else
      split_item<32>(p, it, base, full, empty, stage, phase, wg, wtid);
  }
}

// y[r] = the S partials of row r added in order and rounded once to bf16,
// for the rows the groups own; the rows past them exactly 0. Four columns a
// thread.
__global__ void __launch_bounds__(256)
    gmm_fwd_sum_kernel(const int* __restrict__ sizes, const SplitParams p) {
  __shared__ int s_start[kScan], s_live[kScan], s_count;
  if (threadIdx.x < 32) {
    group_starts(sizes, p.E, p.M, s_start);
    const int n_live = live_groups(p.E, s_start, s_live);
    if (threadIdx.x == 0) s_count = n_live;
  }
  __syncthreads();
  const int n_split = pick_split(s_count * p.tiles_n, p.n_slices, p.sms);
  const int total = s_start[p.E];
  const long long quads = (long long)p.M * p.N / 4, plane = (long long)p.M * p.N;
  for (long long q = blockIdx.x * 256ll + threadIdx.x; q < quads; q += 256ll * gridDim.x) {
    const long long o = 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (o / p.N < total)
      for (int k = 0; k < n_split; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(p.ws + k * plane + o);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
    *reinterpret_cast<uint2*>(p.y + o) =
        make_uint2(Mma<__nv_bfloat16>::pack(v.x, v.y), Mma<__nv_bfloat16>::pack(v.z, v.w));
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

// the forward: the row-tile mode above 128 rows, the decode mode (split
// over K, then the ordered sum of the partials in ws) at or below
int launch_fwd(const void* x, const void* w, const int* sizes, void* y, void* ws, int M, int K,
               int N, int E, cudaStream_t stream) {
  CUtensorMap mx, mw;
  if (M > split::kMaxRows) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        gmm_fwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dx::kSmem);
    if (attr != cudaSuccess) return attr;
    if (!map2d(&mx, x, K, M, 64) || !map3d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, E, 64))
      return -1;
    DxParams p;
    p.y = static_cast<uint16_t*>(y);
    p.M = M;
    p.K = K;
    p.N = N;
    p.E = E;
    p.tiles_n = (N + dx::kBN - 1) / dx::kBN;
    const long long bound = ((long long)(M + dx::kBM - 1) / dx::kBM + E + 1) * p.tiles_n;
    const int grid = int(bound < num_sms() ? bound : num_sms());
    gmm_fwd_rows_kernel<<<grid, kThreads, dx::kSmem, stream>>>(mx, mw, sizes, p);
    return cudaGetLastError();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_fwd_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, split::kSmem);
  if (attr != cudaSuccess) return attr;
  if (ws == nullptr) return cudaErrorInvalidValue;
  if (!map2d(&mx, x, K, M, split::kChunk) ||
      !map3d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, E, 64))
    return -1;
  SplitParams p;
  p.ws = static_cast<float*>(ws);
  p.y = static_cast<uint16_t*>(y);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  p.tiles_n = (N + split::kBN - 1) / split::kBN;
  p.n_slices = (K + 63) / 64;
  p.sms = num_sms();
  gmm_fwd_split_kernel<<<p.sms, kThreads, split::kSmem, stream>>>(mx, mw, sizes, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long quads = (long long)M * N / 4;
  const int blocks = int(quads / 256 + 1 < 4 * p.sms ? quads / 256 + 1 : 4 * p.sms);
  gmm_fwd_sum_kernel<<<blocks, 256, 0, stream>>>(sizes, p);
  return cudaGetLastError();
}

}  // namespace persistent

}  // namespace

// bf16 operands, all contiguous and 16-byte aligned; sizes is (E,) int32 on
// the device; K and N multiples of 8 (16-byte rows); E at most 128.
// trans_w = 0: y (M, N) = x (M, K) @ w[g], w stored (E, K, N), by
// gmm_fwd_rows_kernel when M > 128, else by gmm_fwd_split_kernel and
// gmm_fwd_sum_kernel with ws, an fp32 workspace of (8, M, N);
// trans_w = 1: y (M, N) = x (M, K) @ w[g]^T, w stored (E, N, K), by
// gmm_dx_kernel (ws is not read).
// Returns the cudaError_t of the launch (0 = launched), or -1 if the driver
// refused a tensor map.
extern "C" int grouped_matmul(const void* x, const void* w, const int* sizes, void* y, void* ws,
                              int M, int K, int N, int E, int trans_w, void* stream) {
  using persistent::kMaxGroups;
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0 || E > kMaxGroups || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_w) return persistent::launch_dx(x, w, sizes, y, M, K, N, E, s);
  return persistent::launch_fwd(x, w, sizes, y, ws, M, K, N, E, s);
}

// dw (E, K, N) = per group x_g^T @ dy_g: x (M, K) and dy (M, N) bf16,
// contiguous and 16-byte aligned; sizes (E,) int32 on the device; K and N
// multiples of 8; E at most 128; dw in bf16 when out_bf16, else fp32.
// Returns the cudaError_t of the launch, or -1 if the driver refused a
// tensor map.
extern "C" int grouped_matmul_dw(const void* x, const void* dy, const int* sizes, void* dw, int M,
                                 int K, int N, int E, int out_bf16, void* stream) {
  using persistent::kMaxGroups;
  if (M < 0 || N <= 0 || K <= 0 || E <= 0 || E > kMaxGroups || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? persistent::launch_dw<true>(x, dy, sizes, dw, M, K, N, E, s)
                  : persistent::launch_dw<false>(x, dy, sizes, dw, M, K, N, E, s);
}
