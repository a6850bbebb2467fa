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
//     = new[b] for K and V, in place. The decode step runs it fused into
//     the decode's split kernel (`paged_decode_append`); the standalone
//     kernel stays (`paged_kv_write`).
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
//     query rows per kv head), so it is flash_attention_fwd.cu's design on
//     the consumer body they share (attention_fwd.cuh): persistent blocks
//     taking (128-query tile, b, h) items heaviest (last) tile first; two
//     consumer warpgroups of 64 query rows with S = Q K^T and O += P V on
//     wgmma and the online softmax in registers; a producer warp filling a
//     ring of (K tile, V tile) stages through `full` / `empty` mbarriers.
//     Key tiles (64 keys at D 128, 128 at D 64) are aligned to absolute
//     positions, not to the chunk's start, so a query row's result does not
//     depend on where the chunk boundaries fell, and the arithmetic is the
//     dense forward's: a chunk gives, bit for bit, what flash_attention_fwd
//     gives with q_offset = start over the same rows gathered into a dense
//     cache of length lengths[b]. Only the producer differs: it reads the
//     block table and gathers each tile. At a page that is a multiple of 8
//     a tile is boxes of R rows (R the largest of 64, 32, 16, 8 dividing the
//     page), one Tensor Memory Accelerator copy each per 64-column half,
//     from a 3-D map over each pool as (D, Hkv, num_pages * page rows) with
//     the 128-byte swizzle; the swizzle's atom is 8 rows, so the boxes land
//     where one dense box would. A box that starts at or past lengths[b]
//     is aimed past the pool's last row, which the copy fills with zeros;
//     the rest of a box that starts below it is read from its page and
//     masked (the engine's pools hold finite values). At any other page the
//     producer warp gathers the tile with cp.async, row by row, into the
//     same swizzled layout (rows past the length zero-filled), and each
//     lane's copies arrive on the stage's barrier; the consumers fence the
//     async proxy before wgmma reads them. Rows past the chunk's valid rows
//     are computed (the caller discards them), as in the reference.
//   * insert: one block per slot writes that slot's one K row and one V row
//     (Hkv * D values each) with 16-byte stores; the TPU kernel rewrites the
//     whole page because its BlockSpec works in pages, which gives the same
//     result. Idle slots all write to row 0 of the null page 0: blocks may
//     race there, which is benign, since page 0 holds no sequence and is
//     read only by rows that no result depends on.
//   * the decode step's insert fused into the decode (`paged_decode_append`,
//     the policy's kAppend): a launch of its own moves 0.13 MB and cannot
//     come near its 0.04 us bound, so the split kernel, which already reads
//     the slot's table row, does the insert. Slot b's new row sits at
//     position lengths[b] - 1, which (page_idx[b], row[b]) must address
//     through the table (the engine's `paged_decode_addressing` gives
//     that). For each (b, kv head) the one block whose split holds that
//     position, split (lengths[b] - 1) / 256, the last one that runs, does
//     it: the warp that stages the sub-tile holding the position (row by
//     row, at any page) copies that one row from k_new / v_new instead of
//     the pool, and stores kv head hk's K and V row into the pools with
//     16-byte stores. No block reads in the same launch a live row that
//     another block writes, so on every live row the launch gives, bit for
//     bit, what the standalone insert followed by the decode gives, and
//     leaves the same pools. Only
//     the null page is both written and read in one launch: idle slots
//     (row 0) and mid-prefill slots masked to it write and read its rows,
//     so a row there may be read torn between writers, 16 bytes at a time.
//     Every writer's row is finite, and no result depends on page 0.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode is bound by memory: each live cache row is read once for K
//     and once for V. At Qwen2-7B's decode shape (B 32, capacity 2048,
//     Hkv 4, D 128) with 31 163 live rows that is 64 MB, 0.019 ms.
//   * prefill: the larger of 4 * H * D * (visible keys summed over the
//     query rows) operations and the bytes of q, out and the live K/V rows
//     read once; a 512-token chunk at start 512 (B 1, 5.6 GFLOP) is ~0.0057 ms
//     by operations. Each (query tile, head) item reads its K/V tiles
//     itself: the 7 query heads of a GQA group read them from L2.
//   * insert: 2 * B * Hkv * D * 2 bytes read and written, 0.13 MB at B 32
//     (0.04 us): its time is the launch, which the fused insert saves.

#include <cuda.h>
#include <cuda_runtime.h>

#include "attention_fwd.cuh"
#include "decode_split.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // the insert kernel's block
using T = __nv_bfloat16;

struct Pool {
  const uint16_t* k;
  const uint16_t* v;
  const int* bt;        // (B, n_tables)
  int page, n_tables;
  long long page_stride, row_stride, head_stride, bt_sb;
};

// ------------------------------------------------------------------ decode
// one warp copies the kSub rows whose pool offsets lane r < kSub holds in
// `off` (-1: not live, zero-filled without a read) into a stage; with
// kSwap, row `swap` (if any) comes from `alt`, a contiguous row, instead
template <int D, bool kSwap>
__device__ __forceinline__ void kv_stage_rows(uint16_t* dst, const uint16_t* base, long long off,
                                              int lane, int swap, const uint16_t* alt) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int i = 0; i < decode::kSub * kPerRow / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / kPerRow, col = (c % kPerRow) * 8;
    const long long o = __shfl_sync(0xffffffffu, off, r);
    const uint16_t* src = kSwap && r == swap ? alt : base + (o < 0 ? 0 : o);
    cp_async16(dst + r * decode::Smem<D>::kPitch + col, src + col, o >= 0);
  }
}

// the decode step's insert (kAppend): slot b's new K and V rows, (B, 1,
// Hkv, D) through their batch and head strides, go to (page_idx[b],
// row[b]), the pool row of position lengths[b] - 1
struct Append {
  uint16_t* k_pool;
  uint16_t* v_pool;
  const uint16_t* k_new;
  const uint16_t* v_new;
  const int* page_idx;
  const int* row;
  const int* lengths;
  int T;  // the table's capacity in rows, as decode::Split's
  long long kn_sb, kn_sh, vn_sb, vn_sh;
};

// a stage's K and V rows through the block table: kByRow false, the page a
// multiple of 16, so the stage lies in one page; kByRow true, any page,
// each row looked up by its own lane. kAppend: the block of the split that
// holds position lengths[b] - 1 also inserts the slot's new row, in the
// stage holding that position (the source note's "fused insert")
template <bool kByRow, bool kAppend>
struct Paged {
  const uint16_t* k;
  const uint16_t* v;
  const int* bt;  // (B, n_tables)
  int page;
  long long page_stride, row_stride, head_stride, bt_sb;
  Append app;

  template <int D>
  __device__ __forceinline__ void stage(uint16_t* dk, uint16_t* dv, int b, int hk, int k0,
                                        int key0, int n, int lane) const {
    const int* row = bt + b * bt_sb;
    const int pos0 = k0 + key0;
    const long long head = hk * head_stride;
    // the stage's row that holds position lengths[b] - 1, where this block
    // inserts: the split's last row (n - 1) in the split that ends at the
    // length; -1 elsewhere
    int swap = -1;
    if (kAppend && key0 + decode::kSub >= n &&
        k0 + n == min(max(app.lengths[b], 0), app.T))
      swap = n - 1 - key0;
    const uint16_t* kn = app.k_new + b * app.kn_sb + hk * app.kn_sh;
    const uint16_t* vn = app.v_new + b * app.vn_sb + hk * app.vn_sh;
    // the insert: kv head hk's K and V row, a 16-byte piece a lane (D <= 128:
    // at most 32 pieces), loaded before the stage's copies are issued so
    // that its latency overlaps them, stored after
    constexpr int kPerRow = D / 8;
    static_assert(2 * kPerRow <= 32, "one insert piece a lane");
    const bool ins = swap >= 0 && lane < 2 * kPerRow;
    const int col = (lane % kPerRow) * 8;
    uint16_t* dst = nullptr;
    uint4 piece = {};
    if (ins) {
      dst = (lane < kPerRow ? app.k_pool : app.v_pool) + (long long)app.page_idx[b] * page_stride +
            (long long)app.row[b] * row_stride + head + col;
      piece = *reinterpret_cast<const uint4*>((lane < kPerRow ? kn : vn) + col);
    }
    if (!kByRow && swap < 0) {
      const long long base = (long long)row[pos0 / page] * page_stride +
                             (long long)(pos0 % page) * row_stride + head;
      decode::kv_stage<D>(dk, k + base, row_stride, 0, n - key0, lane);
      decode::kv_stage<D>(dv, v + base, row_stride, 0, n - key0, lane);
    } else {  // row by row: any page, and the stage whose row `swap` is the new one
      long long off = -1;
      if (lane < decode::kSub && key0 + lane < n) {
        const int pos = pos0 + lane;
        off = (long long)row[pos / page] * page_stride + (long long)(pos % page) * row_stride;
      }
      kv_stage_rows<D, kAppend>(dk, k + head, off, lane, swap, kn);
      kv_stage_rows<D, kAppend>(dv, v + head, off, lane, swap, vn);
    }
    if (ins) *reinterpret_cast<uint4*>(dst) = piece;
  }
};

template <int D, bool kByRow, bool kAppend>
__global__ void __launch_bounds__(decode::kThreads)
    paged_decode_split_kernel(const decode::Split p, const Paged<kByRow, kAppend> a) {
  extern __shared__ __align__(16) uint8_t smem[];
  decode::split_body<D>(p, a, smem);
}

template <int D>
__global__ void __launch_bounds__(D / 2) paged_decode_combine_kernel(const decode::Split p) {
  decode::combine_body<D>(p);
}

template <int D, bool kByRow, bool kAppend>
cudaError_t launch_decode(const decode::Split& p, const Paged<kByRow, kAppend>& a, int B, int Hkv,
                          cudaStream_t stream) {
  constexpr int kBytes = decode::Smem<D>::kBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(paged_decode_split_kernel<D, kByRow, kAppend>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  paged_decode_split_kernel<D, kByRow, kAppend>
      <<<dim3(p.splits, Hkv, B), decode::kThreads, kBytes, stream>>>(p, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<D><<<B * p.H, D / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kAppend>
cudaError_t launch_decode(const decode::Split& p, const Pool& pl, const Append& app, int B,
                          int Hkv, cudaStream_t stream) {
  const bool by_row = pl.page % decode::kSub != 0;
  if (by_row) {
    const Paged<true, kAppend> a{pl.k, pl.v, pl.bt, pl.page, pl.page_stride, pl.row_stride,
                                 pl.head_stride, pl.bt_sb, app};
    return launch_decode<D>(p, a, B, Hkv, stream);
  }
  const Paged<false, kAppend> a{pl.k, pl.v, pl.bt, pl.page, pl.page_stride, pl.row_stride,
                                pl.head_stride, pl.bt_sb, app};
  return launch_decode<D>(p, a, B, Hkv, stream);
}

// ----------------------------------------------------------------- prefill
struct PrefillParams {
  const int* bt;  // (B, n_tables)
  const int* starts;
  const int* lengths;
  const uint16_t* k;  // the pools, (num_pages, page, Hkv, D) contiguous: gathered rows
  const uint16_t* v;
  uint16_t* o;
  int S, H, group, n_q_tiles, n_items, page, n_tables;
  int box_rows;   // rows of a TMA box (0: the page is not a multiple of 8)
  int pool_rows;  // num_pages * page: a box aimed here lies past the pool (zeros)
  long long bt_sb, o_sb, o_ss, o_sh;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

// one work item as attn::consume_item reads it: the mask (keys below the
// row's length, causal at the chunk's start) and where the rows go
struct ItemView {
  int T, q_offset, causal, window, S;
  float scale, softcap;
  uint16_t* o;
  long long o_sb, o_ss, o_sh;
  float* lse;  // not written
};

// work item i -> its query tile, row and head, the row's start and length,
// and n, its key tiles [0, n * kBN): tile-major, the heaviest (last) query
// tile first
struct PrefillItem {
  int q0, b, h, start, len, n;
};

template <int kBN>
__device__ __forceinline__ PrefillItem prefill_item(const PrefillParams& p, int i) {
  const int BH = p.n_items / p.n_q_tiles, bh = i % BH;
  PrefillItem it;
  it.q0 = (p.n_q_tiles - 1 - i / BH) * attn::kBM;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.start = p.starts[it.b];
  it.len = min(max(p.lengths[it.b], 0), p.n_tables * p.page);
  const int kv_end = min(it.len, it.start + min(it.q0 + attn::kBM, p.S));
  it.n = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;
  return it;
}

// the K and V tiles of keys [k0, k0 + kBN) at sk, in TMA boxes of
// box_rows rows through the table row: lane r copies box r
template <int D, int kBN>
__device__ __forceinline__ void paged_boxes(const PrefillParams& p, const CUtensorMap* mk,
                                            const CUtensorMap* mv, uint32_t sk,
                                            const int* bt_row, int k0, int len, int hk, int lane,
                                            uint64_t* bar) {
  const int R = p.box_rows;
  if (lane >= kBN / R) return;
  const int r0 = lane * R, pos = k0 + r0;
  const int row = pos < len ? bt_row[pos / p.page] * p.page + pos % p.page : p.pool_rows;
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    const uint32_t dst = sk + c * kBN * 128 + r0 * 128;
    hopper::tma_load(dst, mk, 64 * c, hk, row, bar);
    hopper::tma_load(dst + attn::Layout<D>::kTileBytes, mv, 64 * c, hk, row, bar);
  }
}

// the same tiles gathered row by row with cp.async into the 128-byte
// swizzled layout (16-byte chunk j of row r at chunk j ^ (r % 8)); rows at
// or past the length are zero-filled. Every lane's copies arrive on bar.
template <int D, int kBN>
__device__ __forceinline__ void paged_rows(const PrefillParams& p, uint32_t sk, const int* bt_row,
                                           int k0, int len, int hk, int lane, uint64_t* bar) {
  constexpr int kPerRow = D / 8;  // 16-byte chunks a row
  const int q = lane % kPerRow;
  const long long row_stride = (long long)(p.H / p.group) * D;
  const long long col = (long long)hk * D + 8 * q;
  const uint32_t half = (q / 8) * kBN * 128;
  for (int r = lane / kPerRow; r < kBN; r += 32 / kPerRow) {
    const int pos = k0 + r;
    const bool live = pos < len;
    const long long off =
        live ? ((long long)bt_row[pos / p.page] * p.page + pos % p.page) * row_stride + col : 0;
    const uint32_t dst = sk + half + r * 128 + (((q % 8) ^ (r & 7)) << 4);
    hopper::cp_async16(dst, p.k + off, live);
    hopper::cp_async16(dst + attn::Layout<D>::kTileBytes, p.v + off, live);
  }
  hopper::cp_async_arrive(bar);
}

template <int D, bool kGather>
__global__ void __launch_bounds__(attn::kThreads, 1)
    paged_prefill_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv, const PrefillParams p) {
  using namespace hopper;
  using L = attn::Layout<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t full[L::kStages], empty[L::kStages], q_full, q_empty;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sq = base, ring = base + L::kQBytes;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], kGather ? 32 : 1);  // each gathering lane, or one expect_tx
      mbar_init(&empty[s], attn::kConsumers * 4);
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, attn::kConsumers * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == attn::kConsumers) {  // the producer warpgroup: one warp copies
    // 40 registers (not the dense forward's 24) for the table walk:
    // 128 x 40 + 256 x 232 is still the block's 384 x 168
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid < attn::kConsumers * 128 + 32) {
      const int lane = tid & 31;
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
        const PrefillItem it = prefill_item<kBN>(p, i);
        if (it.n == 0) continue;  // the consumers write the empty rows alone
        const int hk = it.h / p.group;
        const int* bt_row = p.bt + it.b * p.bt_sb;
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        if (lane == 0) {
          mbar_expect_tx(&q_full, L::kQBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
#pragma unroll
            for (int r = 0; r < attn::kBM / attn::kBox; ++r)
              tma_load(sq + c * attn::kBM * 128 + r * attn::kBox * 128, &mq, 64 * c,
                       it.q0 + r * attn::kBox, it.h, it.b, &q_full);
        }
        for (int j = 0; j < it.n; ++j) {
          mbar_wait(&empty[stage], phase ^ 1);
          const uint32_t sk = ring + stage * L::kStageBytes;
          if (kGather) {
            paged_rows<D, kBN>(p, sk, bt_row, j * kBN, it.len, hk, lane, &full[stage]);
          } else {
            if (lane == 0) mbar_expect_tx(&full[stage], L::kStageBytes);
            __syncwarp();
            paged_boxes<D, kBN>(p, &mk, &mv, sk, bt_row, j * kBN, it.len, hk, lane,
                                &full[stage]);
          }
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
      const PrefillItem it = prefill_item<kBN>(p, i);
      const ItemView v{it.len, it.start, 1, 0, p.S, p.scale, p.softcap, p.o, p.o_sb, p.o_ss,
                       p.o_sh, nullptr};
      attn::consume_item<T, D, false, kGather>(v, it.q0, it.n, 0, it.b, it.h, 0, sq, ring, full,
                                               empty, &q_full, &q_empty, stage, phase, q_phase);
    }
  }
}

template <int D, bool kGather>
int launch_prefill(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                   const PrefillParams& p, cudaStream_t stream) {
  auto kernel = paged_prefill_kernel<D, kGather>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, attn::Layout<D>::kSmem);
  if (err != cudaSuccess) return err;
  const int sms = hopper::num_sms();
  kernel<<<p.n_items < sms ? p.n_items : sms, attn::kThreads, attn::Layout<D>::kSmem, stream>>>(
      mq, mk, mv, p);
  return cudaGetLastError();
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

template <bool kAppend>
int run_decode(const void* q, const void* k_pool, const void* v_pool, const int* block_table,
               const int* lengths, void* out, float* part_m, float* part_l, float* part_acc,
               const Append& app, int B, int H, int Hkv, int D, int page, int n_tables,
               long long q_sb, long long q_sh, long long page_stride, long long row_stride,
               long long head_stride, long long bt_sb, long long o_sb, long long o_sh,
               float softcap, void* stream) {
  if (Hkv <= 0 || H % Hkv || H / Hkv > decode::kMaxGroup || page <= 0)
    return cudaErrorInvalidValue;
  decode::Split p = decode::make_split(q, lengths, out, part_m, part_l, part_acc, H, Hkv, D, q_sb,
                                       q_sh, o_sb, o_sh, softcap);
  p.T = n_tables * page;
  p.splits = decode::splits_of(p.T);
  const Pool pl = make_pool(k_pool, v_pool, block_table, page, n_tables, page_stride, row_stride,
                            head_stride, bt_sb);
  Append a = app;
  a.T = p.T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_decode<64, kAppend>(p, pl, a, B, Hkv, s);
  if (D == 128) return launch_decode<128, kAppend>(p, pl, a, B, Hkv, s);
  return cudaErrorInvalidValue;
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
  return run_decode<false>(q, k_pool, v_pool, block_table, lengths, out, part_m, part_l, part_acc,
                           Append{}, B, H, Hkv, D, page, n_tables, q_sb, q_sh, page_stride,
                           row_stride, head_stride, bt_sb, o_sb, o_sh, softcap, stream);
}

// paged_flash_decode with the decode step's K/V insert fused in: in place,
// k_pool[page_idx[b], row[b]] = k_new[b, 0] (and V) for every b, as
// paged_kv_write does, before the attention reads them. Precondition:
// lengths[b] >= 1 and (page_idx[b], row[b]) is the pool row that the
// block table maps position lengths[b] - 1 to (clamped to the table's
// capacity); a row of length 0 is not written. The new rows (B, 1, Hkv, D)
// go through their batch and head strides (multiples of 8 elements,
// 16-byte aligned). The null page may be both written and read: its rows
// are finite but may be torn between writers (the source note). Returns
// the cudaError_t of the launches (0 = launched).
extern "C" int paged_decode_append(
    const void* q, void* k_pool, void* v_pool, const int* block_table, const int* lengths,
    const void* k_new, const void* v_new, const int* page_idx, const int* row,
    void* out, float* part_m, float* part_l, float* part_acc,
    int B, int H, int Hkv, int D, int page, int n_tables,
    long long q_sb, long long q_sh,
    long long page_stride, long long row_stride, long long head_stride, long long bt_sb,
    long long o_sb, long long o_sh, long long kn_sb, long long kn_sh, long long vn_sb,
    long long vn_sh, float softcap, void* stream) {
  Append app;
  app.k_pool = static_cast<uint16_t*>(k_pool);
  app.v_pool = static_cast<uint16_t*>(v_pool);
  app.k_new = static_cast<const uint16_t*>(k_new);
  app.v_new = static_cast<const uint16_t*>(v_new);
  app.page_idx = page_idx;
  app.row = row;
  app.lengths = lengths;
  app.kn_sb = kn_sb; app.kn_sh = kn_sh;
  app.vn_sb = vn_sb; app.vn_sh = vn_sh;
  return run_decode<true>(q, k_pool, v_pool, block_table, lengths, out, part_m, part_l, part_acc,
                          app, B, H, Hkv, D, page, n_tables, q_sb, q_sh, page_stride, row_stride,
                          head_stride, bt_sb, o_sb, o_sh, softcap, stream);
}

// bf16 operands; q's and out's strides in elements, the head dim
// contiguous; the pools contiguous and 16-byte aligned. Returns the
// cudaError_t of the launch (0 = launched), or -1 if the driver refused a
// tensor map.
extern "C" int paged_flash_prefill(
    const void* q, const void* k_pool, const void* v_pool, const int* block_table,
    const int* starts, const int* lengths, void* out,
    int B, int S, int H, int Hkv, int D, int page, int n_tables, int num_pages,
    long long q_sb, long long q_ss, long long q_sh, long long bt_sb,
    long long o_sb, long long o_ss, long long o_sh, float softcap, void* stream) {
  if (Hkv <= 0 || H % Hkv || page <= 0 || num_pages <= 0 || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  PrefillParams p;
  p.bt = block_table;
  p.starts = starts;
  p.lengths = lengths;
  p.k = static_cast<const uint16_t*>(k_pool);
  p.v = static_cast<const uint16_t*>(v_pool);
  p.o = static_cast<uint16_t*>(out);
  p.S = S;
  p.H = H;
  p.group = H / Hkv;
  p.n_q_tiles = (S + attn::kBM - 1) / attn::kBM;
  p.n_items = p.n_q_tiles * B * H;
  p.page = page;
  p.n_tables = n_tables;
  p.box_rows = page % 64 == 0 ? 64 : page % 32 == 0 ? 32 : page % 16 == 0 ? 16
                                   : page % 8 == 0 ? 8 : 0;
  p.pool_rows = num_pages * page;
  p.bt_sb = bt_sb;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  if (p.n_items == 0) return cudaSuccess;
  // q as the dense forward maps it: (D, S, H, B), a size-1 dim taking the
  // contiguous stride; the pools as (D, Hkv, rows), boxes of box_rows rows
  const long long sq[3] = {S > 1 ? q_ss : (long long)H * D, H > 1 ? q_sh : D,
                           B > 1 ? q_sb : (long long)S * H * D};
  const cuuint64_t qdims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t qstrides[3] = {cuuint64_t(sq[0] * 2), cuuint64_t(sq[1] * 2),
                                  cuuint64_t(sq[2] * 2)};
  const cuuint32_t qbox[4] = {64, attn::kBox, 1, 1};
  const cuuint64_t kdims[3] = {cuuint64_t(D), cuuint64_t(Hkv), cuuint64_t(p.pool_rows)};
  const cuuint64_t kstrides[2] = {cuuint64_t(D * 2), cuuint64_t((long long)Hkv * D * 2)};
  const cuuint32_t kbox[3] = {64, 1, cuuint32_t(p.box_rows ? p.box_rows : 8)};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  if (!hopper::make_map(&mq, bf, 4, q, qdims, qstrides, qbox) ||
      !hopper::make_map(&mk, bf, 3, k_pool, kdims, kstrides, kbox) ||
      !hopper::make_map(&mv, bf, 3, v_pool, kdims, kstrides, kbox))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gather = p.box_rows == 0;
  if (D == 64)
    return gather ? launch_prefill<64, true>(mq, mk, mv, p, s)
                  : launch_prefill<64, false>(mq, mk, mv, p, s);
  return gather ? launch_prefill<128, true>(mq, mk, mv, p, s)
                : launch_prefill<128, false>(mq, mk, mv, p, s);
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
