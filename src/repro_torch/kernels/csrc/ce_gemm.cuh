// The GEMM mainloop of the cross-entropy kernels (cross_entropy.cu): bf16
// products C (128 x 128 tile) = A (128 x K) B (K x 128) in fp32 on Hopper's
// warpgroup tensor-core instruction, for any mix of operand layouts, with
// the epilogue left to the caller.
//
// An operand is stored either K-major (each stored row is one row of A or
// one column of B, K contiguous) or MN-major (each stored row is one k, M or
// N contiguous), so the same loop reads h, the head weight in the untied
// (D, Vpad) layout or as the tied (Vpad, D) embedding table, the dlogits
// chunk and the transposes of all of them without a copy: wgmma reads a
// 16-bit operand from shared memory in either major-ness (its transpose
// flags).
//
// A block is two consumer warpgroups and a producer warp. One thread of
// the producer walks the block's (tile, 64-deep k-slice) sequence and, for each
// slice, waits until a ring stage is free and has the Tensor Memory
// Accelerator copy both operands' slices into it (tensor maps with the
// 128-byte swizzle; reads past an operand's extents land as zeros), the
// stage's `full` mbarrier counting the bytes. The consumers own 64 rows of
// the tile each: per slice they wait on `full`, issue four
// wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate in registers) on
// descriptors of the stage, keep one slice's products in flight, and free
// the slice before it through the stage's `empty` mbarrier. At a tile's
// last slice they wait for their products and run the epilogue while the
// producer already fills the ring with the next tile's slices. A stage is
// 32 KB; five of them take 160 KB, so one block runs an SM, and its 288
// threads may hold up to 224 registers each.
//
// The tensor cores add each k16 product into the fp32 accumulator without
// rounding to nearest, and that error grows with the number of additions:
// at D = 5 120 it moves an lse by ~1e-4. With kFlush > 0 the products of
// kFlush slices at a time are summed on the tensor cores from zero and
// then added, rounded to nearest, into a second fp32 sum in registers,
// which cuts the error ~10x for one wait on the products every kFlush
// slices.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {
namespace ce {

// the mbarriers, TMA loads, descriptors, wgmma wrappers, tensor-map encoder
// and SM count of hopper.cuh
using namespace hopper;

constexpr int kBM = 128;                       // tile rows (M) and columns (N)
constexpr int kBK = 64;                        // depth of one slice: 128 bytes of bf16
constexpr int kStages = 5;
constexpr int kConsumers = 2;                  // warpgroups, 64 tile rows each
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kOperandBytes = kBM * kBK * 2;   // one operand's slice, 16 KB
constexpr int kStageBytes = 2 * kOperandBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + the 1024-byte alignment of the swizzle
constexpr int kHalfBytes = 64 * kBK * 2;       // an MN-major slice is two 64-wide boxes of 8 KB
constexpr int kAcc = 64;                       // fp32 accumulators a consumer thread holds

// element (i, k) of an operand, i along M (A) or N (B): p[i * ld + k] when
// K-major, p[k * ld + i] when MN-major; reads with i >= mn or k >= k_ext
// give zeros. ld is a multiple of 8 and p is 16-byte aligned.
struct Operand {
  const uint16_t* p;
  long long ld;
  int mn, k_ext;
};

// A thread's accumulators in its tile: acc[4 i + 2 hh + e] is row row0 +
// 8 hh, column col0 + 8 i + e (consumer warpgroup c owns rows 64 c ...).
struct Frag {
  int row0, col0;
  __device__ __forceinline__ Frag() {
    const int tid = threadIdx.x;
    row0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
    col0 = 2 * (tid & 3);
  }
};

// rows [i0, i0 + 128) x [k0, k0 + 64) of an operand: one box of 128 rows
// of 64 k (K-major), or two boxes of 64 k-rows of 64 (MN-major)
template <bool kKMajor>
__device__ __forceinline__ void load_slice(const CUtensorMap* map, uint32_t dst, int i0, int k0,
                                           uint64_t* bar) {
  if constexpr (kKMajor) {
    tma_load(dst, map, k0, i0, bar);
  } else {
    tma_load(dst, map, i0, k0, bar);
    tma_load(dst + kHalfBytes, map, i0 + 64, k0, bar);
  }
}

// the 16-deep step kk of a slice. K-major: 8-row swizzle atoms 1024 bytes
// apart, a step 32 bytes along the row. MN-major: 8 k-rows of 128 bytes an
// atom, a step 16 rows (2048 bytes), the 64-wide halves kHalfBytes apart.
template <bool kKMajor>
__device__ __forceinline__ uint64_t slice_desc(uint32_t base, int kk) {
  return kKMajor ? kmajor_desc(base, kk) : mnmajor_desc(base, kk, kHalfBytes);
}

template <bool kTA, bool kTB>
__device__ __forceinline__ void wgmma(float (&d)[kAcc], uint64_t da, uint64_t db, int accumulate) {
  Wgmma<__nv_bfloat16>::ss<int(kTA), int(kTB)>(d, da, db, accumulate);
}

// The products of a block's tiles: seq.n tiles, tile j at seq.at(j) =
// (m0, n0, k_lo, k_hi) summed over k in [k_lo, k_hi) (a non-empty range),
// A and B through the tensor maps ma and mb (K-major: box 64 x 128,
// MN-major: box 64 x 64, both with the 128-byte swizzle); epi(tile, acc)
// receives each tile's sum in the consumer warpgroups (see Frag). smem
// holds kSmemBytes of dynamic shared memory. The producer warpgroup returns
// when it has issued its copies: nothing after this may wait for the whole
// block.
template <bool kAKMajor, bool kBKMajor, int kFlush, class Seq, class Epi>
__device__ __forceinline__ void gemm_tiles(uint8_t* smem, const CUtensorMap* ma,
                                           const CUtensorMap* mb, const Seq& seq, Epi& epi) {
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warp
    if (tid == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < seq.n; ++j) {
        const int4 t = seq.at(j);
        for (int k = t.z; k < t.w; k += kBK) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageBytes);
          const uint32_t sa = base + stage * kStageBytes;
          load_slice<kAKMajor>(ma, sa, t.x, k, &full[stage]);
          load_slice<kBKMajor>(mb, sa + kOperandBytes, t.y, k, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  constexpr int kRun = kFlush > 0 ? kFlush * kBK : 1 << 30;  // depth summed on the tensor cores
  int stage = 0;
  uint32_t phase = 0;
  float acc[kAcc], sum[kAcc];  // sum: only with kFlush
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = sum[i] = 0.f;
  for (int j = 0; j < seq.n; ++j) {
    const int4 t = seq.at(j);
    for (int k0 = t.z; k0 < t.w; k0 += kRun) {
      const int k_end = min(t.w, k0 + kRun);
      int prev = -1;
      for (int k = k0; k < k_end; k += kBK) {
        mbar_wait(&full[stage], phase);
        const uint32_t sa = base + stage * kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma<!kAKMajor, !kBKMajor>(acc, slice_desc<kAKMajor>(sa + wg * kHalfBytes, kk),
                                      slice_desc<kBKMajor>(sa + kOperandBytes, kk),
                                      k > k0 || kk > 0);
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
      if (lane == 0) mbar_arrive(&empty[prev]);
      if constexpr (kFlush > 0) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) sum[i] = k0 == t.z ? acc[i] : sum[i] + acc[i];
      }
    }
    if constexpr (kFlush > 0)
      epi(t, sum);
    else
      epi(t, acc);
  }
}

// the tiles of a grid of blocks, persistent: tile id blockIdx.x + j
// gridDim.x of tiles_m x tiles_n x shares, M fastest (neighbouring blocks
// share B's slices), share z summing k in [z k_per_share, (z + 1)
// k_per_share) within [0, k_total); n0 is offset by n_off
struct GridSeq {
  int n, tiles_m, tiles_n, k_per_share, k_total, n_off;
  __device__ __forceinline__ GridSeq(int tiles_m_, int tiles_n_, int shares, int k_per_share_,
                                     int k_total_, int n_off_)
      : tiles_m(tiles_m_), tiles_n(tiles_n_), k_per_share(k_per_share_), k_total(k_total_),
        n_off(n_off_) {
    const int total = tiles_m * tiles_n * shares;
    n = int(blockIdx.x) < total ? (total - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x) : 0;
  }
  __device__ __forceinline__ int4 at(int j) const {
    const int id = int(blockIdx.x) + j * int(gridDim.x);
    const int tm = id % tiles_m, rest = id / tiles_m, tn = rest % tiles_n, z = rest / tiles_n;
    return make_int4(tm * kBM, n_off + tn * kBM, z * k_per_share,
                     min(k_total, (z + 1) * k_per_share));
  }
};

// ---- host: tensor maps

// the tensor map of an operand read K-major (box: 64 k x 128 rows) or
// MN-major (box: 64 of M or N x 64 k-rows); false if the driver refuses it
inline bool make_map(CUtensorMap* map, const Operand& o, bool k_major) {
  const cuuint64_t dims[2] = {cuuint64_t(k_major ? o.k_ext : o.mn),
                              cuuint64_t(k_major ? o.mn : o.k_ext)};
  const cuuint64_t strides[1] = {cuuint64_t(o.ld) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(k_major ? kBM : kBK)};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, o.p, dims, strides, box);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

}  // namespace ce
}  // namespace
