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

#include "mma.cuh"

namespace {
namespace ce {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed. A wait of more than
// 2^33 cycles (seconds) is a fault of the schedule: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long t0 = 0;
  for (int n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      if (!t0)
        t0 = clock64();
      else if (clock64() - t0 > (1LL << 33))
        __trap();
    }
  }
}

// a 2-D box of the tensor map at (c0 innermost, c1) into shared memory,
// completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

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

// the wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// the 16-deep step kk of a slice. K-major: 8-row swizzle atoms 1024 bytes
// apart, a step 32 bytes along the row. MN-major: 8 k-rows of 128 bytes an
// atom, a step 16 rows (2048 bytes), the 64-wide halves kHalfBytes apart.
template <bool kKMajor>
__device__ __forceinline__ uint64_t slice_desc(uint32_t base, int kk) {
  return kKMajor ? desc(base + kk * 32, 0, 1024) : desc(base + kk * 2048, kHalfBytes, 1024);
}

template <bool kTA, bool kTB>
__device__ __forceinline__ void wgmma(float (&d)[kAcc], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(int(kTA)), "n"(int(kTB)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of an operand read K-major (box: 64 k x 128 rows) or
// MN-major (box: 64 of M or N x 64 k-rows); false if the driver refuses it
inline bool make_map(CUtensorMap* map, const Operand& o, bool k_major) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cuuint64_t(k_major ? o.k_ext : o.mn),
                              cuuint64_t(k_major ? o.mn : o.k_ext)};
  const cuuint64_t strides[1] = {cuuint64_t(o.ld) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(k_major ? kBM : kBK)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<uint16_t*>(o.p), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

inline int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  return n;
}

}  // namespace ce
}  // namespace
