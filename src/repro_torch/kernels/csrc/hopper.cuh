// Hopper (sm_90a) primitives shared by the port's wgmma + TMA kernels: the
// cross-entropy GEMM mainloop (ce_gemm.cuh), the flash-attention forward
// and backward (flash_attention_fwd.cu, flash_attention_bwd.cu, and the
// forward's consumer side attention_fwd.cuh, which the paged chunk prefill
// in paged_attention.cu shares) and the grouped matmul (grouped_matmul.cu).
//
// - mbarriers (init, arrive, arrive with an expected transaction count, and
//   a parity wait that traps after ~2^33 cycles instead of hanging the card),
//   and 16-byte cp.async copies that arrive on one when they complete;
// - Tensor Memory Accelerator loads of a 2-D, 3-D or 4-D box into shared
//   memory, completing on an mbarrier, and stores of a 3-D box from shared
//   memory with an L2 cache policy, completing in bulk groups;
// - the proxy fence and named barriers around shared memory that threads
//   write and the async proxy (wgmma, TMA) then reads;
// - wgmma shared-memory descriptors of 128-byte-swizzled tiles, K-major and
//   MN-major;
// - wgmma.mma_async m64nNk16 with fp32 accumulators and bf16 or fp16
//   operands: N = 8, 16, 32 (the grouped matmul's decode mode), 64 and 128
//   with A from shared memory (SS), 64 and 128 with A from registers (RS);
//   and the fence / commit / wait around them;
// - on the host: the driver's tensor-map encoder (reached through the
//   runtime, no -lcuda), an N-D tensor map with the 128-byte swizzle, and
//   the SM count.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// ---- cp.async: 16 bytes from global src to shared dst (a copy that is not
// live reads nothing and writes zeros; src must still be a valid address),
// and an arrival on bar once this thread's earlier copies have landed. The
// barrier's count includes that arrival (.noinc); a reader that waits on
// it fences the async proxy before wgmma reads what the copies wrote.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- TMA: a box of the tensor map at the given coordinates (innermost
// first) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- TMA stores: the box at src in shared memory to the tensor map's box
// at the given coordinates (innermost first), with an L2 cache policy;
// elements outside the tensor's extents are not written. A thread's stores
// complete in the bulk groups it commits: bulk_wait_read<N> returns when
// all but its N newest groups have read their shared memory (which may then
// be written again), bulk_wait<N> when they have also written device
// memory.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// an L2 policy for data written once and not read back soon: its lines go
// first, so a stream of them does not evict what the kernel reads again
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's writes to shared memory, before the async proxy (wgmma, a
// TMA store) reads them; a barrier among the writers then follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `count` threads (whole warps) on named barrier `id` (1-15;
// 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma descriptors of 128-byte-swizzled tiles (rows of 128 bytes,
// 8-row swizzle atoms of 1024 bytes, the tile 1024-byte aligned)

// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// K-major (each stored row one row of A or one column of B, 64 k of it):
// the 16-deep step kk is 32 bytes along the row
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  return desc(base + kk * 32, 0, 1024);
}

// MN-major (each stored row one k, 64 of M or N): the 16-deep step kk is
// 16 rows (2048 bytes); the next 64 of M or N lie `half_bytes` further on
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk, uint32_t half_bytes) {
  return desc(base + kk * 2048, half_bytes, 1024);
}

// ---- wgmma
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

// Registers that an asynchronous wgmma writes (accumulators) or reads (an
// A fragment) are live until its wait: this empty asm, after the wait, keeps
// the compiler from reading the accumulators early or reusing the fragment's
// registers while the tensor cores may still read them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOP_D4 "{%0, %1, %2, %3}"
#define HOP_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOP_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOP_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOP_D64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define HOP_ACC8(b)                                                                           \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
      "+f"(d[b + 6]), "+f"(d[b + 7])
#define HOP_ACC4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define HOP_ACC16 HOP_ACC8(0), HOP_ACC8(8)
#define HOP_ACC32 HOP_ACC8(0), HOP_ACC8(8), HOP_ACC8(16), HOP_ACC8(24)
#define HOP_ACC64 HOP_ACC32, HOP_ACC8(32), HOP_ACC8(40), HOP_ACC8(48), HOP_ACC8(56)

// D (64 x N, fp32, see the layout below) (+)= A (64 x 16) B (16 x N), T =
// __nv_bfloat16 or __half; the accumulator array's length, N / 2, picks N.
// ss: A and B from shared memory (descriptors; kTA / kTB = 1 reads that
// operand MN-major), N = 8, 16, 32, 64 or 128. rs: A from four registers, B
// from shared memory, N = 64 or 128. accumulate = 0 overwrites D.
//
// Layouts, for thread tid of the warpgroup (w = tid / 32, g = (tid % 32) /
// 4, t = tid % 4): d[4 i + 2 hh + e] is row 16 w + g + 8 hh, column 8 i +
// 2 t + e. The A fragment of rs: a[0] = (row 16 w + g, columns 2 t, 2 t +
// 1), a[1] = the same columns of row + 8, a[2] and a[3] the same at
// columns + 8, the first element in the low half: so the accumulators of
// columns [16 kk, 16 kk + 16) pack into the A fragment of k-step kk
// (pack_a).
template <typename T>
struct Wgmma;

#define HOP_WGMMA(CT, TY)                                                                      \
  template <>                                                                                  \
  struct Wgmma<CT> {                                                                           \
    template <int kTA, int kTB>                                                                \
    static __device__ __forceinline__ void ss(float (&d)[4], uint64_t da, uint64_t db,        \
                                              int accumulate) {                                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"                                 \
                   "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " " HOP_D4           \
                   ", %4, %5, p, 1, 1, %7, %8;\n}\n"                                           \
                   : HOP_ACC4                                                                  \
                   : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));                   \
    }                                                                                          \
    template <int kTA, int kTB>                                                                \
    static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db,        \
                                              int accumulate) {                                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                                \
                   "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " HOP_D8          \
                   ", %8, %9, p, 1, 1, %11, %12;\n}\n"                                         \
                   : HOP_ACC8(0)                                                               \
                   : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));                   \
    }                                                                                          \
    template <int kTA, int kTB>                                                                \
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db,       \
                                              int accumulate) {                                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " HOP_D16         \
                   ", %16, %17, p, 1, 1, %19, %20;\n}\n"                                       \
                   : HOP_ACC16                                                                 \
                   : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));                   \
    }                                                                                          \
    template <int kTA, int kTB>                                                                \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,       \
                                              int accumulate) {                                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " HOP_D32         \
                   ", %32, %33, p, 1, 1, %35, %36;\n}\n"                                       \
                   : HOP_ACC32                                                                 \
                   : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));                   \
    }                                                                                          \
    template <int kTA, int kTB>                                                                \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,       \
                                              int accumulate) {                                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " HOP_D64        \
                   ", %64, %65, p, 1, 1, %67, %68;\n}\n"                                       \
                   : HOP_ACC64                                                                 \
                   : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));                   \
    }                                                                                          \
    template <int kTB>                                                                         \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],         \
                                              uint64_t db, int accumulate) {                   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " HOP_D32         \
                   ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                           \
                   : HOP_ACC32                                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),     \
                     "n"(kTB));                                                                \
    }                                                                                          \
    template <int kTB>                                                                         \
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],         \
                                              uint64_t db, int accumulate) {                   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " HOP_D64        \
                   ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                           \
                   : HOP_ACC64                                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),     \
                     "n"(kTB));                                                                \
    }                                                                                          \
  };

HOP_WGMMA(__nv_bfloat16, "bf16")
HOP_WGMMA(__half, "f16")

#undef HOP_WGMMA
#undef HOP_ACC64
#undef HOP_ACC32
#undef HOP_ACC16
#undef HOP_ACC8
#undef HOP_ACC4
#undef HOP_D64
#undef HOP_D32
#undef HOP_D16
#undef HOP_D8
#undef HOP_D4

// the A fragment of k-step kk of an rs product from accumulators d of the
// layout above (columns [16 kk, 16 kk + 16)), each value rounded to T once
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = Mma<T>::pack(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = Mma<T>::pack(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = Mma<T>::pack(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = Mma<T>::pack(d[8 * kk + 6], d[8 * kk + 7]);
}

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

// the rank-N tensor map of a tensor at p with extents dims (innermost
// first), byte strides of dims 1 .. N-1 and the box, with the 128-byte
// swizzle (the box's inner extent is 128 bytes: 64 16-bit elements, 32
// fp32); reads outside the extents land as zeros. false if the driver
// refuses it.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* p,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, cuuint32_t(rank), const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  return n;
}

}  // namespace hopper
}  // namespace
