// Tensor-core product and fragment loads shared by the port's CUDA kernels.
//
// Mma<T> wraps mma.sync m16n8k16 with fp32 accumulation for T =
// __nv_bfloat16 or __half: run (c += a b), pack (two floats -> one register
// of two T, the first in the low half) and to_float (one T from its 16-bit
// pattern). The fragment loads read 16-bit tiles held row-major in shared
// memory with rows of COLS + kPad elements; g = lane / 4 and t = lane % 4,
// as in the PTX fragment layout of m16n8k16. Below them: 16-byte cp.async
// copies into shared memory (zero-filled when the source is not live) with
// their commit and wait, and ldmatrix.x4.trans for B fragments whose k
// index runs down the rows of a tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;  // row padding (16-bit elements): conflict-free fragment reads

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float to_float(uint16_t x) {
    return __uint_as_float(uint32_t(x) << 16);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float to_float(uint16_t x) {
    return __half2float(__ushort_as_half(x));
  }
};

// the A fragment (16 x 16, row-major) at rows [row, row + 16), columns
// [col, col + 16) of the tile
template <int COLS>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint16_t* s, int row, int col,
                                       int g, int t) {
  const uint16_t* p = s + (row + g) * (COLS + kPad) + col + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * (COLS + kPad));
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * (COLS + kPad) + 8);
}

// B fragment (16 x 8, k x n) whose n index is a row of the tile and whose k
// index runs along that row (B = tile^T): rows [row, row + 8)
template <int COLS>
__device__ __forceinline__ void b_frag_rows(uint32_t& b0, uint32_t& b1, const uint16_t* s,
                                            int row, int col, int g, int t) {
  const uint16_t* p = s + (row + g) * (COLS + kPad) + col + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment whose k index runs down the rows of the tile and whose n index
// is a column (B = tile): k rows [row, row + 16), column col + g
template <int COLS>
__device__ __forceinline__ void b_frag_cols(uint32_t& b0, uint32_t& b1, const uint16_t* s,
                                            int row, int col, int g, int t) {
  const uint16_t* p = s + (row + 2 * t) * (COLS + kPad) + col + g;
  b0 = uint32_t(p[0]) | (uint32_t(p[COLS + kPad]) << 16);
  b1 = uint32_t(p[8 * (COLS + kPad)]) | (uint32_t(p[9 * (COLS + kPad)]) << 16);
}

// ---- asynchronous copies into shared memory (sm_80+)
// 16 bytes from global src to shared dst; a copy that is not live reads
// nothing and writes 16 zero bytes (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the B fragments of two n8 tiles (16 x 16, k down the rows, n along them)
// at rows [row, row + 16), columns [col, col + 16) of a row-major tile:
// b[0], b[1] for columns col..col+7 and b[2], b[3] for col+8..col+15
template <int COLS>
__device__ __forceinline__ void b_frag_cols_x2(uint32_t (&b)[4], const uint16_t* s, int row,
                                               int col, int lane) {
  const uint16_t* p = s + (row + (lane & 15)) * (COLS + kPad) + col + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

}  // namespace
