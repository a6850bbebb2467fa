// Mamba-2 SSD chunked scan for Hopper (sm_90a), backward: the gradient of
// every SSM layer in training.
//
// The port's own kernel: the reference's TPU kernel (`_ssd_kernel` in
// src/repro/kernels/ssd_scan.py) is forward-only, and the reference trains
// through XLA's autodiff of its jnp scan `_ssd_chunked_xla`
// (src/repro/kernels/ops.py). Contract: the forward's inputs (x (B, S, H,
// P) bf16, dt (B, S, H) fp32, A and D (H,) fp32, B and C (B, S, G, N) bf16,
// x, B and C possibly strided views with the last dim contiguous), the
// state entering each chunk of 64 rows (B, nc, H, P, N) fp32 from
// ssd_scan_states, dy (B, S, H, P) bf16 and the final state's gradient
// dstate (B, H, P, N) fp32 or null -> dx (B, S, H, P) bf16, ddt (B, S, H)
// fp32, dB and dC (B, S, G, N) bf16, dA and dD (H,) fp32. ref.py's
// ssd_scan_bwd_ref is the same decomposition in torch.
//
// Per chunk of L = 64 rows, head and batch row, rows t >= s, with cum the
// prefix sum of dt A, seg = cum[L-1], G = C B^T, E_ts = exp(cum_t - cum_s),
// M = G o E o dt_s, w_s = dt_s exp(seg - cum_s), dM = dy x^T, and the
// chunk's h_in and dh_out (the gradient of the state leaving it):
//   dx_s  = sum_t M_ts dy_t + w_s (dh_out B_s) + D dy_s
//   dB_s  = sum_t dS_ts C_t + w_s V_s,   dS = dM o E o dt_s, V_s = dh_out^T x_s
//   dC_t  = sum_s dS_ts B_s + exp(cum_t) Z_t,               Z_t = h_in^T dy_t
//   ddt_s = sum_t R_ts + dw_s exp(seg - cum_s) + A rc_s,    R = dM o G o E
//   dA   += sum_r dt_r rc_r,   dD += sum dy . x
// with dw_s = B_s . V_s, rc_r = sum_{t >= r} dcum_t and dcum_t = sum_s R_ts
// dt_s - dt_t sum_t' R_t't + exp(cum_t) C_t . Z_t - dw_t w_t, the last row
// adding sum_s dw_s w_s + exp(seg) <dh_out, h_in>. dh_out is dstate for the
// last chunk, and dh_in = exp(seg) dh_out + sum_t exp(cum_t) dy_t C_t^T
// carries it back. The causal decay is selected, never multiplied by a
// mask: every exponent taken is <= 0. Rows past S count as x = 0, dt = 0,
// dy = 0, as in the forward.
//
// Design: three launches, no atomics (a repeat is bit-identical).
// (1) ssd_bwd_state_kernel walks the chunks in reverse, one block a (batch
// row, head, 32 rows of P, 64 columns of N -- 32 where N <= 32), 4 warps:
// 320 blocks at Mamba2's shape. Each warp keeps a 16 x 32 (or 16) slice of
// dh in mma accumulators and adds the chunk's (exp(cum) o dy)^T C on the
// tensor cores; each chunk's dh_out goes out as bf16 high and low halves
// (B, nc, H, 2, P, NP), N padded with zeros to NP (16, 32, 64 or 128) and
// 16-byte pieces swizzled (swz): the bytes of fp32, but the chunk kernel
// copies a head's halves in two bulk copies straight into its ldmatrix
// tiles. The halves are staged in shared memory and stored in 16-byte
// pieces of whole rows (stored from the accumulators, 4-byte pieces cost
// ~0.02 ms more at Mamba2's shape). dy, C and dt are copied by cp.async a
// chunk ahead of the walk (a deeper ring takes shared memory that the
// blocks an SM need: slower). The other form -- every chunk's (exp(cum) o
// dy)^T C in one chunk-parallel pass, then an elementwise reverse scan --
// writes that product (42 MB at Mamba2's shape) and reads it back beside
// dh's 42 MB: ~3x the walk's bytes, so only the walk was built.
// (2) ssd_bwd_chunk_kernel: given h_in and dh_out the chunks are
// independent. One block of 8 warps takes (batch row, chunk, a run of K
// heads of one group): it loads the chunk's B and C once and forms G^T = B
// C^T once for the run (kept in shared memory), then walks the run's
// heads with the next head's tiles in flight in a two-stage ring: dh_out's
// halves and h_in by three bulk copies (the Tensor Memory Accelerator, on
// an mbarrier), x, dy and dt by cp.async. dB and dC are summed over the
// run's heads in head order in the warps' accumulators, so the fp32
// partials are (B, S, H / K, N). K is a divisor of H / G picked from the
// shape by the wrapper (the fewest block-waves times K; ties to the larger
// K: 10 at Mamba2's shape, 128 blocks). Warp w takes rows 16 rb..16 rb + 15
// (as s in G^T, dM^T, dx, V and dB, as t in Z and dC) and one half of the
// columns (of N in V, Z, dB and dC, of P in dx); rb = w & 3, mirrored in
// the second half, so the two warps of a sub-partition hold a heavy and a
// light row block of the causal triangle. Per head: h_in's fp32 tile is
// split into bf16 halves in its place (swizzled like dh_out; <dh_out, h_in>
// on the way), then Z = dy h_in, V = x dh_out, dM^T = x dy^T; dx = w o (B
// dh_out^T) + M^T dy + D dy with M's fragments formed from G^T, the decay
// and dt a k-tile at a time; in the accumulators' layout, elementwise, dS
// and R, R's row sums (colR) and column sums (rowQ, summed over the row
// blocks in order) and dM's trace (dD); dB += dS^T C with dS's fragments
// split straight from the accumulators, and dC += dS B with dS read back
// transposed from shared memory (stored over h_in's place, after a
// barrier, where it fits). One warp finishes the head's ddt, dA and dD
// with warp scans (two rows a lane). P above 64 is taken in slices of 64
// (32 where P is not a multiple of 64): the slices' products are summed,
// and dx takes a second pass over them. Tried and slower at Mamba2's
// shape (earlier forms of this file, timed by prefill_variants.py): 16
// warps of a quarter of the columns each (128 registers), a bulk copy a
// row for every tile; cp.async for the dh_out and h_in tiles as well was
// no faster.
// (3) ssd_bwd_sum_kernel sums the runs' dB and dC partials over each
// group in order, and the chunks' dA and dD partials over (batch, chunk).
//
// Arithmetic: every product on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators). x, dy, B and C are bf16 already, so G and
// dM are exact up to summation order. The fp32 operands -- M and dS, dh_out
// (in dx, V), h_in (in Z) and exp(cum) o dy (in the state pass) -- are
// split into bf16 high and low halves, one product each, as in the
// forward: no low half is dropped (prefill_variants.py times the choice).
// Decays are 2^x of a base-2 prefix sum on the special-function unit.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): bytes -- x,
// dy, B, C, dt read, the chunk states read, dx, ddt, dB, dC written -- over
// the memory rate, against the chunked form's products at the bf16
// tensor-core rate; chip_smoke.ssd_bwd_bound reckons both from the shape.
// The kernel moves more: dh_out's round trip through device memory and the
// small partials.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kL = 64;        // rows per chunk (the forward's)
constexpr int kWarps = 8;     // the chunk kernel's
constexpr int kThreads = 32 * kWarps;
constexpr int kEpiWarp = 4;   // the warp that finishes a head's ddt, dA and dD
constexpr int kStateStages = 2;  // the state pass's ring: chunks in flight ahead of the walk
constexpr int kStateRows = 32;   // rows of P a state-pass block (32 where P % 64 != 0)
constexpr int kMaxN = 128;
constexpr float kLog2e = 1.4426950408889634f;
using T = __nv_bfloat16;

struct Params {
  const uint16_t* x;    // (B, S, H, P), p contiguous
  const float* dt;      // (B, S, H), h contiguous
  const float* A;       // (H,)
  const uint16_t* Bm;   // (B, S, G, N), n contiguous
  const uint16_t* Cm;   // the same strides as Bm
  const float* D;       // (H,)
  const float* hin;     // (B, nc, H, P, N): the state entering each chunk
  const uint16_t* dy;   // (B, S, H, P) contiguous
  const float* dstate;  // (B, H, P, N) or null
  uint16_t* dh;         // (B, nc, H, 2, P, NP): dh_out of each chunk, bf16 high then low half
  uint16_t* dx;         // (B, S, H, P)
  float* ddt;           // (B, S, H)
  float* dBp;           // (B, S, H / K, N): dB of each run of K heads
  float* dCp;           // (B, S, H / K, N)
  float* dAp;           // (B, nc, H): dA of each chunk
  float* dDp;           // (B, nc, H)
  uint16_t* dB;         // (B, S, G, N)
  uint16_t* dC;         // (B, S, G, N)
  float* dA;            // (H,)
  float* dD;            // (H,)
  long long xs_b, xs_s, xs_h;  // element strides of x
  long long bs_b, bs_s, bs_g;  // of Bm and Cm
  long long ds_b, ds_s;        // of dt
  int B, S, H, P, G, N, NP, nc;
  int K, runs;          // heads a run, runs (H / K)
  int vec16;            // x, dy, B and C in 16-byte rows: cp.async; else element copies
  int hin16;            // h_in the same
};

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices, lane l addressing row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(su32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(su32(p))
               : "memory");
}

// Fragment addresses for lane l into tiles of `pitch` elements a row:
// the A fragment (16 x 16) at (m0, k0) of a tile stored [m][k] (ldsm4);
__device__ __forceinline__ const uint16_t* a_rows(const uint16_t* s, int pitch, int m0, int k0,
                                                  int lane) {
  return s + (m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8;
}
// the A fragment at (m0, k0) of a tile stored [k][m] (ldsm4t);
__device__ __forceinline__ const uint16_t* a_cols(const uint16_t* s, int pitch, int m0, int k0,
                                                  int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + m0 + (((lane >> 3) & 1) << 3);
}
// the B fragments of n8 tiles n0 and n0 + 8 at depth k0 of a tile stored
// [n][k] (ldsm4: r[0], r[1] tile n0; r[2], r[3] tile n0 + 8);
__device__ __forceinline__ const uint16_t* b_rows(const uint16_t* s, int pitch, int n0, int k0,
                                                  int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + (((lane >> 3) & 1) << 3);
}
// the same of a tile stored [k][n] (ldsm4t)
__device__ __forceinline__ const uint16_t* b_cols(const uint16_t* s, int pitch, int n0, int k0,
                                                  int lane) {
  return s + (k0 + (lane & 15)) * pitch + n0 + (lane >> 4) * 8;
}

// 2^x by the special-function unit (ex2.approx.ftz: ~2^-22 relative)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (v0, v1) -> their bf16 high parts and the bf16 of what is left
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - f.x, v1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A fragments (hi, lo) of k-tile ks from an accumulator row block held
// as n8 tiles: tiles 2 ks and 2 ks + 1 are the k columns
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split2(c0[0], c0[1], ah[0], al[0]);
  split2(c0[2], c0[3], ah[1], al[1]);
  split2(c1[0], c1[1], ah[2], al[2]);
  split2(c1[2], c1[3], ah[3], al[3]);
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint16_t to_bf(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const uint16_t*>(&b);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(su32(dst)), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

// ---- mbarriers and 1-D bulk copies (the Tensor Memory Accelerator)
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(su32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; a wait of more than
// 2^33 cycles is a fault of the schedule: trap rather than hang
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
        : "r"(su32(bar)), "r"(parity)
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

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global src to
// shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(su32(dst)), "l"(src), "r"(bytes), "r"(su32(bar))
      : "memory");
}

// orders this thread's generic shared-memory accesses before later
// async-proxy (bulk copy) ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the 4 lanes of a quad (one row of an accumulator)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// cw[r] = the inclusive prefix sum of sdt * a2 (base-2 units) over the
// chunk's 64 rows: lane l sums rows 2l and 2l + 1, then a warp scan
__device__ __forceinline__ void warp_cum(float* cw, const float* sdt, float a2, int lane) {
  const int r = 2 * lane;
  const float v0 = sdt[r] * a2, v1 = v0 + sdt[r + 1] * a2;
  float incl = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  __syncwarp();  // every lane is done with the last chunk's cw
  cw[r] = excl + v0;
  cw[r + 1] = excl + v1;
  __syncwarp();
}

// rows [0, kRows) of a bf16 matrix (row stride `stride` elements, `cols` <=
// kCols columns) into a tile of pitch kPitch by kThr threads; rows at or
// past `live` are zero-filled, columns past cols left as they are
template <int kRows, int kPitch, int kCols, int kThr>
__device__ __forceinline__ void load_bf16(uint16_t* dst, const uint16_t* src, long long stride,
                                          int cols, int live, bool vec16) {
  if (vec16) {
    constexpr int kPer = kCols / 8;  // 16-byte pieces of a row
    for (int i = threadIdx.x; i < kRows * kPer; i += kThr) {
      const int r = i / kPer, c = (i % kPer) * 8;
      if (c >= cols) continue;
      const bool ok = r < live;
      cp_async16(dst + r * kPitch + c, src + (ok ? r * stride + c : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * cols; i += kThr) {
      const int r = i / cols, c = i % cols;
      dst[r * kPitch + c] = r < live ? src[r * stride + c] : uint16_t(0);
    }
  }
}

// zero `bytes` (a multiple of 16) of shared memory from `s`
__device__ __forceinline__ void clear(uint8_t* s, int bytes, int nthr) {
  for (int i = threadIdx.x; i < bytes / 16; i += nthr)
    reinterpret_cast<uint4*>(s)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The layout of dh_out's halves (in device memory and in the chunk kernel's
// tiles) and of h_in's (in the chunk kernel's tiles): rows of NP bf16
// whose 16-byte pieces are XORed with the row's bits above the rows that
// share 128 bytes, so that the 8 rows an ldmatrix reads fall in distinct
// banks with no padding -- a tile is then one contiguous copy.
template <int NP>
__device__ __forceinline__ int swz(int row, int piece) {
  constexpr int kShift = NP >= 64 ? 0 : NP == 32 ? 1 : 2;
  constexpr int kMask = (NP / 8 < 8 ? NP / 8 : 8) - 1;
  return piece ^ ((row >> kShift) & kMask);
}

// the A fragment (ldsm4) / the B fragments (ldsm4t) of a swizzled tile:
// as a_rows / b_rows and b_cols
template <int NP>
__device__ __forceinline__ const uint16_t* swz_rows(const uint16_t* s, int m0, int k0, int lane) {
  const int row = m0 + (lane & 7) + ((lane >> 4) << 3);
  return s + row * NP + swz<NP>(row, (k0 >> 3) + ((lane >> 3) & 1)) * 8;
}
template <int NP>
__device__ __forceinline__ const uint16_t* swz_cols(const uint16_t* s, int k0, int n0, int lane) {
  const int row = k0 + (lane & 15);
  return s + row * NP + swz<NP>(row, (n0 >> 3) + (lane >> 4)) * 8;
}

// ---------------------------------------------------------------- (1)
// the state pass's shared memory (bytes): a ring of kStateStages (C, dy,
// dt) tiles, two staging tiles for the dh_out halves it stores, and each
// warp's cum; PR rows of P and kSN columns of N a block
template <int NP, int PR>
struct StateSmem {
  static constexpr int kSN = NP >= 64 ? 64 : 32;   // columns of N a block
  static constexpr int kWarps = PR / 16 * 2;       // warps: PR / 16 row blocks x 2 column halves
  static constexpr int kCP = kSN + kPad;           // pitch of the C tile
  static constexpr int kYP = PR + kPad;            // of the dy tile
  static constexpr int kOP = kSN + kPad;           // of the staged dh_out halves
  static constexpr int kCT = kL * kCP * 2, kYT = kL * kYP * 2;
  static constexpr int kStage = kCT + kYT + kL * 4;
  static constexpr int kOut = 2 * PR * kOP * 2;    // one staging tile: hi, then lo
  static constexpr int kOffOut = kStateStages * kStage, kOffCum = kOffOut + 2 * kOut;
  static constexpr int kBytes = kOffCum + kWarps * kL * 4;
};

// Block (B * H, P / PR, column blocks); warp (wp, wn) holds rows 16 wp.. of
// the block's PR and columns wn * kSN / 2.. of its kSN.
template <int NP, int PR>
__global__ void __launch_bounds__(PR * 4) ssd_bwd_state_kernel(const Params p) {
  using L = StateSmem<NP, PR>;
  constexpr int kSN = L::kSN, kCP = L::kCP, kYP = L::kYP, kOP = L::kOP, kWN = kSN / 2,
                kNT = kWN / 8, kThr = 32 * L::kWarps;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int p0 = blockIdx.y * PR, n0 = blockIdx.z * kSN;
  const int wp = warp % (PR / 16), wn = warp / (PR / 16);
  const int grp = h / (p.H / p.G);
  const float a2 = p.A[h] * kLog2e;
  float* cw = reinterpret_cast<float*>(smem + L::kOffCum) + warp * kL;
  const int ncols = min(kSN, p.N - n0);
  const float* dtb = p.dt + b * p.ds_b + h;
  const bool vec16 = p.vec16;

  clear(smem, kStateStages * L::kStage, kThr);  // C's columns past N read as zero
  __syncthreads();

  // chunk c into its stage (chunks below 1 are not needed: an empty group)
  auto load = [&](int c) {
    if (c < 1) {
      cp_async_commit();
      return;
    }
    uint8_t* s = smem + (c % kStateStages) * L::kStage;
    const int c0 = c * kL, rows = min(kL, p.S - c0);
    load_bf16<kL, kCP, kSN, kThr>(reinterpret_cast<uint16_t*>(s),
                                  p.Cm + b * p.bs_b + grp * p.bs_g + c0 * p.bs_s + n0, p.bs_s,
                                  ncols, rows, vec16);
    load_bf16<kL, kYP, PR, kThr>(reinterpret_cast<uint16_t*>(s + L::kCT),
                                 p.dy + (((long long)b * p.S + c0) * p.H + h) * p.P + p0,
                                 (long long)p.H * p.P, PR, rows, vec16);
    float* sdt = reinterpret_cast<float*>(s + L::kCT + L::kYT);
    for (int j = tid; j < kL; j += kThr)
      cp_async4(sdt + j, dtb + (j < rows ? (long long)(c0 + j) * p.ds_s : 0), j < rows);
    cp_async_commit();
  };

  // the carried dh slice: rows 16 wp + g (+ 8) of the block's, columns wn
  // kWN + 8 j + 2 tq (+ 1) of its
  const int pr = 16 * wp + g, nw = wn * kWN;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = n0 + nw + 8 * j + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 v = make_float2(0.f, 0.f);
      if (p.dstate && col < p.N)
        v = *reinterpret_cast<const float2*>(
            p.dstate + (((long long)b * p.H + h) * p.P + p0 + pr + 8 * r) * p.N + col);
      acc[j][2 * r] = v.x;
      acc[j][2 * r + 1] = v.y;
    }
  }

  const int nc = p.nc;
  const int out_cols = min(kSN, NP - n0);  // columns of dh's rows this block stores
  for (int k = 1; k < kStateStages; ++k) load(nc - k);
  for (int c = nc - 1;; --c) {
    // dh_out of chunk c in bf16 high and low halves, staged in shared memory
    // (tile c & 1) and stored in 16-byte pieces after the next barrier
    uint16_t* so = reinterpret_cast<uint16_t*>(smem + L::kOffOut + (c & 1) * L::kOut);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = nw + 8 * j + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t hi, lo;
        split2(acc[j][2 * r], acc[j][2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(so + (pr + 8 * r) * kOP + col) = hi;
        *reinterpret_cast<uint32_t*>(so + (PR + pr + 8 * r) * kOP + col) = lo;
      }
    }
    if (c > 0) cp_async_wait<kStateStages - 2>();
    __syncthreads();  // chunk c has landed, dh_out is staged; chunk c + 1 is done with its stage
    {
      uint16_t* dst = p.dh + (((long long)b * nc + c) * p.H + h) * 2 * p.P * NP;
      const int per = out_cols / 8;  // 16-byte pieces a row
      for (int i = tid; i < 2 * PR * per; i += kThr) {
        const int row = i / per, piece = i % per;  // rows PR.. are the low half
        const int prow = p0 + (row < PR ? row : row - PR);
        const long long drow = row < PR ? prow : (long long)p.P + prow;
        *reinterpret_cast<uint4*>(dst + drow * NP + 8 * swz<NP>(prow, (n0 >> 3) + piece)) =
            *reinterpret_cast<const uint4*>(so + row * kOP + 8 * piece);
      }
    }
    if (c == 0) break;
    load(c - (kStateStages - 1));  // into chunk c + 1's stage
    const uint8_t* s = smem + (c % kStateStages) * L::kStage;
    const uint16_t* sC = reinterpret_cast<const uint16_t*>(s);
    const uint16_t* sDY = reinterpret_cast<const uint16_t*>(s + L::kCT);
    warp_cum(cw, reinterpret_cast<const float*>(s + L::kCT + L::kYT), a2, lane);
    const float es = ex2(cw[kL - 1]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] *= es;
      acc[j][1] *= es;
      acc[j][2] *= es;
      acc[j][3] *= es;
    }
    // + (exp(cum) o dy)^T C: A = (exp(cum) o dy)^T (rows p, k = t), split
#pragma unroll
    for (int ks = 0; ks < kL / 16; ++ks) {
      const int t0 = 16 * ks + 2 * tq;
      const float e0 = ex2(cw[t0]), e1 = ex2(cw[t0 + 1]);
      const float e8 = ex2(cw[t0 + 8]), e9 = ex2(cw[t0 + 9]);
      uint32_t ya[4], ah[4], al[4];
      ldsm4t(ya, a_cols(sDY, kYP, 16 * wp, 16 * ks, lane));
      const float2 y0 = bf2(ya[0]), y1 = bf2(ya[1]), y2 = bf2(ya[2]), y3 = bf2(ya[3]);
      split2(y0.x * e0, y0.y * e1, ah[0], al[0]);
      split2(y1.x * e0, y1.y * e1, ah[1], al[1]);
      split2(y2.x * e8, y2.y * e9, ah[2], al[2]);
      split2(y3.x * e8, y3.y * e9, ah[3], al[3]);
#pragma unroll
      for (int jn = 0; jn < kNT / 2; ++jn) {
        uint32_t cb[4];
        ldsm4t(cb, b_cols(sC, kCP, nw + 16 * jn, 16 * ks, lane));
        Mma<T>::run(acc[2 * jn], ah, cb[0], cb[1]);
        Mma<T>::run(acc[2 * jn + 1], ah, cb[2], cb[3]);
        Mma<T>::run(acc[2 * jn], al, cb[0], cb[1]);
        Mma<T>::run(acc[2 * jn + 1], al, cb[2], cb[3]);
      }
    }
  }
}

// ---------------------------------------------------------------- (2)
// the chunk kernel's shared memory (bytes): a two-stage ring of a head's
// (x, dy, dh_out hi, dh_out lo, h_in, dt) slice, then B, C, G^T, dS^T hi /
// lo (over the current stage's h_in where they fit), each warp's cum, the
// head's vectors and a stage's mbarrier each
template <int PT, int NP>
struct ChunkSmem {
  static constexpr int kNP = NP + kPad;   // bf16 pitch of B and C
  static constexpr int kXP = PT + kPad;   // of x and dy
  static constexpr int kSP = kL + kPad;   // bf16 pitch of dS^T
  // dh_out's halves (swizzled, pitch NP) and h_in (fp32 at pitch N as it
  // lands, then its swizzled halves at pitch NP) unpadded: one copy each
  static constexpr int kXT = kL * kXP * 2, kDH = PT * NP * 2, kHin = PT * NP * 4;
  static constexpr int kBC = kL * kNP * 2, kDS = kL * kSP * 2;
  static constexpr int kOffDY = kXT, kOffDHh = 2 * kXT, kOffDHl = kOffDHh + kDH;
  static constexpr int kOffHin = kOffDHl + kDH, kOffDt = kOffHin + kHin;
  static constexpr int kStage = kOffDt + kL * 4;
  static constexpr bool kDSInHin = 2 * kDS <= kHin;
  static constexpr int kOffB = 2 * kStage, kOffC = kOffB + kBC;
  // G^T in the accumulators' order: [row block][n8 tile][lane] float4
  static constexpr int kOffG = kOffC + kBC;
  static constexpr int kOffDS = kOffG + 4 * (kL / 2) * 32 * 4;  // when not over h_in
  static constexpr int kOffCum = kOffDS + (kDSInHin ? 0 : 2 * kDS);
  static constexpr int kOffVec = kOffCum + kWarps * kL * 4;
  // the vectors, in floats from kOffVec: rowQ partials [4][kL], colR [kL],
  // dw partials [2][kL], ht partials [2][kL], <dh_out, h_in> partials
  // [kWarps], trace(dM) partials [4]
  static constexpr int kRowQ = 0, kColR = 4 * kL, kDw = 5 * kL, kHt = 7 * kL, kHh = 9 * kL,
                       kDd = 9 * kL + kWarps;
  static constexpr int kOffBar = kOffVec + (kDd + 4) * 4;  // an mbarrier a stage
  static constexpr int kBytes = kOffBar + 2 * 8;
};

template <int PT, int NP>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(const Params p) {
  using L = ChunkSmem<PT, NP>;
  constexpr int kNP = L::kNP, kXP = L::kXP, kSP = L::kSP;
  constexpr int kPB = PT / 16;                 // k16 tiles over the slice's P
  constexpr int kNW = NP >= 32 ? NP / 2 : NP;  // columns of N a warp takes
  constexpr int kNT = kNW / 8;
  constexpr int kJG = kNT < 4 ? kNT : 4;       // n8 tiles of Z or V at a time
  constexpr int kPW = PT / 2;                  // columns of P a warp takes in dx
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int half = warp >> 2, rb = half ? 3 - (warp & 3) : warp & 3;
  const bool n_active = NP >= 32 || half == 0;
  const int nw0 = half * kNW, pw0 = half * kPW;
  const int sa = 16 * rb + g, sb = sa + 8;     // this thread's rows of the warp's row block
  const int run = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = run * p.K, grp = h0 / (p.H / p.G);
  const int c0 = c * kL, rows = min(kL, p.S - c0);
  const int ns = p.P / PT, sph = ns > 1 ? 2 * ns : 1, n_steps = p.K * sph;
  const bool vec16 = p.vec16, hin16 = p.hin16;
  uint16_t* sB = reinterpret_cast<uint16_t*>(smem + L::kOffB);
  uint16_t* sC = reinterpret_cast<uint16_t*>(smem + L::kOffC);
  float4* sG = reinterpret_cast<float4*>(smem + L::kOffG) + rb * (kL / 8) * 32 + lane;
  float* cw = reinterpret_cast<float*>(smem + L::kOffCum) + warp * kL;
  float* vec = reinterpret_cast<float*>(smem + L::kOffVec);
  float *rowQp = vec + L::kRowQ, *colR = vec + L::kColR, *dwp = vec + L::kDw, *htp = vec + L::kHt,
        *hhp = vec + L::kHh, *ddp = vec + L::kDd;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);

  clear(smem, L::kOffVec, kThreads);  // columns past N of B, C and h_in read as zero
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
  }
  __syncthreads();

  // step i of the run: head h0 + i / sph; A(q) (i % sph < ns: every product
  // but dx, summed over the slices) or X(q) (dx's second pass, P > 64)
  // dh_out's halves and h_in by three bulk copies from one thread (h_in by
  // element copies where its rows are not 16-byte aligned), on the stage's
  // mbarrier; x, dy and dt by cp.async from every thread
  auto load_step = [&](int i, int st) {
    if (i >= n_steps) return;
    const int h = h0 + i / sph, r = i % sph;
    const bool is_a = r < ns;
    const int q = is_a ? r : r - ns;
    uint8_t* s = smem + st * L::kStage;
    uint16_t* sdh = reinterpret_cast<uint16_t*>(s + L::kOffDHh);
    float* shin = reinterpret_cast<float*>(s + L::kOffHin);
    float* sdt = reinterpret_cast<float*>(s + L::kOffDt);
    const uint16_t* dhq = p.dh + ((((long long)b * p.nc + c) * p.H + h) * 2 * p.P + q * PT) * NP;
    const float* hq =
        p.hin + (((long long)b * p.nc + c) * p.H + h) * p.P * p.N + (long long)q * PT * p.N;
    if (tid == 0) {
      const bool hin_bulk = is_a && hin16;
      mbar_expect_tx(&bars[st], 2 * PT * NP * 2 + (hin_bulk ? PT * p.N * 4 : 0));
      bulk_copy(sdh, dhq, PT * NP * 2, &bars[st]);
      bulk_copy(sdh + PT * NP, dhq + (long long)p.P * NP, PT * NP * 2, &bars[st]);
      if (hin_bulk) bulk_copy(shin, hq, PT * p.N * 4, &bars[st]);
    }
    if (is_a && !hin16)
      for (int j = tid; j < PT * p.N; j += kThreads) shin[j] = hq[j];
    load_bf16<kL, kXP, PT, kThreads>(reinterpret_cast<uint16_t*>(s + L::kOffDY),
                                     p.dy + (((long long)b * p.S + c0) * p.H + h) * p.P + q * PT,
                                     (long long)p.H * p.P, PT, rows, vec16);
    if (is_a)
      load_bf16<kL, kXP, PT, kThreads>(reinterpret_cast<uint16_t*>(s),
                                       p.x + b * p.xs_b + h * p.xs_h + c0 * p.xs_s + q * PT,
                                       p.xs_s, PT, rows, vec16);
    const float* dtb = p.dt + b * p.ds_b + h;
    for (int j = tid; j < kL; j += kThreads)
      cp_async4(sdt + j, dtb + (j < rows ? (long long)(c0 + j) * p.ds_s : 0), j < rows);
    cp_async_commit();
  };

  load_bf16<kL, kNP, NP, kThreads>(sB, p.Bm + b * p.bs_b + grp * p.bs_g + c0 * p.bs_s, p.bs_s,
                                   p.N, rows, vec16);
  load_bf16<kL, kNP, NP, kThreads>(sC, p.Cm + b * p.bs_b + grp * p.bs_g + c0 * p.bs_s, p.bs_s,
                                   p.N, rows, vec16);
  load_step(0, 0);  // commits B and C with it

  // per thread: dM^T, then dS^T (rows s of the block, columns t: n8 tiles
  // j >= 2 rb), and the run's dB and dC
  float dm[kL / 8][4];
  float dBa[kNT][4], dCa[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dBa[j][i] = dCa[j][i] = 0.f;
  float htA = 0.f, htB = 0.f, dwA = 0.f, dwB = 0.f, hh = 0.f;

  // dx of slice q: w o (B dh_out^T) + M^T dy + D dy, stored in bf16; M's
  // fragments formed from G^T, the decay and dt a k-tile at a time
  auto do_dx = [&](int h, int q, const uint8_t* s) {
    const uint16_t* sDY = reinterpret_cast<const uint16_t*>(s + L::kOffDY);
    const uint16_t* sDHh = reinterpret_cast<const uint16_t*>(s + L::kOffDHh);
    const uint16_t* sDHl = reinterpret_cast<const uint16_t*>(s + L::kOffDHl);
    const float* sdt = reinterpret_cast<const float*>(s + L::kOffDt);
    float acc[kPW / 8][4];
#pragma unroll
    for (int j = 0; j < kPW / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t ba[4];
      ldsm4(ba, a_rows(sB, kNP, 16 * rb, 16 * kk, lane));
#pragma unroll
      for (int jp = 0; jp < kPW / 16; ++jp) {
        uint32_t bh[4], bl[4];
        ldsm4(bh, swz_rows<NP>(sDHh, pw0 + 16 * jp, 16 * kk, lane));
        ldsm4(bl, swz_rows<NP>(sDHl, pw0 + 16 * jp, 16 * kk, lane));
        Mma<T>::run(acc[2 * jp], ba, bh[0], bh[1]);
        Mma<T>::run(acc[2 * jp + 1], ba, bh[2], bh[3]);
        Mma<T>::run(acc[2 * jp], ba, bl[0], bl[1]);
        Mma<T>::run(acc[2 * jp + 1], ba, bl[2], bl[3]);
      }
    }
    const float seg2 = cw[kL - 1], csa = cw[sa], csb = cw[sb], dta = sdt[sa], dtb = sdt[sb];
    const float wa = dta * ex2(seg2 - csa), wb = dtb * ex2(seg2 - csb);
#pragma unroll
    for (int j = 0; j < kPW / 8; ++j) {
      acc[j][0] *= wa;
      acc[j][1] *= wa;
      acc[j][2] *= wb;
      acc[j][3] *= wb;
    }
#pragma unroll
    for (int ks = 0; ks < kL / 16; ++ks) {
      if (ks < rb) continue;  // t < s: zero
      float mt[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * ks + jj, t = 8 * j + 2 * tq;
        const float4 gv = sG[j * 32];
        const float2 ct = *reinterpret_cast<const float2*>(cw + t);
        mt[jj][0] = t >= sa ? gv.x * ex2(ct.x - csa) * dta : 0.f;
        mt[jj][1] = t + 1 >= sa ? gv.y * ex2(ct.y - csa) * dta : 0.f;
        mt[jj][2] = t >= sb ? gv.z * ex2(ct.x - csb) * dtb : 0.f;
        mt[jj][3] = t + 1 >= sb ? gv.w * ex2(ct.y - csb) * dtb : 0.f;
      }
      uint32_t ah[4], al[4];
      split_a(mt[0], mt[1], ah, al);
#pragma unroll
      for (int jp = 0; jp < kPW / 16; ++jp) {
        uint32_t yb[4];
        ldsm4t(yb, b_cols(sDY, kXP, pw0 + 16 * jp, 16 * ks, lane));
        Mma<T>::run(acc[2 * jp], ah, yb[0], yb[1]);
        Mma<T>::run(acc[2 * jp + 1], ah, yb[2], yb[3]);
        Mma<T>::run(acc[2 * jp], al, yb[0], yb[1]);
        Mma<T>::run(acc[2 * jp + 1], al, yb[2], yb[3]);
      }
    }
    const float dsc = p.D[h];
    const long long x_row = (long long)p.H * p.P;
    uint16_t* dxb = p.dx + ((long long)b * p.S + c0) * x_row + (long long)h * p.P + q * PT;
#pragma unroll
    for (int j = 0; j < kPW / 8; ++j) {
      const int col = pw0 + 8 * j + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int srow = r ? sb : sa;
        if (srow >= rows) continue;
        const float2 yv = bf2(ld32(sDY + srow * kXP + col));
        *reinterpret_cast<uint32_t*>(dxb + srow * x_row + col) =
            Mma<T>::pack(acc[j][2 * r] + dsc * yv.x, acc[j][2 * r + 1] + dsc * yv.y);
      }
    }
  };

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1, h = h0 + i / sph, r = i % sph;
    const bool is_a = r < ns;
    const int q = is_a ? r : r - ns;
    // this thread's shared-memory reads and writes of the last steps (dS^T
    // and h_in's halves over h_in) come before the copies issued after the
    // barrier
    fence_proxy_async();
    cp_async_wait<0>();
    mbar_wait(&bars[st], (i >> 1) & 1);
    __syncthreads();  // step i has landed; step i - 1 is done with the other stage
    load_step(i + 1, st ^ 1);
    const uint8_t* s = smem + st * L::kStage;
    if (!is_a) {
      do_dx(h, q, s);
      continue;
    }
    const uint16_t* sX = reinterpret_cast<const uint16_t*>(s);
    const uint16_t* sDY = reinterpret_cast<const uint16_t*>(s + L::kOffDY);
    const uint16_t* sDHh = reinterpret_cast<const uint16_t*>(s + L::kOffDHh);
    const uint16_t* sDHl = reinterpret_cast<const uint16_t*>(s + L::kOffDHl);
    float* sHin = reinterpret_cast<float*>(smem + st * L::kStage + L::kOffHin);
    const uint16_t* sHh = reinterpret_cast<const uint16_t*>(sHin);  // h_in's halves, once split
    const uint16_t* sHl = sHh + PT * NP;
    const float* sdt = reinterpret_cast<const float*>(s + L::kOffDt);
    uint16_t* sDSh = reinterpret_cast<uint16_t*>(
        L::kDSInHin ? smem + st * L::kStage + L::kOffHin : smem + L::kOffDS);
    uint16_t* sDSl = sDSh + kL * kSP;

    if (i == 0 && half == 0) {  // G^T = B C^T once for the run (tiles on or above the diagonal)
      float gt[kL / 8][4];
#pragma unroll
      for (int j = 0; j < kL / 8; ++j) gt[j][0] = gt[j][1] = gt[j][2] = gt[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t ba[4];
        ldsm4(ba, a_rows(sB, kNP, 16 * rb, 16 * kk, lane));
#pragma unroll
        for (int js = 0; js < kL / 16; ++js) {
          if (js < rb) continue;
          uint32_t cc[4];
          ldsm4(cc, b_rows(sC, kNP, 16 * js, 16 * kk, lane));
          Mma<T>::run(gt[2 * js], ba, cc[0], cc[1]);
          Mma<T>::run(gt[2 * js + 1], ba, cc[2], cc[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kL / 8; ++j)
        if (j / 2 >= rb) sG[j * 32] = make_float4(gt[j][0], gt[j][1], gt[j][2], gt[j][3]);
    }
    if (q == 0) {  // a new head: its cum, and the sums over its slices
      warp_cum(cw, sdt, p.A[h] * kLog2e, lane);
#pragma unroll
      for (int j = 0; j < kL / 8; ++j) dm[j][0] = dm[j][1] = dm[j][2] = dm[j][3] = 0.f;
      htA = htB = dwA = dwB = hh = 0.f;
    }
    const float seg2 = cw[kL - 1];

    {  // h_in's fp32 tile -> bf16 high and low halves in its place (rows of NP,
       // 16-byte pieces swizzled), and <dh_out, h_in> on the way
      constexpr int kV = PT * NP / 4, kPer = (kV + kThreads - 1) / kThreads;
      float4 hv[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int v = tid + k * kThreads, pr = v / (NP / 4), n = v % (NP / 4) * 4;
        hv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v < kV && n < p.N) {  // past N the tile may hold dS^T
          hv[k] = *reinterpret_cast<const float4*>(sHin + pr * p.N + n);
          const int o = pr * NP + swz<NP>(pr, n >> 3) * 8 + (n & 7);
          const uint2 dhh = *reinterpret_cast<const uint2*>(sDHh + o);
          const uint2 dhl = *reinterpret_cast<const uint2*>(sDHl + o);
          const float2 h01 = bf2(dhh.x), h23 = bf2(dhh.y), l01 = bf2(dhl.x), l23 = bf2(dhl.y);
          hh += hv[k].x * (h01.x + l01.x) + hv[k].y * (h01.y + l01.y) +
                hv[k].z * (h23.x + l23.x) + hv[k].w * (h23.y + l23.y);
        }
      }
      __syncthreads();  // every thread holds its part of the fp32 tile
      uint16_t* hhi = reinterpret_cast<uint16_t*>(sHin);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int v = tid + k * kThreads, pr = v / (NP / 4), n = v % (NP / 4) * 4;
        if (v >= kV) continue;
        uint2 hi, lo;
        split2(hv[k].x, hv[k].y, hi.x, lo.x);
        split2(hv[k].z, hv[k].w, hi.y, lo.y);
        const int o = pr * NP + swz<NP>(pr, n >> 3) * 8 + (n & 7);
        *reinterpret_cast<uint2*>(hhi + o) = hi;
        *reinterpret_cast<uint2*>(hhi + PT * NP + o) = lo;
      }
      __syncthreads();
    }

    if (n_active) {
      // Z = dy h_in (rows t, columns nw0..), kJG n8 tiles at a time
      const float ea = ex2(cw[sa]), eb = ex2(cw[sb]);
#pragma unroll
      for (int jg = 0; jg < kNT; jg += kJG) {
        float z[kJG][4];
#pragma unroll
        for (int j = 0; j < kJG; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kPB; ++kk) {
          uint32_t ya[4];
          ldsm4(ya, a_rows(sDY, kXP, 16 * rb, 16 * kk, lane));
#pragma unroll
          for (int jn = 0; jn < kJG / 2; ++jn) {
            uint32_t bh[4], bl[4];
            ldsm4t(bh, swz_cols<NP>(sHh, 16 * kk, nw0 + 8 * jg + 16 * jn, lane));
            ldsm4t(bl, swz_cols<NP>(sHl, 16 * kk, nw0 + 8 * jg + 16 * jn, lane));
            Mma<T>::run(z[2 * jn], ya, bh[0], bh[1]);
            Mma<T>::run(z[2 * jn + 1], ya, bh[2], bh[3]);
            Mma<T>::run(z[2 * jn], ya, bl[0], bl[1]);
            Mma<T>::run(z[2 * jn + 1], ya, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < kJG; ++j) {
          const int n = nw0 + 8 * (jg + j) + 2 * tq;
          const float2 ca = bf2(ld32(sC + sa * kNP + n)), cb = bf2(ld32(sC + sb * kNP + n));
          htA += ca.x * z[j][0] + ca.y * z[j][1];
          htB += cb.x * z[j][2] + cb.y * z[j][3];
          dCa[jg + j][0] += ea * z[j][0];
          dCa[jg + j][1] += ea * z[j][1];
          dCa[jg + j][2] += eb * z[j][2];
          dCa[jg + j][3] += eb * z[j][3];
        }
      }
    }
    if (n_active) {
      // V = x dh_out (rows s, columns nw0..) -> dw and dB += w o V
      const float wa = sdt[sa] * ex2(seg2 - cw[sa]), wb = sdt[sb] * ex2(seg2 - cw[sb]);
#pragma unroll
      for (int jg = 0; jg < kNT; jg += kJG) {
        float v[kJG][4];
#pragma unroll
        for (int j = 0; j < kJG; ++j) v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kPB; ++kk) {
          uint32_t xa[4];
          ldsm4(xa, a_rows(sX, kXP, 16 * rb, 16 * kk, lane));
#pragma unroll
          for (int jn = 0; jn < kJG / 2; ++jn) {
            uint32_t bh[4], bl[4];
            ldsm4t(bh, swz_cols<NP>(sDHh, 16 * kk, nw0 + 8 * jg + 16 * jn, lane));
            ldsm4t(bl, swz_cols<NP>(sDHl, 16 * kk, nw0 + 8 * jg + 16 * jn, lane));
            Mma<T>::run(v[2 * jn], xa, bh[0], bh[1]);
            Mma<T>::run(v[2 * jn + 1], xa, bh[2], bh[3]);
            Mma<T>::run(v[2 * jn], xa, bl[0], bl[1]);
            Mma<T>::run(v[2 * jn + 1], xa, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < kJG; ++j) {
          const int n = nw0 + 8 * (jg + j) + 2 * tq;
          const float2 ba = bf2(ld32(sB + sa * kNP + n)), bb = bf2(ld32(sB + sb * kNP + n));
          dwA += ba.x * v[j][0] + ba.y * v[j][1];
          dwB += bb.x * v[j][2] + bb.y * v[j][3];
          dBa[jg + j][0] += wa * v[j][0];
          dBa[jg + j][1] += wa * v[j][1];
          dBa[jg + j][2] += wb * v[j][2];
          dBa[jg + j][3] += wb * v[j][3];
        }
      }
    }

    // dM^T = x dy^T (rows s, columns t >= the block's diagonal), summed over slices
#pragma unroll
    for (int kk = 0; kk < kPB; ++kk) {
      uint32_t xa[4];
      ldsm4(xa, a_rows(sX, kXP, 16 * rb, 16 * kk, lane));
#pragma unroll
      for (int js = 0; js < kL / 16; ++js) {
        if (js < rb) continue;
        uint32_t yb[4];
        ldsm4(yb, b_rows(sDY, kXP, 16 * js, 16 * kk, lane));
        Mma<T>::run(dm[2 * js], xa, yb[0], yb[1]);
        Mma<T>::run(dm[2 * js + 1], xa, yb[2], yb[3]);
      }
    }
    const bool last = q == ns - 1;
    if (last) {  // the head's partial sums, each over a quad, a warp or a half
      const float hA = quad_sum(htA), hB = quad_sum(htB);
      const float wA = quad_sum(dwA), wB = quad_sum(dwB);
      const float hs = warp_sum(hh);
      if (tq == 0) {
        htp[half * kL + sa] = hA;
        htp[half * kL + sb] = hB;
        dwp[half * kL + sa] = wA;
        dwp[half * kL + sb] = wB;
      }
      if (lane == 0) hhp[warp] = hs;
    }
    __syncthreads();  // every warp is done with h_in: dS^T may take its place; G^T is in place
    if (!last) continue;

    if (ns == 1) do_dx(h, 0, s);
    // dS^T and R^T in the accumulators' layout: (s, t), t >= s selected;
    // R's row sums (colR) and column sums times dt_s (rowQ), dM's trace
    {
      const float csa = cw[sa], csb = cw[sb], dta = sdt[sa], dtb = sdt[sb];
      float colA = 0.f, colB = 0.f, ddv = 0.f;
#pragma unroll
      for (int j = 0; j < kL / 8; ++j) {
        if (j / 2 < rb) continue;
        float q0 = 0.f, q1 = 0.f;
        const float4 g4 = sG[j * 32];
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
        const float2 ct = *reinterpret_cast<const float2*>(cw + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int srow = e < 2 ? sa : sb, t = 8 * j + 2 * tq + (e & 1);
          const float dts = e < 2 ? dta : dtb, dmv = dm[j][e];
          float dsv = 0.f, rv = 0.f;
          if (t >= srow) {
            const float ev = ex2((e & 1 ? ct.y : ct.x) - (e < 2 ? csa : csb));
            dsv = dmv * ev * dts;
            rv = dmv * gv[e] * ev;
          }
          if (t == srow) ddv += dmv;
          dm[j][e] = dsv;
          if (e < 2) colA += rv;
          else colB += rv;
          if (e & 1) q1 += rv * dts;
          else q0 += rv * dts;
        }
        if (half == 0) {  // rowQ: the column sums of R dt_s over this row block
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            q0 += __shfl_xor_sync(0xffffffffu, q0, o);
            q1 += __shfl_xor_sync(0xffffffffu, q1, o);
          }
          if (g == 0) {
            rowQp[rb * kL + 8 * j + 2 * tq] = q0;
            rowQp[rb * kL + 8 * j + 2 * tq + 1] = q1;
          }
        }
      }
      if (half == 0) {
        colA = quad_sum(colA);
        colB = quad_sum(colB);
        ddv = warp_sum(ddv);
        if (tq == 0) {
          colR[sa] = colA;
          colR[sb] = colB;
        }
        if (lane == 0) ddp[rb] = ddv;
#pragma unroll
        for (int j = 0; j < kL / 8; ++j) {  // dS^T, hi and lo, for the t-row products
          if (j / 2 < rb) continue;
          const int t = 8 * j + 2 * tq;
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            uint32_t hi, lo;
            split2(dm[j][2 * r2], dm[j][2 * r2 + 1], hi, lo);
            const int srow = r2 ? sb : sa;
            *reinterpret_cast<uint32_t*>(sDSh + srow * kSP + t) = hi;
            *reinterpret_cast<uint32_t*>(sDSl + srow * kSP + t) = lo;
          }
        }
      }
    }
    __syncthreads();  // dS^T and the head's vectors are in place
    // dB after the barrier with dC: (4 - rb) k-tiles and (rb + 1), 5 for every warp
    if (n_active) {  // dB += dS^T C (rows s, k = t >= s)
#pragma unroll
      for (int ks = 0; ks < kL / 16; ++ks) {
        if (ks < rb) continue;
        uint32_t ah[4], al[4];
        split_a(dm[2 * ks], dm[2 * ks + 1], ah, al);
#pragma unroll
        for (int jn = 0; jn < kNT / 2; ++jn) {
          uint32_t cb[4];
          ldsm4t(cb, b_cols(sC, kNP, nw0 + 16 * jn, 16 * ks, lane));
          Mma<T>::run(dBa[2 * jn], ah, cb[0], cb[1]);
          Mma<T>::run(dBa[2 * jn + 1], ah, cb[2], cb[3]);
          Mma<T>::run(dBa[2 * jn], al, cb[0], cb[1]);
          Mma<T>::run(dBa[2 * jn + 1], al, cb[2], cb[3]);
        }
      }
    }
    if (n_active) {  // dC += dS B (rows t, k = s <= t), dS read back transposed
#pragma unroll
      for (int ks = 0; ks < kL / 16; ++ks) {
        if (ks > rb) continue;
        uint32_t ah[4], al[4];
        ldsm4t(ah, a_cols(sDSh, kSP, 16 * rb, 16 * ks, lane));
        ldsm4t(al, a_cols(sDSl, kSP, 16 * rb, 16 * ks, lane));
#pragma unroll
        for (int jn = 0; jn < kNT / 2; ++jn) {
          uint32_t bb[4];
          ldsm4t(bb, b_cols(sB, kNP, nw0 + 16 * jn, 16 * ks, lane));
          Mma<T>::run(dCa[2 * jn], ah, bb[0], bb[1]);
          Mma<T>::run(dCa[2 * jn + 1], ah, bb[2], bb[3]);
          Mma<T>::run(dCa[2 * jn], al, bb[0], bb[1]);
          Mma<T>::run(dCa[2 * jn + 1], al, bb[2], bb[3]);
        }
      }
    }
    if (warp == kEpiWarp) {
      // dcum, its reverse prefix sum rc, ddt, dA and dD: lane l has rows 2l, 2l + 1
      const float a = p.A[h];
      float dc[2], dwv[2], dtv[2], ed[2];
      float tot = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int rr = 2 * lane + u;
        dtv[u] = sdt[rr];
        ed[u] = ex2(seg2 - cw[rr]);
        dwv[u] = dwp[rr] + dwp[kL + rr];
        float rq = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k <= (rr >> 4)) rq += rowQp[k * kL + rr];
        const float wv = dtv[u] * ed[u];
        dc[u] = rq - dtv[u] * colR[rr] + ex2(cw[rr]) * (htp[rr] + htp[kL + rr]) - dwv[u] * wv;
        tot += dwv[u] * wv;
      }
      tot = warp_sum(tot);
      float hs = 0.f, dd = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) hs += hhp[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) dd += ddp[k];
      if (lane == 31) dc[1] += tot + ex2(seg2) * hs;
      float incl = dc[0] + dc[1];  // the sum over rows >= 2 lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      const float rc[2] = {incl, incl - dc[0]};
      const float da = warp_sum(dtv[0] * rc[0] + dtv[1] * rc[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int rr = 2 * lane + u;
        if (rr < rows)
          p.ddt[((long long)b * p.S + c0 + rr) * p.H + h] = colR[rr] + dwv[u] * ed[u] + a * rc[u];
      }
      if (lane == 0) {
        p.dAp[((long long)b * p.nc + c) * p.H + h] = da;
        p.dDp[((long long)b * p.nc + c) * p.H + h] = dd;
      }
    }
  }

  // the run's dB and dC, fp32
  if (n_active) {
    const long long base = ((long long)b * p.S + c0) * p.runs + run;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = nw0 + 8 * j + 2 * tq;
      if (n >= p.N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int srow = r ? sb : sa;
        if (srow >= rows) continue;
        const long long o = (base + (long long)srow * p.runs) * p.N + n;
        *reinterpret_cast<float2*>(p.dBp + o) = make_float2(dBa[j][2 * r], dBa[j][2 * r + 1]);
        *reinterpret_cast<float2*>(p.dCp + o) = make_float2(dCa[j][2 * r], dCa[j][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- (3)
// dB and dC: the runs' partials summed over each group in run order, in
// bf16, one thread an element of (B, S, G, N); dA and dD: the threads below
// H sum theirs over (batch, chunk) in order
__global__ void ssd_bwd_sum_kernel(const Params p) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (first < p.H) {
    const int h = static_cast<int>(first);
    float sa = 0.f, sd = 0.f;
    for (int bc = 0; bc < p.B * p.nc; ++bc) {
      sa += p.dAp[(long long)bc * p.H + h];
      sd += p.dDp[(long long)bc * p.H + h];
    }
    p.dA[h] = sa;
    p.dD[h] = sd;
  }
  const long long total = (long long)p.B * p.S * p.G * p.N;
  const int per = p.runs / p.G;  // runs a group
  for (long long i = first; i < total; i += (long long)gridDim.x * blockDim.x) {
    const int n = i % p.N;
    const long long bsg = i / p.N;  // (b, s) * G + g
    const int grp = bsg % p.G;
    const long long bs = bsg / p.G;
    const long long base = (bs * p.runs + (long long)grp * per) * p.N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < per; ++k) {
      sb += p.dBp[base + (long long)k * p.N];
      sc += p.dCp[base + (long long)k * p.N];
    }
    p.dB[i] = to_bf(sb);
    p.dC[i] = to_bf(sc);
  }
}

template <int NP, int PR>
cudaError_t launch_state(const Params& p, cudaStream_t s) {
  using L = StateSmem<NP, PR>;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_state_kernel<NP, PR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_state_kernel<NP, PR><<<dim3(p.B * p.H, p.P / PR, (NP + L::kSN - 1) / L::kSN),
                                 32 * L::kWarps, L::kBytes, s>>>(p);
  return cudaGetLastError();
}

template <int PT, int NP>
cudaError_t launch_chunk(const Params& p, cudaStream_t s) {
  constexpr int kBytes = ChunkSmem<PT, NP>::kBytes;
  static_assert(kBytes <= 232448, "the chunk kernel's tiles exceed an SM's shared memory");
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<PT, NP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<PT, NP><<<dim3(p.runs, p.nc, p.B), kThreads, kBytes, s>>>(p);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_n(const Params& p, cudaStream_t s) {
  cudaError_t e = p.P % kStateRows == 0 ? launch_state<NP, kStateRows>(p, s)
                                          : launch_state<NP, 32>(p, s);
  if (e != cudaSuccess) return e;
  e = p.P % 64 == 0 ? launch_chunk<64, NP>(p, s) : launch_chunk<32, NP>(p, s);
  if (e != cudaSuccess) return e;
  const long long total = (long long)p.B * p.S * p.G * p.N;
  long long blocks = (total + kThreads - 1) / kThreads;
  blocks = blocks < 4096 ? blocks : 4096;
  const long long head_blocks = (p.H + kThreads - 1) / kThreads;
  ssd_bwd_sum_kernel<<<(int)(blocks > head_blocks ? blocks : head_blocks), kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The backward of ssd_scan, in three launches on `stream`. x, B and C bf16
// with the last dim contiguous (strides in elements), dt fp32 with h
// contiguous, A and D fp32 (H,), hin (B, ceil(S / 64), H, P, N) fp32 from
// ssd_scan_states, dy bf16 (B, S, H, P) contiguous, dstate fp32 (B, H, P, N)
// contiguous or null; the scratch dh (B, nc, H, 2, P, NP) bf16 with NP the
// least of 16, 32, 64, 128 that holds N, dBp and dCp (B, S, H / K, N) and
// dAp and dDp (B, nc, H) fp32, and the outputs dx (B, S, H, P) bf16, ddt
// (B, S, H) fp32, dB and dC (B, S, G, N) bf16, dA and dD (H,) fp32, all
// contiguous. H a multiple of G, K (heads a run) a divisor of H / G, P a
// multiple of 32, N of 4 and at most 128. Returns the cudaError_t of the
// launches (0 = launched).
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* D, const float* hin, const void* dy,
                            const float* dstate, void* dh, void* dx, float* ddt, float* dBp,
                            float* dCp, float* dAp, float* dDp, void* dB, void* dC, float* dA,
                            float* dD, long long xs_b, long long xs_s, long long xs_h,
                            long long bs_b, long long bs_s, long long bs_g, long long ds_b,
                            long long ds_s, int B, int S, int H, int P, int G, int N, int K,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 32 || N <= 0 || N % 4 ||
      N > kMaxN || K <= 0 || (H / G) % K)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.dt = dt;
  p.A = A;
  p.Bm = static_cast<const uint16_t*>(Bm);
  p.Cm = static_cast<const uint16_t*>(Cm);
  p.D = D;
  p.hin = hin;
  p.dy = static_cast<const uint16_t*>(dy);
  p.dstate = dstate;
  p.dh = static_cast<uint16_t*>(dh);
  p.dx = static_cast<uint16_t*>(dx);
  p.ddt = ddt;
  p.dBp = dBp;
  p.dCp = dCp;
  p.dAp = dAp;
  p.dDp = dDp;
  p.dB = static_cast<uint16_t*>(dB);
  p.dC = static_cast<uint16_t*>(dC);
  p.dA = dA;
  p.dD = dD;
  p.xs_b = xs_b;
  p.xs_s = xs_s;
  p.xs_h = xs_h;
  p.bs_b = bs_b;
  p.bs_s = bs_s;
  p.bs_g = bs_g;
  p.ds_b = ds_b;
  p.ds_s = ds_s;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.NP = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
  p.nc = (S + kL - 1) / kL;
  p.K = K;
  p.runs = H / K;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                         reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(dy);
  p.vec16 = ptrs % 16 == 0 && N % 8 == 0 && (xs_b | xs_s | xs_h | bs_b | bs_s | bs_g) % 8 == 0;
  p.hin16 = reinterpret_cast<uintptr_t>(hin) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.NP) {
    case 16: return launch_n<16>(p, s);
    case 32: return launch_n<32>(p, s);
    case 64: return launch_n<64>(p, s);
    default: return launch_n<128>(p, s);
  }
}
