// Flash-attention forward for Hopper (sm_90a): bf16/fp16 in, fp32 softmax.
//
// Replaces the TPU kernel `_fa_kernel` behind `flash_attention_fwd` in
// src/repro/kernels/flash_attention.py (its pallas_call at :211). Same
// contract: q (B,S,H,D), k/v (B,T,Hkv,D) -> out (B,S,H,D) in q's dtype and
// the per-row log-sum-exp lse (B*H, S) fp32; scale 1/sqrt(D); mask k_pos <
// T plus causal / sliding window / q_offset; optional logit softcap; GQA as
// head h reading kv head h / group. A row that sees no key gives output 0
// and lse = -1e30.
//
// Design. The TPU kernel walks a sequential kv grid axis and carries (m, l,
// acc) in VMEM scratch between grid steps; Hopper blocks run in no order,
// so a block owns whole 128-row query tiles of one (b, h) and loops over
// the key tiles itself (128 keys at D = 64, 64 at D = 128), carrying m, l
// and the output in registers. No
// sum crosses blocks. The grid is persistent (one block an SM, each taking
// work items blockIdx.x, + gridDim.x, ...); under causal masking the items
// run heaviest query tile first, so the last wave is not a long tail.
//
// A block is two consumer warpgroups of 64 query rows each and one
// producer warp (of a warpgroup that gives up its registers; the other
// three warps exit at once). Its lane 0 has the Tensor Memory Accelerator
// copy the Q tile once per item and the K and V tiles into a ring of
// stages (`full` / `empty` mbarriers), straight from the caller's strided
// (B, L, heads, D) layout: one 4-D tensor map per operand over (D, L,
// heads, B), boxes of 64 x 64 with the 128-byte swizzle, so rows past S or
// T land as zeros and never come from the next head. Per key tile a
// consumer warpgroup runs
//   S = Q K^T    wgmma m64n{keys}k16, both operands K-major in shared
//                memory;
//   the online softmax in fp32 registers on wgmma's accumulator layout, in
//                base-2 units, masking only on a tile that crosses T, the
//                causal diagonal or the window;
//   O += P V     wgmma m64n{D}k16 with A = P from registers (P rounded to
//                the input dtype once, packed straight from S's
//                accumulators) and V read MN-major through the transpose
//                flag, so no V^T copy is made.
// bf16 x bf16 products are exact in fp32, so S matches an fp32 Q K^T up to
// summation order; P's rounding (at most 2^-9 relative per probability in
// bf16) is not seen by the row normaliser l, summed from the fp32 P.
// setmaxnreg moves registers from the producer warp to the consumers. Each
// warpgroup runs S, softmax and P V in turn, and the other warpgroup's
// products fill the tensor cores meanwhile: issuing the next tile's S
// before this tile's P V (FlashAttention-3's intra-warpgroup overlap), with
// or without ping-pong barriers between the warpgroups, measured slower on
// an H100 at every shape chip_smoke.py times.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), counted as
// chip_smoke.py counts it: the ESM-2 serving shape B=32, S=T=1024, H=20,
// D=64 is 4*B*H*S*T*D = 1.7e11 FLOP (0.174 ms) against q, k, v read and
// out written once plus lse, 0.34 GB (0.10 ms): operations bound it. The
// ESM-2 training shape (B=8) is a quarter of that (0.043 ms); under causal
// masking only the visible half counts: Qwen2-7B's prefill (B=1, S=T=1024,
// 28 q / 4 kv heads, D=128) 7.5e9 FLOP (0.0076 ms), Llama-4-Scout's
// training forward (B=2, S=T=1024, 40 q / 8 kv heads, D=128, window 8192)
// 2.1e10 FLOP (0.0217 ms), all bound by operations.

#include <cuda.h>
#include <cuda_runtime.h>

#include "attention_fwd.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace hopper;
using attn::kBM;
using attn::kBox;
using attn::kConsumers;
using attn::kThreads;
using attn::Layout;

struct Params {
  uint16_t* o;
  float* lse;
  int S, T, H, group, n_q_tiles, n_items;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float scale;    // 1/sqrt(D)
  float softcap;  // 0 = off
};

// work item i -> (query tile, b*h): under causal masking tile-major with the
// heaviest (last) tile first, else head-major (neighbours share K and V)
__device__ __forceinline__ int2 item_at(const Params& p, int i, int BH) {
  if (p.causal) return make_int2(p.n_q_tiles - 1 - i / BH, i % BH);
  return make_int2(i % p.n_q_tiles, i / p.n_q_tiles);
}

// the key tiles a query tile at q0 can see: [*k_begin, + n * kBN)
template <int kBN>
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int* k_begin) {
  const int q_last = min(q0 + kBM, p.S) - 1 + p.q_offset;
  int end = p.T, begin = 0;
  if (p.causal) end = min(end, q_last + 1);
  if (p.window > 0) begin = max(0, q0 + p.q_offset - p.window + 1);
  begin = (begin / kBN) * kBN;
  *k_begin = begin;
  return end > begin ? (end - begin + kBN - 1) / kBN : 0;
}

// rows [r0, r0 + R) x all D of the (D, L, heads, B) map into a tile at dst
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int r0, int head,
                                          int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < R / kBox; ++r)
      tma_load(dst + c * R * 128 + r * kBox * 128, map, 64 * c, r0 + r * kBox, head, b, bar);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv, const Params p) {
  using L = Layout<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t full[L::kStages], empty[L::kStages], q_full, q_empty;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sq = base, ring = base + L::kQBytes;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int BH = p.n_items / p.n_q_tiles;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, kConsumers * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
        const int2 it = item_at(p, i, BH);
        const int q0 = it.x * kBM, b = it.y / p.H, h = it.y % p.H, hk = h / p.group;
        int k_begin;
        const int n = key_tiles<kBN>(p, q0, &k_begin);
        if (n == 0) continue;  // the consumers write the empty rows alone
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(&q_full, L::kQBytes);
        load_tile<D, kBM>(sq, &mq, q0, h, b, &q_full);
        for (int j = 0; j < n; ++j) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], L::kStageBytes);
          const uint32_t sk = ring + stage * L::kStageBytes;
          load_tile<D, kBN>(sk, &mk, k_begin + j * kBN, hk, b, &full[stage]);
          load_tile<D, kBN>(sk + L::kTileBytes, &mv, k_begin + j * kBN, hk, b, &full[stage]);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
      const int2 it = item_at(p, i, BH);
      const int q0 = it.x * kBM, bh = it.y, b = bh / p.H, h = bh % p.H;
      int k_begin;
      const int n = key_tiles<kBN>(p, q0, &k_begin);
      attn::consume_item<T, D, true, false>(p, q0, n, k_begin, b, h, bh, sq, ring, full, empty,
                                            &q_full, &q_empty, stage, phase, q_phase);
    }
  }
}

// the 4-D map of a (B, L, heads, D) operand from geo = {D, L, heads, B,
// byte strides of L, heads, B}: boxes of 64 columns x 64 rows
bool make_operand_map(CUtensorMap* map, int dtype, const void* p, const long long* geo) {
  const cuuint64_t dims[4] = {cuuint64_t(geo[0]), cuuint64_t(geo[1]), cuuint64_t(geo[2]),
                              cuuint64_t(geo[3])};
  const cuuint64_t strides[3] = {cuuint64_t(geo[4]), cuuint64_t(geo[5]), cuuint64_t(geo[6])};
  const cuuint32_t box[4] = {64, kBox, 1, 1};
  return make_map(map, dtype ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, p, dims, strides, box);
}

template <typename T, int D>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const Params& p,
           cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<D>::kSmem);
  if (err != cudaSuccess) return err;
  const int grid = p.n_items < num_sms() ? p.n_items : num_sms();
  kernel<<<grid, kThreads, Layout<D>::kSmem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. geo: for q, k, v in turn, the tensor
// map's {D, L, heads, B} and the byte strides of L, heads, B (7 values
// each). out's strides are in elements; its head dim is contiguous.
// Returns the cudaError_t of the launch (0 = launched), or -1 if the driver
// refused a tensor map.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
    int B, int S, int T, int H, int Hkv, int D, const long long* geo,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, int q_offset, void* stream) {
  CUtensorMap mq, mk, mv;
  if (!make_operand_map(&mq, dtype, q, geo) || !make_operand_map(&mk, dtype, k, geo + 7) ||
      !make_operand_map(&mv, dtype, v, geo + 14))
    return -1;
  Params p;
  p.o = static_cast<uint16_t*>(out);
  p.lse = lse;
  p.S = S;
  p.T = T;
  p.H = H;
  p.group = H / Hkv;
  p.n_q_tiles = (S + kBM - 1) / kBM;
  p.n_items = p.n_q_tiles * B * H;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = 1.0f / sqrtf(float(D));
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.n_items == 0) return cudaSuccess;
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(mq, mk, mv, p, s);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(mq, mk, mv, p, s);
  if (dtype == 1 && D == 64) return launch<__half, 64>(mq, mk, mv, p, s);
  if (dtype == 1 && D == 128) return launch<__half, 128>(mq, mk, mv, p, s);
  return cudaErrorInvalidValue;
}
