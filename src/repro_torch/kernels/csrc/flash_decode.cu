// Flash-decoding for Hopper (sm_90a): one query token per row against a
// dense KV cache, bf16 in, fp32 softmax.
//
// Replaces the TPU kernel `_fd_kernel` behind `flash_decode` in
// src/repro/kernels/flash_decode.py (its pallas_call). Same contract:
// q (B,1,H,D), k/v (B,T,Hkv,D), lengths (B,) -> out (B,1,H,D) in q's dtype;
// scale 1/sqrt(D); optional logit softcap; keys at positions >= length are
// masked; GQA as query head h reading kv head h / group; a row with length
// 0 (an idle serving slot) gives exactly 0.
//
// Design. The TPU kernel walks the cache along a sequential grid axis of
// 512-key blocks and carries (m, l, acc) in VMEM scratch. Hopper blocks run
// in no order, so the cache is split instead (flash-decoding): grid
// (splits, Hkv, B), one block per (row, kv head, 256-key chunk), holding the
// group's query heads. The chunk size is fixed, so the split of a row
// depends on neither the batch nor the other rows: a request's bits do not
// move with its batch mates. Blocks whose chunk starts at or past the row's
// length return before any load.
//
// Inside a block, four warps share the chunk's 16-key sub-tiles, warp w
// taking sub-tiles w, w + 4, ... (balanced when the row ends inside the
// chunk). Each warp streams its sub-tiles through its own ring of
// shared-memory stages (K and V of one sub-tile a stage) with 16-byte
// cp.async copies: the next stages are in flight while the warp computes
// on this one, and a row past the length is zero-filled, not read. A
// sub-tile's K and V are consumed together, in one pass, with an online
// softmax across the warp's sub-tiles (fp32 m and l, expf): S = Q K^T and
// O += P V run on the tensor cores as mma.sync m16n8k16, the group's query
// heads on the M side padded to 16 rows with zeros, P rounded to bf16 from
// the S accumulators in registers (the plain version rounds the normalized
// P to bf16 too), V's fragments read with ldmatrix.trans. At the end the
// four warps' (m, l, O) merge through shared memory in warp order, and the
// block writes fp32 partials (m, l, acc) for its chunk; a second small
// kernel combines the partials of each (row, head) in split order. No
// atomics, so a step repeats bit for bit. The split and combine bodies
// live in decode_split.cuh, shared with the paged decode kernel of
// paged_attention.cu; here a stage's rows come from one base pointer and
// the row stride (`Dense::stage`).
//
// Bound on an H100 SXM (3.35 TB/s): memory. Each live cache row is read
// once for K and once for V: at Qwen2-7B's decode shape (B=32, T=2048,
// Hkv=4, D=128 bf16) a full cache is 134 MB (40 us); a ragged batch reads
// sum(lengths) * Hkv * D * 4 B. The products (4 * H * D per live key, 16/7
// of that with the padded rows) take ~2 us of the tensor cores.

#include <cuda_runtime.h>

#include "decode_split.cuh"
#include "mma.cuh"

namespace {

using decode::kMaxGroup;

// a stage's K and V rows: the chunk's rows of a (row, kv head) of a dense
// strided cache
struct Dense {
  const uint16_t* k;
  const uint16_t* v;
  long long k_sb, k_st, k_sh, v_sb, v_st, v_sh;

  template <int D>
  __device__ __forceinline__ void stage(uint16_t* dk, uint16_t* dv, int b, int hk, int k0,
                                        int key0, int n, int lane) const {
    decode::kv_stage<D>(dk, k + b * k_sb + hk * k_sh + k0 * k_st, k_st, key0, n, lane);
    decode::kv_stage<D>(dv, v + b * v_sb + hk * v_sh + k0 * v_st, v_st, key0, n, lane);
  }
};

template <int D>
__global__ void __launch_bounds__(decode::kThreads)
    flash_decode_split_kernel(const decode::Split p, const Dense a) {
  extern __shared__ __align__(16) uint8_t smem[];
  decode::split_body<D>(p, a, smem);
}

template <int D>
__global__ void __launch_bounds__(D / 2) flash_decode_combine_kernel(const decode::Split p) {
  decode::combine_body<D>(p);
}

template <int D>
cudaError_t launch(const decode::Split& p, const Dense& a, int B, int Hkv, cudaStream_t stream) {
  constexpr int kBytes = decode::Smem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  flash_decode_split_kernel<D><<<dim3(p.splits, Hkv, B), decode::kThreads, kBytes, stream>>>(p, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<D><<<B * p.H, D / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The number of splits a cache of T rows is cut into (the wrapper sizes
// the partials with it).
extern "C" int flash_decode_splits(int T) { return decode::splits_of(T); }

// bf16 operands. Strides are in elements; the head dim is
// contiguous; out is written through its batch and head strides. part_m,
// part_l and part_acc are fp32 scratch of B*H*splits (and *D) elements.
// Returns the cudaError_t of the launches (0 = launched).
extern "C" int flash_decode(
    const void* q, const void* k, const void* v, const int* lengths, void* out,
    float* part_m, float* part_l, float* part_acc,
    int B, int T, int H, int Hkv, int D,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_sh, float softcap, void* stream) {
  if (Hkv <= 0 || H % Hkv || H / Hkv > kMaxGroup) return cudaErrorInvalidValue;
  decode::Split p = decode::make_split(q, lengths, out, part_m, part_l, part_acc, H, Hkv, D, q_sb,
                                       q_sh, o_sb, o_sh, softcap);
  p.T = T;
  p.splits = decode::splits_of(T);
  Dense a;
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(p, a, B, Hkv, s);
  if (D == 128) return launch<128>(p, a, B, Hkv, s);
  return cudaErrorInvalidValue;
}
