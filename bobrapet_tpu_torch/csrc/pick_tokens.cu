// The token pick of a decode step: per row of logits, the argmax (T == 0)
// or a Gumbel-max draw at temperature T (T > 0):
//
//   greedy:  token = argmax_v float(logit_v)
//   sampled: token = argmax_v (float(logit_v) / T + g_v)
//            g_v = -log(-log(u_v)), u_v = ((w_v >> 8) + 0.5) * 2^-24
//            w_v = word v % 4 of Philox4x32-10(counter (v / 4, index, rid, 0),
//                                               key (0, 0))
//
// ties go to the lowest index, and a NaN wins (the first NaN), as
// torch.argmax and jnp.argmax pick.
//
// Replaces: the token picks of bobrapet_tpu/serving/engine.py (jnp.argmax
// and jax.random.categorical at :2916-2921 and :3075-3078, _sample_host
// :2718-2727) and of serving/spec_decode.py (:194-199, :331-334). No Pallas:
// XLA fused them. jax.random.categorical is Gumbel-max over threefry bits;
// Philox takes threefry's place, so a draw has JAX's distribution and not
// its bits. A sampled token is a pure function of (rid, token index), the
// key JAX folds (_fold_keys), so a stream does not depend on the slot, the
// horizon or the co-scheduled requests.
//
// u: the exact value ((w >> 8) + 0.5) 2^-24 is not an fp32 number above
// 0.5 (it needs 25 bits), and rounding it can give u = 1 and g = +inf. So
// -log(u) is taken from the exact distance to the nearer end: below 0.5
// -log(m) with m = u, above it -log1p(-m) with m = 1 - u, both m exact.
// Every operation is an IEEE fp32 one with round to nearest (the division
// included; no contraction into an FMA), and logf / log1pf are the
// full-precision functions, not __logf: the plain version in
// ops/pick_tokens.py repeats the arithmetic, and the two agree bit for bit
// on greedy rows and up to an ulp of a log on sampled ones.
//
// Bound on the card: bytes. A row set [8, 128256] fp32 is 4.10 MB read once,
// 1.22 us at 3.35 TB/s; a sampled element adds one Philox word (a quarter of
// ten rounds) and two logs, well under what 67 TFLOP/s of fp32 does in that
// time.
//
// Design: a row is split over the `splits` blocks of a thread-block cluster
// (as the decode attention splits its keys), each block a contiguous run of
// 4-element groups; a thread takes one group at a time (one 16-byte load of
// fp32, 8 of bf16, and one Philox call for 4 words), keeps its best (score,
// index), the warp reduces with shuffles, the block's warps through shared
// memory, and each block pushes its best into rank 0's shared memory (DSMEM);
// after one cluster barrier rank 0 combines the blocks in rank order and
// writes the token. One launch, no atomics, the same bits every run.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace bobra {
namespace pick {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;

// the better of two (score, index) candidates: a NaN first, then the larger
// score, then the lower index
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  const bool n = s != s, bn = bs != bs;
  if (n || bn) return n && (!bn || i < bi);
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// g = -log(-log(u)) for u = ((w >> 8) + 0.5) 2^-24 (see the header)
__device__ __forceinline__ float gumbel(uint32_t w) {
  const uint32_t x = w >> 8;
  const bool upper = x >= (1u << 23);
  const uint32_t y = upper ? 0xFFFFFFu - x : x;
  const float m = __fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), 5.9604644775390625e-08f);
  const float e = upper ? -log1pf(-m) : -logf(m);
  return -logf(e);
}

// the four logits of group g as floats; `vec`: the row is 16-byte (fp32) or
// 8-byte (bf16) aligned and holds whole groups
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* row, long long g, int v, float (&l)[4]);

template <>
__device__ __forceinline__ void load4<float, true>(const float* row, long long g, int,
                                                   float (&l)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(row) + g);
  l[0] = x.x;
  l[1] = x.y;
  l[2] = x.z;
  l[3] = x.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, true>(const __nv_bfloat16* row, long long g,
                                                           int, float (&l)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(row) + g);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  l[0] = __low2float(a);
  l[1] = __high2float(a);
  l[2] = __low2float(b);
  l[3] = __high2float(b);
}

template <>
__device__ __forceinline__ void load4<float, false>(const float* row, long long g, int v,
                                                    float (&l)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) l[j] = 4 * g + j < v ? row[4 * g + j] : -INFINITY;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, false>(const __nv_bfloat16* row,
                                                            long long g, int v, float (&l)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) l[j] = 4 * g + j < v ? to_float(row[4 * g + j]) : -INFINITY;
}

// Grid (splits, rows), cluster (splits, 1, 1), kThreads threads. temps,
// rids, index: [rows] or null (every row greedy).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
pick_tokens_kernel(const T* __restrict__ logits, const float* __restrict__ temps,
                   const int* __restrict__ rids, const int* __restrict__ index,
                   int* __restrict__ out, int v) {
  __shared__ float warp_s[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float slot_s[kMaxSplits];
  __shared__ int slot_i[kMaxSplits];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const T* row = logits + static_cast<long long>(r) * v;

  const float t = temps == nullptr ? 0.f : temps[r];
  const bool sampled = t > 0.f;
  const uint32_t c1 = sampled ? static_cast<uint32_t>(index[r]) : 0u;
  const uint32_t c2 = sampled ? static_cast<uint32_t>(rids[r]) : 0u;

  const long long groups = (static_cast<long long>(v) + 3) / 4;
  const long long per = (groups + splits - 1) / splits;
  const long long g0 = per * rank;
  const long long g1 = g0 + per < groups ? g0 + per : groups;

  float best_s = -INFINITY;
  int best_i = 0x7fffffff;
#pragma unroll 4
  for (long long g = g0 + tid; g < g1; g += kThreads) {
    float l[4];
    load4<T, kVec>(row, g, v, l);
    if (sampled) {
      const uint4 w = philox4x32_10(make_uint4(static_cast<uint32_t>(g), c1, c2, 0u), 0u, 0u);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) l[j] = __fadd_rn(__fdiv_rn(l[j], t), gumbel(ws[j]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = static_cast<int>(4 * g + j);
      if (i < v && better(l[j], i, best_s, best_i)) {
        best_s = l[j];
        best_i = i;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_xor_sync(0xffffffffu, best_s, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(s, i, best_s, best_i)) {
      best_s = s;
      best_i = i;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    warp_s[warp] = best_s;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  cluster.sync();  // every block of the cluster runs: rank 0's slots exist
  if (tid == 0) {
    float s = warp_s[0];
    int i = warp_i[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(warp_s[w], warp_i[w], s, i)) {
        s = warp_s[w];
        i = warp_i[w];
      }
    }
    cluster.map_shared_rank(slot_s, 0)[rank] = s;
    cluster.map_shared_rank(slot_i, 0)[rank] = i;
  }
  cluster.sync();  // the slots are written and visible to rank 0
  if (rank == 0 && tid == 0) {
    float s = slot_s[0];
    int i = slot_i[0];
    for (int b = 1; b < splits; ++b) {
      if (better(slot_s[b], slot_i[b], s, i)) {
        s = slot_s[b];
        i = slot_i[b];
      }
    }
    // a row of no element (v == 0) is refused by the entry
    out[r] = i;
  }
}

template <typename T, bool kVec>
int launch(const void* logits, const void* temps, const void* rids, const void* index,
           void* out, int rows, int v, int splits, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, pick_tokens_kernel<T, kVec>, static_cast<const T*>(logits),
      static_cast<const float*>(temps), static_cast<const int*>(rids),
      static_cast<const int*>(index), static_cast<int*>(out), v);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pick
}  // namespace bobra

// logits: [rows, v] contiguous, fp32 or bf16; temps: fp32 [rows], rids and
// index: int32 [rows], all three null for an all-greedy call (else all
// three set); out: int32 [rows]. splits: 1, 2, 4 or 8, the blocks of the
// cluster that split a row. vec: the logits are 16-byte aligned and v a
// multiple of 4 (the 16- or 8-byte loads). Returns the cudaError_t of the
// launch.
extern "C" int bobra_pick_tokens(const void* logits, const void* temps, const void* rids,
                                 const void* index, void* out, int rows, int v, int splits,
                                 int vec, int dtype, void* stream) {
  using namespace bobra;
  if (rows < 1 || rows > 65535 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (splits != 1 && splits != 2 && splits != 4 && splits != pick::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((temps == nullptr) != (rids == nullptr) || (temps == nullptr) != (index == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return vec ? pick::launch<float, true>(logits, temps, rids, index, out, rows, v, splits, st)
               : pick::launch<float, false>(logits, temps, rids, index, out, rows, v, splits,
                                            st);
  }
  if (dtype == kBFloat16) {
    return vec ? pick::launch<__nv_bfloat16, true>(logits, temps, rids, index, out, rows, v,
                                                   splits, st)
               : pick::launch<__nv_bfloat16, false>(logits, temps, rids, index, out, rows, v,
                                                    splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
