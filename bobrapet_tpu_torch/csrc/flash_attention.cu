// Flash attention (online softmax), causal or not, with GQA and a q offset.
//
// Replaces: bobrapet_tpu/ops/attention.py:flash_attention (_flash_kernel).
// Beyond the Pallas kernel it takes a q_offset (query i sits at position
// q_offset + i, as attention_reference defines it) and ragged Sq / Sk, so
// the same kernel carries the model's cached prefill and every decode step
// (models/llama.py:_cached_attention slices the cache to its valid length
// and calls it with q_offset = valid_len - Sq).
//
// Bound on the card: bytes at the model's shapes. Prefill (q [8,128,32,128],
// k/v [8,128,8,128], bf16) moves 21.0 MB against 1.08 GFLOP of causal
// work, 6.3 us at 3.35 TB/s against 1.1 us at 989 TFLOP/s; a decode step
// (Sq = 1) is bytes by far more.
//
// Design (simple and right first; wgmma/TMA and packing the GQA group into
// one q tile are later work): one block of 128 threads per (q tile of 16
// rows, query head, batch). The q tile is scaled in fp32 and kept in
// shared memory; k/v tiles of 32 keys are staged in shared memory as fp32
// and read by all 16 rows, so device memory sees each k/v row once per
// q tile. Each query head finds its kv head as hq / group: no repeat is
// materialised. Scores: lane j of each warp owns key j of the tile and 4
// of the 16 rows, so the row max and sum are warp shuffles. m, l and the
// output accumulator are fp32; masked keys get -1e30 as in the reference,
// keys past Sk get -inf, and k tiles wholly past the causal bound are
// never loaded. Products are scalar FMAs. The K tile is padded by one
// column so the 32 lanes hit 32 banks.

#include <math.h>

#include "common.cuh"

namespace bobra {

constexpr int kBlockM = 16;   // query rows per block
constexpr int kBlockN = 32;   // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int sq, int sk, int group,
                       long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                       int causal, int q_offset, float scale) {
  static_assert(kThreads % D == 0 && kBlockM % (kThreads / D) == 0, "unsupported head dim");
  constexpr int kRowsPerWarp = kBlockM / kWarps;        // score phase
  constexpr int kRowStride = kThreads / D;              // output phase
  constexpr int kRowsPerThread = kBlockM / kRowStride;  // output phase

  __shared__ float qs[kBlockM][D];
  __shared__ float ks[kBlockN][D + 1];
  __shared__ float vs[kBlockN][D];
  __shared__ float ps[kBlockM][kBlockN];
  __shared__ float alpha_s[kBlockM];
  __shared__ float l_s[kBlockM];

  const int row0 = blockIdx.x * kBlockM;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // heads are packed along the token: head h starts at h * D
  const T* qb = q + b * q_sb + static_cast<long long>(hq) * D;
  const T* kb = k + b * k_sb + static_cast<long long>(hq / group) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(hq / group) * D;
  T* ob = o + b * o_sb + static_cast<long long>(hq) * D;

  for (int e = tid; e < kBlockM * D; e += kThreads) {
    const int r = e / D, c = e % D, qi = row0 + r;
    qs[r][c] = qi < sq ? to_float(qb[qi * q_ss + c]) * scale : 0.f;
  }
  const int row_end = min(sq, row0 + kBlockM);
  // causal: keys past q_offset + (last row) are masked for every row here
  const int kv_len = causal ? min(sk, q_offset + row_end) : sk;

  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int dcol = tid % D, rgroup = tid / D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kBlockN) {
    __syncthreads();  // the last tile's ks/vs/ps are consumed (and qs is written)
    for (int e = tid; e < kBlockN * D; e += kThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      const bool ok = kj < kv_len;
      ks[j][c] = ok ? to_float(kb[kj * k_ss + c]) : 0.f;
      vs[j][c] = ok ? to_float(vb[kj * v_ss + c]) : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(qs[r][c], ks[lane][c], s);
      if (kj >= sk) {
        s = -INFINITY;  // not a key at all
      } else if (causal && kj > q_offset + row0 + r) {
        s = kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      ps[r][lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] *= alpha_s[rgroup + kRowStride * i];
    for (int j = 0; j < kBlockN; ++j) {
      const float vv = vs[j][dcol];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        acc[i] = fmaf(ps[rgroup + kRowStride * i][j], vv, acc[i]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp + kWarps * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rgroup + kRowStride * i, qi = row0 + r;
    if (qi < sq) ob[qi * o_ss + dcol] = from_float<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                 int hq, int group, int d, long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                 int causal, int q_offset, float scale, cudaStream_t st) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, hq, b);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define BOBRA_FLASH(DD)                                                                   \
  flash_attention_kernel<T, DD><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, group,  \
                                                          q_sb, q_ss, k_sb, k_ss, v_sb,     \
                                                          v_ss, o_sb, o_ss, causal,         \
                                                          q_offset, scale)
  switch (d) {
    case 32: BOBRA_FLASH(32); break;   // llama_tiny
    case 128: BOBRA_FLASH(128); break;  // llama3_1b, llama3_8b
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BOBRA_FLASH
  return 0;
}

}  // namespace bobra

// q [b, sq, hq, d], k/v [b, sk, hq/group, d], o like q. The last axis is
// contiguous and heads are packed (head stride d); batch and sequence
// strides are given in elements, so a sliced KV cache needs no copy.
// Returns the cudaError_t of the launch.
extern "C" int bobra_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int b, int sq, int sk, int hq, int group, int d,
                                     long long q_sb, long long q_ss, long long k_sb,
                                     long long k_ss, long long v_sb, long long v_ss,
                                     long long o_sb, long long o_ss, int causal, int q_offset,
                                     float scale, int dtype, void* stream) {
  using namespace bobra;
  if (b <= 0 || sq <= 0 || sk <= 0 || hq <= 0 || group <= 0 || hq % group != 0 ||
      q_offset < 0 || b > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kFloat32:
      err = launch_flash<float>(q, k, v, o, b, sq, sk, hq, group, d, q_sb, q_ss, k_sb, k_ss,
                                v_sb, v_ss, o_sb, o_ss, causal, q_offset, scale, st);
      break;
    case kBFloat16:
      err = launch_flash<__nv_bfloat16>(q, k, v, o, b, sq, sk, hq, group, d, q_sb, q_ss, k_sb,
                                        k_ss, v_sb, v_ss, o_sb, o_ss, causal, q_offset, scale,
                                        st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
