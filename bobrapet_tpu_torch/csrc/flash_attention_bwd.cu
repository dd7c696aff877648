// Flash attention backward: dq, dk, dv of causal (or full) GQA attention
// from q, k, v, the output o, its gradient do and each row's log-sum-exp
// (bobra_flash_attention_lse in flash_attention.cu).
//
// Replaces: no TPU kernel. The JAX package's train step
// (bobrapet_tpu/parallel/train.py:106-125) differentiates
// bobrapet_tpu/ops/attention.py:attention through XLA; the Pallas forward
// (flash_attention, :117) has no custom VJP. This is the gradient of the
// port's forward kernel, so the training forward runs the kernel and not
// the S x S reference.
//
//   P  = exp(scale q k^T - lse)        (masked: score -1e30 as in the forward; keys past Sk 0)
//   D  = rowsum(do * o)                (fp32, one small kernel first)
//   dv = P^T do                        dk = scale dS^T q,  dS = P * (do v^T - D)
//   dq = scale dS k
//
// GQA: packed rows as in the forward's rows kernel (row r of kv head h is
// query r / group of q head h * group + r % group), so dk and dv of a kv
// head sum over its group's query heads inside one block.
//
// Bound on the card at the train step's shapes (q [8, 512, 32, 128], k/v
// [8, 512, 8, 128], bf16, causal): ~43 GFLOP (2.5x the forward's: S, dP,
// dv, dk, dq), 0.043 ms at 989 TFLOP/s, against ~168 MB of q, k, v, o, do,
// dq, dk, dv: 0.050 ms at 3.35 TB/s. So it sits near the ridge.
//
// Design: deterministic, no atomics; every output element is written by
// one block. Three launches: D; then dk/dv; then dq. fp32 takes scalar
// kernels (exact; the tensor cores would run fp32 as TF32).
//
// bf16 (sm_90a): both kernels are persistent and warp-specialised. A block
// of 384 threads has two consumer warpgroups (setmaxnreg: 232 registers a
// thread) and a producer warpgroup (40) whose first warp keeps TMA loads in
// flight through a ring of kBwdStages stages with full and empty mbarriers.
// One block an SM walks its work items in a closed order (bwd_item): the
// items come heaviest first under the causal mask and alternate direction
// each round, so the last round holds the lightest items; an item is
// computed by one block whatever the order, so the bits do not depend on it.
//
// * dk/dv: an item is 128 keys of one (batch, kv head), 64 a consumer. The
//   producer loads the item's K and V once, then rings the q and do tiles
//   (64 packed rows) of the rows that see any of its keys, with each tile
//   row's lse and D (plain loads by the producer warp's lanes: they are
//   head-major, not contiguous over packed rows). A consumer computes
//   S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory (m64n64,
//   both K-major), forms P^T and dS^T in its accumulator registers, and
//   accumulates dV += P^T dO and dK += dS^T Q with P^T and dS^T as wgmma's A
//   registers and dO, Q as MN-major B; dK and dV stay in fp32 registers
//   (m64n128 or m64n32) until the item ends.
// * dq: an item is 128 packed rows, 64 a consumer; the producer loads their
//   q and do once, then rings the K and V tiles (64 keys) up to the causal
//   diagonal of the item's last row. S = Q K^T and dP = dO V^T from shared
//   memory, dQ += dS K with dS in registers.
//
// TMA reads q and do as [B, Sq, Hq, D] through 4-D tensor maps whose box is
// (head-dim columns, the group's heads, 64 / group queries): a kv head's
// group of q heads is contiguous for each query, so the box lands in packed
// row order. A box row is 128 bytes at D = 128 (two boxes a tile, 128-byte
// swizzle) and 64 at D = 32 (one box, 64-byte swizzle). Rows past Sq or
// keys past Sk arrive as zeros and are masked as BwdShape::mask says. P and
// dS go into the products in one bf16 part or as hi + lo parts
// (bobra_flash_attention_backward_parts; see PERF.md for the measurement).
// The tiles, the work order, the products and the tensor maps are shared
// with the training forward (attention_wgmma.cuh).

#include <limits.h>
#include <math.h>

#include "attention_core.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace bobra {

constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr float kBwdNegInf = -1e30f;  // the reference's NEG_INF

// Contiguous layouts: q, o, do, dq [B, Sq, Hq, D]; k, v, dk, dv [B, Sk,
// Hkv, D]; lse, delta [B, Hq, Sq] fp32.
struct BwdShape {
  int sq, sk, hq, group, causal, q_offset;
  float scale;
  __device__ int hkv() const { return hq / group; }
  __device__ int rows() const { return sq * group; }
  // packed row r of kv head h: its q head and query
  __device__ int head(int h, int r) const { return h * group + r % group; }
  __device__ long long q_off(int b, int h, int r, int d) const {
    return ((static_cast<long long>(b) * sq + r / group) * hq + head(h, r)) * d;
  }
  __device__ long long kv_off(int b, int h, int key, int d) const {
    return ((static_cast<long long>(b) * sk + key) * hkv() + h) * d;
  }
  __device__ long long stat_off(int b, int h, int r) const {
    return (static_cast<long long>(b) * hq + head(h, r)) * sq + r / group;
  }
  // a key's score for packed row r: 0 live, 1 causally masked (-1e30), 2 no key (-inf)
  __device__ int mask(int r, int key) const {
    if (key >= sk) return 2;
    return causal && key > q_offset + r / group ? 1 : 0;
  }
};

// D = rowsum(do * o), fp32, [B, Hq, Sq]: one warp a (b, query, head) row
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int sq, int hq, int d, long long total) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kBwdWarps + static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= total) return;
  const T* orow = o + row * d;
  const T* grow = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_float(orow[c]) * to_float(grow[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const int head = static_cast<int>(row % hq);
    const long long bq = row / hq;
    delta[(bq / sq * hq + head) * sq + bq % sq] = s;
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar kernels, 128 threads, 8 query rows (dq) or 8 packed rows (dk/dv) a tile

constexpr int kScalarRows = 8;   // query rows / packed rows of one tile
constexpr int kScalarKeys = 32;  // keys of one tile: one a lane

// dq of 8 query rows of one q head: grid (ceil(sq / 8), hq, b)
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, const BwdShape S) {
  constexpr int kRowStride = kBwdThreads / D;
  constexpr int kRowsPerThread = kScalarRows / kRowStride;
  constexpr int kRowsPerWarp = kScalarRows / kBwdWarps;
  __shared__ float qs[kScalarRows][D];  // q * scale
  __shared__ float gs[kScalarRows][D];  // do
  __shared__ float ks[kScalarKeys][D + 1];
  __shared__ float vs[kScalarKeys][D + 1];
  __shared__ float dss[kScalarRows][kScalarKeys];
  __shared__ float lse_s[kScalarRows], del_s[kScalarRows];

  const int row0 = blockIdx.x * kScalarRows, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = hh / S.group;
  // the packed row of query i of this head, for the shape's helpers
  auto packed = [&](int i) { return i * S.group + hh % S.group; };
  for (int e = tid; e < kScalarRows * D; e += kBwdThreads) {
    const int r = e / D, c = e % D, qi = row0 + r;
    const bool ok = qi < S.sq;
    const long long off = ok ? S.q_off(b, h, packed(qi), D) + c : 0;
    qs[r][c] = ok ? q[off] * S.scale : 0.f;
    gs[r][c] = ok ? dout[off] : 0.f;
  }
  if (tid < kScalarRows) {
    const int qi = row0 + tid;
    const bool ok = qi < S.sq;
    lse_s[tid] = ok ? lse[S.stat_off(b, h, packed(qi))] : 0.f;
    del_s[tid] = ok ? delta[S.stat_off(b, h, packed(qi))] : 0.f;
  }
  const int row_end = min(S.sq, row0 + kScalarRows);
  const int kv_len = S.causal ? min(S.sk, S.q_offset + row_end) : S.sk;
  const int dcol = tid % D, rgroup = tid / D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kScalarKeys) {
    __syncthreads();
    for (int e = tid; e < kScalarKeys * D; e += kBwdThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      const bool ok = kj < kv_len;
      const long long off = ok ? S.kv_off(b, h, kj, D) + c : 0;
      ks[j][c] = ok ? k[off] : 0.f;
      vs[j][c] = ok ? v[off] : 0.f;
    }
    __syncthreads();
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kBwdWarps * i, qi = row0 + r;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        s = fmaf(qs[r][c], ks[lane][c], s);
        dp = fmaf(gs[r][c], vs[lane][c], dp);
      }
      const int m = qi < S.sq ? S.mask(packed(qi), kj) : 2;
      const float p = m == 2 ? 0.f : expf((m == 1 ? kBwdNegInf : s) - lse_s[r]);
      dss[r][lane] = p * (dp - del_s[r]);
    }
    __syncthreads();
    for (int j = 0; j < kScalarKeys; ++j) {
      const float kv = ks[j][dcol];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        acc[i] = fmaf(dss[rgroup + kRowStride * i][j], kv, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = row0 + rgroup + kRowStride * i;
    if (qi < S.sq) dq[S.q_off(b, h, packed(qi), D) + dcol] = acc[i] * S.scale;
  }
}

// dk and dv of 32 keys of one kv head: grid (ceil(sk / 32), hkv, b)
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, const BwdShape S) {
  constexpr int kKeyStride = kBwdThreads / D;
  constexpr int kKeysPerThread = kScalarKeys / kKeyStride;
  constexpr int kRowsPerWarp = kScalarRows / kBwdWarps;
  __shared__ float ks[kScalarKeys][D + 1];
  __shared__ float vs[kScalarKeys][D + 1];
  __shared__ float qs[kScalarRows][D];  // q * scale
  __shared__ float gs[kScalarRows][D];  // do
  __shared__ float ps[kScalarRows][kScalarKeys];
  __shared__ float dss[kScalarRows][kScalarKeys];
  __shared__ float lse_s[kScalarRows], del_s[kScalarRows];

  const int k0 = blockIdx.x * kScalarKeys, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = S.rows();
  for (int e = tid; e < kScalarKeys * D; e += kBwdThreads) {
    const int j = e / D, c = e % D, kj = k0 + j;
    const bool ok = kj < S.sk;
    const long long off = ok ? S.kv_off(b, h, kj, D) + c : 0;
    ks[j][c] = ok ? k[off] : 0.f;
    vs[j][c] = ok ? v[off] : 0.f;
  }
  const int dcol = tid % D, kgroup = tid / D;
  float acc_k[kKeysPerThread], acc_v[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) acc_k[i] = acc_v[i] = 0.f;
  // causal: queries before k0 - q_offset see none of these keys
  const int first = S.causal ? max(0, k0 - S.q_offset) * S.group : 0;
  for (int r0 = first / kScalarRows * kScalarRows; r0 < rows; r0 += kScalarRows) {
    __syncthreads();
    for (int e = tid; e < kScalarRows * D; e += kBwdThreads) {
      const int r = e / D, c = e % D, pr = r0 + r;
      const bool ok = pr < rows;
      const long long off = ok ? S.q_off(b, h, pr, D) + c : 0;
      qs[r][c] = ok ? q[off] * S.scale : 0.f;
      gs[r][c] = ok ? dout[off] : 0.f;
    }
    if (tid < kScalarRows) {
      const int pr = r0 + tid;
      const bool ok = pr < rows;
      lse_s[tid] = ok ? lse[S.stat_off(b, h, pr)] : 0.f;
      del_s[tid] = ok ? delta[S.stat_off(b, h, pr)] : 0.f;
    }
    __syncthreads();
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kBwdWarps * i, pr = r0 + r;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        s = fmaf(qs[r][c], ks[lane][c], s);
        dp = fmaf(gs[r][c], vs[lane][c], dp);
      }
      const int m = pr < rows ? S.mask(pr, kj) : 2;
      const float p = m == 2 ? 0.f : expf((m == 1 ? kBwdNegInf : s) - lse_s[r]);
      ps[r][lane] = p;
      dss[r][lane] = p * (dp - del_s[r]);
    }
    __syncthreads();
    for (int r = 0; r < kScalarRows; ++r) {
      const float gv = gs[r][dcol], qv = qs[r][dcol];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        const int j = kgroup + kKeyStride * i;
        acc_v[i] = fmaf(ps[r][j], gv, acc_v[i]);
        acc_k[i] = fmaf(dss[r][j], qv, acc_k[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int kj = k0 + kgroup + kKeyStride * i;
    if (kj < S.sk) {
      const long long off = S.kv_off(b, h, kj, D) + dcol;
      dk[off] = acc_k[i];  // q was scaled: dk = scale dS^T q
      dv[off] = acc_v[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernels

namespace attn {

constexpr int kBwdStages = 3;      // ring stages

// dk/dv: K and V of the item's keys (a tile each consumer), then the ring:
// q, do and the tile rows' stats (lse in log2 units, D), 1024-aligned
template <int D>
struct DkdvSmem {
  static constexpr int kKV = 2 * kBwdConsumers * BwdTile<D>::kBytes;
  static constexpr int kStats = 1024;
  static constexpr int kStage = 2 * BwdTile<D>::kBytes + kStats;
  static constexpr int kBars = (2 * kBwdStages + 2) * 8;
  static constexpr int kBytes = 1024 + kKV + kBwdStages * kStage + kBars;
};

// dq: q and do of the item's rows (a tile each consumer), then the ring of K and V
template <int D>
struct DqSmem {
  static constexpr int kQO = 2 * kBwdConsumers * BwdTile<D>::kBytes;
  static constexpr int kStage = 2 * BwdTile<D>::kBytes;
  static constexpr int kBars = (2 * kBwdStages + 2) * 8;
  static constexpr int kBytes = 1024 + kQO + kBwdStages * kStage + kBars;
};

struct BwdPtrs {
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
};

// sacc = A_s B_s^T and pacc = A_p B_p^T over the head dim (A 64 rows, B
// 64 or 32 rows of K-major tiles), then waited for; the first k16 step
// overwrites the accumulators, so they need no zeros
template <int D, int R>
__device__ __forceinline__ void two_score_products(float (&sacc)[R], float (&pacc)[R],
                                                   uint32_t a_s, uint32_t b_s, uint32_t a_p,
                                                   uint32_t b_p) {
  using L = BwdTile<D>;
  hopper::wgmma_fence_operands(sacc);
  hopper::wgmma_fence_operands(pacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_ss(sacc, L::kmajor(a_s, kk), L::kmajor(b_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_ss(pacc, L::kmajor(a_p, kk), L::kmajor(b_p, kk), kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_fence_operands(sacc);
  hopper::wgmma_fence_operands(pacc);
  hopper::wgmma_wait<0>();
  hopper::wgmma_fence_operands(sacc);
  hopper::wgmma_fence_operands(pacc);
}

// dk, dv of the work items this block takes: an item is 128 keys of one
// (batch, kv head), 64 a consumer warpgroup; the producer rings the q and
// do tiles of the packed rows that see any of those keys
template <int D, int PARTS>
__global__ void __launch_bounds__(kBwdWsThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const BwdPtrs A,
                      const BwdShape S, const int bh) {
  using L = BwdTile<D>;
  using M = DkdvSmem<D>;
  constexpr int kSt = kBwdStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv_s = hopper::align1024(smem_raw);  // K of each consumer, then V
  unsigned char* ring = kv_s + M::kKV;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSt * M::kStage);
  uint64_t* empty = full + kSt;
  uint64_t* kv_full = empty + kSt;
  uint64_t* kv_empty = kv_full + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = S.rows(), hkv = S.hkv();
  const int tile_rows = kBwdTile / S.group * S.group;  // whole queries
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  const int items = (S.sk + kBwdItemRows - 1) / kBwdItemRows * bh;

  if (tid == 0) {
    hopper::prefetch_tensormap(&qmap);
    hopper::prefetch_tensormap(&gmap);
    hopper::prefetch_tensormap(&kmap);
    hopper::prefetch_tensormap(&vmap);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes (stats), one with the bytes
      hopper::mbar_init(&empty[s], 4 * kBwdConsumers);
    }
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, 4 * kBwdConsumers);
    hopper::fence_barrier_init();
  }
  if (tile_rows < kBwdTile) {
    // a group that does not divide 64: rows past tile_rows are never loaded; zeros there
    for (int i = tid; i < kSt * M::kStage / 16; i += kBwdWsThreads) {
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    }
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (warp >= 4 * kBwdConsumers) {
    hopper::setmaxnreg_dec<kBwdProducerRegs>();
    if (warp == 4 * kBwdConsumers) {
      const int qt = kBwdTile / S.group;  // queries of a tile
      int it = 0;
      for (int r = 0;; ++r) {
        const int item = bwd_item(r, items);
        if (item < 0) break;
        const int k0 = item / bh * kBwdItemRows, b = item % bh / hkv, h = item % hkv;
        if (lane == 0) {
          // a consumer whose first key is past Sk loads (and computes) nothing
          const int live = min(kBwdConsumers, (S.sk - k0 + kBwdWgRows - 1) / kBwdWgRows);
          hopper::mbar_wait(kv_empty, (r & 1) ^ 1);
          hopper::mbar_expect_tx(kv_full, 2 * live * L::kBytes);
          for (int wg = 0; wg < live; ++wg) {
#pragma unroll
            for (int bx = 0; bx < L::kBoxes; ++bx) {
              const int off = wg * L::kBytes + bx * L::kBox;
              hopper::tma_load_4d(kv_s + off, &kmap, bx * L::kCols, h, k0 + wg * kBwdWgRows, b,
                                  kv_full);
              hopper::tma_load_4d(kv_s + kBwdConsumers * L::kBytes + off, &vmap, bx * L::kCols,
                                  h, k0 + wg * kBwdWgRows, b, kv_full);
            }
          }
        }
        const int first = S.causal ? max(0, k0 - S.q_offset) * S.group : 0;
        for (int t = first / tile_rows; t < n_tiles; ++t, ++it) {
          const int s = it % kSt;
          hopper::mbar_wait(&empty[s], ((it / kSt) & 1) ^ 1);
          unsigned char* st = ring + s * M::kStage;
          float* stats = reinterpret_cast<float*>(st + 2 * L::kBytes);
          for (int c = lane; c < kBwdTile; c += 32) {
            const int pr = t * tile_rows + c;
            const bool ok = c < tile_rows && pr < rows;
            const long long off = S.stat_off(b, h, ok ? pr : 0);
            stats[c] = ok ? A.lse[off] * kLog2e : 0.f;
            stats[kBwdTile + c] = ok ? A.delta[off] : 0.f;
          }
          if (lane == 0) {
            hopper::mbar_expect_tx(&full[s], 2 * L::kBoxes * tile_rows * L::kRowBytes);
#pragma unroll
            for (int bx = 0; bx < L::kBoxes; ++bx) {
              hopper::tma_load_4d(st + bx * L::kBox, &qmap, bx * L::kCols, h * S.group, t * qt, b,
                                  &full[s]);
              hopper::tma_load_4d(st + L::kBytes + bx * L::kBox, &gmap, bx * L::kCols,
                                  h * S.group, t * qt, b, &full[s]);
            }
          } else {
            hopper::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kBwdConsumerRegs>();
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, qd = lane & 3;
    const float scale_log2 = S.scale * kLog2e;
    const uint32_t k_tile = hopper::smem_addr(kv_s + wg * L::kBytes);
    const uint32_t v_tile = k_tile + kBwdConsumers * L::kBytes;
    float dk[D / 2], dv[D / 2];
    int it = 0;
    for (int r = 0;; ++r) {
      const int item = bwd_item(r, items);
      if (item < 0) break;
      const int k0 = item / bh * kBwdItemRows, b = item % bh / hkv, h = item % hkv;
      const int kw = k0 + wg * kBwdWgRows;  // this warpgroup's first key
      // this thread's keys (accumulator rows): live ones, and the packed
      // rows below `lim` that the causal mask hides from them
      bool key_ok[2];
      int lim[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = kw + 16 * w4 + g + 8 * hh;
        key_ok[hh] = key < S.sk;
        lim[hh] = S.causal ? (key - S.q_offset) * S.group : INT_MIN;
      }
      const int w_first = S.causal ? max(0, kw - S.q_offset) * S.group : 0;
      zero_acc(dk);
      zero_acc(dv);
      hopper::mbar_wait(kv_full, r & 1);
      const int first = S.causal ? max(0, k0 - S.q_offset) * S.group : 0;
      for (int t = first / tile_rows; t < n_tiles; ++t, ++it) {
        const int s = it % kSt;
        hopper::mbar_wait(&full[s], (it / kSt) & 1);
        const int r0 = t * tile_rows;
        if (kw < S.sk && r0 + tile_rows > w_first) {
          const unsigned char* st = ring + s * M::kStage;
          const uint32_t q_tile = hopper::smem_addr(st), g_tile = q_tile + L::kBytes;
          const float* stats = reinterpret_cast<const float*>(st + 2 * L::kBytes);
          // the tile in two halves of 32 rows: P^T and dS^T of a half (in
          // two bf16 parts) fit the registers beside dK and dV
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int h0 = 32 * half;  // the half's first tile row
            // a half with no row, or none that sees this warpgroup's keys
            if (h0 >= tile_rows || r0 + h0 >= rows || r0 + h0 + 32 <= w_first) continue;
            // S^T = K Q^T, dP^T = V dO^T: keys on the rows, the half's packed rows on the columns
            float sacc[16], pacc[16];
            two_score_products<D>(sacc, pacc, k_tile, q_tile + h0 * L::kRowBytes, v_tile,
                                  g_tile + h0 * L::kRowBytes);
            // P^T = exp(S^T scale - lse) masked as the forward; dS^T = P^T (dP^T - D)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = h0 + 8 * j + 2 * qd;
              const float2 l2 = *reinterpret_cast<const float2*>(stats + c);
              const float2 dd = *reinterpret_cast<const float2*>(stats + kBwdTile + c);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int hh = e >> 1, x = e & 1, cc = c + x, pr = r0 + cc;
                const bool live = key_ok[hh] && cc < tile_rows && pr < rows;
                const float raw = pr < lim[hh] ? kMasked : sacc[4 * j + e] * scale_log2;
                const float p = exp2_approx(live ? raw - (x ? l2.y : l2.x) : -INFINITY);
                sacc[4 * j + e] = p;
                pacc[4 * j + e] = p * (pacc[4 * j + e] - (x ? dd.y : dd.x));
              }
            }
            uint32_t pa[PARTS][2][4], da[PARTS][2][4];
            a_fragments<PARTS>(sacc, pa);
            a_fragments<PARTS>(pacc, da);
            hopper::wgmma_fence_operands(dk);
            hopper::wgmma_fence_operands(dv);
            hopper::wgmma_fence();  // the A registers before the products read them
            accumulate_rs<D, PARTS>(dv, pa, g_tile, 2 * half);  // dv += P^T do
            accumulate_rs<D, PARTS>(dk, da, q_tile, 2 * half);  // dk += dS^T q (scaled below)
            hopper::wgmma_commit();
            hopper::wgmma_fence_operands(dk);
            hopper::wgmma_fence_operands(dv);
            hopper::wgmma_wait<0>();
            hopper::wgmma_fence_operands(dk);
            hopper::wgmma_fence_operands(dv);
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(kv_empty);  // K and V read for this item
      // acc[4j + 2hh + x]: key kw + 16 w4 + g + 8 hh, column 8j + 2 qd + x
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = kw + 16 * w4 + g + 8 * hh;
        if (key >= S.sk) continue;
        bf16* dkr = A.dk + S.kv_off(b, h, key, D);
        bf16* dvr = A.dv + S.kv_off(b, h, key, D);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int c = 8 * j + 2 * qd, e = 4 * j + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(dkr + c) =
              __floats2bfloat162_rn(dk[e] * S.scale, dk[e + 1] * S.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvr + c) = __floats2bfloat162_rn(dv[e], dv[e + 1]);
        }
      }
    }
  }
}

// dq of the work items this block takes: an item is 128 packed rows of one
// (batch, kv head), 64 a consumer warpgroup; the producer rings the K and V
// tiles up to the causal diagonal of the item's last row
template <int D, int PARTS>
__global__ void __launch_bounds__(kBwdWsThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const BwdPtrs A, const BwdShape S,
                    const int bh) {
  using L = BwdTile<D>;
  using M = DqSmem<D>;
  constexpr int kSt = kBwdStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qo_s = hopper::align1024(smem_raw);  // q of each consumer, then do
  unsigned char* ring = qo_s + M::kQO;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSt * M::kStage);
  uint64_t* empty = full + kSt;
  uint64_t* qo_full = empty + kSt;
  uint64_t* qo_empty = qo_full + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = S.rows(), hkv = S.hkv();
  const int tile_rows = kBwdTile / S.group * S.group;
  const int item_rows = kBwdConsumers * tile_rows;
  const int n_rt = (rows + item_rows - 1) / item_rows;
  const int items = n_rt * bh;
  // the keys an item's rows see: up to the diagonal of its last row
  auto kv_len = [&](int row0) {
    const int last = min(rows, row0 + item_rows) - 1;
    return S.causal ? min(S.sk, S.q_offset + last / S.group + 1) : S.sk;
  };

  if (tid == 0) {
    hopper::prefetch_tensormap(&qmap);
    hopper::prefetch_tensormap(&gmap);
    hopper::prefetch_tensormap(&kmap);
    hopper::prefetch_tensormap(&vmap);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kBwdConsumers);
    }
    hopper::mbar_init(qo_full, 1);
    hopper::mbar_init(qo_empty, 4 * kBwdConsumers);
    hopper::fence_barrier_init();
  }
  if (tile_rows < kBwdTile) {
    for (int i = tid; i < M::kQO / 16; i += kBwdWsThreads) {
      reinterpret_cast<uint4*>(qo_s)[i] = make_uint4(0, 0, 0, 0);
    }
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (warp >= 4 * kBwdConsumers) {
    hopper::setmaxnreg_dec<kBwdProducerRegs>();
    if (warp == 4 * kBwdConsumers && lane == 0) {
      const int qt = kBwdTile / S.group;
      int it = 0;
      for (int r = 0;; ++r) {
        const int item = bwd_item(r, items);
        if (item < 0) break;
        const int row0 = (n_rt - 1 - item / bh) * item_rows, b = item % bh / hkv, h = item % hkv;
        // a consumer whose first row is past the last loads (and computes) nothing
        const int live = min(kBwdConsumers, (rows - row0 + tile_rows - 1) / tile_rows);
        hopper::mbar_wait(qo_empty, (r & 1) ^ 1);
        hopper::mbar_expect_tx(qo_full, 2 * live * L::kBoxes * tile_rows * L::kRowBytes);
        for (int wg = 0; wg < live; ++wg) {
#pragma unroll
          for (int bx = 0; bx < L::kBoxes; ++bx) {
            const int off = wg * L::kBytes + bx * L::kBox;
            const int q0 = row0 / S.group + wg * qt;
            hopper::tma_load_4d(qo_s + off, &qmap, bx * L::kCols, h * S.group, q0, b, qo_full);
            hopper::tma_load_4d(qo_s + kBwdConsumers * L::kBytes + off, &gmap, bx * L::kCols,
                                h * S.group, q0, b, qo_full);
          }
        }
        const int n_kt = (kv_len(row0) + kBwdTile - 1) / kBwdTile;
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int s = it % kSt;
          hopper::mbar_wait(&empty[s], ((it / kSt) & 1) ^ 1);
          unsigned char* st = ring + s * M::kStage;
          hopper::mbar_expect_tx(&full[s], M::kStage);
#pragma unroll
          for (int bx = 0; bx < L::kBoxes; ++bx) {
            hopper::tma_load_4d(st + bx * L::kBox, &kmap, bx * L::kCols, h, j * kBwdTile, b,
                                &full[s]);
            hopper::tma_load_4d(st + L::kBytes + bx * L::kBox, &vmap, bx * L::kCols, h,
                                j * kBwdTile, b, &full[s]);
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kBwdConsumerRegs>();
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, qd = lane & 3;
    const float scale_log2 = S.scale * kLog2e;
    const uint32_t q_tile = hopper::smem_addr(qo_s + wg * L::kBytes);
    const uint32_t g_tile = q_tile + kBwdConsumers * L::kBytes;
    float dq[D / 2];
    int it = 0;
    for (int r = 0;; ++r) {
      const int item = bwd_item(r, items);
      if (item < 0) break;
      const int row0 = (n_rt - 1 - item / bh) * item_rows, b = item % bh / hkv, h = item % hkv;
      const int wrow0 = row0 + wg * tile_rows;  // this warpgroup's first packed row
      const int len = kv_len(row0);
      // this thread's rows (accumulator rows): live ones, their log-sum-exp
      // (log2 units), D, and the last key the causal mask lets them see
      bool row_ok[2];
      float lse_r[2], del_r[2];
      int lim[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lr = 16 * w4 + g + 8 * hh, pr = wrow0 + lr;
        row_ok[hh] = lr < tile_rows && pr < rows;
        const long long off = row_ok[hh] ? S.stat_off(b, h, pr) : 0;
        lse_r[hh] = row_ok[hh] ? A.lse[off] * kLog2e : 0.f;
        del_r[hh] = row_ok[hh] ? A.delta[off] : 0.f;
        lim[hh] = S.causal ? S.q_offset + pr / S.group : INT_MAX;
      }
      const int wlast = min(rows - 1, wrow0 + tile_rows - 1);
      const int w_end = wrow0 >= rows ? 0
                        : S.causal ? min(len, S.q_offset + wlast / S.group + 1) : len;
      zero_acc(dq);
      hopper::mbar_wait(qo_full, r & 1);
      const int n_kt = (len + kBwdTile - 1) / kBwdTile;
      for (int j = 0; j < n_kt; ++j, ++it) {
        const int s = it % kSt;
        hopper::mbar_wait(&full[s], (it / kSt) & 1);
        const int key0 = j * kBwdTile;
        if (key0 < w_end) {
          const uint32_t k_tile = hopper::smem_addr(ring + s * M::kStage);
          const uint32_t v_tile = k_tile + L::kBytes;
          // S = Q K^T, dP = dO V^T
          float sacc[32], pacc[32];
          two_score_products<D>(sacc, pacc, q_tile, k_tile, g_tile, v_tile);
          // dS = P (dP - D), P = exp(S scale - lse) masked as the forward
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1, key = key0 + 8 * jj + 2 * qd + (e & 1);
              const bool live = row_ok[hh] && key < S.sk;
              const float raw = key > lim[hh] ? kMasked : sacc[4 * jj + e] * scale_log2;
              const float p = exp2_approx(live ? raw - lse_r[hh] : -INFINITY);
              pacc[4 * jj + e] = p * (pacc[4 * jj + e] - del_r[hh]);
            }
          }
          uint32_t da[PARTS][4][4];
          a_fragments<PARTS>(pacc, da);
          hopper::wgmma_fence_operands(dq);
          hopper::wgmma_fence();
          accumulate_rs<D, PARTS>(dq, da, k_tile, 0);  // dq += dS k (scaled below)
          hopper::wgmma_commit();
          hopper::wgmma_fence_operands(dq);
          hopper::wgmma_wait<0>();
          hopper::wgmma_fence_operands(dq);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(qo_empty);  // q and do read for this item
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!row_ok[hh]) continue;
        bf16* dqr = A.dq + S.q_off(b, h, wrow0 + 16 * w4 + g + 8 * hh, D);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int c = 8 * j + 2 * qd, e = 4 * j + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(dqr + c) =
              __floats2bfloat162_rn(dq[e] * S.scale, dq[e + 1] * S.scale);
        }
      }
    }
  }
}

// the form of P and dS in the bf16 products (1: one bf16 part; 2: hi + lo)
static int bwd_parts = 2;
// which of the bf16 launches run (bit 0: D, 1: dk/dv, 2: dq): all, unless
// a measurement times one alone
static int bwd_launches = 7;

template <int D, int PARTS>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const BwdPtrs& A, const BwdShape& S, int b, cudaStream_t st) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, PARTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DkdvSmem<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, PARTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int sms = hopper::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // q and do as [B, Sq, Hq, D], k and v as [B, Sk, Hkv, D], contiguous
  const int hkv = S.hq / S.group, qt = kBwdTile / S.group;
  const long long q_ss = static_cast<long long>(S.hq) * D;
  const long long kv_ss = static_cast<long long>(hkv) * D;
  CUtensorMap qmap, gmap, kmap, vmap;
  if ((err = encode_q_map<D>(&qmap, q, b, S.sq, S.hq, S.group, q_ss, q_ss * S.sq)) !=
          cudaSuccess ||
      (err = encode_q_map<D>(&gmap, dout, b, S.sq, S.hq, S.group, q_ss, q_ss * S.sq)) !=
          cudaSuccess ||
      (err = encode_kv_map<D>(&kmap, k, b, S.sk, hkv, kv_ss, kv_ss * S.sk)) != cudaSuccess ||
      (err = encode_kv_map<D>(&vmap, v, b, S.sk, hkv, kv_ss, kv_ss * S.sk)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int bh = b * hkv;
  const int kv_items = (S.sk + kBwdItemRows - 1) / kBwdItemRows * bh;
  const int item_rows = kBwdConsumers * qt * S.group;
  const int q_items = (S.sq * S.group + item_rows - 1) / item_rows * bh;
  const int kv_grid = min(kv_items, sms), q_grid = min(q_items, sms);
  if (bwd_launches & 2) {
    flash_bwd_dkdv_kernel<D, PARTS><<<kv_grid, kBwdWsThreads, DkdvSmem<D>::kBytes, st>>>(
        qmap, gmap, kmap, vmap, A, S, bh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bwd_launches & 4) {
    flash_bwd_dq_kernel<D, PARTS><<<q_grid, kBwdWsThreads, DqSmem<D>::kBytes, st>>>(
        qmap, gmap, kmap, vmap, A, S, bh);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const BwdPtrs& A, const BwdShape& S, int b, cudaStream_t st) {
  return bwd_parts == 1 ? launch_bwd_bf16<D, 1>(q, k, v, dout, A, S, b, st)
                        : launch_bwd_bf16<D, 2>(q, k, v, dout, A, S, b, st);
}

}  // namespace attn

template <int D>
int launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* dq, float* dk, float* dv,
                   const BwdShape& S, int b, int hkv, cudaStream_t st) {
  const dim3 kv_grid((S.sk + kScalarKeys - 1) / kScalarKeys, hkv, b);
  attn_bwd_dkdv_f32<D><<<kv_grid, kBwdThreads, 0, st>>>(q, k, v, dout, lse, delta, dk, dv, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((S.sq + kScalarRows - 1) / kScalarRows, S.hq, b);
  attn_bwd_dq_f32<D><<<q_grid, kBwdThreads, 0, st>>>(q, k, v, dout, lse, delta, dq, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bobra

// The gradient of bobra_flash_attention_lse's output. q, o, dout, dq
// [b, sq, hq, d]; k, v, dk, dv [b, sk, hq / group, d], all contiguous and of
// one type; lse [b, hq, sq] fp32 from the forward; delta: fp32 scratch
// [b, hq, sq]. bf16 pointers 16-byte aligned and a group of at most 64
// heads. Three launches on `stream`
// (D, then dk/dv, then dq); no output element is written twice and none is
// accumulated with atomics. Returns the cudaError_t of the launches.
extern "C" int bobra_flash_attention_backward(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const void* lse,
                                              void* delta, void* dq, void* dk, void* dv, int b,
                                              int sq, int sk, int hq, int group, int d,
                                              int causal, int q_offset, float scale, int dtype,
                                              void* stream) {
  using namespace bobra;
  if (b <= 0 || sq <= 0 || sk <= 0 || hq <= 0 || group <= 0 || hq % group != 0 ||
      q_offset < 0 || b > 65535 || hq > 65535 || static_cast<long long>(sq) * group > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d != 32 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  BwdShape S;
  S.sq = sq;
  S.sk = sk;
  S.hq = hq;
  S.group = group;
  S.causal = causal;
  S.q_offset = q_offset;
  S.scale = scale;
  const int hkv = hq / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(b) * sq * hq;
  const unsigned delta_blocks = static_cast<unsigned>((total + kBwdWarps - 1) / kBwdWarps);
  float* del = static_cast<float*>(delta);
  if (dtype == kFloat32) {
    attn_bwd_delta_kernel<float><<<delta_blocks, kBwdThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), del, sq, hq, d, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* gf = static_cast<const float*>(dout);
    const float* lf = static_cast<const float*>(lse);
    float* dqf = static_cast<float*>(dq);
    float* dkf = static_cast<float*>(dk);
    float* dvf = static_cast<float*>(dv);
    return d == 32 ? launch_bwd_f32<32>(qf, kf, vf, gf, lf, del, dqf, dkf, dvf, S, b, hkv, st)
                   : launch_bwd_f32<128>(qf, kf, vf, gf, lf, del, dqf, dkf, dvf, S, b, hkv, st);
  }
  if (dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  // a ring tile holds whole queries: at most 64 heads a group
  if (ptrs % 16 != 0 || group > attn::kBwdTile) return static_cast<int>(cudaErrorInvalidValue);
  if (attn::bwd_launches & 1) {
    attn_bwd_delta_kernel<__nv_bfloat16><<<delta_blocks, kBwdThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), del, sq,
        hq, d, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attn::BwdPtrs A;
  A.lse = static_cast<const float*>(lse);
  A.delta = del;
  A.dq = static_cast<attn::bf16*>(dq);
  A.dk = static_cast<attn::bf16*>(dk);
  A.dv = static_cast<attn::bf16*>(dv);
  return d == 32 ? attn::launch_bwd_bf16<32>(q, k, v, dout, A, S, b, st)
                 : attn::launch_bwd_bf16<128>(q, k, v, dout, A, S, b, st);
}

// Two measurement switches for chip_smoke.py; each returns the setting in
// force. The form of P and dS in the bf16 products: 1 rounds each to one
// bf16 part, 2 feeds them as hi + lo parts (set when `parts` is 1 or 2).
extern "C" int bobra_flash_attention_backward_parts(int parts) {
  if (parts == 1 || parts == 2) bobra::attn::bwd_parts = parts;
  return bobra::attn::bwd_parts;
}

// Which of the bf16 launches run: bit 0 D, bit 1 dk/dv, bit 2 dq (set
// when `mask` is 1-7), so that each can be timed alone. The outputs are
// the gradients only with all three.
extern "C" int bobra_flash_attention_backward_launches(int mask) {
  if (mask >= 1 && mask <= 7) bobra::attn::bwd_launches = mask;
  return bobra::attn::bwd_launches;
}
