// Flash attention (online softmax), causal or not, with GQA and a q offset.
//
// Replaces: bobrapet_tpu/ops/attention.py:flash_attention (_flash_kernel).
// Beyond the Pallas kernel it takes a q_offset (query i sits at position
// q_offset + i, as attention_reference defines it) and ragged Sq / Sk, so
// the same entry point carries the model's prefill, the engine's bucketed
// prefill and every greedy decode step (models/llama.py:_cached_attention
// slices the cache to its valid length and calls it with
// q_offset = valid_len - Sq).
//
// Bound on the card: bytes at the model's shapes. Prefill (q [8,128,32,128],
// k/v [8,128,8,128], bf16) moves 21.0 MB against 1.08 GFLOP of causal
// work: 6.3 us at 3.35 TB/s against 1.1 us at 989 TFLOP/s. A decode step
// (q [8,1,32,128] over k/v [8,160,8,128]) moves 5.4 MB: 1.6 us.
//
// Three kernels, chosen by the caller (ops/attention.py:flash_route):
//
// * bf16, rows = Sq * group > 16: the rows kernel. Packed GQA rows: row r
//   of kv head h is (query r / group, q head h * group + r % group), and a
//   group's heads are adjacent, so one K/V tile in shared memory serves
//   the whole group (K/V leave device memory once per 64 packed rows, not
//   once per q head). A block of 4 warps holds 64 packed rows, 16 per
//   warp; grid (ceil(rows / 64), Hkv, B), the row blocks with the most
//   keys first. The q tile and K/V tiles of 32 keys stay bf16 in shared
//   memory (XOR-swizzled, read by ldmatrix), K/V in a three-stage
//   cp.async ring, two tiles loading while one is in use; 64 KB a block
//   at D = 128, so three blocks share an SM and hide each other's
//   latency. S = Q K^T and P V run on the tensor cores with the next
//   fragments loaded ahead of each product (attention_core.cuh). Masks
//   only on a warp's edge tiles: keys past Sk get -inf, causally masked
//   keys -1e30 as in the reference; a warp skips the tiles past its
//   causal bound, and the block loads no tile past its last row's. The
//   output goes through shared memory, so device memory sees whole
//   16-byte chunks.
// * bf16, rows <= 16 (a decode step): attention_core.cuh's decode core
//   with the dense policy. The rows fill one m16 tile, the keys are split
//   across a cluster of C blocks (C from Sk, on the host) and combined
//   through distributed shared memory: one launch, deterministic.
// * fp32: the scalar kernel below, exact in fp32 (the tensor cores would
//   run fp32 as TF32, outside the 2e-4 tolerance): one block of 128
//   threads per (16 query rows, q head, batch); k/v tiles of 32 keys
//   staged in shared memory as fp32 with a padded K tile; scores by lane
//   (one key each), row max and sum by warp shuffles; scalar FMAs.
//
// Every route takes free batch and sequence strides, so a sliced cache
// goes in without a copy; the bf16 routes need 16-byte aligned rows
// (pointers 16-byte aligned, strides multiples of 8 elements).
//
// A second entry point, bobra_cached_attention, reads each batch row's
// valid length from an int32 array on the device instead of taking Sk and
// q_offset from the host: the mask of the JAX model's _cached_attention
// over the whole cache (models/llama.py), keys at or past lens[b] at
// probability 0, query i at lens[b] - Sq + i. Nothing of the launch then
// changes from one greedy step to the next, so a CUDA graph replays it.
// bf16 takes the decode core with the cached policy (the split from the
// cache's capacity, never from a length), at any Sq x group: above 16
// packed rows (the standalone speculative verify, Sq = k + 1) the rows go
// in tiles of 16 on the grid. fp32 takes the scalar kernel reading the
// same array. Its bound is the decode's: the valid K/V rows, once.
//
// A third entry point, bobra_flash_attention_lse, is the train step's forward:
// the output and each row's log-sum-exp, which the backward
// (flash_attention_bwd.cu) reads. fp32 takes the scalar kernel. bf16 takes
// flash_fwd_lse_kernel, built for sm_90a like the backward's dq kernel and
// sharing its pieces (attention_wgmma.cuh): persistent blocks, one an SM, of
// two consumer warpgroups (64 packed rows each, 232 registers a thread after
// setmaxnreg) and a producer warpgroup whose first warp loads by TMA. An item
// is 128 packed rows of one (batch, kv head); items come heaviest first under
// the causal mask, in alternating rounds (the dq kernel's order, mirrored by
// ops/attention.py:bwd_dq_items, bwd_block_items), and each output element and
// lse entry is written by one block: no atomics, the same bits whatever the
// order. The producer loads an item's q once (two q buffers, so the next
// item's q lands while this one finishes) and rings K and V tiles of 64 keys
// through full and empty mbarriers up to the causal diagonal of the item's
// last row. A consumer computes S = Q K^T by wgmma from shared memory
// (m64n64), the online softmax in registers (exp2, masks only on edge tiles),
// and O += P V with P in registers as hi + lo bf16 parts (one part breaks the
// bf16 tolerance, as in the rows kernel) and V as an MN-major B (m64n128, or
// m64n32 at D = 32), the next tile's scores issued with this tile's P V so
// that the softmax runs while the tensor cores work (4% faster than each step
// in turn; the two consumers also taking turns gained nothing: PERF.md). The
// output goes out through the warp's rows of the q tile in whole 16-byte
// chunks. At the train step's shapes (q [8,512,32,128], k/v [8,512,8,128],
// causal) it moves 84.4 MB, 0.0252 ms at 3.35 TB/s, against 17.2 GFLOP of
// causal products (25.8 with P in two parts), 0.017 ms at 989 TFLOP/s: bytes
// bound it, at the ridge.

#include <limits.h>
#include <math.h>

#include "attention_core.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace bobra {

constexpr int kBlockM = 16;   // query rows per block
constexpr int kBlockN = 32;   // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

template <typename T, int D, bool kLse = false>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int sq, int sk, int group,
                       long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                       int causal, int q_offset, float scale, const int* __restrict__ lens,
                       float* __restrict__ lse = nullptr) {
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
  // device lengths (causal): the queries sit at the last sq valid rows
  if (lens != nullptr) q_offset = lens[b] - sq;

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
    for (int i = 0; i < kRowsPerWarp; ++i) {
      l_s[warp + kWarps * i] = l[i];
      // the row's log-sum-exp of the scaled scores [B, Hq, Sq]
      const int qi = row0 + warp + kWarps * i;
      if constexpr (kLse) {
        if (qi < sq) lse[(static_cast<long long>(b) * gridDim.y + hq) * sq + qi] = m[i] + logf(l[i]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rgroup + kRowStride * i, qi = row0 + r;
    if (qi < sq) ob[qi * o_ss + dcol] = from_float<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

int launch_flash_f32(const float* q, const float* k, const float* v, float* o, int b, int sq,
                     int sk, int hq, int group, int d, long long q_sb, long long q_ss,
                     long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                     long long o_sb, long long o_ss, int causal, int q_offset, float scale,
                     const int* lens, cudaStream_t st, float* lse = nullptr) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, hq, b);
#define BOBRA_FLASH(DD)                                                                       \
  if (lse != nullptr) {                                                                       \
    flash_attention_kernel<float, DD, true><<<grid, kThreads, 0, st>>>(                       \
        q, k, v, o, sq, sk, group, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,     \
        q_offset, scale, lens, lse);                                                          \
  } else {                                                                                    \
    flash_attention_kernel<float, DD><<<grid, kThreads, 0, st>>>(q, k, v, o, sq, sk, group,    \
                                                                q_sb, q_ss, k_sb, k_ss, v_sb,   \
                                                                v_ss, o_sb, o_ss, causal,       \
                                                                q_offset, scale, lens);         \
  }
  switch (d) {
    case 32: BOBRA_FLASH(32); break;   // llama_tiny
    case 128: BOBRA_FLASH(128); break;  // llama3_1b, llama3_8b
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BOBRA_FLASH
  return 0;
}

namespace attn {

constexpr int kRowBlock = 64;  // packed rows per block of the rows kernel (16 per warp)
constexpr int kRowKeys = 32;   // keys per tile of the rows kernel
constexpr int kStages = 3;     // tiles of its cp.async ring: two in flight, one in use
// blocks of the rows kernel an SM holds: 64 KB of shared memory and at
// most 168 registers a thread each (four would spill)
constexpr int kRowMinBlocks = 3;

template <int D>
__host__ __device__ constexpr int rows_smem_bytes() {
  return tile_bytes<D>(kRowBlock) + kStages * 2 * tile_bytes<D>(kRowKeys);
}

// bf16, 64 packed rows of one (kv head, batch) per block: see the note at
// the top of this file. Small blocks (64 KB of shared memory at D = 128, q
// fragments read per k-step) so that several fit an SM and one block's
// loads overlap another's math; the row blocks with the most keys start
// first. A three-stage ring needs one block barrier per tile.
template <int D>
__global__ void __launch_bounds__(kThreads, kRowMinBlocks)
flash_rows_kernel(const DensePolicy<D> P) {
  constexpr int kChunks = D / 8;
  constexpr int kTile = tile_bytes<D>(kRowKeys);
  constexpr int kNT = kRowKeys / 8;  // score n-tiles of a warp: the whole key tile
  constexpr int kNO = D / 8;         // accumulator n-tiles

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* ring = smem + tile_bytes<D>(kRowBlock);

  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRowBlock, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = P.rows();
  const int last_row = min(rows, row0 + kRowBlock) - 1;
  // keys that any row of the block sees unmasked
  const int kv_len = P.causal ? min(P.sk, P.q_offset + last_row / P.group + 1) : P.sk;
  const int n_tiles = (kv_len + kRowKeys - 1) / kRowKeys;

  for (int e = tid; e < kRowBlock * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < rows;
    cp_async16(smem_u32(q_s) + tile_offset<D>(r, c), (ok ? P.q_row(b, h, row0 + r) : P.q) + c * 8,
               ok);
  }
  // keys past kv_len are zeros (every row masks them); one commit per call
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = ring + (t % kStages) * 2 * kTile;
      const int key0 = t * kRowKeys;
      for (int e = tid; e < kRowKeys * kChunks; e += kThreads) {
        const int j = e / kChunks, c = e % kChunks, key = key0 + j;
        const bool ok = key < kv_len;
        const bf16* kr = P.q;
        const bf16* vr = P.q;
        if (ok) P.kv_rows(b, h, key, nullptr, 0, kr, vr);
        const uint32_t off = tile_offset<D>(j, c);
        cp_async16(smem_u32(st) + off, kr + c * 8, ok);
        cp_async16(smem_u32(st + kTile) + off, vr + c * 8, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_tile(t);

  // this warp's 16 rows
  const int wrow0 = row0 + warp * 16;
  const bool has_rows = wrow0 < rows;
  const int wlast = min(rows - 1, wrow0 + 15);
  const int w_kv_end = P.causal ? min(kv_len, P.q_offset + wlast / P.group + 1) : kv_len;
  const int w_first_limit = P.key_limit(b, wrow0);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int limit[2] = {P.key_limit(b, wrow0 + g), P.key_limit(b, wrow0 + g + 8)};

  float o[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    // tile t (and, with tile 0, q) is in shared memory, and every warp is
    // done with tile t - 1, whose stage the next load takes
    __syncthreads();
    load_tile(t + kStages - 1);
    const unsigned char* st = ring + (t % kStages) * 2 * kTile;
    const int key0 = t * kRowKeys;
    if (has_rows && key0 < w_kv_end) {
      float s[kNT][4];
      scores<D, kNT>(s, smem_u32(q_s), warp * 16, smem_u32(st), 0, lane);
      // masks only where a key may be past Sk or past a row's causal bound
      const bool edge = key0 + kRowKeys > P.sk || key0 + kRowKeys - 1 > w_first_limit;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * P.scale_log2;
          if (edge) {
            const int key = key0 + 8 * j + t2 + (e & 1);
            if (key >= P.sk) {
              x = -INFINITY;
            } else if (key > limit[e >> 1]) {
              x = kMasked;
            }
          }
          s[j][e] = x;
        }
      }
      online_softmax(s, m, l, o);
      accumulate_pv<D, kNT>(o, s, smem_u32(st + kTile), 0, lane);
    }
  }
  cp_async_wait<0>();
  quad_sum(l);

  // the output tile goes through q's shared memory, so that device memory
  // sees whole 16-byte chunks of each packed row
  __syncthreads();  // every warp is done reading q
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(q_s + tile_offset<D>(r, j) + (lane & 3) * 4) =
          __floats2bfloat162_rn(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
    }
  }
  __syncthreads();
  for (int e = tid; e < kRowBlock * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    if (row0 + r < rows) {
      *reinterpret_cast<uint4*>(P.o_row(b, h, row0 + r) + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + tile_offset<D>(r, c));
    }
  }
}

template <int D>
int launch_rows(const DensePolicy<D>& P, int hkv, int batch, cudaStream_t st) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_rows_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               rows_smem_bytes<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const dim3 grid((P.sq * P.group + kRowBlock - 1) / kRowBlock, hkv, batch);
  flash_rows_kernel<D><<<grid, kThreads, rows_smem_bytes<D>(), st>>>(P);
  return 0;
}

template <int D>
int launch_flash_bf16(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                      int hkv, int group, long long q_sb, long long q_ss, long long k_sb,
                      long long k_ss, long long v_sb, long long v_ss, long long o_sb,
                      long long o_ss, int causal, int q_offset, float scale, int splits,
                      cudaStream_t st) {
  DensePolicy<D> P;
  P.q = static_cast<const bf16*>(q);
  P.k = static_cast<const bf16*>(k);
  P.v = static_cast<const bf16*>(v);
  P.o = static_cast<bf16*>(o);
  P.sq = sq;
  P.sk = sk;
  P.group = group;
  P.causal = causal;
  P.q_offset = q_offset;
  P.q_sb = q_sb;
  P.q_ss = q_ss;
  P.k_sb = k_sb;
  P.k_ss = k_ss;
  P.v_sb = v_sb;
  P.v_ss = v_ss;
  P.o_sb = o_sb;
  P.o_ss = o_ss;
  P.scale_log2 = scale * kLog2e;
  if (splits == 0) return launch_rows<D>(P, hkv, b, st);
  if (static_cast<long long>(sq) * group > kDecodeRows || splits < 1 || splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_decode(P, sq * group, splits, split_chunk(sk, splits), hkv, b, 0, st);
}

// ---------------------------------------------------------------------------
// bf16 training forward: persistent, warp-specialised, TMA and wgmma

constexpr int kFwdStages = 3;  // K/V ring stages

// the output and log-sum-exp of the training forward, and its shape
struct FwdArgs {
  bf16* o;
  float* lse;  // [B, Hq, Sq] fp32
  long long o_sb, o_ss;
  int sq, sk, hq, group, causal, q_offset;
  float scale_log2;  // 1/sqrt(D) * log2(e)
};

// two items' q (a tile each consumer; item r takes buffer r % 2), then the
// ring of K and V tiles, then the barriers; 1024-aligned
template <int D>
struct FwdSmem {
  static constexpr int kQ = kBwdConsumers * BwdTile<D>::kBytes;
  static constexpr int kStage = 2 * BwdTile<D>::kBytes;
  static constexpr int kBars = (2 * kFwdStages + 4) * 8;
  static constexpr int kBytes = 1024 + 2 * kQ + kFwdStages * kStage + kBars;
};

// One 64 x 64 score tile of this thread's rows (s[4j + 2hh + x]: row
// 16 w4 + g + 8 hh of the warpgroup, key key0 + 8j + 2qd + x) into
// probabilities: scaled into log2 units, masked on an edge tile (keys past
// Sk -inf, keys past a row's causal bound kMasked), the row max m updated
// across the quad, s turned into exp2(s - m). Returns each row's alpha =
// exp2(m_old - m) and adds this thread's share of the tile's row sums,
// rescaled, into l. A row's first tile holds key 0, which every row sees,
// so m is finite after it.
__device__ __forceinline__ void fwd_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], bool edge, int key0, int qd,
                                            const int (&lim)[2], int sk, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * qd + (e & 1);
        s[4 * j + e] = key >= sk ? -INFINITY : key > lim[e >> 1] ? kMasked : s[4 * j + e];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = m[hh];
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[hh] = exp2_approx(m[hh] - mx);
    m[hh] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float p = exp2_approx(s[4 * j + 2 * hh + x] - mx);
        s[4 * j + 2 * hh + x] = p;
        sum += p;
      }
    }
    l[hh] = l[hh] * alpha[hh] + sum;
  }
}

template <int R>
__device__ __forceinline__ void rescale_rows(float (&o)[R], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// S = Q K^T over the head dim into sacc (64 rows by 64 keys), issued and
// committed, not waited for
template <int D>
__device__ __forceinline__ void issue_scores(float (&sacc)[32], uint32_t q_tile,
                                             uint32_t k_tile) {
  using L = BwdTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    mma_ss(sacc, L::kmajor(q_tile, kk), L::kmajor(k_tile, kk), kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P V over a tile's 64 keys, P in registers as hi + lo bf16 parts,
// issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[2][4][4],
                                         uint32_t v_tile) {
  accumulate_rs<D, 2>(o, pa, v_tile, 0);
  hopper::wgmma_commit();
}

// (o, lse) of the work items this block takes: an item is 128 packed rows
// of one (batch, kv head), 64 a consumer warpgroup, in the dq kernel's
// order (flash_attention_bwd.cu); the producer loads the item's q once and
// rings the K and V tiles up to the causal diagonal of its last row
template <int D>
__global__ void __launch_bounds__(kBwdWsThreads, 1)
flash_fwd_lse_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const FwdArgs A, const int bh) {
  using L = BwdTile<D>;
  using M = FwdSmem<D>;
  constexpr int kSt = kFwdStages;
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = hopper::align1024(smem_raw);
  unsigned char* ring = q_s + 2 * M::kQ;  // K, then V, of each stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSt * M::kStage);
  uint64_t* empty = full + kSt;
  uint64_t* q_full = empty + kSt;  // one a q buffer
  uint64_t* q_empty = q_full + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = A.sq * A.group, hkv = A.hq / A.group;
  // whole queries a tile; rows past tile_rows hold stale values, never stored
  const int tile_rows = kBwdTile / A.group * A.group;
  const int item_rows = kBwdConsumers * tile_rows;
  const int n_rt = (rows + item_rows - 1) / item_rows;
  const int items = n_rt * bh;
  // the keys an item's rows see: up to the diagonal of its last row
  auto kv_len = [&](int row0) {
    const int last = min(rows, row0 + item_rows) - 1;
    return A.causal ? min(A.sk, A.q_offset + last / A.group + 1) : A.sk;
  };

  if (tid == 0) {
    hopper::prefetch_tensormap(&qmap);
    hopper::prefetch_tensormap(&kmap);
    hopper::prefetch_tensormap(&vmap);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kBwdConsumers);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 4 * kBwdConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * kBwdConsumers) {
    hopper::setmaxnreg_dec<kBwdProducerRegs>();
    if (warp == 4 * kBwdConsumers && lane == 0) {
      const int qt = kBwdTile / A.group;  // queries of a tile
      int it = 0;
      for (int r = 0;; ++r) {
        const int item = bwd_item(r, items);
        if (item < 0) break;
        const int row0 = (n_rt - 1 - item / bh) * item_rows, b = item % bh / hkv, h = item % hkv;
        // a consumer whose first row is past the last loads (and computes) nothing
        const int live = min(kBwdConsumers, (rows - row0 + tile_rows - 1) / tile_rows);
        const int qb = r & 1;
        unsigned char* qs = q_s + qb * M::kQ;
        hopper::mbar_wait(&q_empty[qb], ((r >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&q_full[qb], live * L::kBoxes * tile_rows * L::kRowBytes);
        for (int wg = 0; wg < live; ++wg) {
#pragma unroll
          for (int bx = 0; bx < L::kBoxes; ++bx) {
            hopper::tma_load_4d(qs + wg * L::kBytes + bx * L::kBox, &qmap, bx * L::kCols,
                                h * A.group, row0 / A.group + wg * qt, b, &q_full[qb]);
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
    float o[D / 2];
    int it = 0;
    for (int r = 0;; ++r) {
      const int item = bwd_item(r, items);
      if (item < 0) break;
      const int row0 = (n_rt - 1 - item / bh) * item_rows, b = item % bh / hkv, h = item % hkv;
      const int qb = r & 1;
      unsigned char* q_tile_p = q_s + qb * M::kQ + wg * L::kBytes;
      const uint32_t q_tile = hopper::smem_addr(q_tile_p);
      const int wrow0 = row0 + wg * tile_rows;  // this warpgroup's first packed row
      const int len = kv_len(row0);
      // this thread's rows (accumulator rows): the last key the causal mask
      // lets each see
      int lim[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lim[hh] = A.causal ? A.q_offset + (wrow0 + 16 * w4 + g + 8 * hh) / A.group : INT_MAX;
      }
      const int wlast = min(rows - 1, wrow0 + tile_rows - 1);
      // tiles this warpgroup computes (a consumer with no row computes none),
      // and the keys every one of its rows sees: a tile past them is masked
      const int w_end = wrow0 >= rows ? 0
                        : A.causal ? min(len, A.q_offset + wlast / A.group + 1) : len;
      const int n_w = (w_end + kBwdTile - 1) / kBwdTile;
      const int w_live = min(A.sk, A.causal ? A.q_offset + wrow0 / A.group + 1 : A.sk);
      zero_acc(o);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      hopper::mbar_wait(&q_full[qb], (r >> 1) & 1);
      const int n_kt = (len + kBwdTile - 1) / kBwdTile;
      // tile j's scores are issued with tile j - 1's P V and waited for
      // alone, so the softmax of tile j runs while P V of tile j - 1 is
      // on the tensor cores; o and P's registers are left alone until
      // that product completes, and a stage is released after it. The
      // first tile and the last P V are peeled, so that no product is
      // issued on a path of its own (ptxas serializes every product of
      // a kernel that does)
      int j = 0;
      if (n_w > 0) {
        uint32_t pa[2][4][4];
        int s_prev = it % kSt;
        const uint32_t k0_tile = hopper::smem_addr(ring + s_prev * M::kStage);
        uint32_t v_prev = k0_tile + L::kBytes;
        {
          hopper::mbar_wait(&full[s_prev], (it / kSt) & 1);
          float sacc[32];
          hopper::wgmma_fence_operands(sacc);
          hopper::wgmma_fence();
          issue_scores<D>(sacc, q_tile, k0_tile);
          hopper::wgmma_wait<0>();
          hopper::wgmma_fence_operands(sacc);
          float alpha[2];
          fwd_softmax(sacc, m, l, alpha, kBwdTile > w_live, 0, qd, lim, A.sk, A.scale_log2);
          a_fragments<2>(sacc, pa);
        }
        for (j = 1, ++it; j < n_w; ++j, ++it) {
          const int s = it % kSt;
          hopper::mbar_wait(&full[s], (it / kSt) & 1);
          const int key0 = j * kBwdTile;
          const uint32_t k_tile = hopper::smem_addr(ring + s * M::kStage);
          float sacc[32];
          hopper::wgmma_fence_operands(sacc);
          hopper::wgmma_fence_operands(o);
          hopper::wgmma_fence();
          issue_scores<D>(sacc, q_tile, k_tile);
          issue_pv<D>(o, pa, v_prev);
          hopper::wgmma_wait<1>();  // the scores; P V may still run
          hopper::wgmma_fence_operands(sacc);
          float alpha[2];
          fwd_softmax(sacc, m, l, alpha, key0 + kBwdTile > w_live, key0, qd, lim, A.sk,
                      A.scale_log2);
          hopper::wgmma_wait<0>();
          hopper::wgmma_fence_operands(o);
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&empty[s_prev]);
          rescale_rows(o, alpha);
          a_fragments<2>(sacc, pa);
          s_prev = s;
          v_prev = k_tile + L::kBytes;
        }
        hopper::wgmma_fence_operands(o);
        hopper::wgmma_fence();
        issue_pv<D>(o, pa, v_prev);
        hopper::wgmma_wait<0>();
        hopper::wgmma_fence_operands(o);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s_prev]);
      }
      // tiles past this warpgroup's rows: released at once
      for (; j < n_kt; ++j, ++it) {
        const int s = it % kSt;
        hopper::mbar_wait(&full[s], (it / kSt) & 1);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      quad_sum(l);
      if (wrow0 < rows) {
        // each packed row's log-sum-exp of the scaled scores, natural
        // units, into [B, Hq, Sq]: m and l are in log2 units
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int lr = 16 * w4 + g + 8 * hh, pr = wrow0 + lr;
          if (qd == 0 && lr < tile_rows && pr < rows) {
            const long long head = static_cast<long long>(h) * A.group + pr % A.group;
            A.lse[(static_cast<long long>(b) * A.hq + head) * A.sq + pr / A.group] =
                (m[hh] + log2f(l[hh])) * kLn2;
          }
        }
        // the output through this warp's 16 rows of the q tile, which no
        // product reads any more, so that device memory sees whole 16-byte
        // chunks of each packed row
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int lr = 16 * w4 + g + 8 * hh;
          const float inv = 1.f / l[hh];
          if (lr < tile_rows) {
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
              *reinterpret_cast<__nv_bfloat162*>(q_tile_p + tile_offset<D>(lr, j) + qd * 4) =
                  __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
            }
          }
        }
        __syncwarp();
        for (int e = lane; e < 16 * kChunks; e += 32) {
          const int lr = 16 * w4 + e / kChunks, c = e % kChunks, pr = wrow0 + lr;
          if (lr < tile_rows && pr < rows) {
            bf16* orow = A.o + b * A.o_sb + (pr / A.group) * A.o_ss +
                         (static_cast<long long>(h) * A.group + pr % A.group) * D;
            *reinterpret_cast<uint4*>(orow + c * 8) =
                *reinterpret_cast<const uint4*>(q_tile_p + tile_offset<D>(lr, c));
          }
        }
      }
      // these generic accesses before the next TMA write into the buffer
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&q_empty[qb]);
    }
  }
}

// the training forward in bf16: one launch of flash_fwd_lse_kernel, a
// persistent block an SM (or an item, where there are fewer)
template <int D>
int launch_flash_lse_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                          int b, int sq, int sk, int hkv, int group, long long q_sb,
                          long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                          long long v_ss, long long o_sb, long long o_ss, int causal,
                          int q_offset, float scale, cudaStream_t st) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_lse_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int sms = hopper::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int hq = hkv * group;
  CUtensorMap qmap, kmap, vmap;
  if ((err = encode_q_map<D>(&qmap, q, b, sq, hq, group, q_ss, q_sb)) != cudaSuccess ||
      (err = encode_kv_map<D>(&kmap, k, b, sk, hkv, k_ss, k_sb)) != cudaSuccess ||
      (err = encode_kv_map<D>(&vmap, v, b, sk, hkv, v_ss, v_sb)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  FwdArgs A;
  A.o = static_cast<bf16*>(o);
  A.lse = lse;
  A.o_sb = o_sb;
  A.o_ss = o_ss;
  A.sq = sq;
  A.sk = sk;
  A.hq = hq;
  A.group = group;
  A.causal = causal;
  A.q_offset = q_offset;
  A.scale_log2 = scale * kLog2e;
  const int bh = b * hkv;
  const int item_rows = kBwdConsumers * (kBwdTile / group * group);
  const int items = (sq * group + item_rows - 1) / item_rows * bh;
  flash_fwd_lse_kernel<D><<<min(items, sms), kBwdWsThreads, FwdSmem<D>::kBytes, st>>>(
      qmap, kmap, vmap, A, bh);
  return 0;
}

// the decode core over a whole cache of `cap` rows with device lengths,
// 16 packed rows a block
template <int D>
int launch_cached_bf16(const void* q, const void* k, const void* v, void* o, const int* lens,
                       int b, int sq, int cap, int hkv, int group, long long q_sb, long long q_ss,
                       long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                       long long o_sb, long long o_ss, float scale, int splits, cudaStream_t st) {
  if (splits < 1 || splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  CachedPolicy<D> P;
  P.q = static_cast<const bf16*>(q);
  P.k = static_cast<const bf16*>(k);
  P.v = static_cast<const bf16*>(v);
  P.o = static_cast<bf16*>(o);
  P.sq = sq;
  P.sk = cap;
  P.group = group;
  P.causal = 1;
  P.q_offset = 0;
  P.q_sb = q_sb;
  P.q_ss = q_ss;
  P.k_sb = k_sb;
  P.k_ss = k_ss;
  P.v_sb = v_sb;
  P.v_ss = v_ss;
  P.o_sb = o_sb;
  P.o_ss = o_ss;
  P.scale_log2 = scale * kLog2e;
  P.lens = lens;
  return launch_decode(P, sq * group, splits, split_chunk(cap, splits), hkv, b, 0, st);
}

}  // namespace attn
}  // namespace bobra

// q [b, sq, hq, d], k/v [b, sk, hq/group, d], o like q. The last axis is
// contiguous and heads are packed (head stride d); batch and sequence
// strides are given in elements, so a sliced KV cache needs no copy.
// splits: 0 for the rows kernel (bf16) or the scalar kernel (fp32); 1, 2,
// 4 or 8 for the bf16 decode kernel (sq * group <= 16), its keys split
// across a cluster of that many blocks. In bf16 every pointer must be
// 16-byte aligned and every stride a multiple of 8. Returns the
// cudaError_t of the launch.
extern "C" int bobra_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int b, int sq, int sk, int hq, int group, int d,
                                     long long q_sb, long long q_ss, long long k_sb,
                                     long long k_ss, long long v_sb, long long v_ss,
                                     long long o_sb, long long o_ss, int causal, int q_offset,
                                     float scale, int splits, int dtype, void* stream) {
  using namespace bobra;
  if (b <= 0 || sq <= 0 || sk <= 0 || hq <= 0 || group <= 0 || hq % group != 0 ||
      q_offset < 0 || b > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == kFloat32) {
    if (splits != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_flash_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o), b, sq, sk, hq,
                           group, d, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
                           q_offset, scale, nullptr, st);
  } else if (dtype == kBFloat16) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    const long long strides = q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | o_sb | o_ss;
    if (ptrs % 16 != 0 || strides % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int hkv = hq / group;
    switch (d) {
      case 32:
        err = attn::launch_flash_bf16<32>(q, k, v, o, b, sq, sk, hkv, group, q_sb, q_ss, k_sb,
                                          k_ss, v_sb, v_ss, o_sb, o_ss, causal, q_offset, scale,
                                          splits, st);
        break;
      case 128:
        err = attn::launch_flash_bf16<128>(q, k, v, o, b, sq, sk, hkv, group, q_sb, q_ss, k_sb,
                                           k_ss, v_sb, v_ss, o_sb, o_ss, causal, q_offset, scale,
                                           splits, st);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The cached attention of a decode step: q [b, sq, hq, d] over a whole
// cache k/v [b, cap, hq/group, d] (heads packed, batch and sequence
// strides free), lens [b] int32 on the device. Row b's queries sit at
// lens[b] - sq ..., keys at or past lens[b] are not read. splits: 1, 2, 4
// or 8 in bf16 (the decode core, its keys split across a cluster of that
// many blocks, the sq * group packed rows in tiles of 16), 0 in fp32 (the
// scalar kernel). Returns the cudaError_t of the launch.
extern "C" int bobra_cached_attention(const void* q, const void* k, const void* v, void* o,
                                      const void* lens, int b, int sq, int cap, int hq,
                                      int group, int d, long long q_sb, long long q_ss,
                                      long long k_sb, long long k_ss, long long v_sb,
                                      long long v_ss, long long o_sb, long long o_ss, float scale,
                                      int splits, int dtype, void* stream) {
  using namespace bobra;
  if (lens == nullptr || b <= 0 || sq <= 0 || cap <= 0 || hq <= 0 || group <= 0 ||
      hq % group != 0 || b > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lens);
  int err;
  if (dtype == kFloat32) {
    if (splits != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_flash_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o), b, sq, cap, hq,
                           group, d, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, 1, 0, scale,
                           len, st);
  } else if (dtype == kBFloat16) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    const long long strides = q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | o_sb | o_ss;
    if (ptrs % 16 != 0 || strides % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int hkv = hq / group;
    switch (d) {
      case 32:
        err = attn::launch_cached_bf16<32>(q, k, v, o, len, b, sq, cap, hkv, group, q_sb, q_ss,
                                           k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale, splits, st);
        break;
      case 128:
        err = attn::launch_cached_bf16<128>(q, k, v, o, len, b, sq, cap, hkv, group, q_sb, q_ss,
                                            k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale, splits, st);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The training forward: bobra_flash_attention's layout and arguments (no
// splits) with each row's log-sum-exp of the scaled scores, natural log,
// written to lse [b, hq, sq] fp32 contiguous, for the backward
// (csrc/flash_attention_bwd.cu). bf16 takes flash_fwd_lse_kernel (any
// number of packed rows; a group of at most 64 heads, as the backward),
// fp32 the scalar kernel. Returns the cudaError_t of the launch.
extern "C" int bobra_flash_attention_lse(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int b, int sq, int sk, int hq, int group,
                                         int d, long long q_sb, long long q_ss, long long k_sb,
                                         long long k_ss, long long v_sb, long long v_ss,
                                         long long o_sb, long long o_ss, int causal,
                                         int q_offset, float scale, int dtype, void* stream) {
  using namespace bobra;
  if (lse == nullptr || b <= 0 || sq <= 0 || sk <= 0 || hq <= 0 || group <= 0 ||
      hq % group != 0 || q_offset < 0 || b > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  int err;
  if (dtype == kFloat32) {
    err = launch_flash_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o), b, sq, sk, hq,
                           group, d, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
                           q_offset, scale, nullptr, st, lse_f);
  } else if (dtype == kBFloat16) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    const long long strides = q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | o_sb | o_ss;
    // a 64-row tile holds whole queries: at most 64 heads a group
    if (ptrs % 16 != 0 || strides % 8 != 0 || group > attn::kBwdTile) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int hkv = hq / group;
    switch (d) {
      case 32:
        err = attn::launch_flash_lse_bf16<32>(q, k, v, o, lse_f, b, sq, sk, hkv, group, q_sb,
                                              q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
                                              q_offset, scale, st);
        break;
      case 128:
        err = attn::launch_flash_lse_bf16<128>(q, k, v, o, lse_f, b, sq, sk, hkv, group, q_sb,
                                               q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
                                               q_offset, scale, st);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
