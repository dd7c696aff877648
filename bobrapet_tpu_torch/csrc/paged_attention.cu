// Paged decode attention: one query per sequence over KV pages read in place,
// or T queries per sequence (a speculative verify, a draft catch-up).
//
// Replaces: bobrapet_tpu/serving/engine.py:_paged_attention_pallas, which calls
// jax.experimental's TPU paged_attention kernel (paged_attention_kernel.py:376).
// The T-query entry, bobra_paged_attention_multi, replaces the XLA function
// bobrapet_tpu/serving/spec_decode.py:_paged_attention_multi (query t of slot
// s attends the cache positions <= pos0[s] + t, its own write included): the
// caller passes lens = pos0 + T, and query i then sits at lens - T + i, the
// cached kernel's causal rule. T = 1 is bobra_paged_attention, bit for bit.
// It computes what the engine runs by default, engine.py:_paged_attention (the
// einsum route): scores scaled by 1/sqrt(D) in fp32 (the Pallas route passes q
// unscaled and applies no scale), keys at positions >= seq_len masked, softmax
// in fp32, the output cast once to q's type. seq_len == 0 gives a zero
// output; a seq_len past the table's capacity counts as the capacity; an
// out-of-range block id in a covered page makes the row NaN rather than read
// outside the pool; table entries past the covered pages are never read.
//
// Layout: the port's pool [N, B, Hkv, D] of one layer, read from the layer's
// base pointer with no transpose (the TPU kernel wants [Hkv, N, B, D] and the
// JAX engine transposes for it). Key t of kv head h of a sequence sits at
// ((table[t / B] * B + t % B) * Hkv + h) * D, so one head's rows are Hkv * D
// elements apart. Tables and lengths are device int32, read by the kernel.
//
// Bound on the card: bytes. A decode step reads each valid K/V row once and
// does 4 flops per element of it per q head of the group (group 4 at the 8B
// widths: ~4 flops/byte in bf16, far below the ~295 the H100 needs to be
// compute bound). chip_smoke.py's main case (8 slots, Hq 32, Hkv 8, D 128,
// 385 valid tokens, bf16) moves 1.71 MB: 0.51 us at 3.35 TB/s, below what a
// launch costs.
//
// Two kernels, chosen by dtype:
//
// * bf16: attention_core.cuh's decode core with the paged policy. The GQA
//   group's q rows (T x group packed rows for T queries) fill m16 tiles of
//   the tensor cores, one tile a block, the tiles on the grid; a sequence's keys
//   are split across a thread-block cluster of C blocks (C from the table's
//   capacity, on the host: the wrapper never reads tables or lengths), grid
//   (C, Hkv, slots). Each block loads its slice of the table row once, then
//   puts its pages' K/V cp.async copies in flight (64-key tiles, bf16,
//   XOR-swizzled; all of a block's tiles up to four) before any math; its
//   4 warps split each tile, combine in shared memory, and push their
//   state into rank 0, which combines the cluster: one launch, no atomics,
//   deterministic.
// * fp32: the scalar kernel below, exact in fp32 (the tensor cores would
//   run fp32 as TF32): one block of 128 threads per (kv head, sequence,
//   query) holding the group's rows, 32-key tiles staged as fp32 in shared
//   memory, one key per lane, scalar FMAs.

#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"
#include "common.cuh"

namespace bobra {

constexpr int kPagedThreads = 128;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kTileKeys = 32;  // one key per lane
constexpr int kMaxGroup = 16;  // q heads per kv head (wrapper checks)
constexpr int kRowsPerWarpMax = kMaxGroup / kPagedWarps;
constexpr float kPagedNegInf = -1e30f;  // the reference's NEG_INF

template <typename T, int D>
__global__ void __launch_bounds__(kPagedThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ seq_lens, T* __restrict__ o, int sq, int hkv,
                       int group, int block_size, int max_blocks, int num_blocks, float scale) {
  static_assert(kPagedThreads % D == 0, "unsupported head dim");
  constexpr int kPack = 16 / sizeof(T);           // elements per 16-byte load
  constexpr int kVecPerRow = D / kPack;
  constexpr int kRowStride = kPagedThreads / D;   // output phase: rows per pass
  constexpr int kRowsPerThread = (kMaxGroup + kRowStride - 1) / kRowStride;

  __shared__ float qs[kMaxGroup][D];
  __shared__ float ks[kTileKeys][D + 1];  // padded: 32 lanes hit 32 banks
  __shared__ float vs[kTileKeys][D];
  __shared__ float ps[kMaxGroup][kTileKeys];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int h = blockIdx.x;  // kv head
  const int s = blockIdx.y;  // sequence (slot)
  const int qi = blockIdx.z;  // query: at seq_lens[s] - sq + qi, sees the keys up to it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the group's q rows (heads h*group ...) of query qi are contiguous: [group, D]
  const long long q_row0 = ((static_cast<long long>(s) * sq + qi) * hkv + h) * group;
  const T* qb = q + q_row0 * D;
  T* ob = o + q_row0 * D;
  const int* table = tables + static_cast<long long>(s) * max_blocks;
  const int n = min(max(seq_lens[s] - sq + qi + 1, 0), max_blocks * block_size);
  const long long token_stride = static_cast<long long>(hkv) * D;

  for (int e = tid; e < group * D; e += kPagedThreads) {
    qs[e / D][e % D] = to_float(qb[e]) * scale;
  }

  float m[kRowsPerWarpMax], l[kRowsPerWarpMax];
#pragma unroll
  for (int i = 0; i < kRowsPerWarpMax; ++i) {
    m[i] = kPagedNegInf;
    l[i] = 0.f;
  }
  const int dcol = tid % D, rgroup = tid / D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTileKeys) {
    __syncthreads();  // the last tile's ks/vs/ps are consumed (and qs is written)
    for (int e = tid; e < kTileKeys * kVecPerRow; e += kPagedThreads) {
      const int jj = e / kVecPerRow, c0 = (e % kVecPerRow) * kPack, key = k0 + jj;
      float kf[kPack], vf[kPack];
      if (key < n) {
        const int blk = table[key / block_size];
        if (blk >= 0 && blk < num_blocks) {
          const long long off =
              (static_cast<long long>(blk) * block_size + key % block_size) * token_stride +
              static_cast<long long>(h) * D + c0;
          const uint4 kraw = *reinterpret_cast<const uint4*>(k_pool + off);
          const uint4 vraw = *reinterpret_cast<const uint4*>(v_pool + off);
          const T* ke = reinterpret_cast<const T*>(&kraw);
          const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
          for (int t = 0; t < kPack; ++t) {
            kf[t] = to_float(ke[t]);
            vf[t] = to_float(ve[t]);
          }
        } else {
#pragma unroll
          for (int t = 0; t < kPack; ++t) kf[t] = vf[t] = NAN;  // a bad table shows
        }
      } else {
#pragma unroll
        for (int t = 0; t < kPack; ++t) kf[t] = vf[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kPack; ++t) {
        ks[jj][c0 + t] = kf[t];
        vs[jj][c0 + t] = vf[t];
      }
    }
    __syncthreads();

    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarpMax; ++i) {
      const int r = warp + kPagedWarps * i;
      if (r >= group) break;  // uniform across the warp
      float sc = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) sc = fmaf(qs[r][c], ks[lane][c], sc);
      if (key >= n) sc = -INFINITY;  // past seq_len: probability exactly 0
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = expf(sc - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      ps[r][lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rgroup + kRowStride * i;
      if (r < group) acc[i] *= alpha_s[r];
    }
    const int tile_n = min(kTileKeys, n - k0);
    for (int j = 0; j < tile_n; ++j) {
      const float vv = vs[j][dcol];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rgroup + kRowStride * i;
        if (r < group) acc[i] = fmaf(ps[r][j], vv, acc[i]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarpMax; ++i) {
      const int r = warp + kPagedWarps * i;
      if (r < group) l_s[r] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rgroup + kRowStride * i;
    if (r < group) ob[r * D + dcol] = from_float<T>(n > 0 ? acc[i] / l_s[r] : 0.f);
  }
}

int launch_paged_f32(const float* q, const float* k_pool, const float* v_pool, const int* tables,
                     const int* seq_lens, float* o, int slots, int sq, int hkv, int group, int d,
                     int block_size, int max_blocks, int num_blocks, float scale,
                     cudaStream_t st) {
  const dim3 grid(hkv, slots, sq);
#define BOBRA_PAGED(DD)                                                                        \
  paged_attention_kernel<float, DD><<<grid, kPagedThreads, 0, st>>>(                           \
      q, k_pool, v_pool, tables, seq_lens, o, sq, hkv, group, block_size, max_blocks,           \
      num_blocks, scale)
  switch (d) {
    case 32: BOBRA_PAGED(32); break;    // llama_tiny
    case 128: BOBRA_PAGED(128); break;  // llama3_1b, llama3_8b
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BOBRA_PAGED
  return 0;
}

namespace attn {

template <int D>
int launch_paged_bf16(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                      const int* seq_lens, void* o, int slots, int sq, int hkv, int group,
                      int block_size, int max_blocks, int num_blocks, float scale, int splits,
                      cudaStream_t st) {
  PagedPolicy<D> P;
  P.q = static_cast<const bf16*>(q);
  P.k_pool = static_cast<const bf16*>(k_pool);
  P.v_pool = static_cast<const bf16*>(v_pool);
  P.o = static_cast<bf16*>(o);
  P.tables = tables;
  P.seq_lens = seq_lens;
  P.sq = sq;
  P.hkv = hkv;
  P.group = group;
  P.block_size = block_size;
  P.max_blocks = max_blocks;
  P.num_blocks = num_blocks;
  P.scale_log2 = scale * kLog2e;
  if (splits < 1 || splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const int capacity = max_blocks * block_size;
  return launch_decode(P, sq * group, splits, split_chunk(capacity, splits), hkv, slots,
                       paged_table_entries(capacity, splits, block_size), st);
}

}  // namespace attn
}  // namespace bobra

namespace {

// both entries: sq queries per sequence (1 for the one-query entry)
int paged_attention(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                    const void* seq_lens, void* o, int slots, int sq, int hkv, int group, int d,
                    int block_size, int max_blocks, int num_blocks, float scale, int splits,
                    int dtype, void* stream) {
  using namespace bobra;
  const uintptr_t pools = reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  const uintptr_t rows = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(o);
  if (slots <= 0 || slots > 65535 || sq <= 0 || sq > 65535 || hkv <= 0 || hkv > 65535 ||
      group <= 0 || group > kMaxGroup || block_size <= 0 || max_blocks <= 0 || num_blocks <= 0 ||
      static_cast<long long>(max_blocks) * block_size > 0x7fffffff || pools % 16 != 0 ||
      (dtype == kBFloat16 && rows % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(tables);
  const int* lp = static_cast<const int*>(seq_lens);
  int err;
  if (dtype == kFloat32) {
    if (splits != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_paged_f32(static_cast<const float*>(q), static_cast<const float*>(k_pool),
                           static_cast<const float*>(v_pool), tp, lp, static_cast<float*>(o),
                           slots, sq, hkv, group, d, block_size, max_blocks, num_blocks, scale,
                           st);
  } else if (dtype == kBFloat16) {
    switch (d) {
      case 32:
        err = attn::launch_paged_bf16<32>(q, k_pool, v_pool, tp, lp, o, slots, sq, hkv, group,
                                          block_size, max_blocks, num_blocks, scale, splits, st);
        break;
      case 128:
        err = attn::launch_paged_bf16<128>(q, k_pool, v_pool, tp, lp, o, slots, sq, hkv, group,
                                           block_size, max_blocks, num_blocks, scale, splits, st);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [slots, hkv * group, d]; k_pool, v_pool: [num_blocks, block_size, hkv, d],
// all contiguous and of one type, the pools (and in bf16 q and o) 16-byte
// aligned; tables: int32 [slots, max_blocks]; seq_lens: int32 [slots]. splits: 0 for fp32 (the
// scalar kernel); 1, 2, 4 or 8 for bf16, the blocks of the cluster that
// split a sequence's keys. Returns the cudaError_t of the launch.
extern "C" int bobra_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* tables, const void* seq_lens, void* o,
                                     int slots, int hkv, int group, int d, int block_size,
                                     int max_blocks, int num_blocks, float scale, int splits,
                                     int dtype, void* stream) {
  return paged_attention(q, k_pool, v_pool, tables, seq_lens, o, slots, 1, hkv, group, d,
                         block_size, max_blocks, num_blocks, scale, splits, dtype, stream);
}

// The T-query entry: q, o [slots, sq, hkv * group, d], the rest as above,
// lens [slots] int32 = pos0 + sq, where query i of slot s sits at position
// pos0[s] + i and attends the keys at positions <= it. In bf16 the sq x
// group packed rows go in tiles of 16, one block a tile. Returns the
// cudaError_t of the launch.
extern "C" int bobra_paged_attention_multi(const void* q, const void* k_pool, const void* v_pool,
                                           const void* tables, const void* lens, void* o,
                                           int slots, int sq, int hkv, int group, int d,
                                           int block_size, int max_blocks, int num_blocks,
                                           float scale, int splits, int dtype, void* stream) {
  return paged_attention(q, k_pool, v_pool, tables, lens, o, slots, sq, hkv, group, d,
                         block_size, max_blocks, num_blocks, scale, splits, dtype, stream);
}
