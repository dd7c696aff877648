// Shared pieces of the port's bf16 attention kernels on Hopper
// (flash_attention.cu, paged_attention.cu): tensor-core fragments fed by
// ldmatrix, the cp.async ring, the online softmax over mma accumulators,
// and the decode core with its thread-block-cluster combine.
//
// Products are Ampere-style mma.sync m16n8k16 (bf16 in, fp32 accumulate)
// through inline PTX: both kernels are bound by bytes at the model's
// shapes, and a decode tile has at most 16 rows, which wgmma's 64-row
// tile would mostly waste. Plain CUDA with no PyTorch or CuTe header, so a
// source builds in seconds.
//
// Layout of a shared-memory tile: [rows][D] bf16, each row D / 8 chunks of
// 16 bytes, the chunk index XOR-swizzled by the row so that ldmatrix's 8
// row addresses at one logical chunk fall in 8 different bank groups (no
// padding, no conflicts).
//
// Precision. Scores are q·k in fp32, scaled in fp32 by 1/sqrt(D)·log2(e)
// and exponentiated with exp2f; q is never scaled and rounded back to
// bf16. P·V runs as two products, P = P_hi + P_lo with both parts in
// bf16, so P keeps ~16 significant bits: P rounded once to bf16 breaks the
// port's bf16 tolerance at the prefill shape. m, l and the output
// accumulator are fp32; the output is divided by l in fp32 and cast once.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace bobra {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;        // 4 warps per block, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;        // keys per shared-memory tile of the decode kernel
constexpr int kDecodeStages = 4;     // the most tiles a decode block keeps in flight
constexpr int kDecodeRows = 16;      // packed rows of the decode kernel: one m16 tile
constexpr int kMaxSplits = 8;        // blocks of one cluster in the decode kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;    // a causally masked score: the reference's NEG_INF
// the most dynamic shared memory a block may ask for on sm_90
constexpr int kMaxDynamicSmem = 232448;

// ---------------------------------------------------------------------------
// shared-memory tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Physical 16-byte chunk of logical chunk c in row r of a [rows][D] tile.
// D >= 64: 8 or more chunks a row, XOR with r mod 8. D = 32: 4 chunks a
// row, two rows to 128 bytes, XOR with (r / 2) mod 4.
template <int D>
__device__ __forceinline__ int swizzle(int r, int c) {
  static_assert(D == 32 || D % 64 == 0, "unsupported head dim");
  if constexpr (D / 8 >= 8) {
    return c ^ (r & 7);
  } else {
    return c ^ ((r >> 1) & 3);
  }
}

template <int D>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return static_cast<uint32_t>(r * (D * 2) + swizzle<D>(r, c) * 16);
}

template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies from global to shared memory, L2 only (.cg)

// valid == false fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the cluster barrier, split: arrive early (nothing to publish), wait later

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// fragments of mma.sync.m16n8k16 (bf16 x bf16 -> fp32)
//
// With g = lane / 4 and t = lane % 4, a thread holds of the 16x8 fp32
// accumulator the elements (g, 2t), (g, 2t+1) in c[0..1] and (g+8, ...)
// in c[2..3]; of the 16x16 A the pairs (g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..); of the 16x8 B the pairs (k 2t.., n g), (k 2t+8.., n g).

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi + lo, each rounded to nearest even
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// s = Q · K^T for the 16 q rows from row q0 of a Q tile [rows][D] and the
// NT * 8 keys from row key0 of a K tile [keys][D]. Software-pipelined, with
// no branch between the products: the fragments of k-step kk + 1 are
// loaded (ldmatrix) before the mmas of step kk, so a warp never waits on
// shared memory between products; Q's fragments hold no registers between
// tiles.
template <int D, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], uint32_t q_tile, int q0,
                                       uint32_t k_tile, int key0, int lane) {
  static_assert(NT % 2 == 0, "keys come in pairs of 8");
  constexpr int kSteps = D / 16;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const int a_r = q0 + (lane & 15), a_c = lane >> 4;
  const int b_r = key0 + ((lane >> 4) << 3) + (lane & 7), b_c = (lane >> 3) & 1;
  uint32_t a[2][4], b[2][NT / 2][4];
  auto load = [&](int kk, int buf) {
    ldmatrix_x4(a[buf], q_tile + tile_offset<D>(a_r, 2 * kk + a_c));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      ldmatrix_x4(b[buf][np], k_tile + tile_offset<D>(b_r + 16 * np, 2 * kk + b_c));
    }
  };
  load(0, 0);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    if (kk + 1 < kSteps) load(kk + 1, (kk + 1) & 1);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      mma_bf16(s[2 * np], a[kk & 1], b[kk & 1][np][0], b[kk & 1][np][1]);
      mma_bf16(s[2 * np + 1], a[kk & 1], b[kk & 1][np][2], b[kk & 1][np][3]);
    }
  }
}

// o += P · V over the NT * 8 keys from row key0 of a V tile [keys][D]; the
// probabilities p (fp32, accumulator layout) become A fragments in two
// bf16 parts. The V fragments of the next 16 columns are loaded before the
// mmas of these, and each accumulator's P_lo product comes one column
// group after its P_hi product, so consecutive mmas are independent.
template <int D, int NT>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 8][4], const float (&p)[NT][4],
                                              uint32_t v_tile, int key0, int lane) {
  constexpr int kGroups = D / 16;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    {
      uint32_t hi[4], lo[4];
      split_bf16x2(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
      split_bf16x2(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
      split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
      const int v_r = key0 + 16 * kk + (lane & 15), v_c = lane >> 4;
      uint32_t b[2][4];
      ldmatrix_x4_trans(b[0], v_tile + tile_offset<D>(v_r, v_c));
#pragma unroll
      for (int nb = 0; nb < kGroups; ++nb) {
        const int cur = nb & 1;
        if (nb > 0) {  // P_lo of the last column group, whose fragments are in b[cur ^ 1]
          mma_bf16(o[2 * nb - 2], lo, b[cur ^ 1][0], b[cur ^ 1][1]);
          mma_bf16(o[2 * nb - 1], lo, b[cur ^ 1][2], b[cur ^ 1][3]);
        }
        if (nb + 1 < kGroups) {
          ldmatrix_x4_trans(b[cur ^ 1], v_tile + tile_offset<D>(v_r, 2 * (nb + 1) + v_c));
        }
        mma_bf16(o[2 * nb], hi, b[cur][0], b[cur][1]);
        mma_bf16(o[2 * nb + 1], hi, b[cur][2], b[cur][3]);
      }
      constexpr int kLast = kGroups - 1;
      mma_bf16(o[2 * kLast], lo, b[kLast & 1][0], b[kLast & 1][1]);
      mma_bf16(o[2 * kLast + 1], lo, b[kLast & 1][2], b[kLast & 1][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// online softmax over the accumulators of one warp

// One tile's scores s (log2 units, masked) of the thread's two rows g and
// g + 8: updates the row max m, this thread's share l of the row sum,
// rescales o, and turns s into probabilities. A row that has seen no key
// (max -inf) keeps p = 0 and alpha = 0 instead of NaN; a NaN score (a bad
// page) makes p, l and o NaN, since fmaxf passes over it.
template <int NT, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&o)[NO][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m[h] - base);
    m[h] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * h] = exp2f(s[j][2 * h] - base);
      s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - base);
      sum += s[j][2 * h] + s[j][2 * h + 1];
    }
    l[h] = l[h] * alpha + sum;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * h] *= alpha;
      o[n][2 * h + 1] *= alpha;
    }
  }
}

// the full row sums from the four threads of a quad, in a fixed order
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// weight of a partial state with max m in a sum whose max is big_m
__device__ __forceinline__ float rescale(float m, float big_m) {
  return m == -INFINITY ? 0.f : exp2f(m - big_m);
}

// ---------------------------------------------------------------------------
// address policies of the decode core

// Dense, strided: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], o like q, heads
// packed, batch and sequence strides free. Packed row r of kv head h is
// (query r / group, q head h * group + r % group).
template <int D_>
struct DensePolicy {
  static constexpr int kD = D_;
  static constexpr bool kPaged = false;
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int sq, sk, group, causal, q_offset;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale_log2;  // 1/sqrt(D) * log2(e)

  __device__ int rows() const { return sq * group; }
  // keys any row may see
  __device__ int keys(int /*b*/) const { return causal ? min(sk, q_offset + sq) : sk; }
  // the last key row r of batch row b sees unmasked
  __device__ int key_limit(int /*b*/, int r) const {
    return causal ? q_offset + r / group : 0x7fffffff;
  }
  __device__ long long head_off(int h, int r) const {
    return static_cast<long long>(h * group + r % group) * kD;
  }
  __device__ const bf16* q_row(int b, int h, int r) const {
    return q + b * q_sb + (r / group) * q_ss + head_off(h, r);
  }
  __device__ bf16* o_row(int b, int h, int r) const {
    return o + b * o_sb + (r / group) * o_ss + head_off(h, r);
  }
  __device__ bool kv_rows(int b, int h, int key, const int*, int, const bf16*& kr,
                          const bf16*& vr) const {
    kr = k + b * k_sb + key * k_ss + static_cast<long long>(h) * kD;
    vr = v + b * v_sb + key * v_ss + static_cast<long long>(h) * kD;
    return true;
  }
};

// Cached, dense with device lengths: the layout of DensePolicy over a
// cache of sk = capacity rows, and lens [B] int32 on the device, the valid
// rows of each batch row. Query i of batch row b sits at lens[b] - sq + i:
// keys at or past lens[b] get probability 0 and keys past the query are
// masked, the mask of the JAX model's _cached_attention over the whole
// cache. The host passes no length, so a CUDA graph can replay the call
// while the lengths move.
template <int D_>
struct CachedPolicy : DensePolicy<D_> {
  const int* lens;

  __device__ int keys(int b) const { return max(0, min(this->sk, lens[b])); }
  __device__ int key_limit(int b, int r) const { return lens[b] - this->sq + r / this->group; }
};

// Paged: q, o [S, sq, Hkv * group, D]; pools [N, B, Hkv, D] of one layer
// read in place; int32 tables [S, MB] and seq_lens [S] on the device. Key
// t of sequence s lives in page tables[s, t / B] at row t % B. Query i of
// sequence s sits at seq_lens[s] - sq + i and sees the keys up to its own
// position (the cached rule): with sq = 1 every key below seq_lens[s].
// Packed row r is (query r / group, q head h * group + r % group).
template <int D_>
struct PagedPolicy {
  static constexpr int kD = D_;
  static constexpr bool kPaged = true;
  const bf16* q;
  const bf16* k_pool;
  const bf16* v_pool;
  bf16* o;
  const int* tables;
  const int* seq_lens;
  int sq, hkv, group, block_size, max_blocks, num_blocks;
  float scale_log2;

  __device__ int rows() const { return sq * group; }
  // a length past the table's capacity counts as the capacity
  __device__ int keys(int s) const { return min(max(seq_lens[s], 0), max_blocks * block_size); }
  __device__ int key_limit(int s, int r) const { return seq_lens[s] - sq + r / group; }
  __device__ long long row_off(int s, int h, int r) const {
    return ((static_cast<long long>(s) * sq + r / group) * hkv * group + h * group + r % group) *
           kD;
  }
  __device__ const bf16* q_row(int s, int h, int r) const { return q + row_off(s, h, r); }
  __device__ bf16* o_row(int s, int h, int r) const { return o + row_off(s, h, r); }
  // the table entries of the pages that hold keys [k_begin, k_end), once
  __device__ void load_table(int* tbl, int s, int k_begin, int k_end, int tid) const {
    if (k_end <= k_begin) return;
    const int p0 = k_begin / block_size, p1 = (k_end - 1) / block_size;
    const int* row = tables + static_cast<long long>(s) * max_blocks;
    for (int i = tid; i <= p1 - p0; i += kThreads) tbl[i] = row[p0 + i];
  }
  // false: the page id is outside the pool (the key reads as NaN)
  __device__ bool kv_rows(int, int h, int key, const int* tbl, int k_begin, const bf16*& kr,
                          const bf16*& vr) const {
    const int blk = tbl[key / block_size - k_begin / block_size];
    if (blk < 0 || blk >= num_blocks) return false;
    const long long off =
        (static_cast<long long>(blk) * block_size + key % block_size) * hkv * kD +
        static_cast<long long>(h) * kD;
    kr = k_pool + off;
    vr = v_pool + off;
    return true;
  }
};

// ---------------------------------------------------------------------------
// the decode core: tiles of 16 packed rows of one (kv head, sequence)
//
// Grid (C, Hkv, B x row tiles), cluster (C, 1, 1). A block holds one m16
// tile of packed rows, rows [16 * tile, 16 * tile + 16) of the
// (sequence, kv head): a call with more than 16 packed rows (a T-query
// verify, a draft catch-up, a multi-token cached decode) puts its tiles on
// the grid's z axis beside the sequences, each tile reading the keys its
// rows may see (its K/V tiles come from L2 for all but the first). Block
// `rank` of the
// cluster takes keys [rank * chunk, (rank + 1) * chunk) of the n that the
// sequence holds, chunk = ceil(n / C) rounded up to 16; its 4 warps take
// 16 keys each of every 64-key tile in its range, so a block's K/V tiles
// are read from device memory once for the whole GQA group. All of a
// block's tiles are in flight at once, up to four when the grid has no
// more blocks than the card has SMs and two otherwise (then two or three
// blocks share an SM). The warps combine (m, l, acc) in shared memory and
// each block pushes its state into a slot of rank 0's shared memory
// (distributed shared memory stores, which do not wait); after one
// cluster barrier rank 0 combines the slots in rank order and writes the
// output: one launch, no global scratch, no atomics, the same bits from
// run to run. Every block reaches every cluster barrier, including one
// whose keys all lie past n (it pushes the empty state).

// Shared memory of one block (byte offsets): q [16][D] and the ring at 0,
// overlaid after the key loop by the warps' partial states; rank 0's
// slots (m and l [kMaxSplits][16], acc [C][rows][D], fp32) at `slots`,
// apart, since other blocks write them while rank 0 may still compute; the
// table slice at `table`.
struct DecodeLayout {
  int stages;  // K/V tiles in flight: every tile of a block, up to 4 (or 2)
  int slots;
  int table;
};

template <int D>
__host__ __device__ constexpr int decode_partials_bytes(int rows) {
  return (kWarps * rows * (D + 8) + 2 * kWarps * kDecodeRows) * 4;
}

// max_chunk: the most keys a block can get; few_blocks: the grid fits the
// SMs one block each, so one block's tiles must keep the SM's loads in
// flight (up to four), where with more blocks two each do. Returns the
// block's bytes.
template <int D>
inline int decode_layout(int rows, int splits, int max_chunk, int table_entries,
                         bool few_blocks, DecodeLayout* L) {
  const int tiles = (max_chunk + kTileKeys - 1) / kTileKeys;
  const int most = few_blocks ? kDecodeStages : 2;
  L->stages = tiles < 1 ? 1 : (tiles > most ? most : tiles);
  const int loop = tile_bytes<D>(kDecodeRows) + L->stages * 2 * tile_bytes<D>(kTileKeys);
  const int overlay = loop > decode_partials_bytes<D>(rows) ? loop : decode_partials_bytes<D>(rows);
  L->slots = (overlay + 15) / 16 * 16;
  L->table = L->slots + (2 * kMaxSplits * kDecodeRows + splits * rows * D) * 4;
  return L->table + table_entries * 4;
}

template <class Policy>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Policy P, const DecodeLayout L) {
  namespace cg = cooperative_groups;
  constexpr int D = Policy::kD;
  constexpr int kChunks = D / 8;
  constexpr int kTile = tile_bytes<D>(kTileKeys);
  constexpr int kNO = D / 8;      // accumulator n-tiles
  constexpr int kLd = D + 8;      // fp32 row stride of the warps' partial states

  cluster_arrive_relaxed();  // this block runs; waited for before any remote store

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* ring = q_s + tile_bytes<D>(kDecodeRows);
  float* slot_m = reinterpret_cast<float*>(smem + L.slots);  // rank 0's: [kMaxSplits][16]
  float* slot_l = slot_m + kMaxSplits * kDecodeRows;         // [kMaxSplits][16]
  float* slot_o = slot_l + kMaxSplits * kDecodeRows;         // [C][rows][D]
  int* tbl = reinterpret_cast<int*>(smem + L.table);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  // z: the sequence and its tile of packed rows (the tiles of a sequence
  // are adjacent)
  const int tiles = (P.rows() + kDecodeRows - 1) / kDecodeRows;
  const int h = blockIdx.y, seq = blockIdx.z / tiles;
  const int row0 = (blockIdx.z % tiles) * kDecodeRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int rows = min(kDecodeRows, P.rows() - row0);
  const int n = P.keys(seq);
  const int chunk = (n + splits * 16 - 1) / (splits * 16) * 16;
  const int k_begin = min(n, rank * chunk), k_end = min(n, k_begin + chunk);
  const int n_tiles = (k_end - k_begin + kTileKeys - 1) / kTileKeys;

  // q rows to shared memory (rows past `rows` are zeros), then the table
  for (int e = tid; e < kDecodeRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r < rows;
    cp_async16(smem_u32(q_s) + tile_offset<D>(r, c), (ok ? P.q_row(seq, h, row0 + r) : P.q) + c * 8, ok);
  }
  if constexpr (Policy::kPaged) {
    P.load_table(tbl, seq, k_begin, k_end, tid);
    __syncthreads();
  }

  // every key of the tile gets its row: data, zeros past the range, or NaN
  // for a page outside the pool
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = ring + (t % L.stages) * 2 * kTile;
      const int key0 = k_begin + t * kTileKeys;
      for (int e = tid; e < kTileKeys * kChunks; e += kThreads) {
        const int j = e / kChunks, c = e % kChunks, key = key0 + j;
        const uint32_t off = tile_offset<D>(j, c);
        const bf16* kr = P.q;
        const bf16* vr = P.q;
        const bool in_range = key < k_end;
        if (in_range && !P.kv_rows(seq, h, key, tbl, k_begin, kr, vr)) {
          const uint4 nan = make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u);
          *reinterpret_cast<uint4*>(st + off) = nan;
          *reinterpret_cast<uint4*>(st + kTile + off) = nan;
        } else {
          cp_async16(smem_u32(st) + off, kr + c * 8, in_range);
          cp_async16(smem_u32(st + kTile) + off, vr + c * 8, in_range);
        }
      }
    }
  };
  // one commit group per stage up front, one per iteration after: tile t
  // is complete once at most stages - 1 groups are pending
#pragma unroll
  for (int t = 0; t < kDecodeStages; ++t) {
    if (t < L.stages) {
      load_tile(t);
      cp_async_commit();
    }
  }

  float o[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int limit[2] = {P.key_limit(seq, row0 + g), P.key_limit(seq, row0 + g + 8)};

  for (int t = 0; t < n_tiles; ++t) {
    switch (L.stages) {
      case 4: cp_async_wait<3>(); break;
      case 3: cp_async_wait<2>(); break;
      case 2: cp_async_wait<1>(); break;
      default: cp_async_wait<0>(); break;
    }
    __syncthreads();  // tile t (and, with tile 0, q) is in shared memory
    const unsigned char* st = ring + (t % L.stages) * 2 * kTile;
    const int wkey0 = k_begin + t * kTileKeys + warp * 16;
    if (wkey0 < k_end) {
      float s[2][4];
      scores<D, 2>(s, smem_u32(q_s), 0, smem_u32(st), warp * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = wkey0 + 8 * j + t2 + (e & 1);
          float x = s[j][e] * P.scale_log2;
          if (key >= k_end) {
            x = -INFINITY;  // not this block's key: probability exactly 0
          } else if (key > limit[e >> 1]) {
            x = kMasked;
          }
          s[j][e] = x;
        }
      }
      online_softmax(s, m, l, o);
      accumulate_pv<D, 2>(o, s, smem_u32(st + kTile), warp * 16, lane);
    }
    __syncthreads();
    load_tile(t + L.stages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // q and the ring are free: the warps' partial states overlay them
  quad_sum(l);

  float* part_o = reinterpret_cast<float*>(smem);          // [warps][rows][kLd]
  float* part_m = part_o + kWarps * rows * kLd;             // [warps][16]
  float* part_l = part_m + kWarps * kDecodeRows;            // [warps][16]
  {
    float* po = part_o + warp * rows * kLd;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < kNO; ++j) {
          *reinterpret_cast<float2*>(po + r * kLd + 8 * j + t2) =
              make_float2(o[j][2 * hh], o[j][2 * hh + 1]);
        }
      }
    }
    if ((lane & 3) == 0) {
      part_m[warp * kDecodeRows + g] = m[0];
      part_m[warp * kDecodeRows + g + 8] = m[1];
      part_l[warp * kDecodeRows + g] = l[0];
      part_l[warp * kDecodeRows + g + 8] = l[1];
    }
  }
  __syncthreads();

  // the block's state, warps 0..3 in order, pushed into rank 0's slot;
  // each thread weighs the warps for the rows it handles
  cluster_wait();  // every block of the cluster runs: its shared memory exists
  float* dst_m = cluster.map_shared_rank(slot_m, 0);
  float* dst_l = cluster.map_shared_rank(slot_l, 0);
  float* dst_o = cluster.map_shared_rank(slot_o, 0) + rank * rows * D;
  if (tid < rows) {
    float big_m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big_m = fmaxf(big_m, part_m[w * kDecodeRows + tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sum += part_l[w * kDecodeRows + tid] * rescale(part_m[w * kDecodeRows + tid], big_m);
    }
    dst_m[rank * kDecodeRows + tid] = big_m;
    dst_l[rank * kDecodeRows + tid] = sum;
  }
  for (int e = tid; e < rows * (D / 2); e += kThreads) {
    const int r = e / (D / 2), c = (e % (D / 2)) * 2;
    float big_m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big_m = fmaxf(big_m, part_m[w * kDecodeRows + r]);
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 x = *reinterpret_cast<const float2*>(part_o + (w * rows + r) * kLd + c);
      const float f = rescale(part_m[w * kDecodeRows + r], big_m);
      acc.x += x.x * f;
      acc.y += x.y * f;
    }
    *reinterpret_cast<float2*>(dst_o + r * D + c) = acc;
  }
  cluster.sync();  // the slots are written and visible to rank 0

  // rank 0: the blocks in rank order; no key at all gives zeros (NaN from
  // a bad page stays NaN)
  if (rank == 0) {
    for (int e = tid; e < rows * (D / 2); e += kThreads) {
      const int r = e / (D / 2), c = (e % (D / 2)) * 2;
      float big_m = -INFINITY;
      for (int b = 0; b < splits; ++b) big_m = fmaxf(big_m, slot_m[b * kDecodeRows + r]);
      float sum = 0.f;
      float2 acc = make_float2(0.f, 0.f);
      for (int b = 0; b < splits; ++b) {
        const float f = rescale(slot_m[b * kDecodeRows + r], big_m);
        const float2 x = *reinterpret_cast<const float2*>(slot_o + (b * rows + r) * D + c);
        sum += slot_l[b * kDecodeRows + r] * f;
        acc.x += x.x * f;
        acc.y += x.y * f;
      }
      const float inv = sum == 0.f ? 0.f : 1.f / sum;
      *reinterpret_cast<__nv_bfloat162*>(P.o_row(seq, h, row0 + r) + c) =
          __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    }
  }
}

// Set the kernel's dynamic shared-memory limit once per device, then
// launch it on a cluster of `splits` blocks along x, one block a tile of
// 16 of the `rows` packed rows of each (kv head, batch row). max_chunk is
// the most keys a block can get (from the static size the split was
// chosen from). Returns the cudaError_t; a refused cluster launch is an
// error, never retried.
template <class Policy>
int launch_decode(const Policy& P, int rows, int splits, int max_chunk, int heads, int batch,
                  int table_entries, cudaStream_t st) {
  constexpr int D = Policy::kD;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(rows) + kDecodeRows - 1) / kDecodeRows;
  if (rows < 1 || batch < 1 || tiles * batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int sm_count[64] = {};  // per device; 0 until the first launch there
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(decode_attention_kernel<Policy>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[dev] = sms;
  }
  DecodeLayout L;
  const bool few_blocks = splits * heads * tiles * batch <= sm_count[dev];
  const int smem = decode_layout<D>(rows < kDecodeRows ? rows : kDecodeRows, splits, max_chunk,
                                    table_entries, few_blocks, &L);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, heads, static_cast<unsigned>(tiles * batch));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_attention_kernel<Policy>, P, L));
}

// the most keys one block of a split can get out of `size`
inline int split_chunk(int size, int splits) {
  return (size + splits * 16 - 1) / (splits * 16) * 16;
}

// the table entries a block of the paged decode may need: the pages of
// its largest key range, plus one for a range that starts mid-page
inline int paged_table_entries(int capacity, int splits, int block_size) {
  return split_chunk(capacity, splits) / block_size + 2;
}

}  // namespace attn
}  // namespace bobra
