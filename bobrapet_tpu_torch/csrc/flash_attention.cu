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

#include <math.h>

#include "attention_core.cuh"
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
                       int causal, int q_offset, float scale, const int* __restrict__ lens) {
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
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp + kWarps * i] = l[i];
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
                     const int* lens, cudaStream_t st) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, hq, b);
#define BOBRA_FLASH(DD)                                                                       \
  flash_attention_kernel<float, DD><<<grid, kThreads, 0, st>>>(q, k, v, o, sq, sk, group,      \
                                                              q_sb, q_ss, k_sb, k_ss, v_sb,     \
                                                              v_ss, o_sb, o_ss, causal,         \
                                                              q_offset, scale, lens)
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
    err = cudaFuncSetAttribute(flash_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
