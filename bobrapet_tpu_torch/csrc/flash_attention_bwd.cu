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
// one block. Three launches: D; then dk/dv, one block of 4 warps a tile of
// 64 keys (16 a warp), looping over the packed rows that see those keys in
// tiles of 32 (q and do double-buffered by cp.async), accumulating dk and
// dv in fp32 registers (mma.sync m16n8k16 through attention_core.cuh, keys
// on the m side: S^T = K Q^T, dP^T = V dO^T); then dq, one block a tile of
// 64 packed rows (16 a warp) looping over key tiles of 32, as the forward's
// rows kernel does. P and dS go into the products as two bf16 parts (hi +
// lo, attention_core.cuh:accumulate_pv), as the forward's P does. fp32
// takes scalar kernels (exact; the tensor cores would run fp32 as TF32).
// No wgmma or TMA yet: a simple kernel first.

#include <math.h>

#include "attention_core.cuh"
#include "common.cuh"

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
// bf16: tensor-core kernels

namespace attn {

constexpr int kBwdKeys = 64;    // keys of a dk/dv block: 16 a warp
constexpr int kBwdQTile = 32;   // packed rows of one q tile in the dk/dv loop
constexpr int kBwdRows = 64;    // packed rows of a dq block: 16 a warp
constexpr int kBwdKTile = 32;   // keys of one tile in the dq loop

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  // K and V of the block's keys, then two stages of (q, do, lse, D)
  return 2 * tile_bytes<D>(kBwdKeys) + 2 * (2 * tile_bytes<D>(kBwdQTile) + 2 * kBwdQTile * 4);
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  // q and do of the block's rows, then two stages of (K, V)
  return 2 * tile_bytes<D>(kBwdRows) + 2 * 2 * tile_bytes<D>(kBwdKTile);
}

// 4-byte cp.async (L1 allowed): valid == false writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

struct BwdPtrs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
};

// one element's probability from its raw score (log2 units after the
// scale) and its row's log-sum-exp (natural units), masked as the forward
__device__ __forceinline__ float bwd_prob(float raw, float scale_log2, float lse, int mask) {
  if (mask == 2) return 0.f;
  const float x = mask == 1 ? kMasked : raw * scale_log2;
  return exp2f(x - lse * kLog2e);
}

// dk, dv of 64 keys of kv head h: grid (ceil(sk / 64), hkv, b)
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_kernel(const BwdPtrs A, const BwdShape S) {
  constexpr int kChunks = D / 8;
  constexpr int kNT = kBwdQTile / 8;  // score n-tiles: the q tile's rows
  constexpr int kNO = D / 8;          // accumulator n-tiles
  constexpr int kQTile = tile_bytes<D>(kBwdQTile);
  constexpr int kStage = 2 * kQTile + 2 * kBwdQTile * 4;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + tile_bytes<D>(kBwdKeys);
  unsigned char* ring = smem + 2 * tile_bytes<D>(kBwdKeys);

  const int k0 = blockIdx.x * kBwdKeys, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = S.rows();
  const float scale_log2 = S.scale * kLog2e;

  for (int e = tid; e < kBwdKeys * kChunks; e += kBwdThreads) {
    const int j = e / kChunks, c = e % kChunks, key = k0 + j;
    const bool ok = key < S.sk;
    const long long off = ok ? S.kv_off(b, h, key, D) + c * 8 : 0;
    cp_async16(smem_u32(k_s) + tile_offset<D>(j, c), A.k + off, ok);
    cp_async16(smem_u32(v_s) + tile_offset<D>(j, c), A.v + off, ok);
  }
  // the packed rows that see any of these keys start at (k0 - q_offset) * group
  const int first = S.causal ? max(0, k0 - S.q_offset) * S.group : 0;
  const int t0 = first / kBwdQTile;
  const int n_tiles = (rows + kBwdQTile - 1) / kBwdQTile;
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = ring + (t & 1) * kStage;
      const int r0 = t * kBwdQTile;
      for (int e = tid; e < kBwdQTile * kChunks; e += kBwdThreads) {
        const int r = e / kChunks, c = e % kChunks, pr = r0 + r;
        const bool ok = pr < rows;
        const long long off = ok ? S.q_off(b, h, pr, D) + c * 8 : 0;
        const uint32_t dst = tile_offset<D>(r, c);
        cp_async16(smem_u32(st) + dst, A.q + off, ok);
        cp_async16(smem_u32(st + kQTile) + dst, A.dout + off, ok);
      }
      if (tid < kBwdQTile) {
        const int pr = r0 + tid;
        const bool ok = pr < rows;
        const long long off = ok ? S.stat_off(b, h, pr) : 0;
        cp_async4(smem_u32(st + 2 * kQTile) + tid * 4, A.lse + off, ok);
        cp_async4(smem_u32(st + 2 * kQTile + kBwdQTile * 4) + tid * 4, A.delta + off, ok);
      }
    }
    cp_async_commit();
  };
  load_tile(t0);  // one group with K and V

  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int kw = k0 + warp * 16;  // this warp's first key
  // the first packed row that sees any of this warp's keys
  const int w_first = S.causal ? max(0, kw - S.q_offset) * S.group : 0;
  float dk[kNO][4], dv[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int t = t0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    // tile t is in shared memory and every warp is done with tile t - 1,
    // whose stage the next load takes
    __syncthreads();
    load_tile(t + 1);
    const unsigned char* st = ring + (t & 1) * kStage;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * kQTile);
    const float* del_s = lse_s + kBwdQTile;
    const int r0 = t * kBwdQTile;
    if (kw < S.sk && r0 + kBwdQTile > w_first) {
      // P^T = exp(K Q^T * scale - lse): keys on the rows, packed q rows on the columns
      float p[kNT][4];
      scores<D, kNT>(p, smem_u32(k_s), warp * 16, smem_u32(st), 0, lane);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + t2 + (e & 1), pr = r0 + c;
          const int key = kw + g + 8 * (e >> 1);
          const int m = pr < rows ? S.mask(pr, key) : 2;
          p[j][e] = bwd_prob(p[j][e], scale_log2, lse_s[c], m);
        }
      }
      // dv += P^T do
      accumulate_pv<D, kNT>(dv, p, smem_u32(st + kQTile), 0, lane);
      // dS^T = P^T * (V dO^T - D)
      float ds[kNT][4];
      scores<D, kNT>(ds, smem_u32(v_s), warp * 16, smem_u32(st + kQTile), 0, lane);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - del_s[8 * j + t2 + (e & 1)]);
      }
      // dk += dS^T q (scaled below)
      accumulate_pv<D, kNT>(dk, ds, smem_u32(st), 0, lane);
    }
  }
  cp_async_wait<0>();

  // dk, dv go through K's and V's shared memory, so that device memory
  // sees whole 16-byte chunks of each key row
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const uint32_t off = tile_offset<D>(r, j) + (lane & 3) * 4;
      *reinterpret_cast<__nv_bfloat162*>(k_s + off) =
          __floats2bfloat162_rn(dk[j][2 * hh] * S.scale, dk[j][2 * hh + 1] * S.scale);
      *reinterpret_cast<__nv_bfloat162*>(v_s + off) =
          __floats2bfloat162_rn(dv[j][2 * hh], dv[j][2 * hh + 1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < kBwdKeys * kChunks; e += kBwdThreads) {
    const int j = e / kChunks, c = e % kChunks, key = k0 + j;
    if (key < S.sk) {
      const long long off = S.kv_off(b, h, key, D) + c * 8;
      *reinterpret_cast<uint4*>(A.dk + off) =
          *reinterpret_cast<const uint4*>(k_s + tile_offset<D>(j, c));
      *reinterpret_cast<uint4*>(A.dv + off) =
          *reinterpret_cast<const uint4*>(v_s + tile_offset<D>(j, c));
    }
  }
}

// dq of 64 packed rows of kv head h: grid (ceil(rows / 64), hkv, b)
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dq_kernel(const BwdPtrs A, const BwdShape S) {
  constexpr int kChunks = D / 8;
  constexpr int kNT = kBwdKTile / 8;
  constexpr int kNO = D / 8;
  constexpr int kKTile = tile_bytes<D>(kBwdKTile);

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* g_s = smem + tile_bytes<D>(kBwdRows);
  unsigned char* ring = smem + 2 * tile_bytes<D>(kBwdRows);

  const int row0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = S.rows();
  const float scale_log2 = S.scale * kLog2e;
  const int last_row = min(rows, row0 + kBwdRows) - 1;
  const int kv_len = S.causal ? min(S.sk, S.q_offset + last_row / S.group + 1) : S.sk;
  const int n_tiles = (kv_len + kBwdKTile - 1) / kBwdKTile;

  for (int e = tid; e < kBwdRows * kChunks; e += kBwdThreads) {
    const int r = e / kChunks, c = e % kChunks, pr = row0 + r;
    const bool ok = pr < rows;
    const long long off = ok ? S.q_off(b, h, pr, D) + c * 8 : 0;
    cp_async16(smem_u32(q_s) + tile_offset<D>(r, c), A.q + off, ok);
    cp_async16(smem_u32(g_s) + tile_offset<D>(r, c), A.dout + off, ok);
  }
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = ring + (t & 1) * 2 * kKTile;
      const int key0 = t * kBwdKTile;
      for (int e = tid; e < kBwdKTile * kChunks; e += kBwdThreads) {
        const int j = e / kChunks, c = e % kChunks, key = key0 + j;
        const bool ok = key < kv_len;
        const long long off = ok ? S.kv_off(b, h, key, D) + c * 8 : 0;
        const uint32_t dst = tile_offset<D>(j, c);
        cp_async16(smem_u32(st) + dst, A.k + off, ok);
        cp_async16(smem_u32(st + kKTile) + dst, A.v + off, ok);
      }
    }
    cp_async_commit();
  };
  load_tile(0);  // one group with q and do

  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wrow0 = row0 + warp * 16;
  const bool has_rows = wrow0 < rows;
  const int wlast = min(rows - 1, wrow0 + 15);
  const int w_kv_end = S.causal ? min(kv_len, S.q_offset + wlast / S.group + 1) : kv_len;
  // this thread's two rows: their log-sum-exp and D
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pr = wrow0 + g + 8 * hh;
    const bool ok = pr < rows;
    lse_r[hh] = ok ? A.lse[S.stat_off(b, h, pr)] : 0.f;
    del_r[hh] = ok ? A.delta[S.stat_off(b, h, pr)] : 0.f;
  }
  float dq[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    load_tile(t + 1);
    const unsigned char* st = ring + (t & 1) * 2 * kKTile;
    const int key0 = t * kBwdKTile;
    if (has_rows && key0 < w_kv_end) {
      float p[kNT][4];
      scores<D, kNT>(p, smem_u32(q_s), warp * 16, smem_u32(st), 0, lane);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pr = wrow0 + g + 8 * (e >> 1), key = key0 + 8 * j + t2 + (e & 1);
          const int m = pr < rows ? S.mask(pr, key) : 2;
          p[j][e] = bwd_prob(p[j][e], scale_log2, lse_r[e >> 1], m);
        }
      }
      float ds[kNT][4];
      scores<D, kNT>(ds, smem_u32(g_s), warp * 16, smem_u32(st + kKTile), 0, lane);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - del_r[e >> 1]);
      }
      // dq += dS K (scaled below)
      accumulate_pv<D, kNT>(dq, ds, smem_u32(st), 0, lane);
    }
  }
  cp_async_wait<0>();

  __syncthreads();  // every warp is done reading q
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(q_s + tile_offset<D>(r, j) + (lane & 3) * 4) =
          __floats2bfloat162_rn(dq[j][2 * hh] * S.scale, dq[j][2 * hh + 1] * S.scale);
    }
  }
  __syncthreads();
  for (int e = tid; e < kBwdRows * kChunks; e += kBwdThreads) {
    const int r = e / kChunks, c = e % kChunks, pr = row0 + r;
    if (pr < rows) {
      *reinterpret_cast<uint4*>(A.dq + S.q_off(b, h, pr, D) + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + tile_offset<D>(r, c));
    }
  }
}

template <int D>
int launch_bwd_bf16(const BwdPtrs& A, const BwdShape& S, int b, int hkv, cudaStream_t st) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem_bytes<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int rows = S.sq * S.group;
  const dim3 kv_grid((S.sk + kBwdKeys - 1) / kBwdKeys, hkv, b);
  flash_bwd_dkdv_kernel<D><<<kv_grid, kBwdThreads, dkdv_smem_bytes<D>(), st>>>(A, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((rows + kBwdRows - 1) / kBwdRows, hkv, b);
  flash_bwd_dq_kernel<D><<<q_grid, kBwdThreads, dq_smem_bytes<D>(), st>>>(A, S);
  return static_cast<int>(cudaGetLastError());
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
// [b, hq, sq]. bf16 pointers 16-byte aligned. Three launches on `stream`
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
  if (ptrs % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_delta_kernel<__nv_bfloat16><<<delta_blocks, kBwdThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), del, sq, hq,
      d, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn::BwdPtrs A;
  A.q = static_cast<const attn::bf16*>(q);
  A.k = static_cast<const attn::bf16*>(k);
  A.v = static_cast<const attn::bf16*>(v);
  A.dout = static_cast<const attn::bf16*>(dout);
  A.lse = static_cast<const float*>(lse);
  A.delta = del;
  A.dq = static_cast<attn::bf16*>(dq);
  A.dk = static_cast<attn::bf16*>(dk);
  A.dv = static_cast<attn::bf16*>(dv);
  return d == 32 ? attn::launch_bwd_bf16<32>(A, S, b, hkv, st)
                 : attn::launch_bwd_bf16<128>(A, S, b, hkv, st);
}
