// Int8 weight-only matrix product: out = round(x @ q) * scale, read from the
// int8 weight itself.
//
// Replaces: bobrapet_tpu/models/quant.py:matmul (:70), whose int8 branch XLA
// fuses into one product that never writes a widened weight to memory. It
// computes what that function computes, in its order: the product of x with
// the int8 weight q [K, N] (the tree's [in, out] layout) in fp32, rounded to
// x's type, then multiplied by the per-column scale [N] in x's type and
// rounded again. The plain PyTorch version (ops/quant_matmul.py) writes a
// bf16 copy of the weight first, which this kernel never does: each weight
// byte leaves device memory once and is widened in the SM.
//
// Bound on the card: bytes at decode, where M (the rows of x: 8 for a decode
// step, 8 (k + 1) for a verify, 8 H for a draft catch-up) is far below the
// ~295 operations per byte at which the H100's bf16 tensor cores would be
// the limit. A decode step of the int8 Llama-3-8B moves 7.5 GB of int8
// weights (2.2 ms at 3.35 TB/s) where the plain version moves 3 bytes more
// per weight (a bf16 write and its read back).
//
// Two kernels, chosen by dtype:
//
// * bf16: tensor cores through mma.sync m16n8k16 (attention_core.cuh's
//   fragments). A block of 4 warps takes 128 output columns (so every
//   weight row is read as whole 128-byte lines) and 16 or 32 rows of x
//   (MT = 1 or 2 m16 tiles, from M); its K range is split over the warps,
//   and each warp runs a pipeline of its own over its share, no block
//   barrier in the K loop: a three-stage cp.async ring of 32-row
//   stages (the x tile bf16, XOR-swizzled, read by ldmatrix; the int8 tile
//   raw), and at each stage the warp widens its raw tile into a bf16 tile
//   of its own in shared memory (exactly, two integer ops and a float add
//   per weight: the byte b as the float 2^23 + (b ^ 0x80) minus 2^23 + 128,
//   whose high half is b in bf16) and reads it with ldmatrix.trans, as the
//   attention kernels read V. The warps' fp32 partials are summed in warp
//   order in shared memory. Where the grid would leave the card's SMs idle
//   (few column tiles: wq, wk, wv, wo and w_down at decode), the K range is
//   also split across a thread-block cluster of 2, 4 or 8 blocks (chosen on
//   the host from the shapes); rank 0 sums the blocks' partials through
//   distributed shared memory in rank order, rounds and scales: one launch,
//   no global scratch, no atomics, the same bits from run to run.
// * fp32: a scalar kernel, exact in fp32 (the tensor cores would run fp32
//   as TF32): a block of 128 threads takes 128 columns and 8 rows of x, x
//   staged in shared memory, one column a thread, scalar FMAs.

#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_core.cuh"
#include "common.cuh"

namespace bobra {
namespace qmm {

using attn::bf16;
using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::mma_bf16;
using attn::smem_u32;
using attn::tile_offset;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;       // output columns of a block (and of each warp): 128-byte rows
constexpr int kBK = 32;        // K rows of one warp stage
constexpr int kStages = 3;     // each warp's cp.async ring
constexpr int kQChunks = kBN / 16;  // 16-byte chunks of an int8 row
constexpr int kF32Cols = 128;  // the fp32 kernel: columns of a block (one a thread)
constexpr int kF32Rows = 8;    // rows of x of a block
constexpr int kF32K = 64;      // K of x staged at once

template <int MT>
struct Layout {
  static constexpr int kBM = 16 * MT;
  static constexpr int kX = kBM * kBK * 2;  // bf16 x tile [BM][BK], swizzled
  static constexpr int kQ = kBK * kBN;      // raw int8 tile [BK][BN]
  static constexpr int kStage = kX + kQ;
  static constexpr int kB = kBK * kBN * 2;  // the warp's widened bf16 tile [BK][BN], swizzled
  static constexpr int kWarp = kStages * kStage + kB;
  static constexpr int kBytes = kWarps * kWarp;
  // the warps' fp32 partials [4][BM][BN], overlaying the rings after the K loop
  static_assert(kWarps * kBM * kBN * 4 <= kBytes, "the partials must fit the rings");
};

// 16 int8 weights (one 16-byte chunk) -> 16 bf16, exactly (see the top)
__device__ __forceinline__ void widen16(const uint4 raw, uint4 (&out)[2]) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bits 0x4B0000uu: the float 2^23 + u, u = byte j of w[i]
      const float v = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 | j)) - 8388736.f;
      f[j] = __float_as_uint(v);
    }
    r[2 * i] = __byte_perm(f[0], f[1], 0x7632);  // the high halves: two bf16
    r[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
  out[0] = make_uint4(r[0], r[1], r[2], r[3]);
  out[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// Grid (C, ceil(N / 128), ceil(M / BM)), cluster (C, 1, 1). The K range
// in tiles of 32 rows is split over the cluster (block `rank` takes a
// contiguous share) and each block's share over its 4 warps (contiguous
// again). Each warp runs a pipeline of its own over its share: its ring
// of x and int8 stages, its widened tile, only __syncwarp between them, so
// no warp waits on another in the K loop. Then the warps' partials are
// summed in warp order in shared memory, and rank 0 sums the blocks' in
// rank order. Every block reaches both cluster barriers, also one with no
// K tile (its partial is zero).
template <int MT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_bf16_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                         const bf16* __restrict__ scale, bf16* __restrict__ out, int M, int N,
                         int K) {
  namespace cg = cooperative_groups;
  using L = Layout<MT>;
  extern __shared__ __align__(128) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.z * L::kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* wring = smem + warp * L::kWarp;
  unsigned char* b_tile = wring + kStages * L::kStage;

  // this warp's K tiles: the cluster's share, then the warp's share of it
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per_block = (k_tiles + splits - 1) / splits;
  const int b_begin = min(k_tiles, rank * per_block);
  const int b_tiles = min(k_tiles, b_begin + per_block) - b_begin;
  const int per_warp = (b_tiles + kWarps - 1) / kWarps;
  const int t_begin = b_begin + min(b_tiles, warp * per_warp);
  const int n_tiles = min(b_tiles, (warp + 1) * per_warp) - min(b_tiles, warp * per_warp);

  // stage t: x rows m0.. (4 chunks a row), q rows k0.. (4 chunks a row);
  // past M, K or N the chunk is zeros
  auto load = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = wring + (t % kStages) * L::kStage;
      const int k0 = (t_begin + t) * kBK;
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
        const int e = lane + 32 * i, r = e >> 2, c = e & 3, m = m0 + r, k = k0 + c * 8;
        const bool ok = m < M && k < K;
        cp_async16(smem_u32(st) + tile_offset<kBK>(r, c),
                   ok ? x + static_cast<long long>(m) * K + k : x, ok);
      }
#pragma unroll
      for (int i = 0; i < kBK * kQChunks / 32; ++i) {
        const int e = lane + 32 * i, r = e / kQChunks, c = e % kQChunks, k = k0 + r,
                  n = n0 + c * 16;
        const bool ok = k < K && n < N;
        cp_async16(smem_u32(st + L::kX) + r * kBN + c * 16,
                   ok ? q + static_cast<long long>(k) * N + n : q, ok);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    load(t);
    cp_async_commit();
  }

  float acc[MT][kBN / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // stage t is in shared memory; the last widened tile is consumed
    const unsigned char* st = wring + (t % kStages) * L::kStage;
#pragma unroll
    for (int i = 0; i < kBK * kQChunks / 32; ++i) {
      const int e = lane + 32 * i, r = e / kQChunks, c = e % kQChunks;
      uint4 w[2];
      widen16(*reinterpret_cast<const uint4*>(st + L::kX + r * kBN + c * 16), w);
      *reinterpret_cast<uint4*>(b_tile + tile_offset<kBN>(r, 2 * c)) = w[0];
      *reinterpret_cast<uint4*>(b_tile + tile_offset<kBN>(r, 2 * c + 1)) = w[1];
    }
    __syncwarp();  // the widened tile is whole; stage t - 1 is free
    load(t + kStages - 1);
    cp_async_commit();
    const uint32_t xs = smem_u32(st), bs = smem_u32(b_tile);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(a[mt], xs + tile_offset<kBK>(16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int g = 0; g < kBN / 16; ++g) {
        // 16 columns: two n8 tiles (b[0..1], b[2..3])
        uint32_t b[4];
        ldmatrix_x4_trans(b, bs + tile_offset<kBN>(16 * kk + (lane & 15), 2 * g + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * g], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * g + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's ring is free: the partials overlay them

  float* part = reinterpret_cast<float*>(smem);  // [warps][BM][BN]
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  {
    float* wp = part + warp * L::kBM * kBN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * mt + g + 8 * hh, c = 8 * j + t2;
          *reinterpret_cast<float2*>(wp + r * kBN + c) =
              make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
        }
      }
    }
  }
  __syncthreads();
  // the block's partial, warps in order, into warp 0's place
  for (int e = tid; e < L::kBM * (kBN / 2); e += kThreads) {
    const int off = (e / (kBN / 2)) * kBN + (e % (kBN / 2)) * 2;
    float2 sum = *reinterpret_cast<const float2*>(part + off);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(part + w * L::kBM * kBN + off);
      sum.x += v.x;
      sum.y += v.y;
    }
    *reinterpret_cast<float2*>(part + off) = sum;
  }
  cluster.sync();  // every block's partial is written and visible

  // rank 0: the blocks' partials in rank order, rounded to bf16 (the
  // product in x's type), times the scale, rounded again
  if (rank == 0) {
    for (int e = tid; e < L::kBM * (kBN / 2); e += kThreads) {
      const int r = e / (kBN / 2), c = (e % (kBN / 2)) * 2, m = m0 + r, n = n0 + c;
      float2 sum = make_float2(0.f, 0.f);
      for (int b = 0; b < splits; ++b) {
        const float2 v =
            *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, b) + r * kBN + c);
        sum.x += v.x;
        sum.y += v.y;
      }
      if (m < M && n < N) {
        const float2 prod = __bfloat1622float2(__floats2bfloat162_rn(sum.x, sum.y));
        const float2 sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(scale + n));
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(m) * N + n) =
            __floats2bfloat162_rn(prod.x * sc.x, prod.y * sc.y);
      }
    }
  }
  cluster.sync();  // rank 0 has read every block's shared memory
}

__global__ void __launch_bounds__(kF32Cols)
quant_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                        int K) {
  __shared__ float xs[kF32Rows][kF32K];
  const int n = blockIdx.x * kF32Cols + threadIdx.x;
  const int m0 = blockIdx.y * kF32Rows;
  float acc[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kF32K) {
    __syncthreads();  // the last x tile is consumed
    for (int e = threadIdx.x; e < kF32Rows * kF32K; e += kF32Cols) {
      const int r = e / kF32K, c = e % kF32K, m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? x[static_cast<long long>(m) * K + k] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int kn = min(kF32K, K - k0);
      for (int c = 0; c < kn; ++c) {
        const float w = static_cast<float>(q[static_cast<long long>(k0 + c) * N + n]);
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) acc[r] = fmaf(xs[r][c], w, acc[r]);
      }
    }
  }
  if (n < N) {
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      if (m0 + r < M) out[static_cast<long long>(m0 + r) * N + n] = acc[r] * scale[n];
    }
  }
}

template <int MT>
int launch_bf16(const void* x, const void* q, const void* scale, void* out, int m, int n, int k,
                int splits, cudaStream_t st) {
  using L = Layout<MT>;
  static bool ready[64] = {};  // per device: the shared-memory limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(quant_matmul_bf16_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const long long m_tiles = (static_cast<long long>(m) + L::kBM - 1) / L::kBM;
  const long long n_tiles = (static_cast<long long>(n) + kBN - 1) / kBN;
  if (m_tiles > 65535 || n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, static_cast<unsigned>(n_tiles), static_cast<unsigned>(m_tiles));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, quant_matmul_bf16_kernel<MT>, static_cast<const bf16*>(x),
      static_cast<const int8_t*>(q), static_cast<const bf16*>(scale), static_cast<bf16*>(out), m,
      n, k));
}

}  // namespace qmm
}  // namespace bobra

// out [m, n] = round(x [m, k] @ q [k, n]) * scale [n], all contiguous on one
// card; x, scale and out of one type (float32 or bfloat16), q int8. n and k
// multiples of 16; in bf16 x and q 16-byte aligned. splits: 1, 2, 4 or 8 in
// bf16, the blocks of a cluster that split K; 0 in fp32 (the scalar kernel).
// In bf16 the rows of a block are 16 (m <= 16) or 32.
// Returns the cudaError_t of the launch.
extern "C" int bobra_quant_matmul(const void* x, const void* q, const void* scale, void* out,
                                  int m, int n, int k, int splits, int dtype, void* stream) {
  using namespace bobra;
  if (m <= 0 || n <= 0 || k <= 0 || n % 16 != 0 || k % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == kFloat32) {
    if (splits != 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long m_tiles = (static_cast<long long>(m) + qmm::kF32Rows - 1) / qmm::kF32Rows;
    if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + qmm::kF32Cols - 1) / qmm::kF32Cols, static_cast<unsigned>(m_tiles));
    qmm::quant_matmul_f32_kernel<<<grid, qmm::kF32Cols, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), m, n, k);
    err = 0;
  } else if (dtype == kBFloat16) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q);
    if (ptrs % 16 != 0 || (splits != 1 && splits != 2 && splits != 4 && splits != 8)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (m <= 16) {
      err = qmm::launch_bf16<1>(x, q, scale, out, m, n, k, splits, st);
    } else {
      err = qmm::launch_bf16<2>(x, q, scale, out, m, n, k, splits, st);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
