// Int8 weight-only matrix product: out = round(x @ q) * scale, read from the
// int8 weight itself.
//
// Replaces: bobrapet_tpu/models/quant.py:matmul (:70), whose int8 branch XLA
// fuses into one product that never writes a widened weight to memory. It
// computes what that function computes, in its order: the product of x
// [M, K] with the int8 weight q [K, N] (the tree's [in, out] layout) summed
// in fp32, rounded to x's type, then multiplied by the per-column scale [N]
// in x's type and rounded again. The plain PyTorch version
// (ops/quant_matmul.py) writes a widened copy of the weight first; no route
// here writes one to device memory.
//
// Three routes, one C entry; the host picks the route from the type, M and
// N (ops/quant_matmul.py: quant_route). D and P widen each int8 byte
// exactly: the float 2^23 + (b + 128) less 2^23 + 128 is b, whose high
// half is b in bf16 (two integer ops and a float add per weight).
//
// * D, bf16 decode, verify and catch-up (up to 32 rows, and to 128 where
//   route P's grid would be small). Bound by bytes: at M = 8 the product
//   does 16 operations per int8 byte where the H100's bf16 tensor cores
//   need ~295, so the design is about keeping HBM busy. A block takes 128
//   output columns (one 128-byte TMA row of q) and BM = 8, 16 or 32 rows of
//   x. One producer warp streams the block's K range through a ring of 10
//   stages (64 K rows: 8 KB of q and BM rows of x, 128-byte-swizzled TMA
//   boxes, full/empty mbarriers): up to 80 KB of int8 requested per block,
//   and at M = 8 two blocks fit an SM. The weight's first stages are
//   requested before the dependency wait. Eight mma warps in two sets take
//   alternate stages, one k16 slice of a stage each: four 16-byte words of
//   int8 (rows 2t, 2t+1, 2t+8, 2t+9 of the slice, chunk g: conflict-free
//   under the swizzle) are widened in registers straight into mma.sync's A
//   operand; no widened weight is written to shared memory. The operands
//   are swapped: the weight's columns are the m16 side and x's rows the n8
//   side, so M = 8 is one n8 tile with no padding. Fragment row g of m16
//   tile i holds column 16g + 2i and row g + 8 column 16g + 2i + 1 (a fixed
//   permutation that the partials' layout undoes). Where the grid would
//   leave SMs idle, K is also split across a thread-block cluster
//   (ops/quant_matmul.py: quant_splits); each block sums its warps in warp
//   order and pushes each rank's 1/splits of the tile into that rank's
//   shared memory, and after one cluster barrier each rank sums its share
//   over the blocks in rank order, rounds, scales and stores. No atomics:
//   the same bits every run.
// * P, bf16 prefill (above 128 rows, and from 33 where its grid is large).
//   Bound by operations at M = 1024. The operands are swapped here too: a
//   tile is 128 rows of x by 256 weight columns (128 where that grid would
//   leave SMs idle: ops/quant_matmul.py: prefill_tile), and each consumer
//   warpgroup takes 128 of the columns as wgmma's M (two m64 halves) and
//   the 128 rows as its N, with A from registers: every lane widens its
//   int8 words straight into A (route D's mapping) and x is a K-major B in
//   shared memory. So the widened weight never touches shared memory, each
//   int8 byte is widened once for all 128 rows, and a tile moves 56 KB of
//   shared memory per million FMAs. A TMA warp keeps 6 stages of x and int8
//   tiles in flight; its warpgroup gives its registers to the consumers
//   (setmaxnreg). A tile's A registers are all written before its first
//   wgmma and rest until its last is done (ptxas would otherwise serialise
//   the products), and the two warpgroups overlap one's widening with the
//   other's products. The grid puts the row tiles fastest, so the tiles that
//   share a weight tile run together and it leaves device memory once.
// * F, fp32 (the cross-checks): exact fp32 FMAs outside the tensor cores
//   (TF32 would break the 1e-5 tolerance). Each thread reads 16-byte words
//   of q (16 columns) and holds 8 rows of x staged in shared memory; a block
//   is 256 columns by 8 K lanes, and K is split across a cluster so the grid
//   fills the card; lanes, warps and blocks are summed in a fixed order.
//
// Every ring slot read by generic loads, or by wgmma, is released only
// after a fence.proxy.async: without it the next TMA or generic write can
// land first (found on the card as rare differing runs). Every route
// launches with programmatic dependent launch when the host asks: the
// weight stream starts while the kernel before finishes, and x is read,
// and anything written, only after griddepcontrol.wait.

#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_core.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace bobra {
namespace qmm {

namespace cg = cooperative_groups;
using attn::bf16;
using attn::mma_bf16;
using hopper::smem_addr;

// routes and flags of the C entry (ops/quant_matmul.py keeps the same)
constexpr int kRouteF = 0;
constexpr int kRouteD = 1;
constexpr int kRouteP = 2;
constexpr int kFlagPdl = 1;

// route D
constexpr int kDCols = 128;                       // output columns of a block
constexpr int kDBK = 64;                          // K rows of a stage: 8 KB of q, 128 B rows of x
constexpr int kDSetWarps = kDBK / 16;             // one k16 slice of a stage each
constexpr int kDSets = 2;                         // sets of mma warps, alternate stages
constexpr int kDConsumers = kDSets * kDSetWarps;  // 8
constexpr int kDThreads = (kDConsumers + 1) * 32; // and the TMA warp
constexpr int kDStages = 10;                      // 80 KB of q in flight, two blocks an SM at BM = 8
// a set waits on the parity of its own stages only while no stage passes
// between the sets: with an odd ring one set could pass a wait two phases
// early
static_assert(kDStages % kDSets == 0, "each stage of the ring belongs to one set of warps");
constexpr int kDPartStride = kDCols + 4;          // floats a partial row (padded)

// route P: WGS consumer warpgroups (1 or 2) of 128 weight columns each
constexpr int kPBM = 128, kPBK = 64;              // x rows and K of a tile
constexpr int kPQBox = 128;                       // weight columns of one int8 box (a warpgroup)
constexpr int kPStages = 6;                       // x tile + int8 tile

// route F
constexpr int kFColThreads = 16;                  // 16 columns a thread
constexpr int kFKLanes = 8;
constexpr int kFThreads = kFColThreads * kFKLanes;
constexpr int kFCols = kFColThreads * 16;
constexpr int kFRows = 8;
constexpr int kFChunk = 128;                      // K rows of x staged at once

constexpr int kMaxSplits = 8;

template <int BM>
struct DLayout {
  static constexpr int kQ = kDBK * kDCols;                  // int8 [64][128]
  static constexpr int kX = BM * kDBK * 2;                  // bf16 [BM][64]
  static constexpr int kStage = kQ + kX;                    // multiples of 1024
  static constexpr int kRing = kDStages * kStage;
  static constexpr int kPart = kDConsumers * BM * kDPartStride * 4;
  static constexpr int kRecv = BM * kDCols * 4;            // the cluster's slices of this rank's share
  static constexpr int kData = (kRing > kPart ? kRing : kPart) + kRecv;
  static constexpr int kBytes = 1024 + kData + 2 * kDStages * 8;
};

template <int WGS>
struct PLayout {
  static constexpr int kMmaWarps = 4 * WGS;
  static constexpr int kThreads = (kMmaWarps + 4) * 32;     // and the TMA warpgroup
  static constexpr int kBN = WGS * kPQBox;                  // weight columns of a tile
  static constexpr int kX = kPBM * kPBK * 2;                // bf16 x [128][64]
  static constexpr int kQBox = kPBK * kPQBox;               // int8 [64][128]
  static constexpr int kStage = kX + WGS * kQBox;
  static constexpr int kRing = kPStages * kStage;
  static constexpr int kBytes = 1024 + kRing + 2 * kPStages * 8;
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// byte j of an int8 word (bias-flipped: b ^ 0x80) as an exact float: the
// float 2^23 + (b + 128) less 2^23 + 128
__device__ __forceinline__ float byte_float(uint32_t flipped, int j) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 | j)) - 8388736.f;
}

// two words of int8 -> four bf16 pairs, exactly: pair j holds byte j of lo
// in its low half and byte j of hi in its high half (the floats above are
// integers of at most 8 bits, so their high halves are exact bf16)
__device__ __forceinline__ void widen_pairs(uint32_t lo, uint32_t hi, uint32_t (&out)[4]) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = __byte_perm(__float_as_uint(byte_float(lo, j)), __float_as_uint(byte_float(hi, j)),
                         0x7632);
  }
}

// the float4 at p in every block of the cluster, summed in rank order; all
// the remote loads are issued before the first add
__device__ __forceinline__ float4 cluster_sum(const cg::cluster_group& cluster, float* p,
                                              int splits) {
  float4 v[kMaxSplits];
#pragma unroll
  for (int b = 0; b < kMaxSplits; ++b) {
    if (b < splits) v[b] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, b));
  }
  float4 sum = v[0];
#pragma unroll
  for (int b = 1; b < kMaxSplits; ++b) {
    if (b < splits) {
      sum.x += v[b].x;
      sum.y += v[b].y;
      sum.z += v[b].z;
      sum.w += v[b].w;
    }
  }
  return sum;
}

// round(sum) to bf16, times the scale, rounded again: four columns from n
__device__ __forceinline__ void store_bf16x4(bf16* dst, const bf16* __restrict__ scale,
                                             float4 s) {
  const float v[4] = {s.x, s.y, s.z, s.w};
  uint32_t packed[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float p0 = __bfloat162float(__float2bfloat16_rn(v[2 * h]));
    const float p1 = __bfloat162float(__float2bfloat16_rn(v[2 * h + 1]));
    const __nv_bfloat162 o = __floats2bfloat162_rn(p0 * __bfloat162float(scale[2 * h]),
                                                   p1 * __bfloat162float(scale[2 * h + 1]));
    packed[h] = attn::bf16x2_bits(o);
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
}

// ---------------------------------------------------------------------------
// route D

// Grid (splits, ceil(M / BM), ceil(N / 128)), cluster (splits, 1, 1): the
// row tiles of one column tile are neighbours. Block `rank` takes a
// contiguous share of the K stages. Warps 0-7 multiply, warp 8 loads.
template <int BM>
__global__ void __launch_bounds__(kDThreads, BM == 8 ? 2 : 1)
quant_decode_kernel(__grid_constant__ const CUtensorMap qmap,
                    __grid_constant__ const CUtensorMap xmap, const bf16* __restrict__ scale,
                    bf16* __restrict__ out, int M, int N, int K) {
  using L = DLayout<BM>;
  constexpr int NT = BM / 8;  // n8 tiles of x's rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kData);
  uint64_t* empty = full + kDStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * kDCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int k_tiles = (K + kDBK - 1) / kDBK;
  const int per = (k_tiles + splits - 1) / splits;
  const int t_begin = min(k_tiles, rank * per);
  const int n_st = min(k_tiles, t_begin + per) - t_begin;

  if (tid == 0) {
    hopper::prefetch_tensormap(&qmap);
    hopper::prefetch_tensormap(&xmap);
#pragma unroll
    for (int s = 0; s < kDStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kDSetWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  hopper::launch_dependents();
  attn::cluster_arrive_relaxed();  // this block has started (waited on before the pushes)

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[nt][i][0] = acc[nt][i][1] = acc[nt][i][2] = acc[nt][i][3] = 0.f;
  }

  if (warp == kDConsumers) {
    if (lane == 0) {
      // the weight needs no earlier kernel: its first stages go before the
      // dependency wait, x's after it
      const int pre = min(n_st, kDStages);
      for (int i = 0; i < pre; ++i) {
        hopper::mbar_expect_tx(&full[i], L::kStage);
        hopper::tma_load_2d(ring + i * L::kStage, &qmap, n0, (t_begin + i) * kDBK, &full[i]);
      }
      hopper::grid_dependency_wait();
      for (int i = 0; i < pre; ++i) {
        hopper::tma_load_2d(ring + i * L::kStage + L::kQ, &xmap, (t_begin + i) * kDBK, m0,
                            &full[i]);
      }
      for (int i = pre; i < n_st; ++i) {
        const int s = i % kDStages;
        hopper::mbar_wait(&empty[s], ((i / kDStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::kStage);
        unsigned char* st = ring + s * L::kStage;
        hopper::tma_load_2d(st, &qmap, n0, (t_begin + i) * kDBK, &full[s]);
        hopper::tma_load_2d(st + L::kQ, &xmap, (t_begin + i) * kDBK, m0, &full[s]);
      }
    }
    __syncwarp();
  } else {
    const int set = warp / kDSetWarps, slice = warp % kDSetWarps;
    const int g = lane >> 2, t = lane & 3;
    for (int i = set; i < n_st; i += kDSets) {
      const int s = i % kDStages;
      hopper::mbar_wait(&full[s], (i / kDStages) & 1);
      const unsigned char* qs = ring + s * L::kStage;
      const unsigned char* xs = qs + L::kQ;
      // q rows r0, r0 + 1, r0 + 8, r0 + 9 of this warp's slice, chunk g
      const int r0 = 16 * slice + 2 * t;
      uint4 raw[4];
#pragma unroll
      for (int jr = 0; jr < 4; ++jr) {
        const int r = r0 + (jr & 1) + 8 * (jr >> 1);
        raw[jr] = *reinterpret_cast<const uint4*>(qs + r * kDCols + ((g ^ (r & 7)) << 4));
      }
      // B: x rows 8 nt + g at k 2t.. and 2t + 8.. of the slice (chunks
      // 2 slice and 2 slice + 1 of a 128-byte row, swizzled by the row)
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* row = xs + (8 * nt + g) * (kDBK * 2);
        b[nt][0] = *reinterpret_cast<const uint32_t*>(row + (((2 * slice) ^ g) << 4) + 4 * t);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(row + (((2 * slice + 1) ^ g) << 4) + 4 * t);
      }
      // release the stage once it is in registers: the proxy fence completes
      // these generic loads before the TMA's next write to the slot
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // columns 16g + 4w .. + 3: m16 tiles 2w (columns +0, +1) and 2w + 1
        uint32_t lo[4], hi[4];
        widen_pairs(word(raw[0], w), word(raw[1], w), lo);
        widen_pairs(word(raw[2], w), word(raw[3], w), hi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a[4] = {lo[2 * h], lo[2 * h + 1], hi[2 * h], hi[2 * h + 1]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][2 * w + h], a, b[nt][0], b[nt][1]);
        }
      }
    }
  }
  __syncthreads();  // every stage is consumed: the partials overlay the ring

  // warp partials [warps][BM][128 (+4)]: acc[nt][i][hh] is row 8 nt + 2t + hh,
  // column 16g + 2i; acc[nt][i][2 + hh] the column after it
  float* part = reinterpret_cast<float*>(ring);
  if (warp < kDConsumers) {
    const int g = lane >> 2, t = lane & 3;
    float* wp = part + warp * BM * kDPartStride;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* dst = wp + (8 * nt + 2 * t + hh) * kDPartStride + 16 * g;
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          *reinterpret_cast<float4*>(dst + 4 * i4) =
              make_float4(acc[nt][2 * i4][hh], acc[nt][2 * i4][2 + hh], acc[nt][2 * i4 + 1][hh],
                          acc[nt][2 * i4 + 1][2 + hh]);
        }
      }
    }
  }
  __syncthreads();
  // the block's sum, warps in order, pushed straight into the receive buffer
  // of the rank that owns each float4 (rank r owns float4s r share..): slot
  // [this rank][..] there, over distributed shared memory. One cluster
  // barrier then makes every push visible, and each rank sums its slots in
  // rank order: no remote load, and no block reads another's memory after
  // the barrier, so none waits for the others to leave
  constexpr int kVec = BM * kDCols / 4;  // float4s of the tile
  const int share = (kVec + splits - 1) / splits;
  float4* recv = reinterpret_cast<float4*>(ring + L::kData - L::kRecv);
  attn::cluster_wait();  // every block of the cluster runs: its shared memory may be written
  for (int e = tid; e < kVec; e += kDThreads) {
    const int off = (e / (kDCols / 4)) * kDPartStride + (e % (kDCols / 4)) * 4;
    float4 sum = *reinterpret_cast<const float4*>(part + off);
#pragma unroll
    for (int w = 1; w < kDConsumers; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(part + w * BM * kDPartStride + off);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int owner = e / share;
    *(cluster.map_shared_rank(recv, owner) + rank * share + (e - owner * share)) = sum;
  }
  cluster.sync();  // every push has landed
  hopper::grid_dependency_wait();
  const int e_end = min(kVec, (rank + 1) * share);
  for (int e = rank * share + tid; e < e_end; e += kDThreads) {
    const int slot = e - rank * share;
    float4 sum = recv[slot];
    for (int b = 1; b < splits; ++b) {
      const float4 v = recv[b * share + slot];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int r = e / (kDCols / 4), c = (e % (kDCols / 4)) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) store_bf16x4(out + static_cast<long long>(m) * N + n, scale + n, sum);
  }
}

// ---------------------------------------------------------------------------
// route P

// Grid (ceil(M / 128), ceil(N / (128 WGS))): row tiles fastest. The
// operands are swapped: warpgroup wg takes weight columns 128 wg.. of the
// tile as wgmma's M (two m64 halves h) and the tile's 128 rows of x as its
// N. Each
// lane widens its int8 words straight into the A registers, with route D's
// mapping: lane group g of warp w4 holds columns 32 w4 + 4g .. + 3, fragment
// row g of half h column + 2h and row g + 8 column + 2h + 1. The first WGS
// warpgroups widen and multiply; in the last, one thread loads.
template <int WGS>
__global__ void __launch_bounds__(PLayout<WGS>::kThreads, 1)
quant_prefill_kernel(__grid_constant__ const CUtensorMap qmap,
                     __grid_constant__ const CUtensorMap xmap, const bf16* __restrict__ scale,
                     bf16* __restrict__ out, int M, int N, int K) {
  using L = PLayout<WGS>;
  constexpr int kPMmaWarps = L::kMmaWarps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kRing);
  uint64_t* empty = full + kPStages;

  const int m0 = blockIdx.x * kPBM, n0 = blockIdx.y * L::kBN;
  const int k_tiles = (K + kPBK - 1) / kPBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    hopper::prefetch_tensormap(&qmap);
    hopper::prefetch_tensormap(&xmap);
#pragma unroll
    for (int s = 0; s < kPStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kPMmaWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  hopper::launch_dependents();

  // with two consumer warpgroups, twelve warps start with at most 168
  // registers a thread: the TMA warpgroup gives most of its back to the two
  // that multiply (a tile's A registers and 128 accumulators a thread); with
  // one, eight warps start with enough
  if (warp >= kPMmaWarps) {
    if constexpr (WGS == 2) hopper::setmaxnreg_dec<40>();
    if (warp == kPMmaWarps && lane == 0) {
      auto load_q = [&](int i, int s) {
#pragma unroll
        for (int h = 0; h < WGS; ++h) {
          hopper::tma_load_2d(ring + s * L::kStage + L::kX + h * L::kQBox, &qmap,
                              n0 + h * kPQBox, i * kPBK, &full[s]);
        }
      };
      // the weight first (it needs no earlier kernel), x after the wait
      const int pre = min(k_tiles, kPStages);
      for (int i = 0; i < pre; ++i) {
        hopper::mbar_expect_tx(&full[i], L::kStage);
        load_q(i, i);
      }
      hopper::grid_dependency_wait();
      for (int i = 0; i < pre; ++i) {
        hopper::tma_load_2d(ring + i * L::kStage, &xmap, i * kPBK, m0, &full[i]);
      }
      for (int i = pre; i < k_tiles; ++i) {
        const int s = i % kPStages;
        hopper::mbar_wait(&empty[s], ((i / kPStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::kStage);
        load_q(i, s);
        hopper::tma_load_2d(ring + s * L::kStage, &xmap, i * kPBK, m0, &full[s]);
      }
    }
    __syncwarp();
  } else {
    if constexpr (WGS == 2) hopper::setmaxnreg_inc<232>();
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
    const int col = 32 * w4 + 4 * g;  // this lane's first column in its warpgroup's box
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[h][e] = 0.f;
    }
    // a tile's A registers are all written before its first product and
    // rest until its last is done, so ptxas never serialises the products;
    // the two warpgroups overlap one's widening with the other's products
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % kPStages;
      hopper::mbar_wait(&full[s], (i / kPStages) & 1);
      const unsigned char* xs = ring + s * L::kStage;
      const unsigned char* qs = xs + L::kX + wg * L::kQBox;
      const uint32_t xa = smem_addr(xs);
      uint32_t a[kPBK / 16][2][4];
#pragma unroll
      for (int kk = 0; kk < kPBK / 16; ++kk) {
        // rows 16 kk + (2t, 2t+1, 2t+8, 2t+9), 4 columns: the words of a row
        // pair become the A pairs of both halves
        uint32_t wv[4];
#pragma unroll
        for (int jr = 0; jr < 4; ++jr) {
          const int r = 16 * kk + 2 * t + (jr & 1) + 8 * (jr >> 1);
          wv[jr] = *reinterpret_cast<const uint32_t*>(
              qs + r * kPQBox + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15)));
        }
        uint32_t lo[4], hi[4];
        widen_pairs(wv[0], wv[1], lo);
        widen_pairs(wv[2], wv[3], hi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[kk][h][0] = lo[2 * h];
          a[kk][h][1] = lo[2 * h + 1];
          a[kk][h][2] = hi[2 * h];
          a[kk][h][3] = hi[2 * h + 1];
        }
      }
      hopper::wgmma_fence_operands(acc[0]);
      hopper::wgmma_fence_operands(acc[1]);
      hopper::wgmma_fence();  // the A registers before the products read them
#pragma unroll
      for (int kk = 0; kk < kPBK / 16; ++kk) {
        // x as B: K-major, rows of 128 bytes, 8-row groups 1024 bytes apart
        const uint64_t db = hopper::wgmma_desc(xa + 32 * kk, 16, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h) hopper::wgmma_m64n128k16_rs(acc[h], a[kk][h], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_fence_operands(acc[0]);
      hopper::wgmma_fence_operands(acc[1]);
      hopper::wgmma_wait<0>();
      hopper::wgmma_fence_operands(acc[0]);
      hopper::wgmma_fence_operands(acc[1]);
      // release the stage: its int8 words were read by generic loads, x by
      // wgmma; the fence orders the former before the TMA's next write
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    hopper::grid_dependency_wait();
    // acc[h][4j + 2hh + e]: weight column col + 2h + hh, x row 8j + 2t + e:
    // four consecutive columns a row
    const int n = n0 + 128 * wg + col;
#pragma unroll
    for (int j = 0; j < kPBM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m < M && n < N) {
          store_bf16x4(out + static_cast<long long>(m) * N + n, scale + n,
                       make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                                   acc[1][4 * j + 2 + e]));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// route F

// Grid (splits, ceil(M / 8), ceil(N / 256)), cluster (splits, 1, 1): block
// `rank` takes a contiguous share of K in chunks of 128 rows. Thread
// (lane k-lane kl = tid / 16, column thread ct = tid % 16) takes columns
// n0 + 16 ct.. at K rows kl, kl + 8, ... of each chunk.
__global__ void __launch_bounds__(kFThreads)
quant_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[kFChunk][kFRows];
  __shared__ __align__(16) float red[kFThreads / 32][kFRows][kFCols];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int m0 = blockIdx.y * kFRows, n0 = blockIdx.z * kFCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ct = tid % kFColThreads, kl = tid / kFColThreads;
  const int n = n0 + 16 * ct;
  const int chunks = (K + kFChunk - 1) / kFChunk;
  const int per = (chunks + splits - 1) / splits;
  const int kb = min(K, rank * per * kFChunk), ke = min(K, (rank + 1) * per * kFChunk);

  hopper::launch_dependents();
  hopper::grid_dependency_wait();
  float acc[kFRows][16];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  }
  for (int k0 = kb; k0 < ke; k0 += kFChunk) {
    __syncthreads();  // the last chunk of x is consumed
    for (int e = tid; e < kFChunk * kFRows; e += kFThreads) {
      const int r = e / kFChunk, c = e % kFChunk, m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < ke) ? x[static_cast<long long>(m) * K + k] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int kn = min(kFChunk, ke - k0);
#pragma unroll 4
      for (int c = kl; c < kn; c += kFKLanes) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(
            q + static_cast<long long>(k0 + c) * N + n));
        float wf[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t u = word(w, i) ^ 0x80808080u;
#pragma unroll
          for (int j = 0; j < 4; ++j) wf[4 * i + j] = byte_float(u, j);
        }
        const float4 xa = *reinterpret_cast<const float4*>(&xs[c][0]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[c][4]);
        const float xr[kFRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < kFRows; ++r) {
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(xr[r], wf[j], acc[r][j]);
        }
      }
    }
  }
  // k-lanes 2 warp and 2 warp + 1 (lanes l and l + 16): a + b either way
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
  }
  if (lane < 16) {
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        *reinterpret_cast<float4*>(&red[warp][r][16 * ct + 4 * j4]) =
            make_float4(acc[r][4 * j4], acc[r][4 * j4 + 1], acc[r][4 * j4 + 2],
                        acc[r][4 * j4 + 3]);
      }
    }
  }
  __syncthreads();
  constexpr int kVec = kFRows * kFCols / 4;
  float* part = &red[0][0][0];
  for (int e = tid; e < kVec; e += kFThreads) {
    float4 sum = *reinterpret_cast<const float4*>(part + 4 * e);
#pragma unroll
    for (int w = 1; w < kFThreads / 32; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(part + w * kFRows * kFCols + 4 * e);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(part + 4 * e) = sum;
  }
  cluster.sync();
  const int share = (kVec + splits - 1) / splits;
  const int e_end = min(kVec, (rank + 1) * share);
  for (int e = rank * share + tid; e < e_end; e += kFThreads) {
    const float4 sum = cluster_sum(cluster, part + 4 * e, splits);
    const int m = m0 + e / (kFCols / 4), nn = n0 + (e % (kFCols / 4)) * 4;
    if (m < M && nn < N) {
      *reinterpret_cast<float4*>(out + static_cast<long long>(m) * N + nn) =
          make_float4(sum.x * scale[nn], sum.y * scale[nn + 1], sum.z * scale[nn + 2],
                      sum.w * scale[nn + 3]);
    }
  }
  cluster.sync();
}

// ---------------------------------------------------------------------------
// host

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// the launch's attributes: a cluster of `splits` along x (0: none), and
// programmatic dependent launch
struct Attrs {
  cudaLaunchAttribute a[2];
  unsigned n = 0;
  Attrs(int splits, bool pdl) {
    if (splits > 0) {
      a[n].id = cudaLaunchAttributeClusterDimension;
      a[n].val.clusterDim.x = splits;
      a[n].val.clusterDim.y = 1;
      a[n].val.clusterDim.z = 1;
      ++n;
    }
    if (pdl) {
      a[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      a[n].val.programmaticStreamSerializationAllowed = 1;
      ++n;
    }
  }
};

template <int BM>
cudaError_t launch_decode(const void* x, const void* q, const void* scale, void* out, int m,
                          int n, int k, int splits, bool pdl, cudaStream_t st) {
  using L = DLayout<BM>;
  static bool ready[64] = {};
  cudaError_t err = allow_smem(quant_decode_kernel<BM>, L::kBytes, ready);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, xmap;
  err = hopper::encode_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, n, k, n, kDCols, kDBK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2LL * k, kDBK, BM,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (static_cast<long long>(m) + BM - 1) / BM;
  const long long n_tiles = (static_cast<long long>(n) + kDCols - 1) / kDCols;
  if (m_tiles > 65535 || n_tiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles));
  cfg.blockDim = dim3(kDThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = st;
  Attrs attrs(splits, pdl);
  cfg.attrs = attrs.a;
  cfg.numAttrs = attrs.n;
  return cudaLaunchKernelEx(&cfg, quant_decode_kernel<BM>, qmap, xmap,
                            static_cast<const bf16*>(scale), static_cast<bf16*>(out), m, n, k);
}

template <int WGS>
cudaError_t launch_prefill(const void* x, const void* q, const void* scale, void* out, int m,
                           int n, int k, bool pdl, cudaStream_t st) {
  using L = PLayout<WGS>;
  static bool ready[64] = {};
  cudaError_t err = allow_smem(quant_prefill_kernel<WGS>, L::kBytes, ready);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, xmap;
  err = hopper::encode_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, n, k, n, kPQBox, kPBK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2LL * k, kPBK, kPBM,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (static_cast<long long>(m) + kPBM - 1) / kPBM;
  const long long n_tiles = (static_cast<long long>(n) + L::kBN - 1) / L::kBN;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles), 1);
  cfg.blockDim = dim3(L::kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = st;
  Attrs attrs(0, pdl);
  cfg.attrs = attrs.a;
  cfg.numAttrs = attrs.n;
  return cudaLaunchKernelEx(&cfg, quant_prefill_kernel<WGS>, qmap, xmap,
                            static_cast<const bf16*>(scale), static_cast<bf16*>(out), m, n, k);
}

cudaError_t launch_f32(const void* x, const void* q, const void* scale, void* out, int m, int n,
                       int k, int splits, bool pdl, cudaStream_t st) {
  const long long m_tiles = (static_cast<long long>(m) + kFRows - 1) / kFRows;
  const long long n_tiles = (static_cast<long long>(n) + kFCols - 1) / kFCols;
  if (m_tiles > 65535 || n_tiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles));
  cfg.blockDim = dim3(kFThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  Attrs attrs(splits, pdl);
  cfg.attrs = attrs.a;
  cfg.numAttrs = attrs.n;
  return cudaLaunchKernelEx(&cfg, quant_f32_kernel, static_cast<const float*>(x),
                            static_cast<const int8_t*>(q), static_cast<const float*>(scale),
                            static_cast<float*>(out), m, n, k);
}

}  // namespace qmm
}  // namespace bobra

// out [m, n] = round(x [m, k] @ q [k, n]) * scale [n], all contiguous on one
// card; x, scale and out of one type (float32 or bfloat16), q int8 and
// 16-byte aligned; n and k multiples of 16. route: 0 (F, fp32), 1 (D,
// bf16) or 2 (P, bf16; x 16-byte aligned in D and P). splits: the blocks
// of a cluster that split K in D and F (1, 2, 4 or 8); 1 in P. tile: D's
// rows of x a block (8, 16 or 32), P's weight columns a block (128 or
// 256), 0 in F.
// flags: bit 0 launches with programmatic dependent launch.
// Returns the cudaError_t of the launch.
extern "C" int bobra_quant_matmul(const void* x, const void* q, const void* scale, void* out,
                                  int m, int n, int k, int route, int splits, int tile, int flags,
                                  int dtype, void* stream) {
  using namespace bobra;
  using namespace bobra::qmm;
  if (m <= 0 || n <= 0 || k <= 0 || n % 16 != 0 || k % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || (flags & ~kFlagPdl) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool pdl = (flags & kFlagPdl) != 0;
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == kRouteF && dtype == kFloat32 && tile == 0) {
    err = launch_f32(x, q, scale, out, m, n, k, splits, pdl, st);
  } else if (route == kRouteD && dtype == kBFloat16 && x_aligned) {
    if (tile == 8) {
      err = launch_decode<8>(x, q, scale, out, m, n, k, splits, pdl, st);
    } else if (tile == 16) {
      err = launch_decode<16>(x, q, scale, out, m, n, k, splits, pdl, st);
    } else if (tile == 32) {
      err = launch_decode<32>(x, q, scale, out, m, n, k, splits, pdl, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (route == kRouteP && dtype == kBFloat16 && x_aligned && splits == 1) {
    if (tile == 2 * kPQBox) {
      err = launch_prefill<2>(x, q, scale, out, m, n, k, pdl, st);
    } else if (tile == kPQBox) {
      err = launch_prefill<1>(x, q, scale, out, m, n, k, pdl, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
