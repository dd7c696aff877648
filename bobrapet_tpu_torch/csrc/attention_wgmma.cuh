// Shared pieces of the warp-specialised bf16 attention kernels for sm_90a:
// the training forward (flash_attention.cu, flash_fwd_lse_kernel) and the
// backward (flash_attention_bwd.cu). Both run persistent blocks of two
// consumer warpgroups and one producer warpgroup, take their work items in
// one order, keep 64-row tiles that TMA writes swizzled and wgmma reads, and
// feed wgmma the same products. Plain CUDA with no PyTorch header.
#pragma once

#include <stdint.h>

#include "attention_core.cuh"
#include "hopper.cuh"

namespace bobra {
namespace attn {

constexpr int kBwdWgRows = 64;     // rows of a consumer warpgroup: wgmma's M
constexpr int kBwdConsumers = 2;   // consumer warpgroups a block
constexpr int kBwdTile = 64;       // rows of a ring tile: wgmma's N
// keys of a dk/dv work item, packed rows of a dq (or forward) work item
constexpr int kBwdItemRows = kBwdWgRows * kBwdConsumers;
// the consumer warpgroups, then the producer warpgroup (its first warp loads)
constexpr int kBwdWsThreads = (kBwdConsumers + 1) * 128;
constexpr int kBwdProducerRegs = 40;
constexpr int kBwdConsumerRegs = 232;
static_assert(128 * kBwdProducerRegs + kBwdConsumers * 128 * kBwdConsumerRegs <= 65536,
              "the register file of one SM");

// A [64][D] bf16 tile in shared memory: D / kCols boxes of 64 rows by kCols
// columns, each row swizzled over its kRowBytes (128 at D = 128, 64 at D =
// 32) as TMA writes it and wgmma reads it.
template <int D>
struct BwdTile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kBox = kBwdTile * kRowBytes;
  static constexpr int kBytes = kBoxes * kBox;
  static constexpr int kSbo = 8 * kRowBytes;  // between 8-row groups
  static constexpr int kStepsPerBox = kCols / 16;
  // the tile as a K-major operand (its rows wgmma's M or N, the head dim
  // K): k16 step kk, 32 bytes along a box row
  __device__ static uint64_t kmajor(uint32_t tile, int kk) {
    return hopper::wgmma_desc_sw<kRowBytes>(
        tile + (kk / kStepsPerBox) * kBox + 32 * (kk % kStepsPerBox), 16, kSbo);
  }
  // the tile as an MN-major B (its rows K, the head dim N; the boxes kBox
  // apart): k16 step kk, 16 rows on
  __device__ static uint64_t mnmajor(uint32_t tile, int kk) {
    return hopper::wgmma_desc_sw<kRowBytes>(tile + kk * 16 * kRowBytes, kBox, kSbo);
  }
};

// The persistent order: the items come heaviest first (dk/dv: key tiles in
// ascending order; dq and the forward: row tiles in descending order), and
// in round r block blk takes item r grid + blk on even rounds, r grid +
// grid - 1 - blk on odd ones; -1 past the last item.
// ops/attention.py:bwd_block_items mirrors it.
__device__ __forceinline__ int bwd_item(int r, int items) {
  const int blk = blockIdx.x, grid = gridDim.x;
  const int i = r * grid + ((r & 1) ? grid - 1 - blk : blk);
  return i < items ? i : -1;
}

// 2^x in one MUFU instruction, with no branch: a masked element passes
// -inf and gets 0 (a select ahead of exp2f compiled to a branch an element)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void zero_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// (a, b) as a bf16 pair in one part, or as hi + lo parts
template <int PARTS>
__device__ __forceinline__ void to_parts(float a, float b, uint32_t (&w)[PARTS]) {
  if constexpr (PARTS == 1) {
    w[0] = bf16x2_bits(__floats2bfloat162_rn(a, b));
  } else {
    split_bf16x2(a, b, w[0], w[1]);
  }
}

// the 64 x N accumulator of a score product as wgmma A fragments: k16
// step kk holds columns 16kk.. (acc[4j + 2hh + x] is row 16 w4 + g + 8 hh,
// column 8j + 2 qd + x; fragment register i the pair at acc[8kk + 2i])
template <int PARTS, int R, int KS>
__device__ __forceinline__ void a_fragments(const float (&acc)[R], uint32_t (&a)[PARTS][KS][4]) {
  static_assert(R == 8 * KS, "two columns a register, 16 a k16 step");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w[PARTS];
      to_parts<PARTS>(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1], w);
#pragma unroll
      for (int part = 0; part < PARTS; ++part) a[part][kk][i] = w[part];
    }
  }
}

// acc += A B over the 64 rows of an MN-major B tile, A in registers
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n128k16_rs_tb<1>(d, a, b, 1);
}
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n32k16_rs_tb<1>(d, a, b, 1);
}

// d += A B over KS k16 steps of an MN-major B tile from row 16 k0
template <int D, int PARTS, int KS>
__device__ __forceinline__ void accumulate_rs(float (&d)[D / 2], const uint32_t (&a)[PARTS][KS][4],
                                              uint32_t b_tile, int k0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      mma_rs(d, a[part][kk], BwdTile<D>::mnmajor(b_tile, k0 + kk));
    }
  }
}

// acc (+)= A B^T over a k16 step, A and B K-major; N = 64 or 32 rows of B
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  hopper::wgmma_m64n64k16_ss<0, 0>(d, a, b, scale_d);
}
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  hopper::wgmma_m64n32k16_ss<0, 0>(d, a, b, scale_d);
}

// Host: the 4-D tensor maps of these kernels, innermost dimension first.
// q-like [B, Sq, Hq, D] (heads packed; query and batch strides in
// elements): a box is kCols of the head dim, the group's heads and 64 /
// group queries, so it lands in packed row order (row r: query r / group,
// head r % group of the kv head's group). k-like [B, Sk, Hkv, D]: a box is
// kCols of the head dim of one head over 64 keys. Rows past the tensor
// arrive as zeros.
template <int D>
inline cudaError_t encode_q_map(CUtensorMap* map, const void* base, int b, int sq, int hq,
                                int group, long long q_ss, long long q_sb) {
  using L = BwdTile<D>;
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(hq),
                            static_cast<uint64_t>(sq), static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(q_ss) * 2,
                               static_cast<uint64_t>(q_sb) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(L::kCols), static_cast<uint32_t>(group),
                           static_cast<uint32_t>(kBwdTile / group), 1};
  return hopper::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int D>
inline cudaError_t encode_kv_map(CUtensorMap* map, const void* base, int b, int sk, int hkv,
                                 long long k_ss, long long k_sb) {
  using L = BwdTile<D>;
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(hkv),
                            static_cast<uint64_t>(sk), static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(k_ss) * 2,
                               static_cast<uint64_t>(k_sb) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(L::kCols), 1, kBwdTile, 1};
  return hopper::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace attn
}  // namespace bobra
