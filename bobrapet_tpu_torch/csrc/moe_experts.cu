// Grouped expert products of the sparse-MoE block over the live capacity
// rows: the gate/up product with the dispatch folded into its loads, and
// the down product.
//
//   gate/up: act[e, c] = bf16(silu(f32(bf16(x @ w_gate[e]))) * f32(bf16(x @ w_up[e])))
//            with x = h[src[e, c]], for the live slots c < n_e of each expert
//   down:    out[e, c] = bf16(act[e, c] @ w_down[e]), for the same rows
//
// where n_e = min(counts[e], C) from the route (csrc/moe_dispatch.cu): each
// expert's queue fills from slot 0, so its live rows are slots 0 .. n_e - 1.
// Rows at or past n_e are neither computed nor written; the combine reads
// only kept (t, k) rows, which are exactly these.
//
// Replaces: the expert einsums of bobrapet_tpu/models/moe.py:moe_mlp_block
// (:200 gate and up, :206 down) and the dispatch einsum before them (:197),
// which XLA fuses; the JAX package has no Pallas kernel there. JAX
// multiplies every one of the E x C capacity rows, live or empty; at the
// no-drop capacity serving requires (C = T x k) 7 of Mixtral's 8 rows are
// empty. The rounding points are JAX's: the products summed in fp32 and
// cast to the model's type, the SiLU and the product of gate and up in
// fp32 and cast, the down product summed in fp32 and cast.
//
// Bound on the card: at a prefill (1,024 tokens) operations: 2 x 2,048
// routed rows x 4,096 x 14,336 x 2 for gate/up, half that for down: 0.73
// ms a layer at 989 TFLOP/s. At a decode step (8 tokens, 16 rows) bytes:
// each live expert's weights, 235 MB gate/up and 117 MB down in bf16 (bmm
// reads every expert's, live or not).
//
// Design. bf16 takes one of two routes, which the C entries pick from C,
// never from counts, so the launch holds no host read and can be captured
// in a CUDA graph:
//
// * wide (C > 16: prefills): a tile is 128 capacity rows of one expert by
//   128 output columns (gate/up: of gate and of up, two accumulators; down:
//   256 columns as two accumulators). Grid (row tiles, column tiles,
//   experts), row tiles fastest so the live tiles of one weight tile run
//   together. A block reads counts after the dependency wait and leaves
//   before any load when its first row is past n_e. Two consumer
//   warpgroups take 64 rows each; a producer warpgroup fills a ring of 4
//   stages of 64 K rows. The weight tiles come by TMA ([E x K, N] tensor
//   maps, 64 x 64 boxes, 128-byte swizzle) and are wgmma's MN-major B. The
//   gate/up rows come from h through src by 16-byte cp.async (zeros past
//   n_e) into the 128-byte-swizzled K-major layout of wgmma's A: chunk j of
//   tile row r at byte 128 r + 16 (j ^ (r & 7)), the pattern TMA writes
//   and the descriptor reads (TMA cannot gather rows). The down rows are
//   act's rows of one expert, contiguous: TMA. Each loading thread's
//   cp.async completion arrives on the stage's full barrier
//   (cp.async.mbarrier.arrive.noinc) beside the TMA bytes, so the ring runs
//   its whole depth ahead; a consumer fences the landed rows for the async
//   proxy before its wgmma. wgmma keeps one stage in flight.
// * narrow (C <= 16: decode steps): the operands are swapped, as route D
//   of csrc/quant_matmul.cu does: 128 weight columns of a block are two
//   m64 halves of wgmma's A (MN-major, trans-a) and the at most 16 rows its
//   N = 16 (rows past n_e are zeros and are not written). A block streams
//   one expert's column tile over all of K; two blocks fit an SM. An expert
//   with no live row reads none of its weights.
//
// The wide route and fp32 size the grid's row tiles by min(C, T): the
// route gives a token's k experts once each, so no expert has more than T
// live rows.
// Epilogues take JAX's rounding points and write only live rows. fp32 (the
// cross-checks) runs exact SIMT FMAs (no TF32) over the same live-tile
// loop. Every kernel launches with programmatic dependent launch: it lets
// the next kernel start launching at once, and reads counts, src and the
// rows, and writes anything, only after griddepcontrol.wait.

#include <stdint.h>

#include "attention_core.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace bobra {
namespace moe {
namespace experts {

using bf16 = __nv_bfloat16;
using hopper::smem_addr;

constexpr int kBK = 64;                        // K rows of a stage: 128 bytes of bf16
constexpr int kBoxCols = 64;                   // weight columns of a TMA box (128 bytes)
constexpr int kBoxBytes = kBK * kBoxCols * 2;  // 8 KB
constexpr int kRowBytes = kBK * 2;             // one row of a stage

// wide route: two consumer warpgroups of 64 rows and a producer warpgroup
constexpr int kWideRows = 128;
constexpr int kWideStages = 4;
constexpr int kWideThreads = 3 * 128;

// narrow route: one consumer warpgroup and a producer warp
constexpr int kNarrowMaxRows = 16;
constexpr int kNarrowHalves = 2;               // m64 halves: 128 weight columns a block
constexpr int kNarrowThreads = 128 + 32;
constexpr int kUpStages = 3;                   // 34 KB a stage: two blocks an SM
constexpr int kDownStages = 6;                 // 18 KB a stage

// fp32: a block of 256 threads, 32 rows x 64 columns, K in chunks of 32
constexpr int kF32Rows = 32;
constexpr int kF32Cols = 64;
constexpr int kF32K = 32;
constexpr int kF32Threads = 256;

// silu(g) * u in fp32 as torch computes it (x / (1 + exp(-x)), each op
// rounded on its own)
__device__ __forceinline__ float swiglu(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), u);
}

// JAX's rounding points: g and u cast to bf16 first, the result once more
__device__ __forceinline__ float swiglu_bf16(float g, float u) {
  return swiglu(__bfloat162float(__float2bfloat16_rn(g)),
                __bfloat162float(__float2bfloat16_rn(u)));
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------------------
// wide route

template <bool kUp>
struct Wide {
  static constexpr int kA = kWideRows * kRowBytes;            // 16 KB of rows
  static constexpr int kStage = kA + 4 * kBoxBytes;           // and four weight boxes
  static constexpr int kRing = kWideStages * kStage;
  static constexpr int kBytes = 1024 + kRing + 2 * kWideStages * 8 + kWideRows * 4;
  static constexpr int kTileCols = (kUp ? 2 : 4) * kBoxCols;  // output columns of a tile
};

// kUp: gate/up (w0 = gate, w1 = up; rows gathered from h through src); else
// down (w0 = w1 = down, rows of act by TMA through amap). Warps 0-7 multiply,
// 8-11 load.
template <bool kUp>
__global__ void __launch_bounds__(kWideThreads, 1)
moe_wide_kernel(const __grid_constant__ CUtensorMap w0map,
                const __grid_constant__ CUtensorMap w1map,
                const __grid_constant__ CUtensorMap amap, const bf16* __restrict__ h,
                const int* __restrict__ src, const int* __restrict__ counts,
                bf16* __restrict__ out, int capacity, int k_dim, int n_dim) {
  using L = Wide<kUp>;
  constexpr int S = kWideStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kRing);
  uint64_t* empty = full + S;
  int* tok = reinterpret_cast<int*>(empty + S);

  const int e = blockIdx.z, m0 = blockIdx.x * kWideRows, n0 = blockIdx.y * L::kTileCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  hopper::launch_dependents();
  hopper::grid_dependency_wait();
  const int live = min(counts[e], capacity);
  if (m0 >= live) return;  // no live row: nothing loaded, nothing written
  const int rows = min(kWideRows, live - m0);
  const int k_tiles = k_dim / kBK;

  if (tid == 0) {
    hopper::prefetch_tensormap(&w0map);
    hopper::prefetch_tensormap(&w1map);
    if constexpr (!kUp) hopper::prefetch_tensormap(&amap);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // the TMA thread's arrival, and each loading thread's cp.async completion
      hopper::mbar_init(&full[s], kUp ? 1 + 128 : 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  if constexpr (kUp) {
    if (tid < kWideRows) tok[tid] = tid < rows ? src[static_cast<size_t>(e) * capacity + m0 + tid] : -1;
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::setmaxnreg_dec<56>();
    const int p = tid - 256;
    if constexpr (kUp) {
      // thread p copies chunk p & 7 of tile rows (p >> 3) + 16 j
      const int chunk = p & 7, r0 = p >> 3;
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % S;
        hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = ring + s * L::kStage;
        if (p == 0) {
          const int krow = e * k_dim + i * kBK;
          hopper::mbar_expect_tx(&full[s], 4 * kBoxBytes);
          hopper::tma_load_2d(st + L::kA, &w0map, n0, krow, &full[s]);
          hopper::tma_load_2d(st + L::kA + kBoxBytes, &w0map, n0 + kBoxCols, krow, &full[s]);
          hopper::tma_load_2d(st + L::kA + 2 * kBoxBytes, &w1map, n0, krow, &full[s]);
          hopper::tma_load_2d(st + L::kA + 3 * kBoxBytes, &w1map, n0 + kBoxCols, krow, &full[s]);
        }
        const uint32_t a = smem_addr(st);
        const int k0 = i * kBK + 8 * chunk;
#pragma unroll
        for (int j = 0; j < kWideRows / 16; ++j) {
          const int r = r0 + 16 * j;
          const int t = tok[r];
          attn::cp_async16(a + r * kRowBytes + ((chunk ^ (r & 7)) << 4),
                           h + static_cast<size_t>(t < 0 ? 0 : t) * k_dim + k0, t >= 0);
        }
        hopper::cp_async_mbar_arrive(&full[s]);
      }
      attn::cp_async_commit();
      attn::cp_async_wait<0>();
    } else if (p == 0) {
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % S;
        hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = ring + s * L::kStage;
        const int krow = e * k_dim + i * kBK;
        hopper::mbar_expect_tx(&full[s], L::kStage);
        hopper::tma_load_2d(st, &amap, i * kBK, e * capacity + m0, &full[s]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          hopper::tma_load_2d(st + L::kA + b * kBoxBytes, &w0map, n0 + b * kBoxCols, krow, &full[s]);
        }
      }
    }
    __syncwarp();
  } else {
    hopper::setmaxnreg_inc<224>();
    const int wg = warp >> 2;
    float acc0[64], acc1[64];
    zero(acc0);
    zero(acc1);
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % S;
      hopper::mbar_wait(&full[s], (i / S) & 1);
      // the rows landed by cp.async (the generic proxy): ordered before
      // wgmma's reads (the async proxy)
      if constexpr (kUp) hopper::fence_proxy_async();
      const uint32_t st = smem_addr(ring + s * L::kStage);
      const uint32_t a = st + wg * 64 * kRowBytes;
      const uint32_t b = st + L::kA;
      hopper::wgmma_fence_operands(acc0);
      hopper::wgmma_fence_operands(acc1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: K-major rows; B: MN-major boxes of 64 columns, 8 KB apart
        const uint64_t da = hopper::wgmma_desc(a + 32 * kk, 16, 1024);
        hopper::wgmma_m64n128k16_ss<0, 1>(
            acc0, da, hopper::wgmma_desc(b + 2048 * kk, kBoxBytes, 1024), 1);
        hopper::wgmma_m64n128k16_ss<0, 1>(
            acc1, da, hopper::wgmma_desc(b + 2 * kBoxBytes + 2048 * kk, kBoxBytes, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_fence_operands(acc0);
      hopper::wgmma_fence_operands(acc1);
      hopper::wgmma_wait<1>();  // the stage before this one is read
      hopper::wgmma_fence_operands(acc0);
      hopper::wgmma_fence_operands(acc1);
      if (i > 0) {
        hopper::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % S]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::wgmma_fence_operands(acc0);
    hopper::wgmma_fence_operands(acc1);
    // acc[4j + 2hh + x]: tile row 64 wg + 16 w4 + g + 8 hh, column 8j + 2q + x
    const int w4 = warp & 3, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wg * 64 + 16 * w4 + g + 8 * hh;
      if (r >= rows) continue;
      bf16* dst = out + (static_cast<size_t>(e) * capacity + m0 + r) * n_dim + n0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * q;
        const int x = 4 * j + 2 * hh;
        if constexpr (kUp) {
          if (n0 + c < n_dim) {
            *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
                swiglu_bf16(acc0[x], acc1[x]), swiglu_bf16(acc0[x + 1], acc1[x + 1]));
          }
        } else {
          if (n0 + c < n_dim) {
            *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(acc0[x], acc0[x + 1]);
          }
          if (n0 + 128 + c < n_dim) {
            *reinterpret_cast<__nv_bfloat162*>(dst + 128 + c) =
                __floats2bfloat162_rn(acc1[x], acc1[x + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// narrow route

template <bool kUp>
struct Narrow {
  static constexpr int N = kNarrowMaxRows;
  static constexpr int kMats = kUp ? 2 : 1;
  static constexpr int kBoxes = kMats * kNarrowHalves;
  static constexpr int kW = kBoxes * kBoxBytes;
  static constexpr int kRows = N * kRowBytes;                 // 2 KB: 1024-aligned
  static constexpr int kStage = kW + kRows;
  static constexpr int kStages = kUp ? kUpStages : kDownStages;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBytes = 1024 + kRing + 2 * kStages * 8 + N * 4;
  static constexpr int kTileCols = kNarrowHalves * kBoxCols;  // 128 weight columns
};

// Grid (column tiles, experts). The weight is A (MN-major boxes, trans-a),
// the rows are B (K-major). Warps 0-3 multiply, warp 4 loads.
template <bool kUp>
__global__ void __launch_bounds__(kNarrowThreads)
moe_narrow_kernel(const __grid_constant__ CUtensorMap w0map,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap amap, const bf16* __restrict__ h,
                  const int* __restrict__ src, const int* __restrict__ counts,
                  bf16* __restrict__ out, int capacity, int k_dim, int n_dim) {
  using L = Narrow<kUp>;
  constexpr int N = L::N;
  constexpr int S = L::kStages;
  constexpr int H = kNarrowHalves;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kRing);
  uint64_t* empty = full + S;
  int* tok = reinterpret_cast<int*>(empty + S);

  const int e = blockIdx.y, n0 = blockIdx.x * L::kTileCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  hopper::launch_dependents();
  hopper::grid_dependency_wait();
  const int live = min(counts[e], capacity);
  if (live <= 0) return;  // an expert with no live row reads none of its weights
  const int k_tiles = k_dim / kBK;

  if (tid == 0) {
    hopper::prefetch_tensormap(&w0map);
    if constexpr (kUp) hopper::prefetch_tensormap(&w1map);
    if constexpr (!kUp) hopper::prefetch_tensormap(&amap);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // the TMA thread's arrival, and each lane's cp.async completion (kUp)
      hopper::mbar_init(&full[s], kUp ? 1 + 32 : 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  if constexpr (kUp) {
    if (tid < N) tok[tid] = tid < live ? src[static_cast<size_t>(e) * capacity + tid] : -1;
  }
  __syncthreads();

  if (warp == 4) {
    if constexpr (kUp) {
      // lane copies chunk lane & 7 of rows (lane >> 3) + 4 j
      const int chunk = lane & 7, r0 = lane >> 3;
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % S;
        hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = ring + s * L::kStage;
        if (lane == 0) {
          const int krow = e * k_dim + i * kBK;
          hopper::mbar_expect_tx(&full[s], L::kW);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int hf = 0; hf < H; ++hf) {
              hopper::tma_load_2d(st + (m * H + hf) * kBoxBytes, m == 0 ? &w0map : &w1map,
                                  n0 + hf * kBoxCols, krow, &full[s]);
            }
          }
        }
        const uint32_t rows = smem_addr(st + L::kW);
        const int k0 = i * kBK + 8 * chunk;
#pragma unroll
        for (int j = 0; j < N / 4; ++j) {
          const int r = r0 + 4 * j;
          const int t = tok[r];
          attn::cp_async16(rows + r * kRowBytes + ((chunk ^ (r & 7)) << 4),
                           h + static_cast<size_t>(t < 0 ? 0 : t) * k_dim + k0, t >= 0);
        }
        hopper::cp_async_mbar_arrive(&full[s]);
      }
      attn::cp_async_commit();
      attn::cp_async_wait<0>();
    } else if (lane == 0) {
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % S;
        hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = ring + s * L::kStage;
        const int krow = e * k_dim + i * kBK;
        hopper::mbar_expect_tx(&full[s], L::kStage);
#pragma unroll
        for (int hf = 0; hf < H; ++hf) {
          hopper::tma_load_2d(st + hf * kBoxBytes, &w0map, n0 + hf * kBoxCols, krow, &full[s]);
        }
        hopper::tma_load_2d(st + L::kW, &amap, i * kBK, e * capacity, &full[s]);
      }
    }
    __syncwarp();
  } else {
    float acc[L::kBoxes][N / 2];
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b) zero(acc[b]);
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % S;
      hopper::mbar_wait(&full[s], (i / S) & 1);
      if constexpr (kUp) hopper::fence_proxy_async();
      const uint32_t st = smem_addr(ring + s * L::kStage);
      const uint32_t rows = st + L::kW;
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) hopper::wgmma_fence_operands(acc[b]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = hopper::wgmma_desc(rows + 32 * kk, 16, 1024);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          hopper::wgmma_m64n16k16_ss<1, 0>(
              acc[b], hopper::wgmma_desc(st + b * kBoxBytes + 2048 * kk, kBoxBytes, 1024), db, 1);
        }
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) hopper::wgmma_fence_operands(acc[b]);
      hopper::wgmma_wait<1>();
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) hopper::wgmma_fence_operands(acc[b]);
      if (i > 0) {
        hopper::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % S]);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b) hopper::wgmma_fence_operands(acc[b]);
    // acc[b][4j + 2hh + x]: weight column 64 half + 16 warp + g + 8 hh of the
    // tile, row 8j + 2q + x
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int hf = 0; hf < H; ++hf) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = n0 + hf * kBoxCols + 16 * warp + g + 8 * hh;
        if (c >= n_dim) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int r = 8 * j + 2 * q + x;
            if (r >= live) continue;
            const int v = 4 * j + 2 * hh + x;
            float y;
            if constexpr (kUp) {
              y = swiglu_bf16(acc[hf][v], acc[H + hf][v]);
            } else {
              y = acc[hf][v];
            }
            out[(static_cast<size_t>(e) * capacity + r) * n_dim + c] = __float2bfloat16_rn(y);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: exact SIMT FMAs

// Grid (row tiles, column tiles, experts). Thread (ty = tid / 16, tx = tid
// % 16) takes rows 2 ty, 2 ty + 1 and columns 4 tx .. 4 tx + 3 of the tile.
// kUp: x = h, rows through src, w0 = gate, w1 = up; else x = act (the
// expert's rows), w0 = down.
template <bool kUp>
__global__ void __launch_bounds__(kF32Threads)
moe_f32_kernel(const float* __restrict__ x, const int* __restrict__ src,
               const int* __restrict__ counts, const float* __restrict__ w0,
               const float* __restrict__ w1, float* __restrict__ out, int capacity, int k_dim,
               int n_dim) {
  constexpr int kMats = kUp ? 2 : 1;
  constexpr int kPad = kF32Rows + 2;  // keeps the float2 reads aligned, the stores 2-way
  __shared__ __align__(16) float as[kF32K][kPad];
  __shared__ __align__(16) float bs[kMats][kF32K][kF32Cols];
  __shared__ int tok[kF32Rows];

  const int e = blockIdx.z, m0 = blockIdx.x * kF32Rows, n0 = blockIdx.y * kF32Cols;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  hopper::launch_dependents();
  hopper::grid_dependency_wait();
  const int live = min(counts[e], capacity);
  if (m0 >= live) return;
  const int rows = min(kF32Rows, live - m0);
  if (tid < kF32Rows) {
    const size_t slot = static_cast<size_t>(e) * capacity + m0 + tid;
    tok[tid] = tid >= rows ? -1 : kUp ? src[slot] : static_cast<int>(slot);
  }
  float acc[kMats][2][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][r][c] = 0.f;
    }
  }
  for (int k0 = 0; k0 < k_dim; k0 += kF32K) {
    __syncthreads();  // tok is written, the last chunk consumed
    for (int i = tid; i < kF32Rows * kF32K; i += kF32Threads) {
      const int r = i / kF32K, kc = i % kF32K, k = k0 + kc, t = tok[r];
      as[kc][r] = (t >= 0 && k < k_dim) ? x[static_cast<size_t>(t) * k_dim + k] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      for (int i = tid; i < kF32K * kF32Cols; i += kF32Threads) {
        const int kr = i / kF32Cols, c = i % kF32Cols, k = k0 + kr, n = n0 + c;
        bs[m][kr][c] = (k < k_dim && n < n_dim)
                           ? (m == 0 ? w0 : w1)[(static_cast<size_t>(e) * k_dim + k) * n_dim + n]
                           : 0.f;
      }
    }
    __syncthreads();
    // a whole chunk: past k_dim both tiles hold zeros, which add nothing
#pragma unroll
    for (int kc = 0; kc < kF32K; ++kc) {
      const float2 a = *reinterpret_cast<const float2*>(&as[kc][2 * ty]);
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float4 b = *reinterpret_cast<const float4*>(&bs[m][kc][4 * tx]);
        acc[m][0][0] = fmaf(a.x, b.x, acc[m][0][0]);
        acc[m][0][1] = fmaf(a.x, b.y, acc[m][0][1]);
        acc[m][0][2] = fmaf(a.x, b.z, acc[m][0][2]);
        acc[m][0][3] = fmaf(a.x, b.w, acc[m][0][3]);
        acc[m][1][0] = fmaf(a.y, b.x, acc[m][1][0]);
        acc[m][1][1] = fmaf(a.y, b.y, acc[m][1][1]);
        acc[m][1][2] = fmaf(a.y, b.z, acc[m][1][2]);
        acc[m][1][3] = fmaf(a.y, b.w, acc[m][1][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 2 * ty + r;
    if (row >= rows) continue;
    float* dst = out + (static_cast<size_t>(e) * capacity + m0 + row) * n_dim;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (n < n_dim) dst[n] = kUp ? swiglu(acc[0][r][c], acc[kMats - 1][r][c]) : acc[0][r][c];
    }
  }
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

// a bf16 weight stack [E, K, N] as one [E x K, N] map of 64 x 64 boxes
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int n_experts, int k, int n) {
  return hopper::encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, n,
                           static_cast<uint64_t>(n_experts) * k, 2ULL * n, kBoxCols, kBK,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// rows [E x C, K] in boxes of 64 K columns by `rows` rows
inline cudaError_t rows_map(CUtensorMap* map, const void* a, int n_experts, int capacity, int k,
                            int rows) {
  return hopper::encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, k,
                           static_cast<uint64_t>(n_experts) * capacity, 2ULL * k, kBK, rows,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// one bf16 product: w0 / w1 over [E, K, N]; `a` the rows of act (down).
// `rows`: the most live rows an expert can have, min(capacity, tokens),
// which sizes the wide route's row tiles
template <bool kUp>
cudaError_t launch_bf16(const void* h, const void* src, const void* counts, const void* w0,
                        const void* w1, const void* a, void* out, int n_experts, int capacity,
                        int rows, int k, int n, cudaStream_t st) {
  const bool narrow = capacity <= kNarrowMaxRows;
  CUtensorMap w0map, w1map, amap;
  cudaError_t err = weight_map(&w0map, w0, n_experts, k, n);
  if (err != cudaSuccess) return err;
  err = weight_map(&w1map, kUp ? w1 : w0, n_experts, k, n);
  if (err != cudaSuccess) return err;
  if (kUp) {
    amap = w0map;  // unused
  } else {
    err = rows_map(&amap, a, n_experts, capacity, k, narrow ? kNarrowMaxRows : kWideRows);
    if (err != cudaSuccess) return err;
  }
  const bf16* hp = static_cast<const bf16*>(h);
  const int* sp = static_cast<const int*>(src);
  const int* cp = static_cast<const int*>(counts);
  bf16* op = static_cast<bf16*>(out);
  if (narrow) {
    using L = Narrow<kUp>;
    static bool ready[64] = {};
    err = allow_smem(moe_narrow_kernel<kUp>, L::kBytes, ready);
    if (err != cudaSuccess) return err;
    hopper::PdlLaunch l(dim3((n + L::kTileCols - 1) / L::kTileCols, n_experts, 1),
                        kNarrowThreads, L::kBytes, st);
    return cudaLaunchKernelEx(&l.cfg, moe_narrow_kernel<kUp>, w0map, w1map, amap, hp, sp, cp, op,
                              capacity, k, n);
  }
  using L = Wide<kUp>;
  static bool ready[64] = {};
  err = allow_smem(moe_wide_kernel<kUp>, L::kBytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kWideRows - 1) / kWideRows, (n + L::kTileCols - 1) / L::kTileCols,
                  n_experts);
  hopper::PdlLaunch l(grid, kWideThreads, L::kBytes, st);
  return cudaLaunchKernelEx(&l.cfg, moe_wide_kernel<kUp>, w0map, w1map, amap, hp, sp, cp, op,
                            capacity, k, n);
}

template <bool kUp>
cudaError_t launch_f32(const void* x, const void* src, const void* counts, const void* w0,
                       const void* w1, void* out, int n_experts, int capacity, int rows, int k,
                       int n, cudaStream_t st) {
  const dim3 grid((rows + kF32Rows - 1) / kF32Rows, (n + kF32Cols - 1) / kF32Cols, n_experts);
  hopper::PdlLaunch l(grid, kF32Threads, 0, st);
  return cudaLaunchKernelEx(&l.cfg, moe_f32_kernel<kUp>, static_cast<const float*>(x),
                            static_cast<const int*>(src), static_cast<const int*>(counts),
                            static_cast<const float*>(w0), static_cast<const float*>(w1),
                            static_cast<float*>(out), capacity, k, n);
}

// what both entries refuse: sizes, grids, other types, and for bf16 widths
// off 64 or pointers off 16 bytes
inline bool refuse(int tokens, int n_experts, int capacity, int k, int n, int dtype,
                   const void* const* ptrs, int n_ptrs) {
  if (tokens < 1 || n_experts < 1 || n_experts > 65535 || capacity < 1 || k < 1 || n < 1) {
    return true;
  }
  if (static_cast<long long>(n_experts) * capacity > 0x7fffffffLL ||
      static_cast<long long>(n_experts) * k > 0x7fffffffLL) {
    return true;
  }
  if (dtype == kFloat32) return (n + kF32Cols - 1) / kF32Cols > 65535;
  if (dtype != kBFloat16 || k % kBK != 0 || n % kBoxCols != 0) return true;
  if ((n + 2 * kBoxCols - 1) / (2 * kBoxCols) > 65535) return true;
  for (int i = 0; i < n_ptrs; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return true;
  }
  return false;
}

}  // namespace experts
}  // namespace moe
}  // namespace bobra

// act [n_experts, capacity, f] = the gate/up product of the live rows: h
// [tokens, d] and w_gate, w_up [n_experts, d, f], all of one type (float32
// or bfloat16) and contiguous on one card; src int32 [n_experts, capacity]
// and counts int32 [n_experts] from bobra_moe_route (a token in at most one
// slot of an expert, so no expert has more than `tokens` live rows: the grid
// holds no row tile past min(capacity, tokens)). bfloat16 takes the narrow
// route at capacity <= 16, else the wide route, and needs d and f multiples
// of 64 and the pointers 16-byte aligned. Launched with programmatic
// dependent launch. Rows of act at or past min(counts[e], capacity) are not
// written. Returns the cudaError_t of the launch.
extern "C" int bobra_moe_gate_up(const void* h, const void* src, const void* counts,
                                 const void* w_gate, const void* w_up, void* act, int tokens,
                                 int n_experts, int capacity, int d, int f, int dtype,
                                 void* stream) {
  using namespace bobra::moe::experts;
  const void* ptrs[4] = {h, w_gate, w_up, act};
  if (refuse(tokens, n_experts, capacity, d, f, dtype, ptrs, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = capacity < tokens ? capacity : tokens;
  const cudaError_t err =
      dtype == bobra::kFloat32
          ? launch_f32<true>(h, src, counts, w_gate, w_up, act, n_experts, capacity, rows, d, f,
                             st)
          : launch_bf16<true>(h, src, counts, w_gate, w_up, nullptr, act, n_experts, capacity,
                              rows, d, f, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out [n_experts, capacity, d] = act [n_experts, capacity, f] @ w_down
// [n_experts, f, d] on the live rows (counts from a route of `tokens`
// tokens, as above), one type, contiguous on one card. The routes, the
// launch and the refusals as bobra_moe_gate_up's, with f and d for d and f.
// Rows of out at or past min(counts[e], capacity) are not written.
extern "C" int bobra_moe_down(const void* act, const void* counts, const void* w_down, void* out,
                              int tokens, int n_experts, int capacity, int f, int d, int dtype,
                              void* stream) {
  using namespace bobra::moe::experts;
  const void* ptrs[3] = {act, w_down, out};
  if (refuse(tokens, n_experts, capacity, f, d, dtype, ptrs, 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = capacity < tokens ? capacity : tokens;
  const cudaError_t err =
      dtype == bobra::kFloat32
          ? launch_f32<false>(act, nullptr, counts, w_down, w_down, out, n_experts, capacity,
                              rows, f, d, st)
          : launch_bf16<false>(nullptr, nullptr, counts, w_down, nullptr, act, out, n_experts,
                               capacity, rows, f, d, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
