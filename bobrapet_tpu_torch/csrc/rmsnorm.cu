// RMSNorm over the last axis, alone or fused with the residual add before it:
//
//   plain: y = norm(x)
//   add:   s = cast(x + delta); y = norm(s); s and y both written
//   norm(v) = cast(cast(v * rsqrt(mean(v^2) + eps)) * w)
//
// Replaces: bobrapet_tpu/ops/rmsnorm.py:rmsnorm_pallas (_rmsnorm_kernel).
// The add mode also takes the residual add that precedes every norm but
// the first of a forward (bobrapet_tpu/models/llama.py:196,216 and the
// decode step of serving/engine.py), so the sum is not written by one
// launch and read back by the next.
//
// Rounding follows bobrapet_tpu/ops/rmsnorm.py:rmsnorm_reference, which is
// what every model path calls: the normalised row is cast to x's type
// BEFORE the weight multiply, and that product is taken in fp32 and rounded
// once (exact for bf16 * bf16). The Pallas kernel multiplies by the weight
// in fp32 and casts once, which is one bf16 rounding away; following it
// would drift greedy tokens away from the JAX model in bf16. In the add
// mode s is rounded to x's type once, exactly as torch's x + delta, and
// the mean square is taken over the rounded s: the model normalises the
// rounded residual stream.
//
// Bound on the card: bytes. Each element is read once and written once
// (twice in the add mode) and does ~5 flops, far below the ~295 flop/byte
// the H100 needs to be compute bound. [1024, 4096] bf16 moves 16.8 MB in
// the plain mode (5.0 us at 3.35 TB/s) and 33.6 MB in the add mode (10.0
// us); a decode row set [8, 4096] moves under 0.3 MB, far below a launch.
//
// Design: one pass, the row in registers. For the widths the port runs
// (kWidth = 4096, 2048 and the tiny config's 128) a group of kRowThreads
// threads holds one row, each thread 16-byte packs strided by the group so
// that a warp reads contiguous bytes. Every thread issues all its loads (x,
// delta, w) before any arithmetic, so a row costs one memory round, not a
// read, a reduction, then a second read. The sum of squares goes through
// warp shuffles; a group wider than a warp (one row a block) then writes
// one shared slot per warp, passes ONE barrier, and every thread adds its
// row's slots in one fixed order, so reruns give the same bits. A group
// narrower than a warp (several rows a warp) needs no barrier. Any other
// width, or a pointer not on 16 bytes, takes a generic strided loop (two
// passes, kWidth = 0). The entry picks the instance from the width and the
// pointers' alignment alone, never after a failure. At d = 4096, 512
// threads x 8 elements a row timed within 2% of 256 x 16 at the greedy
// prefill's and a decode's rows in both modes (PERF.md), so 256 x 16 is
// the one instance.

#include <stdint.h>

#include "common.cuh"

namespace bobra {

// threads of a block whose rows are narrower than a warp, and of the
// generic loop's block (one row each)
constexpr int kNormNarrowBlock = 128;
constexpr int kNormGenericThreads = 256;

template <int kWidth, int kRowThreads>
struct NormShape {
  static constexpr int kBlock =
      kWidth == 0 ? kNormGenericThreads
                  : (kRowThreads < kNormNarrowBlock ? kNormNarrowBlock : kRowThreads);
  static constexpr int kRowsPerBlock = kWidth == 0 ? 1 : kBlock / kRowThreads;
};

template <typename T>
__device__ __forceinline__ T norm_one(float v, float scale, T w) {
  const T y = from_float<T>(v * scale);  // the reference's cast to x.dtype
  return from_float<T>(to_float(y) * to_float(w));
}

// x + delta rounded to T once, as torch rounds a tensor add
template <typename T>
__device__ __forceinline__ T add_one(T x, T delta) {
  return from_float<T>(to_float(x) + to_float(delta));
}

// The sum over one row's group of kRowThreads threads; every thread of the
// group gets the same bits. Groups of at most a warp are aligned inside it
// (a power of two), so the butterfly stays in the group and the whole warp
// takes part. Wider groups are a whole block: one barrier.
template <int kRowThreads>
__device__ __forceinline__ float row_sum(float v) {
  if constexpr (kRowThreads <= 32) {
#pragma unroll
    for (int off = kRowThreads / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  } else {
    constexpr int kWarps = kRowThreads / 32;
    __shared__ float slots[kWarps];
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += slots[i];
    return total;
  }
}

template <typename T, bool kAdd, int kWidth, int kRowThreads>
__global__ void __launch_bounds__(NormShape<kWidth, kRowThreads>::kBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ delta, const T* __restrict__ w,
               T* __restrict__ sum_out, T* __restrict__ out, long long rows, int d, float eps) {
  using Shape = NormShape<kWidth, kRowThreads>;
  if constexpr (kWidth == 0) {
    // generic: one row a block, two passes; the second recomputes s from
    // x and delta rather than reading back what other threads wrote
    const long long base = static_cast<long long>(blockIdx.x) * d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      T v = x[base + i];
      if constexpr (kAdd) {
        v = add_one(v, delta[base + i]);
        sum_out[base + i] = v;
      }
      const float f = to_float(v);
      ss += f * f;
    }
    ss = row_sum<kRowThreads>(ss);
    const float scale = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      T v = x[base + i];
      if constexpr (kAdd) v = add_one(v, delta[base + i]);
      out[base + i] = norm_one(to_float(v), scale, w[i]);
    }
  } else {
    constexpr int kPack = 16 / sizeof(T);
    static_assert(kWidth % (kRowThreads * kPack) == 0, "a thread holds whole 16-byte packs");
    constexpr int kVecs = kWidth / (kRowThreads * kPack);  // packs a thread holds per tensor
    const int lane = threadIdx.x % kRowThreads;
    const long long row =
        static_cast<long long>(blockIdx.x) * Shape::kRowsPerBlock + threadIdx.x / kRowThreads;
    // a group past the last row still takes part in the warp's shuffles
    const bool live = Shape::kRowsPerBlock == 1 || row < rows;
    const long long base = row * kWidth;

    uint4 xv[kVecs], dv[kAdd ? kVecs : 1], wv[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int col = (j * kRowThreads + lane) * kPack;
      wv[j] = *reinterpret_cast<const uint4*>(w + col);
      xv[j] = live ? *reinterpret_cast<const uint4*>(x + base + col) : make_uint4(0, 0, 0, 0);
      if constexpr (kAdd) {
        dv[j] = live ? *reinterpret_cast<const uint4*>(delta + base + col) : make_uint4(0, 0, 0, 0);
      }
    }

    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      T* xe = reinterpret_cast<T*>(&xv[j]);
      if constexpr (kAdd) {
        const T* de = reinterpret_cast<const T*>(&dv[j]);
#pragma unroll
        for (int e = 0; e < kPack; ++e) xe[e] = add_one(xe[e], de[e]);  // s replaces x
        if (live) {
          *reinterpret_cast<uint4*>(sum_out + base + (j * kRowThreads + lane) * kPack) = xv[j];
        }
      }
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        const float f = to_float(xe[e]);
        ss += f * f;
      }
    }
    ss = row_sum<kRowThreads>(ss);
    const float scale = 1.0f / sqrtf(ss / static_cast<float>(kWidth) + eps);
    if (!live) return;

#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const T* xe = reinterpret_cast<const T*>(&xv[j]);
      const T* we = reinterpret_cast<const T*>(&wv[j]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < kPack; ++e) oe[e] = norm_one(to_float(xe[e]), scale, we[e]);
      *reinterpret_cast<uint4*>(out + base + (j * kRowThreads + lane) * kPack) = o;
    }
  }
}

template <typename T, bool kAdd, int kWidth, int kRowThreads>
void launch_instance(const void* x, const void* delta, const void* w, void* sum_out, void* out,
                     long long rows, int d, float eps, cudaStream_t stream) {
  using Shape = NormShape<kWidth, kRowThreads>;
  const unsigned grid =
      static_cast<unsigned>((rows + Shape::kRowsPerBlock - 1) / Shape::kRowsPerBlock);
  rmsnorm_kernel<T, kAdd, kWidth, kRowThreads><<<grid, Shape::kBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<const T*>(w),
      static_cast<T*>(sum_out), static_cast<T*>(out), rows, d, eps);
}

// The one-pass instances: (width, threads a row), 16 elements a thread;
// a pointer not on 16 bytes or any other width takes the generic loop.
template <typename T, bool kAdd>
void launch_rmsnorm(const void* x, const void* delta, const void* w, void* sum_out, void* out,
                    long long rows, int d, float eps, bool aligned, cudaStream_t stream) {
  if (aligned && d == 4096) {
    launch_instance<T, kAdd, 4096, 256>(x, delta, w, sum_out, out, rows, d, eps, stream);
  } else if (aligned && d == 2048) {
    launch_instance<T, kAdd, 2048, 128>(x, delta, w, sum_out, out, rows, d, eps, stream);
  } else if (aligned && d == 128) {
    launch_instance<T, kAdd, 128, 8>(x, delta, w, sum_out, out, rows, d, eps, stream);
  } else {
    launch_instance<T, kAdd, 0, kNormGenericThreads>(x, delta, w, sum_out, out, rows, d, eps,
                                                     stream);
  }
}

inline bool overlaps(const void* a, const void* b, size_t bytes) {
  if (a == nullptr || b == nullptr) return false;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a), pb = reinterpret_cast<uintptr_t>(b);
  return pa < pb + bytes && pb < pa + bytes;
}

}  // namespace bobra

// x, out (and delta, sum_out in the add mode): [rows, d] contiguous; w:
// [d]; all of one type. delta and sum_out are both null (plain mode) or
// both set (add mode). No two of x, delta, sum_out and out may overlap
// (they are __restrict__), nor an output the weight. Returns the
// cudaError_t of the launch.
extern "C" int bobra_rmsnorm(const void* x, const void* delta, const void* w, void* sum_out,
                             void* out, long long rows, int d, float eps, int dtype,
                             void* stream) {
  using namespace bobra;
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((delta == nullptr) != (sum_out == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t es = dtype == kBFloat16 ? 2 : 4;
  const size_t bytes = static_cast<size_t>(rows) * d * es;
  const void* rows_of[4] = {x, delta, sum_out, out};
  for (int i = 0; i < 4; ++i)
    for (int j = i + 1; j < 4; ++j)
      if (overlaps(rows_of[i], rows_of[j], bytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (overlaps(w, out, d * es) || overlaps(w, sum_out, d * es))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(delta) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(sum_out) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool add = delta != nullptr;
  switch (dtype) {
    case kFloat32:
      if (add) {
        launch_rmsnorm<float, true>(x, delta, w, sum_out, out, rows, d, eps, aligned, st);
      } else {
        launch_rmsnorm<float, false>(x, delta, w, sum_out, out, rows, d, eps, aligned, st);
      }
      break;
    case kBFloat16:
      if (add) {
        launch_rmsnorm<__nv_bfloat16, true>(x, delta, w, sum_out, out, rows, d, eps, aligned,
                                            st);
      } else {
        launch_rmsnorm<__nv_bfloat16, false>(x, delta, w, sum_out, out, rows, d, eps, aligned,
                                             st);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
