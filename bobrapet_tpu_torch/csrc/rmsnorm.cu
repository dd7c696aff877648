// RMSNorm over the last axis: y = cast(cast(x * rsqrt(mean(x^2) + eps)) * w).
//
// Replaces: bobrapet_tpu/ops/rmsnorm.py:rmsnorm_pallas (_rmsnorm_kernel).
// Rounding follows bobrapet_tpu/ops/rmsnorm.py:rmsnorm_reference, which is
// what every model path calls: the normalised row is cast to x's type
// BEFORE the weight multiply, and that product is taken in fp32 and rounded
// once (exact for bf16 * bf16). The Pallas kernel multiplies by the weight
// in fp32 and casts once, which is one bf16 rounding away; following it
// would drift greedy tokens away from the JAX model in bf16.
//
// Bound on the card: bytes. Each element is read once and written once and
// does ~4 flops, far below the ~295 flop/byte the H100 needs to be compute
// bound; [1024, 4096] bf16 moves 16.8 MB, 5.0 us at 3.35 TB/s.
//
// Design: one block of 256 threads per row; 16-byte vector loads and
// stores where the width allows (8 bf16 or 4 fp32 per access), a scalar
// loop otherwise. Pass 1 sums x^2 in fp32 (warp shuffles, then one shared
// slot per warp); pass 2 reads the row again, which a 4096-wide row finds
// in L1/L2, so device memory sees one read and one write per element.

#include <stdint.h>

#include "common.cuh"

namespace bobra {

constexpr int kNormThreads = 256;

template <typename T>
__device__ __forceinline__ T norm_one(float xv, float scale, T w) {
  const T y = from_float<T>(xv * scale);  // the reference's cast to x.dtype
  return from_float<T>(to_float(y) * to_float(w));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int d, float eps) {
  constexpr int kPack = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  if constexpr (kVec) {
    for (int i = threadIdx.x * kPack; i < d; i += kNormThreads * kPack) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPack; ++j) {
        const float v = to_float(e[j]);
        ss += v * v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kNormThreads) {
      const float v = to_float(xr[i]);
      ss += v * v;
    }
  }
  ss = block_sum(ss);
  const float scale = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  if constexpr (kVec) {
    for (int i = threadIdx.x * kPack; i < d; i += kNormThreads * kPack) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* we = reinterpret_cast<const T*>(&wraw);
      uint4 oraw;
      T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < kPack; ++j) oe[j] = norm_one(to_float(xe[j]), scale, we[j]);
      *reinterpret_cast<uint4*>(orow + i) = oraw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kNormThreads) {
      orow[i] = norm_one(to_float(xr[i]), scale, w[i]);
    }
  }
}

template <typename T>
void launch_rmsnorm(const void* x, const void* w, void* out, long long rows, int d,
                    float eps, cudaStream_t stream) {
  constexpr int kPack = 16 / sizeof(T);
  const bool vec = d % kPack == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(rows);
  if (vec) {
    rmsnorm_kernel<T, true><<<grid, kNormThreads, 0, stream>>>(xp, wp, op, d, eps);
  } else {
    rmsnorm_kernel<T, false><<<grid, kNormThreads, 0, stream>>>(xp, wp, op, d, eps);
  }
}

}  // namespace bobra

// x, out: [rows, d] contiguous; w: [d]; all of one type. Returns the
// cudaError_t of the launch.
extern "C" int bobra_rmsnorm(const void* x, const void* w, void* out, long long rows, int d,
                             float eps, int dtype, void* stream) {
  using namespace bobra;
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: launch_rmsnorm<float>(x, w, out, rows, d, eps, st); break;
    case kBFloat16: launch_rmsnorm<__nv_bfloat16>(x, w, out, rows, d, eps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
