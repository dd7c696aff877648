// RMSNorm backward: the gradient of csrc/rmsnorm.cu's two modes.
//
//   forward:  n = cast(x * scale), scale = rsqrt(mean(x^2) + eps); y = cast(n * w)
//   backward: dn = cast(dy * w)                      (the product in x's type)
//             dw = sum over rows of cast(dy * n)     (each product in x's type, summed in fp32)
//             c  = sum over the row of dn * x        (fp32)
//             dx = cast(dn * scale + 2 x * (c * (-0.5 * scale / ms)) / d),  ms = mean(x^2) + eps
//   add mode: the forward returned s = x + delta and the norm of s; the
//             backward takes s as its x and adds the incoming ds:
//             dx = cast(cast(dx) + ds), the gradient of both x and delta.
//
// Replaces: no TPU kernel. The JAX package differentiates
// bobrapet_tpu/ops/rmsnorm.py:rmsnorm_reference through XLA (its train step,
// bobrapet_tpu/parallel/train.py:106-125); this is that VJP, rounding where
// it rounds: the cast to x's type before the weight product, so the
// gradient passes through that cast and through a product in x's type.
//
// Bound on the card: bytes. dy and x are read once (and ds in the add
// mode), dx written once: [4096, 4096] bf16 moves 100.7 MB in the plain
// mode (30 us at 3.35 TB/s) and 134.2 MB in the add mode (40 us), at ~10
// flops an element.
//
// Design: deterministic, no atomics. A block of 256 threads walks a run of
// consecutive rows, the row in registers (16-byte packs, every load of a
// row issued before its arithmetic, as the forward does), the two row sums
// (x^2 and dn x) through warp shuffles and one barrier, added in a fixed
// order. Each thread keeps the weight gradient of its own columns in fp32
// registers over its block's rows and writes them to one row of a
// [blocks, d] fp32 scratch; a second kernel adds the blocks' rows in block
// order, one thread a column. The run length comes from the host
// (ops/rmsnorm.py:norm_backward_blocks), so the sums do not depend on the
// card. Widths 4096 and 2048 with 16-byte aligned pointers take the
// register kernel; any other width a generic kernel that keeps the weight
// gradient in shared memory and reads each row twice.

#include <stdint.h>

#include "common.cuh"

namespace bobra {
namespace norm_bwd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// widest row the generic kernel's shared-memory accumulators take (48 KB)
constexpr int kGenericMaxWidth = 12288;

// the sums of one row over the block: both values on every thread. Slots
// alternate with the row's parity, so one barrier a row suffices.
__device__ __forceinline__ void block_sums(float& a, float& b, float (&slots)[2][2][kWarps],
                                           int parity) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    slots[parity][0][warp] = a;
    slots[parity][1][warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    a += slots[parity][0][i];
    b += slots[parity][1][i];
  }
}

// dx of one element from the row's scale and coefficient (fp32), rounded
// like JAX's VJP: cast to x's type, then (add mode) the add of ds in x's type
template <typename T>
__device__ __forceinline__ T dx_one(float dn, float xf, float scale, float coef, const T* ds_e) {
  T out = from_float<T>(dn * scale + xf * coef);
  if (ds_e != nullptr) out = from_float<T>(to_float(out) + to_float(*ds_e));
  return out;
}

// dn = cast(dy * w): the product in x's type
template <typename T>
__device__ __forceinline__ float dn_one(T dy, T w) {
  return to_float(from_float<T>(to_float(dy) * to_float(w)));
}

// the weight gradient's term: cast(dy * n), n = cast(x * scale)
template <typename T>
__device__ __forceinline__ float dw_one(T dy, float xf, float scale) {
  const T n = from_float<T>(xf * scale);
  return to_float(from_float<T>(to_float(dy) * to_float(n)));
}

// the coefficient of x in dx: 2 * (c * (-0.5 * scale / ms)) / d
__device__ __forceinline__ float x_coef(float c, float scale, float ms, int d) {
  return 2.f * (c * (-0.5f * (scale / ms)) / static_cast<float>(d));
}

template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ ds, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int d, float eps, int run) {
  __shared__ float slots[2][2][kWarps];
  const long long r0 = static_cast<long long>(blockIdx.x) * run;
  const long long r1 = min(rows, r0 + run);
  if constexpr (kVecs == 0) {
    // generic width: the weight gradient in shared memory, each thread
    // owning the columns tid, tid + 256, ...; every row read twice
    extern __shared__ float dw_s[];
    for (int i = threadIdx.x; i < d; i += kThreads) dw_s[i] = 0.f;
    int parity = 0;
    for (long long r = r0; r < r1; ++r, parity ^= 1) {
      const long long base = r * d;
      float sxx = 0.f, sdx = 0.f;
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const float xf = to_float(x[base + i]);
        sxx += xf * xf;
        sdx += dn_one(dy[base + i], w[i]) * xf;
      }
      block_sums(sxx, sdx, slots, parity);
      const float ms = sxx / static_cast<float>(d) + eps;
      const float scale = 1.0f / sqrtf(ms);
      const float coef = x_coef(sdx, scale, ms, d);
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const float xf = to_float(x[base + i]);
        const T g = dy[base + i];
        dw_s[i] += dw_one(g, xf, scale);
        dx[base + i] = dx_one(dn_one(g, w[i]), xf, scale, coef,
                              ds == nullptr ? nullptr : ds + base + i);
      }
    }
    for (int i = threadIdx.x; i < d; i += kThreads) {
      partial[static_cast<long long>(blockIdx.x) * d + i] = dw_s[i];
    }
  } else {
    constexpr int kPack = 16 / sizeof(T);
    const int tid = threadIdx.x;
    auto col = [&](int j) { return (j * kThreads + tid) * kPack; };
    float acc[kVecs * kPack];
#pragma unroll
    for (int i = 0; i < kVecs * kPack; ++i) acc[i] = 0.f;
    uint4 wv[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) wv[j] = *reinterpret_cast<const uint4*>(w + col(j));
    int parity = 0;
    for (long long r = r0; r < r1; ++r, parity ^= 1) {
      const long long base = r * d;
      uint4 xv[kVecs], gv[kVecs], sv[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        xv[j] = *reinterpret_cast<const uint4*>(x + base + col(j));
        gv[j] = *reinterpret_cast<const uint4*>(dy + base + col(j));
        if (ds != nullptr) sv[j] = *reinterpret_cast<const uint4*>(ds + base + col(j));
      }
      float sxx = 0.f, sdx = 0.f;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const T* xe = reinterpret_cast<const T*>(&xv[j]);
        const T* ge = reinterpret_cast<const T*>(&gv[j]);
        const T* we = reinterpret_cast<const T*>(&wv[j]);
#pragma unroll
        for (int e = 0; e < kPack; ++e) {
          const float xf = to_float(xe[e]);
          sxx += xf * xf;
          sdx += dn_one(ge[e], we[e]) * xf;
        }
      }
      block_sums(sxx, sdx, slots, parity);
      const float ms = sxx / static_cast<float>(d) + eps;
      const float scale = 1.0f / sqrtf(ms);
      const float coef = x_coef(sdx, scale, ms, d);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const T* xe = reinterpret_cast<const T*>(&xv[j]);
        const T* ge = reinterpret_cast<const T*>(&gv[j]);
        const T* we = reinterpret_cast<const T*>(&wv[j]);
        const T* se = reinterpret_cast<const T*>(&sv[j]);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int e = 0; e < kPack; ++e) {
          const float xf = to_float(xe[e]);
          acc[j * kPack + e] += dw_one(ge[e], xf, scale);
          oe[e] = dx_one(dn_one(ge[e], we[e]), xf, scale, coef,
                         ds == nullptr ? nullptr : se + e);
        }
        *reinterpret_cast<uint4*>(dx + base + col(j)) = o;
      }
    }
    float* prow = partial + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int e = 0; e < kPack; e += 4) {
        *reinterpret_cast<float4*>(prow + col(j) + e) =
            make_float4(acc[j * kPack + e], acc[j * kPack + e + 1], acc[j * kPack + e + 2],
                        acc[j * kPack + e + 3]);
      }
    }
  }
}

// dw[c] = the blocks' partial sums of column c, added in block order
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, int blocks,
                         int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<long long>(b) * d + c];
  dw[c] = from_float<T>(s);
}

template <typename T, int kVecs>
int launch_instance(const void* dy, const void* x, const void* w, const void* ds, void* dx,
                    float* partial, long long rows, int d, float eps, int blocks, int run,
                    cudaStream_t st) {
  const int smem = kVecs == 0 ? d * static_cast<int>(sizeof(float)) : 0;
  rmsnorm_bwd_kernel<T, kVecs><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(ds), static_cast<T*>(dx), partial, rows, d, eps, run);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* dy, const void* x, const void* w, const void* ds, void* dx,
                    void* dw, void* partial, long long rows, int d, float eps, int blocks,
                    bool aligned, cudaStream_t st) {
  constexpr int kPack = 16 / sizeof(T);
  const int run = static_cast<int>((rows + blocks - 1) / blocks);
  float* part = static_cast<float*>(partial);
  int err;
  if (aligned && d == 4096) {
    err = launch_instance<T, 4096 / (kThreads * kPack)>(dy, x, w, ds, dx, part, rows, d, eps,
                                                        blocks, run, st);
  } else if (aligned && d == 2048) {
    err = launch_instance<T, 2048 / (kThreads * kPack)>(dy, x, w, ds, dx, part, rows, d, eps,
                                                        blocks, run, st);
  } else {
    if (d > kGenericMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_instance<T, 0>(dy, x, w, ds, dx, part, rows, d, eps, blocks, run, st);
  }
  if (err != 0) return err;
  rmsnorm_dw_reduce_kernel<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, static_cast<T*>(dw), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace norm_bwd
}  // namespace bobra

// dy, x, dx (and ds in the add mode): [rows, d] contiguous; w, dw: [d];
// all of one type. x is the forward's norm input (s in the add mode); ds
// null selects the plain mode. partial: fp32 scratch [blocks, d]; row run
// r of x goes to block r / ceil(rows / blocks). Two launches on `stream`
// (the rows, then the weight gradient's reduce). Returns the cudaError_t of
// the launches.
extern "C" int bobra_rmsnorm_backward(const void* dy, const void* x, const void* w,
                                      const void* ds, void* dx, void* dw, void* partial,
                                      long long rows, int d, float eps, int blocks, int dtype,
                                      void* stream) {
  using namespace bobra;
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows || blocks > 0x7fffffff / d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dy == nullptr || x == nullptr || w == nullptr || dx == nullptr || dw == nullptr ||
      partial == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned =
      (reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(x) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(ds) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(partial)) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return norm_bwd::launch_backward<float>(dy, x, w, ds, dx, dw, partial, rows, d, eps,
                                              blocks, aligned, st);
    case kBFloat16:
      return norm_bwd::launch_backward<__nv_bfloat16>(dy, x, w, ds, dx, dw, partial, rows, d,
                                                      eps, blocks, aligned, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
