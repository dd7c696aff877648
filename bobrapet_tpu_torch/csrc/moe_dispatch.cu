// Sparse-MoE routing, dispatch and combine: three kernels.
//
//   route:    probs = softmax(fp32(logits)) per token; the top-k experts
//             (equal probabilities to the lower expert index); gates =
//             chosen probs / max(their sum, 1e-9); each (t, k)'s slot in
//             its expert's queue in t-major, k-minor order; the inverse map
//             src[e, c] (token, or -1 for an empty slot); per expert the
//             (t, k) routed to it and the sum of its probabilities
//   dispatch: expert_in[e, c] = h[src[e, c]], zeros where src is -1
//   combine:  y[t] = cast(sum_k gate[t, k] * expert_out[e(t, k), slot(t, k)])
//             in fp32, k in order, a (t, k) past the capacity skipped
//
// Replaces: bobrapet_tpu/models/moe.py:route_topk (:142) and the dispatch
// and combine einsums of moe_mlp_block (:197, :209), which XLA fuses; the
// JAX package has no Pallas kernel there. JAX builds one-hot dispatch and
// combine tensors [T, E, C] and contracts them with the activations: at
// no-drop capacity (C = T * k, what serving requires) that is O(T^2) work
// and memory for a copy and a k-term sum. Here the route keeps the map as
// indices ([T, k] and [E, C]) and the other two move each row once.
//
// Rounding: the route's softmax is JAX's formula (max subtracted, exp, a
// sum in expert order, a division), the top-k is lax.top_k's order (a
// strict > keeps the lower index of equal probabilities), the gate sum is
// taken in k order. The combine takes each product and each add rounded
// on its own (__fmul_rn / __fadd_rn: no FMA contraction), which is what
// the plain version's torch ops do, so the two agree bit for bit; JAX's
// fp32 einsum may contract them into an FMA (one ulp before the cast).
//
// Bound on the card: bytes, all three. The route reads T x E logits and
// writes a few ints a token and E x C src entries; the dispatch reads the
// T rows of h and writes E x C rows (134 MB at the greedy prefill's T =
// 1024, C = 2048, d = 4096 bf16: 42.6 us at 3.35 TB/s); the combine reads
// k rows a token and writes one (25 MB there, 7.5 us). None does more than
// a few flops a byte.
//
// Design: the route is one block of kRouteThreads threads that walks the
// tokens in chunks of one token a thread, because the queue positions are
// a prefix sum over all tokens: per expert a warp ballot of the tokens that
// chose it, popc for the lanes before, the warps' counts summed in order by
// one thread an expert, plus the chunks before. The per-expert probability
// sums are taken in token order by one thread an expert, so reruns give
// the same bits. At the port's T (8 to 1024) the whole route is a few
// microseconds on one SM; it lets the kernel after it (the gate/up product
// of csrc/moe_experts.cu, launched with programmatic dependent launch)
// start launching at once. The dispatch is one block a row (E x C rows) of
// kRowThreads threads moving 16-byte packs where the row width and
// pointers allow, else elements; the model no longer runs it (the gate/up
// product gathers its rows itself), it stays as the counterpart of JAX's
// dispatch einsum. The combine is latency, not bytes, at a decode (8
// tokens of 8 KB): its grid is tokens x column chunks, with the chunk (32
// to 128 threads of 16 bytes) picked so that every SM gets two blocks; each
// thread issues its k loads before its sums, and the launch overlaps the
// down product's tail (programmatic dependent launch).

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace bobra {
namespace moe {

constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kMaxExperts = 32;
constexpr int kMaxTopK = 8;
constexpr int kRowThreads = 128;
constexpr int kCombineThreads = 128;  // the most threads of a combine block

template <typename T>
__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const T* __restrict__ logits, int* __restrict__ expert,
                     int* __restrict__ slot, float* __restrict__ gate, int* __restrict__ src,
                     int* __restrict__ counts, float* __restrict__ probsum, int tokens,
                     int n_experts, int top_k, int capacity) {
  __shared__ float probs[kRouteThreads][kMaxExperts + 1];
  __shared__ unsigned ballots[kRouteWarps][kMaxExperts];
  __shared__ int warp_base[kRouteWarps][kMaxExperts];
  __shared__ int base[kMaxExperts];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = n_experts, K = top_k;
  // the gate/up product, launched with programmatic dependent launch, may
  // start now: it reads nothing of this kernel's before its dependency wait
  hopper::launch_dependents();
  // every capacity slot starts empty
  for (int i = tid; i < E * capacity; i += kRouteThreads) src[i] = -1;
  if (tid < E) base[tid] = 0;
  float psum = 0.f;  // thread e < E: expert e's probabilities so far, in token order
  __syncthreads();
  for (int t0 = 0; t0 < tokens; t0 += kRouteThreads) {
    const int t = t0 + tid;
    const bool live = t < tokens;
    unsigned chosen = 0;
    float* p = probs[tid];
    if (live) {
      const T* row = logits + static_cast<size_t>(t) * E;
      float mx = -INFINITY;
      for (int e = 0; e < E; ++e) {
        p[e] = to_float(row[e]);
        mx = fmaxf(mx, p[e]);
      }
      float s = 0.f;
      for (int e = 0; e < E; ++e) {
        p[e] = expf(p[e] - mx);
        s = __fadd_rn(s, p[e]);
      }
      for (int e = 0; e < E; ++e) p[e] = __fdiv_rn(p[e], s);
      int* ex = expert + static_cast<size_t>(t) * K;
      float* g = gate + static_cast<size_t>(t) * K;
      float gs = 0.f;
      for (int k = 0; k < K; ++k) {
        int best = -1;
        float bv = 0.f;
        for (int e = 0; e < E; ++e) {
          if ((chosen >> e) & 1u) continue;
          if (best < 0 || p[e] > bv) {
            best = e;
            bv = p[e];
          }
        }
        chosen |= 1u << best;
        ex[k] = best;
        g[k] = bv;
        gs = __fadd_rn(gs, bv);
      }
      gs = fmaxf(gs, 1e-9f);
      for (int k = 0; k < K; ++k) g[k] = __fdiv_rn(g[k], gs);
    }
    // the (t, k) of this chunk routed to each expert, warp by warp
    for (int e = 0; e < E; ++e) {
      const unsigned b = __ballot_sync(0xffffffffu, (chosen >> e) & 1u);
      if (lane == 0) ballots[warp][e] = b;
    }
    __syncthreads();
    if (tid < E) {
      int run = base[tid];
      for (int w = 0; w < kRouteWarps; ++w) {
        warp_base[w][tid] = run;
        run += __popc(ballots[w][tid]);
      }
      base[tid] = run;
      const int n = min(kRouteThreads, tokens - t0);
      for (int i = 0; i < n; ++i) psum = __fadd_rn(psum, probs[i][tid]);
    }
    __syncthreads();
    if (live) {
      const unsigned before = (1u << lane) - 1u;
      for (int k = 0; k < K; ++k) {
        const int e = expert[static_cast<size_t>(t) * K + k];
        const int s = warp_base[warp][e] + __popc(ballots[warp][e] & before);
        slot[static_cast<size_t>(t) * K + k] = s;
        if (s < capacity) src[static_cast<size_t>(e) * capacity + s] = t;
      }
    }
    // the next chunk rewrites probs, ballots and warp_base
    __syncthreads();
  }
  if (tid < E) {
    counts[tid] = base[tid];
    probsum[tid] = psum;
  }
}

// one row of V a block: out row r = h row src[r], or zeros
template <typename V>
__global__ void __launch_bounds__(kRowThreads)
    moe_dispatch_kernel(const V* __restrict__ h, const int* __restrict__ src,
                        V* __restrict__ out, int row_vecs) {
  const int r = blockIdx.x;
  const int s = src[r];
  V* dst = out + static_cast<size_t>(r) * row_vecs;
  if (s < 0) {
    const V zero{};
    for (int i = threadIdx.x; i < row_vecs; i += kRowThreads) dst[i] = zero;
    return;
  }
  const V* from = h + static_cast<size_t>(s) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += kRowThreads) dst[i] = from[i];
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// Grid (tokens, column chunks): a block takes blockDim.x packs of kVec
// elements (16 bytes where the width and pointers allow, else 1) of one
// token, so a decode's few tokens still spread over the SMs. A thread loads
// its k rows (and their maps) before the first sum.
template <typename T, int kVec>
__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const T* __restrict__ expert_out, const int* __restrict__ expert,
                       const int* __restrict__ slot, const float* __restrict__ gate,
                       T* __restrict__ y, int d, int top_k, int capacity) {
  using P = Pack<T, kVec>;
  hopper::launch_dependents();
  hopper::grid_dependency_wait();  // the expert rows and the route's maps are written
  const int t = blockIdx.x;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * kVec;
  if (col >= d) return;
  const int* ex = expert + static_cast<size_t>(t) * top_k;
  const int* sl = slot + static_cast<size_t>(t) * top_k;
  const float* g = gate + static_cast<size_t>(t) * top_k;
  P v[kMaxTopK];
  float gk[kMaxTopK];
  bool kept[kMaxTopK];
#pragma unroll
  for (int k = 0; k < kMaxTopK; ++k) {
    const int s = k < top_k ? sl[k] : capacity;
    kept[k] = s < capacity;  // else dropped: past its expert's capacity
    gk[k] = kept[k] ? g[k] : 0.f;
    if (kept[k]) {
      const size_t row = static_cast<size_t>(ex[k]) * capacity + s;
      v[k] = *reinterpret_cast<const P*>(expert_out + row * d + col);
    }
  }
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxTopK; ++k) {
    if (!kept[k]) continue;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(gk[k], to_float(v[k].v[j])));
  }
  P o;
#pragma unroll
  for (int j = 0; j < kVec; ++j) o.v[j] = from_float<T>(acc[j]);
  *reinterpret_cast<P*>(y + static_cast<size_t>(t) * d + col) = o;
}

inline bool aligned16(const void* a, const void* b, const void* c) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c)) % 16 == 0;
}

inline int finish(cudaError_t err) {
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the threads of a combine block: the most (of 128, 64, 32) that still give
// every SM two blocks, else 32
inline int combine_threads(int tokens, int packs) {
  const int sms = hopper::sm_count();
  if (sms == 0) return kCombineThreads;
  for (int threads = kCombineThreads; threads > 32; threads /= 2) {
    if (static_cast<long long>(tokens) * ((packs + threads - 1) / threads) >= 2LL * sms) {
      return threads;
    }
  }
  return 32;
}

template <typename T, int kVec>
cudaError_t launch_combine(const void* expert_out, const void* expert, const void* slot,
                           const void* gate, void* y, int tokens, int d, int top_k,
                           int capacity, cudaStream_t st) {
  const int packs = (d + kVec - 1) / kVec;
  const int threads = combine_threads(tokens, packs);
  // the launch overlaps the tail of the kernel before it (the down product's)
  hopper::PdlLaunch l(dim3(tokens, (packs + threads - 1) / threads, 1), threads, 0, st);
  return cudaLaunchKernelEx(&l.cfg, moe_combine_kernel<T, kVec>, static_cast<const T*>(expert_out),
                            static_cast<const int*>(expert), static_cast<const int*>(slot),
                            static_cast<const float*>(gate), static_cast<T*>(y), d, top_k,
                            capacity);
}

template <typename T>
int launch_combine(const void* expert_out, const void* expert, const void* slot,
                   const void* gate, void* y, int tokens, int d, int top_k, int capacity,
                   cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && aligned16(expert_out, y, nullptr)) {
    return finish(launch_combine<T, kVec>(expert_out, expert, slot, gate, y, tokens, d, top_k,
                                          capacity, st));
  }
  return finish(launch_combine<T, 1>(expert_out, expert, slot, gate, y, tokens, d, top_k,
                                     capacity, st));
}

}  // namespace moe
}  // namespace bobra

// logits: [tokens, n_experts] contiguous, fp32 or bf16. Outputs: expert,
// slot int32 and gate fp32 [tokens, top_k]; src int32 [n_experts,
// capacity]; counts int32 and probsum fp32 [n_experts]. 1 <= n_experts <=
// 32, 1 <= top_k <= min(8, n_experts). One block: the launches on a stream
// are ordered, the route of one call is never split across blocks.
extern "C" int bobra_moe_route(const void* logits, void* expert, void* slot, void* gate,
                               void* src, void* counts, void* probsum, int tokens,
                               int n_experts, int top_k, int capacity, int dtype,
                               void* stream) {
  using namespace bobra;
  using namespace bobra::moe;
  if (tokens < 1 || n_experts < 1 || n_experts > kMaxExperts || top_k < 1 ||
      top_k > kMaxTopK || top_k > n_experts || capacity < 1 ||
      static_cast<long long>(n_experts) * capacity > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ex = static_cast<int*>(expert);
  int* sl = static_cast<int*>(slot);
  float* g = static_cast<float*>(gate);
  int* sr = static_cast<int*>(src);
  int* cn = static_cast<int*>(counts);
  float* ps = static_cast<float*>(probsum);
  if (dtype == kFloat32) {
    moe_route_kernel<float><<<1, kRouteThreads, 0, st>>>(static_cast<const float*>(logits), ex,
                                                         sl, g, sr, cn, ps, tokens, n_experts,
                                                         top_k, capacity);
  } else if (dtype == kBFloat16) {
    moe_route_kernel<__nv_bfloat16><<<1, kRouteThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), ex, sl, g, sr, cn, ps, tokens, n_experts,
        top_k, capacity);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish(cudaSuccess);
}

// h: [tokens, d] contiguous; src: int32 [rows] (rows = n_experts x
// capacity; entries -1 or a row of h); out: [rows, d]. fp32 or bf16.
extern "C" int bobra_moe_dispatch(const void* h, const void* src, void* out, int rows, int d,
                                  int dtype, void* stream) {
  using namespace bobra;
  using namespace bobra::moe;
  if (rows < 1 || d < 1 || (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sr = static_cast<const int*>(src);
  const long long row_bytes = static_cast<long long>(d) * (dtype == kBFloat16 ? 2 : 4);
  if (row_bytes % 16 == 0 && aligned16(h, out, nullptr)) {
    moe_dispatch_kernel<uint4><<<rows, kRowThreads, 0, st>>>(
        static_cast<const uint4*>(h), sr, static_cast<uint4*>(out),
        static_cast<int>(row_bytes / 16));
  } else if (dtype == kBFloat16) {
    moe_dispatch_kernel<uint16_t><<<rows, kRowThreads, 0, st>>>(
        static_cast<const uint16_t*>(h), sr, static_cast<uint16_t*>(out), d);
  } else {
    moe_dispatch_kernel<uint32_t><<<rows, kRowThreads, 0, st>>>(
        static_cast<const uint32_t*>(h), sr, static_cast<uint32_t*>(out), d);
  }
  return finish(cudaSuccess);
}

// expert_out: [n_experts x capacity, d] contiguous; expert, slot int32 and
// gate fp32 [tokens, top_k] (the route's); y: [tokens, d]. fp32 or bf16.
extern "C" int bobra_moe_combine(const void* expert_out, const void* expert, const void* slot,
                                 const void* gate, void* y, int tokens, int d, int top_k,
                                 int capacity, int dtype, void* stream) {
  using namespace bobra;
  using namespace bobra::moe;
  if (tokens < 1 || d < 1 || top_k < 1 || top_k > kMaxTopK || capacity < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_combine<float>(expert_out, expert, slot, gate, y, tokens, d, top_k, capacity,
                                 st);
  }
  if (dtype == kBFloat16) {
    return launch_combine<__nv_bfloat16>(expert_out, expert, slot, gate, y, tokens, d, top_k,
                                         capacity, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
