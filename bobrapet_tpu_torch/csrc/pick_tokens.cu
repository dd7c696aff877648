// The token pick of a decode step: per row of logits, the argmax (T == 0)
// or a Gumbel-max draw at temperature T (T > 0):
//
//   greedy:  token = argmax_v float(logit_v)
//   sampled: token = argmax_v (float(logit_v) / max(T, 1e-6) + g_v)
//            g_v = -log(-log(u_v)), u_v = ((w_v >> 8) + 0.5) * 2^-24
//            w_v = word v % 4 of Philox4x32-10(counter (v / 4, index, rid, 0),
//                                               key (0, 0))
//
// ties go to the lowest index, and a NaN wins (the first NaN), as
// torch.argmax and jnp.argmax pick. The temperature's floor is JAX's
// (jnp.maximum(t, 1e-6) at every fused pick): without it a subnormal T
// turns every logit into an infinity and the pick into the first of them.
//
// Replaces: the token picks of bobrapet_tpu/serving/engine.py (jnp.argmax
// and jax.random.categorical at :2916-2921 and :3075-3078, _sample_host
// :2718-2727), of serving/spec_decode.py (:194-199, :331-334) and the
// jnp.argmax of models/llama.py:340, :345 and models/speculative.py:81,
// :115, :141. No Pallas: XLA fused them. jax.random.categorical is
// Gumbel-max over threefry bits; Philox takes threefry's place, so a draw
// has JAX's distribution and not its bits. A sampled token is a pure
// function of (rid, token index), the key JAX folds (_fold_keys), so a
// stream does not depend on the slot, the horizon or the co-scheduled
// requests.
//
// u: the exact value ((w >> 8) + 0.5) 2^-24 is not an fp32 number above
// 0.5 (it needs 25 bits), and rounding it can give u = 1 and g = +inf. So
// -log(u) is taken from the exact distance to the nearer end: below 0.5
// -log(m) with m = u, above it -log1p(-m) with m = 1 - u, both m exact.
// Every operation is an IEEE fp32 one with round to nearest (the division
// included; no contraction into an FMA), and logf / log1pf are the
// full-precision functions, not __logf: the plain version in
// ops/pick_tokens.py repeats the arithmetic, and the two agree bit for bit
// on greedy rows and up to an ulp of a log on sampled ones.
//
// Bound on the card: bytes. A row set [8, 128256] fp32 is 4.10 MB read once,
// 1.22 us at 3.35 TB/s. A sampled element adds a quarter of a Philox call
// (ten rounds of two 32-bit products), an IEEE division and three
// full-precision logs (logf and log1pf both run where a warp's lanes draw
// both halves of u, then logf): ~100 instructions on the FP32 pipe, so an
// engine step's six sampled rows (770k elements) are some 2-3 us of issue
// on 132 SMs, above the bytes' time; the loads and the arithmetic have to
// be spread over the whole card.
//
// Design (for the H100's 132 SMs):
// - the grid fills the card: a row is split over `splits` blocks of a
//   thread-block cluster (pick_splits in ops/pick_tokens.py, as before) and
//   over `chunks` clusters (chunks_for below, mirrored by pick_chunks), so
//   that rows x splits x chunks blocks of 256 threads come to about four an
//   SM, all resident at once (at most 64 registers a thread);
// - a block's span of the row is contiguous; a thread takes kUnroll (2)
//   4-element groups at a time, 256 groups apart, and issues both 16-byte
//   (fp32) or 8-byte (bf16) loads before its first compare, then runs their
//   Philox calls and logs side by side (independent chains in flight); a
//   greedy row runs no Philox; the compare relies on the thread meeting its
//   indices in increasing order (no index compare, no branch);
// - the tail: warp shuffles, one warp over the block's warps, each block's
//   best into rank 0's shared memory (DSMEM) and an arrival on rank 0's
//   mbarrier (release, cluster scope: the other blocks leave at once), one
//   warp of rank 0 over the cluster once all have arrived; the cluster
//   barrier only guarantees, early and cheaply, that rank 0 has started
//   (its arrival is the kernel's first instruction, its wait comes after
//   the loads); with chunks > 1 each cluster folds its best into the row's
//   static slot with a 64-bit integer max (the candidate packed so that the
//   integers' order is the candidates'), then takes a ticket
//   (acquire-release); the cluster that takes a row's last ticket reads the
//   slot's token and resets slot and ticket, so the next launch (or graph
//   replay) finds them at zero. No float atomics and no fence: the
//   candidates' order (a NaN first, then the larger score, then the lower
//   index) is total, so any order gives the same bits;
// - programmatic dependent launch (a flag): the cluster barrier's first
//   arrival, the mbarrier's init and the offsets run before
//   griddepcontrol.wait, and nothing that an earlier kernel writes
//   (logits, temperatures, rids, token indices, the slots) is read before
//   it: a verify's token indices come from the kernel right before the
//   pick (spec_decode._verify_choice); each block lets the next kernel
//   launch once its loads and arithmetic are done.
//
// The slots and tickets are one static scratch per card: launches of
// the pick on one card must be ordered (one stream, as the port launches
// it), never concurrent on two streams.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace bobra {
namespace pick {

namespace cg = cooperative_groups;

constexpr int kBlockThreads = 256;  // threads of a block
constexpr int kBlocksPerSm = 4;     // blocks an SM holds at once (<= 64 registers a thread)
// the threads an SM holds at once: a cluster rank's span of a row is sized
// to 4 groups for each of them before pick_splits doubles the cluster
// (_GROUPS_PER_BLOCK in ops/pick_tokens.py)
constexpr int kThreads = 1024;
static_assert(kThreads == kBlockThreads * kBlocksPerSm, "an SM's threads");
constexpr int kWarps = kBlockThreads / 32;
constexpr int kMaxSplits = 8;
constexpr int kUnroll = 2;          // groups a thread loads before its first compare
static_assert(kUnroll == 2, "the batch dispatch takes 2 or 1 groups a thread");
constexpr int kMaxChunks = 16;      // clusters of one row, at most
constexpr int kMaxPartials = 2048;  // rows x chunks, at most, when chunks > 1 (slots, one a row)
constexpr int kFlagVec = 1;         // `vec`: the 16- (fp32) or 8-byte (bf16) loads
constexpr int kFlagPdl = 2;         // `vec`: programmatic dependent launch
constexpr float kTempFloor = 1e-6f;

// a row's best so far (pack) and its clusters done, when chunks > 1: zero
// at load, and reset by the row's last cluster
__device__ unsigned long long g_best[kMaxPartials];
__device__ unsigned int g_ticket[kMaxPartials];

// the cluster barrier, split: arrive early (nothing to publish), wait later
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// arrive on the mbarrier at `bar` in the shared memory of the cluster's
// block `rank`, releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(hopper::smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote) : "memory");
}

// wait for phase 0 of the mbarrier at `bar`, acquiring at cluster scope
// what the arrivals released (traps after ~5 s, as hopper::mbar_wait)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar) {
  const uint32_t addr = hopper::smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > hopper::kWaitTrapCycles) {
      asm volatile("trap;\n");
    }
  }
}

// the better of two (score, index) candidates: a NaN first, then the larger
// score, then the lower index
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  const bool n = s != s, bn = bs != bs;
  if (n || bn) return n && (!bn || i < bi);
  return s > bs || (s == bs && i < bi);
}

// a candidate as one 64-bit key whose unsigned order is better()'s: a NaN
// above every number, -0 taken as +0, then the lower index above the
// higher; above 0 (the reset slot) for every candidate
__device__ __forceinline__ unsigned long long pack(float s, int i) {
  const uint32_t b = __float_as_uint(s == 0.f ? 0.f : s);
  const uint32_t k = s != s ? 0xFFFFFFFFu : (b & 0x80000000u) ? ~b : b | 0x80000000u;
  return (static_cast<unsigned long long>(k) << 32) | static_cast<uint32_t>(0x7FFFFFFF - i);
}

__device__ __forceinline__ int unpack_index(unsigned long long key) {
  return 0x7FFFFFFF - static_cast<int>(key & 0xFFFFFFFFull);
}

// *slot = max(*slot, key), with no reply
__device__ __forceinline__ void red_max(unsigned long long* slot, unsigned long long key) {
  asm volatile("red.relaxed.gpu.global.max.u64 [%0], %1;\n" :: "l"(slot), "l"(key) : "memory");
}

// ++*ticket, returning the old count: a release of this thread's earlier
// writes (the red_max) and an acquire of those of the threads it follows
__device__ __forceinline__ unsigned int ticket_acq_rel(unsigned int* ticket) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket)
               : "memory");
  return old;
}

// the best candidate of the lanes `width` apart and nearer (width: a power
// of two), into every lane
template <int kWidth>
__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const int io = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(so, io, s, i)) {
      s = so;
      i = io;
    }
  }
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// g = -log(-log(u)) for u = ((w >> 8) + 0.5) 2^-24 (see the header)
__device__ __forceinline__ float gumbel(uint32_t w) {
  const uint32_t x = w >> 8;
  const bool upper = x >= (1u << 23);
  const uint32_t y = upper ? 0xFFFFFFu - x : x;
  const float m = __fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), 5.9604644775390625e-08f);
  const float e = upper ? -log1pf(-m) : -logf(m);
  return -logf(e);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// the four logits of group g as floats; kVec: the row is 16-byte (fp32) or
// 8-byte (bf16) aligned and holds whole groups
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* row, long long g, int v, float (&l)[4]);

template <>
__device__ __forceinline__ void load4<float, true>(const float* row, long long g, int,
                                                   float (&l)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(row) + g);
  l[0] = x.x;
  l[1] = x.y;
  l[2] = x.z;
  l[3] = x.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, true>(const __nv_bfloat16* row, long long g,
                                                           int, float (&l)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(row) + g);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  l[0] = __low2float(a);
  l[1] = __high2float(a);
  l[2] = __low2float(b);
  l[3] = __high2float(b);
}

template <>
__device__ __forceinline__ void load4<float, false>(const float* row, long long g, int v,
                                                    float (&l)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) l[j] = 4 * g + j < v ? row[4 * g + j] : -INFINITY;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, false>(const __nv_bfloat16* row,
                                                            long long g, int v, float (&l)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) l[j] = 4 * g + j < v ? to_float(row[4 * g + j]) : -INFINITY;
}

// N groups of this thread, g = first + u * kBlockThreads for u < N (those
// at or past g1 are not the block's): every load first, then the N groups'
// noise side by side, then the compares in index order
template <int N, typename T, bool kVec>
__device__ __forceinline__ void scan(const T* row, long long first, long long g1, int v,
                                     bool sampled, float t, uint32_t c1, uint32_t c2,
                                     float& best_s, int& best_i) {
  float l[N][4];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long g = first + static_cast<long long>(u) * kBlockThreads;
    if (g < g1) {
      load4<T, kVec>(row, g, v, l[u]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) l[u][j] = -INFINITY;
    }
  }
  if (sampled) {
    uint4 w[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const uint32_t g = static_cast<uint32_t>(first + static_cast<long long>(u) * kBlockThreads);
      w[u] = philox4x32_10(make_uint4(g, c1, c2, 0u), 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) l[u][j] = __fadd_rn(__fdiv_rn(l[u][j], t), gumbel(word(w[u], j)));
    }
  }
  // a thread meets its indices in increasing order, so better() needs no
  // index compare here: the first NaN stays, a larger score wins, and the
  // start (-inf at no index) gives way to anything
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long g = first + static_cast<long long>(u) * kBlockThreads;
    if (g < g1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = static_cast<int>(4 * g + j);
        const float s = l[u][j];
        const bool take = best_s == best_s && (s != s || s > best_s || best_i == 0x7fffffff);
        if ((kVec || i < v) && take) {
          best_s = s;
          best_i = i;
        }
      }
    }
  }
}

// Grid (splits x chunks, rows), cluster (splits, 1, 1), kBlockThreads
// threads; block x of row y takes part x of the row's splits x chunks
// contiguous parts (its cluster: x / splits). temps,
// rids, index: [rows] or null (every row greedy).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm)
pick_tokens_kernel(const T* __restrict__ logits, const float* __restrict__ temps,
                   const int* __restrict__ rids, const int* __restrict__ index,
                   int* __restrict__ out, int v, int chunks) {
  __shared__ float warp_s[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float slot_s[kMaxSplits];
  __shared__ int slot_i[kMaxSplits];
  __shared__ uint64_t slots_full;  // rank 0's: every block's slot is written

  // before the wait: nothing that an earlier kernel writes
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  if (rank == 0 && threadIdx.x == 0) {
    hopper::mbar_init(&slots_full, splits);
    hopper::fence_barrier_init();
  }
  cluster_arrive_relaxed();  // the barrier's init and rank 0's slots exist
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* row = logits + static_cast<long long>(r) * v;
  const long long groups = (static_cast<long long>(v) + 3) / 4;
  const long long parts = static_cast<long long>(splits) * chunks;
  const long long per = (groups + parts - 1) / parts;
  const long long g0 = per * blockIdx.x;
  const long long g1 = g0 + per < groups ? g0 + per : groups;

  hopper::grid_dependency_wait();
  const float t = temps == nullptr ? 0.f : temps[r];
  const bool sampled = t > 0.f;
  const float td = fmaxf(t, kTempFloor);
  const uint32_t c1 = sampled ? static_cast<uint32_t>(index[r]) : 0u;
  const uint32_t c2 = sampled ? static_cast<uint32_t>(rids[r]) : 0u;

  float best_s = -INFINITY;
  int best_i = 0x7fffffff;
  for (long long base = g0; base < g1; base += kBlockThreads * kUnroll) {
    // the groups any thread of the block holds in this batch (block-uniform)
    const long long live = (g1 - base + kBlockThreads - 1) / kBlockThreads;
    const long long first = base + tid;
    if (live >= kUnroll) {
      scan<kUnroll, T, kVec>(row, first, g1, v, sampled, td, c1, c2, best_s, best_i);
    } else {
      scan<1, T, kVec>(row, first, g1, v, sampled, td, c1, c2, best_s, best_i);
    }
  }
  hopper::launch_dependents();

  warp_best<32>(best_s, best_i);
  if (lane == 0) {
    warp_s[warp] = best_s;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best_s = lane < kWarps ? warp_s[lane] : -INFINITY;
    best_i = lane < kWarps ? warp_i[lane] : 0x7fffffff;
    warp_best<kWarps>(best_s, best_i);
  }
  cluster_wait();  // every block of the cluster runs: rank 0's slots exist
  if (tid == 0) {
    cluster.map_shared_rank(slot_s, 0)[rank] = best_s;
    cluster.map_shared_rank(slot_i, 0)[rank] = best_i;
    mbar_arrive_remote(&slots_full, 0);
  }
  if (rank != 0 || warp != 0) return;  // no block reads another's shared memory but rank 0's
  mbar_wait_cluster(&slots_full);  // the slots are written and visible

  float s = lane < splits ? slot_s[lane] : -INFINITY;
  int i = lane < splits ? slot_i[lane] : 0x7fffffff;
  warp_best<kMaxSplits>(s, i);
  // a row of no element (v == 0) is refused by the entry
  if (chunks == 1) {
    if (lane == 0) out[r] = i;
    return;
  }
  // the cluster's best into the row's slot (an integer max: any order, the
  // same bits); the row's last cluster, whichever it is, takes the slot's
  // token and leaves slot and ticket at zero for the next launch, which
  // the stream orders after this one
  if (lane == 0) {
    red_max(&g_best[r], pack(s, i));
    if (ticket_acq_rel(&g_ticket[r]) == static_cast<unsigned int>(chunks - 1)) {
      out[r] = unpack_index(atomicExch(&g_best[r], 0ull));
      g_ticket[r] = 0u;
    }
  }
}

// the clusters of one row: rows x splits x chunks blocks come to about
// kBlocksPerSm an SM (to the nearest), each block keeps at least one group
// a thread, and rows x chunks partials fit the scratch
int chunks_for(int rows, int v, int splits, int sms) {
  const long long groups = (static_cast<long long>(v) + 3) / 4;
  const long long rs = static_cast<long long>(rows) * splits;
  long long c = (2LL * sms * kBlocksPerSm + rs) / (2 * rs);
  const long long most = groups / (static_cast<long long>(splits) * kBlockThreads);
  if (c > most) c = most;
  if (c > kMaxChunks) c = kMaxChunks;
  if (c > kMaxPartials / rows) c = kMaxPartials / rows;
  return c < 1 ? 1 : static_cast<int>(c);
}

// the SMs of the current card, asked once a card
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

template <typename T, bool kVec>
int launch(const void* logits, const void* temps, const void* rids, const void* index,
           void* out, int rows, int v, int splits, int chunks, bool pdl, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * chunks, rows, 1);
  cfg.blockDim = dim3(kBlockThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.numAttrs = 1;
  if (pdl) {
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.numAttrs = 2;
  }
  cfg.attrs = attr;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, pick_tokens_kernel<T, kVec>, static_cast<const T*>(logits),
      static_cast<const float*>(temps), static_cast<const int*>(rids),
      static_cast<const int*>(index), static_cast<int*>(out), v, chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pick
}  // namespace bobra

// logits: [rows, v] contiguous, fp32 or bf16; temps: fp32 [rows], rids and
// index: int32 [rows], all three null for an all-greedy call (else all
// three set); out: int32 [rows]. splits: 1, 2, 4 or 8, the blocks of the
// cluster that split a row (the clusters of a row follow from rows, v and
// the card's SMs: chunks_for). vec: flags, kFlagVec (the logits are 16-byte
// aligned and v a multiple of 4: the 16- or 8-byte loads) and kFlagPdl
// (programmatic dependent launch). Returns the cudaError_t of the launch.
// Not re-entrant: launches on one card must be ordered (one stream; see the
// static slots above).
extern "C" int bobra_pick_tokens(const void* logits, const void* temps, const void* rids,
                                 const void* index, void* out, int rows, int v, int splits,
                                 int vec, int dtype, void* stream) {
  using namespace bobra;
  if (rows < 1 || rows > 65535 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (splits != 1 && splits != 2 && splits != 4 && splits != pick::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((temps == nullptr) != (rids == nullptr) || (temps == nullptr) != (index == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec & ~(pick::kFlagVec | pick::kFlagPdl)) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = pick::sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const int chunks = pick::chunks_for(rows, v, splits, sms);
  const bool aligned = (vec & pick::kFlagVec) != 0, pdl = (vec & pick::kFlagPdl) != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return aligned ? pick::launch<float, true>(logits, temps, rids, index, out, rows, v, splits,
                                               chunks, pdl, st)
                   : pick::launch<float, false>(logits, temps, rids, index, out, rows, v,
                                                splits, chunks, pdl, st);
  }
  if (dtype == kBFloat16) {
    return aligned ? pick::launch<__nv_bfloat16, true>(logits, temps, rids, index, out, rows, v,
                                                       splits, chunks, pdl, st)
                   : pick::launch<__nv_bfloat16, false>(logits, temps, rids, index, out, rows,
                                                        v, splits, chunks, pdl, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
