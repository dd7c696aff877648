// Hopper building blocks for the port's kernels: mbarriers (and cp.async
// completion on one), TMA tensor loads, programmatic dependent launch,
// register moves between warpgroups, wgmma (shared-memory descriptors,
// fences, the m64n128k16 bf16 product with A in registers, the m64n128
// and n16 products with both operands in shared memory; for the attention
// backward the m64n64 and n32 products from shared memory, the n128 and n32
// products with A in registers and B of either major, and descriptors of
// 64-byte-swizzled operands) and, on the host, the tensor-map encoders (2-D,
// and 4-D for the backward's head-strided tiles), a launch with
// programmatic dependent launch and the SM count.
// Plain CUDA with no PyTorch header; the encoder reaches the driver's
// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library links no libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bobra {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p: a 128-byte-swizzled tile's
// pattern repeats every 8 rows of 128 bytes, so its base is aligned to that
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// mbarriers (shared::cta)

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// after the initialisations, before any other thread or the TMA unit uses them
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// cycles a barrier wait may last before the kernel traps (~5 s): a lost
// phase ends the launch with an error instead of holding the card
constexpr long long kWaitTrapCycles = 1LL << 33;

// wait for the phase of parity `parity` to complete (a barrier starts in
// phase 0: waiting on parity 1 of a fresh barrier returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitTrapCycles) {
      asm volatile("trap;\n");
    }
  }
}

// arrive on bar once every cp.async this thread issued before has landed;
// .noinc: the barrier's expected count includes this arrival
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// TMA

// the box of a 2-D tensor map at (inner, outer) into shared memory at dst;
// its bytes complete on bar (out-of-range elements arrive as zeros)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int inner,
                                            int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer),
         "r"(smem_addr(bar))
      : "memory");
}

// the box of a 4-D tensor map at (c0, c1, c2, c3), innermost first, into
// shared memory at dst; the box lands densely, innermost dimension fastest
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// bring a tensor map's descriptor into the cache ahead of its first load
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// this thread's generic-proxy writes to shared memory become visible to the
// async proxy (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// programmatic dependent launch (a no-op without the launch attribute)

// wait until the kernels this one depends on have completed and their
// writes are visible: nothing they write may be read, and nothing written,
// before this
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// let the next kernel on the stream start launching its blocks
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// move registers between warpgroups of a warp-specialised kernel: every
// thread of the warpgroup runs it, on a path that never rejoins the others
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// shared-memory matrix descriptor of a 128-byte-swizzled operand (tile base
// 1024-byte aligned): the start address, the leading and stride byte
// offsets (multiples of 16)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // layout: 128-byte swizzle
  return d;
}

// the same for an operand swizzled over `SW` bytes a row: 128 (layout 1)
// or 64 (layout 2: rows of 64 bytes, the pattern repeating every 512)
template <int SW>
__device__ __forceinline__ uint64_t wgmma_desc_sw(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  static_assert(SW == 128 || SW == 64, "128- or 64-byte swizzle");
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (warp w of the
// warpgroup holds rows 16w.. in mma.sync m16n8k16's A fragment layout), B
// K-major bf16 in 128-byte-swizzled shared memory; 64 fp32 accumulators a
// thread, in the layout of m16n8k16's C fragments over the 16 n8 tiles;
// accumulate onto D when scale_d is 1, overwrite it when 0
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Both operands in 128-byte-swizzled shared memory. TA / TB 0: the operand
// is K-major (K contiguous in its 128-byte rows: start + 32 bytes a k16
// step, LBO 16, SBO 1024 between 8-row groups); 1: MN-major (M or N
// contiguous, K along the rows: start + 2048 bytes a k16 step, LBO the
// bytes between 64-element column chunks, SBO 1024 between 8-row K groups).
// Accumulators as in the register-A product above, N / 2 a thread.

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers as in
// wgmma_m64n128k16_rs, B from shared memory K-major (TB 0) or MN-major (1)
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], as the n128 product above
template <int TB>
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// ---------------------------------------------------------------------------
// host: launches

// a launch configuration with programmatic dependent launch: the kernel may
// start launching while the one before it on the stream still runs, and
// reads that kernel's results only after grid_dependency_wait
struct PdlLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  PdlLaunch(dim3 grid, int threads, int smem, cudaStream_t st) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  PdlLaunch(const PdlLaunch&) = delete;  // cfg points into this object
  PdlLaunch& operator=(const PdlLaunch&) = delete;
};

// the current device's SM count, queried once a device; 0 where it fails
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    sms[dev] = n;
  }
  return sms[dev];
}

// ---------------------------------------------------------------------------
// host: a 2-D tiled tensor map over a row-major [outer, inner] array with
// rows of `row_bytes`, boxes of [box_outer, box_inner]

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             uint64_t inner, uint64_t outer, uint64_t row_bytes,
                             uint32_t box_inner, uint32_t box_outer,
                             CUtensorMapSwizzle swizzle,
                             CUtensorMapL2promotion promotion = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  static EncodeTiledFn encode = nullptr;  // the driver's function, found once
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a 4-D tiled tensor map: dims innermost first, strides (bytes) of dims 1-3
inline cudaError_t encode_4d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             const uint64_t (&dims)[4], const uint64_t (&strides)[3],
                             const uint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  static EncodeTiledFn encode = nullptr;  // cuTensorMapEncodeTiled, looked up once
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t s[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), d, s, b, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace bobra
