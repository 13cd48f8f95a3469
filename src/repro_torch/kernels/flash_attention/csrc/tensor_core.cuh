// The helpers of the port's attention kernels on Hopper (sm_90a), shared by
// flash_attention_wgmma.cu, flash_attention_bwd_wgmma.cu (bf16), flash_attention.cu and
// flash_attention_bwd.cu (float32 as split TF32), and flash_attention_wide.cu and
// flash_attention_wide_bwd.cu (widths above 256): shared-memory addresses, mbarriers, TMA
// and bulk copies, cp.async, wgmma descriptors and fences, the bf16 and TF32 wgmma
// products, the TF32 split, the run-time lookup of cuTensorMapEncodeTiled, and the
// CUDA-core paths' strides, loads, rounding, mask and score.  Each
// source that includes it is its own library (kernels/_build.py), so everything here sits
// in an anonymous namespace; _build hashes this header into the key of every library
// whose source includes it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-d map {D, S, heads, B} into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte offsets (all
// in 16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// The descriptor `desc` moved `bytes` further into shared memory: an add to its 14-bit
// start-address field, which cannot carry out of it (shared memory ends below 256 KB).
// A step's descriptors are one base and such adds, so none of them has to stay live in
// a register across the loop.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// A bulk copy of `bytes` contiguous bytes into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16]; A from registers (four bf16 pairs), B from
// shared memory, MN-major (the transpose-B bit set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32]; A from registers (four bf16 pairs), B from
// shared memory, MN-major (the transpose-B bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A from registers (four bf16 pairs), B from
// shared memory, MN-major (the transpose-B bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 80] += A[64 x 16] * B[16 x 80]; A from registers (four bf16 pairs), B from
// shared memory, MN-major (the transpose-B bit set): five 16-column atoms of the 32-byte
// swizzle, the descriptor's leading byte offset apart.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A from registers (four bf16 pairs), B from
// shared memory, MN-major (the transpose-B bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256]; A from registers (four bf16 pairs), B from
// shared memory, MN-major (the transpose-B bit set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86,"
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102,"
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116,"
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x by the special-function unit: the instruction exp2f is built on, without exp2f's
// rescaling for results below 2^-126 (those flush to zero; they carry no weight in an
// fp32 sum that holds a 1 from the row maximum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes this file adds to CUDA's (which stay below 1000).
constexpr int kNoEncoder = 9999;        // libcuda has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 10000;    // + the CUresult of a refused tensor map

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a: dims[4] {D, S, heads, B}, byte strides[3] of S, heads, B, box[4], swizzle bytes —
// as ops.tma_map_args computes them.
int encode(CUtensorMap* map, const void* ptr, const unsigned long long* a) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  // The libcuda call needs a current context.  A thread that has made no runtime call yet
  // has none: autograd's device thread, whose first work can be a backward launch with
  // every allocation served from PyTorch's cache (CUresult 201).  Setting the thread's
  // device makes its primary context current.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t dims[4] = {a[0], a[1], a[2], a[3]};
  const cuuint64_t strides[3] = {a[4], a[5], a[6]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(a[7]), static_cast<cuuint32_t>(a[8]),
                             static_cast<cuuint32_t>(a[9]), static_cast<cuuint32_t>(a[10])};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = a[11] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : a[11] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// ---- float32 as split TF32 ------------------------------------------------------------
//
// The tensor cores read a 32-bit operand as TF32: its sign, exponent and top 10 mantissa
// bits, the low 13 ignored (truncated).  A float32 x is taken as hi + lo, hi = tf32(x)
// rounded to nearest (cvt.rna: ties away from zero) and lo = tf32(x − hi); x − hi is exact
// in fp32, so x − (hi + lo) is lo's own rounding, at most 2^-11 of |lo| ≤ 2^-12 ulp-ish of
// x: about 2^-22 of |x|.  A product x·y is then lo_x·hi_y + hi_x·lo_y + hi_x·hi_y, summed
// in fp32 by the tensor cores (the dropped lo_x·lo_y is below 2^-22 of |x·y|).

// x rounded to TF32 (nearest, ties away), as the 32-bit pattern the tensor cores read.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as its TF32 pair: hi = tf32(x), lo = tf32(x − hi).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Byte offset of the 16-byte chunk `chunk` (of 8) of row `row` in a tile of 128-byte rows
// with the 128-byte swizzle that TMA writes and wgmma's layout 1 reads: in each 8-row atom
// of 1024 bytes, chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// Shared memory through a generic pointer: at<T>(a) is the T at shared address a.  Plain
// loads and stores through it compile to LDS / STS that the compiler schedules freely
// between barriers (asm with memory clobbers, which order them); the TF32 splits of the
// producers are a stream of such loads and stores.
struct Smem {
  uint8_t* base;
  __device__ __forceinline__ explicit Smem(uint8_t* smem_raw)
      : base(smem_raw - smem_u32(smem_raw)) {}
  template <typename T>
  __device__ __forceinline__ T& at(uint32_t a) const {
    return *reinterpret_cast<T*>(base + a);
  }
};

// Four floats split into TF32 pairs, stored as 16 bytes each at shared addresses hi and lo.
__device__ __forceinline__ void st_split4(const Smem& sm, uint32_t hi, uint32_t lo, float4 x) {
  uint4 h, l;
  tf32_split(x.x, h.x, l.x);
  tf32_split(x.y, h.y, l.y);
  tf32_split(x.z, h.z, l.z);
  tf32_split(x.w, h.w, l.w);
  sm.at<uint4>(hi) = h;
  sm.at<uint4>(lo) = l;
}

// Asynchronous copies of 4 or 16 bytes into shared memory; where `in` is false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic writes to shared memory visible to the async proxy (wgmma's
// operand reads) once a barrier orders them before the product.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A named barrier over `threads` threads (a multiple of 32).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D[64 x 32] (+)= A[64 x 8] * B[8 x 32] in TF32 with fp32 sums: A and B from shared
// memory, both K-major (TF32 operands have no transpose bits); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] * B[8 x 64] in TF32 with fp32 sums: A and B from shared
// memory, both K-major (TF32 operands have no transpose bits); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] += A[64 x 8] * B[8 x 32] in TF32 with fp32 sums: A from registers (the
// TF32 patterns of rows r, r + 8 at k columns t, t + 4), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] * B[8 x 64] in TF32 with fp32 sums: A from registers (the
// TF32 patterns of rows r, r + 8 at k columns t, t + 4), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 8] * B[8 x 128] in TF32 with fp32 sums: A from registers (the
// TF32 patterns of rows r, r + 8 at k columns t, t + 4), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Split tiles.  A tile of R rows by C floats (C a multiple of 32, the K axis of its
// products) is stored as C/32 column boxes of R rows × 128 bytes, box c at c·R·128 bytes,
// each swizzled as swizzle128 says: the K-major layout 1 of a wgmma descriptor with a
// stride byte offset of 1024.  Its hi and its lo tile have the same layout.

// Producer side.  A split is a load phase and a store phase, so that a producer can put
// the loads of several tiles in flight before the first split: its warps are few and
// would otherwise wait out a load's latency for every 16 bytes.  NT threads, this one t.
//
// RowSplit, K-major: raw [R][C] fp32 in shared memory (row stride C floats) → the hi / lo
// tiles [R][C].  A quarter-warp reads one raw row's 128 contiguous bytes and writes the
// same row's 8 chunks, so neither side has bank conflicts.
template <int R, int C, int NT>
struct RowSplit {
  static constexpr int kIt = R * C / 4 / NT;
  static_assert(kIt * 4 * NT == R * C, "whole float4s a thread");
  float4 x[kIt];
  __device__ __forceinline__ void load(const Smem& sm, uint32_t raw, int t) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = t + it * NT, ch = i % 8, r = i / 8 % R, box = i / (8 * R);
      x[it] = sm.at<float4>(raw + (r * C + box * 32 + ch * 4) * 4);
    }
  }
  __device__ __forceinline__ void store(const Smem& sm, uint32_t hi, uint32_t lo, int t) const {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = t + it * NT, ch = i % 8, r = i / 8 % R, box = i / (8 * R);
      const uint32_t off = box * R * 128 + swizzle128(r, ch);
      st_split4(sm, hi + off, lo + off, x[it]);
    }
  }
};

// ColSplit, transposed: raw [R][C] → the hi / lo tiles [C][R] (R a multiple of 32, now the
// K axis), with the K axis permuted inside each group of 8: column k holds raw row
// 8·(k / 8) + perm(k % 8), perm = (0 2 4 6 1 3 5 7).  That is the order in which a thread's
// accumulator columns 2t, 2t + 1 become its A fragment's k columns t, t + 4 (split_frag), so
// a product whose A is an accumulator (P·V, Pᵀ·dO, dSᵀ·Q, dS·K) needs no shuffle.  Threads
// of a warp read neighbouring raw columns and write rows of distinct swizzle chunks.
template <int R, int C, int NT>
struct ColSplit {
  static constexpr int kIt = R * C / 4 / NT;
  static_assert(kIt * 4 * NT == R * C, "whole float4s a thread");
  float4 x[kIt];
  __device__ __forceinline__ void load(const Smem& sm, uint32_t raw, int t) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = t + it * NT, n = i % C, ch = i / C % 8, box = i / (8 * C);
      const int r0 = 32 * box + 8 * (ch >> 1) + (ch & 1);  // k = 4·ch .. 4·ch + 3 of the box
      x[it] = make_float4(sm.at<float>(raw + ((r0 + 0) * C + n) * 4),
                          sm.at<float>(raw + ((r0 + 2) * C + n) * 4),
                          sm.at<float>(raw + ((r0 + 4) * C + n) * 4),
                          sm.at<float>(raw + ((r0 + 6) * C + n) * 4));
    }
  }
  __device__ __forceinline__ void store(const Smem& sm, uint32_t hi, uint32_t lo, int t) const {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = t + it * NT, n = i % C, ch = i / C % 8, box = i / (8 * C);
      const uint32_t off = box * C * 128 + swizzle128(n, ch);
      st_split4(sm, hi + off, lo + off, x[it]);
    }
  }
};

template <int N>
__device__ __forceinline__ void tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(N == 32 || N == 64, "TF32 SS products of 32 or 64 columns");
  if constexpr (N == 64) wgmma_tf32_ss_n64(d, da, db, acc);
  else wgmma_tf32_ss_n32(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "TF32 RS products of 32, 64 or 128 columns");
  if constexpr (N == 128) wgmma_tf32_rs_n128(d, a, db);
  else if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, db);
  else wgmma_tf32_rs_n32(d, a, db);
}

// acc[64 x N] = A·Bᵀ in split TF32, A [64][K] and B [N][K] as hi / lo tiles: the small terms
// lo·hi and hi·lo of every k step first, then hi·hi, all into acc (overwritten by the first
// product), so that the small terms are summed while acc is still small.  Not committed.
template <int N, int K>
__device__ __forceinline__ void split_ss(float (&acc)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b_hi, uint32_t b_lo) {
  const uint64_t ah = smem_desc(a_hi, 16, 1024, 1), al = smem_desc(a_lo, 16, 1024, 1);
  const uint64_t bh = smem_desc(b_hi, 16, 1024, 1), bl = smem_desc(b_lo, 16, 1024, 1);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t oa = kk / 4 * 64 * 128 + kk % 4 * 32, ob = kk / 4 * N * 128 + kk % 4 * 32;
    tf32_ss<N>(acc, desc_add(al, oa), desc_add(bh, ob), kk > 0);
    tf32_ss<N>(acc, desc_add(ah, oa), desc_add(bl, ob), 1);
  }
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t oa = kk / 4 * 64 * 128 + kk % 4 * 32, ob = kk / 4 * N * 128 + kk % 4 * 32;
    tf32_ss<N>(acc, desc_add(ah, oa), desc_add(bh, ob), 1);
  }
}

// acc[64 x N] += A·B in split TF32: A as the (hi, lo) fragments of KC k steps in registers
// (split_frag), B [N][8·KC] as hi / lo tiles (ColSplit); small terms first.  Not committed.
template <int N, int KC>
__device__ __forceinline__ void split_rs(float (&acc)[N / 2], const uint32_t (&a_hi)[KC][4],
                                         const uint32_t (&a_lo)[KC][4], uint32_t b_hi,
                                         uint32_t b_lo) {
  const uint64_t bh = smem_desc(b_hi, 16, 1024, 1), bl = smem_desc(b_lo, 16, 1024, 1);
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const uint32_t ob = kk / 4 * N * 128 + kk % 4 * 32;
    tf32_rs<N>(acc, a_lo[kk], desc_add(bh, ob));
    tf32_rs<N>(acc, a_hi[kk], desc_add(bl, ob));
  }
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
    tf32_rs<N>(acc, a_hi[kk], desc_add(bh, kk / 4 * N * 128 + kk % 4 * 32));
}

// An accumulator fragment of 64 x 8·KC (a thread's element 4c + e is row r + 8·(e >> 1),
// column 8c + 2t + (e & 1)) as the split A fragments of KC k steps.  A TF32 A fragment holds
// rows r, r + 8 at k columns t and t + 4; k column t is taken as accumulator column 2t and
// t + 4 as 2t + 1, the permutation that ColSplit applies to the B tile.
template <int KC>
__device__ __forceinline__ void split_frag(uint32_t (&hi)[KC][4], uint32_t (&lo)[KC][4],
                                           const float (&f)[KC * 4]) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    tf32_split(f[4 * c + 0], hi[c][0], lo[c][0]);
    tf32_split(f[4 * c + 2], hi[c][1], lo[c][1]);
    tf32_split(f[4 * c + 1], hi[c][2], lo[c][2]);
    tf32_split(f[4 * c + 3], hi[c][3], lo[c][3]);
  }
}

// The pieces the CUDA-core attention paths share (flash_attention.cu and
// flash_attention_bwd.cu above their split-TF32 widths, and the wide kernels): the element
// strides of a [B, S, heads, D] input, the backward's options, fp32 loads and stores of
// float or bf16 values, rounding to the operand dtype, the mask and the score.
struct Strides {
  long long b, s, h;  // element strides of the batch, sequence and head axes
};

struct Opts {
  float scale, cap;
  int causal, window, has_cap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to the dtype `tag` points to and widened back (the identity in float32)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ bool kept(int qpos, int kpos, int Sq, int Sk, const Opts& o) {
  return qpos < Sq && kpos < Sk && (!o.causal || qpos >= kpos) &&
         (o.window <= 0 || qpos - kpos < o.window);
}

// The score s of one (query, key) pair from its raw product q·k, and in *dfac the factor
// (1 − t²) that the softcap puts on ds (1 without one).
__device__ __forceinline__ float score(float raw, const Opts& o, float* dfac) {
  const float x = raw * o.scale;
  if (!o.has_cap) {
    *dfac = 1.0f;
    return x;
  }
  const float t = tanhf(x / o.cap);
  *dfac = 1.0f - t * t;
  return o.cap * t;
}

}  // namespace
