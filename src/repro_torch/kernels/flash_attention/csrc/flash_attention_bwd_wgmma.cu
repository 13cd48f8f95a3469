// Attention backward for bf16 on Hopper (sm_90a): the tensor-core kernels, which
// FlashAttention.backward runs for bfloat16 inputs with head_dim D in {16, 32, 64, 128, 256};
// float32 inputs go to the CUDA-core kernels in flash_attention_bwd.cu.
//
// Replaces no Pallas kernel: the TPU kernel `_fa_kernel` (src/repro/kernels/flash_attention/
// kernel.py:38) has no VJP, and the JAX package differentiates `full_attention` through the
// custom VJP `_fa_bwd` (src/repro/models/attention.py:244), XLA einsums over query × KV
// chunks.  This file computes what `_fa_bwd` computes, as
// repro_torch/kernels/flash_attention/backward.py does in plain PyTorch, from the forward's
// output O and row stats m (natural log of the scaled scores) and l:
//
//   Δ   = rowsum(dO·O)                  lse = m·log2(e) + log2(max(l, 1e-30))  (base 2)
//   s   = q·kᵀ (bf16 products, fp32 sums), then as the forward forms it: s·scale, or under
//         a softcap c·tanh(s·scale / c) with the accurate tanhf
//   P   = exp2(s·log2(e) − lse)  where kept, else 0      (keep: causal, window, ragged ends)
//   dP  = dO·vᵀ;   dS = P·(dP − Δ)·(1 − tanh²)·scale      (the tanh term under a softcap)
//   dV  = Σ bf16(P)ᵀ·dO     dK = Σ bf16(dS)ᵀ·q     dQ = Σ bf16(dS)·k     (fp32 sums)
//
// P and dS are rounded to bf16 before their products, as the plain version and the JAX
// package round them to the operand dtype.  Masks are aligned at position 0, as in the
// forward kernels (the op refuses causal and windowed calls with Sq != Sk).  GQA is folded:
// query head h reads KV head h / G.
//
// What bounds it on an H100.  At llama3.2-1b's training shape (B = 4, S = 2048, 32/8
// heads, D = 64, causal) the backward needs 2.5× the forward's 68.8 GFLOP (S, dP, dV, dK
// and dQ against the forward's S and PV): 0.174 ms at the bf16 tensor-core peak of 989
// TFLOP/s, against 0.05 ms to move q, k, v, O, dO, the stats and the gradients once, so
// operations bound it.  Summing dQ over key tiles in one pass would take float atomics,
// whose order changes from run to run; this design recomputes S and dP in a second pass
// over the query tiles instead, 3.5× the forward's FLOPs in all, and is deterministic: two
// launches give the same bits (a restarted training run must equal an unbroken one).
//
// Design: three kernels on the caller's stream, all products on wgmma, no atomics.
// 1. Prologue: a warp per (batch, head, query row) writes Δ and lse as float32 [B, H,
//    Sq_pad] scratch, Sq_pad = Sq rounded up to 64, zeros in the padded rows, so that a
//    query tile's 64 values are one aligned 256-byte bulk copy.
// 2. dK/dV: one block per (KV head, batch, 64-key tile), the causal band's longest key
//    tiles first.  Keys are wgmma's M dimension.  The block holds its K and V tiles in
//    swizzled shared memory (one TMA load each) and walks, in a fixed order, the G query
//    heads that read its KV head and, for each, the query tiles of the key tile's band:
//    from the tile holding k0 (causal) to the one holding k0 + 63 + window − 1 (window),
//    clipped to Sq.  A producer warpgroup streams each step's Q and dO tiles (TMA) and
//    its lse and Δ (bulk copies) through a ring of kStages stages, each with a full and
//    an empty mbarrier.  Two consumer warpgroups split the work of a step, so that each
//    holds one 64 × D fp32 accumulator (D/2 registers a thread; both would not fit at
//    D = 256):
//      the P warpgroup:  Sᵀ = K·Qᵀ (wgmma m64n64k16, both operands K-major in shared
//                        memory), Pᵀ by ex2.approx with the scale and log2(e) folded into
//                        one FFMA (the forward's kLog2e folding), P·(1 − tanh²)·scale into
//                        a shared fp32 tile, then dV += Pᵀ·dO with Pᵀ packed to bf16 pairs
//                        in registers (the register-A form of wgmma) and dO read MN-major
//                        through the transpose-B bit;
//      the dS warpgroup: dPᵀ = V·dOᵀ (both K-major), then, once the P tile is written,
//                        dSᵀ = P·(1 − tanh²)·scale·(dPᵀ − Δ) and dK += dSᵀ·Q, dSᵀ from
//                        registers, Q MN-major.
//    Two named barriers hand the shared P tile from one warpgroup to the other.  dK and dV
//    stay in fp32 registers across all G heads and all query tiles and are written once,
//    so GQA needs no repeat and no second sum.
// 3. dQ: one block per (query head, batch, query tile of 64 rows per consumer warpgroup:
//    three at D <= 64, two at D >= 128), the causal band's longest tiles first.  The
//    block holds its Q and dO rows (TMA) and walks the forward's band of kBK-key tiles,
//    K and V streamed through a ring; per tile S = Q·Kᵀ and dP = dO·Vᵀ (both K-major),
//    P and dS in registers, dQ += dS·K with dS from registers and K MN-major.  kBK is
//    64, 32 at D = 256, where the fragments of 64 keys beside the 128-float dQ
//    accumulator would not fit in registers.
// In both, the producer warpgroup drops to 24 registers with setmaxnreg, so that each
// consumer thread gets 240 (160 with three consumer warpgroups); ptxas's report
// (build.log) must show 0 spill bytes in every instantiation.  Tiles that cross the
// diagonal, the window's edge or a ragged end take a masked body; P (and so dS) is 0 at
// every masked pair, rows past Sq and keys past Sk included, not only in the stores.
// TMA fills rows past the ends with zeros.  The TMA maps get the caller's strides, so k
// and v may be strided halves of one projection; O and dO are contiguous.
//
// Rounding.  Built without --use_fast_math.  The exponentials are ex2.approx.ftz, as in the
// forward; tanhf and log2f are the library functions.  The products take bf16 operands
// exactly and sum in fp32 in the tensor cores' order, so the results are within the bf16
// tolerance of the plain version, not bit for bit.

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

// Design constants (tests/test_torch_flash_bwd_kernel.py reads these lines).
constexpr int kKeys = 64;           // dK/dV: keys per block, wgmma's M
constexpr int kQueryTile = 64;      // dK/dV: query rows per ring stage
constexpr int kRowsPerWarpgroup = 64;   // dQ: query rows per consumer warpgroup
constexpr int kKeyTile = 64;        // dQ: keys per ring stage
constexpr int kKeyTile256 = 32;     // ... at D = 256
constexpr int kStages = 3;          // ring stages of both kernels
constexpr int kStages256 = 2;       // ... at D = 256
constexpr int kStatsPad = 64;       // Sq is padded to this for the lse and Δ scratch
constexpr int kRowsPerBlock = 8;    // prologue: one row a warp
constexpr int kSmemBudget = 232448;

// Shared-memory geometry of one head_dim.  A tile is stored as column boxes of
// kRowBytes-byte rows, each swizzled by TMA in atoms of 8 rows (the forward's layout).
template <int D>
struct Tile {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kAtom = 8 * kRowBytes;  // bytes of one swizzle atom (8 rows)
  // wgmma descriptor layout code: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kStg = D == 256 ? kStages256 : kStages;
  // dK/dV kernel: two consumer warpgroups and a producer.
  static constexpr int kKvThreads = 3 * 128;
  static constexpr int kKTile = kKeys * D * 2;       // bytes of the K or the V tile
  static constexpr int kQTile = kQueryTile * D * 2;  // bytes of a Q or a dO stage
  static constexpr int kPTile = kKeys * kQueryTile * 4;  // the shared fp32 P tile
  static constexpr int kSmemKv = 2 * kKTile + 2 * kStg * kQTile + kPTile +
                                 2 * kStg * kQueryTile * 4 + 128 + 1024;
  // dQ kernel: kWG consumer warpgroups of 64 query rows and a producer.
  static constexpr int kWG = D >= 128 ? 2 : 3;
  static constexpr int kBQ = kRowsPerWarpgroup * kWG;
  static constexpr int kQThreads = 128 * (kWG + 1);
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 240;
  static constexpr int kBK = D == 256 ? kKeyTile256 : kKeyTile;
  static constexpr int kRows = kRowsPerWarpgroup * D * 2;  // bytes of one warpgroup's rows
  static constexpr int kKvTile = kBK * D * 2;              // bytes of a K or a V stage
  static constexpr int kSmemQ = 2 * kWG * kRows + 2 * kStg * kKvTile + 128 + 1024;
  static_assert(kSmemKv <= kSmemBudget && kSmemQ <= kSmemBudget, "shared memory");
  static_assert(1 + 2 * kStg <= 16, "mbarriers fit their 128 bytes");
};

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

// A bulk copy of `bytes` contiguous bytes into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barriers between the two consumer warpgroups of the dK/dV kernel (256 threads).
constexpr int kPFull = 1, kPEmpty = 2;
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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

// 2^x by the special-function unit, as in the forward: the instruction exp2f is built on,
// without exp2f's rescaling for results below 2^-126 (those flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[64 x N] = A[64 rows, D] · B[N rows, D]ᵀ: D/16 wgmma steps along head_dim, both
// operands K-major in swizzled shared memory; a tile's column boxes hold ARows (BRows) rows.
// Not committed: the caller commits, so that two products can be one group.
template <int D, int N, int ARows, int BRows>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_tile, uint32_t b_tile) {
  using T = Tile<D>;
  const uint64_t da0 = smem_desc(a_tile, 16, T::kAtom, T::kLayout);
  const uint64_t db0 = smem_desc(b_tile, 16, T::kAtom, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / T::kBoxCols;
    const uint32_t col = (kk * 16 % T::kBoxCols) * 2;
    const uint64_t da = desc_add(da0, box * ARows * T::kRowBytes + col);
    const uint64_t db = desc_add(db0, box * BRows * T::kRowBytes + col);
    if constexpr (N == 64) wgmma_ss_n64(acc, da, db, kk > 0);
    else wgmma_ss_n32(acc, da, db, kk > 0);
  }
}

// acc[64 x D] += A[64 x 16·K16] · B[16·K16 rows, D]: A from registers (bf16 pairs), B
// MN-major in shared memory, read through the transpose-B bit (the forward's P·V form); a
// step moves 16 rows down the tile, and its column boxes are 16·K16·128 bytes apart (the
// descriptor's leading byte offset).
template <int D, int K16>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[K16][4],
                                         uint32_t b_tile) {
  using T = Tile<D>;
  const uint64_t b0 = smem_desc(b_tile, 16 * K16 * T::kRowBytes, T::kAtom, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    const uint64_t db = desc_add(b0, kk * 16 * T::kRowBytes);
    if constexpr (D == 16) wgmma_rs_n16(acc, a[kk], db);
    else if constexpr (D == 32) wgmma_rs_n32(acc, a[kk], db);
    else if constexpr (D == 64) wgmma_rs_n64(acc, a[kk], db);
    else if constexpr (D == 128) wgmma_rs_n128(acc, a[kk], db);
    else wgmma_rs_n256(acc, a[kk], db);
  }
}

// A 64 x N fp32 fragment as the bf16 A fragments of N/16 wgmma steps (elements 8·kk ..
// 8·kk + 7 are the 16 columns of step kk).
template <int N>
__device__ __forceinline__ void pack(uint32_t (&a)[N / 16][4], const float (&f)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(f[8 * kk + 2 * i], f[8 * kk + 2 * i + 1]);
  }
}

// What a warpgroup needs to know of the problem.  A thread holds rows r_lo and r_lo + 8 of
// its warpgroup's 64 and columns 8·g + c_th + {0, 1} of each 8-column group g of a
// fragment: element e is row r_lo + 8·((e >> 1) & 1), column 8·(e >> 2) + c_th + (e & 1).
struct Frag {
  int r_lo, c_th, Sq, Sk, causal, window;
  float scale, scale_log2, cap;

  __device__ __forceinline__ bool keep(int qpos, int kpos) const {
    return qpos < Sq && kpos < Sk && (!causal || qpos >= kpos) &&
           (window <= 0 || qpos - kpos < window);
  }
  // The base-2 exponent of P for a raw product x against the row's base-2 lse, and in
  // *fac what takes P to dS / (dP − Δ): (1 − tanh²)·scale under a softcap, else scale.
  template <bool kCap>
  __device__ __forceinline__ float exponent(float x, float lse, float* fac) const {
    if constexpr (kCap) {
      const float th = tanhf(x * scale / cap);
      *fac = (1.0f - th * th) * scale;
      return cap * th * kLog2e - lse;
    } else {
      *fac = scale;
      return fmaf(x, scale_log2, -lse);
    }
  }
};

// 1. Δ and lse of each (batch, head, row), a warp per row of the padded scratch.
__global__ void __launch_bounds__(256) prologue_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l, float* __restrict__ delta,
    float* __restrict__ lse, long long rows, int Sq, int Sq_pad, int H, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / Sq_pad;
  const int qi = static_cast<int>(row % Sq_pad);
  if (qi >= Sq) {
    if (lane == 0) delta[row] = lse[row] = 0.0f;
    return;
  }
  const long long base = ((bh / H * Sq + qi) * H + bh % H) * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(__bfloat162float(dout[base + d]), __bfloat162float(o[base + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float mi = m[bh * Sq + qi];
    delta[row] = acc;
    // a row that saw no key gets no gradient: exp2(x − ∞) = 0
    lse[row] = mi <= kNegInf ? INFINITY : fmaf(mi, kLog2e, log2f(fmaxf(l[bh * Sq + qi], 1e-30f)));
  }
}

// The P warpgroup's step: Pᵀ from Sᵀ in f (masked where kEdge), written as
// P·(1 − tanh²)·scale into the shared tile pP for the dS warpgroup; f keeps P for dV.
template <bool kCap, bool kEdge>
__device__ __forceinline__ void p_tile(float (&f)[32], float* pP, const float* pL, int t128,
                                       const Frag& w, int k0, int q0) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int col = 8 * (e >> 2) + w.c_th + (e & 1);
    float fac;
    float p = ex2(w.exponent<kCap>(f[e], pL[col], &fac));
    if constexpr (kEdge) {
      if (!w.keep(q0 + col, k0 + w.r_lo + 8 * ((e >> 1) & 1))) p = 0.0f;
    }
    f[e] = p;
    pP[e * 128 + t128] = p * fac;
  }
}

// 2. dK and dV of one 64-key tile.
template <int D, bool kCap>
__global__ void __launch_bounds__(Tile<D>::kKvThreads, 1) dkdv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
    int KV, int Sq_pad, float scale, int causal, int window, float cap) {
  using T = Tile<D>;
  constexpr int kStg = T::kStg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + T::kKTile;
  const uint32_t sQ = sV + T::kKTile;            // Q ring
  const uint32_t sO = sQ + kStg * T::kQTile;     // dO ring
  const uint32_t sP = sO + kStg * T::kQTile;     // P tile, [element][thread] floats
  const uint32_t sL = sP + T::kPTile;            // lse ring, 64 floats a stage
  const uint32_t sD = sL + kStg * kQueryTile * 4;  // Δ ring
  const uint32_t bars = sD + kStg * kQueryTile * 4;
  float* const pP = reinterpret_cast<float*>(smem_raw + (sP - raw));
  const float* const pL = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* const pD = reinterpret_cast<const float*>(smem_raw + (sD - raw));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStg + s); };

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;  // the causal band's longest key tiles first
  const int G = H / KV;
  // The key tile's band of query tiles: from the one holding k0 (causal) to the one
  // holding k0 + kKeys − 1 + window − 1 (window), clipped to Sq.
  const int q_lo = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + kKeys - 1 + window) : Sq;
  const int t_lo = q_lo / kQueryTile;
  const int nq = q_lo < q_end ? (q_end - 1) / kQueryTile + 1 - t_lo : 0;
  const int n = G * nq;  // steps: the G heads in order, each over the band's query tiles
  auto step_q0 = [&](int i) { return (t_lo + i % nq) * kQueryTile; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStg; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp of both warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup: it gives its registers to the consumers, and one thread
    // issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * T::kKTile);
      for (int c = 0; c < D / T::kBoxCols; ++c) {
        tma_load(sK + c * kKeys * T::kRowBytes, &tk, kv_full, c * T::kBoxCols, k0, kvh, b);
        tma_load(sV + c * kKeys * T::kRowBytes, &tv, kv_full, c * T::kBoxCols, k0, kvh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStg;
        const int h = kvh * G + i / nq;
        const int q0 = step_q0(i);
        mbar_wait(empty(s), ((i / kStg) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), 2 * T::kQTile + 2 * kQueryTile * 4);
        for (int c = 0; c < D / T::kBoxCols; ++c) {
          tma_load(sQ + s * T::kQTile + c * kQueryTile * T::kRowBytes, &tq, full(s),
                   c * T::kBoxCols, q0, h, b);
          tma_load(sO + s * T::kQTile + c * kQueryTile * T::kRowBytes, &tdo, full(s),
                   c * T::kBoxCols, q0, h, b);
        }
        const long long row = (static_cast<long long>(b) * H + h) * Sq_pad + q0;
        bulk_load(sL + s * kQueryTile * 4, lse + row, kQueryTile * 4, full(s));
        bulk_load(sD + s * kQueryTile * 4, delta + row, kQueryTile * 4, full(s));
      }
    }
    return;
  }

  // Consumer warpgroups over the block's 64 keys: 0 computes P and dV, 1 dS and dK.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  Frag w;
  w.r_lo = 16 * (t128 / 32) + lane / 4;
  w.c_th = 2 * (lane % 4);
  w.Sq = Sq;
  w.Sk = Sk;
  w.causal = causal;
  w.window = window;
  w.scale = scale;
  w.scale_log2 = scale * kLog2e;
  w.cap = cap;
  // A query tile needs the mask where it crosses the diagonal, the window's edge or an end.
  auto edge = [&](int q0) {
    return (causal && q0 < k0 + kKeys - 1) ||
           (window > 0 && q0 + kQueryTile - 1 - k0 >= window) || q0 + kQueryTile > Sq ||
           k0 + kKeys > Sk;
  };
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  float f[32];
  uint32_t a[4][4];

  mbar_wait(kv_full, 0);
  if (wg == 1) named_arrive(kPEmpty);  // the P tile starts free
  for (int i = 0; i < n; ++i) {
    const int s = i % kStg;
    const int q0 = step_q0(i);
    const uint32_t q_tile = sQ + s * T::kQTile;
    const uint32_t o_tile = sO + s * T::kQTile;
    mbar_wait(full(s), (i / kStg) & 1);
    __syncwarp();  // the .aligned wgmma instructions need the warp converged
    fence_regs(f);
    wgmma_fence();
    if (wg == 0) issue_ss<D, kQueryTile, kKeys, kQueryTile>(f, sK, q_tile);  // Sᵀ = K·Qᵀ
    else issue_ss<D, kQueryTile, kKeys, kQueryTile>(f, sV, o_tile);          // dPᵀ = V·dOᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(f);
    if (wg == 0) {
      named_sync(kPEmpty);  // the dS warpgroup has read the last step's tile
      const float* lrow = pL + s * kQueryTile;
      if (edge(q0)) p_tile<kCap, true>(f, pP, lrow, t128, w, k0, q0);
      else p_tile<kCap, false>(f, pP, lrow, t128, w, k0, q0);
      named_arrive(kPFull);
    } else {
      named_sync(kPFull);
      const float* drow = pD + s * kQueryTile;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        f[e] = pP[e * 128 + t128] * (f[e] - drow[8 * (e >> 2) + w.c_th + (e & 1)]);
      named_arrive(kPEmpty);
    }
    pack<kQueryTile>(a, f);
    fence_regs(acc);
    wgmma_fence();
    // dV += Pᵀ·dO (warpgroup 0), dK += dSᵀ·Q (warpgroup 1)
    issue_rs<D, kQueryTile / 16>(acc, a, wg == 0 ? o_tile : q_tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
  if (wg == 0) named_sync(kPEmpty);  // pairs the dS warpgroup's last arrival

  // dk, dv are fresh contiguous [B, Sk, KV, D] tensors
  __nv_bfloat16* const out = wg == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + w.r_lo + 8 * r;
    if (kpos >= Sk) continue;
    __nv_bfloat16* row = out + ((static_cast<long long>(b) * Sk + kpos) * KV + kvh) * D + w.c_th;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * g) =
          __floats2bfloat162_rn(acc[4 * g + 2 * r], acc[4 * g + 2 * r + 1]);
  }
}

// The dQ warpgroup's step: dS = P·(dP − Δ)·fac into s (masked where kEdge).
template <int BK, bool kCap, bool kEdge>
__device__ __forceinline__ void ds_tile(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                        const float (&lse)[2], const float (&dl)[2],
                                        const Frag& w, int qa, int k0) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = (e >> 1) & 1;
    float fac;
    float p = ex2(w.exponent<kCap>(s[e], lse[r], &fac));
    if constexpr (kEdge) {
      if (!w.keep(qa + w.r_lo + 8 * r, k0 + 8 * (e >> 2) + w.c_th + (e & 1))) p = 0.0f;
    }
    s[e] = p * (dp[e] - dl[r]) * fac;
  }
}

// 3. dQ of one query tile of kWG·64 rows.
template <int D, bool kCap>
__global__ void __launch_bounds__(Tile<D>::kQThreads, 1) dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KV, int Sq_pad, float scale,
    int causal, int window, float cap) {
  using T = Tile<D>;
  constexpr int BK = T::kBK;
  constexpr int kStg = T::kStg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + T::kWG * T::kRows;
  const uint32_t sK = sO + T::kWG * T::kRows;     // K ring
  const uint32_t sV = sK + kStg * T::kKvTile;     // V ring
  const uint32_t bars = sV + kStg * T::kKvTile;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStg + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kBQ;  // the causal band's longest first
  const int kvh = h / (H / KV);
  // The forward's band of key tiles for this query tile.
  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min((min(q0 + T::kBQ, Sq) - 1) / BK + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  auto stage = [&](int j) { return (j - lo) % kStg; };
  auto parity = [&](int j) { return static_cast<uint32_t>(((j - lo) / kStg) & 1); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStg; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), T::kWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::kWG * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == T::kWG * 128) {
      mbar_expect_tx(q_full, 2 * T::kWG * T::kRows);
      for (int half = 0; half < T::kWG; ++half)
        for (int c = 0; c < D / T::kBoxCols; ++c) {
          const uint32_t off = half * T::kRows + c * kRowsPerWarpgroup * T::kRowBytes;
          const int row = q0 + kRowsPerWarpgroup * half;
          tma_load(sQ + off, &tq, q_full, c * T::kBoxCols, row, h, b);
          tma_load(sO + off, &tdo, q_full, c * T::kBoxCols, row, h, b);
        }
      for (int j = lo; j < hi; ++j) {
        const int s = stage(j);
        mbar_wait(empty(s), parity(j) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), 2 * T::kKvTile);
        for (int c = 0; c < D / T::kBoxCols; ++c) {
          tma_load(sK + s * T::kKvTile + c * BK * T::kRowBytes, &tk, full(s), c * T::kBoxCols,
                   j * BK, kvh, b);
          tma_load(sV + s * T::kKvTile + c * BK * T::kRowBytes, &tv, full(s), c * T::kBoxCols,
                   j * BK, kvh, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup `wg` owns query rows [qa, qa + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs) : "memory");
  const int wg = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int qa = q0 + kRowsPerWarpgroup * wg;
  Frag w;
  w.r_lo = 16 * (t128 / 32) + lane / 4;
  w.c_th = 2 * (lane % 4);
  w.Sq = Sq;
  w.Sk = Sk;
  w.causal = causal;
  w.window = window;
  w.scale = scale;
  w.scale_log2 = scale * kLog2e;
  w.cap = cap;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + w.r_lo + 8 * r;
    const long long i = (static_cast<long long>(b) * H + h) * Sq_pad + qpos;
    lse_r[r] = qpos < Sq ? lse[i] : 0.0f;
    dl_r[r] = qpos < Sq ? delta[i] : 0.0f;
  }
  // This warpgroup's own band inside [lo, hi); a tile outside it no row here sees, so it
  // is only waited for and released.  Rows past Sq see nothing.
  const int lo_w = max(lo, window > 0 ? max(qa - window + 1, 0) / BK : 0);
  const int hi_w = qa >= Sq ? lo_w : min(hi, causal ? (min(qa + 64, Sq) - 1) / BK + 1 : nk);
  auto edge = [&](int k0) {
    return (causal && k0 + BK - 1 > qa) || (window > 0 && qa + 63 - k0 >= window) ||
           k0 + BK > Sk;
  };
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  float sf[BK / 2], dpf[BK / 2];
  uint32_t a[BK / 16][4];

  mbar_wait(q_full, 0);
  for (int j = lo; j < hi; ++j) {
    const int s = stage(j);
    mbar_wait(full(s), parity(j));
    __syncwarp();
    if (j >= lo_w && j < hi_w) {
      const uint32_t k_tile = sK + s * T::kKvTile;
      fence_regs(sf);
      fence_regs(dpf);
      wgmma_fence();
      issue_ss<D, BK, kRowsPerWarpgroup, BK>(sf, sQ + wg * T::kRows, k_tile);  // S = Q·Kᵀ
      issue_ss<D, BK, kRowsPerWarpgroup, BK>(dpf, sO + wg * T::kRows,
                                             sV + s * T::kKvTile);           // dP = dO·Vᵀ
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sf);
      fence_regs(dpf);
      if (edge(j * BK)) ds_tile<BK, kCap, true>(sf, dpf, lse_r, dl_r, w, qa, j * BK);
      else ds_tile<BK, kCap, false>(sf, dpf, lse_r, dl_r, w, qa, j * BK);
      pack<BK>(a, sf);
      fence_regs(acc);
      wgmma_fence();
      issue_rs<D, BK / 16>(acc, a, k_tile);  // dQ += dS·K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
    }
    if (lane == 0) mbar_arrive(empty(s));
  }

  // dq is a fresh contiguous [B, Sq, H, D] tensor
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + w.r_lo + 8 * r;
    if (qpos >= Sq) continue;
    __nv_bfloat16* row = dq + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D + w.c_th;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * g) =
          __floats2bfloat162_rn(acc[4 * g + 2 * r], acc[4 * g + 2 * r + 1]);
  }
}

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

struct Args {
  const void *o, *dout;
  const float *m, *l;
  float *delta, *lse;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, Sq_pad, causal, window, has_cap;
  float scale, cap;
};

// maps: q, dO, k, v with 64-row boxes, then k, v with Tile<D>::kBK-row boxes (dQ's).
template <int D>
int launch(const CUtensorMap (&maps)[6], const Args& a, cudaStream_t stream) {
  using T = Tile<D>;
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq_pad;
  prologue_kernel<<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock), 256, 0,
                    stream>>>(static_cast<const __nv_bfloat16*>(a.o),
                              static_cast<const __nv_bfloat16*>(a.dout), a.m, a.l, a.delta,
                              a.lse, rows, a.Sq, a.Sq_pad, a.H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kv = a.has_cap ? dkdv_kernel<D, true> : dkdv_kernel<D, false>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemKv);
  if (err != cudaSuccess) return static_cast<int>(err);
  kv<<<dim3(a.KV, a.B, (a.Sk + kKeys - 1) / kKeys), T::kKvThreads, T::kSmemKv, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, a.dk, a.dv, a.Sq, a.Sk, a.H, a.KV,
      a.Sq_pad, a.scale, a.causal, a.window, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto qk = a.has_cap ? dq_kernel<D, true> : dq_kernel<D, false>;
  err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  qk<<<dim3(a.H, a.B, (a.Sq + T::kBQ - 1) / T::kBQ), T::kQThreads, T::kSmemQ, stream>>>(
      maps[0], maps[1], maps[4], maps[5], a.lse, a.delta, a.dq, a.Sq, a.Sk, a.H, a.KV,
      a.Sq_pad, a.scale, a.causal, a.window, a.cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` without synchronizing; returns 0, a CUDA error
// code, or one of the codes above.  q: [B, Sq, H, D]; k, v: [B, Sk, KV, D], bfloat16, each
// described by its tensor-map arguments (ops.tma_map_args): q, dout, k and v with 64-row
// boxes, then k and v again with ops.bwd_kv_box_rows(D)-row boxes for the dQ kernel; o,
// dout: contiguous bfloat16 [B, Sq, H, D]; m, l: contiguous float32 [B, H, Sq], the forward's
// row stats; dq: contiguous bfloat16 [B, Sq, H, D]; dk, dv: contiguous bfloat16 [B, Sk, KV,
// D]; delta, lse: contiguous float32 [B, H, Sq_pad] scratch, Sq_pad = Sq rounded up to 64.
// window <= 0 means none; has_cap = 0 means no softcap.  The caller checks D in {16, 32,
// 64, 128, 256}, H % KV == 0, the alignment TMA needs and the grid's limits.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* m, const void* l, void* dq, void* dk, void* dv, void* delta, void* lse,
    const unsigned long long* q_map, const unsigned long long* do_map,
    const unsigned long long* k_map, const unsigned long long* v_map,
    const unsigned long long* k_map_dq, const unsigned long long* v_map_dq, int B, int Sq,
    int Sk, int H, int KV, int D, int Sq_pad, float scale, int causal, int window,
    int has_cap, float cap, void* stream) {
  CUtensorMap maps[6];
  const void* ptrs[6] = {q, dout, k, v, k, v};
  const unsigned long long* args[6] = {q_map, do_map, k_map, v_map, k_map_dq, v_map_dq};
  for (int i = 0; i < 6; ++i) {
    const int rc = encode(&maps[i], ptrs[i], args[i]);
    if (rc != 0) return rc;
  }
  Args a;
  a.o = o;
  a.dout = dout;
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<float*>(delta);
  a.lse = static_cast<float*>(lse);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.KV = KV, a.Sq_pad = Sq_pad;
  a.causal = causal, a.window = window, a.has_cap = has_cap;
  a.scale = scale, a.cap = cap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(maps, a, st);
    case 32: return launch<32>(maps, a, st);
    case 64: return launch<64>(maps, a, st);
    case 128: return launch<128>(maps, a, st);
    case 256: return launch<256>(maps, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the dK/dV (which = 0) or dQ (which = 1) kernel at head_dim D
// (0 for a D the kernels do not take): tiles, rings, scratch, mbarriers and the
// alignment slack.
extern "C" int flash_attention_bwd_wgmma_smem_bytes(int D, int which) {
  switch (D) {
    case 16: return which == 0 ? Tile<16>::kSmemKv : Tile<16>::kSmemQ;
    case 32: return which == 0 ? Tile<32>::kSmemKv : Tile<32>::kSmemQ;
    case 64: return which == 0 ? Tile<64>::kSmemKv : Tile<64>::kSmemQ;
    case 128: return which == 0 ? Tile<128>::kSmemKv : Tile<128>::kSmemQ;
    case 256: return which == 0 ? Tile<256>::kSmemKv : Tile<256>::kSmemQ;
    default: return 0;
  }
}
