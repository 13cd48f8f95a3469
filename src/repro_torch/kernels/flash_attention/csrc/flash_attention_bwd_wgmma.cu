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
// What kept the tensor cores idle is the waits between the products, not the products: a
// warpgroup that issues one product and waits for it at once runs no exponential under
// it, two warpgroups that hand P to each other through shared memory take turns, and a
// last product waited for before the next step's first keeps the next step from starting.
// So every warpgroup here keeps a product in flight while it computes: its score products
// go in two commit groups, the exponentials of the first run under the second, and the
// products that consume P and dS are left in flight until the next step's first wait.
// Commit groups complete in order, so that wait also frees the registers the pending
// products read (P's and dS's bf16 pairs) and the ring stage they read; the stage is
// released to the producer there.  ptxas serializes every wgmma of a kernel where it finds
// an accumulator set by another instruction while some product is in flight (its info
// C7515 in build.log); the accumulators' zeros are therefore pinned before the loop (left
// to the compiler, they were set just before the first dV and dK products), and no
// accumulator is touched by anything but its products until the last wait.  A branch
// around the products cost more than the wholly masked tiles it would skip, so no
// warpgroup skips a tile of its block's band: such a tile takes the masked body.
//
// Design: three kernels on the caller's stream, all products on wgmma, no atomics.
// 1. Prologue: Δ and lse as float32 [B, H, Sq_pad] scratch, Sq_pad = Sq rounded up to 64,
//    zeros in the padded rows, so that a query tile's 64 values are one aligned 256-byte
//    bulk copy.  D/8 lanes share a row, each with one 16-byte load of 8 bf16 values of O
//    and of dO and a sum over the row's lanes by shuffles; a thread reads
//    kPrologueRowsPerThread rows, all their loads issued before any sum, so that a block
//    of kPrologueThreads threads takes 8·kPrologueThreads·kPrologueRowsPerThread/D rows.
//    It moves O and dO once: bytes bound it.
// 2. dK/dV: one block per (KV head, batch, key tile), the causal band's longest key tiles
//    first.  Keys are wgmma's M dimension.  The block holds its K and V tiles in swizzled
//    shared memory (one TMA load each) and walks, in a fixed order, the G query heads that
//    read its KV head and, for each, the query tiles of the key tile's band: from the tile
//    holding k0 (causal) to the one holding the tile's last key + window − 1 (window),
//    clipped to Sq.  A producer warpgroup streams each step's Q and dO tiles (TMA) and its
//    lse and Δ (bulk copies) through a ring of kStages stages, each with a full and an
//    empty mbarrier.  dK and dV stay in fp32 registers across all G heads and all query
//    tiles and are written once, so GQA needs no repeat and no second sum.
//    At D <= kOwnKeysMaxD a block holds kKeys = 128 keys, and each of its two consumer
//    warpgroups owns kKeysPerWarpgroup = 64 of them and does the whole step for them, both
//    accumulators in its registers (D fp32 a thread):
//      Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ (wgmma m64n64k16, both operands K-major in shared
//      memory), two commit groups; Pᵀ by ex2.approx with the scale and log2(e) folded into
//      one FFMA (the forward's kLog2e folding) while dPᵀ runs; dV += Pᵀ·dO issued at once
//      (Pᵀ packed to bf16 pairs in registers, the register-A form of wgmma; dO read
//      MN-major through the transpose-B bit); dSᵀ = P·(1 − tanh²)·scale·(dPᵀ − Δ) while
//      dV runs; dK += dSᵀ·Q issued and left in flight into the next step.
//    One ring stage feeds both warpgroups, so a stage's bytes serve 128 keys.  The block's
//    first query tile lies wholly above warpgroup 1's keys under the causal mask; it goes
//    through the masked body (P = 0) with the rest of the band.  At D = 128 the two
//    accumulators, the score fragments and the packed operands of products in flight fill
//    the 240 registers, and ptxas serializes that instantiation's wgmma for want of
//    registers (its note in build.log; no spill); it still beats the split design below
//    at qwen3-moe's shape, so D = 128 stays here by the fixed rule.
//    At D > kOwnKeysMaxD (D = 256) the two accumulators alone would take 256 registers a
//    thread, so a block holds kKeysSplit = 64 keys and its two warpgroups split the step:
//      the P warpgroup:  Sᵀ = K·Qᵀ, Pᵀ, P·(1 − tanh²)·scale into a shared fp32 tile, then
//                        dV += Pᵀ·dO;
//      the dS warpgroup: dPᵀ = V·dOᵀ, then, once the P tile is written,
//                        dSᵀ = P·(1 − tanh²)·scale·(dPᵀ − Δ) and dK += dSᵀ·Q.
//    Two named barriers hand the shared P tile from one warpgroup to the other.  Each
//    warpgroup waits at its barrier while its first product runs, and leaves its dV or dK
//    product in flight into the next step.  Neither warpgroup branches around a product
//    (a branch on the warpgroup around wgmma made ptxas serialize them, its C7520).
// 3. dQ: one block per (query head, batch, query tile of kDqWarpgroups·64 rows, 64 a
//    consumer warpgroup), the causal band's longest tiles first.  The block holds its Q
//    and dO rows (TMA) and walks the forward's band of kBK-key tiles, K and V streamed
//    through a ring; per tile S = Q·Kᵀ and dP = dO·Vᵀ (both K-major) in two commit groups,
//    P's exponentials while dP runs, dS in registers, dQ += dS·K with dS from registers and
//    K MN-major, left in flight into the next tile.  kBK is 128 at D <= 64 (m64n128
//    score products: half the tiles, and fewer shared-memory bytes a product), 64 at D =
//    128 and 32 at D = 256, as many keys as the score fragments beside the dQ accumulator
//    leave registers for.  A tile of the block's band outside a warpgroup's own takes the
//    masked body.
// In both, the producer warpgroup drops to 24 registers with setmaxnreg, so that each
// consumer thread gets 240; ptxas's report (build.log) must show 0 spill bytes in every
// instantiation.  Tiles that cross the
// diagonal, the window's edge or a ragged end take a masked body; P (and so dS) is 0 at
// every masked pair, rows past Sq and keys past Sk included, not only in the stores.
// TMA fills rows past the ends with zeros.  The TMA maps get the caller's strides, so k
// and v may be strided halves of one projection; O and dO are contiguous and 16-byte
// aligned.
//
// Rounding.  Built without --use_fast_math.  The exponentials are ex2.approx.ftz, as in the
// forward; tanhf and log2f are the library functions.  The products take bf16 operands
// exactly and sum in fp32 in the tensor cores' order, so the results are within the bf16
// tolerance of the plain version, not bit for bit.

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

// Design constants (tests/test_torch_flash_bwd_kernel.py reads these lines).
constexpr int kKeys = 128;              // dK/dV at D <= kOwnKeysMaxD: keys per block
constexpr int kKeysPerWarpgroup = 64;   // ... a consumer warpgroup's own keys, wgmma's M
constexpr int kKeysSplit = 64;          // dK/dV at D > kOwnKeysMaxD: keys per block
constexpr int kOwnKeysMaxD = 128;       // the largest head_dim whose warpgroups own keys
constexpr int kQueryTile = 64;          // dK/dV: query rows per ring stage
constexpr int kRowsPerWarpgroup = 64;   // dQ: query rows per consumer warpgroup
constexpr int kDqWarpgroups = 2;        // dQ: consumer warpgroups a block
constexpr int kKeyTile = 128;           // dQ: keys per ring stage at D <= 64
constexpr int kKeyTile128 = 64;         // ... at D = 128
constexpr int kKeyTile256 = 32;         // ... at D = 256
constexpr int kStages = 4;              // ring stages of both kernels
constexpr int kStages256 = 2;           // ... at D = 256
constexpr int kStatsPad = 64;           // Sq is padded to this for the lse and Δ scratch
constexpr int kPrologueThreads = 256;   // prologue: D/8 lanes a row, 16 bytes a lane
constexpr int kPrologueRowsPerThread = 4;  // ... rows a thread reads, all loads in flight
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
  static constexpr int kPrologueRows = kPrologueThreads / (D / 8);
  // dK/dV kernel: two consumer warpgroups and a producer; each warpgroup owns its keys
  // (kOwn), or the two split the steps of one 64-key block and share a P tile.
  static constexpr bool kOwn = D <= kOwnKeysMaxD;
  static constexpr int kBlockKeys = kOwn ? kKeys : kKeysSplit;
  static constexpr int kKvThreads = 3 * 128;
  static constexpr int kKTile = kBlockKeys * D * 2;  // bytes of the K or the V tile
  static constexpr int kQTile = kQueryTile * D * 2;  // bytes of a Q or a dO stage
  static constexpr int kPTile = kOwn ? 0 : kKeysSplit * kQueryTile * 4;  // the shared P tile
  static constexpr int kSmemKv = 2 * kKTile + 2 * kStg * kQTile + kPTile +
                                 2 * kStg * kQueryTile * 4 + 128 + 1024;
  // dQ kernel: kWG consumer warpgroups of 64 query rows and a producer; kBK keys a stage,
  // as many as the score fragments (kBK fp32 a thread) beside the dQ accumulator allow.
  static constexpr int kWG = kDqWarpgroups;
  static constexpr int kBQ = kRowsPerWarpgroup * kWG;
  static constexpr int kQThreads = 128 * (kWG + 1);
  static constexpr int kBK = D == 256 ? kKeyTile256 : D == 128 ? kKeyTile128 : kKeyTile;
  static constexpr int kRows = kRowsPerWarpgroup * D * 2;  // bytes of one warpgroup's rows
  static constexpr int kKvTile = kBK * D * 2;              // bytes of a K or a V stage
  static constexpr int kSmemQ = 2 * kWG * kRows + 2 * kStg * kKvTile + 128 + 1024;
  static_assert(kSmemKv <= kSmemBudget && kSmemQ <= kSmemBudget, "shared memory");
  static_assert(1 + 2 * kStg <= 16, "mbarriers fit their 128 bytes");
  static_assert(kBlockKeys <= 256, "a TMA box has at most 256 rows");
};

// Named barriers between the two consumer warpgroups of the dK/dV kernel (256 threads).
constexpr int kPFull = 1, kPEmpty = 2;
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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
    if constexpr (N == 128) wgmma_ss_n128(acc, da, db, kk > 0);
    else if constexpr (N == 64) wgmma_ss_n64(acc, da, db, kk > 0);
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
// The bf16 pair a[kk][i] of a packed fragment holds elements 8·kk + 2·i and 8·kk + 2·i + 1:
// row r_lo + 8·(i & 1), columns 16·kk + 8·(i >> 1) + c_th + {0, 1}.
struct Frag {
  int r_lo, c_th, Sq, Sk, causal, window;
  float scale, scale_log2, cap;

  __device__ __forceinline__ Frag(int t128, int Sq_, int Sk_, int causal_, int window_,
                                  float scale_, float cap_)
      : r_lo(16 * (t128 / 32) + t128 % 32 / 4), c_th(2 * (t128 % 4)), Sq(Sq_), Sk(Sk_),
        causal(causal_), window(window_), scale(scale_), scale_log2(scale_ * kLog2e),
        cap(cap_) {}

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

// 1. Δ and lse of each (batch, head, row) of the padded scratch: D/8 neighbouring lanes a
// row, each with one 16-byte load of O and one of dO; a block takes kPrologueRowsPerThread
// passes of kPrologueRows rows, all of whose loads are issued before any sum.
template <int D>
__global__ void __launch_bounds__(kPrologueThreads) prologue_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l, float* __restrict__ delta,
    float* __restrict__ lse, long long rows, int Sq, int Sq_pad, int H) {
  constexpr int kLanes = D / 8;
  constexpr int kR = kPrologueRowsPerThread;
  const int part = threadIdx.x % kLanes;
  long long row[kR], bh[kR];
  int qi[kR];
  uint4 ov[kR], dv[kR];
  float mi[kR], li[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    row[j] = (static_cast<long long>(blockIdx.x) * kR + j) * Tile<D>::kPrologueRows +
             threadIdx.x / kLanes;
    const bool live = row[j] < rows;
    bh[j] = live ? row[j] / Sq_pad : 0;
    qi[j] = live ? static_cast<int>(row[j] % Sq_pad) : Sq;
    ov[j] = dv[j] = make_uint4(0u, 0u, 0u, 0u);
    mi[j] = li[j] = 0.0f;
    if (qi[j] < Sq) {
      const long long at = ((bh[j] / H * Sq + qi[j]) * H + bh[j] % H) * D + 8 * part;
      ov[j] = __ldg(reinterpret_cast<const uint4*>(o + at));
      dv[j] = __ldg(reinterpret_cast<const uint4*>(dout + at));
      if (part == 0) {
        mi[j] = m[bh[j] * Sq + qi[j]];
        li[j] = l[bh[j] * Sq + qi[j]];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const uint32_t ow[4] = {ov[j].x, ov[j].y, ov[j].z, ov[j].w};
    const uint32_t dw[4] = {dv[j].x, dv[j].y, dv[j].z, dv[j].w};
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = unpack_bf16(ow[i]);
      const float2 d = unpack_bf16(dw[i]);
      acc = fmaf(d.x, a.x, acc);
      acc = fmaf(d.y, a.y, acc);
    }
    // A row's lanes are kLanes aligned neighbours, so xor shuffles stay among them; every
    // lane of the warp takes part.
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row[j] >= rows || part != 0) continue;
    if (qi[j] >= Sq) {
      delta[row[j]] = lse[row[j]] = 0.0f;
      continue;
    }
    delta[row[j]] = acc;
    // a row that saw no key gets no gradient: exp2(x − ∞) = 0
    lse[row[j]] = mi[j] <= kNegInf ? INFINITY : fmaf(mi[j], kLog2e, log2f(fmaxf(li[j], 1e-30f)));
  }
}

// The dK/dV producer (one thread): the block's K and V tiles of kBlockKeys rows once, then
// each step's Q and dO tiles, lse and Δ into ring stage i % kStg.
template <int D>
__device__ __forceinline__ void kv_producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const float* lse, const float* delta,
                                            uint32_t sK, uint32_t sV, uint32_t sQ,
                                            uint32_t sO, uint32_t sL, uint32_t sD,
                                            uint32_t bars, int kvh, int b, int k0, int G,
                                            int H, int Sq_pad, int n, int nq, int t_lo) {
  using T = Tile<D>;
  constexpr int kStg = T::kStg;
  const uint32_t kv_full = bars;
  mbar_expect_tx(kv_full, 2 * T::kKTile);
  for (int c = 0; c < D / T::kBoxCols; ++c) {
    tma_load(sK + c * T::kBlockKeys * T::kRowBytes, tk, kv_full, c * T::kBoxCols, k0, kvh, b);
    tma_load(sV + c * T::kBlockKeys * T::kRowBytes, tv, kv_full, c * T::kBoxCols, k0, kvh, b);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % kStg;
    const uint32_t full = bars + 8u * (1 + s), empty = bars + 8u * (1 + kStg + s);
    const int h = kvh * G + i / nq;
    const int q0 = (t_lo + i % nq) * kQueryTile;
    mbar_wait(empty, ((i / kStg) & 1) ^ 1);  // the first round passes at once
    mbar_expect_tx(full, 2 * T::kQTile + 2 * kQueryTile * 4);
    for (int c = 0; c < D / T::kBoxCols; ++c) {
      tma_load(sQ + s * T::kQTile + c * kQueryTile * T::kRowBytes, tq, full, c * T::kBoxCols,
               q0, h, b);
      tma_load(sO + s * T::kQTile + c * kQueryTile * T::kRowBytes, tdo, full,
               c * T::kBoxCols, q0, h, b);
    }
    const long long row = (static_cast<long long>(b) * H + h) * Sq_pad + q0;
    bulk_load(sL + s * kQueryTile * 4, lse + row, kQueryTile * 4, full);
    bulk_load(sD + s * kQueryTile * 4, delta + row, kQueryTile * 4, full);
  }
}

// Writes a warpgroup's 64 rows of dK or dV (from acc) to the fresh contiguous [B, Sk, KV,
// D] tensor out, rows from ka, those past Sk left out.
template <int D>
__device__ __forceinline__ void store_keys(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           const Frag& w, int b, int ka, int kvh, int KV) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = ka + w.r_lo + 8 * r;
    if (kpos >= w.Sk) continue;
    __nv_bfloat16* row =
        out + ((static_cast<long long>(b) * w.Sk + kpos) * KV + kvh) * D + w.c_th;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * g) =
          __floats2bfloat162_rn(acc[4 * g + 2 * r], acc[4 * g + 2 * r + 1]);
  }
}

// A warpgroup's Pᵀ from Sᵀ in f (masked where kEdge; keys from ka, queries from q0, the
// row's lse in pL): P's bf16 pairs into a, dV's A operand, and P·(1 − tanh²)·scale into f
// for dS.
template <bool kCap, bool kEdge>
__device__ __forceinline__ void p_frags(float (&f)[32], uint32_t (&a)[4][4], const float* pL,
                                        const Frag& w, int ka, int q0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 2 * i;
      const int col = 16 * kk + 8 * (i >> 1) + w.c_th;
      const float2 lse = *reinterpret_cast<const float2*>(pL + col);
      float fac0, fac1;
      float p0 = ex2(w.exponent<kCap>(f[e], lse.x, &fac0));
      float p1 = ex2(w.exponent<kCap>(f[e + 1], lse.y, &fac1));
      if constexpr (kEdge) {
        const int kpos = ka + w.r_lo + 8 * (i & 1);
        if (!w.keep(q0 + col, kpos)) p0 = 0.0f;
        if (!w.keep(q0 + col + 1, kpos)) p1 = 0.0f;
      }
      a[kk][i] = pack_bf16(p0, p1);
      f[e] = p0 * fac0;
      f[e + 1] = p1 * fac1;
    }
  }
}

// A warpgroup's dSᵀ = P·fac·(dPᵀ − Δ) (pf from p_frags, the columns' Δ in pD) as the bf16
// pairs of dK's A operand.
__device__ __forceinline__ void ds_frags(const float (&pf)[32], const float (&dp)[32],
                                         uint32_t (&a)[4][4], const float* pD, int c_th) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 2 * i;
      const float2 d = *reinterpret_cast<const float2*>(pD + 16 * kk + 8 * (i >> 1) + c_th);
      a[kk][i] = pack_bf16(pf[e] * (dp[e] - d.x), pf[e + 1] * (dp[e + 1] - d.y));
    }
  }
}

// 2. dK and dV of one block of kKeys keys at D <= kOwnKeysMaxD: consumer warpgroup wg owns
// keys [k0 + 64·wg, k0 + 64·wg + 64) and does every product of a step for them.
template <int D, bool kCap>
__global__ void __launch_bounds__(Tile<D>::kKvThreads, 1) dkdv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
    int KV, int Sq_pad, float scale, int causal, int window, float cap) {
  using T = Tile<D>;
  static_assert(T::kOwn && T::kBlockKeys == 2 * kKeysPerWarpgroup, "own-keys geometry");
  constexpr int kStg = T::kStg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + T::kKTile;
  const uint32_t sQ = sV + T::kKTile;            // Q ring
  const uint32_t sO = sQ + kStg * T::kQTile;     // dO ring
  const uint32_t sL = sO + kStg * T::kQTile;     // lse ring, 64 floats a stage
  const uint32_t sD = sL + kStg * kQueryTile * 4;  // Δ ring
  const uint32_t bars = sD + kStg * kQueryTile * 4;
  const float* const pL = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* const pD = reinterpret_cast<const float*>(smem_raw + (sD - raw));
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStg + s); };

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;  // the causal band's longest key tiles first
  const int G = H / KV;
  // The block's band of query tiles: from the one holding k0 (causal) to the one holding
  // k0 + kKeys − 1 + window − 1 (window), clipped to Sq.
  const int q_lo = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + kKeys - 1 + window) : Sq;
  const int t_lo = q_lo / kQueryTile;
  const int nq = q_lo < q_end ? (q_end - 1) / kQueryTile + 1 - t_lo : 0;
  const int n = G * nq;  // steps: the G heads in order, each over the band's query tiles

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
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
    if (threadIdx.x == 256)
      kv_producer<D>(&tq, &tdo, &tk, &tv, lse, delta, sK, sV, sQ, sO, sL, sD, bars, kvh, b,
                     k0, G, H, Sq_pad, n, nq, t_lo);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const Frag w(threadIdx.x % 128, Sq, Sk, causal, window, scale, cap);
  const int ka = k0 + kKeysPerWarpgroup * wg;  // this warpgroup's keys [ka, ka + 64)
  const uint32_t k_rows = sK + kKeysPerWarpgroup * wg * T::kRowBytes;
  const uint32_t v_rows = sV + kKeysPerWarpgroup * wg * T::kRowBytes;
  // Whether the query tile from q0 needs the mask for this warpgroup's keys: it crosses the
  // diagonal, the window's edge or an end, or lies wholly past them.  A tile with no kept
  // pair of these keys (above them under the causal mask: the block's first tile for
  // warpgroup 1) goes through the masked body too: a branch around the products costs
  // more than the one masked tile a head.
  auto edge = [&](int q0) {
    return (causal && q0 < ka + kKeysPerWarpgroup - 1) ||
           (window > 0 && q0 + kQueryTile - 1 - ka >= window) || q0 + kQueryTile > Sq ||
           ka + kKeysPerWarpgroup > Sk;
  };
  float acc_v[D / 2], acc_k[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_v[e] = acc_k[e] = 0.0f;
  // The zeros are set here: left to the compiler, they would be set just before the first
  // dV or dK product, while another product is in flight, and ptxas would then serialize
  // every wgmma of the kernel.
  fence_regs(acc_v);
  fence_regs(acc_k);
  float sf[32], dpf[32];
  uint32_t ap[4][4], ads[4][4];  // the bf16 pairs of Pᵀ and dSᵀ, read by dV's and dK's products

  mbar_wait(bars, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStg;
    const int q0 = (t_lo + i % nq) * kQueryTile;
    const uint32_t q_tile = sQ + s * T::kQTile;
    const uint32_t o_tile = sO + s * T::kQTile;
    mbar_wait(full(s), (i / kStg) & 1);
    __syncwarp();  // the .aligned wgmma instructions need the warp converged
    fence_regs(sf);
    fence_regs(dpf);
    wgmma_fence();
    issue_ss<D, kQueryTile, kKeys, kQueryTile>(sf, k_rows, q_tile);  // Sᵀ = K·Qᵀ
    wgmma_commit();
    issue_ss<D, kQueryTile, kKeys, kQueryTile>(dpf, v_rows, o_tile);  // dPᵀ = V·dOᵀ
    wgmma_commit();
    wgmma_wait<1>();  // Sᵀ done, and before it the last step's dV and dK
    fence_regs(sf);
    if (lane == 0 && i > 0) mbar_arrive(empty((i - 1) % kStg));  // the stage they read
    __syncwarp();
    const float* lrow = pL + s * kQueryTile;
    if (edge(q0)) p_frags<kCap, true>(sf, ap, lrow, w, ka, q0);
    else p_frags<kCap, false>(sf, ap, lrow, w, ka, q0);
    wgmma_fence();
    issue_rs<D, kQueryTile / 16>(acc_v, ap, o_tile);  // dV += Pᵀ·dO
    wgmma_commit();
    wgmma_wait<1>();  // dPᵀ done; dV runs on under dS
    fence_regs(dpf);
    ds_frags(sf, dpf, ads, pD + s * kQueryTile, w.c_th);
    wgmma_fence();
    issue_rs<D, kQueryTile / 16>(acc_k, ads, q_tile);  // dK += dSᵀ·Q, on into the next step
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc_v);
  fence_regs(acc_k);
  store_keys<D>(dv, acc_v, w, b, ka, kvh, KV);
  store_keys<D>(dk, acc_k, w, b, ka, kvh, KV);
}

// The split design's P warpgroup step: Pᵀ from Sᵀ in f (masked where kEdge), written as
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

// 2'. dK and dV of one block of kKeysSplit keys at D > kOwnKeysMaxD: warpgroup 0 computes
// P and dV, warpgroup 1 dS and dK.
template <int D, bool kCap>
__global__ void __launch_bounds__(Tile<D>::kKvThreads, 1) dkdv_split_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
    int KV, int Sq_pad, float scale, int causal, int window, float cap) {
  using T = Tile<D>;
  static_assert(!T::kOwn && T::kBlockKeys == kKeysSplit, "split geometry");
  constexpr int kStg = T::kStg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + T::kKTile;
  const uint32_t sQ = sV + T::kKTile;            // Q ring
  const uint32_t sO = sQ + kStg * T::kQTile;     // dO ring
  const uint32_t sL = sO + kStg * T::kQTile;     // lse ring, 64 floats a stage
  const uint32_t sD = sL + kStg * kQueryTile * 4;  // Δ ring
  const uint32_t sP = sD + kStg * kQueryTile * 4;  // P tile, [element][thread] floats
  const uint32_t bars = sP + T::kPTile;
  float* const pP = reinterpret_cast<float*>(smem_raw + (sP - raw));
  const float* const pL = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* const pD = reinterpret_cast<const float*>(smem_raw + (sD - raw));
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStg + s); };

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKeysSplit;  // the causal band's longest key tiles first
  const int G = H / KV;
  const int q_lo = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + kKeysSplit - 1 + window) : Sq;
  const int t_lo = q_lo / kQueryTile;
  const int nq = q_lo < q_end ? (q_end - 1) / kQueryTile + 1 - t_lo : 0;
  const int n = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStg; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp of both warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256)
      kv_producer<D>(&tq, &tdo, &tk, &tv, lse, delta, sK, sV, sQ, sO, sL, sD, bars, kvh, b,
                     k0, G, H, Sq_pad, n, nq, t_lo);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const Frag w(t128, Sq, Sk, causal, window, scale, cap);
  auto edge = [&](int q0) {
    return (causal && q0 < k0 + kKeysSplit - 1) ||
           (window > 0 && q0 + kQueryTile - 1 - k0 >= window) || q0 + kQueryTile > Sq ||
           k0 + kKeysSplit > Sk;
  };
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  fence_regs(acc);  // the zeros set here, before any product is in flight
  float f[32];
  uint32_t a[4][4];

  mbar_wait(bars, 0);
  if (wg == 1) named_arrive(kPEmpty);  // the P tile starts free
  for (int i = 0; i < n; ++i) {
    const int s = i % kStg;
    const int q0 = (t_lo + i % nq) * kQueryTile;
    const uint32_t q_tile = sQ + s * T::kQTile;
    const uint32_t o_tile = sO + s * T::kQTile;
    mbar_wait(full(s), (i / kStg) & 1);
    __syncwarp();
    fence_regs(f);
    wgmma_fence();
    // Sᵀ = K·Qᵀ (warpgroup 0), dPᵀ = V·dOᵀ (warpgroup 1): one instruction stream for
    // both, as a branch around wgmma would serialize it
    issue_ss<D, kQueryTile, kKeysSplit, kQueryTile>(f, wg == 0 ? sK : sV,
                                                    wg == 0 ? q_tile : o_tile);
    wgmma_commit();
    // the hand-over barrier is waited for while the product runs: the dS warpgroup has
    // read the last P tile (warpgroup 0), the P tile is written (warpgroup 1)
    named_sync(wg == 0 ? kPEmpty : kPFull);
    wgmma_wait<0>();  // this step's product, and before it the last step's dV or dK
    fence_regs(f);
    if (lane == 0 && i > 0) mbar_arrive(empty((i - 1) % kStg));  // the stage it read
    __syncwarp();
    if (wg == 0) {
      const float* lrow = pL + s * kQueryTile;
      if (edge(q0)) p_tile<kCap, true>(f, pP, lrow, t128, w, k0, q0);
      else p_tile<kCap, false>(f, pP, lrow, t128, w, k0, q0);
      named_arrive(kPFull);
    } else {
      const float* drow = pD + s * kQueryTile;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        f[e] = pP[e * 128 + t128] * (f[e] - drow[8 * (e >> 2) + w.c_th + (e & 1)]);
      named_arrive(kPEmpty);
    }
    pack<kQueryTile>(a, f);
    wgmma_fence();
    // dV += Pᵀ·dO (warpgroup 0), dK += dSᵀ·Q (warpgroup 1), on into the next step
    issue_rs<D, kQueryTile / 16>(acc, a, wg == 0 ? o_tile : q_tile);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (wg == 0) named_sync(kPEmpty);  // pairs the dS warpgroup's last arrival
  store_keys<D>(wg == 0 ? dv : dk, acc, w, b, k0, kvh, KV);
}

// The dQ warpgroup's P: P·(1 − tanh²)·scale into s (masked where kEdge), rows from qa,
// keys from k0.
template <int BK, bool kCap, bool kEdge>
__device__ __forceinline__ void p_rows(float (&s)[BK / 2], const float (&lse)[2],
                                       const Frag& w, int qa, int k0) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = (e >> 1) & 1;
    float fac;
    float p = ex2(w.exponent<kCap>(s[e], lse[r], &fac));
    if constexpr (kEdge) {
      if (!w.keep(qa + w.r_lo + 8 * r, k0 + 8 * (e >> 2) + w.c_th + (e & 1))) p = 0.0f;
    }
    s[e] = p * fac;
  }
}

// The dQ warpgroup's dS = P·fac·(dP − Δ) as the bf16 pairs of dQ's A operand.
template <int BK>
__device__ __forceinline__ void ds_rows(const float (&pf)[BK / 2], const float (&dp)[BK / 2],
                                        const float (&dl)[2], uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 2 * i;
      const float d = dl[i & 1];
      a[kk][i] = pack_bf16(pf[e] * (dp[e] - d), pf[e + 1] * (dp[e + 1] - d));
    }
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int qa = q0 + kRowsPerWarpgroup * wg;
  const Frag w(threadIdx.x % 128, Sq, Sk, causal, window, scale, cap);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + w.r_lo + 8 * r;
    const long long i = (static_cast<long long>(b) * H + h) * Sq_pad + qpos;
    lse_r[r] = qpos < Sq ? lse[i] : 0.0f;
    dl_r[r] = qpos < Sq ? delta[i] : 0.0f;
  }
  // Whether the key tile from k0 needs the mask for this warpgroup's rows: it crosses the
  // diagonal, the window's edge or Sk, or lies wholly past them.  The block's band is the
  // union of its warpgroups' bands; a tile outside this warpgroup's own goes through the
  // masked body, as a branch around the products costs more.  Rows past Sq need no mask:
  // TMA's zeros give them dS = 0, and they are not stored.
  auto edge = [&](int k0) {
    return (causal && k0 + BK - 1 > qa) || (window > 0 && qa + 63 - k0 >= window) ||
           k0 + BK > Sk;
  };
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  fence_regs(acc);  // the zeros set here, before any product is in flight
  float sf[BK / 2], dpf[BK / 2];
  uint32_t a[BK / 16][4];  // dS's bf16 pairs, read by the dQ product

  mbar_wait(q_full, 0);
  for (int j = lo; j < hi; ++j) {
    const int s = stage(j);
    mbar_wait(full(s), parity(j));
    __syncwarp();
    const uint32_t k_tile = sK + s * T::kKvTile;
    fence_regs(sf);
    fence_regs(dpf);
    wgmma_fence();
    issue_ss<D, BK, kRowsPerWarpgroup, BK>(sf, sQ + wg * T::kRows, k_tile);  // S = Q·Kᵀ
    wgmma_commit();
    issue_ss<D, BK, kRowsPerWarpgroup, BK>(dpf, sO + wg * T::kRows,
                                           sV + s * T::kKvTile);           // dP = dO·Vᵀ
    wgmma_commit();
    wgmma_wait<1>();  // S done, and before it the last tile's dQ product
    fence_regs(sf);
    if (lane == 0 && j > lo) mbar_arrive(empty(stage(j - 1)));  // the stage it read
    __syncwarp();
    if (edge(j * BK)) p_rows<BK, kCap, true>(sf, lse_r, w, qa, j * BK);
    else p_rows<BK, kCap, false>(sf, lse_r, w, qa, j * BK);
    wgmma_wait<0>();  // dP done
    fence_regs(dpf);
    ds_rows<BK>(sf, dpf, dl_r, a);
    wgmma_fence();
    issue_rs<D, BK / 16>(acc, a, k_tile);  // dQ += dS·K, on into the next tile
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

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

struct Args {
  const void *o, *dout;
  const float *m, *l;
  float *delta, *lse;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, Sq_pad, causal, window, has_cap;
  float scale, cap;
};

// Sets kernel's shared memory and launches it on the dK/dV grid: a block per (KV head,
// batch, Tile<D>::kBlockKeys keys).
template <int D, typename Kernel>
cudaError_t launch_kv(Kernel kernel, const CUtensorMap (&maps)[6], const Args& a,
                      cudaStream_t stream) {
  using T = Tile<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemKv);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.KV, a.B, (a.Sk + T::kBlockKeys - 1) / T::kBlockKeys), T::kKvThreads,
           T::kSmemKv, stream>>>(maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, a.dk,
                                 a.dv, a.Sq, a.Sk, a.H, a.KV, a.Sq_pad, a.scale, a.causal,
                                 a.window, a.cap);
  return cudaGetLastError();
}

// maps: q, dO with 64-row boxes, k, v with Tile<D>::kBlockKeys-row boxes (the dK/dV
// block's), then k, v with Tile<D>::kBK-row boxes (dQ's).
template <int D>
int launch(const CUtensorMap (&maps)[6], const Args& a, cudaStream_t stream) {
  using T = Tile<D>;
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq_pad;
  constexpr int kBlockRows = T::kPrologueRows * kPrologueRowsPerThread;
  prologue_kernel<D><<<static_cast<unsigned>((rows + kBlockRows - 1) / kBlockRows),
                       kPrologueThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout), a.m,
      a.l, a.delta, a.lse, rows, a.Sq, a.Sq_pad, a.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (T::kOwn)
    err = launch_kv<D>(a.has_cap ? dkdv_kernel<D, true> : dkdv_kernel<D, false>, maps, a,
                       stream);
  else
    err = launch_kv<D>(a.has_cap ? dkdv_split_kernel<D, true> : dkdv_split_kernel<D, false>,
                       maps, a, stream);
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
// described by its tensor-map arguments (ops.tma_map_args): q and dout with 64-row boxes,
// k and v with ops.bwd_key_block_rows(D)-row boxes for the dK/dV kernel, then k and v again
// with ops.bwd_kv_box_rows(D)-row boxes for the dQ kernel; o, dout: contiguous, 16-byte
// aligned bfloat16 [B, Sq, H, D]; m, l: contiguous float32 [B, H, Sq], the forward's
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
