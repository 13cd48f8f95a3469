// Online-softmax attention forward for bf16 on Hopper (sm_90a): the tensor-core kernel.
//
// Replaces the TPU kernel `_fa_kernel` in src/repro/kernels/flash_attention/kernel.py:38
// (launched by `flash_attention_fwd`, `pallas_call` at :141) for bfloat16 inputs.  Like
// it, it takes q and k of one head_dim D and v of its own, Dv (the Pallas kernel's
// `acc` and output are Dv wide): the (D, Dv) pairs (16, 16), (32, 32), (64, 64),
// (128, 128), (256, 256), the heads of 80 of zamba2's shared block and hubert (80, 80),
// and MLA's (192, 128) (deepseek-v2: q, k of qk_nope + qk_rope, v of v_head_dim).
// float32 inputs stay on flash_attention.cu.  It computes what that kernel computes, as
// repro_torch/kernels/flash_attention/ref.py does in one pass:
//
//   s = q·kᵀ (bf16 products, fp32 sums), then s·scale     (the TPU kernel scales q first)
//   optional softcap        s = c·tanh(s / c)              (accurate tanhf)
//   mask                    keep = (!causal || qpos >= kpos) && (!window || qpos − kpos < window)
//                           masked scores become −2e38; keys at or past Sk get no weight
//   per KV tile             m' = max(m, rowmax s);  p = exp(s − m');  corr = exp(m − m')
//                           l = l·corr + Σp (fp32 p);  acc = acc·corr + bf16(p)·v
//   out                     acc / max(l, 1e-30), rounded once to bf16: [B, Sq, H, Dv].
//   stats (optional)        m and l of each row, float32 [B, H, Sq], in the natural-log
//                           domain of the scaled scores, as the attention backward reads
//                           them: m is kept in base 2 (below) and multiplied by ln 2 on
//                           the store.
//
// The causal mask is aligned at position 0, as in the Pallas kernel.  p is rounded to
// bf16 before p·v, as the TPU kernel does (`p.astype(v.dtype)`).
//
// What bounds it on an H100.  At the serving shape (B = 4, S = 2048, 32 query heads,
// 8 KV heads, D = 64, causal) it moves about 84 MB (q, k, v and out once: 25 µs at
// 3.35 TB/s) and does about 69 GFLOP (2·B·H·(D + Dv)·S(S+1)/2: 70 µs at the bf16
// tensor-core peak of 989 TFLOP/s), so operations bound it, and only the tensor cores
// reach that rate: both products run on wgmma.  At D = 64 the exponentials weigh as
// much: one per score against 4·D = 256 tensor-core FLOP, and the special-function units
// do 16 a clock per SM where the tensor cores do 4096 FLOP, so they too need about 70 µs.
// At gemma2-2b's prefill (B = 2, S = 8160, 8 query / 4 KV heads, D = 256, softcap 50) a
// global layer does 546 GFLOP (0.552 ms at peak) and a local one (window 4096) 410 GFLOP
// (0.415 ms); there the softcap's accurate tanhf and its IEEE division, a score at a time
// on the CUDA cores, take longer than the products (PERF.md has the times with and
// without it).  deepseek-v2's MLA layer (B = 2, S = 4096, 128 heads, (192, 128), causal)
// does 1.374 TFLOP (1.39 ms); heads of 80 (B = 4, S = 2048, 32 or 16 heads) 86 GFLOP.
//
// Design.  One block per (query head, batch, query tile), query tiles heaviest first
// (the z axis counts down).  The first warpgroups are consumers of 64 query rows each:
// three (192-row tiles) up to Dv = 64 and at (80, 80) and (192, 128), two at D = 128
// and 256 and at (192, 128) with the softcap (Tile says why); the last warpgroup is the
// producer, one thread of which issues every TMA load.  The producer drops to 24
// registers with setmaxnreg, so that each consumer thread gets 160 with three (232 with
// two, 240 at Dv = 256, where the output fragment alone is 128 floats a thread); ptxas
// allocates the code after each setmaxnreg for its count, not for the launch bound's
// 128 or 168.
//  * TMA: the host encodes one CUtensorMap each for q, k and v over the caller's
//    [B, S, heads, width] view (dims innermost first {width, S, heads, B}, the caller's
//    byte strides, the head axis contiguous), with a box of 64 (q) or kBK (k, v) rows by
//    the columns of one swizzle span: the widest of 128, 64 and 32 bytes that tiles a
//    row (ops.tma_map_args).  So q and k at 192 take three 64-column boxes and v at 128
//    two, each at the 128-byte swizzle, and a width of 80 (160 bytes a row, more than the
//    128-byte span and no multiple of it or of 64) takes five 16-column boxes at the
//    32-byte swizzle.  That is the first of the two ways to an 80-wide row, and the one
//    taken: every product then reads the canonical layouts wgmma documents (q·kᵀ one
//    32-byte atom a k step, as at D = 16; p·v five atoms along n, one instruction of
//    n = 80), and HBM sends 160 bytes a row.  The other, the D = 128 geometry with TMA's
//    zero fill past column 80, would leave p·v an n = 80 read across a 128-byte atom that
//    it covers by a quarter, which no canonical layout describes, and would spend shared
//    memory and ring stages on 48 columns of zeros.  GQA is folded in the coordinates:
//    query head h reads KV head h / G.  TMA fills rows past the end with zeros; keys at
//    or past Sk are still masked, and query rows at or past Sq are not stored.  The maps
//    hold the base pointers, so they are encoded on every call, by libcuda's
//    cuTensorMapEncodeTiled looked up with cudaGetDriverEntryPoint (no -lcuda).
//  * Pipeline: Q is loaded once; K and V tiles of kBK keys (128; 64 at D >= 128 and at
//    80, for registers) go through a K ring and a V ring of three stages each (two at
//    D = 256, where a tile is 32 KB: Q, 64 KB, and the rings then take 192 KB), each
//    stage with a full barrier and an empty barrier that each consumer warp arrives on
//    once: on K's as soon as S of that tile is done, on V's once its P·V is.  The
//    producer walks the tiles of the causal / window band [lo, hi) of the block's rows,
//    so tiles outside it are never loaded; a tile no row of a warpgroup can see is
//    waited for and released by it, not computed.  At (192, 128) a stage is a 24 KB K
//    tile and a 16 KB V tile, so three stages and three warpgroups' 24 KB of Q take
//    192 KB (two warpgroups' with the softcap, 168 KB).
//  * S = Q·Kᵀ: wgmma m64nkBKk16, both operands K-major in swizzled shared memory, D/16
//    steps (12 at D = 192, 5 at D = 80).  O += P·V: wgmma m64nDvk16 (m64n256k16 at
//    Dv = 256, the widest wgmma; m64n80k16 at Dv = 80) with A = P from registers (the
//    fp32 S fragment packed to bf16 pairs is the A fragment) and B = the V tile [keys, Dv]
//    MN-major, read through the transpose-B bit, so V is never copied or transposed.
//  * Overlap: step j issues S(j) and P(j−1)·V(j−1) together, waits for S(j) only, and
//    runs the softmax of S(j) while the tensor cores do P·V; the wait for P·V opens
//    step j + 1, behind the loop's branch, because ptxas hoists a wgmma wait placed
//    after the softmax above it.  The warpgroups of a block also overlap each other.
//  * Softmax in registers on the accumulator fragment: each row is held by the four
//    threads of a quad, its max reduced with __shfl_xor_sync 1 and 2 (l is summed per
//    thread and reduced once at the end).  Softcap and "this tile needs the mask" are
//    compile-time, so each loop body is branch-free; the tiles that cross the diagonal,
//    the window edge or Sk sit at the ends of the band and take the masked body, the
//    rest pay no mask arithmetic and fold the scale into the exponent's FFMA.
//  * Epilogue: acc / max(l, 1e-30) rounded once to bf16 and stored as bf16 pairs into
//    the contiguous [B, Sq, H, Dv] output: Dv columns, no padding to copy or cut.
// PERF.md has the measured times and what still holds the kernel back.
//
// Rounding.  Built without --use_fast_math.  The exponentials are base 2 with log2(e)
// folded into the scale: ex2.approx.ftz, the instruction exp2f itself is built on
// (2 ulp), without exp2f's rescaling of results below 2^-126, which flush to zero and
// weigh nothing beside the row maximum's 1.  tanhf is the library function and the
// output is divided by l.  The products take bf16 operands exactly and sum in fp32 in
// the tensor cores' order; with p rounded to bf16 the result is within the bf16
// tolerance (2e-2) of the plain version, not bit for bit.

#include <limits.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiles' design constants (tests/test_torch_flash_native_width.py reads them).
constexpr int kNarrowWarpgroups = 3;  // consumer warpgroups up to Dv = 64
constexpr int kWideWarpgroups = 2;    // ... at D = 128 and 256
constexpr int kNarrowRegs = 160;      // registers a consumer thread, three warpgroups
constexpr int kWideRegs = 232;        // ... two warpgroups, Dv = 128
constexpr int kWidestRegs = 240;      // ... two warpgroups, Dv = 256
constexpr int kProducerRegs = 24;     // the producer warpgroup's, after setmaxnreg.dec
constexpr int kNarrowKeys = 128;      // keys a KV tile up to D = 64
constexpr int kWideKeys = 64;         // ... at D = 128 and 256
constexpr int kStages = 3;            // stages of the K ring and of the V ring
constexpr int kStages256 = 2;         // ... at D = 256
constexpr int kWarpgroups80 = 3;      // consumer warpgroups of the (80, 80) tile
constexpr int kKeys80 = 64;           // ... and keys a KV tile of it
constexpr int kWarpgroups192 = 3;     // consumer warpgroups of the (192, 128) tile
constexpr int kWarpgroups192Cap = 2;  // ... of it with the softcap
constexpr int kKeys192 = 64;          // keys a KV tile of (192, 128)
constexpr int kRegisterFile = 65536;  // 32-bit registers of an SM
constexpr int kSmemOptIn = 232448;    // dynamic shared memory a block may opt in to

// Bytes of a box row of a `width`-wide operand: the widest swizzle span (128, 64 or 32
// bytes) that tiles its 2·width bytes.  A tile is stored as column boxes of such rows,
// each swizzled by TMA in atoms of 8 rows.
constexpr int box_row_bytes(int width) {
  return (2 * width) % 128 == 0 ? 128 : (2 * width) % 64 == 0 ? 64 : 32;
}
// wgmma descriptor layout code of a swizzle span: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
constexpr int swizzle_layout(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// Shared-memory and register geometry of q, k of head_dim D and v of Dv, with or without
// the softcap.  KV tiles hold 128 keys, 64 at D >= 128, where the S, P and output
// fragments of 128 keys would not fit in registers, and at the native-width pairs (80,
// 80) and (192, 128) (ops.kv_box_rows says the same).
template <int D, int Dv, bool kCap>
struct Tile {
  // Consumer warpgroups of 64 query rows, and the registers each of their threads gets
  // once the producer warpgroup has dropped to 24 (the 64K of an SM, less the
  // producer's 3K, split over them): three, each at 160, up to Dv = 64 (128-key tiles)
  // and at (80, 80) and (192, 128) (64-key tiles, whose S and P fragments leave room for
  // the output's 40 or 64 floats); two at D = 128 and 256, whose 64- and 128-float
  // output fragments take 232 and 240, and at (192, 128) with the softcap, whose tanhf
  // leaves three warpgroups short of registers.  scripts/flash_tile_variants.py builds
  // and times the native tiles' other shapes (PERF.md has what it measured).  At Dv = 256
  // the consumers take all the producer gives up: 2 · 128 · (240 − 168) = 128 · (168 − 24).
  static constexpr int kWG = D == 80    ? kWarpgroups80
                             : D == 192 ? (kCap ? kWarpgroups192Cap : kWarpgroups192)
                             : Dv <= 64 ? kNarrowWarpgroups
                                        : kWideWarpgroups;
  static constexpr int kBQ = 64 * kWG;             // query rows per block
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
  static constexpr int kConsumerRegs =
      kWG == kNarrowWarpgroups ? kNarrowRegs : Dv == 256 ? kWidestRegs : kWideRegs;
  static constexpr int kBK = D == 80    ? kKeys80      // keys per KV tile
                             : D == 192 ? kKeys192
                             : D >= 128 ? kWideKeys
                                        : kNarrowKeys;
  // Stages of the K ring and of the V ring: three, two at D = 256, where a tile is 32 KB
  // and three stages of both beside Q would pass the 227 KB a block can have.
  static constexpr int kRing = D == 256 ? kStages256 : kStages;
  // A 64-float output fragment beside 160 registers, (192, 128) without the softcap:
  // every register counts (issue_qk, softmax_tile).
  static constexpr bool kTight = kWG == kNarrowWarpgroups && Dv >= 128;
  // q and k: box row bytes, columns and wgmma layout code; v: the same
  static constexpr int kQKRow = box_row_bytes(D);
  static constexpr int kQKCols = kQKRow / 2;
  static constexpr int kQKLayout = swizzle_layout(kQKRow);
  static constexpr int kVRow = box_row_bytes(Dv);
  static constexpr int kVCols = kVRow / 2;
  static constexpr int kVLayout = swizzle_layout(kVRow);
  static constexpr int kQRows = 64 * D * 2;    // bytes of one warpgroup's Q rows
  static constexpr int kK = kBK * D * 2;       // bytes of one K tile
  static constexpr int kV = kBK * Dv * 2;      // bytes of one V tile
  // Q, the K and V rings, 1 + 4·kRing mbarriers, and slack to align the base to 1024
  static constexpr int kSmem = kWG * kQRows + kRing * (kK + kV) + 128 + 1024;
  static_assert(D % 16 == 0 && Dv % 16 == 0, "whole wgmma k steps and n atoms");
  static_assert(kSmem <= kSmemOptIn, "shared memory past the opt-in limit");
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= kRegisterFile,
                "the consumers take more registers than the producer frees");
};

// S = Q·Kᵀ of one warpgroup: D/16 wgmma steps along head_dim, committed as one group.
// A step reads 16 columns of one column box of Q and of K.
template <int D, int Dv, bool kCap>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<D, Dv, kCap>::kBK / 2],
                                         uint32_t q_tile, uint32_t k_tile) {
  using T = Tile<D, Dv, kCap>;
  uint64_t qa = smem_desc(q_tile, 16, 8 * T::kQKRow, T::kQKLayout);
  const uint64_t ka = smem_desc(k_tile, 16, 8 * T::kQKRow, T::kQKLayout);
  // Q's descriptor is the same every step: made opaque here, it is formed anew by each
  // call instead of held, with its D/16 offsets, across the loop (Tile::kTight)
  if constexpr (T::kTight) asm volatile("" : "+l"(qa));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / T::kQKCols;
    const uint32_t col = (kk * 16 % T::kQKCols) * 2;
    const uint64_t da = desc_add(qa, box * 64 * T::kQKRow + col);
    const uint64_t db = desc_add(ka, box * T::kBK * T::kQKRow + col);
    if constexpr (T::kBK == 128) wgmma_ss_n128(s, da, db, kk > 0);
    else wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P·V of one warpgroup: kBK/16 wgmma steps along the keys, committed as one group.
// V is MN-major: a step moves 16 rows down the tile; its column boxes (two at Dv = 128,
// four at 256, five at 80) are kBK rows apart (the descriptor's leading byte offset).
template <int D, int Dv, bool kCap>
__device__ __forceinline__ void issue_pv(float (&acc)[Dv / 2],
                                         const uint32_t (&p)[Tile<D, Dv, kCap>::kBK / 16][4],
                                         uint32_t v_tile) {
  using T = Tile<D, Dv, kCap>;
  const uint64_t va = smem_desc(v_tile, T::kBK * T::kVRow, 8 * T::kVRow, T::kVLayout);
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk) {
    const uint64_t db = desc_add(va, kk * 16 * T::kVRow);
    if constexpr (Dv == 16) wgmma_rs_n16(acc, p[kk], db);
    else if constexpr (Dv == 32) wgmma_rs_n32(acc, p[kk], db);
    else if constexpr (Dv == 64) wgmma_rs_n64(acc, p[kk], db);
    else if constexpr (Dv == 80) wgmma_rs_n80(acc, p[kk], db);
    else if constexpr (Dv == 128) wgmma_rs_n128(acc, p[kk], db);
    else wgmma_rs_n256(acc, p[kk], db);
  }
  wgmma_commit();
}

// What a warpgroup's softmax needs to know of the problem.  A thread holds rows r_lo and
// r_lo + 8 of the warpgroup's 64 and columns 8·g + c_th + {0, 1} of each 8-column group g
// of an accumulator: element e of a fragment is row r_lo + 8·((e >> 1) & 1), column
// 8·(e >> 2) + c_th + (e & 1).
struct Rows {
  int qa, r_lo, c_th, Sk, causal, window;
  float scale, scale_log2, cap;

  // Tile [k0, k0 + bk) crosses the diagonal, the window edge or the end of the keys.
  __device__ __forceinline__ bool edge(int k0, int bk) const {
    return (causal && k0 + bk - 1 > qa) || (window > 0 && qa + 63 - k0 >= window) ||
           k0 + bk > Sk;
  }
};

// One tile's scores in s → their base-2 exponentials against the new row max.  Updates
// the running max m and this thread's share of the row sums l, and returns in corr the
// factor that rescales what was summed before.  kCap and kEdge (the tile needs the mask)
// are compile-time, so the body is one branch-free block: a tile without softcap and
// inside the band takes the scale into the one FFMA of the exponent and pays no mask
// arithmetic.  kBounds (Tile::kTight) masks by per-row bounds, in fewer registers.
template <int BK, bool kCap, bool kEdge, bool kBounds>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Rows& w, int k0) {
  float mul = w.scale_log2;  // what takes s to the base-2 domain
  if constexpr (kCap) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = w.cap * tanhf(s[e] * w.scale / w.cap) * kLog2e;
    mul = 1.0f;
  }
  if constexpr (kEdge) {
    if constexpr (!kCap) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) s[e] *= mul;
      mul = 1.0f;
    }
    if constexpr (kBounds) {
      // Element e sits at key kpos = base + c, c = 8·(e >> 2) + (e & 1) known at compile
      // time, in row qpos = base + d[r]: keep it where c <= d[r] (causal) and
      // c > d[r] − window, give it no weight where c >= Sk − base: three integers a row,
      // compared with immediates.
      const int base = k0 + w.c_th;
      const int past = w.Sk - base;
      int hi[2], lo[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = w.qa + w.r_lo + 8 * r - base;
        hi[r] = w.causal ? d : INT_MAX;
        lo[r] = w.window > 0 ? d - w.window : INT_MIN;
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int c = 8 * (e >> 2) + (e & 1), r = (e >> 1) & 1;
        s[e] = c >= past ? -INFINITY : c <= hi[r] && c > lo[r] ? s[e] : kNegInf;
      }
    } else {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int qpos = w.qa + w.r_lo + 8 * ((e >> 1) & 1);
        const int kpos = k0 + 8 * (e >> 2) + w.c_th + (e & 1);
        const bool keep =
            (!w.causal || qpos >= kpos) && (w.window <= 0 || qpos - kpos < w.window);
        s[e] = kpos >= w.Sk ? -INFINITY : keep ? s[e] : kNegInf;
      }
    }
  }
  // row max and row sum in four interleaved partials each, so the chains stay short
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[0][i] = mx[1][i] = kNegInf, sum[0][i] = sum[1][i] = 0.0f;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e)
    mx[(e >> 1) & 1][(e >> 2) & 3] = fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3], s[e]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x * mul);  // mul > 0: the max commutes with it
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const float pe = ex2(fmaf(s[e], mul, neg_m[(e >> 1) & 1]));
    s[e] = pe;
    sum[(e >> 1) & 1][(e >> 2) & 3] += pe;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// The exponentials as bf16 pairs: the A fragment of P·V (elements 8·kk .. 8·kk + 7 of the
// S fragment are the 16 keys of wgmma step kk).
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

template <int D, int Dv, bool kCap>
__global__ void __launch_bounds__(Tile<D, Dv, kCap>::kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk, int H, int G,
    float scale, int causal, int window, float cap) {
  using T = Tile<D, Dv, kCap>;
  constexpr int BK = T::kBK;
  constexpr int kRing = T::kRing;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::kWG * T::kQRows;
  const uint32_t sV = sK + kRing * T::kK;
  const uint32_t bars = sV + kRing * T::kV;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kRing + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kRing + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kRing + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kBQ;
  // KV tiles in the band: the last one any row of this tile sees (causal), the first
  // one inside the window of its first row.
  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min((min(q0 + T::kBQ, Sq) - 1) / BK + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  // tile j sits in stage (j − lo) % kRing of both rings, in round (j − lo) / kRing
  auto stage = [&](int j) { return (j - lo) % kRing; };
  auto parity = [&](int j) { return static_cast<uint32_t>(((j - lo) / kRing) & 1); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), T::kConsumers / 32);  // one arrival per consumer warp
      mbar_init(v_empty(s), T::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::kConsumers) {
    // Producer warpgroup: it gives its registers to the consumers, and one thread
    // issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == T::kConsumers) {
      const int kvh = h / G;
      mbar_expect_tx(q_full, T::kWG * T::kQRows);
      for (int half = 0; half < T::kWG; ++half)
        for (int c = 0; c < D / T::kQKCols; ++c)
          tma_load(sQ + half * T::kQRows + c * 64 * T::kQKRow, &tq, q_full, c * T::kQKCols,
                   q0 + 64 * half, h, b);
      for (int j = lo; j < hi; ++j) {
        const int s = stage(j);
        mbar_wait(k_empty(s), parity(j) ^ 1);  // the first round passes at once
        mbar_expect_tx(k_full(s), T::kK);
        for (int c = 0; c < D / T::kQKCols; ++c)
          tma_load(sK + s * T::kK + c * BK * T::kQKRow, &tk, k_full(s), c * T::kQKCols,
                   j * BK, kvh, b);
        mbar_wait(v_empty(s), parity(j) ^ 1);
        mbar_expect_tx(v_full(s), T::kV);
        for (int c = 0; c < Dv / T::kVCols; ++c)
          tma_load(sV + s * T::kV + c * BK * T::kVRow, &tv, v_full(s), c * T::kVCols,
                   j * BK, kvh, b);
      }
    }
    return;
  }

  // Consumer warpgroup `wg` owns query rows [qa, qa + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs) : "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  Rows w;
  w.qa = q0 + 64 * wg;
  w.r_lo = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  w.c_th = 2 * (lane % 4);
  w.Sk = Sk;
  w.causal = causal;
  w.window = window;
  w.scale = scale;
  w.scale_log2 = scale * kLog2e;
  w.cap = cap;
  const uint32_t q_tile = sQ + wg * T::kQRows;
  // This warpgroup's own band inside [lo, hi): a tile outside it no row here can see,
  // so it is only waited for and released.
  const int lo_w = max(lo, window > 0 ? max(w.qa - window + 1, 0) / BK : 0);
  const int hi_w = min(hi, causal ? (min(w.qa + 64, Sq) - 1) / BK + 1 : nk);
  auto wait_full = [&](uint32_t bar, int j) {
    mbar_wait(bar, parity(j));
    __syncwarp();  // the .aligned wgmma instructions need the warp converged
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto pass = [&](int j) {
    wait_full(k_full(stage(j)), j);
    release(k_empty(stage(j)));
    wait_full(v_full(stage(j)), j);
    release(v_empty(stage(j)));
  };
  float m[2] = {kNegInf, kNegInf};  // running row max, in the base-2 domain
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  float corr[2];
  float acc[Dv / 2];
#pragma unroll
  for (int e = 0; e < Dv / 2; ++e) acc[e] = 0.0f;
  float s[BK / 2];
  uint32_t p[BK / 16][4];

  // A warpgroup whose rows see no key (rows past Sq, or a window that ends before the
  // keys do) only passes the block's tiles, and stores zeros for rows before Sq, as the
  // TPU kernel's empty loop does.  Every warpgroup waits for Q, so that no load is in
  // flight when the block ends.
  mbar_wait(q_full, 0);
  if (lo_w >= hi_w) {
    for (int j = lo; j < hi; ++j) pass(j);
  } else {
    for (int j = lo; j < lo_w; ++j) pass(j);
    // The first tile's scores, alone.  Then, per tile j: S(j) and P(j−1)·V(j−1) are
    // issued together, and the softmax of S(j) runs while the tensor cores do P·V.  The
    // wait for that P·V comes at the top of the next step, behind the loop's branch, so
    // the compiler cannot hoist it above the softmax; the step then releases V(j − 2),
    // rescales O and packs P(j − 1).  K(j) is released as soon as S(j) is done, so the
    // producer can refill its stage a step before V's (two stages are enough to never
    // wait on a load that was not already asked for).
    static_assert(kRing >= 2, "V(j) is loaded into the stage V(j − 2) leaves");
    wait_full(k_full(stage(lo_w)), lo_w);
    fence_regs(s);
    wgmma_fence();
    issue_qk<D, Dv, kCap>(s, q_tile, sK + stage(lo_w) * T::kK);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty(stage(lo_w)));
    if (w.edge(lo_w * BK, BK))
      softmax_tile<BK, kCap, true, T::kTight>(s, m, l, corr, w, lo_w * BK);
    else softmax_tile<BK, kCap, false, T::kTight>(s, m, l, corr, w, lo_w * BK);
    // O·corr + P·V of the previous step is done: release its V, fold in corr, pack P
    auto settle = [&](int j) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (j - 2 >= lo_w) release(v_empty(stage(j - 2)));
#pragma unroll
      for (int e = 0; e < Dv / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
      pack_p<BK>(p, s);
    };
    auto step = [&](int j, auto edge) {
      settle(j);
      wait_full(k_full(stage(j)), j);
      wait_full(v_full(stage(j - 1)), j - 1);
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
      issue_qk<D, Dv, kCap>(s, q_tile, sK + stage(j) * T::kK);
      issue_pv<D, Dv, kCap>(acc, p, sV + stage(j - 1) * T::kV);
      wgmma_wait<1>();  // S(j) is done; P·V may still run
      fence_regs(s);
      release(k_empty(stage(j)));
      softmax_tile<BK, kCap, decltype(edge)::value, T::kTight>(s, m, l, corr, w, j * BK);
    };
    // Tiles that need the mask lie at the ends of the band (the window's edge first, the
    // diagonal and the end of the keys last): [lo_w + 1, a) and [z, hi_w) take the masked
    // body, [a, z) the plain one.
    int a = lo_w + 1;
    while (a < hi_w && w.edge(a * BK, BK)) ++a;
    int z = hi_w;
    while (z > a && w.edge((z - 1) * BK, BK)) --z;
    for (int j = lo_w + 1; j < a; ++j) step(j, Bool<true>());
    for (int j = a; j < z; ++j) step(j, Bool<false>());
    for (int j = z; j < hi_w; ++j) step(j, Bool<true>());
    settle(hi_w);
    wait_full(v_full(stage(hi_w - 1)), hi_w - 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv<D, Dv, kCap>(acc, p, sV + stage(hi_w - 1) * T::kV);
    wgmma_wait<0>();
    fence_regs(acc);
    release(v_empty(stage(hi_w - 1)));
    for (int j = hi_w; j < hi; ++j) pass(j);
  }

  // out is a fresh contiguous [B, Sq, H, Dv] tensor
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w.qa + w.r_lo + 8 * r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* row = o + (static_cast<long long>(b) * Sq + qpos) * H * Dv +
                         static_cast<long long>(h) * Dv + w.c_th;
#pragma unroll
    for (int g = 0; g < Dv / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * g) =
          __floats2bfloat162_rn(acc[4 * g + 2 * r] / denom, acc[4 * g + 2 * r + 1] / denom);
    // the row's stats: the same in the four threads of its quad, stored by the first; a
    // row that saw no key keeps the −2e38 it started with
    if (m_out != nullptr && w.c_th == 0) {
      const long long i = (static_cast<long long>(b) * H + h) * Sq + qpos;
      m_out[i] = m[r] <= kNegInf ? kNegInf : m[r] * kLn2;
      l_out[i] = l[r];
    }
  }
}

template <int D, int Dv, bool kCap>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
           float* m_out, float* l_out, int B, int Sq, int Sk, int H, int KV, float scale,
           int causal, int window, float cap, cudaStream_t stream) {
  using T = Tile<D, Dv, kCap>;
  auto kernel = flash_attention_wgmma_kernel<D, Dv, kCap>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + T::kBQ - 1) / T::kBQ);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                                  m_out, l_out, Sq, Sk, H, H / KV, scale,
                                                  causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

// A (D, Dv) pair as a type, for with_tile.
template <int D, int Dv>
struct Pair {
  static constexpr int kD = D, kDv = Dv;
};

// The (D, Dv) pairs the kernel is built for, as ops.TC_HEAD_DIM_PAIRS lists them: returns
// f(Pair<D, Dv>()) for the pair (d, dv), or `none` for a pair not in the list.
template <typename R, typename F>
R with_tile(int d, int dv, R none, F&& f) {
  if (d == 16 && dv == 16) return f(Pair<16, 16>());
  if (d == 32 && dv == 32) return f(Pair<32, 32>());
  if (d == 64 && dv == 64) return f(Pair<64, 64>());
  if (d == 80 && dv == 80) return f(Pair<80, 80>());
  if (d == 128 && dv == 128) return f(Pair<128, 128>());
  if (d == 192 && dv == 128) return f(Pair<192, 128>());
  if (d == 256 && dv == 256) return f(Pair<256, 256>());
  return none;
}

}  // namespace

// Launches on `stream` without synchronizing; returns 0, a CUDA error code, or one of
// the codes above.  q: [B, Sq, H, D]; k: [B, Sk, KV, D]; v: [B, Sk, KV, Dv], bfloat16,
// each described by its tensor-map arguments (ops.tma_map_args: q with 64-row boxes, k
// and v with ops.kv_box_rows(D)-row boxes); o: a contiguous [B, Sq, H, Dv]; m_out, l_out:
// contiguous float32 [B, H, Sq] for the row stats, or both null for none.  window <= 0
// means none; has_cap = 0 means no softcap.  The caller checks that (D, Dv) is one of
// with_tile's pairs, H % KV == 0 and the alignment TMA needs.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, void* m_out, void* l_out,
                                            const unsigned long long* q_map,
                                            const unsigned long long* k_map,
                                            const unsigned long long* v_map, int B, int Sq,
                                            int Sk, int H, int KV, int D, int Dv, float scale,
                                            int causal, int window, int has_cap, float cap,
                                            void* stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, q_map);
  if (rc == 0) rc = encode(&tk, k, k_map);
  if (rc == 0) rc = encode(&tv, v, v_map);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const mo = static_cast<float*>(m_out);
  float* const lo = static_cast<float*>(l_out);
  return with_tile(D, Dv, static_cast<int>(cudaErrorInvalidValue), [&](auto pair) {
    using P = decltype(pair);
    return has_cap ? launch<P::kD, P::kDv, true>(tq, tk, tv, o, mo, lo, B, Sq, Sk, H, KV,
                                                 scale, causal, window, cap, st)
                   : launch<P::kD, P::kDv, false>(tq, tk, tv, o, mo, lo, B, Sq, Sk, H, KV,
                                                  scale, causal, window, cap, st);
  });
}

// Dynamic shared memory a launch of q, k of head_dim D and v of Dv, with the softcap or
// without, asks for (0 for a pair the kernel does not take): Q, the K and V rings, the
// mbarriers and the alignment slack.
extern "C" int flash_attention_wgmma_smem_bytes(int D, int Dv, int has_cap) {
  return with_tile(D, Dv, 0, [&](auto pair) {
    using P = decltype(pair);
    return has_cap ? Tile<P::kD, P::kDv, true>::kSmem : Tile<P::kD, P::kDv, false>::kSmem;
  });
}
