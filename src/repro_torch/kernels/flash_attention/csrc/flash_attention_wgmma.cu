// Online-softmax attention forward for bf16 on Hopper (sm_90a): the tensor-core kernel.
//
// Replaces the TPU kernel `_fa_kernel` in src/repro/kernels/flash_attention/kernel.py:38
// (launched by `flash_attention_fwd`, `pallas_call` at :141) for bfloat16 inputs with
// head_dim D in {16, 32, 64, 128, 256}; float32 inputs stay on the CUDA-core kernel in
// flash_attention.cu.  It computes what that kernel computes, as
// repro_torch/kernels/flash_attention/ref.py does in one pass:
//
//   s = q·kᵀ (bf16 products, fp32 sums), then s·scale     (the TPU kernel scales q first)
//   optional softcap        s = c·tanh(s / c)              (accurate tanhf)
//   mask                    keep = (!causal || qpos >= kpos) && (!window || qpos − kpos < window)
//                           masked scores become −2e38; keys at or past Sk get no weight
//   per KV tile             m' = max(m, rowmax s);  p = exp(s − m');  corr = exp(m − m')
//                           l = l·corr + Σp (fp32 p);  acc = acc·corr + bf16(p)·v
//   out                     acc / max(l, 1e-30), rounded once to bf16.
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
// 3.35 TB/s) and does about 69 GFLOP (4·B·H·D·S(S+1)/2: 70 µs at the bf16 tensor-core
// peak of 989 TFLOP/s), so operations bound it, and only the tensor cores reach that
// rate: both products run on wgmma.  At D = 64 the exponentials weigh as much: one per
// score against 4·D = 256 tensor-core FLOP, and the special-function units do 16 a clock
// per SM where the tensor cores do 4096 FLOP, so they too need about 70 µs.  At gemma2-2b's
// prefill (B = 2, S = 8160, 8 query / 4 KV heads, D = 256, softcap 50) a global layer does
// 546 GFLOP (0.552 ms at peak) and a local one (window 4096) 410 GFLOP (0.415 ms); there
// the softcap's accurate tanhf and its IEEE division, a score at a time on the CUDA cores,
// take longer than the products (PERF.md has the times with and without it).
//
// Design.  One block per (query head, batch, query tile), query tiles heaviest first
// (the z axis counts down).  The first warpgroups are consumers of 64 query rows each,
// three at D <= 64 (192-row tiles), two at D = 128 and 256; the last warpgroup is the
// producer, one thread of which issues every TMA load.  The producer drops to 24
// registers with setmaxnreg, so that each consumer thread gets 160 (232 at D = 128, 240
// at D = 256, where the output fragment alone is 128 floats a thread); ptxas allocates
// the code after each setmaxnreg for its count, not for the launch bound's 128 or 168.
//  * TMA: the host encodes one CUtensorMap each for q, k and v over the caller's
//    [B, S, heads, D] view (dims innermost first {D, S, heads, B}, the caller's byte
//    strides, head_dim contiguous), with a box of 64 (q) or kBK (k, v) rows by
//    min(D, 64) columns and a swizzle of the box row's bytes (128 B at D >= 64, so
//    D = 128 takes two column boxes and D = 256 four).  GQA is folded in the
//    coordinates: query head h reads KV head h / G.  TMA fills rows past the end with
//    zeros; keys at or past Sk are still masked, and query rows at or past Sq are not
//    stored.  The maps hold the base pointers, so they are encoded on every call, by
//    libcuda's cuTensorMapEncodeTiled looked up with cudaGetDriverEntryPoint (no -lcuda).
//  * Pipeline: Q is loaded once; K and V tiles of kBK keys (128; 64 at D >= 128, for
//    registers) go through a K ring and a V ring of three stages each (two at D = 256,
//    where a tile is 32 KB: Q, 64 KB, and the rings then take 192 KB), each stage with a
//    full barrier and an empty barrier that each consumer warp arrives on once: on K's
//    as soon as S of that tile is done, on V's once its P·V is.  The producer walks the
//    tiles of the causal / window band [lo, hi) of the block's rows, so tiles outside
//    it are never loaded; a tile no row of a warpgroup can see is waited for and
//    released by it, not computed.
//  * S = Q·Kᵀ: wgmma m64nkBKk16, both operands K-major in swizzled shared memory, D/16
//    steps.  O += P·V: wgmma m64nDk16 (m64n256k16 at D = 256, the widest wgmma) with
//    A = P from registers (the fp32 S fragment packed to bf16 pairs is the A fragment)
//    and B = the V tile [keys, D] MN-major, read through the transpose-B bit, so V is
//    never copied or transposed.
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
//    the contiguous [B, Sq, H, D] output.
// PERF.md has the measured times and what still holds the kernel back.
//
// Rounding.  Built without --use_fast_math.  The exponentials are base 2 with log2(e)
// folded into the scale: ex2.approx.ftz, the instruction exp2f itself is built on
// (2 ulp), without exp2f's rescaling of results below 2^-126, which flush to zero and
// weigh nothing beside the row maximum's 1.  tanhf is the library function and the
// output is divided by l.  The products take bf16 operands exactly and sum in fp32 in
// the tensor cores' order; with p rounded to bf16 the result is within the bf16
// tolerance (2e-2) of the plain version, not bit for bit.

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry of one head_dim.  A tile is stored as column boxes of
// kRowBytes-byte rows, each swizzled by TMA in atoms of 8 rows.  KV tiles hold 128 keys,
// 64 at D = 128 and 256, where the S, P and output fragments of 128 keys would not fit
// in registers (ops.kv_box_rows says the same).
template <int D>
struct Tile {
  // Consumer warpgroups of 64 query rows, and the registers each of their threads gets
  // once the producer warpgroup has dropped to 24 (the 64K of an SM, less the
  // producer's 3K, split over them): three at D <= 64; two at D = 128 and 256, whose 64-
  // and 128-float output fragments would not fit in 160.  At D = 256 the consumers take
  // all the producer gives up: 2 · 128 · (240 − 168) = 128 · (168 − 24).
  static constexpr int kWG = D >= 128 ? 2 : 3;
  static constexpr int kBQ = 64 * kWG;             // query rows per block
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : D == 256 ? 240 : 232;
  static constexpr int kBK = D >= 128 ? 64 : 128;  // keys per KV tile
  // Stages of the K ring and of the V ring: three, two at D = 256, where a tile is 32 KB
  // and three stages of both beside Q would pass the 227 KB a block can have.
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kQRows = 64 * D * 2;    // bytes of one warpgroup's Q rows
  static constexpr int kKV = kBK * D * 2;      // bytes of one K or V tile
  static constexpr int kAtom = 8 * kRowBytes;  // bytes of one swizzle atom (8 rows)
  // wgmma descriptor layout code: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // Q, the K and V rings, 1 + 4·kStages mbarriers, and slack to align the base to 1024
  static constexpr int kSmem = kWG * kQRows + 2 * kStages * kKV + 128 + 1024;
};

// S = Q·Kᵀ of one warpgroup: D/16 wgmma steps along head_dim, committed as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<D>::kBK / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
  using T = Tile<D>;
  const uint64_t qa = smem_desc(q_tile, 16, T::kAtom, T::kLayout);
  const uint64_t ka = smem_desc(k_tile, 16, T::kAtom, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / T::kBoxCols;
    const uint32_t col = (kk * 16 % T::kBoxCols) * 2;
    const uint64_t da = desc_add(qa, box * 64 * T::kRowBytes + col);
    const uint64_t db = desc_add(ka, box * T::kBK * T::kRowBytes + col);
    if constexpr (T::kBK == 128) wgmma_ss_n128(s, da, db, kk > 0);
    else wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P·V of one warpgroup: kBK/16 wgmma steps along the keys, committed as one group.
// V is MN-major: a step moves 16 rows down the tile; at D = 128 and 256 its two and four
// column boxes are kBK·128 bytes apart (the descriptor's leading byte offset).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[Tile<D>::kBK / 16][4],
                                         uint32_t v_tile) {
  using T = Tile<D>;
  const uint64_t va = smem_desc(v_tile, T::kBK * T::kRowBytes, T::kAtom, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk) {
    const uint64_t db = desc_add(va, kk * 16 * T::kRowBytes);
    if constexpr (D == 16) wgmma_rs_n16(acc, p[kk], db);
    else if constexpr (D == 32) wgmma_rs_n32(acc, p[kk], db);
    else if constexpr (D == 64) wgmma_rs_n64(acc, p[kk], db);
    else if constexpr (D == 128) wgmma_rs_n128(acc, p[kk], db);
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
// arithmetic.
template <int BK, bool kCap, bool kEdge>
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
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int qpos = w.qa + w.r_lo + 8 * ((e >> 1) & 1);
      const int kpos = k0 + 8 * (e >> 2) + w.c_th + (e & 1);
      const bool keep =
          (!w.causal || qpos >= kpos) && (w.window <= 0 || qpos - kpos < w.window);
      s[e] = kpos >= w.Sk ? -INFINITY : keep ? s[e] : kNegInf;
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

template <int D, bool kCap>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk, int H, int G,
    float scale, int causal, int window, float cap) {
  using T = Tile<D>;
  constexpr int BK = T::kBK;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::kWG * T::kQRows;
  const uint32_t sV = sK + kStages * T::kKV;
  const uint32_t bars = sV + kStages * T::kKV;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kBQ;
  // KV tiles in the band: the last one any row of this tile sees (causal), the first
  // one inside the window of its first row.
  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min((min(q0 + T::kBQ, Sq) - 1) / BK + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  // tile j sits in stage (j − lo) % kStages of both rings, in round (j − lo) / kStages
  auto stage = [&](int j) { return (j - lo) % kStages; };
  auto parity = [&](int j) { return static_cast<uint32_t>(((j - lo) / kStages) & 1); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == T::kConsumers) {
      const int kvh = h / G;
      mbar_expect_tx(q_full, T::kWG * T::kQRows);
      for (int half = 0; half < T::kWG; ++half)
        for (int c = 0; c < D / T::kBoxCols; ++c)
          tma_load(sQ + half * T::kQRows + c * 64 * T::kRowBytes, &tq, q_full,
                   c * T::kBoxCols, q0 + 64 * half, h, b);
      for (int j = lo; j < hi; ++j) {
        const int s = stage(j);
        mbar_wait(k_empty(s), parity(j) ^ 1);  // the first round passes at once
        mbar_expect_tx(k_full(s), T::kKV);
        for (int c = 0; c < D / T::kBoxCols; ++c)
          tma_load(sK + s * T::kKV + c * BK * T::kRowBytes, &tk, k_full(s), c * T::kBoxCols,
                   j * BK, kvh, b);
        mbar_wait(v_empty(s), parity(j) ^ 1);
        mbar_expect_tx(v_full(s), T::kKV);
        for (int c = 0; c < D / T::kBoxCols; ++c)
          tma_load(sV + s * T::kKV + c * BK * T::kRowBytes, &tv, v_full(s), c * T::kBoxCols,
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
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
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
    static_assert(kStages >= 2, "V(j) is loaded into the stage V(j − 2) leaves");
    wait_full(k_full(stage(lo_w)), lo_w);
    fence_regs(s);
    wgmma_fence();
    issue_qk<D>(s, q_tile, sK + stage(lo_w) * T::kKV);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty(stage(lo_w)));
    if (w.edge(lo_w * BK, BK)) softmax_tile<BK, kCap, true>(s, m, l, corr, w, lo_w * BK);
    else softmax_tile<BK, kCap, false>(s, m, l, corr, w, lo_w * BK);
    // O·corr + P·V of the previous step is done: release its V, fold in corr, pack P
    auto settle = [&](int j) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (j - 2 >= lo_w) release(v_empty(stage(j - 2)));
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
      pack_p<BK>(p, s);
    };
    auto step = [&](int j, auto edge) {
      settle(j);
      wait_full(k_full(stage(j)), j);
      wait_full(v_full(stage(j - 1)), j - 1);
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
      issue_qk<D>(s, q_tile, sK + stage(j) * T::kKV);
      issue_pv<D>(acc, p, sV + stage(j - 1) * T::kKV);
      wgmma_wait<1>();  // S(j) is done; P·V may still run
      fence_regs(s);
      release(k_empty(stage(j)));
      softmax_tile<BK, kCap, decltype(edge)::value>(s, m, l, corr, w, j * BK);
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
    issue_pv<D>(acc, p, sV + stage(hi_w - 1) * T::kKV);
    wgmma_wait<0>();
    fence_regs(acc);
    release(v_empty(stage(hi_w - 1)));
    for (int j = hi_w; j < hi; ++j) pass(j);
  }

  // out is a fresh contiguous [B, Sq, H, D] tensor
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
    __nv_bfloat16* row = o + (static_cast<long long>(b) * Sq + qpos) * H * D +
                         static_cast<long long>(h) * D + w.c_th;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
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

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
           float* m_out, float* l_out, int B, int Sq, int Sk, int H, int KV, float scale,
           int causal, int window, int has_cap, float cap, cudaStream_t stream) {
  auto kernel = has_cap ? flash_attention_wgmma_kernel<D, true>
                        : flash_attention_wgmma_kernel<D, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + Tile<D>::kBQ - 1) / Tile<D>::kBQ);
  kernel<<<grid, Tile<D>::kThreads, Tile<D>::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), m_out, l_out, Sq, Sk, H, H / KV, scale,
      causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` without synchronizing; returns 0, a CUDA error code, or one of
// the codes above.  q: [B, Sq, H, D]; k, v: [B, Sk, KV, D], bfloat16, each described by
// its tensor-map arguments (ops.tma_map_args: q with 64-row boxes, k and v with
// ops.kv_box_rows(D)-row boxes); o: a contiguous [B, Sq, H, D]; m_out, l_out: contiguous
// float32 [B, H, Sq] for the row stats, or both null for none.  window <= 0 means none;
// has_cap = 0 means no softcap.  The caller checks D in {16, 32, 64, 128, 256},
// H % KV == 0 and the alignment TMA needs.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, void* m_out, void* l_out,
                                            const unsigned long long* q_map,
                                            const unsigned long long* k_map,
                                            const unsigned long long* v_map, int B, int Sq,
                                            int Sk, int H, int KV, int D, float scale,
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
  switch (D) {
    case 16:
      return launch<16>(tq, tk, tv, o, mo, lo, B, Sq, Sk, H, KV, scale, causal, window,
                        has_cap, cap, st);
    case 32:
      return launch<32>(tq, tk, tv, o, mo, lo, B, Sq, Sk, H, KV, scale, causal, window,
                        has_cap, cap, st);
    case 64:
      return launch<64>(tq, tk, tv, o, mo, lo, B, Sq, Sk, H, KV, scale, causal, window,
                        has_cap, cap, st);
    case 128:
      return launch<128>(tq, tk, tv, o, mo, lo, B, Sq, Sk, H, KV, scale, causal, window,
                         has_cap, cap, st);
    case 256:
      return launch<256>(tq, tk, tv, o, mo, lo, B, Sq, Sk, H, KV, scale, causal, window,
                         has_cap, cap, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a launch of head_dim D asks for (0 for a D the kernel does not
// take): Q, the K and V rings, the mbarriers and the alignment slack.
extern "C" int flash_attention_wgmma_smem_bytes(int D) {
  switch (D) {
    case 16: return Tile<16>::kSmem;
    case 32: return Tile<32>::kSmem;
    case 64: return Tile<64>::kSmem;
    case 128: return Tile<128>::kSmem;
    case 256: return Tile<256>::kSmem;
    default: return 0;
  }
}
