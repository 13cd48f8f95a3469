// Attention backward for float32 on Hopper (sm_90a): the kernels FlashAttention.backward
// runs for float32 inputs.  Their products run on the tensor cores as split TF32 up to
// head_dim kSplitMaxD (64), and as fp32 FMAs on the CUDA cores above it.
//
// Replaces no Pallas kernel: the TPU kernel `_fa_kernel` (src/repro/kernels/flash_attention/
// kernel.py:38) has no VJP, and the JAX package differentiates `full_attention` through the
// custom VJP `_fa_bwd` (src/repro/models/attention.py:244), XLA einsums over query × KV
// chunks.  This file computes what `_fa_bwd` computes, as
// repro_torch/kernels/flash_attention/backward.py does in plain PyTorch, from the forward's
// row stats m (natural log of the scaled scores) and l:
//
//   Δ   = rowsum(dO·O)
//   s   = (q·kᵀ)·scale in fp32, as the plain version forms it (the float32 forward
//         scales q first; the two differ in the last bits)
//   optional softcap   t = tanh(s / c),  s = c·t    (accurate tanhf)
//   p   = exp(s − m) / max(l, 1e-30)  where kept, else 0   (keep: causal, window, ends)
//   ds  = p·(dO·vᵀ − Δ)·(1 − t²)                   (the scale is applied to the sums)
//   dq  = scale·Σ_k ds·k      dk = scale·Σ_q ds·q      dv = Σ_q p·dO
//
// Masks are aligned at position 0, as in the forward kernels (the op refuses causal and
// windowed calls with Sq != Sk).  GQA is folded: query head h reads KV head h / G.  p is
// formed from m and l as the forward and the plain version form it, not from one
// log-sum-exp m + log l (the bf16 kernel's), which in fp32 would lose |m|·2⁻²⁴ of every
// exponent: at the scores a softcap of 50 allows, more than the float32 tolerance.
//
// What bounds it on an H100.  The backward does 2.5× the forward's products at the least
// (S, dP, dV, dK, dQ against the forward's S and PV); this design recomputes S and dP in
// its second pass, 3.5× in all.  At llama3.2-1b's shape in float32 (B = 4, S = 2048, 32/8
// heads, D = 64, causal) the 2.5× is 172 GFLOP: 2.57 ms on fp32 FMAs (67 TFLOP/s), and as
// split TF32 (three TF32 products each, tensor_core.cuh) 3 × 172 GFLOP at 494.7 TFLOP/s:
// 1.04 ms, the bound it is held to.  One TF32 pass would miss the float32 tolerance
// (1e-4 of max |g|) by far.  Beside the products it pays the splits (the walked tiles
// twice over, natural and transposed, and P and dS per score), an accurate expf per score
// in both passes (and a tanhf under the softcap), and the loads.
//
// Design: three kernels on the caller's stream, no atomics, so two launches give the
// same bits.
// 1. Prologue: a warp per (batch, head, query row) writes Δ, float32 [B, H, Sq].
// Up to kSplitMaxD, with D zero-padded to DP = 32 or 64 inside the kernels, the two
// passes are blocks of kSplitConsumers consumer and kSplitProducers producer warpgroups.
// 2. dK/dV: one block per (KV head, batch, 64-key tile).  The consumers split the block's
//    K and V rows once into hi / lo tiles (the A operands of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ,
//    wgmma's M = 64 keys).  The walk's items are, in a fixed order, the G query heads that
//    read the KV head times the kSplitQueryTile-row query tiles of the key tile's band
//    (from the tile holding k0 (causal) to the one holding k0 + 63 + window − 1, clipped
//    to Sq).  For each the producers copy the raw Q and dO rows and the rows' m, l and Δ
//    by cp.async into one of kRawBuffers raw buffers (two copies in flight ahead of the
//    splits), then split them into two rings of kSplitStages stages: ring A natural
//    ([rows][DP], the B operands of Sᵀ and dPᵀ), ring B transposed ([DP][rows], the B
//    operands of dK += dSᵀ·Q and dV += Pᵀ·dO: TF32 wgmma operands must be K-major) with
//    the rows' m, 1 / max(l, 1e-30) and Δ.  The consumers take alternate items: Sᵀ and
//    dPᵀ (wgmma m64n32k8) in two commit groups, p under dPᵀ, dV += Pᵀ·dO issued at once,
//    ds under it, then dK += dSᵀ·Q; p and ds stay in registers and are taken as the A
//    fragments of dV and dK in place (split_frag: the accumulator's columns 2t, 2t + 1
//    are the A fragment's k columns t, t + 4, the order in which ColSplit lays out the
//    transposed tiles, so p and ds never go through shared memory); both stages are
//    released when the item's products are done.  Each consumer sums its own dK and dV in
//    registers over its
//    items; at the end the second's are added to the first's through shared memory, in
//    that fixed order, and stored once: GQA needs no repeat and no second pass.
// 3. dQ: one block per (query head, batch, 64-row query tile): the consumers split the
//    block's Q and dO rows once and keep their rows' m, 1 / max(l, 1e-30) and Δ in
//    registers; the items are the forward's band of kSplitKeyTile-key tiles, which the
//    producers copy and split into ring A (K and V natural) and ring B (K transposed).
//    The consumers take alternate tiles, recompute S and dP (two commit groups, p under
//    dP), form ds, sum dQ += dS·K in registers, and add their partial sums in a fixed
//    order at the end.
// The two consumers overlap each other's exponentials and products; the producers'
// splits (each item's elements shared by their 256 threads, the loads of a stage's tiles
// batched before the first split) overlap both.  Every
// product is three TF32 wgmma passes, the small terms first (split_ss, split_rs).  The
// division by l is a multiply by the row's reciprocal, rounded once more: within the
// tolerance (tests/test_torch_flash_fp32_split.py models it).  The producers give the
// consumers registers with setmaxnreg (kProducerRegs, kConsumerRegs).  Shared memory at
// DP = 64: dK/dV 64 KB of own K and V tiles, two stages of each ring (4 · 32 KB), two raw
// buffers of 16.4 KB and the stats (225.8 KB); dQ 64 KB, two stages of 32 + 16 KB and two
// raw buffers of 16 KB (193 KB) (kSmemBudget; the design test recomputes every
// instantiation's bytes from these constants).
//
// Head_dims above kSplitMaxD keep the CUDA-core design below, by a fixed route: at DP =
// 128 the dK/dV block's own split K and V tiles take 128 KB, and each stage of its four
// split query-side tiles takes 64 KB even at 16 rows, so two stages and the raw rows pass
// the 227 KB a block can have (128 + 2·64 + 16 = 272 KB).  There one block of 256 threads
// per (KV head, batch, 64-key tile) (dK/dV) or (query head, batch, 64-row query tile)
// (dQ) stages 64-row tiles (32 at D > 128, kOther256) in shared memory, each thread owns
// 4 own rows × 4 (or 2) walked columns of Sᵀ and dPᵀ (fp32 FMAs), p and ds go through
// shared tiles, and at D > 128 a dK/dV block takes one of two 128-column slabs
// (kSlabCols).  Rows of its tiles are padded by one float and the p / ds rows by four.
//
// Rounding.  Built without --use_fast_math: expf and tanhf are the accurate library
// functions.  Sums run in another order than the plain version's, so results agree with
// it to about 1e-6 of each gradient's largest magnitude, not bit for bit.

#include "tensor_core.cuh"

namespace {

constexpr int kSplitMaxD = 64;       // head_dims up to this take the split-TF32 kernels
constexpr int kSplitKeys = 64;       // dK/dV: keys a block, its consumer warpgroup's M
constexpr int kSplitQueryTile = 32;  // dK/dV: query rows a ring stage
constexpr int kSplitRows = 64;       // dQ: query rows a block
constexpr int kSplitKeyTile = 32;    // dQ: keys a ring stage
constexpr int kSplitStages = 2;      // stages of each ring of both split kernels
constexpr int kRawBuffers = 2;       // raw tiles of the producer's copies
constexpr int kSplitConsumers = 2;   // consumer warpgroups a block: they take alternate items
constexpr int kSplitProducers = 2;   // producer warpgroups a block: they split each item together
constexpr int kProducerThreads = 128 * kSplitProducers;
constexpr int kSplitThreads = 128 * (kSplitConsumers + kSplitProducers);
// Registers a thread after setmaxnreg (each thread has 65536 / kSplitThreads, rounded down
// to 8, at launch).  The consumers can only take what the producers give up: a larger sum
// never completes.
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 184;
static_assert(kProducerThreads * kProducerRegs + 128 * kSplitConsumers * kConsumerRegs <=
                  kSplitThreads * (65536 / kSplitThreads / 8 * 8),
              "register pool");
// The CUDA-core kernels' tiles (head_dim above kSplitMaxD).
constexpr int kOwn = 64;        // rows a block owns: keys (dK/dV) or query rows (dQ)
constexpr int kOther = 64;      // rows of the tiles it walks: query rows (dK/dV) or keys (dQ)
constexpr int kOther256 = 32;   // ... at head_dim above 128
constexpr int kThreads = 256;   // 16 row groups × 16 column lanes
constexpr int kTR = 4;          // own rows per thread
constexpr int kPad = 4;         // padding of a p / ds row, in floats
constexpr int kSlabCols = 128;  // dK/dV: output columns a block at most
constexpr int kRowsPerBlock = 8;   // prologue: one row a warp
constexpr int kSmemBudget = 232448;

// Shared floats of each kernel at head_dim D with BO-row walked tiles.
__host__ __device__ constexpr int dkdv_floats(int d, int bo) {
  return 2 * kOwn * (d + 1) + 2 * bo * (d + 1) + 2 * kOwn * (bo + kPad) + 3 * bo;
}
__host__ __device__ constexpr int dq_floats(int d, int bo) {
  return 2 * kOwn * (d + 1) + 2 * bo * (d + 1) + kOwn * (bo + kPad);
}
static_assert(dkdv_floats(256, kOther256) * 4 <= kSmemBudget, "dK/dV tiles at D = 256");
static_assert(dq_floats(256, kOther256) * 4 <= kSmemBudget, "dQ tiles at D = 256");
static_assert(dkdv_floats(128, kOther) * 4 <= kSmemBudget, "dK/dV tiles at D = 128");

// The score (tensor_core.cuh) with the softcap known at compile time (the split kernels'
// instantiations).
template <bool kCap>
__device__ __forceinline__ float score(float raw, const Opts& o, float* dfac, Bool<kCap>) {
  const float x = raw * o.scale;
  if constexpr (!kCap) {
    *dfac = 1.0f;
    return x;
  } else {
    const float t = tanhf(x / o.cap);
    *dfac = 1.0f - t * t;
    return o.cap * t;
  }
}

// 1. Δ of each row, a warp per row.
__global__ void __launch_bounds__(kThreads) prologue_kernel(
    const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ delta,
    long long rows, int Sq, int H, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / Sq;
  const int qi = static_cast<int>(row % Sq);
  const long long b = bh / H, h = bh % H;
  const long long base = ((b * Sq + qi) * H + h) * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(dout[base + d], o[base + d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Shared-memory geometry of the split kernels at padded head_dim DP.  Each keeps two
// rings of kSplitStages stages: ring A holds the walked tiles of the score products
// (natural), ring B the transposed tiles of the gradient products (and, in dK/dV, the
// rows' stats); the producers fill an item's A before its B.  The raw tiles are
// double-buffered, so a copy is in flight while the one before it is split.
template <int DP>
struct SplitKv {  // dK/dV
  static constexpr int kBQ = kSplitQueryTile;
  static constexpr int kOwnTile = kSplitKeys * DP * 4;  // an own K or V hi (or lo) tile
  static constexpr int kTile = kBQ * DP * 4;            // a walked hi (or lo) tile
  static constexpr int kStageA = 4 * kTile;             // Q and dO, hi and lo
  static constexpr int kStageB = 4 * kTile;             // Qᵀ and dOᵀ, hi and lo
  static constexpr int kStats = 3 * kBQ * 4;            // m, 1 / max(l, 1e-30), Δ
  static constexpr int kRaw = kBQ * DP * 4;             // a raw Q or dO tile
  // a raw buffer: Q, dO and the rows' m, l and Δ as copied
  static constexpr int kRawBuffer = 2 * kRaw + kStats;
  static constexpr int kSmem = 4 * kOwnTile + kSplitStages * (kStageA + kStageB) +
                               kRawBuffers * kRawBuffer + kSplitStages * kStats + 64 + 1024;
  static_assert(kSmem <= kSmemBudget, "dK/dV shared memory");
};
template <int DP>
struct SplitQ {  // dQ
  static constexpr int kBK = kSplitKeyTile;
  static constexpr int kOwnTile = kSplitRows * DP * 4;  // an own Q or dO hi (or lo) tile
  static constexpr int kTile = kBK * DP * 4;            // a walked hi (or lo) tile
  static constexpr int kStageA = 4 * kTile;             // K and V, hi and lo
  static constexpr int kStageB = 2 * kTile;             // Kᵀ, hi and lo
  static constexpr int kRaw = kBK * DP * 4;             // a raw K or V tile
  static constexpr int kSmem = 4 * kOwnTile + kSplitStages * (kStageA + kStageB) +
                               kRawBuffers * 2 * kRaw + 64 + 1024;
  static_assert(kSmem <= kSmemBudget, "dQ shared memory");
};

// Rows [r0, r0 + R) of a [.., S, .., D] operand at `base` (row stride `ss` elements) into a
// raw [R][DP] tile: zeros past `S` and past D.  One commit group; NT threads, this one t.
template <int R, int DP, int NT>
__device__ __forceinline__ void copy_rows(uint32_t raw, const float* base, long long ss,
                                          int r0, int S, int D, int vec, int t) {
  if (vec) {
    for (int i = t; i < R * DP / 4; i += NT) {
      const int r = i / (DP / 4), c = i % (DP / 4) * 4;
      const bool in = r0 + r < S && c < D;
      cp_async16(raw + (r * DP + c) * 4, base + (in ? (r0 + r) * ss + c : 0), in);
    }
  } else {
    for (int i = t; i < R * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      const bool in = r0 + r < S && c < D;
      cp_async4(raw + (r * DP + c) * 4, base + (in ? (r0 + r) * ss + c : 0), in);
    }
  }
}

// A block's own 64 rows of a [.., S, .., D] operand, split straight from device memory
// into hi / lo tiles [64][DP] (zeros past S and past D) by the consumer warpgroups' threads.
template <int DP>
__device__ __forceinline__ void own_rows(const Smem& sm, uint32_t hi, uint32_t lo,
                                         const float* base, long long ss, int r0, int S, int D,
                                         int t) {
  for (int i = t; i < 64 * DP / 4; i += 128 * kSplitConsumers) {
    const int ch = i % 8, r = i / 8 % 64, box = i / (8 * 64);
    const int c = box * 32 + ch * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + r < S) {
      const float* src = base + (r0 + r) * ss;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < D) x[u] = src[c + u];
    }
    const uint32_t off = box * 64 * 128 + swizzle128(r, ch);
    st_split4(sm, hi + off, lo + off, make_float4(x[0], x[1], x[2], x[3]));
  }
}

// Barriers of the two rings: full and empty of each stage of A, then of B.
struct Rings {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full_a(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty_a(int s) const {
    return bars + 8u * (kSplitStages + s);
  }
  __device__ __forceinline__ uint32_t full_b(int s) const {
    return bars + 8u * (2 * kSplitStages + s);
  }
  __device__ __forceinline__ uint32_t empty_b(int s) const {
    return bars + 8u * (3 * kSplitStages + s);
  }
  // Thread 0: every producer thread arrives on a full barrier, one lane of each of the 4
  // warps of the consumer warpgroup that takes the stage's item on an empty one.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(full_a(s), kProducerThreads);
      mbar_init(empty_a(s), 4);
      mbar_init(full_b(s), kProducerThreads);
      mbar_init(empty_b(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// Item n of a walk sits in stage n % kSplitStages of both rings, in round n / kSplitStages.
__device__ __forceinline__ uint32_t round_parity(int n) {
  return static_cast<uint32_t>((n / kSplitStages) & 1);
}

// The producer's walk over `items` items: copy(n, buffer) issues item n's raw copies into
// raw buffer `buffer` (one commit group), split_a(n, stage) and split_b(n, stage) fill its
// stages.  Two copies are in flight ahead of the splits.
template <typename Copy, typename SplitA, typename SplitB>
__device__ __forceinline__ void produce(const Rings& rings, int items, Copy copy,
                                        SplitA split_a, SplitB split_b) {
  for (int n = 0; n < min(items, kRawBuffers); ++n) copy(n, n);
  for (int n = 0; n < items; ++n) {
    const int s = n % kSplitStages;
    if (n + 1 < items) cp_async_wait<1>();
    else cp_async_wait<0>();
    bar_sync(3, kProducerThreads);  // item n's raw copies of every producer thread are in
    mbar_wait(rings.empty_a(s), round_parity(n) ^ 1);  // the first round passes at once
    split_a(n, s);
    fence_proxy_async();
    mbar_arrive(rings.full_a(s));
    mbar_wait(rings.empty_b(s), round_parity(n) ^ 1);
    split_b(n, s);
    fence_proxy_async();
    mbar_arrive(rings.full_b(s));
    bar_sync(3, kProducerThreads);  // every producer thread is done with the raw buffer
    if (n + kRawBuffers < items) copy(n + kRawBuffers, n % kRawBuffers);
  }
}

// A consumer warpgroup's walk: warpgroup wg takes items wg, wg + 2, ...  Once both of an
// item's stages are in, scores(n, sc, dp) issues its two score products (ring A) into the
// fragments sc and dp, one commit group each; rest(n, sc, dp) waits for them one at a
// time, so that the exponentials of sc run while the tensor cores do dp, turns them into
// the gradient products (ring B) and commits those; the other warpgroup's item overlaps
// all of it.  No barrier is waited on or arrived at while a product is in flight: ptxas
// serializes every wgmma of a kernel that branches around one in flight.
template <int F, typename Scores, typename Rest>
__device__ __forceinline__ void consume(const Rings& rings, int items, int wg, int lane,
                                        Scores scores, Rest rest) {
  float sc[F], dp[F];
  for (int n = wg; n < items; n += kSplitConsumers) {
    const int s = n % kSplitStages;
    mbar_wait(rings.full_a(s), round_parity(n));
    mbar_wait(rings.full_b(s), round_parity(n));
    __syncwarp();  // the .aligned wgmma instructions need the warp converged
    scores(n, sc, dp);
    rest(n, sc, dp);
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(rings.empty_a(s));
      mbar_arrive(rings.empty_b(s));
    }
  }
}

// The two consumer warpgroups' partial sums of one 64-row output, added in a fixed order
// (warpgroup 0's + warpgroup 1's, handed over through `buf`, N floats a thread), so two
// launches give the same bits.  Every product of both is done and the rings are idle.
template <int N>
__device__ __forceinline__ void add_partials(const Smem& sm, float (&x)[N], uint32_t buf,
                                             int wg, int t128) {
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) sm.at<float>(buf + (e * 128 + t128) * 4) = x[e];
  }
  bar_sync(1, 256);
  if (wg == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] += sm.at<float>(buf + (e * 128 + t128) * 4);
  }
}

// 2. dK and dV of one 64-key tile, split TF32.
template <int DP, bool kCap>
__global__ void __launch_bounds__(kSplitThreads, 1) dkdv_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    Strides qs, Strides ks, Strides vs, int Sq, int Sk, int H, int KV, int D, Opts opt,
    int vec) {
  using T = SplitKv<DP>;
  constexpr int BQ = T::kBQ;
  constexpr int PT = kProducerThreads;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;  // hi, lo
  const uint32_t sV = sK + 2 * T::kOwnTile;                     // hi, lo
  const uint32_t sA = sV + 2 * T::kOwnTile;                     // ring A: Q, dO
  const uint32_t sB = sA + kSplitStages * T::kStageA;           // ring B: Qᵀ, dOᵀ
  const uint32_t sRaw = sB + kSplitStages * T::kStageB;         // [buffer][Q, dO, m, l, Δ]
  const uint32_t sStats = sRaw + kRawBuffers * T::kRawBuffer;   // [stage][m, 1 / l, Δ]
  const Rings rings{sStats + kSplitStages * T::kStats};
  auto tile_a = [&](int s, int i) { return sA + s * T::kStageA + i * T::kTile; };
  auto tile_b = [&](int s, int i) { return sB + s * T::kStageB + i * T::kTile; };
  auto raw = [&](int buf, int i) { return sRaw + buf * T::kRawBuffer + i * T::kRaw; };
  auto raw_stats = [&](int buf, int i) { return raw(buf, 2) + i * BQ * 4; };
  auto stats = [&](int s, int i) { return sStats + s * T::kStats + i * BQ * 4; };

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kSplitKeys;  // the causal band's longest tiles first
  const int G = H / KV;
  // The key tile's band of query tiles: from the one holding k0 (causal) to the one
  // holding its last key's last query in the window, clipped to Sq; walked for each of
  // the G heads, item n = g·tiles + (t − t_lo).
  const int q_lo = opt.causal ? k0 : 0;
  const int q_end = opt.window > 0 ? min(Sq, k0 + kSplitKeys - 1 + opt.window) : Sq;
  const int t_lo = q_lo / BQ;
  const int tiles = q_lo < q_end ? (q_end - 1) / BQ + 1 - t_lo : 0;
  const int items = G * tiles;
  auto head = [&](int n) { return kvh * G + n / tiles; };
  auto row0 = [&](int n) { return (t_lo + n % tiles) * BQ; };

  if (threadIdx.x == 0) rings.init();
  __syncthreads();

  if (threadIdx.x >= 128 * kSplitConsumers) {
    // Producer warpgroups: they give their registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int t = threadIdx.x - 128 * kSplitConsumers;
    produce(
        rings, items,
        [&](int n, int buf) {
          const int h = head(n);
          copy_rows<BQ, DP, PT>(raw(buf, 0), q + b * qs.b + h * qs.h, qs.s, row0(n), Sq, D,
                                 vec, t);
          const float* ob = dout + (static_cast<long long>(b) * Sq * H + h) * D;
          copy_rows<BQ, DP, PT>(raw(buf, 1), ob, static_cast<long long>(H) * D, row0(n), Sq,
                                 D, vec, t);
          if (t < 3 * BQ) {  // the rows' m, l, Δ (zeros past Sq)
            const int which = t / BQ, qpos = row0(n) + t % BQ;
            const float* src = which == 0 ? m : which == 1 ? l : delta;
            const bool in = qpos < Sq;
            cp_async4(raw_stats(buf, which) + t % BQ * 4,
                      src + (in ? (static_cast<long long>(b) * H + h) * Sq + qpos : 0), in);
          }
          cp_async_commit();
        },
        [&](int n, int s) {
          RowSplit<BQ, DP, PT> qs_, os_;
          qs_.load(sm, raw(n % kRawBuffers, 0), t);
          os_.load(sm, raw(n % kRawBuffers, 1), t);
          qs_.store(sm, tile_a(s, 0), tile_a(s, 1), t);
          os_.store(sm, tile_a(s, 2), tile_a(s, 3), t);
        },
        [&](int n, int s) {
          ColSplit<BQ, DP, PT> qs_, os_;
          qs_.load(sm, raw(n % kRawBuffers, 0), t);
          os_.load(sm, raw(n % kRawBuffers, 1), t);
          qs_.store(sm, tile_b(s, 0), tile_b(s, 1), t);
          os_.store(sm, tile_b(s, 2), tile_b(s, 3), t);
          if (t < BQ) {  // rows past Sq are masked: their stats are never used
            const int buf = n % kRawBuffers;
            sm.at<float>(stats(s, 0) + t * 4) = sm.at<float>(raw_stats(buf, 0) + t * 4);
            sm.at<float>(stats(s, 1) + t * 4) =
                1.0f / fmaxf(sm.at<float>(raw_stats(buf, 1) + t * 4), 1e-30f);
            sm.at<float>(stats(s, 2) + t * 4) = sm.at<float>(raw_stats(buf, 2) + t * 4);
          }
        });
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int r_lo = 16 * (t128 / 32) + lane / 4;  // key rows r_lo, r_lo + 8 of the 64
  const int c_th = 2 * (lane % 4);
  own_rows<DP>(sm, sK, sK + T::kOwnTile, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk, D,
               threadIdx.x);
  own_rows<DP>(sm, sV, sV + T::kOwnTile, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk, D,
               threadIdx.x);
  fence_proxy_async();
  bar_sync(1, 256);

  float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc_k[e] = acc_v[e] = 0.0f;
  fence_regs(acc_k);  // the zeros are set before any product is in flight
  fence_regs(acc_v);
  uint32_t p_hi[BQ / 8][4], p_lo[BQ / 8][4], s_hi[BQ / 8][4], s_lo[BQ / 8][4];
  consume<BQ / 2>(
      rings, items, wg, lane,
      [&](int n, float (&st)[BQ / 2], float (&dp)[BQ / 2]) {
        const int s = n % kSplitStages;
        fence_regs(st);
        fence_regs(dp);
        wgmma_fence();
        split_ss<BQ, DP>(st, sK, sK + T::kOwnTile, tile_a(s, 0), tile_a(s, 1));
        wgmma_commit();
        split_ss<BQ, DP>(dp, sV, sV + T::kOwnTile, tile_a(s, 2), tile_a(s, 3));
        wgmma_commit();
      },
      [&](int n, float (&st)[BQ / 2], float (&dp)[BQ / 2]) {
        const int s = n % kSplitStages;
        const int q0 = row0(n);
        wgmma_wait<1>();  // Sᵀ is done; dPᵀ may still run
        fence_regs(st);
        float dfac[kCap ? BQ / 2 : 1];  // the softcap's (1 − t²), kept for ds
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int kpos = k0 + r_lo + 8 * ((e >> 1) & 1);
          const int col = 8 * (e >> 2) + c_th + (e & 1);
          float f;
          const float x = score(st[e], opt, &f, Bool<kCap>());
          if constexpr (kCap) dfac[e] = f;
          // masked pairs get p = 0, and so ds = 0
          st[e] = kept(q0 + col, kpos, Sq, Sk, opt)
                      ? expf(x - sm.at<float>(stats(s, 0) + col * 4)) *
                            sm.at<float>(stats(s, 1) + col * 4)
                      : 0.0f;
        }
        split_frag<BQ / 8>(p_hi, p_lo, st);
        fence_regs(acc_v);
        wgmma_fence();
        split_rs<DP, BQ / 8>(acc_v, p_hi, p_lo, tile_b(s, 2), tile_b(s, 3));
        wgmma_commit();
        wgmma_wait<1>();  // dPᵀ is done; dV may still run
        fence_regs(dp);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int col = 8 * (e >> 2) + c_th + (e & 1);
          dp[e] = st[e] * (dp[e] - sm.at<float>(stats(s, 2) + col * 4));
          if constexpr (kCap) dp[e] *= dfac[e];
        }
        split_frag<BQ / 8>(s_hi, s_lo, dp);
        fence_regs(acc_k);
        wgmma_fence();
        split_rs<DP, BQ / 8>(acc_k, s_hi, s_lo, tile_b(s, 0), tile_b(s, 1));
        wgmma_commit();
      });
  fence_regs(acc_k);
  fence_regs(acc_v);
  bar_sync(1, 256);  // both warpgroups' products are done: ring A takes the partials
  add_partials<DP / 2>(sm, acc_k, sA, wg, t128);
  add_partials<DP / 2>(sm, acc_v, sA + 128 * DP * 2, wg, t128);
  if (wg != 0) return;

  // dk, dv are fresh contiguous [B, Sk, KV, D] tensors
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + r_lo + 8 * r;
    if (kpos >= Sk) continue;
    const long long base = ((static_cast<long long>(b) * Sk + kpos) * KV + kvh) * D;
#pragma unroll
    for (int g = 0; g < DP / 8; ++g) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 8 * g + c_th + u;
        if (col < D) {
          dk[base + col] = acc_k[4 * g + 2 * r + u] * opt.scale;
          dv[base + col] = acc_v[4 * g + 2 * r + u];
        }
      }
    }
  }
}

// 3. dQ of one 64-row query tile, split TF32.
template <int DP, bool kCap>
__global__ void __launch_bounds__(kSplitThreads, 1) dq_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, float* __restrict__ dq, Strides qs, Strides ks,
    Strides vs, int Sq, int Sk, int H, int KV, int D, Opts opt, int vec) {
  using T = SplitQ<DP>;
  constexpr int BK = T::kBK;
  constexpr int PT = kProducerThreads;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // hi, lo
  const uint32_t sO = sQ + 2 * T::kOwnTile;                     // dO hi, lo
  const uint32_t sA = sO + 2 * T::kOwnTile;                     // ring A: K, V
  const uint32_t sB = sA + kSplitStages * T::kStageA;           // ring B: Kᵀ
  const uint32_t sRaw = sB + kSplitStages * T::kStageB;         // [buffer][K, V]
  const Rings rings{sRaw + kRawBuffers * 2 * T::kRaw};
  auto tile_a = [&](int s, int i) { return sA + s * T::kStageA + i * T::kTile; };
  auto tile_b = [&](int s, int i) { return sB + s * T::kStageB + i * T::kTile; };
  auto raw = [&](int buf, int i) { return sRaw + (2 * buf + i) * T::kRaw; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kSplitRows;  // the causal band's longest first
  const int kvh = h / (H / KV);
  // The forward's band of key tiles for this query tile: item n is tile lo + n.
  const int nk = (Sk + BK - 1) / BK;
  const int hi = opt.causal ? min((min(q0 + kSplitRows, Sq) - 1) / BK + 1, nk) : nk;
  const int lo = opt.window > 0 ? max(q0 - opt.window + 1, 0) / BK : 0;
  const int items = max(hi - lo, 0);

  if (threadIdx.x == 0) rings.init();
  __syncthreads();

  if (threadIdx.x >= 128 * kSplitConsumers) {
    // Producer warpgroups: they give their registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int t = threadIdx.x - 128 * kSplitConsumers;
    const float* kb = k + b * ks.b + kvh * ks.h;
    const float* vb = v + b * vs.b + kvh * vs.h;
    produce(
        rings, items,
        [&](int n, int buf) {
          copy_rows<BK, DP, PT>(raw(buf, 0), kb, ks.s, (lo + n) * BK, Sk, D, vec, t);
          copy_rows<BK, DP, PT>(raw(buf, 1), vb, vs.s, (lo + n) * BK, Sk, D, vec, t);
          cp_async_commit();
        },
        [&](int n, int s) {
          RowSplit<BK, DP, PT> ks_, vs_;
          ks_.load(sm, raw(n % kRawBuffers, 0), t);
          vs_.load(sm, raw(n % kRawBuffers, 1), t);
          ks_.store(sm, tile_a(s, 0), tile_a(s, 1), t);
          vs_.store(sm, tile_a(s, 2), tile_a(s, 3), t);
        },
        [&](int n, int s) {
          ColSplit<BK, DP, PT> kt_;
          kt_.load(sm, raw(n % kRawBuffers, 0), t);
          kt_.store(sm, tile_b(s, 0), tile_b(s, 1), t);
        });
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int r_lo = 16 * (t128 / 32) + lane / 4;  // query rows r_lo, r_lo + 8 of the 64
  const int c_th = 2 * (lane % 4);
  own_rows<DP>(sm, sQ, sQ + T::kOwnTile, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D,
               threadIdx.x);
  own_rows<DP>(sm, sO, sO + T::kOwnTile, dout + (static_cast<long long>(b) * Sq * H + h) * D,
               static_cast<long long>(H) * D, q0, Sq, D, threadIdx.x);
  fence_proxy_async();
  bar_sync(1, 256);
  float rm[2], rl[2], rd[2];
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r_lo + 8 * r;
    rm[r] = qpos < Sq ? m[row0 + qpos] : 0.0f;
    rl[r] = qpos < Sq ? 1.0f / fmaxf(l[row0 + qpos], 1e-30f) : 1.0f;
    rd[r] = qpos < Sq ? delta[row0 + qpos] : 0.0f;
  }

  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
  fence_regs(acc);
  uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
  consume<BK / 2>(
      rings, items, wg, lane,
      [&](int n, float (&sc)[BK / 2], float (&dp)[BK / 2]) {
        const int s = n % kSplitStages;
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        split_ss<BK, DP>(sc, sQ, sQ + T::kOwnTile, tile_a(s, 0), tile_a(s, 1));
        wgmma_commit();
        split_ss<BK, DP>(dp, sO, sO + T::kOwnTile, tile_a(s, 2), tile_a(s, 3));
        wgmma_commit();
      },
      [&](int n, float (&sc)[BK / 2], float (&dp)[BK / 2]) {
        const int s = n % kSplitStages;
        const int k0 = (lo + n) * BK;
        wgmma_wait<1>();  // S is done; dP may still run
        fence_regs(sc);
        float dfac[kCap ? BK / 2 : 1];  // the softcap's (1 − t²), kept for ds
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int r = (e >> 1) & 1;
          const int qpos = q0 + r_lo + 8 * r;
          const int kpos = k0 + 8 * (e >> 2) + c_th + (e & 1);
          float f;
          const float x = score(sc[e], opt, &f, Bool<kCap>());
          if constexpr (kCap) dfac[e] = f;
          // masked pairs get p = 0, and so ds = 0
          sc[e] = kept(qpos, kpos, Sq, Sk, opt) ? expf(x - rm[r]) * rl[r] : 0.0f;
        }
        wgmma_wait<0>();  // dP is done
        fence_regs(dp);
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          dp[e] = sc[e] * (dp[e] - rd[(e >> 1) & 1]);
          if constexpr (kCap) dp[e] *= dfac[e];
        }
        split_frag<BK / 8>(a_hi, a_lo, dp);
        fence_regs(acc);
        wgmma_fence();
        split_rs<DP, BK / 8>(acc, a_hi, a_lo, tile_b(s, 0), tile_b(s, 1));
        wgmma_commit();
      });
  fence_regs(acc);
  bar_sync(1, 256);  // both warpgroups' products are done: ring A takes the partials
  add_partials<DP / 2>(sm, acc, sA, wg, t128);
  if (wg != 0) return;

  // dq is a fresh contiguous [B, Sq, H, D] tensor
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r_lo + 8 * r;
    if (qpos >= Sq) continue;
    const long long base = ((static_cast<long long>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int g = 0; g < DP / 8; ++g) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 8 * g + c_th + u;
        if (col < D) dq[base + col] = acc[4 * g + 2 * r + u] * opt.scale;
      }
    }
  }
}

// 2. (CUDA cores) dK and dV of one 64-key tile, columns [c0, c0 + 16·NJ) of them.  NJ =
// output columns a thread (c0 + tx + 16·jj), BO = query rows a walked tile.
template <int NJ, int BO>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    Strides qs, Strides ks, Strides vs, int Sq, int Sk, int H, int KV, int D, Opts opt) {
  constexpr int kTC = BO / 16;  // query columns a thread: tx + 16·c
  constexpr int kLdP = BO + kPad;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sK = smem;              // [kOwn][ld]
  float* sV = sK + kOwn * ld;    // [kOwn][ld]
  float* sQ = sV + kOwn * ld;    // [BO][ld]
  float* sO = sQ + BO * ld;      // [BO][ld], dO
  float* sP = sO + BO * ld;      // [kOwn][kLdP]
  float* sS = sP + kOwn * kLdP;  // [kOwn][kLdP], ds
  float* sM = sS + kOwn * kLdP;  // [BO] m
  float* sL = sM + BO;           // [BO] max(l, 1e-30)
  float* sD = sL + BO;           // [BO] Δ

  const int slabs = (D + 16 * NJ - 1) / (16 * NJ);
  const int kvh = blockIdx.x / slabs;
  const int c0 = blockIdx.x % slabs * 16 * NJ;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kOwn;  // the causal band's longest tiles first
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  for (int i = tid; i < kOwn * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool in = k0 + r < Sk;
    sK[r * ld + d] = in ? kb[(k0 + r) * ks.s + d] : 0.0f;
    sV[r * ld + d] = in ? vb[(k0 + r) * vs.s + d] : 0.0f;
  }

  // The key tile's band of query tiles: from the one holding k0 (causal) to the one
  // holding its last key's last query in the window, clipped to Sq.
  const int q_lo = opt.causal ? k0 : 0;
  const int q_end = opt.window > 0 ? min(Sq, k0 + kOwn - 1 + opt.window) : Sq;
  const int t_lo = q_lo / BO;
  const int t_hi = q_lo < q_end ? (q_end - 1) / BO + 1 : t_lo;

  float accK[kTR][NJ], accV[kTR][NJ];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) accK[r][jj] = accV[r][jj] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BO;
      __syncthreads();  // K, V are written; the last tile's reads are done
      for (int i = tid; i < BO * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const bool in = q0 + r < Sq;
        sQ[r * ld + d] = in ? qb[(q0 + r) * qs.s + d] : 0.0f;
        sO[r * ld + d] = in ? dout[((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + d]
                            : 0.0f;
      }
      for (int r = tid; r < BO; r += kThreads) {
        const bool in = q0 + r < Sq;
        sM[r] = in ? m[row0 + q0 + r] : 0.0f;
        sL[r] = in ? fmaxf(l[row0 + q0 + r], 1e-30f) : 1.0f;
        sD[r] = in ? delta[row0 + q0 + r] : 0.0f;
      }
      __syncthreads();

      float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
      for (int r = 0; r < kTR; ++r)
#pragma unroll
        for (int c = 0; c < kTC; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[kTR], vr[kTR], qc[kTC], oc[kTC];
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          kr[r] = sK[(ty * kTR + r) * ld + d];
          vr[r] = sV[(ty * kTR + r) * ld + d];
        }
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
          qc[c] = sQ[(tx + 16 * c) * ld + d];
          oc[c] = sO[(tx + 16 * c) * ld + d];
        }
#pragma unroll
        for (int r = 0; r < kTR; ++r)
#pragma unroll
          for (int c = 0; c < kTC; ++c) {
            s[r][c] = fmaf(kr[r], qc[c], s[r][c]);
            dp[r][c] = fmaf(vr[r], oc[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const int kpos = k0 + ty * kTR + r;
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
          const int col = tx + 16 * c;
          float dfac;
          const float x = score(s[r][c], opt, &dfac);
          const bool keep = kept(q0 + col, kpos, Sq, Sk, opt);
          const float p = keep ? expf(x - sM[col]) / sL[col] : 0.0f;
          sP[(ty * kTR + r) * kLdP + col] = p;
          sS[(ty * kTR + r) * kLdP + col] = keep ? p * (dp[r][c] - sD[col]) * dfac : 0.0f;
        }
      }
      __syncwarp();  // a key row's p and ds are written and read by one half-warp

#pragma unroll 4
      for (int qq = 0; qq < BO; ++qq) {
        float pr[kTR], sr[kTR];
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          pr[r] = sP[(ty * kTR + r) * kLdP + qq];
          sr[r] = sS[(ty * kTR + r) * kLdP + qq];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int d = c0 + tx + 16 * jj;
          const float ov = d < D ? sO[qq * ld + d] : 0.0f;
          const float qv = d < D ? sQ[qq * ld + d] : 0.0f;
#pragma unroll
          for (int r = 0; r < kTR; ++r) {
            accV[r][jj] = fmaf(pr[r], ov, accV[r][jj]);
            accK[r][jj] = fmaf(sr[r], qv, accK[r][jj]);
          }
        }
      }
    }
  }

  // dk, dv are fresh contiguous [B, Sk, KV, D] tensors
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int kpos = k0 + ty * kTR + r;
    if (kpos >= Sk) continue;
    const long long base = ((static_cast<long long>(b) * Sk + kpos) * KV + kvh) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = c0 + tx + 16 * jj;
      if (d < D) {
        dk[base + d] = accK[r][jj] * opt.scale;
        dv[base + d] = accV[r][jj];
      }
    }
  }
}

// 3. (CUDA cores) dQ of one 64-row query tile.  NJ = output columns a thread, BO = keys a
// walked tile.
template <int NJ, int BO>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, float* __restrict__ dq, Strides qs, Strides ks,
    Strides vs, int Sq, int Sk, int H, int KV, int D, Opts opt) {
  constexpr int kTC = BO / 16;  // key columns a thread: tx + 16·c
  constexpr int kLdS = BO + kPad;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;              // [kOwn][ld]
  float* sO = sQ + kOwn * ld;    // [kOwn][ld], dO
  float* sK = sO + kOwn * ld;    // [BO][ld]
  float* sV = sK + BO * ld;      // [BO][ld]
  float* sS = sV + BO * ld;      // [kOwn][kLdS], ds

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn;  // the causal band's longest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* qb = q + b * qs.b + h * qs.h;
  for (int i = tid; i < kOwn * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < Sq;
    sQ[r * ld + d] = in ? qb[(q0 + r) * qs.s + d] : 0.0f;
    sO[r * ld + d] = in ? dout[((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + d]
                        : 0.0f;
  }
  float rm[kTR], rl[kTR], rd[kTR];
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int qpos = q0 + ty * kTR + r;
    rm[r] = qpos < Sq ? m[row0 + qpos] : 0.0f;
    rl[r] = qpos < Sq ? fmaxf(l[row0 + qpos], 1e-30f) : 1.0f;
    rd[r] = qpos < Sq ? delta[row0 + qpos] : 0.0f;
  }

  // The forward's band of key tiles for this query tile.
  const int nk = (Sk + BO - 1) / BO;
  const int hi = opt.causal ? min((min(q0 + kOwn, Sq) - 1) / BO + 1, nk) : nk;
  const int lo = opt.window > 0 ? max(q0 - opt.window + 1, 0) / BO : 0;

  float acc[kTR][NJ];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[r][jj] = 0.0f;

  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BO;
    __syncthreads();  // Q, dO are written; the last tile's reads are done
    for (int i = tid; i < BO * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Sk;
      sK[r * ld + d] = in ? kb[(k0 + r) * ks.s + d] : 0.0f;
      sV[r * ld + d] = in ? vb[(k0 + r) * vs.s + d] : 0.0f;
    }
    __syncthreads();

    float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[kTR], orr[kTR], kc[kTC], vc[kTC];
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        qr[r] = sQ[(ty * kTR + r) * ld + d];
        orr[r] = sO[(ty * kTR + r) * ld + d];
      }
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        kc[c] = sK[(tx + 16 * c) * ld + d];
        vc[c] = sV[(tx + 16 * c) * ld + d];
      }
#pragma unroll
      for (int r = 0; r < kTR; ++r)
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
          s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
          dp[r][c] = fmaf(orr[r], vc[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int qpos = q0 + ty * kTR + r;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int col = tx + 16 * c;
        float dfac;
        const float x = score(s[r][c], opt, &dfac);
        const bool keep = kept(qpos, k0 + col, Sq, Sk, opt);
        const float p = keep ? expf(x - rm[r]) / rl[r] : 0.0f;
        sS[(ty * kTR + r) * kLdS + col] = keep ? p * (dp[r][c] - rd[r]) * dfac : 0.0f;
      }
    }
    __syncwarp();  // a query row's ds is written and read by one half-warp

#pragma unroll 4
    for (int kk = 0; kk < BO; ++kk) {
      float sr[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) sr[r] = sS[(ty * kTR + r) * kLdS + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx + 16 * jj;
        const float kv = d < D ? sK[kk * ld + d] : 0.0f;
#pragma unroll
        for (int r = 0; r < kTR; ++r) acc[r][jj] = fmaf(sr[r], kv, acc[r][jj]);
      }
    }
  }

  // dq is a fresh contiguous [B, Sq, H, D] tensor
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int qpos = q0 + ty * kTR + r;
    if (qpos >= Sq) continue;
    const long long base = ((static_cast<long long>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) dq[base + d] = acc[r][jj] * opt.scale;
    }
  }
}


struct Args {
  const float *q, *k, *v, *o, *dout, *m, *l;
  float *dq, *dk, *dv, *delta;
  int B, Sq, Sk, H, KV, D;
  Strides qs, ks, vs;
  Opts opt;
  int vec;  // the split kernels' raw copies may be 16 bytes
};

template <int NJ, int BO>
int launch_cuda_core(const Args& a, cudaStream_t stream) {
  constexpr int NJK = NJ < kSlabCols / 16 ? NJ : kSlabCols / 16;  // dK/dV's columns a thread
  const int slabs = (a.D + 16 * NJK - 1) / (16 * NJK);
  const int dkdv_smem = dkdv_floats(a.D, BO) * 4;
  const int dq_smem = dq_floats(a.D, BO) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NJK, BO>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<NJ, BO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  prologue_kernel<<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads,
                    0, stream>>>(a.o, a.dout, a.delta, rows, a.Sq, a.H, a.D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<NJK, BO><<<dim3(a.KV * slabs, a.B, (a.Sk + kOwn - 1) / kOwn), kThreads,
                        dkdv_smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.m, a.l, a.delta, a.dk, a.dv, a.qs, a.ks, a.vs, a.Sq, a.Sk, a.H,
      a.KV, a.D, a.opt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<NJ, BO><<<dim3(a.H, a.B, (a.Sq + kOwn - 1) / kOwn), kThreads, dq_smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.m, a.l, a.delta, a.dq, a.qs, a.ks, a.vs, a.Sq, a.Sk, a.H, a.KV,
      a.D, a.opt);
  return static_cast<int>(cudaGetLastError());
}


template <int DP, bool kCap>
int launch_split(const Args& a, cudaStream_t stream) {
  constexpr int kv_smem = SplitKv<DP>::kSmem, q_smem = SplitQ<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_split_kernel<DP, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_split_kernel<DP, kCap>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  prologue_kernel<<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads,
                    0, stream>>>(a.o, a.dout, a.delta, rows, a.Sq, a.H, a.D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = kSplitThreads;
  dkdv_split_kernel<DP, kCap>
      <<<dim3(a.KV, a.B, (a.Sk + kSplitKeys - 1) / kSplitKeys), threads, kv_smem, stream>>>(
          a.q, a.k, a.v, a.dout, a.m, a.l, a.delta, a.dk, a.dv, a.qs, a.ks, a.vs, a.Sq, a.Sk,
          a.H, a.KV, a.D, a.opt, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_split_kernel<DP, kCap>
      <<<dim3(a.H, a.B, (a.Sq + kSplitRows - 1) / kSplitRows), threads, q_smem, stream>>>(
          a.q, a.k, a.v, a.dout, a.m, a.l, a.delta, a.dq, a.qs, a.ks, a.vs, a.Sq, a.Sk, a.H,
          a.KV, a.D, a.opt, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_split_cap(const Args& a, cudaStream_t stream) {
  return a.opt.has_cap ? launch_split<DP, true>(a, stream) : launch_split<DP, false>(a, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launches the three kernels on `stream` without synchronizing; returns a CUDA error code
// as an int (cudaGetLastError() after each launch).  q: [B, Sq, H, D]; k, v: [B, Sk, KV, D],
// each given by its batch, sequence and head strides in elements (head_dim contiguous);
// o, dout: contiguous [B, Sq, H, D]; m, l: contiguous [B, H, Sq], the forward's row stats;
// dq: contiguous [B, Sq, H, D]; dk, dv: contiguous [B, Sk, KV, D]; delta: contiguous
// [B, H, Sq] scratch; all float32.  window <= 0 means none; has_cap = 0 means no softcap.
// The caller checks 1 <= D <= 256, H % KV == 0 and the grid's limits.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* m, const void* l, void* dq, void* dk, void* dv, void* delta, int B,
    int Sq, int Sk, int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, int window, int has_cap, float cap,
    void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.delta = static_cast<float*>(delta);
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.KV = KV, a.D = D;
  a.qs = Strides{q_sb, q_ss, q_sh};
  a.ks = Strides{k_sb, k_ss, k_sh};
  a.vs = Strides{v_sb, v_ss, v_sh};
  a.opt = Opts{scale, cap, causal, window, has_cap};
  // 16-byte raw copies: D, every stride of q, k, v (dO's are multiples of D) and the bases
  // allow them
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  a.vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  for (long long x : st) a.vec = a.vec && x % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_split_cap<32>(a, s);
  if (D <= kSplitMaxD) return launch_split_cap<64>(a, s);
  if (D <= 128) return launch_cuda_core<8, kOther>(a, s);
  return launch_cuda_core<16, kOther256>(a, s);
}

// Dynamic shared memory of the dK/dV (which = 0) or dQ (which = 1) kernel at head_dim D.
extern "C" int flash_attention_bwd_smem_bytes(int D, int which) {
  if (D <= 32) return which == 0 ? SplitKv<32>::kSmem : SplitQ<32>::kSmem;
  if (D <= kSplitMaxD) return which == 0 ? SplitKv<64>::kSmem : SplitQ<64>::kSmem;
  const int bo = D > 128 ? kOther256 : kOther;
  return 4 * (which == 0 ? dkdv_floats(D, bo) : dq_floats(D, bo));
}
