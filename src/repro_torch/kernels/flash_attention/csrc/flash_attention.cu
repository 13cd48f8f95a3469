// Online-softmax attention forward (flash attention) for float32 on Hopper (sm_90a): the
// kernel the op runs for float32 inputs.  Its products run on the tensor cores as split
// TF32 up to head_dim kSplitMaxD (128), and as fp32 FMAs on the CUDA cores above it.
//
// Replaces the TPU kernel `_fa_kernel` in src/repro/kernels/flash_attention/kernel.py:38
// (launched by `flash_attention_fwd`, `pallas_call` at :141) for float32; bfloat16 inputs
// go to flash_attention_wgmma.cu (ops.route).  It computes what the TPU kernel computes,
// which repro_torch/kernels/flash_attention/ref.py computes in one pass:
//
//   q is scaled first:      s = (q·scale)·kᵀ   with fp32 sums
//   optional softcap        s = c·tanh(s / c)
//   mask                    keep = (!causal || qpos >= kpos) && (!window || qpos − kpos < window)
//                           masked scores become −2e38 (keys past the end get no weight)
//   per KV tile             m' = max(m, rowmax s);  p = exp(s − m');  corr = exp(m − m')
//                           l = l·corr + Σp;  acc = acc·corr + p·v   (p stays fp32)
//   out                     acc / max(l, 1e-30).
//   stats (optional)        m and l of each row, float32 [B, H, Sq], in the natural-log
//                           domain of the scaled scores: what the attention backward needs.
//
// The causal mask is aligned at position 0 of both sequences, as in the Pallas kernel;
// the op refuses causal calls with Sq != Sk, where the plain version aligns it on the
// right.  GQA is folded: query head h reads KV head h / G straight from the un-repeated
// k, v.  Offsets come from the element strides of the [B, S, heads, D] inputs (head_dim
// contiguous), so k and v may be the strided halves of one projection; ragged ends are
// masked, so any S works.
//
// What bounds it on an H100.  At llama3.2-1b's shape in float32 (B = 4, S = 2048, 32 query
// heads, 8 KV heads, D = 64, causal) it moves about 168 MB (q, k, v and out once: 50 µs at
// 3.35 TB/s) and does about 69 GFLOP (4·B·H·D·S(S+1)/2).  On fp32 FMAs (67 TFLOP/s) that
// is 1.03 ms.  One TF32 pass on the tensor cores (494.7 TFLOP/s) keeps 10 mantissa bits, a
// relative error near 5e-4, far outside the float32 tolerance (2e-5).  Split TF32 keeps
// float32's accuracy (tensor_core.cuh): each operand x = hi + lo, each product three TF32
// products lo·hi + hi·lo + hi·hi with fp32 sums, so 3 × 69 GFLOP at 494.7 TFLOP/s: 0.42 ms,
// the bound this kernel is held to.  Beside the products it pays the splits (two cvt.rna
// and a subtraction per operand element, K and V once per block and tile, P per score),
// one accurate expf per score (and a tanhf under the softcap), and the loads.
//
// Design (D ≤ kSplitMaxD).  D is zero-padded to DP = 32, 64 or 128 inside the kernel (the
// width of a 128-byte swizzled box row is 32 floats).  One block per (query head, batch,
// query tile), heaviest tiles first (the z axis counts down): at DP ≤ 64 two consumer
// warpgroups of 64 query rows and 64-key KV tiles, at DP = 128 one consumer warpgroup and
// 32-key tiles (kFwdRows*, kFwdKeys*), and one producer warpgroup.
//  * Each consumer warpgroup loads its 64 query rows once, scales them, splits them into a
//    hi and a lo tile (K-major, 128-byte swizzle) and keeps them for the whole walk.
//  * The producer walks the KV tiles of the block's causal / window band [lo, hi): its 128
//    threads copy the raw fp32 K and V tile by cp.async (16 bytes a copy where D, the
//    strides and the bases allow it, else 4; zero-filled past Sk and past D) into one raw
//    buffer, then split it into a ring of kSplitStages stages: K as hi / lo tiles [keys][DP]
//    (RowSplit) and V transposed, as hi / lo tiles [DP][keys] (ColSplit; TF32 wgmma
//    operands must be K-major: only 16-bit types have the transpose bits), each tile's
//    loads all issued before its first split.  A stage's full barrier counts the 128
//    producer threads (each fences its writes into the async proxy first); its empty
//    barrier one arrival per consumer warp.  The copy of tile j + 1 is in flight while
//    the consumers work on tiles j and j − 1.  At DP ≤ 64 the producer gives the consumers
//    registers with setmaxnreg (kProducerRegs, kConsumerRegs).
//  * S = Q·Kᵀ: wgmma m64nBKk8 TF32 from shared memory, the 2·DP/8 small products first,
//    then the DP/8 hi·hi ones, all into one fp32 accumulator (split_ss).
//  * Softmax in registers on the accumulator, each row held by the four threads of a quad
//    (max by two xor shuffles, l summed per thread and reduced once at the end), expf.
//  * O += P·V: wgmma m64nDPk8 with A = P from registers: the S fragment's columns 2t,
//    2t + 1 serve as the TF32 A fragment's k columns t, t + 4, and V's transposed tile holds
//    its keys in that order (ColSplit), so P is split in place (split_frag) and never goes
//    through shared memory.  Small products first again.
// Shared memory at DP = 64: Q 64 KB, two stages of 64 KB, the raw K and V 32 KB: 224 KB of
// the 227 KB a block can have (kSmemBudget); the same at DP = 128, 112 KB at DP = 32.
//
// Head_dims above kSplitMaxD (gemma2's 256) keep the CUDA-core design below, by a fixed
// route: 64 query rows' split Q alone take 128 KB there, and with two split stages of even
// 16 keys (2 × 64 KB) and their raw tiles the block would need 288 KB.  The arithmetic
// would not hold there either: the CPU model of the split products puts gemma2's softcap
// cases (scores far past the cap, q × 40) 2.65e-5 and 3.16e-5 from the plain version,
// past the 2e-5 that phase 5 of chip_smoke.py holds the kernel to.  That design
// stages 64-row tiles in shared memory and keeps 4 query rows × 4 score columns and
// 4 rows × 16 output columns a thread, all on fp32 FMAs.
//
// Rounding.  Built without --use_fast_math: expf and tanhf are the accurate library
// functions, and the output is divided by l, not multiplied by its reciprocal.  The split
// products sum in the tensor cores' order, so results agree with the plain version to
// about 1e-6 relative, not bit for bit (tests/test_torch_flash_fp32_split.py models the
// arithmetic on the CPU).  Two launches give the same bits: every sum runs in a fixed
// order and nothing is atomic.

#include "tensor_core.cuh"

namespace {

constexpr int kSplitMaxD = 128;   // head_dims up to this take the split-TF32 kernel
constexpr int kFwdRows64 = 128;   // query rows a block at DP <= 64: two consumer warpgroups
constexpr int kFwdRows128 = 64;   // ... at DP = 128: one
constexpr int kFwdKeys64 = 64;    // keys a KV tile at DP <= 64
constexpr int kFwdKeys128 = 32;   // ... at DP = 128
constexpr int kSplitStages = 2;   // stages of the split K / Vᵀ ring
// Registers a thread after setmaxnreg at DP <= 64 (384 threads, 168 each at launch).  The
// consumers can only take what the producer gives up: a larger sum never completes.
constexpr int kProducerRegs = 104;
constexpr int kConsumerRegs = 200;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 384 * 168, "register pool");
constexpr int kSmemBudget = 232448;
// The CUDA-core kernel's tiles (head_dim above kSplitMaxD).
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 row groups × 16 column lanes
constexpr int kTR = 4;         // query rows per thread
constexpr int kTC = 4;         // score columns per thread (tx, tx+16, tx+32, tx+48)
constexpr int kLdP = kBK + 4;  // P row stride: the two row groups of a warp on other banks
constexpr float kNegInf = -2.0e38f;

// Shared-memory geometry of the split-TF32 kernel at padded head_dim DP.
template <int DP>
struct Split {
  static constexpr int kRows = DP == 128 ? kFwdRows128 : kFwdRows64;  // query rows a block
  static constexpr int kBK = DP == 128 ? kFwdKeys128 : kFwdKeys64;    // keys a KV tile
  static constexpr int kWG = kRows / 64;                               // consumer warpgroups
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
  static constexpr int kQ = 64 * DP * 4;             // bytes of a warpgroup's Q hi (or lo)
  static constexpr int kKV = kBK * DP * 4;           // bytes of a K or Vᵀ hi (or lo) tile
  static constexpr int kStage = 4 * kKV;             // K hi, K lo, Vᵀ hi, Vᵀ lo
  static constexpr int kRaw = kBK * DP * 4;          // a raw K or V tile
  // Q, the ring, the raw K and V, 2·kSplitStages mbarriers, slack to align the base to 1024
  static constexpr int kSmem = kWG * 2 * kQ + kSplitStages * kStage + 2 * kRaw + 64 + 1024;
  static_assert(kSmem <= kSmemBudget, "shared memory");
};

// The split-TF32 forward.  kCap: softcap.  vec: the raw copies may be 16 bytes (D % 4 == 0,
// the sequence strides and the bases 16-byte aligned).
template <int DP, bool kCap>
__global__ void __launch_bounds__(Split<DP>::kThreads, 1) split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out, Strides qs,
    Strides ks, Strides vs, int Sq, int Sk, int H, int G, int D, float scale, int causal,
    int window, float cap, int vec) {
  using T = Split<DP>;
  constexpr int BK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [wg][hi, lo]
  const uint32_t sRing = sQ + T::kWG * 2 * T::kQ;
  const uint32_t sRawK = sRing + kSplitStages * T::kStage;
  const uint32_t sRawV = sRawK + T::kRaw;
  const uint32_t bars = sRawV + T::kRaw;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kSplitStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kRows;
  const int kvh = h / G;
  // KV tiles in the band: the last one any row of this tile sees (causal), the first
  // one inside the window of its first row.
  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min((min(q0 + T::kRows, Sq) - 1) / BK + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  auto stage = [&](int j) { return (j - lo) % kSplitStages; };
  auto parity = [&](int j) { return static_cast<uint32_t>(((j - lo) / kSplitStages) & 1); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(full(s), 128);                  // every producer thread
      mbar_init(empty(s), T::kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::kConsumers) {
    // Producer warpgroup: raw copies of tile j + 1 in flight while tile j is split.  With
    // two consumer warpgroups it gives them registers (the launch bound's 168 a thread
    // would make the softcap's instantiation spill).
    if constexpr (T::kWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int t = threadIdx.x - T::kConsumers;
    const float* kb = k + b * ks.b + kvh * ks.h;
    const float* vb = v + b * vs.b + kvh * vs.h;
    auto copy_raw = [&](int j) {
      const int k0 = j * BK;
      if (vec) {
        for (int i = t; i < BK * DP / 4; i += 128) {
          const int r = i / (DP / 4), c = i % (DP / 4) * 4;
          const bool in = k0 + r < Sk && c < D;
          const long long row = in ? k0 + r : 0;
          cp_async16(sRawK + (r * DP + c) * 4, kb + row * ks.s + (in ? c : 0), in);
          cp_async16(sRawV + (r * DP + c) * 4, vb + row * vs.s + (in ? c : 0), in);
        }
      } else {
        for (int i = t; i < BK * DP; i += 128) {
          const int r = i / DP, c = i % DP;
          const bool in = k0 + r < Sk && c < D;
          const long long row = in ? k0 + r : 0;
          cp_async4(sRawK + (r * DP + c) * 4, kb + row * ks.s + (in ? c : 0), in);
          cp_async4(sRawV + (r * DP + c) * 4, vb + row * vs.s + (in ? c : 0), in);
        }
      }
      cp_async_commit();
    };
    if (lo < hi) copy_raw(lo);
    for (int j = lo; j < hi; ++j) {
      const int s = stage(j);
      cp_async_wait<0>();
      bar_sync(3, 128);  // tile j's raw copies of every producer thread have landed
      mbar_wait(empty(s), parity(j) ^ 1);  // the first round passes at once
      const uint32_t st = sRing + s * T::kStage;
      {  // K, then V: one tile's loads in flight at a time fits the producer's registers
        RowSplit<BK, DP, 128> x;
        x.load(sm, sRawK, t);
        x.store(sm, st, st + T::kKV, t);
      }
      {
        ColSplit<BK, DP, 128> x;
        x.load(sm, sRawV, t);
        x.store(sm, st + 2 * T::kKV, st + 3 * T::kKV, t);
      }
      fence_proxy_async();
      mbar_arrive(full(s));
      bar_sync(3, 128);  // every thread is done reading the raw tiles
      if (j + 1 < hi) copy_raw(j + 1);
    }
    return;
  }

  // Consumer warpgroup `wg` owns query rows [qa, qa + 64).  A thread holds rows r_lo and
  // r_lo + 8 and columns 8·g + c_th + {0, 1} of each 8-column group g of a fragment.
  if constexpr (T::kWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int qa = q0 + 64 * wg;
  const int r_lo = 16 * (t128 / 32) + lane / 4;
  const int c_th = 2 * (lane % 4);
  const uint32_t q_hi = sQ + wg * 2 * T::kQ, q_lo = q_hi + T::kQ;
  {
    const float* qb = q + b * qs.b + h * qs.h;
    for (int i = t128; i < 64 * DP / 4; i += 128) {
      const int ch = i % 8, r = i / 8 % 64, box = i / (8 * 64);
      const int c = box * 32 + ch * 4;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (qa + r < Sq) {
        const float* src = qb + (qa + r) * qs.s;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < D) x[u] = src[c + u] * scale;
      }
      const uint32_t off = box * 64 * 128 + swizzle128(r, ch);
      st_split4(sm, q_hi + off, q_lo + off, make_float4(x[0], x[1], x[2], x[3]));
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
  }
  // This warpgroup's own band inside [lo, hi): a tile outside it no row here can see,
  // so it is only waited for and released.
  const int lo_w = max(lo, window > 0 ? max(qa - window + 1, 0) / BK : 0);
  const int hi_w = min(hi, causal ? (min(qa + 64, Sq) - 1) / BK + 1 : nk);

  float m[2] = {kNegInf, kNegInf};  // running row max
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
  float s[BK / 2];
  uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];

  for (int j = lo; j < hi; ++j) {
    const int st = stage(j);
    mbar_wait(full(st), parity(j));
    __syncwarp();  // the .aligned wgmma instructions need the warp converged
    if (j >= lo_w && j < hi_w && qa < Sq) {
      const uint32_t tile = sRing + st * T::kStage;
      fence_regs(s);
      wgmma_fence();
      split_ss<BK, DP>(s, q_hi, q_lo, tile, tile + T::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const int k0 = j * BK;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int qpos = qa + r_lo + 8 * ((e >> 1) & 1);
        const int kpos = k0 + 8 * (e >> 2) + c_th + (e & 1);
        float x = s[e];
        if constexpr (kCap) x = cap * tanhf(x / cap);
        const bool keep = (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
        x = kpos >= Sk ? -INFINITY : keep ? x : kNegInf;
        s[e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
      }
      float corr[2], m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = mx[r];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        m_new[r] = fmaxf(m[r], x);
        corr[r] = expf(m[r] - m_new[r]);
        m[r] = m_new[r];
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const float pe = expf(s[e] - m_new[(e >> 1) & 1]);
        s[e] = pe;
        sum[(e >> 1) & 1] += pe;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
      split_frag<BK / 8>(p_hi, p_lo, s);
      fence_regs(acc);
      wgmma_fence();
      split_rs<DP, BK / 8>(acc, p_hi, p_lo, tile + 2 * T::kKV, tile + 3 * T::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // out is a fresh contiguous [B, Sq, H, D] tensor
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + r_lo + 8 * r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* row = o + (static_cast<long long>(b) * Sq + qpos) * H * D +
                 static_cast<long long>(h) * D;
#pragma unroll
    for (int g = 0; g < DP / 8; ++g) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 8 * g + c_th + u;
        if (col < D) row[col] = acc[4 * g + 2 * r + u] / denom;
      }
    }
    // the row's stats: the same in the four threads of its quad, stored by the first
    if (m_out != nullptr && c_th == 0) {
      const long long i = (static_cast<long long>(b) * H + h) * Sq + qpos;
      m_out[i] = m[r];
      l_out[i] = l[r];
    }
  }
}

template <int DP, bool kCap>
int launch_split(const float* q, const float* k, const float* v, float* o, float* m_out,
                 float* l_out, int B, int Sq, int Sk, int H, int KV, int D, Strides qs,
                 Strides ks, Strides vs, float scale, int causal, int window, float cap,
                 int vec, cudaStream_t stream) {
  using T = Split<DP>;
  cudaError_t err = cudaFuncSetAttribute(split_kernel<DP, kCap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + T::kRows - 1) / T::kRows);
  split_kernel<DP, kCap><<<grid, T::kThreads, T::kSmem, stream>>>(
      q, k, v, o, m_out, l_out, qs, ks, vs, Sq, Sk, H, H / KV, D, scale, causal, window, cap,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_split_cap(const float* q, const float* k, const float* v, float* o, float* m_out,
                     float* l_out, int B, int Sq, int Sk, int H, int KV, int D, Strides qs,
                     Strides ks, Strides vs, float scale, int causal, int window, int has_cap,
                     float cap, int vec, cudaStream_t stream) {
  if (has_cap)
    return launch_split<DP, true>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D, qs, ks, vs,
                                  scale, causal, window, cap, vec, stream);
  return launch_split<DP, false>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D, qs, ks, vs,
                                 scale, causal, window, cap, vec, stream);
}

__host__ __device__ constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(kBQ) * (d + 1) + static_cast<size_t>(kBK) * (d + 1) +
         static_cast<size_t>(kBK) * d + static_cast<size_t>(kBQ) * kLdP;
}

// The CUDA-core kernel of head_dims above kSplitMaxD.  NJ = output columns per thread
// (tx + 16·jj for jj < NJ): 16, for D ≤ 256.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out, Strides qs,
    Strides ks, Strides vs, int Sq, int Sk, int H, int G, int D, float scale, int causal,
    int window, int has_cap, float cap) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;              // [kBQ][ld]
  float* sK = sQ + kBQ * ld;     // [kBK][ld]
  float* sV = sK + kBK * ld;     // [kBK][D]
  float* sP = sV + kBK * D;      // [kBQ][kLdP]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.0f;
    if (q0 + r < Sq) x = to_f32(qb[(q0 + r) * qs.s + d]) * scale;
    sQ[r * ld + d] = x;
  }

  // KV tiles in the band: the last one any row of this tile sees (causal), the first
  // one inside the window of its first row.
  const int nk = (Sk + kBK - 1) / kBK;
  const int hi = causal ? min((min(q0 + kBQ, Sq) - 1) / kBK + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / kBK : 0;

  float m[kTR], l[kTR], acc[kTR][NJ];
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[r][jj] = 0.0f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the Q tile is written; the last tile's K, V, P reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + c < Sk) {
        kx = to_f32(kb[(k0 + c) * ks.s + d]);
        vx = to_f32(vb[(k0 + c) * vs.s + d]);
      }
      sK[c * ld + d] = kx;
      sV[c * D + d] = vx;
    }
    __syncthreads();

    float s[kTR][kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[kTR], kc[kTC];
#pragma unroll
      for (int r = 0; r < kTR; ++r) qr[r] = sQ[(ty * kTR + r) * ld + d];
#pragma unroll
      for (int c = 0; c < kTC; ++c) kc[c] = sK[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int r = 0; r < kTR; ++r)
#pragma unroll
        for (int c = 0; c < kTC; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int qpos = q0 + ty * kTR + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = s[r][c];
        if (has_cap) x = cap * tanhf(x / cap);
        bool keep = true;
        if (causal) keep = qpos >= kpos;
        if (window > 0) keep = keep && (qpos - kpos) < window;
        x = keep ? x : kNegInf;
        if (kpos >= Sk) x = -INFINITY;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const float p = expf(s[r][c] - m_new);
        sP[(ty * kTR + r) * kLdP + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[r][jj] *= corr;
    }
    __syncwarp();  // a row's P is written and read by the 16 lanes of one half-warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) pr[r] = sP[(ty * kTR + r) * kLdP + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx + 16 * jj;
        const float vv = d < D ? sV[kk * D + d] : 0.0f;
#pragma unroll
        for (int r = 0; r < kTR; ++r) acc[r][jj] = fmaf(pr[r], vv, acc[r][jj]);
      }
    }
  }

  // out is a fresh contiguous [B, Sq, H, D] tensor
  T* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int qpos = q0 + ty * kTR + r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) store(ob + static_cast<long long>(qpos) * H * D + d, acc[r][jj] / denom);
    }
    // the row's stats: the same in the 16 lanes of its half-warp, stored by the first
    if (m_out != nullptr && tx == 0) {
      const long long i = (static_cast<long long>(b) * H + h) * Sq + qpos;
      m_out[i] = m[r];
      l_out[i] = l[r];
    }
  }
}

template <typename T, int NJ>
int launch_cuda_core(const void* q, const void* k, const void* v, void* o, float* m_out,
                     float* l_out, int B, int Sq, int Sk, int H, int KV, int D, Strides qs,
                     Strides ks, Strides vs, float scale, int causal, int window, int has_cap,
                     float cap, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m_out, l_out, qs, ks, vs, Sq, Sk, H, H / KV, D, scale, causal,
      window, has_cap, cap);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launches on `stream` without synchronizing; returns a CUDA error code as an int
// (cudaGetLastError() after the launch).  q: [B, Sq, H, D]; k, v: [B, Sk, KV, D], each
// given by its batch, sequence and head strides in elements (head_dim contiguous);
// o: a contiguous [B, Sq, H, D]; all float32.  m_out, l_out: contiguous float32 [B, H, Sq]
// for the row stats, or both null for none.  window <= 0 means none; has_cap = 0 means no
// softcap.  The caller checks D <= 256 and H % KV == 0.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* m_out, void* l_out, int B,
    int Sq, int Sk, int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int window, int has_cap, float cap, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  if (D > kSplitMaxD)
    return launch_cuda_core<float, 16>(q, k, v, o, mo, lo, B, Sq, Sk, H, KV, D, qs, ks, vs,
                                       scale, causal, window, has_cap, cap, st);
  // 16-byte raw copies of k and v rows: D, the row strides and the bases allow them (the
  // batch and head strides are multiples of the row's alignment when they are of 4)
  const int vec = D % 4 == 0 && k_ss % 4 == 0 && v_ss % 4 == 0 && k_sb % 4 == 0 &&
                  k_sh % 4 == 0 && v_sb % 4 == 0 && v_sh % 4 == 0 && aligned16(k) &&
                  aligned16(v);
  if (D <= 32)
    return launch_split_cap<32>(qf, kf, vf, of, mo, lo, B, Sq, Sk, H, KV, D, qs, ks, vs, scale,
                                causal, window, has_cap, cap, vec, st);
  if (D <= 64)
    return launch_split_cap<64>(qf, kf, vf, of, mo, lo, B, Sq, Sk, H, KV, D, qs, ks, vs, scale,
                                causal, window, has_cap, cap, vec, st);
  return launch_split_cap<128>(qf, kf, vf, of, mo, lo, B, Sq, Sk, H, KV, D, qs, ks, vs, scale,
                               causal, window, has_cap, cap, vec, st);
}

// Dynamic shared memory of the kernel that takes head_dim D.
extern "C" int flash_attention_smem_bytes(int D) {
  if (D > kSplitMaxD) return static_cast<int>(smem_floats(D) * sizeof(float));
  return D <= 32 ? Split<32>::kSmem : D <= 64 ? Split<64>::kSmem : Split<128>::kSmem;
}
