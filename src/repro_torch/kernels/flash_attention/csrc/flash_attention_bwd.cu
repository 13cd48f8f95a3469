// Attention backward for float32 on Hopper (sm_90a): the CUDA-core kernels, which
// FlashAttention.backward runs for float32 inputs.
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
// windowed calls with Sq != Sk).  GQA is folded: query head h reads KV head h / G.
//
// What bounds it on an H100.  The backward does 2.5× the forward's products at the least
// (S, dP, dV, dK, dQ against the forward's S and PV); this design recomputes S and dP in
// its second pass, 3.5× in all.  At the serving shape in float32 (B = 4, S = 2048, 32/8
// heads, D = 64, causal) that is 241 GFLOP, 3.6 ms at the CUDA cores' 67 TFLOP/s, so
// operations bound it; TF32 would miss the float32 tolerance.  This kernel is the simple,
// right scaffold of the two-pass design that the tensor-core kernel
// (flash_attention_bwd_wgmma.cu) carries to bf16; it has no speed target.  It serves the
// float32 training path (the card-vs-CPU checks), whose shapes are small.
//
// Design: three kernels on the caller's stream, no atomics, so two launches give the
// same bits.
// 1. Prologue: a warp per (batch, head, query row) writes Δ, float32 [B, H, Sq].  p is
//    formed from m and l as the forward and the plain version form it, not from one
//    log-sum-exp m + log l (the bf16 kernel's), which in fp32 would lose |m|·2⁻²⁴ of every
//    exponent: at the scores a softcap of 50 allows, more than the float32 tolerance.
// 2. dK/dV: one block of 256 threads per (KV head, batch, 64-key tile).  The block keeps
//    its K and V tiles in shared memory and walks, in a fixed order, the G query heads
//    that read its KV head and, for each, the query tiles of the key tile's band: from
//    the tile holding k0 (causal) to the one holding k0 + 63 + window − 1 (window),
//    clipped to Sq.  Each thread owns 4 keys × 4 (or 2) query columns of Sᵀ and dPᵀ (fp32
//    FMAs from shared memory, as the forward's S), writes its p and ds into shared tiles,
//    and owns 4 keys × ⌈D/16⌉ columns of dK and dV, summed in registers over all the G
//    heads and query tiles and stored once.  So GQA needs no repeat and no second sum.
//    At D > 128 a block takes one of two 128-column slabs of dK and dV (kSlabCols; the
//    grid's x axis counts KV heads × slabs), since 4 × 16 columns of both would not fit a
//    thread's 255 registers; each slab recomputes the tile's p and ds.
// 3. dQ: one block per (query head, batch, 64-row query tile); it walks the forward's
//    band of key tiles, recomputes s, p, dp and ds, and sums dQ in registers.
// Query (dK/dV) or key (dQ) tiles hold 64 rows, 32 at D > 128, so that the shared tiles
// stay within the 227 KB a block can have (kSmemBudget; the design test recomputes every
// instantiation's bytes from these constants).  Rows of the Q, K, V and dO tiles are
// padded by one float and the p / ds rows by four, which keeps the shared-memory reads
// free of bank conflicts.  Offsets come from the element strides of the [B, S, heads, D]
// inputs (head_dim contiguous), so k and v may be strided halves of one projection; O
// and dO are contiguous.  Ragged ends are masked in p and ds, not only in the stores.
//
// Rounding.  Built without --use_fast_math: expf, logf and tanhf are the accurate library
// functions.  Sums run in another order than the plain version's, so results agree with
// it to about 1e-6 of each gradient's largest magnitude, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kOwn = 64;        // rows a block owns: keys (dK/dV) or query rows (dQ)
constexpr int kOther = 64;      // rows of the tiles it walks: query rows (dK/dV) or keys (dQ)
constexpr int kOther256 = 32;   // ... at head_dim above 128
constexpr int kThreads = 256;   // 16 row groups × 16 column lanes
constexpr int kTR = 4;          // own rows per thread
constexpr int kPad = 4;         // padding of a p / ds row, in floats
constexpr int kSlabCols = 128;  // dK/dV: output columns a block at most
constexpr int kRowsPerBlock = 8;   // prologue: one row a warp
constexpr int kSmemBudget = 232448;

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence and head axes
};

struct Opts {
  float scale, cap;
  int causal, window, has_cap;
};

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

// 2. dK and dV of one 64-key tile, columns [c0, c0 + 16·NJ) of them.  NJ = output columns
// a thread (c0 + tx + 16·jj), BO = query rows a walked tile.
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

// 3. dQ of one 64-row query tile.  NJ = output columns a thread, BO = keys a walked tile.
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
};

template <int NJ, int BO>
int launch(const Args& a, cudaStream_t stream) {
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<2, kOther>(a, st);
  if (D <= 64) return launch<4, kOther>(a, st);
  if (D <= 128) return launch<8, kOther>(a, st);
  return launch<16, kOther256>(a, st);
}

// Dynamic shared memory of the dK/dV (which = 0) or dQ (which = 1) kernel at head_dim D.
extern "C" int flash_attention_bwd_smem_bytes(int D, int which) {
  const int bo = D > 128 ? kOther256 : kOther;
  return 4 * (which == 0 ? dkdv_floats(D, bo) : dq_floats(D, bo));
}
