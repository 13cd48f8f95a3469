// Attention backward on Hopper (sm_90a) for head widths above 256, in float32 and
// bfloat16: the kernels FlashAttention.backward runs when max(D, Dv) > 256, beside the
// forward of flash_attention_wide.cu.
//
// Replaces no Pallas kernel: the TPU kernel `_fa_kernel` (src/repro/kernels/flash_attention/
// kernel.py:38) has no VJP, and the JAX package differentiates `full_attention` at any width
// through the custom VJP `_fa_bwd` (src/repro/models/attention.py:244), XLA einsums over
// query × KV chunks.  This file computes what `_fa_bwd` computes, as
// repro_torch/kernels/flash_attention/backward.py does in plain PyTorch, from the forward's
// row stats m (natural log of the scaled scores) and l:
//
//   Δ   = rowsum(dO·O) over Dv, in fp32
//   s   = (q·kᵀ)·scale, fp32 sums of the inputs' values (bf16 widened to fp32)
//   optional softcap   t = tanh(s / c),  s = c·t    (accurate tanhf)
//   p   = exp(s − m) / max(l, 1e-30)  where kept, else 0   (keep: causal, window, ends)
//   ds  = p·(dO·vᵀ − Δ)·(1 − t²)·scale, 0 where masked
//   dq  = Σ_k round(ds)·k      dk = Σ_q round(ds)·q      dv = Σ_q round(p)·dO
//
// round(x) rounds to the inputs' dtype (the identity in float32), as the plain version and
// JAX's preferred_element_type=f32 einsums round ds and p before their products.  Masks are
// aligned at position 0 (the op refuses causal and windowed calls with Sq != Sk); GQA is
// folded (query head h reads KV head h / G; the dk, dv of a KV head sum over its G heads).
//
// What bounds it on an H100.  The backward does 2.5× the forward's products at the least
// (S, dP, dV, dK, dQ): at DeepSeek-V2's absorbed latent attention (B = 1, S = 4096, 16/1
// heads, D = 576, Dv = 512, causal) 730 GFLOP, 0.74 ms on the bf16 tensor cores and 10.9 ms
// on fp32 FMAs.  This design runs on the CUDA cores and recomputes S and dP in each of its
// output slabs, so it is held to neither: it is the simple design that takes every width.
//
// Design: three kernels on the caller's stream, no atomics, so two launches give the same
// bits.  Shared memory must not grow with D or Dv, so no row of q, k, v, dO is staged
// whole: s = q·kᵀ is streamed over D and dP = dO·vᵀ over Dv, kChunk = 64 columns at a time.
// 1. Prologue: a warp per (batch, head, query row) writes Δ, float32 [B, H, Sq].
// 2. dK/dV: one block of 256 threads per (KV head, output slab, batch, 64-key tile).  A
//    slab is kKvSlab = 128 columns of dK (over D) and the same columns of dV (over Dv); a
//    slab past one of the widths leaves that gradient's columns to the others.  The block
//    walks, for each of the G query heads of the KV head, the 64-row query tiles of the key
//    tile's band (from the tile holding k0 (causal) to the one holding k0 + 63 + window − 1,
//    clipped to Sq): it recomputes Sᵀ and dPᵀ (each thread 4 own keys × 4 query rows),
//    forms p and ds into shared [64][68] tiles, and sums its 4 keys × 8 columns of dK and
//    dV against the walked tile's q and dO slabs (64 × 128 each, staged with the first
//    chunk).  Every slab recomputes Sᵀ and dPᵀ.
// 3. dQ: one block per (query head, output slab, batch, 64-row query tile), a slab being
//    kQSlab = 256 columns of dQ: it walks the forward's band of 64-key tiles, recomputes S
//    and dP, forms ds into a shared tile and sums its 4 rows × 16 columns of dQ against the
//    tile's k slab (64 × 256, staged with the first chunk).
// Shared memory: dK/dV 134,400 bytes, dQ 116,224 bytes, at every width.
//
// Rounding.  Built without --use_fast_math: expf and tanhf are the accurate library
// functions.  Sums run in another order than the plain version's, so results agree with
// it to about 1e-6 of each gradient's largest magnitude in float32, not bit for bit.

#include "tensor_core.cuh"

namespace {

constexpr int kOwn = 64;        // rows a block owns: keys (dK/dV) or query rows (dQ)
constexpr int kOther = 64;      // rows of the tiles it walks: query rows (dK/dV) or keys (dQ)
constexpr int kThreads = 256;   // 16 row groups × 16 column lanes
constexpr int kTR = 4;          // own rows a thread (ty·4 + r)
constexpr int kTC = kOther / 16;  // walked rows a thread (tx + 16·c)
constexpr int kChunk = 64;      // columns of the operands staged a step of S and dP
constexpr int kLdC = kChunk + 1;  // a staged row, padded by one float
constexpr int kPad = 4;         // padding of a p / ds row, in floats
constexpr int kLdP = kOther + kPad;
constexpr int kKvNJ = 8;        // dK/dV: columns a thread (c0 + tx + 16·jj)
constexpr int kKvSlab = 128;   // dK/dV: columns of each a block (ops.WIDE_KV_SLAB)
constexpr int kQNJ = 16;        // dQ: columns a thread
constexpr int kQSlab = 256;     // dQ: columns a block (ops.WIDE_Q_SLAB)
static_assert(kKvSlab == 16 * kKvNJ && kQSlab == 16 * kQNJ, "16 column lanes a slab");
constexpr int kRowsPerBlock = 8;  // prologue: one row a warp
constexpr int kSmemBudget = 232448;
constexpr int kDkdvFloats = 2 * kOwn * kLdC + 2 * kOther * kKvSlab + 2 * kOwn * kLdP + 3 * kOther;
constexpr int kDqFloats = 2 * kOwn * kLdC + kOther * kQSlab + kOwn * kLdP;
static_assert(kDkdvFloats * 4 <= kSmemBudget, "dK/dV shared memory");
static_assert(kDqFloats * 4 <= kSmemBudget, "dQ shared memory");

// Rows [r0, r0 + R) × columns [c0, c0 + C) of a [.., S, .., W] operand at `base` (row
// stride `ss` elements) into a float tile of row stride `ld`: zeros past S and past W.
template <int R, int C, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* base, long long ss, int r0,
                                      int S, int c0, int W) {
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int r = i / C, c = i % C;
    dst[r * ld + c] = r0 + r < S && c0 + c < W ? to_f32(base[(r0 + r) * ss + c0 + c]) : 0.0f;
  }
}

// Adds to x[r][c] (own row ty·4 + r, walked row tx + 16·c) the products of columns
// [0, n) of the own tile `a` and the walked tile `w`, both of row stride kLdC.
__device__ __forceinline__ void chunk_products(float (&x)[kTR][kTC], const float* a,
                                               const float* w, int n, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < n; ++d) {
    float ar[kTR], wc[kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r) ar[r] = a[(ty * kTR + r) * kLdC + d];
#pragma unroll
    for (int c = 0; c < kTC; ++c) wc[c] = w[(tx + 16 * c) * kLdC + d];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) x[r][c] = fmaf(ar[r], wc[c], x[r][c]);
  }
}

// 1. Δ of each row, a warp per row: o and dout are contiguous [B, Sq, H, Dv].
template <typename T>
__global__ void __launch_bounds__(kThreads) prologue_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    long long rows, int Sq, int H, int Dv) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / Sq;
  const int qi = static_cast<int>(row % Sq);
  const long long b = bh / H, h = bh % H;
  const long long base = ((b * Sq + qi) * H + h) * Dv;
  float acc = 0.0f;
  for (int d = lane; d < Dv; d += 32) acc = fmaf(to_f32(dout[base + d]), to_f32(o[base + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// 2. dK and dV of one 64-key tile, columns [c0, c0 + kKvSlab) of each.
template <typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Strides qs,
    Strides ks, Strides vs, int Sq, int Sk, int H, int KV, int D, int Dv, int slabs,
    Opts opt) {
  extern __shared__ float smem[];
  float* sA = smem;                    // [kOwn][kLdC]: a chunk of the own K (then V) rows
  float* sB = sA + kOwn * kLdC;        // [kOther][kLdC]: the same chunk of Q (then dO)
  float* sQs = sB + kOther * kLdC;     // [kOther][kKvSlab]: the walked tile's q slab
  float* sOs = sQs + kOther * kKvSlab;  // [kOther][kKvSlab]: its dO slab
  float* sP = sOs + kOther * kKvSlab;  // [kOwn][kLdP]
  float* sS = sP + kOwn * kLdP;        // [kOwn][kLdP], ds
  float* sM = sS + kOwn * kLdP;        // [kOther] m
  float* sL = sM + kOther;             // [kOther] max(l, 1e-30)
  float* sD = sL + kOther;             // [kOther] Δ

  const int kvh = blockIdx.x / slabs;
  const int c0 = blockIdx.x % slabs * kKvSlab;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kOwn;  // the causal band's longest tiles first
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // The key tile's band of query tiles: from the one holding k0 (causal) to the one
  // holding its last key's last query in the window, clipped to Sq.
  const int q_lo = opt.causal ? k0 : 0;
  const int q_end = opt.window > 0 ? min(Sq, k0 + kOwn - 1 + opt.window) : Sq;
  const int t_lo = q_lo / kOther;
  const int t_hi = q_lo < q_end ? (q_end - 1) / kOther + 1 : t_lo;

  float accK[kTR][kKvNJ], accV[kTR][kKvNJ];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int jj = 0; jj < kKvNJ; ++jj) accK[r][jj] = accV[r][jj] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + (static_cast<long long>(b) * Sq * H + h) * Dv;
    const long long os = static_cast<long long>(H) * Dv;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kOther;
      float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
      for (int r = 0; r < kTR; ++r)
#pragma unroll
        for (int c = 0; c < kTC; ++c) s[r][c] = dp[r][c] = 0.0f;
      for (int d0 = 0; d0 < D; d0 += kChunk) {
        __syncthreads();  // the last chunk's (and the last tile's products') reads are done
        stage<kOwn, kChunk>(sA, kLdC, kb, ks.s, k0, Sk, d0, D);
        stage<kOther, kChunk>(sB, kLdC, qb, qs.s, q0, Sq, d0, D);
        if (d0 == 0) {
          stage<kOther, kKvSlab>(sQs, kKvSlab, qb, qs.s, q0, Sq, c0, D);
          stage<kOther, kKvSlab>(sOs, kKvSlab, ob, os, q0, Sq, c0, Dv);
          for (int r = tid; r < kOther; r += kThreads) {
            const bool in = q0 + r < Sq;
            sM[r] = in ? m[row0 + q0 + r] : 0.0f;
            sL[r] = in ? fmaxf(l[row0 + q0 + r], 1e-30f) : 1.0f;
            sD[r] = in ? delta[row0 + q0 + r] : 0.0f;
          }
        }
        __syncthreads();
        chunk_products(s, sA, sB, min(kChunk, D - d0), tx, ty);
      }
      for (int d0 = 0; d0 < Dv; d0 += kChunk) {
        __syncthreads();
        stage<kOwn, kChunk>(sA, kLdC, vb, vs.s, k0, Sk, d0, Dv);
        stage<kOther, kChunk>(sB, kLdC, ob, os, q0, Sq, d0, Dv);
        __syncthreads();
        chunk_products(dp, sA, sB, min(kChunk, Dv - d0), tx, ty);
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
          const float ds = keep ? p * (dp[r][c] - sD[col]) * dfac * opt.scale : 0.0f;
          sP[(ty * kTR + r) * kLdP + col] = round_to(p, dk);
          sS[(ty * kTR + r) * kLdP + col] = round_to(ds, dk);
        }
      }
      __syncwarp();  // a key row's p and ds are written and read by one half-warp

#pragma unroll 4
      for (int qq = 0; qq < kOther; ++qq) {
        float pr[kTR], sr[kTR];
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          pr[r] = sP[(ty * kTR + r) * kLdP + qq];
          sr[r] = sS[(ty * kTR + r) * kLdP + qq];
        }
#pragma unroll
        for (int jj = 0; jj < kKvNJ; ++jj) {
          const float ov = sOs[qq * kKvSlab + tx + 16 * jj];
          const float qv = sQs[qq * kKvSlab + tx + 16 * jj];
#pragma unroll
          for (int r = 0; r < kTR; ++r) {
            accV[r][jj] = fmaf(pr[r], ov, accV[r][jj]);
            accK[r][jj] = fmaf(sr[r], qv, accK[r][jj]);
          }
        }
      }
    }
  }

  // dk is a fresh contiguous [B, Sk, KV, D] tensor, dv a [B, Sk, KV, Dv] one
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int kpos = k0 + ty * kTR + r;
    if (kpos >= Sk) continue;
    const long long row = (static_cast<long long>(b) * Sk + kpos) * KV + kvh;
#pragma unroll
    for (int jj = 0; jj < kKvNJ; ++jj) {
      const int d = c0 + tx + 16 * jj;
      if (d < D) store(dk + row * D + d, accK[r][jj]);
      if (d < Dv) store(dv + row * Dv + d, accV[r][jj]);
    }
  }
}

// 3. dQ of one 64-row query tile, columns [c0, c0 + kQSlab) of it.
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
    int Sq, int Sk, int H, int KV, int D, int Dv, int slabs, Opts opt) {
  extern __shared__ float smem[];
  float* sA = smem;                  // [kOwn][kLdC]: a chunk of the own Q (then dO) rows
  float* sB = sA + kOwn * kLdC;      // [kOther][kLdC]: the same chunk of K (then V)
  float* sKs = sB + kOther * kLdC;   // [kOther][kQSlab]: the walked tile's k slab
  float* sS = sKs + kOther * kQSlab;  // [kOwn][kLdP], ds

  const int h = blockIdx.x / slabs;
  const int c0 = blockIdx.x % slabs * kQSlab;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn;  // the causal band's longest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* ob = dout + (static_cast<long long>(b) * Sq * H + h) * Dv;
  const long long os = static_cast<long long>(H) * Dv;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

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
  const int nk = (Sk + kOther - 1) / kOther;
  const int hi = opt.causal ? min((min(q0 + kOwn, Sq) - 1) / kOther + 1, nk) : nk;
  const int lo = opt.window > 0 ? max(q0 - opt.window + 1, 0) / kOther : 0;

  float acc[kTR][kQNJ];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int jj = 0; jj < kQNJ; ++jj) acc[r][jj] = 0.0f;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kOther;
    float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[r][c] = dp[r][c] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      __syncthreads();  // the last chunk's (and the last tile's products') reads are done
      stage<kOwn, kChunk>(sA, kLdC, qb, qs.s, q0, Sq, d0, D);
      stage<kOther, kChunk>(sB, kLdC, kb, ks.s, k0, Sk, d0, D);
      if (d0 == 0) stage<kOther, kQSlab>(sKs, kQSlab, kb, ks.s, k0, Sk, c0, D);
      __syncthreads();
      chunk_products(s, sA, sB, min(kChunk, D - d0), tx, ty);
    }
    for (int d0 = 0; d0 < Dv; d0 += kChunk) {
      __syncthreads();
      stage<kOwn, kChunk>(sA, kLdC, ob, os, q0, Sq, d0, Dv);
      stage<kOther, kChunk>(sB, kLdC, vb, vs.s, k0, Sk, d0, Dv);
      __syncthreads();
      chunk_products(dp, sA, sB, min(kChunk, Dv - d0), tx, ty);
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
        const float ds = keep ? p * (dp[r][c] - rd[r]) * dfac * opt.scale : 0.0f;
        sS[(ty * kTR + r) * kLdP + col] = round_to(ds, dq);
      }
    }
    __syncwarp();  // a query row's ds is written and read by one half-warp

#pragma unroll 4
    for (int kk = 0; kk < kOther; ++kk) {
      float sr[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) sr[r] = sS[(ty * kTR + r) * kLdP + kk];
#pragma unroll
      for (int jj = 0; jj < kQNJ; ++jj) {
        const float kv = sKs[kk * kQSlab + tx + 16 * jj];
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
    for (int jj = 0; jj < kQNJ; ++jj) {
      const int d = c0 + tx + 16 * jj;
      if (d < D) store(dq + base + d, acc[r][jj]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *m, *l;
  void *dq, *dk, *dv;
  float* delta;
  int B, Sq, Sk, H, KV, D, Dv;
  Strides qs, ks, vs;
  Opts opt;
};

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int dkdv_smem = kDkdvFloats * 4, dq_smem = kDqFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  prologue_kernel<T><<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                       kThreads, 0, stream>>>(static_cast<const T*>(a.o), dout, a.delta, rows,
                                              a.Sq, a.H, a.Dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_slabs = ((a.D > a.Dv ? a.D : a.Dv) + kKvSlab - 1) / kKvSlab;
  dkdv_kernel<T><<<dim3(a.KV * kv_slabs, a.B, (a.Sk + kOwn - 1) / kOwn), kThreads, dkdv_smem,
                   stream>>>(q, k, v, dout, a.m, a.l, a.delta, static_cast<T*>(a.dk),
                             static_cast<T*>(a.dv), a.qs, a.ks, a.vs, a.Sq, a.Sk, a.H, a.KV,
                             a.D, a.Dv, kv_slabs, a.opt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_slabs = (a.D + kQSlab - 1) / kQSlab;
  dq_kernel<T><<<dim3(a.H * q_slabs, a.B, (a.Sq + kOwn - 1) / kOwn), kThreads, dq_smem,
                 stream>>>(q, k, v, dout, a.m, a.l, a.delta, static_cast<T*>(a.dq), a.qs,
                           a.ks, a.vs, a.Sq, a.Sk, a.H, a.KV, a.D, a.Dv, q_slabs, a.opt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels on `stream` without synchronizing; returns a CUDA error code
// as an int (cudaGetLastError() after each launch).  q: [B, Sq, H, D]; k: [B, Sk, KV, D];
// v: [B, Sk, KV, Dv], each given by its batch, sequence and head strides in elements
// (head_dim contiguous); o, dout: contiguous [B, Sq, H, Dv]; m, l: contiguous float32
// [B, H, Sq], the forward's row stats; dq: contiguous [B, Sq, H, D]; dk: contiguous
// [B, Sk, KV, D]; dv: contiguous [B, Sk, KV, Dv]; delta: contiguous float32 [B, H, Sq]
// scratch.  q, k, v, o, dout and the gradients are all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1).  window <= 0 means none; has_cap = 0 means no softcap.  Any D, Dv >= 1; the
// caller checks H % KV == 0 and the grid's limits.
extern "C" int flash_attention_wide_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* m, const void* l, void* dq, void* dk, void* dv, void* delta, int B, int Sq,
    int Sk, int H, int KV, int D, int Dv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, int window, int has_cap, float cap, int bf16,
    void* stream) {
  Args a;
  a.q = q, a.k = k, a.v = v, a.o = o, a.dout = dout;
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.delta = static_cast<float*>(delta);
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.KV = KV, a.D = D, a.Dv = Dv;
  a.qs = Strides{q_sb, q_ss, q_sh};
  a.ks = Strides{k_sb, k_ss, k_sh};
  a.vs = Strides{v_sb, v_ss, v_sh};
  a.opt = Opts{scale, cap, causal, window, has_cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

// Dynamic shared memory of the dK/dV (which = 0) or dQ (which = 1) kernel: the same at
// every width.
extern "C" int flash_attention_wide_bwd_smem_bytes(int which) {
  return 4 * (which == 0 ? kDkdvFloats : kDqFloats);
}
