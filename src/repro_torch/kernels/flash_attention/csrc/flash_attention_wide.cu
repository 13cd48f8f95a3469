// Online-softmax attention forward (flash attention) on Hopper (sm_90a) for head widths
// above 256, in float32 and bfloat16: the kernel the op runs when max(D, Dv) > 256 (the
// widest tile of flash_attention.cu and flash_attention_wgmma.cu is 256).
//
// Replaces the TPU kernel `_fa_kernel` in src/repro/kernels/flash_attention/kernel.py:38
// (launched by `flash_attention_fwd`, `pallas_call` at :141) at those widths: the Pallas
// kernel's blocks are (block_q, D) and (Sk, D), with no cap on D or Dv.  It computes what
// repro_torch/kernels/flash_attention/ref.py computes in one pass:
//
//   s = (q·kᵀ)·scale with fp32 sums (bf16 values are loaded and widened to fp32)
//   optional softcap      s = c·tanh(s / c)
//   mask                  keep = (!causal || qpos >= kpos) && (!window || qpos − kpos < window)
//                         masked scores become −2e38 (keys past the end get no weight)
//   per KV tile           m' = max(m, rowmax s);  p = exp(s − m');  corr = exp(m − m')
//                         l = l·corr + Σp;  acc = acc·corr + round(p)·v
//   out                   acc / max(l, 1e-30), rounded once to the input dtype
//   stats (optional)      m and l of each row, float32 [B, H, Sq]
//
// round(p) is p rounded to v's dtype (the identity in float32): the plain version and the
// JAX model's full_attention round the unnormalised probabilities before p·v, and divide
// by the fp32 sums after it.  Masks are aligned at position 0 (the op refuses causal and
// windowed calls with Sq != Sk); GQA is folded (query head h reads KV head h / G); q, k, v
// are read through their element strides (head_dim contiguous); ragged ends are masked.
//
// What bounds it on an H100.  At DeepSeek-V2's absorbed latent attention (B = 1, S = 4096,
// 16 query heads on one KV head, causal, D = 576, Dv = 512) the call keeps 134,250,496
// scores and does 2·(D + Dv) FLOPs a score, 292.1 GFLOP: 0.295 ms on the bf16 tensor cores,
// 4.36 ms on fp32 FMAs.  This kernel runs on the CUDA cores (fp32 FMAs) and recomputes the
// scores once per v slab, so it is held to neither: it is the simple design that takes
// every width, and its time is recorded beside those bounds.
//
// Design.  Shared memory must not grow with D or Dv, so no row of q, k or v is staged
// whole.  One block of 256 threads (16 row groups × 16 column lanes) per (query head, v
// slab, batch, 64-row query tile), heaviest tiles first (the z axis counts down).
//  * The slab axis: each block owns kSlab = 256 output columns (16 a thread, tx + 16·jj);
//    a Dv of 512 takes two slabs.  Every slab's block recomputes its rows' scores, so all
//    slabs see the same scores and compute the same m and l; slab 0 stores them.
//  * S = q·kᵀ is streamed over D: for each 64-key tile of the causal / window band the
//    block stages kChunk = 64 columns of its 64 query rows and of the tile's keys at a time
//    and sums each thread's 4 rows × 4 keys on fp32 FMAs.
//  * The tile's slab of v (64 keys × 256 columns, widened to fp32) is staged with the first
//    chunk; p goes through a shared [64][68] tile (a row is written and read by one
//    half-warp), and each thread sums its 4 rows × 16 columns of round(p)·v.
// Shared memory: 2 · 64 · 65 + 64 · 256 + 64 · 68 floats, 116,224 bytes at every width.
//
// Rounding.  Built without --use_fast_math: expf and tanhf are the accurate library
// functions and the output is divided by l.  Sums run in another order than the plain
// version's, so results agree with it to about 1e-6 relative in float32; in bf16 the
// output rounds once more.  Two launches give the same bits: every sum runs in a fixed
// order and nothing is atomic.

#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a KV tile
constexpr int kThreads = 256;  // 16 row groups × 16 column lanes
constexpr int kTR = 4;         // query rows a thread (ty·4 + r)
constexpr int kTC = 4;         // score columns a thread (tx + 16·c)
constexpr int kChunk = 64;     // columns of q and k staged a step of the score sum
constexpr int kNJ = 16;        // output columns a thread (tx + 16·jj)
constexpr int kSlab = 256;     // output (v) columns a block (ops.WIDE_V_SLAB)
static_assert(kSlab == 16 * kNJ, "a slab is 16 column lanes of kNJ columns");
constexpr int kLdC = kChunk + 1;  // a staged q / k row, padded by one float
constexpr int kLdP = kBK + 4;     // a p row: the two row groups of a warp on other banks
constexpr int kSmemFloats = 2 * kBQ * kLdC + kBK * kSlab + kBQ * kLdP;
constexpr int kSmemBudget = 232448;
static_assert(kSmemFloats * 4 <= kSmemBudget, "shared memory");
constexpr float kNegInf = -2.0e38f;

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out, Strides qs,
    Strides ks, Strides vs, int Sq, int Sk, int H, int G, int D, int Dv, int slabs,
    float scale, int causal, int window, int has_cap, float cap) {
  extern __shared__ float smem[];
  float* sQ = smem;               // [kBQ][kLdC]: a chunk of the query rows
  float* sK = sQ + kBQ * kLdC;    // [kBK][kLdC]: the same chunk of the tile's keys
  float* sV = sK + kBK * kLdC;    // [kBK][kSlab]: the tile's v slab
  float* sP = sV + kBK * kSlab;   // [kBQ][kLdP]

  const int h = blockIdx.x / slabs;
  const int slab = blockIdx.x % slabs;
  const int cv0 = slab * kSlab;  // the slab's first output column
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // KV tiles in the band: the last one any row of this tile sees (causal), the first
  // one inside the window of its first row.
  const int nk = (Sk + kBK - 1) / kBK;
  const int hi = causal ? min((min(q0 + kBQ, Sq) - 1) / kBK + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / kBK : 0;

  float m[kTR], l[kTR], acc[kTR][kNJ];
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) acc[r][jj] = 0.0f;
  }

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBK;
    float s[kTR][kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[r][c] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      __syncthreads();  // the last chunk's (and the last tile's p·v) reads are done
      for (int i = tid; i < kBQ * kChunk; i += kThreads) {
        const int r = i / kChunk, c = i % kChunk, d = d0 + c;
        sQ[r * kLdC + c] = q0 + r < Sq && d < D ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.0f;
        sK[r * kLdC + c] = k0 + r < Sk && d < D ? to_f32(kb[(k0 + r) * ks.s + d]) : 0.0f;
      }
      if (d0 == 0) {
        for (int i = tid; i < kBK * kSlab; i += kThreads) {
          const int r = i / kSlab, c = i % kSlab, d = cv0 + c;
          sV[i] = k0 + r < Sk && d < Dv ? to_f32(vb[(k0 + r) * vs.s + d]) : 0.0f;
        }
      }
      __syncthreads();
      const int n = min(kChunk, D - d0);
#pragma unroll 4
      for (int d = 0; d < n; ++d) {
        float qr[kTR], kc[kTC];
#pragma unroll
        for (int r = 0; r < kTR; ++r) qr[r] = sQ[(ty * kTR + r) * kLdC + d];
#pragma unroll
        for (int c = 0; c < kTC; ++c) kc[c] = sK[(tx + 16 * c) * kLdC + d];
#pragma unroll
        for (int r = 0; r < kTR; ++r)
#pragma unroll
          for (int c = 0; c < kTC; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      const int qpos = q0 + ty * kTR + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
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
        sP[(ty * kTR + r) * kLdP + tx + 16 * c] = round_to(p, o);
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) acc[r][jj] *= corr;
    }
    __syncwarp();  // a row's p is written and read by the 16 lanes of one half-warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) pr[r] = sP[(ty * kTR + r) * kLdP + kk];
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const float vv = sV[kk * kSlab + tx + 16 * jj];
#pragma unroll
        for (int r = 0; r < kTR; ++r) acc[r][jj] = fmaf(pr[r], vv, acc[r][jj]);
      }
    }
  }

  // out is a fresh contiguous [B, Sq, H, Dv] tensor
  T* ob = o + (static_cast<long long>(b) * Sq * H + h) * Dv;
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int qpos = q0 + ty * kTR + r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int d = cv0 + tx + 16 * jj;
      if (d < Dv) store(ob + static_cast<long long>(qpos) * H * Dv + d, acc[r][jj] / denom);
    }
    // the row's stats: the same in every slab and in the 16 lanes of its half-warp,
    // stored by slab 0's first lane
    if (m_out != nullptr && slab == 0 && tx == 0) {
      const long long i = (static_cast<long long>(b) * H + h) * Sq + qpos;
      m_out[i] = m[r];
      l_out[i] = l[r];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* m_out, float* l_out,
           int B, int Sq, int Sk, int H, int KV, int D, int Dv, Strides qs, Strides ks,
           Strides vs, float scale, int causal, int window, int has_cap, float cap,
           cudaStream_t stream) {
  constexpr int smem = kSmemFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slabs = (Dv + kSlab - 1) / kSlab;
  const dim3 grid(H * slabs, B, (Sq + kBQ - 1) / kBQ);
  wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m_out, l_out, qs, ks, vs, Sq, Sk, H, H / KV, D, Dv, slabs, scale,
      causal, window, has_cap, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` without synchronizing; returns a CUDA error code as an int
// (cudaGetLastError() after the launch).  q: [B, Sq, H, D]; k: [B, Sk, KV, D]; v:
// [B, Sk, KV, Dv], each given by its batch, sequence and head strides in elements
// (head_dim contiguous); o: a contiguous [B, Sq, H, Dv]; all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1).  m_out, l_out: contiguous float32 [B, H, Sq] for the row stats, or
// both null for none.  window <= 0 means none; has_cap = 0 means no softcap.  Any D,
// Dv >= 1; the caller checks H % KV == 0 and the grid's limits.
extern "C" int flash_attention_wide_launch(
    const void* q, const void* k, const void* v, void* o, void* m_out, void* l_out, int B,
    int Sq, int Sk, int H, int KV, int D, int Dv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int window, int has_cap,
    float cap, int bf16, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, mo, lo, B, Sq, Sk, H, KV, D, Dv, qs, ks, vs,
                                 scale, causal, window, has_cap, cap, st);
  return launch<float>(q, k, v, o, mo, lo, B, Sq, Sk, H, KV, D, Dv, qs, ks, vs, scale,
                       causal, window, has_cap, cap, st);
}

// Dynamic shared memory of the kernel: the same at every width.
extern "C" int flash_attention_wide_smem_bytes() { return kSmemFloats * 4; }

// Output (v) columns a block owns.
extern "C" int flash_attention_wide_slab_columns() { return kSlab; }
