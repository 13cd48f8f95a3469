// Online-softmax attention forward (flash attention), for Hopper (sm_90a): the CUDA-core
// kernel, which the op runs for float32 inputs.
//
// Replaces the TPU kernel `_fa_kernel` in src/repro/kernels/flash_attention/kernel.py:38
// (launched by `flash_attention_fwd`, `pallas_call` at :141) for float32; bfloat16 inputs
// go to the tensor-core kernel in flash_attention_wgmma.cu (ops.route).  It computes what
// the TPU kernel computes, which repro_torch/kernels/flash_attention/ref.py computes in
// one pass:
//
//   q is scaled first:      s = (q·scale)·kᵀ   in fp32
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
// right.
//
// Design.  One block of 256 threads per (query head, batch, 64-row query tile).  GQA is
// folded: query head h reads KV head h / G straight from the un-repeated k, v.  The block
// stages its Q tile (pre-scaled, fp32) in shared memory once, then walks 64-row KV tiles
// from `lo` to `hi`, skipping the tiles wholly outside the causal / sliding-window band as
// the Pallas kernel's fori_loop bounds do.  Each thread owns 4 query rows × 4 score
// columns (S = QKᵀ by fp32 FMAs from shared memory) and the same 4 rows × ⌈D/16⌉ output
// columns; a row's 64 scores live in the 16 lanes of one half-warp, so the row max and
// row sum are 4-step xor shuffles and the P tile is shared through shared memory with a
// __syncwarp only.  Offsets come from the element strides of the [B, S, heads, D] inputs
// (head_dim contiguous); there are no transposes and no lane padding.  Ragged sequence
// ends are masked, so any S works, and D ≤ 256.  Rows of the Q and K tiles are padded by
// one float and P rows by four, which keeps the shared-memory reads free of bank
// conflicts.  Shared memory is 66 KB at D = 64, 114 KB at D = 128 and 214.5 KB at
// D = 256 (one block an SM), above the 48 KB default, so the launch opts in with
// cudaFuncSetAttribute.  Query tiles run heaviest
// first (the z axis counts down) so the causal triangle's long tiles do not trail.
//
// What bounds it on an H100.  At the serving shape in float32 (B = 4, S = 2048, 32 query
// heads, 8 KV heads, D = 64, causal) it moves about 168 MB (q, k, v and out once: 50 µs
// at 3.35 TB/s) and does about 69 GFLOP (4·B·H·D·S(S+1)/2), which the fp32 CUDA cores
// (67 TFLOP/s) need 1.03 ms for, so operations bound it.  The tensor cores would take
// TF32 at best, about three decimal digits, which misses the fp32 tolerance (2e-5), so
// float32 stays on FMAs.  The design keeps the products in registers from shared memory;
// it is further held back by shared-memory bandwidth (two shared loads per FMA pair), by
// K/V loads that do not overlap the arithmetic, and by the accurate expf and tanhf.
// PERF.md has the measured times.
//
// Rounding.  Built without --use_fast_math: expf and tanhf are the accurate library
// functions, and the output is divided by l, not multiplied by its reciprocal.  The sums
// over head_dim and over keys run in another order than XLA's dot, so results agree with
// the plain version to about 1e-6 relative in fp32, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 row groups × 16 column lanes
constexpr int kTR = 4;         // query rows per thread
constexpr int kTC = 4;         // score columns per thread (tx, tx+16, tx+32, tx+48)
constexpr int kLdP = kBK + 4;  // P row stride: the two row groups of a warp on other banks
constexpr float kNegInf = -2.0e38f;

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence and head axes
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__host__ __device__ constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(kBQ) * (d + 1) + static_cast<size_t>(kBK) * (d + 1) +
         static_cast<size_t>(kBK) * d + static_cast<size_t>(kBQ) * kLdP;
}

// NJ = output columns per thread (tx + 16·jj for jj < NJ): 2, 4, 8 or 16 for D ≤ 32, 64,
// 128, 256.
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
int launch(const void* q, const void* k, const void* v, void* o, float* m_out, float* l_out,
           int B, int Sq, int Sk, int H, int KV, int D, Strides qs, Strides ks, Strides vs,
           float scale, int causal, int window, int has_cap, float cap, cudaStream_t stream) {
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

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* m_out,
             float* l_out, int B, int Sq, int Sk, int H, int KV, int D, Strides qs,
             Strides ks, Strides vs, float scale, int causal, int window, int has_cap,
             float cap, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 2>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D, qs, ks, vs, scale,
                        causal, window, has_cap, cap, stream);
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D, qs, ks, vs, scale,
                        causal, window, has_cap, cap, stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D, qs, ks, vs, scale,
                        causal, window, has_cap, cap, stream);
  return launch<T, 16>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D, qs, ks, vs, scale,
                       causal, window, has_cap, cap, stream);
}

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
  return launch_d<float>(q, k, v, o, static_cast<float*>(m_out), static_cast<float*>(l_out),
                         B, Sq, Sk, H, KV, D, qs, ks, vs, scale, causal, window, has_cap,
                         cap, st);
}
