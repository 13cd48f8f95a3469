// Backward of the Mamba-1 selective scan, for Hopper (sm_90a).
//
// The TPU kernel `_scan_kernel` (src/repro/kernels/ssm_scan/kernel.py) has no backward:
// the JAX package trains by differentiating its XLA chunked scan.  This kernel is the
// backward of csrc/selective_scan.cu, new work, held on the card against the plain
// version in repro_torch/kernels/ssm_scan/backward.py.  With a_t = exp(δ_t·A),
// A = −exp(A_log), u_t = δ_t·x_t, and g_t = ∂L/∂h_t, per channel (batch row, d) and state n:
//
//   g_S = dy_S·C_S + dh_final;   g_t = dy_t·C_t + a_{t+1}·g_{t+1}
//   dx_t[d]   = δ_t[d]·Σ_n g_t[d,n]·B_t[n]
//   dδ_t[d]   = Σ_n g_t[d,n]·(A[d,n]·a_t[d,n]·h_{t−1}[d,n] + x_t[d]·B_t[n])
//   dB_t[n]   = Σ_d g_t[d,n]·u_t[d]                 (over the D channels of the row)
//   dC_t[n]   = Σ_d dy_t[d]·h_t[d,n]
//   dA_log[d,n] = A[d,n]·Σ_{b,t} g_t·δ_t·a_t·h_{t−1}
//
// All tensors are fp32 and contiguous: δ, x, dy [b, S, D]; B, C [b, S, N]; A_log [D, N];
// dh_final [b, D, N] or null; the forward's chunk-boundary states [b, ⌈S/kChunk⌉, D, N]
// (h at the end of every kChunk-step chunk, written by selective_scan.cu with the same
// kChunk).  Any S ≥ 1, D ≥ 1 and 1 ≤ N ≤ 16.
//
// What bounds it on an H100.  At the serving shape (b = 4, S = 2048, D = 8192, N = 16)
// the walk back needs a_t once per (b, t, d, n), and the states h_t, which only the
// chunk boundaries keep, once more: 2 × 1.07 G exponentials, 0.51 ms on the SFUs at
// 1.98 GHz.  It moves about 1.5 GB (δ, x, dy read and dδ, dx written once, the
// boundaries, B, C, dB, dC): 0.44 ms at 3.35 TB/s.  So the SFU bounds it, as it bounds the
// forward.  This first kernel is simple and right; it spends a third exponential to
// keep its shared memory small, and its channel sums cost shuffles (PERF.md has its time).
//
// Design.
// 1. The forward's lane split: a block is 64 channels × 2 lanes of one batch row; lane g
//    keeps states n ∈ [8g, 8g + 8) and their g_t, A, A·log2(e) and dA sums in registers,
//    and takes each decay as one ex2.approx of δ·A·log2(e), as the forward does, so the
//    recomputed states are the forward's bit for bit.
// 2. Chunks in reverse, states recomputed.  For each kChunk-step chunk, last first, the
//    block starts from the stored boundary (zero for the first chunk) and walks the chunk
//    forward once, keeping the state before each kSub-step sub-chunk in shared memory;
//    then for each sub-chunk, last first, it recomputes its kSub states into shared memory
//    and walks them back.  Each thread reads only the states it wrote, so these need no
//    barrier.  B and C of the chunk are staged in shared memory (zero past N and S).
// 3. Deterministic sums.  dx and dδ sum the 2 lanes of a channel with one shuffle.  dB
//    and dC sum over channels: within a warp a reduce-scatter over channel bits 2, 1, 0
//    (lanes 8, 4, 2 apart) leaves lane (c, g) with state 8g + (c & 7) over 8 channels, and
//    one more shuffle adds the other 8; the 4 warps' sums go to shared memory and are
//    added in warp order, one partial per (block, batch row, t, n).  dA is summed over the
//    chunk's steps in registers, one partial per (batch row, d, n).  A second kernel adds
//    the partials in block order (dB, dC) and batch order (dA_log, times A).  No atomics:
//    two launches give the same bits.
// 4. Shared memory: 68 KB a block (dynamic), three blocks an SM at up to 170 registers a
//    thread; ptxas's report (build.log) must show 0 spill bytes.
//
// Rounding.  Built without --use_fast_math; the one approximate instruction is ex2, as in
// the forward.  Sums run in other orders than the plain version's, so results agree with
// it to about 1e-6 of each gradient's largest magnitude in fp32, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;        // largest state size the kernel takes
constexpr int kLanes = 2;        // lanes per channel (the forward's)
constexpr int kStatesPerLane = kMaxN / kLanes;
constexpr int kChannels = 64;    // channels per block
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kChannelsPerWarp = 32 / kLanes;
constexpr int kChunk = 32;       // steps between stored states: selective_scan.cu's kChunk
constexpr int kSub = 8;          // steps whose states a thread holds at once
constexpr int kSubs = kChunk / kSub;
constexpr int kMinBlocks = 3;    // blocks an SM holds (shared memory allows three)
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kLanes == 2 && kStatesPerLane == 8, "the channel sum assumes 8 states a lane");
static_assert(kChannelsPerWarp >= kStatesPerLane, "a warp sums whole groups of channels");
static_assert(kChunk % kSub == 0, "a chunk holds whole sub-chunks");

struct Smem {
  float sb[kSubs][kStatesPerLane][kThreads];        // the state before each sub-chunk
  float hs[kSub][kStatesPerLane][kThreads];         // the sub-chunk's states h_t
  float bc[2][kChunk][kMaxN];                       // B (0) and C (1) of the chunk
  float red[2][kChunk][kWarps][kMaxN];              // dB (0), dC (1): a warp's sums
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p[i] (state 8g + i of channel c) summed over the warp's 16 channels: the lane of
// channel c returns the sum for state 8g + (c & 7).
__device__ __forceinline__ float channel_sum(float (&p)[kStatesPerLane], int c) {
#pragma unroll
  for (int o = kStatesPerLane / 2; o >= 1; o >>= 1) {
    const bool upper = c & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float keep = upper ? p[i + o] : p[i];
      const float send = upper ? p[i] : p[i + o];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o * kLanes);
    }
  }
  float s = p[0];
#pragma unroll
  for (int o = kStatesPerLane; o < kChannelsPerWarp; o <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o * kLanes);
  return s;
}

__device__ __forceinline__ void load_bcv(const Smem& sm, int tt, int g,
                                         float (&bv)[kStatesPerLane],
                                         float (&cv)[kStatesPerLane]) {
#pragma unroll
  for (int i = 0; i < kStatesPerLane; i += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(&sm.bc[0][tt][g * kStatesPerLane + i]);
    const float4 c4 = *reinterpret_cast<const float4*>(&sm.bc[1][tt][g * kStatesPerLane + i]);
    bv[i] = b4.x; bv[i + 1] = b4.y; bv[i + 2] = b4.z; bv[i + 3] = b4.w;
    cv[i] = c4.x; cv[i + 1] = c4.y; cv[i + 2] = c4.z; cv[i + 3] = c4.w;
  }
}

// One forward step of the recurrence, as selective_scan.cu takes it.
__device__ __forceinline__ void step(float (&h)[kStatesPerLane],
                                     const float (&A2)[kStatesPerLane], const Smem& sm,
                                     int tt, int g, float dt, float du) {
#pragma unroll
  for (int i = 0; i < kStatesPerLane; ++i)
    h[i] = fmaf(ex2(dt * A2[i]), h[i], du * sm.bc[0][tt][g * kStatesPerLane + i]);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) selective_scan_bwd_kernel(
    const float* __restrict__ delta, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ x,
    const float* __restrict__ A_log, const float* __restrict__ boundary,
    const float* __restrict__ dy, const float* __restrict__ dh,
    float* __restrict__ ddelta, float* __restrict__ dx, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ dA_part, int S, int D, int N) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int c = tid / kLanes, g = tid % kLanes, warp = tid / 32;
  const int d0 = blockIdx.x * kChannels;
  const int live = min(kChannels, D - d0);
  const bool valid = c < live;
  const int d = d0 + (valid ? c : live - 1);  // channels past D recompute channel D − 1
  const long long row = blockIdx.y, batch = gridDim.y;
  const long long t_row = row * S;
  const int chunks = (S + kChunk - 1) / kChunk;

  float A[kStatesPerLane], A2[kStatesPerLane], G[kStatesPerLane], dA[kStatesPerLane];
#pragma unroll
  for (int i = 0; i < kStatesPerLane; ++i) {
    const int n = g * kStatesPerLane + i;
    A[i] = n < N ? -expf(A_log[static_cast<long long>(d) * N + n]) : 0.0f;
    A2[i] = A[i] * kLog2e;
    G[i] = dh != nullptr && n < N ? dh[(row * D + d) * N + n] : 0.0f;  // a_{t+1}·g_{t+1}
    dA[i] = 0.0f;
  }

  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's readers of bc and red are done
    for (int s = tid; s < 2 * kChunk * kMaxN; s += kThreads) {
      const int q = s / (kChunk * kMaxN), r = s % (kChunk * kMaxN);
      const int tt = r / kMaxN, n = r % kMaxN;
      const float* src = q == 0 ? Bm : Cm;
      sm.bc[q][tt][n] = tt < len && n < N ? src[(t_row + t0 + tt) * N + n] : 0.0f;
    }
    __syncthreads();

    // Forward through the chunk from its stored start, keeping each sub-chunk's start.
    float h[kStatesPerLane];
#pragma unroll
    for (int i = 0; i < kStatesPerLane; ++i) {
      const int n = g * kStatesPerLane + i;
      h[i] = k > 0 && n < N ? boundary[((row * chunks + k - 1) * D + d) * N + n] : 0.0f;
    }
    for (int tt = 0; tt < len; ++tt) {
      if (tt % kSub == 0) {
#pragma unroll
        for (int i = 0; i < kStatesPerLane; ++i) sm.sb[tt / kSub][i][tid] = h[i];
      }
      const long long e = (t_row + t0 + tt) * D + d;
      const float dt = delta[e];
      step(h, A2, sm, tt, g, dt, dt * x[e]);
    }

    // Sub-chunks, last first: recompute their states, then walk them back.
    for (int j = (len - 1) / kSub; j >= 0; --j) {
      const int s0 = j * kSub, s1 = min(s0 + kSub, len);
#pragma unroll
      for (int i = 0; i < kStatesPerLane; ++i) h[i] = sm.sb[j][i][tid];
      for (int tt = s0; tt < s1; ++tt) {
        const long long e = (t_row + t0 + tt) * D + d;
        const float dt = delta[e];
        step(h, A2, sm, tt, g, dt, dt * x[e]);
#pragma unroll
        for (int i = 0; i < kStatesPerLane; ++i) sm.hs[tt - s0][i][tid] = h[i];
      }
      for (int tt = s1 - 1; tt >= s0; --tt) {
        const long long e = (t_row + t0 + tt) * D + d;
        const float dt = delta[e], xv = x[e], dyv = dy[e];
        const float du = dt * xv;
        float bv[kStatesPerLane], cv[kStatesPerLane];
        load_bcv(sm, tt, g, bv, cv);
        float sx = 0.0f, sd = 0.0f, vb[kStatesPerLane], vc[kStatesPerLane];
#pragma unroll
        for (int i = 0; i < kStatesPerLane; ++i) {
          const float hp = tt > s0 ? sm.hs[tt - s0 - 1][i][tid] : sm.sb[j][i][tid];
          const float a = ex2(dt * A2[i]);
          const float gi = fmaf(dyv, cv[i], G[i]);
          const float ah = a * hp;
          sx = fmaf(gi, bv[i], sx);
          sd = fmaf(gi, fmaf(A[i], ah, xv * bv[i]), sd);
          dA[i] = fmaf(gi * dt, ah, dA[i]);
          vb[i] = valid ? gi * du : 0.0f;
          vc[i] = valid ? dyv * sm.hs[tt - s0][i][tid] : 0.0f;
          G[i] = a * gi;
        }
        sx += __shfl_xor_sync(0xffffffffu, sx, 1);
        sd += __shfl_xor_sync(0xffffffffu, sd, 1);
        if (valid && g == 0) {
          dx[e] = dt * sx;
          ddelta[e] = sd;
        }
        const float sum_b = channel_sum(vb, c);
        const float sum_c = channel_sum(vc, c);
        if ((c & kStatesPerLane) == 0) {
          const int n = g * kStatesPerLane + (c & (kStatesPerLane - 1));
          sm.red[0][tt][warp][n] = sum_b;
          sm.red[1][tt][warp][n] = sum_c;
        }
      }
    }
    __syncthreads();
    // The block's dB, dC of the chunk: the warps' sums in warp order.
    for (int s = tid; s < 2 * len * kMaxN; s += kThreads) {
      const int q = s / (len * kMaxN), r = s % (len * kMaxN);
      const int tt = r / kMaxN, n = r % kMaxN;
      if (n >= N) continue;
      float v = sm.red[q][tt][0][n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += sm.red[q][tt][w][n];
      float* part = q == 0 ? dB_part : dC_part;
      part[((blockIdx.x * batch + row) * S + t0 + tt) * N + n] = v;
    }
  }

  if (valid) {
#pragma unroll
    for (int i = 0; i < kStatesPerLane; ++i) {
      const int n = g * kStatesPerLane + i;
      if (n < N) dA_part[(row * D + d) * N + n] = dA[i];
    }
  }
}

// dB, dC: the blocks' partials added in block order; dA_log: the batch rows' partials
// added in row order, times A = −exp(A_log).
__global__ void selective_scan_bwd_reduce(const float* __restrict__ dB_part,
                                          const float* __restrict__ dC_part,
                                          const float* __restrict__ dA_part,
                                          const float* __restrict__ A_log,
                                          float* __restrict__ dB, float* __restrict__ dC,
                                          float* __restrict__ dA_log, int blocks, int batch,
                                          int S, int D, int N) {
  const long long nbc = static_cast<long long>(batch) * S * N;
  const long long nda = static_cast<long long>(D) * N;
  const long long total = 2 * nbc + nda;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const long long j = is_c ? i - nbc : i;
      const float* p = is_c ? dC_part : dB_part;
      float s = p[j];
      for (int k = 1; k < blocks; ++k) s += p[k * nbc + j];
      (is_c ? dC : dB)[j] = s;
    } else {
      const long long j = i - 2 * nbc;
      float s = dA_part[j];
      for (int r = 1; r < batch; ++r) s += dA_part[r * nda + j];
      dA_log[j] = -expf(A_log[j]) * s;
    }
  }
}

}  // namespace

// All pointers are fp32; `dh` may be null (no gradient of h_final).  `dB_part`, `dC_part`
// ([⌈D/64⌉, batch, S, N]) and `dA_part` ([batch, D, N]) are scratch the wrapper
// allocates (⌈D/64⌉ blocks: ops.BWD_CHANNELS is kChannels).  Returns the
// cudaError_t of the launches (0 on success); the wrapper has checked the shapes.
extern "C" int selective_scan_bwd_launch(const void* delta, const void* B, const void* C,
                                         const void* x, const void* A_log,
                                         const void* boundary, const void* dy, const void* dh,
                                         void* ddelta, void* dB, void* dC, void* dx,
                                         void* dA_log, void* dB_part, void* dC_part,
                                         void* dA_part, int batch, int S, int D, int N,
                                         void* stream) {
  if (batch < 1 || batch > 65535 || S < 1 || D < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (D + kChannels - 1) / kChannels;
  cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  selective_scan_bwd_kernel<<<dim3(blocks, batch), kThreads, sizeof(Smem), st>>>(
      f(delta), f(B), f(C), f(x), f(A_log), f(boundary), f(dy), f(dh),
      static_cast<float*>(ddelta), static_cast<float*>(dx), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dA_part), S, D, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2LL * batch * S * N + static_cast<long long>(D) * N;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int grid = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  selective_scan_bwd_reduce<<<grid, threads, 0, st>>>(
      f(dB_part), f(dC_part), f(dA_part), f(A_log), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA_log), blocks, batch, S, D, N);
  return static_cast<int>(cudaGetLastError());
}
