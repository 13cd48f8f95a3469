// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_kernel` in src/repro/kernels/ssm_scan/kernel.py
// (launched by `selective_scan_fwd`).  It computes what that kernel computes, and what
// repro_torch/kernels/ssm_scan/ref.py computes one step at a time:
//
//   A = −exp(A_log)                                   [D, N], fp32
//   h_0 = 0;   h_t = exp(δ_t·A) ⊙ h_{t−1} + (δ_t·x_t)·B_t      per channel d, fp32
//   y_t = ⟨h_t, C_t⟩_N, rounded once to x's dtype;   h_S is written in fp32.
//
// δ, x are [b, S, D] and B, C are [b, S, N], all fp32 or all bf16 (read as fp32);
// A_log is [D, N] fp32; y is [b, S, D] in the inputs' dtype, h [b, D, N] fp32.  Every
// tensor is contiguous.  Any S and D work (the ragged channel block is masked), and
// 1 ≤ N ≤ 16.
//
// Design.  The TPU kernel keeps a [block_d, N] state in VMEM scratch and carries it
// across an "arbitrary" (sequential) grid axis of seq chunks.  Blocks on this card run
// in no order, so the sequential axis becomes a loop over t inside one block instead:
// one thread per channel (batch row, d), its N ≤ 16 states and its N decay rates A in
// registers (arrays of 16, the unused tail predicated off), and a grid of
// ⌈D/128⌉ × b blocks of 128 threads.  Time runs in chunks of 32 steps.  For each chunk a
// thread copies its own column of δ and x (32 values each, coalesced over d across the
// warp) into shared memory as fp32, so 64 loads are in flight before the first is
// needed, and the block copies the chunk's B and C rows (shared by all channels of a
// batch row) cooperatively; every thread of a warp then reads the same B_t, C_t word, a
// broadcast.  y_t is stored coalesced over d at each step, and h once at the end.
//
// What bounds it on an H100.  At the serving shape (b = 4, S = 2048, D = 8192, N = 16,
// fp32) it moves about 808 MB (δ and x read once, y written once, B, C, A_log and h:
// 0.24 ms at 3.35 TB/s) and takes 1.07 G exponentials, one per (b, t, d, n).  An
// accurate expf issues one ex2 on the special-function units, 16 per clock per SM:
// 0.26 ms at 132 SMs and 1.98 GHz, with about ten fp32 operations around each (range
// reduction, the decay, the update and the dot product) on the 128 fp32 lanes.  So the
// exponentials bound it, just above the bytes.  This kernel runs one thread per channel,
// 256 blocks at the serving shape (about 8 warps per SM), and does not overlap a chunk's
// loads with the previous chunk's arithmetic; a scan over time split across threads and
// double-buffered chunks are the steps toward the bound.  PERF.md has the measured times.
//
// Rounding.  Built without --use_fast_math: expf is the accurate library function.  The
// compiler may contract a·h + u and the dot product into FMAs, and the dot product runs
// over n in order where the plain version leaves the order to einsum, so results agree
// with the plain version to about 1e-6 relative in fp32, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps staged in shared memory at once
constexpr int kMaxN = 16;      // largest state size the kernel takes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ delta, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const T* __restrict__ x, const float* __restrict__ A_log, T* __restrict__ y,
    float* __restrict__ h_out, int S, int D, int N) {
  __shared__ float s_delta[kChunk][kThreads];
  __shared__ float s_x[kChunk][kThreads];
  __shared__ float s_B[kChunk][kMaxN];
  __shared__ float s_C[kChunk][kMaxN];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < D;
  const long long row = blockIdx.y;  // batch row
  const T* delta_r = delta + row * S * D;
  const T* x_r = x + row * S * D;
  const T* B_r = Bm + row * S * N;
  const T* C_r = Cm + row * S * N;
  T* y_r = y + row * S * D;

  float A[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    A[n] = (live && n < N) ? -expf(A_log[static_cast<long long>(d) * N + n]) : 0.0f;
    h[n] = 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    if (live) {
#pragma unroll 8
      for (int tt = 0; tt < len; ++tt) {
        const long long off = static_cast<long long>(t0 + tt) * D + d;
        s_delta[tt][tid] = to_f32(delta_r[off]);
        s_x[tt][tid] = to_f32(x_r[off]);
      }
    }
    for (int i = tid; i < len * N; i += kThreads) {
      const int tt = i / N, n = i - tt * N;
      const long long off = static_cast<long long>(t0) * N + i;
      s_B[tt][n] = to_f32(B_r[off]);
      s_C[tt][n] = to_f32(C_r[off]);
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < len; ++tt) {
        const float dt = s_delta[tt][tid];
        const float du = dt * s_x[tt][tid];
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < N) {
            h[n] = expf(dt * A[n]) * h[n] + du * s_B[tt][n];
            acc += h[n] * s_C[tt][n];
          }
        }
        store(&y_r[static_cast<long long>(t0 + tt) * D + d], acc);
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  if (live) {
    float* h_d = h_out + (row * D + d) * N;
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_d[n] = h[n];
  }
}

template <typename T>
int launch(const void* delta, const void* B, const void* C, const void* x,
           const float* A_log, void* y, float* h, int batch, int S, int D, int N,
           cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const T*>(x), A_log, static_cast<T*>(y), h, S, D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (δ, B, C, x and y); A_log and h are fp32.  Returns the
// cudaError_t of the launch (0 on success); the wrapper has checked the shapes.
extern "C" int selective_scan_launch(const void* delta, const void* B, const void* C,
                                     const void* x, const void* A_log, void* y, void* h,
                                     int dtype, int batch, int S, int D, int N,
                                     void* stream) {
  if (batch < 1 || batch > 65535 || S < 1 || D < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A_log);
  float* hf = static_cast<float*>(h);
  if (dtype == 0) return launch<float>(delta, B, C, x, a, y, hf, batch, S, D, N, st);
  if (dtype == 1) return launch<__nv_bfloat16>(delta, B, C, x, a, y, hf, batch, S, D, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
