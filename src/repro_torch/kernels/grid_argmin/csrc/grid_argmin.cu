// Fused masked voltage-grid sweep + per-bin argmin, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_grid_argmin_kernel` in
// src/repro/kernels/grid_argmin/kernel.py (launched by `grid_argmin_fwd`).
// Semantics are those of repro_torch/kernels/grid_argmin/ref.py:
//
//   for each platform p, sweep row r, frequency level m:
//     delay[g] = combine_i w_i * D_i(V_rail_i(g))       (Σ, or max if delay_mode == 1)
//     dyn[g]   = Σ_i dyn_i * (V/V0)²                     (f-independent)
//     stat[g]  = Σ_i stat_i * (V/V0) * exp(κ_i (V − V0))
//     feasible[g] = delay[g] <= (1 + eps) / f  &&  mask[r, g]
//     pick the first flat index g minimizing dyn[g]*f + stat[g] over feasible g;
//     when none is feasible, fall back to the nominal corner g = C·B − 1.
//
// The grid is flat and row-major: g = ci·B + bi, V_core = core[ci], V_bram = bram[bi].
//
// Design.  One thread block per (p, r), 256 threads (≥ 247 = 13·19, the default
// grid), looping over grid points when C·B is larger.  Each thread evaluates the
// term library for its grid points once into shared memory (3·C·B floats); then,
// per level, each thread forms its masked objective, and a warp-shuffle
// (value, index) min reduction followed by a cross-warp pass picks the winner,
// ties going to the smaller flat index.  None of the TPU layout is kept: no
// 128-lane/8-sublane padding, no one-hot gather — thread 0 indexes the grids.
//
// Rounding.  Built without --use_fast_math; powf/expf are the accurate library
// functions.  Products and sums go through __fmul_rn/__fadd_rn, which nvcc never
// contracts into FMAs, and term sums run in index order, so the kernel repeats
// the plain version's rounding sequence except where the plain version sums
// (dyn_i·f + stat_i) per term and this kernel forms Σdyn·f + Σstat: the two agree
// to ~1e-6 relative, which can flip a near-tie between two grid points.
//
// What bounds it on an H100.  At Table II size (P = 5, R = 12, M = 25, C·B = 247)
// the call reads and writes about 30 KB and makes about 0.4 M feasibility tests:
// some 20 ns of memory traffic or fp32 arithmetic, far below the microseconds of
// a launch, so neither bytes nor operations bound it, and its 60 blocks fill under
// half of the 132 SMs.  What a block spends its time on is latency: the term
// library costs each thread about a dozen accurate powf/expf, then the 25 levels
// run one after another, each a block-wide reduction with three barriers.  A
// later change could give each level its own warp (no barriers after the table
// is built) and fuse the hybrid gear argmin of controller.fleet_bin_tables into
// this launch.  PERF.md has the measured times beside the bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRailCore = 0;
constexpr int kRailBram = 1;

__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads) grid_argmin_kernel(
    const float* __restrict__ dl_weight, const float* __restrict__ dl_vth,
    const float* __restrict__ dl_alpha, const float* __restrict__ dl_v0,
    const int* __restrict__ dl_rail, const int* __restrict__ delay_mode,
    const int* __restrict__ pw_rail, const float* __restrict__ pw_v0,
    const float* __restrict__ pw_dyn, const float* __restrict__ pw_stat,
    const float* __restrict__ pw_kappa, const unsigned char* __restrict__ mask,
    const float* __restrict__ levels, const float* __restrict__ core_grid,
    const float* __restrict__ bram_grid, float* __restrict__ v_core,
    float* __restrict__ v_bram, float* __restrict__ power,
    unsigned char* __restrict__ feasible, int R, int M, int C, int B, int D,
    int T, float thr_scale) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int r = blockIdx.x;
  const int p = blockIdx.y;
  const int G = C * B;
  float* s_delay = smem;
  float* s_dyn = smem + G;
  float* s_stat = smem + 2 * G;

  // --- the platform's term library over the flat grid (f-independent) ---
  const int max_mode = delay_mode[p] == 1;
  const float* w = dl_weight + p * D;
  const float* vth = dl_vth + p * D;
  const float* alpha = dl_alpha + p * D;
  const float* v0 = dl_v0 + p * D;
  const int* rail = dl_rail + p * D;
  const int* prail = pw_rail + p * T;
  const float* pv0 = pw_v0 + p * T;
  const float* pdyn = pw_dyn + p * T;
  const float* pstat = pw_stat + p * T;
  const float* kappa = pw_kappa + p * T;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float vc = core_grid[g / B];
    const float vb = bram_grid[g % B];
    float delay = 0.0f;
    for (int i = 0; i < D; ++i) {
      const float v = rail[i] == kRailCore ? vc : vb;
      const float num = v / powf(fmaxf(v - vth[i], 1e-6f), alpha[i]);
      const float den = v0[i] / powf(v0[i] - vth[i], alpha[i]);
      const float term = __fmul_rn(w[i], num / den);
      delay = i == 0 ? term : (max_mode ? fmaxf(delay, term) : __fadd_rn(delay, term));
    }
    float dyn = 0.0f, stat = 0.0f;
    for (int i = 0; i < T; ++i) {
      const float v = prail[i] == kRailCore ? vc : (prail[i] == kRailBram ? vb : pv0[i]);
      const float x = v / pv0[i];
      const float d_i = __fmul_rn(pdyn[i], __fmul_rn(x, x));
      const float s_i = __fmul_rn(__fmul_rn(pstat[i], x),
                                  expf(__fmul_rn(kappa[i], v - pv0[i])));
      dyn = i == 0 ? d_i : __fadd_rn(dyn, d_i);
      stat = i == 0 ? s_i : __fadd_rn(stat, s_i);
    }
    s_delay[g] = delay;
    s_dyn[g] = dyn;
    s_stat[g] = stat;
  }
  __syncthreads();

  // --- per level: masked objective, block-wide first-index argmin ---
  const unsigned char* mrow = mask + static_cast<size_t>(r) * G;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int m = 0; m < M; ++m) {
    const float f = levels[r * M + m];
    const float thr = __fmul_rn(1.0f / fmaxf(f, 1e-6f), thr_scale);
    float best = INFINITY;
    int best_i = G;
    int any = 0;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      if (s_delay[g] <= thr && mrow[g]) {
        any = 1;
        const float obj = __fadd_rn(__fmul_rn(s_dyn[g], f), s_stat[g]);
        if (obj < best) {  // strict: keeps this thread's first index
          best = obj;
          best_i = g;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      take_min(best, best_i, ov, oi);
    }
    any = __syncthreads_or(any);
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = red_v[0];
      int i = red_i[0];
      for (int k = 1; k < kWarps; ++k) take_min(v, i, red_v[k], red_i[k]);
      const size_t o = (static_cast<size_t>(p) * R + r) * M + m;
      if (!any) {  // nothing meets timing: the nominal corner
        i = G - 1;
        v = __fadd_rn(__fmul_rn(s_dyn[i], f), s_stat[i]);
      }
      v_core[o] = core_grid[i / B];
      v_bram[o] = bram_grid[i % B];
      power[o] = v;
      feasible[o] = static_cast<unsigned char>(any);
    }
    __syncthreads();  // red_v/red_i are rewritten by the next level
  }
}

}  // namespace

// Launches on `stream` without synchronizing; returns cudaGetLastError() as an int.
extern "C" int grid_argmin_launch(
    const float* dl_weight, const float* dl_vth, const float* dl_alpha,
    const float* dl_v0, const int* dl_rail, const int* delay_mode,
    const int* pw_rail, const float* pw_v0, const float* pw_dyn,
    const float* pw_stat, const float* pw_kappa, const unsigned char* mask,
    const float* levels, const float* core_grid, const float* bram_grid,
    float* v_core, float* v_bram, float* power, unsigned char* feasible, int P,
    int R, int M, int C, int B, int D, int T, float thr_scale, void* stream) {
  const dim3 grid(R, P);
  const size_t smem = 3 * static_cast<size_t>(C) * B * sizeof(float);
  grid_argmin_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dl_weight, dl_vth, dl_alpha, dl_v0, dl_rail, delay_mode, pw_rail, pw_v0,
      pw_dyn, pw_stat, pw_kappa, mask, levels, core_grid, bram_grid, v_core,
      v_bram, power, feasible, R, M, C, B, D, T, thr_scale);
  return static_cast<int>(cudaGetLastError());
}
