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
// Design.  A cluster of S blocks (1 ≤ S ≤ kMaxSplit) owns one (platform,
// row); rank s takes the flat range [s·L, (s+1)·L) and walks it in table
// windows.  make_plan sizes the launch on the host: the largest S whose
// P·R·S blocks all fit on the card at once (kBlocksPerSm an SM) with at
// least kMinRankPoints points a rank, then the largest window whose tables
// and mask bytes fit kSmemBudget.
//
//  1. Per-rail term tables.  Each delay term reads one rail, and each power
//     term one rail or the constant pw_v0, so a term is tabulated over the
//     window's core voltages or its bram voltages, not over its C·B points:
//     one accurate powf or expf a thread for each (term, voltage), then the
//     leading run of terms on one rail is folded in term order into the
//     run's last row; every later term keeps its own.  Power terms at pw_v0
//     may sit inside a run, but the run ends at its last term on the rail,
//     so the row it folds into holds one entry a voltage.  A point's delay,
//     dyn and stat are that prefix entry combined with the later terms'
//     entries in index order, so they are bit for bit the values of a flat
//     evaluation in term order.  `den` is computed once per term.
//  2. Staging.  One phase puts every input of the set-up in flight together
//     (the platform's terms, both grids, the levels); the next builds the
//     window's tables and copies the row's mask bytes into shared memory.
//     The point loop then reads no global memory.
//  3. Levels in parallel, sorted.  Each lane walks its points in ascending
//     flat order, two at a time, and keeps in registers the running
//     (value, index) minimum of every level of the chunk (kMaxLevels = 28 a
//     pass); strict `<` keeps the first index.  The chunk's levels are sorted
//     by threshold, largest first, so a warp stops at the first group of four
//     levels that none of its points meets, and skips dyn and stat where it
//     meets none.  A level is feasible when the least delay over the row's
//     masked points meets it, one fminf a point.  After each window a warp reduce-scatter leaves level l's warp
//     minimum in lane l, which merges it into its own shared slot; the warps
//     merge once at the end, and rank 0 merges the cluster's ranks through
//     distributed shared memory — all by the lexicographic (value, index)
//     rule, which is the first-index rule.  No barrier is taken per level.
//  4. No cap on grid size.  Windows bound the tables and the mask bytes, so
//     any C·B that int32 flat indices hold runs.
//
// Rounding.  Built without --use_fast_math; powf/expf are the accurate library
// functions.  Products and sums go through __fmul_rn/__fadd_rn, which nvcc never
// contracts into FMAs, and term sums run in index order, so every point's delay,
// dyn and stat repeat the plain version's rounding sequence.  The objective is
// Σdyn·f + Σstat, as the TPU kernel forms it (kernel.py:80); the plain version
// sums (dyn_i·f + stat_i) per term.  The two agree to ~1e-6 relative, which can
// flip a near-tie between two grid points.
//
// What bounds it on an H100.  At Table II size (P = 5, R = 12, M = 25, C·B = 247)
// the call reads and writes about 25 KB and makes about 0.4 M feasibility tests:
// some 20 ns of memory traffic or fp32 arithmetic, far below the microseconds of
// a launch, so the launch and one block's chain of phases set the time.  At a
// 1 mV grid (135,751 points) the ~204 M (point, level) tests and the ~16 M
// table lookups of the points' terms bound it by operations: a test is about
// six issue slots (a multiply, an add, two compares, two selects), four of them
// on the integer/compare pipe, and a lookup a chain of dependent shared-memory
// reads.  Registers cap a thread at 128 (two blocks an SM).  PERF.md has the
// measured times beside the bounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 2;
constexpr int kSlots = 32;
constexpr int kMaxLevels = 28;
constexpr int kMaxSplit = 8;
constexpr int kBlocksPerSm = 2;
constexpr int kMinRankPoints = 1024;
constexpr int kSmemBudget = 98304;
constexpr int kStagedGrid = 4096;
constexpr int kRailCore = 0;
constexpr int kRailBram = 1;

struct Args {
  const float* dl_weight;
  const float* dl_vth;
  const float* dl_alpha;
  const float* dl_v0;
  const int* dl_rail;
  const int* delay_mode;
  const int* pw_rail;
  const float* pw_v0;
  const float* pw_dyn;
  const float* pw_stat;
  const float* pw_kappa;
  const unsigned char* mask;
  const float* levels;
  const float* core_grid;
  const float* bram_grid;
  float* v_core;
  float* v_bram;
  float* power;
  unsigned char* feasible;
  int R, M, C, B, D, T;
  float thr_scale;
  int range;   // flat points per cluster rank
  int window;  // flat points per table window
  int width;   // entries per table row
};

// Byte offsets of the dynamic shared memory: tables (at most D + 2T rows of
// `width` floats); the platform's terms (4D + 6T floats: weight, vth, alpha,
// den, then pw_v0, dyn, stat, kappa and each term's dyn and stat at the
// nominal corner; D + T rail codes); unit descriptors (int4 [D + T]); both
// voltage grids when C + B <= kStagedGrid; the row's mask bytes of a window.
struct Layout {
  size_t terms, unit, grid, mask, total;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline bool grid_staged(int C, int B) { return C + B <= kStagedGrid; }

__host__ __device__ inline Layout smem_layout(int D, int T, int C, int B, int width,
                                              int window) {
  Layout l;
  l.terms = align16(static_cast<size_t>(D + 2 * T) * width * sizeof(float));
  l.unit = l.terms + align16(static_cast<size_t>(5 * D + 7 * T) * sizeof(float));
  l.grid = l.unit + static_cast<size_t>(D + T) * 16;
  l.mask = l.grid + (grid_staged(C, B) ? align16(static_cast<size_t>(C + B) * 4) : 0);
  l.total = l.mask + align16(static_cast<size_t>(window));
  return l;
}

// One platform's terms, staged in shared memory.
struct Terms {
  float *w, *vth, *alpha, *den, *pv0, *dyn, *stat, *kappa, *nom_dyn, *nom_stat;
  int *drail, *prail;

  __device__ Terms(unsigned char* base, int D, int T) {
    float* f = reinterpret_cast<float*>(base);
    w = f;
    vth = w + D;
    alpha = vth + D;
    den = alpha + D;
    pv0 = den + D;
    dyn = pv0 + T;
    stat = dyn + T;
    kappa = stat + T;
    nom_dyn = kappa + T;
    nom_stat = nom_dyn + T;
    drail = reinterpret_cast<int*>(nom_stat + T);
    prail = drail + D;
  }

  // Delay term i at rail voltage v: the plain version's expression, in its
  // order, with den = v0 / (v0 − vth)^alpha computed once.
  __device__ float delay(int i, float v) const {
    const float num = v / powf(fmaxf(v - vth[i], 1e-6f), alpha[i]);
    return __fmul_rn(w[i], num / den[i]);
  }

  // Power term i's (dyn, stat) at core voltage vc and bram voltage vb; a term
  // on neither rail sits at its pw_v0.
  __device__ float2 power(int i, float vc, float vb) const {
    const float v = prail[i] == kRailCore ? vc : (prail[i] == kRailBram ? vb : pv0[i]);
    const float x = v / pv0[i];
    return make_float2(__fmul_rn(dyn[i], __fmul_rn(x, x)),
                       __fmul_rn(__fmul_rn(stat[i], x),
                                 expf(__fmul_rn(kappa[i], v - pv0[i]))));
  }
};

__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// One round of the warp reduce-scatter over 2·kHalf (value, index) slots:
// lanes with bit kHalf set keep the upper half, the others the lower half,
// each merged with its partner's copy of the half it keeps.  After the rounds
// 16, 8, 4, 2, 1, slot 0 of lane l holds the warp's minimum of slot l.
template <int kHalf>
__device__ __forceinline__ void scatter_round(float* v, int* i, int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    float keep_v = upper ? v[k + kHalf] : v[k];
    int keep_i = upper ? i[k + kHalf] : i[k];
    const float got_v = __shfl_xor_sync(0xffffffffu, upper ? v[k] : v[k + kHalf], kHalf);
    const int got_i = __shfl_xor_sync(0xffffffffu, upper ? i[k] : i[k + kHalf], kHalf);
    take_min(keep_v, keep_i, got_v, got_i);
    v[k] = keep_v;
    i[k] = keep_i;
  }
}

__device__ __forceinline__ int delay_rail(int code) {
  return code == kRailCore ? kRailCore : kRailBram;  // any other code reads bram
}

// The leading run of n terms: its length and its rail.  `rails` holds rail
// codes; a power term at pw_v0 (a code that is neither core nor bram) may sit
// inside a run but does not end one: the run ends at its last term on its
// rail, so a term at pw_v0 after it is a unit of its own.  A run of terms at
// pw_v0 alone has rail -1.  Every lane of the (whole, converged) warp gets the
// same answer, from ballots, not a serial scan.
__device__ int2 leading_run(const int* rails, int n, int lane) {
  int run = -1, end = 0;  // the run's rail; one past its last term on that rail
  for (int c = 0; c < n; c += 32) {
    const int i = c + lane;
    const int key = i < n && (rails[i] == kRailCore || rails[i] == kRailBram) ? rails[i] : -1;
    if (run < 0) {
      const unsigned keyed = __ballot_sync(0xffffffffu, key >= 0);
      if (keyed) run = __shfl_sync(0xffffffffu, key, __ffs(keyed) - 1);
    }
    const unsigned valid = __ballot_sync(0xffffffffu, i < n);
    const unsigned broken = valid & ~__ballot_sync(0xffffffffu, key < 0 || key == run);
    const unsigned before = broken ? (1u << (__ffs(broken) - 1)) - 1 : 0xffffffffu;
    const unsigned on_run = __ballot_sync(0xffffffffu, key >= 0 && key == run) & before;
    if (on_run) end = c + 32 - __clz(on_run);
    if (broken) break;
  }
  return run < 0 ? make_int2(n, -1) : make_int2(end, run);
}

// A table row's rail as the masks a point's index is formed with:
// index = off + ((lc & core) | (lb & bram)); both 0 for a term at pw_v0.
__device__ __forceinline__ int4 unit_desc(int off, int rail) {
  return make_int4(off, rail == kRailCore ? -1 : 0, rail == kRailBram ? -1 : 0, 0);
}

__device__ __forceinline__ int unit_index(int4 d, int lc, int lb) {
  return d.x + ((lc & d.y) | (lb & d.z));
}

// The table units a point reads: delay units [0, nd) — the leading run of
// delay terms, folded into its last term's row, then one unit a later term —
// and power units [nd, nd + np) likewise.  Delay term i has row i; power
// term i rows D + 2i (dyn) and D + 2i + 1 (stat).
struct Units {
  int nd, np, npd, npp, rail_d, rail_p;

  __device__ int4 desc(const int* drail, const int* prail, int u, int D, int W) const {
    if (u == 0) return unit_desc((npd - 1) * W, rail_d);
    if (u < nd) return unit_desc((npd + u - 1) * W, drail[npd + u - 1]);
    const int i = u - nd == 0 ? npp - 1 : npp + u - nd - 1;
    return unit_desc((D + 2 * i) * W, u - nd == 0 ? rail_p : prail[i]);
  }
};

// Four thresholds or levels from shared memory, read where they are used: a
// volatile load the compiler cannot hoist into 2·kMaxLevels live registers.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Row r's levels [m0, m0 + kMaxLevels), read by one warp and sorted by
// threshold (1 / max(f, 1e-6))·(1 + eps), largest first: a point that meets
// no level of a group of four meets none after it.  Slot k holds the chunk's
// level perm[k]; slots past the chunk or past M hold a NaN threshold, which no
// delay meets, and sort last.
__device__ void stage_levels(const Args& a, int r, int m0, int lane, float* thr_out,
                             float* f_out, int* perm_out) {
  const bool valid = lane < kMaxLevels && m0 + lane < a.M;
  const float f = valid ? a.levels[r * a.M + m0 + lane] : 0.0f;
  const float thr = valid ? __fmul_rn(1.0f / fmaxf(f, 1e-6f), a.thr_scale)
                          : __int_as_float(0x7fc00000);
  int rank = 0;
  for (int k = 0; k < 32; ++k) {
    const float tk = __shfl_sync(0xffffffffu, thr, k);
    const bool vk = __shfl_sync(0xffffffffu, valid, k);
    rank += vk != valid ? vk : (tk > thr || (!(tk < thr) && k < lane));
  }
  thr_out[rank] = thr;
  f_out[rank] = f;
  perm_out[rank] = lane;
}

// A window of the flat grid as the point loop sees it.
struct Window {
  int w0, w1, c_lo, b_lo, B, W, nd, nu, step_c, step_b;  // steps of kThreads points
  bool max_mode;
};

__device__ __forceinline__ int ordered(float x) {  // float order as int order
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// A lane's points g + q·kThreads (q < kB), ascending, at grid position
// (ci, bi), which it advances past them: each point's delay from the tables
// (kB independent chains of reads); then, unless no point of the warp meets
// any level, its dyn and stat, and each level's running minimum.  Levels are
// sorted by threshold, so the warp stops at the first group of four levels
// that none of its points meets.  Strict `<` in ascending order keeps the
// first index.  A point masked out or past the window gets an infinite delay:
// it meets no level and leaves dmin alone.  The warp's control flow is uniform.
template <int kB>
__device__ __forceinline__ void test_points(
    int g, const Window& win, int& ci, int& bi, const unsigned char* s_mask,
    const float* s_tab, const int4* s_unit, const float* s_thr, const float* s_f,
    float* best, int* best_i, float& dmin) {
  int lc[kB], lb[kB];
  bool live[kB];
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    const int gq = g + q * kThreads;
    live[q] = gq < win.w1 && s_mask[gq - win.w0];
    lc[q] = live[q] ? ci - win.c_lo : 0;  // a dead point reads entry 0
    lb[q] = live[q] ? (bi >= win.b_lo ? bi - win.b_lo : bi - win.b_lo + win.B) : 0;
    bi += win.step_b;
    ci += win.step_c;
    if (bi >= win.B) {
      bi -= win.B;
      ++ci;
    }
  }
  float delay[kB];
  int4 d = s_unit[0];
#pragma unroll
  for (int q = 0; q < kB; ++q) delay[q] = s_tab[unit_index(d, lc[q], lb[q])];
#pragma unroll 1
  for (int u = 1; u < win.nd; ++u) {
    d = s_unit[u];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const float t = s_tab[unit_index(d, lc[q], lb[q])];
      delay[q] = win.max_mode ? fmaxf(delay[q], t) : __fadd_rn(delay[q], t);
    }
  }
  int key = ordered(INFINITY);
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    if (!live[q]) delay[q] = INFINITY;
    dmin = fminf(dmin, delay[q]);
    if (!isnan(delay[q])) key = min(key, ordered(delay[q]));
  }
  const float dw = unordered(__reduce_min_sync(0xffffffffu, key));  // the warp's least delay
  if (!(s_thr[0] >= dw)) return;
  float dyn[kB], stat[kB];
  d = s_unit[win.nd];
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    const int idx = unit_index(d, lc[q], lb[q]);
    dyn[q] = s_tab[idx];
    stat[q] = s_tab[idx + win.W];
  }
#pragma unroll 1
  for (int u = win.nd + 1; u < win.nu; ++u) {
    d = s_unit[u];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int idx = unit_index(d, lc[q], lb[q]);
      dyn[q] = __fadd_rn(dyn[q], s_tab[idx]);
      stat[q] = __fadd_rn(stat[q], s_tab[idx + win.W]);
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxLevels; m += 4) {
    const float4 th = lds4(s_thr + m), ff = lds4(s_f + m);
    if (!(th.x >= dw)) break;  // no point of the warp meets level m or any after it
    const float thr[4] = {th.x, th.y, th.z, th.w};
    const float f[4] = {ff.x, ff.y, ff.z, ff.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
#pragma unroll
      for (int q = 0; q < kB; ++q) {
        const float obj = __fadd_rn(__fmul_rn(dyn[q], f[l]), stat[q]);
        if (delay[q] <= thr[l] && obj < best[m + l]) {
          best[m + l] = obj;
          best_i[m + l] = g + q * kThreads;
        }
      }
    }
  }
}

// One block: rank blockIdx.x of the cluster of (platform blockIdx.z, row
// blockIdx.y); kBlocksPerSm blocks an SM.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) grid_argmin_kernel(const Args a) {
  static_assert(kMaxLevels % 4 == 0 && kMaxLevels <= kSlots, "levels go in groups of four");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float s_thr[kSlots];
  __shared__ __align__(16) float s_f[kSlots];
  __shared__ int s_perm[kSlots];
  __shared__ float s_acc_v[kWarps][32];
  __shared__ int s_acc_i[kWarps][32];
  __shared__ float s_dmin[kWarps];
  __shared__ float s_res_v[32];
  __shared__ int s_res_i[32];
  __shared__ float s_res_dmin;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, split = gridDim.x;
  const int r = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int C = a.C, B = a.B, D = a.D, T = a.T, W = a.width, M = a.M;
  const int G = C * B;
  const Layout lay = smem_layout(D, T, C, B, W, a.window);
  float* s_tab = reinterpret_cast<float*>(smem);
  int4* s_unit = reinterpret_cast<int4*>(smem + lay.unit);
  unsigned char* s_mask = smem + lay.mask;
  const bool staged = grid_staged(C, B);
  const float* core = staged ? reinterpret_cast<float*>(smem + lay.grid) : a.core_grid;
  const float* bram = staged ? core + C : a.bram_grid;
  const int lo = min(G, rank * a.range);
  const int hi = min(G, lo + a.range);
  const unsigned char* mrow = a.mask + static_cast<size_t>(r) * G;

  // --- phase 1: every global load of the set-up in flight together: the
  // platform's terms (den with them), the grids, the first chunk's levels.
  // (Each phase makes its own view of the terms: none is live in the point loop.) ---
  {
    const Terms tm(smem + lay.terms, D, T);
    for (int i = (tid + kThreads - 32) % kThreads; i < D; i += kThreads) {  // warp 1 on
      const int k = p * D + i;
      const float v0 = a.dl_v0[k], vth = a.dl_vth[k], alpha = a.dl_alpha[k];
      tm.w[i] = a.dl_weight[k];
      tm.vth[i] = vth;
      tm.alpha[i] = alpha;
      tm.drail[i] = delay_rail(a.dl_rail[k]);
      tm.den[i] = v0 / powf(v0 - vth, alpha);
    }
    for (int i = (tid + kThreads - 64) % kThreads; i < T; i += kThreads) {  // warp 2 on
      const int k = p * T + i;
      tm.pv0[i] = a.pw_v0[k];
      tm.dyn[i] = a.pw_dyn[k];
      tm.stat[i] = a.pw_stat[k];
      tm.kappa[i] = a.pw_kappa[k];
      tm.prail[i] = a.pw_rail[k];
    }
  }
  if (staged) {
    float* s_core = reinterpret_cast<float*>(smem + lay.grid);
    for (int i = tid; i < C + B; i += kThreads) {
      s_core[i] = i < C ? a.core_grid[i] : a.bram_grid[i - C];
    }
  }
  if (warp == 0) stage_levels(a, r, 0, lane, s_thr, s_f, s_perm);
  const bool max_mode = a.delay_mode[p] == 1;
  __syncthreads();

  // --- phase 2 (no barrier of its own): the units from ballots and their
  // descriptors (warp 0) ---
  Units un;
  {
    const Terms tm(smem + lay.terms, D, T);
    const int2 rd = leading_run(tm.drail, D, lane);
    const int2 rp = leading_run(tm.prail, T, lane);
    un = {1 + D - rd.x, 1 + T - rp.x, rd.x, rp.x, rd.y, rp.y};
    if (warp == 0) {
      for (int u = lane; u < un.nd + un.np; u += 32) {
        s_unit[u] = un.desc(tm.drail, tm.prail, u, D, W);
      }
    }
  }
  const int nu = un.nd + un.np;

  for (int m0 = 0; m0 < M; m0 += kMaxLevels) {
    if (m0 > 0 && warp == 0) stage_levels(a, r, m0, lane, s_thr, s_f, s_perm);
    // Each warp's running minima, one level a lane; each lane owns its slot.
    s_acc_v[warp][lane] = INFINITY;
    s_acc_i[warp][lane] = 0;
    if (lane == 0) s_dmin[warp] = INFINITY;

    for (int w0 = lo; w0 < hi; w0 += a.window) {
      const int w1 = min(hi, w0 + a.window), n = w1 - w0;
      const int c_lo = w0 / B, b_lo = w0 - c_lo * B;
      const int nc = (w1 - 1) / B - c_lo + 1, nb = min(B, n);
      if (w0 != lo) __syncthreads();  // the last window's readers are done

      // --- the window's term tables and the row's mask bytes; the first
      // mask byte's load is in flight while the tables are built ---
      const unsigned char m_first = tid < n ? mrow[w0 + tid] : 0;
      const Terms tm(smem + lay.terms, D, T);
      // Step 1: each term over its rail's window, one accurate powf or expf
      // a (term, voltage): delay term i in row i, power term i in rows
      // D + 2i (dyn) and D + 2i + 1 (stat); a power term at pw_v0 has one entry.
      // The last T items are each power term at the nominal corner.
      for (int e = tid; e < (D + T) * W + T; e += kThreads) {
        if (e >= (D + T) * W) {
          const int i = e - (D + T) * W;
          const float2 t = tm.power(i, core[C - 1], bram[B - 1]);
          tm.nom_dyn[i] = t.x;
          tm.nom_stat[i] = t.y;
          continue;
        }
        const int i = e / W, k = e - i * W;
        const int rail = i < D ? tm.drail[i] : tm.prail[i - D];
        if (k >= (rail == kRailCore ? nc : (rail == kRailBram ? nb : 1))) continue;
        const int bk = b_lo + k >= B ? b_lo + k - B : b_lo + k;
        const float v = rail == kRailCore ? core[c_lo + k] : (rail == kRailBram ? bram[bk] : 0.0f);
        if (i < D) {
          s_tab[i * W + k] = tm.delay(i, v);
        } else {
          const float2 t = tm.power(i - D, v, v);
          s_tab[(D + 2 * (i - D)) * W + k] = t.x;
          s_tab[(D + 2 * (i - D) + 1) * W + k] = t.y;
        }
      }
      __syncthreads();
      // Step 2: each leading run folded, in term order, into its last term's
      // row (a term at pw_v0 reads its one entry).
      {
        const int n_d = un.npd > 1 ? (un.rail_d == kRailCore ? nc : nb) : 0;
        const int n_p = un.npp > 1 ? (un.rail_p == kRailCore ? nc
                                      : (un.rail_p == kRailBram ? nb : 1)) : 0;
        for (int e = tid; e < n_d + n_p; e += kThreads) {
          if (e < n_d) {
            float acc = s_tab[e];
            for (int i = 1; i < un.npd; ++i) {
              const float t = s_tab[i * W + e];
              acc = max_mode ? fmaxf(acc, t) : __fadd_rn(acc, t);
            }
            s_tab[(un.npd - 1) * W + e] = acc;
          } else {
            const int k = e - n_d;
            float dyn = 0.0f, stat = 0.0f;
            for (int i = 0; i < un.npp; ++i) {
              const bool fixed = tm.prail[i] != kRailCore && tm.prail[i] != kRailBram;
              const int at = (D + 2 * i) * W + (fixed ? 0 : k);
              dyn = i == 0 ? s_tab[at] : __fadd_rn(dyn, s_tab[at]);
              stat = i == 0 ? s_tab[at + W] : __fadd_rn(stat, s_tab[at + W]);
            }
            s_tab[(D + 2 * (un.npp - 1)) * W + k] = dyn;
            s_tab[(D + 2 * (un.npp - 1)) * W + W + k] = stat;
          }
        }
      }
      if (tid < n) s_mask[tid] = m_first;
      for (int k = tid + kThreads; k < n; k += kThreads) s_mask[k] = mrow[w0 + k];
      __syncthreads();

      // --- each warp's points, kBatch a lane at a time, into registers; the
      // minima live only here, not across the table build ---
      float best[kSlots];
      int best_i[kSlots];
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        best[m] = INFINITY;
        best_i[m] = 0;
      }
      float dmin = INFINITY;
      const Window win = {w0, w1, c_lo, b_lo, B, W, un.nd, nu, kThreads / B, kThreads % B,
                          max_mode};
      int ci = (w0 + tid) / B, bi = w0 + tid - ci * B;
      for (int g0 = w0 + warp * 32; g0 < w1; g0 += kBatch * kThreads) {
        const int g = g0 + lane;
        if (g0 + (kBatch - 1) * kThreads < w1) {  // warp-uniform
          test_points<kBatch>(g, win, ci, bi, s_mask, s_tab, s_unit, s_thr, s_f, best, best_i,
                              dmin);
        } else {
          test_points<1>(g, win, ci, bi, s_mask, s_tab, s_unit, s_thr, s_f, best, best_i, dmin);
        }
      }

      // --- warp reduce-scatter: lane l ends with level slot l's warp
      // minimum, which it merges into its own shared slot ---
      scatter_round<16>(best, best_i, lane);
      scatter_round<8>(best, best_i, lane);
      scatter_round<4>(best, best_i, lane);
      scatter_round<2>(best, best_i, lane);
      scatter_round<1>(best, best_i, lane);
      for (int o = 16; o >= 1; o /= 2) dmin = fminf(dmin, __shfl_xor_sync(0xffffffffu, dmin, o));
      float v = s_acc_v[warp][lane];
      int i = s_acc_i[warp][lane];
      take_min(v, i, best[0], best_i[0]);
      s_acc_v[warp][lane] = v;
      s_acc_i[warp][lane] = i;
      if (lane == 0) s_dmin[warp] = fminf(s_dmin[warp], dmin);
    }
    __syncthreads();
    const int nvalid = min(kMaxLevels, M - m0);  // the chunk's levels, sorted first
    if (tid < nvalid) {
      float v = s_acc_v[0][tid];
      int i = s_acc_i[0][tid];
      for (int k = 1; k < kWarps; ++k) take_min(v, i, s_acc_v[k][tid], s_acc_i[k][tid]);
      s_res_v[tid] = v;
      s_res_i[tid] = i;
    }
    if (tid == kThreads - 1) {
      float dm = s_dmin[0];
      for (int k = 1; k < kWarps; ++k) dm = fminf(dm, s_dmin[k]);
      s_res_dmin = dm;
    }
    if (split > 1) {
      cluster.sync();  // every rank's result is in its shared memory
    } else {
      __syncthreads();
    }

    // --- rank 0 merges the ranks and writes the chunk's levels ---
    if (rank == 0 && tid < nvalid) {
      float v = s_res_v[tid];
      int i = s_res_i[tid];
      float dm = s_res_dmin;
      for (int q = 1; q < split; ++q) {
        take_min(v, i, *cluster.map_shared_rank(&s_res_v[tid], q),
                 *cluster.map_shared_rank(&s_res_i[tid], q));
        dm = fminf(dm, *cluster.map_shared_rank(&s_res_dmin, q));
      }
      const float f = s_f[tid];
      const bool any = dm <= s_thr[tid];
      if (!any) {  // nothing meets timing: the nominal corner
        const Terms tm(smem + lay.terms, D, T);
        float dyn = tm.nom_dyn[0], stat = tm.nom_stat[0];
        for (int k = 1; k < T; ++k) {
          dyn = __fadd_rn(dyn, tm.nom_dyn[k]);
          stat = __fadd_rn(stat, tm.nom_stat[k]);
        }
        i = G - 1;
        v = __fadd_rn(__fmul_rn(dyn, f), stat);
      }
      const size_t o = (static_cast<size_t>(p) * a.R + r) * M + m0 + s_perm[tid];
      a.v_core[o] = core[i / B];
      a.v_bram[o] = bram[i % B];
      a.power[o] = v;
      a.feasible[o] = static_cast<unsigned char>(any);
    }
    if (split > 1) {
      cluster.sync();  // rank 0 is done reading the others before they move on
    } else if (m0 + kMaxLevels < M) {
      __syncthreads();  // the chunk's levels are read before the next chunk's
    }
  }
}

// Entries a table row needs for any `window` consecutive flat points: the
// core rows they touch, or their bram columns.
long long table_width(long long window, int B) {
  return std::max((window + B - 2) / B + 1, std::min<long long>(B, window));
}

struct Plan {
  int split, range, window, width;  // split 0: the terms alone exceed kSmemBudget
};

// The launch for P platforms × R rows over a C × B grid with D delay and T
// power terms on a card of `sms` SMs (see Design).
Plan make_plan(int P, int R, int C, int B, int D, int T, int sms) {
  const long long G = static_cast<long long>(C) * B;
  const long long resident = static_cast<long long>(kBlocksPerSm) * sms;
  const int split = static_cast<int>(std::min<long long>(
      {kMaxSplit, std::max(1LL, resident / (static_cast<long long>(P) * R)),
       std::max(1LL, G / kMinRankPoints)}));
  const long long range = (G + split - 1) / split;
  auto fits = [&](long long n) {
    return smem_layout(D, T, C, B, static_cast<int>(table_width(n, B)), static_cast<int>(n))
               .total <= static_cast<size_t>(kSmemBudget);
  };
  if (!fits(1)) return {0, 0, 0, 0};
  long long lo = 1, hi = range;  // the largest window that fits
  while (lo < hi) {
    const long long mid = lo + (hi - lo + 1) / 2;
    if (fits(mid)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return {split, static_cast<int>(range), static_cast<int>(lo),
          static_cast<int>(table_width(lo, B))};
}

cudaError_t launch(const Args& args, int P, int split, void* stream) {
  const size_t smem = smem_layout(args.D, args.T, args.C, args.B, args.width, args.window).total;
  auto kernel = grid_argmin_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, args.R, P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

}  // namespace

// Launches on `stream` without synchronizing; returns the launch's CUDA error
// as an int (0 on success; cudaErrorInvalidValue when the platform's terms
// alone exceed the shared-memory budget).  `sms` is the card's SM count, from
// which make_plan sizes the launch.
extern "C" int grid_argmin_launch(
    const float* dl_weight, const float* dl_vth, const float* dl_alpha,
    const float* dl_v0, const int* dl_rail, const int* delay_mode,
    const int* pw_rail, const float* pw_v0, const float* pw_dyn,
    const float* pw_stat, const float* pw_kappa, const unsigned char* mask,
    const float* levels, const float* core_grid, const float* bram_grid,
    float* v_core, float* v_bram, float* power, unsigned char* feasible, int P,
    int R, int M, int C, int B, int D, int T, float thr_scale, int sms, void* stream) {
  const Plan plan = sms < 1 ? Plan{0, 0, 0, 0} : make_plan(P, R, C, B, D, T, sms);
  if (plan.split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args args = {dl_weight, dl_vth, dl_alpha, dl_v0, dl_rail, delay_mode,
                     pw_rail, pw_v0, pw_dyn, pw_stat, pw_kappa, mask, levels,
                     core_grid, bram_grid, v_core, v_bram, power, feasible,
                     R, M, C, B, D, T, thr_scale, plan.range, plan.window, plan.width};
  const cudaError_t err = launch(args, P, plan.split, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
