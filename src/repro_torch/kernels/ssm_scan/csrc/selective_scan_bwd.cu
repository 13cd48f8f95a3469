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
// kChunk).  δ, x and dy may start at any address.  Any S ≥ 1, D ≥ 1 and 1 ≤ N ≤ 16.
//
// What bounds it on an H100.  At the serving shape (b = 4, S = 2048, D = 8192, N = 16)
// it moves 1481.6 MB (δ, x, dy, B, C, A_log, the boundaries and dh read once, dδ, dx, dB,
// dC, dA_log written once): 0.4423 ms at 3.35 TB/s.  The least work takes one exponential
// a state element (1.074 G, 0.2568 ms on the SFUs at 16 a clock per SM and 1.98 GHz) and
// some 22 fp32 operations (0.35 ms at 67 TFLOP/s), so bytes bound it (chip_smoke.py's
// phase 7b computes this bound).  This kernel takes 1.875 exponentials an element (below),
// 2.01 G, 0.48 ms on the SFUs; the state's serial chain in time is what a design has to
// hide, since each step of each channel depends on the one before.
//
// Design.
// 1. Lanes and channels.  A thread keeps kStatesPerLane = 8 states (n ∈ [8g, 8g + 8) for
//    lane g of a lane pair, as in the forward) of kPair = 2 channels, c and
//    c + kChannels/2, with their g_t, A·log2(e) and dA sums in registers: 16 independent
//    chains a thread.  A block is kChannels = 128 channels of one batch row in kThreads =
//    128 threads (4 warps); the grid ⌈D/128⌉ × b.  Each decay is one ex2.approx.ftz of
//    δ·A·log2(e), as in the forward, so the recomputed states are the forward's bit for bit.
// 2. Whole waves.  At the serving shape the grid is 64 × 4 = 256 blocks, and an SM holds
//    kMinBlocks = 2 (256 threads, up to 255 registers a thread; the shared memory below,
//    106,560 bytes a block + 1 KB reserved, 215,168 of the SM's 233,472, with the largest
//    shared-memory carveout): 264 places on 132 SMs, so every block is resident at once,
//    one wave.  ptxas's report (build.log) must show 0 spill bytes.  (64-channel blocks,
//    four an SM, 512 blocks, run 1.7 % slower: PERF.md.)
// 3. Chunks in reverse, states recomputed in sub-chunks, each decay kept.  For each
//    kChunk-step chunk, last first, the block walks forward from its stored start (zero
//    for the first chunk) to the start of its last kSub-step sub-chunk, keeping each
//    sub-chunk's start in shared memory (sb); then for each sub-chunk, last first, it
//    recomputes its kSub states, keeping their decays a_t in registers and all but the
//    last state in shared memory (hs), and walks them back.  Exponentials: 28 of a full
//    chunk's 32 steps in the first walk and 32 in the recompute, 1.875 an element; the
//    walk back takes none.  Each thread reads only the states it wrote (no barrier).
// 4. Inputs staged ahead.  Time is cut into units of kSub rows, consumed in a fixed order
//    (per chunk: the forward walk's units, then the sub-chunks' units last first), through
//    a ring of kStages stages: the block's window of δ, x and dy (kSub rows of kChannels
//    channels, copied raw with 16-byte cp.async, LDGSTS, as the forward copies δ and x:
//    a row copied from the 16-byte boundary at or below its start, read at its shift, cut
//    at its end), and B and C as fp32 [kSub][16], zero past N and S.  While a unit is
//    walked the next kStages − 1 are in flight; one barrier a unit.  The kFast
//    instantiation (rows of δ, x, dy and B, C on 16-byte boundaries, N = 16) has each
//    thread issue one 16-byte copy of each array, offsets by shifts; the other copies rows
//    at their shifts and B, C 4 bytes at a time.  No load from device memory sits inside a
//    serial step loop: the boundary states are read once a chunk, after an L2 prefetch a
//    chunk ahead.  A sub-chunk of kSub steps (all but a ragged end) runs unguarded, so the
//    compiler schedules its steps together.
// 5. Deterministic sums, fewer shuffles.  dx and dδ: the 4 sums of a thread (Σ g·B and
//    Σ g·A′·a·h_{t−1} for its 2 channels) are reduce-scattered over the lane pair with 2
//    shuffles, and lane g stores channel g's dx = δ·Σ g·B and dδ = x·Σ g·B +
//    ln2·Σ g·A′·a·h_{t−1}.  dB and dC: a thread adds its 2 channels in registers (g·u
//    of channel c, then + that of c + kChannels/2; dy·h likewise), then the warp
//    reduce-scatters the 16 values (dB and dC of its 8 states) over its 16 lane pairs,
//    lanes 16, 8, 4, 2 apart: 15 shuffles leave lane (p, g) with state 8g + (p & 7) of dB
//    (p < 8) or dC over the warp's 32 channels, 0.94 shuffles a state element where the
//    first kernel took 2.25.  The warps' sums go to shared memory (double-buffered by
//    sub-chunk) and are added in warp order after the next barrier, one partial per
//    (block, batch row, t, n): 64 blocks' partials at the serving shape, 134 MB of dB and
//    dC partials written and read back, half the first kernel's 268 MB.  dA is summed over
//    time in registers, one partial per (batch row, d, n).  A second kernel adds the
//    partials in block order (dB, dC) and batch order (dA_log, times A).  No atomics: two
//    launches give the same bits.
//
// Rounding.  Built without --use_fast_math; the one approximate instruction is ex2, as in
// the forward.  Sums run in other orders than the plain version's, and A·a·h_{t−1} is
// summed as ln2·Σ g·(A·log2(e))·a·h_{t−1}, so results agree with it to about 1e-6 of each
// gradient's largest magnitude in fp32, not bit for bit (tests/test_torch_ssm_backward.py
// models this arithmetic on the CPU).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The design's sizes (scripts/scan_bwd_variants.py rebuilds a copy of this source with
// kChannels, kMinBlocks and kStages changed; PERF.md has the times).
constexpr int kMaxN = 16;        // largest state size the kernel takes
constexpr int kLanes = 2;        // lanes per channel (the forward's)
constexpr int kPair = 2;         // channels a thread keeps: c and c + kChannels / 2
constexpr int kChannels = 128;   // channels per block
constexpr int kMinBlocks = 2;    // blocks an SM holds: 256 at the serving shape, one wave
constexpr int kChunk = 32;       // steps between stored states: selective_scan.cu's kChunk
constexpr int kSub = 4;          // steps whose decays a thread holds at once (a ring unit)
constexpr int kStages = 3;       // ring depth in units
constexpr int kStatesPerLane = kMaxN / kLanes;
constexpr int kElems = kPair * kStatesPerLane;          // state elements a thread keeps
constexpr int kThreads = kChannels * kLanes / kPair;
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerWarp = 32 / kLanes;
constexpr int kHalf = kChannels / kPair;                // channel c's partner: c + kHalf
constexpr int kSubs = kChunk / kSub;
constexpr int kRowCopies = kChannels / 4;                // 16-byte copies of a full row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kLanes == 2 && kPair == 2 && kStatesPerLane == 8,
              "the sums assume 2 lanes of 8 states and 2 channels a thread");
static_assert(2 * kStatesPerLane == kPairsPerWarp,
              "the dB, dC reduce-scatter gives each lane one of a warp's 16 values");
static_assert(kThreads % 32 == 0 && kThreads * kMinBlocks <= 256,
              "whole warps, up to 255 registers a thread");
static_assert(kChunk % kSub == 0 && kSubs >= 2, "a chunk holds whole sub-chunks");
static_assert(kStages >= 2, "the ring needs two stages to overlap");
static_assert(kThreads == kSub * kRowCopies && kThreads >= 2 * kSub * kMaxN / 4,
              "a thread copies one 16-byte unit of each array of a unit, and of B or C");

// One block's ring: a stage holds one unit, kSub rows.  A δ, x or dy row holds kChannels
// channels plus up to 15 bytes of shift.
struct alignas(16) Ring {
  static constexpr int kRowBytes = kChannels * 4 + 16;
  static constexpr int kUnits = kRowBytes / 16;  // 16-byte copies a row can need
  unsigned char rows[kStages][3][kSub][kRowBytes];  // raw δ (0), x (1), dy (2)
  float bc[kStages][2][kSub][kMaxN];                // B (0) and C (1), fp32, zero-padded
};

struct Smem {
  Ring ring;
  float4 sb[kSubs - 1][kElems / 4][kThreads];  // the state before sub-chunk j = 1..kSubs−1
  float4 hs[kSub - 1][kElems / 4][kThreads];   // a sub-chunk's recomputed states, all but its last
  float red[2][kSub][kWarps][2 * kMaxN];        // a warp's dB (q = 0) and dC (q = 1) sums
};

static_assert(kMinBlocks * (sizeof(Smem) + 1024) <= 233472,
              "kMinBlocks blocks' shared memory fits an SM's 228 KB");

// `upper ? a : b`, kept a select in registers: a select between two elements of a
// register array may otherwise become an indexed load from local memory.
__device__ __forceinline__ float pick(int upper, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n selp.f32 %0, %2, %3, p;\n}"
      : "=f"(r) : "r"(upper), "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte async copy global → shared; bytes past `src_bytes` (0..16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}
// 4-byte async copy global → shared; zero-filled when `src_bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The low 32 bits of p's address: their low four bits are the shift of the row starting
// at p in its ring row.
__device__ __forceinline__ uint32_t addr_bits(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
}

// Copy unit u of the row of `live` floats at `first` into its ring row: the row's copies
// start at the 16-byte boundary at or below `first`, and the last is cut at the row's end
// (zero-filled).  selective_scan.cu's copy_unit, for fp32.
__device__ __forceinline__ void copy_unit(unsigned char* row, const float* first, int live,
                                          int u) {
  const uintptr_t begin = reinterpret_cast<uintptr_t>(first);
  const uintptr_t end = begin + static_cast<uintptr_t>(live) * sizeof(float);
  const uintptr_t src = (begin & ~static_cast<uintptr_t>(15)) + 16 * static_cast<uintptr_t>(u);
  if (src < end)
    cp_async16(row + 16 * u, reinterpret_cast<const void*>(src),
               end - src < 16 ? static_cast<int>(end - src) : 16);
}

// Unit u of the block's sequence: chunk k, sub-chunk j, and whether it is walked back
// (else it is a step of the chunk's forward walk).  The last chunk (processed first) has
// `last_subs` sub-chunks, every other chunk kSubs; a chunk of s sub-chunks is 2s − 1
// units: its forward walk's s − 1, then its s sub-chunks last first.
struct Unit {
  int k, j;
  bool back;
};

__device__ __forceinline__ Unit unit_at(int u, int chunks, int last_subs) {
  const int first = 2 * last_subs - 1;
  if (u < first)
    return u < last_subs - 1 ? Unit{chunks - 1, u, false}
                             : Unit{chunks - 1, 2 * last_subs - 2 - u, true};
  constexpr unsigned kPer = 2 * kSubs - 1;
  const unsigned v = u - first;
  const int k = chunks - 2 - static_cast<int>(v / kPer), r = static_cast<int>(v % kPer);
  return r < kSubs - 1 ? Unit{k, r, false} : Unit{k, 2 * kSubs - 2 - r, true};
}

struct Args {
  const float* delta;
  const float* Bm;
  const float* Cm;
  const float* x;
  const float* boundary;
  const float* dy;
  float* ddelta;
  float* dx;
  float* dB_part;
  float* dC_part;
  long long t_row;  // the batch row's first row of the flattened [b·S, D]
  long long row;
  int S, D, N, d0, live, chunks;
};

// Issue the copies of unit `un` into stage `st`: δ and x of its rows, dy too for a
// walk-back unit, and B and C.  kFast: every row of δ, x and dy starts on a 16-byte
// boundary (so D is a multiple of 4, and so is the block's `live`), N = kMaxN, and B and
// C start on 16-byte boundaries: whole 16-byte copies, no shift, indices by shifts.
template <bool kFast>
__device__ __forceinline__ void load_unit(Ring& ring, int st, const Unit& un, const Args& a) {
  const int t = un.k * kChunk + un.j * kSub;
  const int rows = min(kSub, a.S - t);
  const long long e0 = (a.t_row + t) * a.D + a.d0;
  const unsigned tid = threadIdx.x;
  if constexpr (kFast) {
    // Thread tid copies 16-byte unit u of row r of each array.
    const unsigned r = tid / kRowCopies, u = tid % kRowCopies;
    if (static_cast<int>(r) < rows && static_cast<int>(4 * u) < a.live) {
      const long long e = e0 + r * static_cast<long long>(a.D) + 4 * u;
      cp_async16(&ring.rows[st][0][r][16 * u], a.delta + e, 16);
      cp_async16(&ring.rows[st][1][r][16 * u], a.x + e, 16);
      if (un.back) cp_async16(&ring.rows[st][2][r][16 * u], a.dy + e, 16);
    }
    constexpr unsigned kBcCopies = kSub * kMaxN / 4;             // of B, and of C
    if (tid < 2 * kBcCopies) {
      const unsigned q = tid / kBcCopies, u = tid % kBcCopies;
      const bool ok = static_cast<int>(4 * u / kMaxN) < rows;
      const float* src = (q == 0 ? a.Bm : a.Cm) + (a.t_row + t) * kMaxN;
      cp_async16(&ring.bc[st][q][0][4 * u], ok ? src + 4 * u : src, ok ? 16 : 0);
    }
  } else {
    const int copies = (un.back ? 3 : 2) * rows * Ring::kUnits;
    for (int i = tid; i < copies; i += kThreads) {
      const int q = i / (rows * Ring::kUnits), rem = i - q * (rows * Ring::kUnits);
      const int r = rem / Ring::kUnits, u = rem - r * Ring::kUnits;
      const float* src = q == 0 ? a.delta : q == 1 ? a.x : a.dy;
      copy_unit(ring.rows[st][q][r], src + e0 + static_cast<long long>(r) * a.D, a.live, u);
    }
    for (int i = tid; i < 2 * kSub * kMaxN; i += kThreads) {
      const int q = i / (kSub * kMaxN), r = (i / kMaxN) % kSub, n = i % kMaxN;
      const bool ok = r < rows && n < a.N;
      const float* src = q == 0 ? a.Bm : a.Cm;
      cp_async4(&ring.bc[st][q][r][n], ok ? src + (a.t_row + t + r) * a.N + n : src,
                ok ? 4 : 0);
    }
  }
}

// Channel c's value in row s of array q (δ 0, x 1, dy 2) of stage st; `off` is
// addr_bits of the unit's first row of that array.
template <bool kFast>
__device__ __forceinline__ float ring_val(const Ring& ring, int st, int q, int s, uint32_t off,
                                          uint32_t row_bytes, int c) {
  const uint32_t shift = kFast ? 0u : (off + s * row_bytes) & 15u;
  return *reinterpret_cast<const float*>(&ring.rows[st][q][s][0] + shift + 4 * c);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kStatesPerLane]) {
#pragma unroll
  for (int i = 0; i < kStatesPerLane; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

__device__ __forceinline__ void put_states(float4 (&dst)[kElems / 4][kThreads],
                                           const float (&h)[kPair][kStatesPerLane]) {
#pragma unroll
  for (int j = 0; j < kPair; ++j)
#pragma unroll
    for (int i = 0; i < kStatesPerLane; i += 4)
      dst[(j * kStatesPerLane + i) / 4][threadIdx.x] =
          make_float4(h[j][i], h[j][i + 1], h[j][i + 2], h[j][i + 3]);
}

__device__ __forceinline__ void get_states(const float4 (&src)[kElems / 4][kThreads],
                                           float (&h)[kPair][kStatesPerLane]) {
#pragma unroll
  for (int j = 0; j < kPair; ++j)
#pragma unroll
    for (int i = 0; i < kStatesPerLane; i += 4) {
      const float4 q = src[(j * kStatesPerLane + i) / 4][threadIdx.x];
      h[j][i] = q.x; h[j][i + 1] = q.y; h[j][i + 2] = q.z; h[j][i + 3] = q.w;
    }
}

// The state at the start of chunk k: the stored boundary of chunk k − 1, zero for k = 0.
template <bool kFast>
__device__ __forceinline__ void chunk_start(float (&h)[kPair][kStatesPerLane], const Args& a,
                                            int k, const int (&d)[kPair], int g) {
#pragma unroll
  for (int j = 0; j < kPair; ++j) {
    const float* p = a.boundary + ((a.row * a.chunks + max(k, 1) - 1) * a.D + d[j]) * a.N +
                     g * kStatesPerLane;
    if constexpr (kFast) {   // N = 16: the lane's 8 states, 16-byte aligned
#pragma unroll
      for (int i = 0; i < kStatesPerLane; i += 4) {
        const float4 q = k > 0 ? *reinterpret_cast<const float4*>(p + i)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        h[j][i] = q.x; h[j][i + 1] = q.y; h[j][i + 2] = q.z; h[j][i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStatesPerLane; ++i)
        h[j][i] = k > 0 && g * kStatesPerLane + i < a.N ? p[i] : 0.0f;
    }
  }
}

// The warps' dB, dC sums of a walked-back sub-chunk (r steps from t), added in warp order.
__device__ __forceinline__ void flush(const Smem& sm, int buf, int t, int r, const Args& a,
                                      long long part_row) {
  constexpr int kEntries = kSub * 2 * kMaxN;
#pragma unroll
  for (int m = 0; m < (kEntries + kThreads - 1) / kThreads; ++m) {
    const unsigned i = threadIdx.x + m * kThreads;
    const unsigned s = i / (2 * kMaxN), qn = i % (2 * kMaxN), n = qn % kMaxN;
    if (static_cast<int>(s) < r && static_cast<int>(n) < a.N) {
      float v = sm.red[buf][s][0][qn];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += sm.red[buf][s][w][qn];
      (qn < kMaxN ? a.dB_part : a.dC_part)[(part_row + t + s) * a.N + n] = v;
    }
  }
}

// One level of the dB, dC reduce-scatter: values [0, O) and [O, 2O) of lanes 2·O apart;
// the lane whose pair index has bit O (`upper`) keeps the upper half.
template <int O>
__device__ __forceinline__ void scatter_level(float (&pv)[2 * kStatesPerLane], int upper) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float keep = pick(upper, pv[i + O], pv[i]);
    const float send = pick(upper, pv[i], pv[i + O]);
    pv[i] = keep + __shfl_xor_sync(0xffffffffu, send, O * kLanes);
  }
}

// Wait for unit u, free the stage of unit u − 1, add the sums pending from the last
// sub-chunk walked back (in red's buffer (nsub − 1) & 1), and start the copies of unit
// u + kStages − 1; returns unit u's stage and moves u on.
template <bool kFast>
__device__ __forceinline__ int advance(Smem& sm, const Args& a, int& u, int units,
                                       int last_subs, int pend_t, int& pend_r, int nsub,
                                       long long part_row) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (pend_r > 0) flush(sm, (nsub - 1) & 1, pend_t, pend_r, a, part_row);
  pend_r = 0;
  const int un = u + kStages - 1;
  if (un < units) load_unit<kFast>(sm.ring, un % kStages, unit_at(un, a.chunks, last_subs), a);
  cp_async_commit();
  return u++ % kStages;
}

// Recompute the r ≤ kSub states and decays of the sub-chunk at step ts (h holds the state
// before it), then walk them back: g_t, dx, dδ and dA, and the warp's dB, dC sums into
// red[buf].  kFull: r = kSub, no step guarded.
template <bool kFast, bool kFull>
__device__ __forceinline__ void sub_chunk(
    Smem& sm, const Args& a, int st, int ts, int r, int j, int k, int buf, uint32_t od,
    uint32_t ox, uint32_t oy, uint32_t row_bytes, int g, int pl, int warp,
    const int (&d)[kPair], const int (&col)[kPair], const bool (&valid)[kPair],
    const float (&A2)[kPair][kStatesPerLane], float (&G)[kPair][kStatesPerLane],
    float (&dA)[kPair][kStatesPerLane], float (&h)[kPair][kStatesPerLane]) {
  float av[kSub][kPair][kStatesPerLane];   // the decays a_t of the sub-chunk
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    if (kFull || s < r) {
      float bv[kStatesPerLane];
      load8(&sm.ring.bc[st][0][s][g * kStatesPerLane], bv);
#pragma unroll
      for (int j2 = 0; j2 < kPair; ++j2) {
        const float dt = ring_val<kFast>(sm.ring, st, 0, s, od, row_bytes, col[j2]);
        const float du = dt * ring_val<kFast>(sm.ring, st, 1, s, ox, row_bytes, col[j2]);
#pragma unroll
        for (int i = 0; i < kStatesPerLane; ++i) {
          av[s][j2][i] = ex2(dt * A2[j2][i]);
          h[j2][i] = fmaf(av[s][j2][i], h[j2][i], du * bv[i]);
        }
      }
      if (s + 1 < (kFull ? kSub : r)) put_states(sm.hs[s], h);
    }
  }

  // h is now h_t of the sub-chunk's last step; walk back to its first.  Lane g stores
  // channel g's dx and dδ.
  const bool store = g == 0 ? valid[0] : valid[1];
  const long long e_g = (a.t_row + ts) * a.D + a.d0 + (g == 0 ? col[0] : col[1]);
#pragma unroll
  for (int s = kSub - 1; s >= 0; --s) {
    if (kFull || s < r) {
      float hp[kPair][kStatesPerLane];   // h_{t−1}
      if (s > 0) get_states(sm.hs[s - 1], hp);
      else if (j > 0) get_states(sm.sb[j - 1], hp);
      else chunk_start<kFast>(hp, a, k, d, g);
      float bv[kStatesPerLane], cv[kStatesPerLane];
      load8(&sm.ring.bc[st][0][s][g * kStatesPerLane], bv);
      load8(&sm.ring.bc[st][1][s][g * kStatesPerLane], cv);
      float dt[kPair], xv[kPair], sums[2 * kPair];
      float vb[kStatesPerLane], vc[kStatesPerLane];
#pragma unroll
      for (int j2 = 0; j2 < kPair; ++j2) {
        dt[j2] = ring_val<kFast>(sm.ring, st, 0, s, od, row_bytes, col[j2]);
        xv[j2] = ring_val<kFast>(sm.ring, st, 1, s, ox, row_bytes, col[j2]);
        const float dyv = ring_val<kFast>(sm.ring, st, 2, s, oy, row_bytes, col[j2]);
        const float du = valid[j2] ? dt[j2] * xv[j2] : 0.0f;
        const float dym = valid[j2] ? dyv : 0.0f;
        float sx = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int i = 0; i < kStatesPerLane; ++i) {
          const float gi = fmaf(dyv, cv[i], G[j2][i]);
          sx = fmaf(gi, bv[i], sx);
          const float w = gi * (av[s][j2][i] * hp[j2][i]);
          s1 = fmaf(w, A2[j2][i], s1);
          dA[j2][i] = fmaf(w, dt[j2], dA[j2][i]);
          vb[i] = j2 == 0 ? gi * du : fmaf(gi, du, vb[i]);
          vc[i] = j2 == 0 ? dym * h[j2][i] : fmaf(dym, h[j2][i], vc[i]);
          G[j2][i] = av[s][j2][i] * gi;
        }
        sums[2 * j2] = sx;
        sums[2 * j2 + 1] = s1;
      }
      // dx, dδ: reduce-scatter over the lane pair, lane g keeps channel g's sums.
      float v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float keep = pick(g, sums[i + 2], sums[i]);
        const float send = pick(g, sums[i], sums[i + 2]);
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      const float dtg = pick(g, dt[1], dt[0]), xg = pick(g, xv[1], xv[0]);
      if (store) {
        a.dx[e_g + s * static_cast<long long>(a.D)] = dtg * v[0];
        a.ddelta[e_g + s * static_cast<long long>(a.D)] = fmaf(xg, v[0], kLn2 * v[1]);
      }
      // dB, dC: reduce-scatter of the 16 values over the warp's 16 lane pairs.
      float pv[2 * kStatesPerLane];
#pragma unroll
      for (int i = 0; i < kStatesPerLane; ++i) {
        pv[i] = vb[i];
        pv[kStatesPerLane + i] = vc[i];
      }
      scatter_level<8>(pv, pl & 8);
      scatter_level<4>(pv, pl & 4);
      scatter_level<2>(pv, pl & 2);
      scatter_level<1>(pv, pl & 1);
      sm.red[buf][s][warp][(pl / kStatesPerLane) * kMaxN + g * kStatesPerLane +
                           pl % kStatesPerLane] = pv[0];
#pragma unroll
      for (int j2 = 0; j2 < kPair; ++j2)
#pragma unroll
        for (int i = 0; i < kStatesPerLane; ++i) h[j2][i] = hp[j2][i];
    }
  }
}

template <bool kFast>
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
  const int g = tid % kLanes, p = tid / kLanes;   // lane in its pair, pair in the block
  const int pl = p % kPairsPerWarp, warp = tid / 32;
  Args a;
  a.delta = delta; a.Bm = Bm; a.Cm = Cm; a.x = x; a.boundary = boundary; a.dy = dy;
  a.ddelta = ddelta; a.dx = dx; a.dB_part = dB_part; a.dC_part = dC_part;
  a.row = blockIdx.y;
  a.t_row = a.row * S;
  a.S = S; a.D = D; a.N = N;
  a.d0 = blockIdx.x * kChannels;
  a.live = min(kChannels, D - a.d0);
  a.chunks = (S + kChunk - 1) / kChunk;
  const long long part_row = (static_cast<long long>(blockIdx.x) * gridDim.y + a.row) * S;
  const int last_subs = (S - (a.chunks - 1) * kChunk + kSub - 1) / kSub;
  const int units = 2 * last_subs - 1 + (a.chunks - 1) * (2 * kSubs - 1);
  const uint32_t row_bytes = static_cast<uint32_t>(D) * 4u;

  // Channel j of this thread: column col[j] of the block's window (channels past D
  // recompute channel D − 1 and store nothing).
  int col[kPair], d[kPair];
  bool valid[kPair];
#pragma unroll
  for (int j = 0; j < kPair; ++j) {
    const int c = p + j * kHalf;
    valid[j] = c < a.live;
    col[j] = valid[j] ? c : a.live - 1;
    d[j] = a.d0 + col[j];
  }

  float A2[kPair][kStatesPerLane], G[kPair][kStatesPerLane], dA[kPair][kStatesPerLane];
#pragma unroll
  for (int j = 0; j < kPair; ++j)
#pragma unroll
    for (int i = 0; i < kStatesPerLane; ++i) {
      const int n = g * kStatesPerLane + i;
      A2[j][i] = n < N ? -expf(A_log[static_cast<long long>(d[j]) * N + n]) * kLog2e : 0.0f;
      G[j][i] = dh != nullptr && n < N ? dh[(a.row * D + d[j]) * N + n] : 0.0f;  // a·g ahead
      dA[j][i] = 0.0f;
    }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < units) load_unit<kFast>(sm.ring, i, unit_at(i, a.chunks, last_subs), a);
    cp_async_commit();
  }
  int u = 0;                       // the next unit to walk
  int pend_t = 0, pend_r = 0;      // a walked-back sub-chunk whose sums wait in red
  int nsub = 0;                    // sub-chunks walked back so far (red's buffer parity)

  for (int k = a.chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, S - t0);
    const int subs = (len + kSub - 1) / kSub;
    if (k >= 2 && g * kStatesPerLane < N) {
#pragma unroll
      for (int j = 0; j < kPair; ++j)
        prefetch_l2(boundary + ((a.row * a.chunks + k - 2) * D + d[j]) * N + g * kStatesPerLane);
    }

    // Forward from the chunk's stored start to its last sub-chunk, keeping each start.
    float h[kPair][kStatesPerLane];
    chunk_start<kFast>(h, a, k, d, g);
    for (int j = 0; j + 1 < subs; ++j) {
      const int st = advance<kFast>(sm, a, u, units, last_subs, pend_t, pend_r, nsub, part_row);
      if (j > 0) put_states(sm.sb[j - 1], h);
      const long long e0 = (a.t_row + t0 + j * kSub) * D + a.d0;
      const uint32_t od = addr_bits(delta + e0), ox = addr_bits(x + e0);
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        float bv[kStatesPerLane];
        load8(&sm.ring.bc[st][0][s][g * kStatesPerLane], bv);
#pragma unroll
        for (int j2 = 0; j2 < kPair; ++j2) {
          const float dt = ring_val<kFast>(sm.ring, st, 0, s, od, row_bytes, col[j2]);
          const float du = dt * ring_val<kFast>(sm.ring, st, 1, s, ox, row_bytes, col[j2]);
#pragma unroll
          for (int i = 0; i < kStatesPerLane; ++i)
            h[j2][i] = fmaf(ex2(dt * A2[j2][i]), h[j2][i], du * bv[i]);
        }
      }
    }
    if (subs > 1) put_states(sm.sb[subs - 2], h);

    // Sub-chunks, last first: recompute their states and decays, then walk them back.
    for (int j = subs - 1; j >= 0; --j) {
      const int st = advance<kFast>(sm, a, u, units, last_subs, pend_t, pend_r, nsub, part_row);
      const int ts = t0 + j * kSub;
      const int r = min(kSub, len - j * kSub);
      const long long e0 = (a.t_row + ts) * D + a.d0;
      const uint32_t od = addr_bits(delta + e0), ox = addr_bits(x + e0),
                     oy = addr_bits(dy + e0);
      if (j > 0) get_states(sm.sb[j - 1], h);
      else chunk_start<kFast>(h, a, k, d, g);

      const int buf = nsub & 1;
      if (r == kSub)
        sub_chunk<kFast, true>(sm, a, st, ts, r, j, k, buf, od, ox, oy, row_bytes, g, pl, warp, d,
                               col, valid, A2, G, dA, h);
      else
        sub_chunk<kFast, false>(sm, a, st, ts, r, j, k, buf, od, ox, oy, row_bytes, g, pl, warp,
                                d, col, valid, A2, G, dA, h);
      pend_t = ts;
      pend_r = r;
      ++nsub;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pend_r > 0) flush(sm, (nsub - 1) & 1, pend_t, pend_r, a, part_row);

#pragma unroll
  for (int j = 0; j < kPair; ++j) {
    if (!valid[j]) continue;
#pragma unroll
    for (int i = 0; i < kStatesPerLane; ++i) {
      const int n = g * kStatesPerLane + i;
      if (n < N) dA_part[(a.row * D + d[j]) * N + n] = dA[j][i];
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

// Opt in to the block's dynamic shared memory, and ask for the largest shared-memory
// carveout, so that kMinBlocks blocks fit an SM.
template <typename K>
cudaError_t configure(K kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

}  // namespace

// Blocks of the backward kernel an SM holds at once (the kFast instantiation if `fast`),
// as the occupancy calculator gives them; negative: the cudaError_t.
extern "C" int selective_scan_bwd_blocks_per_sm(int fast) {
  auto kernel = fast ? selective_scan_bwd_kernel<true> : selective_scan_bwd_kernel<false>;
  cudaError_t err = configure(kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, sizeof(Smem));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// All pointers are fp32; `dh` may be null (no gradient of h_final).  `dB_part`, `dC_part`
// ([⌈D/kChannels⌉, batch, S, N]) and `dA_part` ([batch, D, N]) are scratch the wrapper
// allocates (ops.BWD_CHANNELS is kChannels).  Returns the cudaError_t of the launches
// (0 on success); the wrapper has checked the shapes.
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
  // Every row of δ, x and dy starts on a 16-byte boundary (no shifts to read), N = 16,
  // and B, C and the boundary store start on 16-byte boundaries: whole 16-byte copies.
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool fast = D % 4 == 0 && N == kMaxN && al(delta) && al(x) && al(dy) && al(B) &&
                    al(C) && al(boundary);
  auto kernel = fast ? selective_scan_bwd_kernel<true> : selective_scan_bwd_kernel<false>;
  cudaError_t err = configure(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  kernel<<<dim3(blocks, batch), kThreads, sizeof(Smem), st>>>(
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
