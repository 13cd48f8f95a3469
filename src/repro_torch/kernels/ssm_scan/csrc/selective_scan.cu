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
// tensor is contiguous (the wrapper checks); δ and x may start at any address.
// Any S ≥ 1 and D ≥ 1 work, and 1 ≤ N ≤ 16.
//
// What bounds it on an H100.  At the serving shape (b = 4, S = 2048, D = 8192, N = 16,
// fp32) it takes 1.07 G exponentials, one per (b, t, d, n), and the special-function
// units (SFU) issue 16 of them per clock per SM: 0.257 ms at 132 SMs and 1.98 GHz.  It
// moves 809 MB (δ and x read once, y written once, B, C, A_log and h): 0.24 ms at
// 3.35 TB/s.  So the SFU bounds it and HBM is nearly as busy: the kernel nears its bound
// only if the exponentials keep the SFU fed while the next chunk streams in, and if the
// fp32 work around each exponential (at least δ·A′, du·B, the update and the dot
// product: 4 FMA-pipe instructions against the SFU's 8 clocks for a warp's 32
// exponentials) issues in the SFU's shadow.  Four steps of the design serve that.
//
// 1. States split across lanes.  The TPU kernel keeps a [block_d, N] state in VMEM and
//    carries it across a sequential grid axis of seq chunks; blocks on this card run in
//    no order, so time is a loop inside the block.  One thread per channel gives only
//    b·D threads (8 warps per SM at the serving shape), too few to hide the latency of
//    each step's chain.  Here kLanes (G) consecutive lanes share a channel (batch row,
//    d); lane g keeps the 16/G states n ∈ [g·16/G, (g+1)·16/G) and their rates in
//    registers (states past N have zero rate, B and C, so they stay 0), which gives G
//    times the warps.  Each lane's partial ⟨h, C⟩ over its states is summed across the
//    G lanes by a reduce-scatter over G consecutive steps: shuffles at lane distance
//    G/2, G/4, …, 1 halve the steps each lane carries, so lane g ends with y of step g
//    of the group, after G − 1 shuffles for G steps, and the group's G values go out in
//    one store.  The sum's order is that of a butterfly: lanes G/2 apart first.  A
//    block is 64 channels × G lanes; the grid ⌈D/64⌉ × b.  G = 2 is kept: 8 states a
//    lane, 16 warps per SM at 128 registers a thread.  G = 4 gives 31 warps but caps a
//    thread at 64 registers (spills) and adds shuffles; G = 1 and 8 are slower too
//    (PERF.md has the times).
// 2. Exponentials on the SFU.  A′ = −exp(A_log)·log2(e) is computed once per (d, n)
//    with the accurate expf; each step's decay is then one FMUL and one
//    `ex2.approx.ftz.f32` (MUFU.EX2), where the accurate expf of the earlier
//    one-thread-per-channel kernel issued about seven FMA-pipe instructions around
//    its ex2.
// 3. Chunk loads overlapped with the scan.  Time runs in chunks of kChunk steps
//    through a ring of kStages stages in shared memory.  Each stage holds the block's
//    window of δ and x (kChunk rows of 64 channels, copied raw with 16-byte `cp.async`,
//    LDGSTS) and the chunk's B and C as fp32 [kChunk][16] (zero past N and past S).
//    While a chunk is scanned, the δ/x copies of the chunk kStages − 1 ahead are in
//    flight, and the next chunk's B and C are in registers (plain loads issued before
//    the scan, stored to the ring after it).  One barrier per chunk.  A row of the
//    window starts at any address: its copy starts at the 16-byte boundary at or
//    below, so the row's data sits `shift` = (its address mod 16) bytes into its shared
//    row, where the reader finds it (δ and x each with their own shift; where both
//    start on 16-byte boundaries and D·sizeof(T) is a multiple of 16 every shift is 0,
//    and an instantiation of the kernel skips the arithmetic), and the last copy of a
//    row is cut at the row's end (zero-filled), so no byte past the block's channels is
//    read.  A block's channels past D read channel D − 1 and store nothing.
// 4. Register budget.  __launch_bounds__ asks for 4 blocks per SM (128 registers a
//    thread at G = 2), which holds all of the serving shape's 512 blocks on the card at
//    once; the ring is 42 KB a block in fp32.  ptxas's report (build.log) must show 0
//    spill bytes.
//
// At the serving shape the card reaches its power limit under this kernel and lowers
// its SM clock (1.8–1.9 GHz at 700 W), which lowers the SFU's rate with it.
//
// Rounding.  Built without --use_fast_math; the one approximate instruction is the
// explicit ex2.  ex2.approx.ftz.f32 has a relative error of about 2 ulp, and
// δ·A′ = (δ·A)·log2(e) carries one more rounding of the product (relative 2^-24 of an
// argument |δ·A| of a few units at most), so a decay differs from torch.exp(δ·A) by a few
// 1e-7 relative.  Flushing to zero changes only a decay below 2^-126, whose term in h is
// under 1e-37.  The dot product sums each lane's states in order (contracted into FMAs)
// and then the lanes in the butterfly's order, where the plain version leaves the order
// to einsum.  So results agree with the plain version to about 1e-6 relative in fp32,
// not bit for bit (tests/test_torch_ssm_scan_design.py models this arithmetic on the CPU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The design's sizes (PERF.md has the times of other values;
// scripts/scan_variants.py rebuilds a copy of this source with them changed).
constexpr int kMaxN = 16;        // largest state size the kernel takes
constexpr int kLanes = 2;        // lanes per channel (G)
constexpr int kStatesPerLane = kMaxN / kLanes;
constexpr int kChannels = 64;    // channels per block
constexpr int kThreads = kChannels * kLanes;
constexpr int kChunk = 32;       // time steps per ring stage
constexpr int kStages = 2;       // ring depth
// Blocks an SM must hold for the serving shape's b·⌈D/kChannels⌉ blocks to be resident at
// once (4 at 64 channels: 512 blocks on 132 SMs), as registers allow (1024 threads).
constexpr int kBlocksPerSm = 4 * 64 / kChannels;
constexpr int kMinBlocks = kThreads * kBlocksPerSm <= 1024 ? kBlocksPerSm : 1024 / kThreads;
constexpr int kBcSlots = (kChunk * kMaxN + kThreads - 1) / kThreads;  // B, C values a thread moves
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8,
              "lanes per channel: 1, 2, 4 or 8");
static_assert(kChunk % kLanes == 0, "a chunk holds whole reduce-scatter groups");
static_assert(kStages >= 2, "the ring needs two stages to overlap");

// One block's ring.  A δ or x row holds kChannels channels plus up to 15 bytes of shift.
template <typename T>
struct alignas(16) Ring {
  static constexpr int kRowBytes = kChannels * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kUnits = kRowBytes / 16;  // 16-byte copies a row can need
  unsigned char dx[kStages][2][kChunk][kRowBytes];  // raw δ (0) and x (1)
  float bc[kStages][2][kChunk][kMaxN];              // B (0) and C (1), fp32, zero-padded
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The low 32 bits of p's address: their low four bits are the shift of the row starting
// at p in its ring row.
__device__ __forceinline__ uint32_t addr_bits(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
}

// Copy unit u of the row of `live` elements at `first` into its ring row: the row's
// copies start at the 16-byte boundary at or below `first`, and the last is cut at the
// row's end (zero-filled).
template <typename T>
__device__ __forceinline__ void copy_unit(unsigned char* row, const T* first, int live,
                                          int u) {
  const uintptr_t begin = reinterpret_cast<uintptr_t>(first);
  const uintptr_t end = begin + static_cast<uintptr_t>(live) * sizeof(T);
  const uintptr_t src = (begin & ~static_cast<uintptr_t>(15)) + 16 * static_cast<uintptr_t>(u);
  if (src < end)
    cp_async16(row + 16 * u, reinterpret_cast<const void*>(src),
               end - src < 16 ? static_cast<int>(end - src) : 16);
}

// Issue the copies of rows [t, t + len) of the block's window of δ and x (`live`
// channels from d0) into stage `st`.  `t` counts rows of the flattened [b·S, D].
template <typename T>
__device__ __forceinline__ void load_dx(Ring<T>& ring, int st, const T* delta, const T* x,
                                        long long t, int len, int D, int d0, int live) {
  using R = Ring<T>;
  for (int i = threadIdx.x; i < len * R::kUnits; i += kThreads) {
    const int r = i / R::kUnits, u = i - r * R::kUnits;
    const long long e = (t + r) * D + d0;
    copy_unit(ring.dx[st][0][r], delta + e, live, u);
    copy_unit(ring.dx[st][1][r], x + e, live, u);
  }
}

// Plain loads of rows [t0, t0 + kChunk) of this batch row's B and C into registers,
// zero past N and past S; store_bc puts them into stage `st` after the scan.
template <typename T>
__device__ __forceinline__ void fetch_bc(float (&rb)[kBcSlots], float (&rc)[kBcSlots],
                                         const T* B, const T* C, int t0, int S, int N) {
#pragma unroll
  for (int j = 0; j < kBcSlots; ++j) {
    const int s = threadIdx.x + j * kThreads;
    const int t = s / kMaxN, n = s - t * kMaxN;
    const bool ok = s < kChunk * kMaxN && n < N && t0 + t < S;
    const long long off = static_cast<long long>(t0 + t) * N + n;
    rb[j] = ok ? to_f32(B[off]) : 0.0f;
    rc[j] = ok ? to_f32(C[off]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store_bc(Ring<T>& ring, int st, const float (&rb)[kBcSlots],
                                         const float (&rc)[kBcSlots]) {
#pragma unroll
  for (int j = 0; j < kBcSlots; ++j) {
    const int s = threadIdx.x + j * kThreads;
    if (s < kChunk * kMaxN) {
      (&ring.bc[st][0][0][0])[s] = rb[j];
      (&ring.bc[st][1][0][0])[s] = rc[j];
    }
  }
}

template <int kN>
__device__ __forceinline__ void load_states(const float* p, float (&v)[kN]) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// Scan the `len` steps of stage `st` (kFull: len == kChunk; kAligned: every row starts
// on a 16-byte boundary, so no row has a shift).  y_g points at y of this lane's channel
// at step g of the chunk, y_group is the stride of a group of kLanes steps; off_d, off_x
// are addr_bits of the chunk's first row of δ and of x.
template <bool kFull, bool kAligned, typename T>
__device__ __forceinline__ void scan_chunk(const Ring<T>& ring, int st, int len,
                                           uint32_t off_d, uint32_t off_x,
                                           uint32_t row_bytes, int c, int g,
                                           float (&h)[kStatesPerLane],
                                           const float (&A2)[kStatesPerLane], T* y_g,
                                           long long y_group, bool store_y) {
  const unsigned char* dx0 = &ring.dx[st][0][0][0] + c * sizeof(T);
  constexpr int kXOff = kChunk * Ring<T>::kRowBytes;  // δ row → x row
#pragma unroll(kFull ? kChunk / kLanes : 1)
  for (int j0 = 0; j0 < (kFull ? kChunk : len); j0 += kLanes) {
    float p[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int tt = j0 + j;
      p[j] = 0.0f;
      if (kFull || tt < len) {
        const uint32_t sd = kAligned ? 0u : (off_d + tt * row_bytes) & 15u;
        const uint32_t sx = kAligned ? 0u : (off_x + tt * row_bytes) & 15u;
        const unsigned char* r = dx0 + tt * Ring<T>::kRowBytes;
        const float dt = to_f32(*reinterpret_cast<const T*>(r + sd));
        const float du = dt * to_f32(*reinterpret_cast<const T*>(r + kXOff + sx));
        float bv[kStatesPerLane], cv[kStatesPerLane];
        load_states(&ring.bc[st][0][tt][g * kStatesPerLane], bv);
        load_states(&ring.bc[st][1][tt][g * kStatesPerLane], cv);
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kStatesPerLane; ++i) {
          h[i] = fmaf(ex2(dt * A2[i]), h[i], du * bv[i]);
          acc = fmaf(h[i], cv[i], acc);
        }
        p[j] = acc;
      }
    }
    // Reduce-scatter over the G lanes of the channel: lane g keeps y of step j0 + g.
#pragma unroll
    for (int o = kLanes / 2; o >= 1; o >>= 1) {
      const bool upper = g & o;
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float keep = upper ? p[i + o] : p[i];
        const float send = upper ? p[i] : p[i + o];
        p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
    if (store_y && (kFull || j0 + g < len)) store(y_g, p[0]);
    y_g += y_group;
  }
}

// kAligned: δ and x start on 16-byte boundaries and D·sizeof(T) is a multiple of 16, so
// every row of δ and x does (and so does d0·sizeof(T)).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks) selective_scan_kernel(
    const T* __restrict__ delta, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const T* __restrict__ x, const float* __restrict__ A_log, T* __restrict__ y,
    float* __restrict__ h_out, int S, int D, int N) {
  __shared__ Ring<T> ring;

  const int c = threadIdx.x / kLanes, g = threadIdx.x % kLanes;
  const int d0 = blockIdx.x * kChannels;
  const int live = min(kChannels, D - d0);
  const bool store_y = c < live;
  const int cr = store_y ? c : live - 1;  // channels past D recompute channel D − 1
  const int d = d0 + cr;
  const long long row = blockIdx.y;     // batch row
  const long long t_row = row * S;      // its first row of the flattened [b·S, D]
  const T* B_r = Bm + t_row * N;
  const T* C_r = Cm + t_row * N;
  const uint32_t row_bytes = static_cast<uint32_t>(D) * static_cast<uint32_t>(sizeof(T));

  float A2[kStatesPerLane], h[kStatesPerLane];
#pragma unroll
  for (int i = 0; i < kStatesPerLane; ++i) {
    const int n = g * kStatesPerLane + i;
    A2[i] = n < N ? -expf(A_log[static_cast<long long>(d) * N + n]) * kLog2e : 0.0f;
    h[i] = 0.0f;
  }

  const int chunks = (S + kChunk - 1) / kChunk;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < chunks)
      load_dx(ring, k, delta, x, t_row + k * kChunk, min(kChunk, S - k * kChunk), D, d0, live);
    cp_async_commit();
  }
  float rb[kBcSlots], rc[kBcSlots];
  fetch_bc(rb, rc, B_r, C_r, 0, S, N);
  store_bc(ring, 0, rb, rc);

  for (int k = 0; k < chunks; ++k) {
    const int st = k % kStages;
    const int t0 = k * kChunk;
    const int len = min(kChunk, S - t0);
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk k have landed
    __syncthreads();               // everyone's have, and stage (k − 1) % kStages is free
    const int kn = k + kStages - 1;
    if (kn < chunks)
      load_dx(ring, kn % kStages, delta, x, t_row + kn * kChunk, min(kChunk, S - kn * kChunk),
              D, d0, live);
    cp_async_commit();
    const bool more = k + 1 < chunks;
    if (more) fetch_bc(rb, rc, B_r, C_r, t0 + kChunk, S, N);

    const long long e0 = (t_row + t0) * D + d0;
    const uint32_t off_d = addr_bits(delta + e0), off_x = addr_bits(x + e0);
    T* y_g = y + (t_row + t0 + g) * D + d;
    const long long y_group = static_cast<long long>(kLanes) * D;
    if (len == kChunk)
      scan_chunk<true, kAligned>(ring, st, len, off_d, off_x, row_bytes, cr, g, h, A2, y_g,
                                 y_group, store_y);
    else
      scan_chunk<false, kAligned>(ring, st, len, off_d, off_x, row_bytes, cr, g, h, A2, y_g,
                                  y_group, store_y);

    if (more) store_bc(ring, (k + 1) % kStages, rb, rc);
  }
  cp_async_wait<0>();

  if (store_y) {
    float* h_d = h_out + (row * D + d) * N;
#pragma unroll
    for (int i = 0; i < kStatesPerLane; ++i) {
      const int n = g * kStatesPerLane + i;
      if (n < N) h_d[n] = h[i];
    }
  }
}

template <typename T>
int launch(const void* delta, const void* B, const void* C, const void* x,
           const float* A_log, void* y, float* h, int batch, int S, int D, int N,
           cudaStream_t stream) {
  const dim3 grid((D + kChannels - 1) / kChannels, batch);
  const bool aligned = static_cast<long long>(D) * sizeof(T) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(delta) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = aligned ? selective_scan_kernel<T, true> : selective_scan_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
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
