// Mamba-1 selective scan: for each (batch row, channel) the n-state
// recurrence over the sequence,
//   h = h * exp(dt A) + (dt x) B,   y = h . C + D x,
// returning y [B, S, di] and the final state h [B, di, n].  Replaces
// src/repro/kernels/selective_scan.py: selective_scan_pallas (_scan_kernel).
//
// Bound on the card: x, dt and y stream once ([B, S, di] f32 each), B and
// C once ([B, S, n]); the state never leaves the chip.  The exps (one a
// state and step) are no tighter bound: an exp2 runs on the SFUs or as a
// polynomial on the FMA pipes.  Instruction slots lie above the bytes:
// the state update is 14 a state and step (the accurate expf is 8 of
// them, one MUFU.EX2), plus the step's loads, the shuffle tree and y.
//
// Design: the TPU kernel's grid walks (batch row, block of channels) and
// keeps a [bd, n] state slab in VMEM across a sequential loop over S.
// Here each channel's n <= 16 states are split over LANES = 4 neighbouring
// lanes of a warp, 4 states and their 4 entries of A in each lane's
// registers, so a block of CHANNELS channels of one batch row has 4 x
// CHANNELS threads (grid (ceil(di / CHANNELS), B)), and each thread's
// chain of adds for y is 4 long, not 16.  Each lane sums its share of h.C
// in state order; the 4 shares are summed by __shfl_xor_sync over lane
// distance 1, then 2 (every lane ends with the same bits), and D x is
// added.  A state past n has a = 0 and b = c = 0: it stays 0 and adds 0,
// so no lane branches on n.  Chunks of TCHUNK timesteps are staged in
// shared memory with cp.async, double-buffered: chunk k + 1's x and dt (16
// bytes a copy, coalesced along di) and its B_t and C_t (4 bytes a copy)
// are in flight while chunk k computes.  A lane reads its 4 B_t and 4 C_t
// as one 16-byte shared-memory load each; the chunk's y is gathered in
// shared memory (UNROLL steps at a time from registers, so no store sits
// between one step's loads and the next's) and stored as 16-byte vectors
// along di.  Ragged di and S not a multiple of TCHUNK are masked (the
// copies zero-fill, the stores skip); di % 4 != 0 or a pointer off 16
// bytes takes 4-byte copies and stores.  Shared memory is 24 KB a block of
// 256 threads; the registers (launch bounds: MINBLOCKS blocks an SM, 64 a
// thread, no spill) hold the SM at 4 blocks, 32 warps (50%).  Blocks of
// 32 channels, other unrolls and 5 or 8 blocks an SM (8 spill) measured
// slower, chunks of 32 steps (at the 48 KB static shared-memory limit)
// under 2% faster.  The state update
// rounds each multiply and add on its own (__fmul_rn / __fadd_rn, no FMA
// contraction), as PyTorch's separate elementwise ops do, and exp is the
// accurate expf (no --use_fast_math), so h is the plain version's bit for
// bit but for the math library's exp.  No float atomics: two launches give
// the same bits.  The TPU kernel's VMEM sizing of its tiles does not carry
// over.
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace {

constexpr int LANES = 4, SPL = 4;   // lanes a channel, states a lane
constexpr int NMAX = LANES * SPL;
constexpr int CHANNELS = 64, TCHUNK = 16, MINBLOCKS = 4, UNROLL = 8;
constexpr int THREADS = CHANNELS * LANES;
constexpr int GROUPS = CHANNELS / 4;   // 4-channel vectors in a row

struct Stage {
  float x[2][TCHUNK][CHANNELS], dt[2][TCHUNK][CHANNELS];
  float b[2][TCHUNK][NMAX], c[2][TCHUNK][NMAX];
  float y[TCHUNK][CHANNELS];
};

// Start chunk [t0, t0 + tn)'s copies into buffer `buf`: x and dt as
// 4-channel vectors (or their 4 channels one by one), B and C element by
// element; out-of-range sources zero-fill.
template <bool VEC>
__device__ __forceinline__ void stage_chunk(
    Stage& sm, int buf, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, size_t row0, int t0, int tn, int c0, int di,
    int n) {
  for (int v = threadIdx.x; v < TCHUNK * GROUPS; v += THREADS) {
    const int t = v / GROUPS, c = c0 + 4 * (v % GROUPS);
    const size_t off = (row0 + t0 + t) * di + c;
    float* dx = &sm.x[buf][t][c - c0];
    float* dd = &sm.dt[buf][t][c - c0];
    if (VEC) {
      const bool ok = t < tn && c < di;
      tc::cp_async<16>(dx, ok ? x + off : x, ok);
      tc::cp_async<16>(dd, ok ? dt + off : dt, ok);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = t < tn && c + k < di;
        tc::cp_async<4>(dx + k, ok ? x + off + k : x, ok);
        tc::cp_async<4>(dd + k, ok ? dt + off + k : dt, ok);
      }
    }
  }
  for (int e = threadIdx.x; e < TCHUNK * NMAX; e += THREADS) {
    const int t = e / NMAX, j = e % NMAX;
    const bool ok = t < tn && j < n;
    const size_t off = (row0 + t0 + t) * n + j;
    tc::cp_async<4>(&sm.b[buf][t][j], ok ? bm + off : bm, ok);
    tc::cp_async<4>(&sm.c[buf][t][j], ok ? cm + off : cm, ok);
  }
}

template <bool VEC>
__global__ __launch_bounds__(THREADS, MINBLOCKS) void selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    float* __restrict__ y, float* __restrict__ hout, int s, int di, int n) {
  __shared__ __align__(16) Stage sm;

  const int lane = threadIdx.x % LANES, ch = threadIdx.x / LANES;
  const int b = blockIdx.y, c0 = blockIdx.x * CHANNELS;
  const int c = c0 + ch;
  const bool live = c < di;
  const size_t row0 = static_cast<size_t>(b) * s;

  // A missing state (lane * SPL + j >= n) has a = 0 here and b = c = 0
  // in shared memory (zero-filled): it stays 0 and adds 0 to y.
  float av[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int st = lane * SPL + j;
    av[j] = (live && st < n) ? a[static_cast<size_t>(c) * n + st] : 0.0f;
    h[j] = 0.0f;
  }
  const float dd = live ? dskip[c] : 0.0f;

  const int chunks = (s + TCHUNK - 1) / TCHUNK;
  stage_chunk<VEC>(sm, 0, x, dt, bm, cm, row0, 0, min(TCHUNK, s), c0, di, n);
  tc::cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1, t0 = k * TCHUNK, tn = min(TCHUNK, s - t0);
    if (k + 1 < chunks)
      stage_chunk<VEC>(sm, buf ^ 1, x, dt, bm, cm, row0, t0 + TCHUNK,
                       min(TCHUNK, s - t0 - TCHUNK), c0, di, n);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();   // chunk k has landed (k + 1 may be in flight)
    __syncthreads();
    // one step's y: every lane of a channel ends with the same sum
    auto step = [&](int t) {
      const float xt = sm.x[buf][t][ch], dtt = sm.dt[buf][t][ch];
      const float4 bq = *reinterpret_cast<const float4*>(
          &sm.b[buf][t][lane * SPL]);
      const float4 cq = *reinterpret_cast<const float4*>(
          &sm.c[buf][t][lane * SPL]);
      const float bv[SPL] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[SPL] = {cq.x, cq.y, cq.z, cq.w};
      const float dtx = __fmul_rn(dtt, xt);
      float acc;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const float da = expf(__fmul_rn(dtt, av[j]));
        h[j] = __fadd_rn(__fmul_rn(h[j], da), __fmul_rn(dtx, bv[j]));
        const float hc = __fmul_rn(h[j], cv[j]);
        acc = j == 0 ? hc : __fadd_rn(acc, hc);
      }
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
      return __fadd_rn(acc, __fmul_rn(dd, xt));
    };
    // every lane stores its channel's y (the same value); a full chunk
    // keeps UNROLL steps' y in registers and stores them after the group,
    // so no shared-memory store sits between one step's loads and the next
    if (tn == TCHUNK) {
      for (int t = 0; t < TCHUNK; t += UNROLL) {
        float yv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) yv[u] = step(t + u);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) sm.y[t + u][ch] = yv[u];
      }
    } else {
      for (int t = 0; t < tn; ++t) sm.y[t][ch] = step(t);
    }
    __syncthreads();   // the chunk's y is gathered; its buffer is free
    for (int v = threadIdx.x; v < TCHUNK * GROUPS; v += THREADS) {
      const int t = v / GROUPS, cv0 = c0 + 4 * (v % GROUPS);
      if (t >= tn) break;
      float* dst = y + (row0 + t0 + t) * di + cv0;
      const float* src = &sm.y[t][cv0 - c0];
      if (VEC) {
        if (cv0 < di)
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (cv0 + q < di) dst[q] = src[q];
      }
    }
  }
  if (live) {
    float* hrow = hout + (static_cast<size_t>(b) * di + c) * n + lane * SPL;
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (lane * SPL + j < n) hrow[j] = h[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x, dt, y [b, s, di]; bm, cm [b, s, n]; a [di, n]; dskip [di]; hout
// [b, di, n]; all f32, contiguous.  1 <= n <= 16.
extern "C" int selective_scan(const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a,
                              const void* dskip, void* y, void* hout, int b,
                              int s, int di, int n, void* stream) {
  if (n < 1 || n > NMAX || b < 1 || s < 1 || di < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = di % 4 == 0 && aligned16(x) && aligned16(dt) &&
                   aligned16(y);
  dim3 grid((di + CHANNELS - 1) / CHANNELS, b);
  auto kernel = vec ? selective_scan_kernel<true>
                    : selective_scan_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dskip),
      static_cast<float*>(y), static_cast<float*>(hout), s, di, n);
  return static_cast<int>(cudaGetLastError());
}
