// Mamba-1 selective scan: for each (batch row, channel) the n-state
// recurrence over the sequence,
//   h = h * exp(dt A) + (dt x) B,   y = h . C + D x,
// returning y [B, S, di] and the final state h [B, di, n].  Replaces
// src/repro/kernels/selective_scan.py: selective_scan_pallas (_scan_kernel).
//
// Bound on the card: bytes — x, dt and y stream once ([B, S, di] f32
// each), B and C once ([B, S, n]); the state never leaves the chip.  About
// 7 operations per state element and step (one of them an exp), so the
// operations' bound is below the bytes' at n = 16.
//
// Design: the TPU kernel's grid walks (batch row, block of channels) and
// keeps a [bd, n] state slab in VMEM across a sequential loop over S.
// Here one thread owns one (batch row, channel) and keeps its n <= 16
// states and its row of A in registers; a block covers 128 channels of one
// batch row (grid (ceil(di / 128), B)).  Every channel of a row reads the
// same B_t and C_t, so a block stages them for a chunk of 32 timesteps in
// shared memory, together with the chunk's x and dt (loaded coalesced
// along di, each thread its own column); y is stored coalesced along di
// per step.  The state update rounds each multiply and add on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), as PyTorch's separate
// elementwise ops do, and exp is the accurate expf (no --use_fast_math);
// the sum over n runs j = 0..n-1.  The TPU kernel's VMEM sizing of its
// tiles does not carry over.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128, NMAX = 16, TCHUNK = 32;

__global__ __launch_bounds__(THREADS) void selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    float* __restrict__ y, float* __restrict__ hout, int s, int di, int n) {
  __shared__ float sx[TCHUNK][THREADS], sdt[TCHUNK][THREADS];
  __shared__ float sb[TCHUNK][NMAX], sc[TCHUNK][NMAX];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.x * THREADS + tid;
  const bool live = c < di;

  float av[NMAX], h[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    av[j] = (live && j < n) ? a[static_cast<size_t>(c) * n + j] : 0.0f;
    h[j] = 0.0f;
  }
  const float dd = live ? dskip[c] : 0.0f;
  const size_t row0 = static_cast<size_t>(b) * s;

  for (int t0 = 0; t0 < s; t0 += TCHUNK) {
    const int tn = min(TCHUNK, s - t0);
    __syncthreads();   // the previous chunk's readers are done
    for (int idx = tid; idx < tn * n; idx += THREADS) {
      const int t = idx / n, j = idx % n;
      const size_t off = (row0 + t0 + t) * n + j;
      sb[t][j] = bm[off];
      sc[t][j] = cm[off];
    }
    if (live) {
#pragma unroll 8
      for (int t = 0; t < tn; ++t) {
        const size_t off = (row0 + t0 + t) * di + c;
        sx[t][tid] = x[off];
        sdt[t][tid] = dt[off];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < tn; ++t) {
      const float xt = sx[t][tid], dtt = sdt[t][tid];
      const float dtx = __fmul_rn(dtt, xt);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const float da = expf(__fmul_rn(dtt, av[j]));
          h[j] = __fadd_rn(__fmul_rn(h[j], da), __fmul_rn(dtx, sb[t][j]));
          acc = __fadd_rn(acc, __fmul_rn(h[j], sc[t][j]));
        }
      }
      y[(row0 + t0 + t) * di + c] = __fadd_rn(acc, __fmul_rn(dd, xt));
    }
  }
  if (live) {
    float* hrow = hout + (static_cast<size_t>(b) * di + c) * n;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) hrow[j] = h[j];
  }
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
  dim3 grid((di + THREADS - 1) / THREADS, b);
  selective_scan_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dskip),
      static_cast<float*>(y), static_cast<float*>(hout), s, di, n);
  return static_cast<int>(cudaGetLastError());
}
