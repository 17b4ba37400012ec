// The one device-side copy of the S2FP8 element maps (paper Eq. 2-5).
//
// Every kernel of the port uses these bodies: the quantize and truncate
// kernels, the payload GEMM's dequant table and Eq. 5 epilogue, the flash
// kernel's dequant table and epilogue, and the paged-decode dequant table.
// It is the counterpart of ``_truncate_body`` / ``_dequant`` in
// src/repro/kernels/s2fp8_quant.py and s2fp8_matmul.py.  Also here: the
// statistics reduction (Eq. 3-4) that the stats, quantize-with-stats and
// fused truncate kernels share, and ``stats_from_reduction``.
//
// Numerics contract (kept so the kernels agree with the plain PyTorch
// versions): full-precision log2f / exp2f (no --use_fast_math); the
// multiply, add, subtract and divide of the maps round separately
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, never contracted into
// an FMA), exactly as PyTorch's separate elementwise ops round; the 8-bit
// cast is clamp at the format's max finite, then RNE with SATFINITE.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace s2fp8 {

enum Fmt { kE5M2 = 0, kE4M3 = 1 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float fmt_max(int fmt) {
  return fmt == kE5M2 ? 57344.0f : 448.0f;
}

// Eq. 2 forward map: sign(x) * 2^(alpha * log2|x| + beta); zeros stay zero.
__device__ __forceinline__ float forward_map(float x, float alpha, float beta) {
  float ax = fabsf(x);
  if (!(ax > 0.0f)) return 0.0f;
  float y = exp2f(__fadd_rn(__fmul_rn(alpha, log2f(ax)), beta));
  return x < 0.0f ? -y : y;
}

// Eq. 4 inverse map: sign(y) * 2^((log2|y| - beta) / alpha); zeros stay zero.
__device__ __forceinline__ float inverse_map(float y, float alpha, float beta) {
  float ay = fabsf(y);
  if (!(ay > 0.0f)) return 0.0f;
  float x = exp2f(__fdiv_rn(__fsub_rn(log2f(ay), beta), alpha));
  return y < 0.0f ? -x : x;
}

// Clamp at the format's max finite, then round to nearest even.
__device__ __forceinline__ unsigned char to_fp8(float y, int fmt) {
  float m = fmt_max(fmt);
  y = fminf(fmaxf(y, -m), m);
  return fmt == kE5M2 ? __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E5M2)
                      : __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float from_fp8(unsigned char v, int fmt) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      v, fmt == kE5M2 ? __NV_E5M2 : __NV_E4M3);
  return __half2float(__half(h));
}

// Eq. 2 + clamp + cast: the payload byte of x.
__device__ __forceinline__ unsigned char encode(float x, float alpha,
                                                float beta, int fmt) {
  return to_fp8(forward_map(x, alpha, beta), fmt);
}

// Eq. 4 of a payload byte: the value a payload stands for.
__device__ __forceinline__ float decode(unsigned char v, float alpha,
                                       float beta, int fmt) {
  return inverse_map(from_fp8(v, fmt), alpha, beta);
}

// Eq. 5: the value x rounds to on the site's grid.
__device__ __forceinline__ float truncate(float x, float alpha, float beta,
                                          int fmt) {
  return decode(encode(x, alpha, beta, fmt), alpha, beta, fmt);
}

// A block's 256-entry dequant table: entry c is decode(c).  A payload byte
// has 256 values, so the GEMM and attention kernels dequantize by lookup:
// the same function, bit for bit, at one transcendental pair per entry
// instead of one per element.  Call with blockDim.x threads, then sync.
__device__ __forceinline__ void fill_lut(float* lut, const float* ab, int fmt) {
  float alpha = ab[0], beta = ab[1];
  for (int c = threadIdx.x; c < 256; c += blockDim.x)
    lut[c] = decode(static_cast<unsigned char>(c), alpha, beta, fmt);
}

__device__ __forceinline__ float load_as_f32(const void* p, long long i,
                                             int dtype) {
  if (dtype == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_from_f32(void* p, long long i, float v,
                                               int dtype) {
  if (dtype == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// ---------------------------------------------------------------------------
// Statistics (Eq. 3-4): (sum log2|x|, max log2|x|, nonzero count) over the
// nonzero elements.  Zeros and NaNs are left out (NaN > 0 is false), as in
// the reference.  The sum is kept in f64 and the count in 64-bit integers,
// so the result does not depend on the grid beyond f64 rounding; every
// reduction below runs in a fixed order (no atomics), so a tensor gives the
// same bits on every run with the same grid.
// ---------------------------------------------------------------------------

constexpr int kStatsThreads = 256;   // block size of every stats kernel

struct StatsPartial {
  double sum;
  float max;
  long long count;
};

__device__ __forceinline__ StatsPartial stats_identity() {
  return StatsPartial{0.0, __int_as_float(0xff800000), 0};  // max = -inf
}

__device__ __forceinline__ StatsPartial stats_combine(StatsPartial a,
                                                      StatsPartial b) {
  return StatsPartial{a.sum + b.sum, fmaxf(a.max, b.max), a.count + b.count};
}

// This thread's share of x under the grid-stride map (element i goes to
// thread i mod (gridDim.x * blockDim.x)): the map the stats kernel and the
// fused truncate kernel's phase 0 both use.
__device__ __forceinline__ StatsPartial stats_thread_partial(const void* x,
                                                             int dtype,
                                                             long long n) {
  StatsPartial p = stats_identity();
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float a = fabsf(load_as_f32(x, i, dtype));
    if (a > 0.0f) {
      float l = log2f(a);
      p.sum += static_cast<double>(l);
      p.max = fmaxf(p.max, l);
      p.count += 1;
    }
  }
  return p;
}

__device__ __forceinline__ StatsPartial stats_warp_reduce(StatsPartial p) {
  for (int off = 16; off > 0; off >>= 1) {
    StatsPartial o;
    o.sum = __shfl_down_sync(0xffffffffu, p.sum, off);
    o.max = __shfl_down_sync(0xffffffffu, p.max, off);
    o.count = __shfl_down_sync(0xffffffffu, p.count, off);
    p = stats_combine(p, o);
  }
  return p;
}

// The block's total, valid in thread 0; every thread of the block calls it.
// ``smem`` holds one partial per warp (32 entries).
__device__ __forceinline__ StatsPartial stats_block_reduce(StatsPartial p,
                                                           StatsPartial* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  p = stats_warp_reduce(p);
  if (lane == 0) smem[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < static_cast<int>((blockDim.x + 31) >> 5) ? smem[lane]
                                                         : stats_identity();
    p = stats_warp_reduce(p);
  }
  __syncthreads();
  return p;
}

// Total over the per-block partials, in a fixed order, valid in thread 0.
// The partials are read through L2 (__ldcg): the fused kernel reads them in
// the launch that wrote them.
__device__ __forceinline__ StatsPartial stats_reduce_partials(
    const StatsPartial* parts, int nparts, StatsPartial* smem) {
  StatsPartial p = stats_identity();
  for (int i = threadIdx.x; i < nparts; i += blockDim.x)
    p = stats_combine(p, StatsPartial{__ldcg(&parts[i].sum),
                                      __ldcg(&parts[i].max),
                                      __ldcg(&parts[i].count)});
  return stats_block_reduce(p, smem);
}

// (sum, max, count) -> (alpha, beta), op for op as core/s2fp8.py
// ``stats_from_reduction``: IEEE f32 division, each step rounded alone.
// An all-zero tensor gives (1, 0); a constant magnitude a pure shift.
__device__ __forceinline__ void stats_from_reduction(float log_sum,
                                                     float log_max,
                                                     float count,
                                                     float target_max,
                                                     float* alpha,
                                                     float* beta) {
  float mu = __fdiv_rn(log_sum, fmaxf(count, 1.0f));
  float spread = __fsub_rn(log_max, mu);
  bool degenerate = spread < 1e-6f;
  float a = degenerate ? 1.0f : __fdiv_rn(target_max, spread);
  float b = degenerate ? __fsub_rn(target_max, log_max) : __fmul_rn(-a, mu);
  if (count == 0.0f) {
    a = 1.0f;
    b = 0.0f;
  }
  *alpha = a;
  *beta = b;
}

// The triplet as f32 (sum rounded once from f64, count converted from the
// exact integer) and its (alpha, beta).
__device__ __forceinline__ void stats_finish(StatsPartial t, float target_max,
                                             float* triplet, float* ab) {
  triplet[0] = __double2float_rn(t.sum);
  triplet[1] = t.max;
  triplet[2] = __ll2float_rn(t.count);
  stats_from_reduction(triplet[0], triplet[1], triplet[2], target_max,
                       &ab[0], &ab[1]);
}

}  // namespace s2fp8
