// The one device-side copy of the S2FP8 element maps (paper Eq. 2-5).
//
// Every kernel of the port uses these bodies: the quantize and truncate
// kernels, the payload GEMM's dequant table and Eq. 5 epilogue, the flash
// kernel's dequant table and epilogue, and the paged-decode dequant table.
// It is the counterpart of ``_truncate_body`` / ``_dequant`` in
// src/repro/kernels/s2fp8_quant.py and s2fp8_matmul.py.
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

}  // namespace s2fp8
