// S2FP8 quantize-apply, truncate-apply and dequantize: elementwise maps
// with given (alpha, beta).
//
// Replaces src/repro/kernels/s2fp8_quant.py: quant_apply_pallas
// (_apply_kernel), truncate_apply_pallas (_truncate_kernel, whose body
// _truncate_body is s2fp8::truncate here) and dequant_pallas
// (_dequant_kernel).
//
// Bound on the card: bytes.  Each element is read once (4 B f32 or 2 B
// bf16) and written once (1 B payload, or 4/2 B truncated value); the
// log2f/exp2f pair (two pairs for truncate) costs a few dozen
// instructions, under the H100's compute per byte at 3.35 TB/s.  Design: a
// grid-stride loop over the flat tensor, one element per thread per step,
// neighbouring threads on neighbouring addresses; (alpha, beta) read once
// per thread from device memory, so no host round trip.  Dequantize moves
// 5 B per element (1 B payload in, 4 B f32 out); each block first builds
// the 256-entry table of s2fp8::decode in shared memory, so the loop is a
// byte load, a table lookup and a store — the same values as decoding
// each element.
#include "s2fp8_common.cuh"

namespace {

__global__ void quant_apply_kernel(const void* __restrict__ x, int x_dtype,
                                   unsigned char* __restrict__ out,
                                   long long n, const float* __restrict__ ab,
                                   int fmt) {
  const float alpha = ab[0], beta = ab[1];
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = s2fp8::encode(s2fp8::load_as_f32(x, i, x_dtype), alpha, beta,
                           fmt);
}

__global__ void truncate_apply_kernel(const void* __restrict__ x,
                                      int x_dtype, void* __restrict__ out,
                                      int out_dtype, long long n,
                                      const float* __restrict__ ab, int fmt) {
  const float alpha = ab[0], beta = ab[1];
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    s2fp8::store_from_f32(
        out, i,
        s2fp8::truncate(s2fp8::load_as_f32(x, i, x_dtype), alpha, beta, fmt),
        out_dtype);
}

__global__ void dequant_kernel(const unsigned char* __restrict__ p,
                               float* __restrict__ out, long long n,
                               const float* __restrict__ ab, int fmt) {
  __shared__ float lut[256];
  s2fp8::fill_lut(lut, ab, fmt);
  __syncthreads();
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = lut[p[i]];
}

int grid_for(long long n) {
  long long blocks = (n + 255) / 256;
  const long long cap = 132LL * 32;  // 32 resident-block waves of 132 SMs
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" int s2fp8_quant_apply(const void* x, int x_dtype, void* out,
                                 long long n, const void* ab, int fmt,
                                 void* stream) {
  quant_apply_kernel<<<grid_for(n), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, x_dtype, static_cast<unsigned char*>(out), n,
      static_cast<const float*>(ab), fmt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2fp8_truncate_apply(const void* x, int x_dtype, void* out,
                                    int out_dtype, long long n, const void* ab,
                                    int fmt, void* stream) {
  truncate_apply_kernel<<<grid_for(n), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, x_dtype, out, out_dtype, n, static_cast<const float*>(ab), fmt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2fp8_dequant(const void* payload, void* out, long long n,
                             const void* ab, int fmt, void* stream) {
  dequant_kernel<<<grid_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(payload), static_cast<float*>(out), n,
      static_cast<const float*>(ab), fmt);
  return static_cast<int>(cudaGetLastError());
}
