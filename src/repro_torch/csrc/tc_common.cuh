// Helpers the tensor-core kernels share (the flash kernels and the payload
// GEMM): the compensated TF32 split and cp.async copies from global to
// shared memory.
#pragma once

#include <cstdint>

#include "s2fp8_common.cuh"

namespace tc {

// x = hi + lo to within 2^-21 |x|, both halves TF32, each truncated
// toward zero (its low 13 bits cleared): two logic ops and a subtract,
// fewer than cvt.rna.tf32.f32 compiles to.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? N : 0;   // 0 source bytes: the destination is zeroed
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
