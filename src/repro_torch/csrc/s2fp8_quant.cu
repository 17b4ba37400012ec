// S2FP8 quantize-apply, truncate-apply and dequantize (elementwise maps
// with given (alpha, beta)), and the statistics kernels: stats,
// quantize-with-stats and the fused truncate.
//
// Replaces src/repro/kernels/s2fp8_quant.py: quant_apply_pallas
// (_apply_kernel), truncate_apply_pallas (_truncate_kernel, whose body
// _truncate_body is s2fp8::truncate here), dequant_pallas
// (_dequant_kernel), stats_pallas (_stats_kernel), quant_pallas (stats, then
// apply) and truncate_fused_pallas (_truncate_fused_kernel).
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
//
// Statistics: bound by bytes too (one read of x; the f64 adds are far
// under the card's f64 rate at this byte rate).  A TPU grid runs in order
// and carries the sums from one step to the next; here blocks run in no
// order, so the reduction is two-stage: each block reduces its
// grid-stride share (warp shuffles, then the block, in a fixed order) to
// one partial, and a second stage sums the partials in a fixed order.  No
// float atomics: the same tensor gives the same bits on every run.  On a
// given card the grid is a function of n alone (``stats_grid``: one block
// per 256 elements, at most what one cooperative launch can hold), so the
// stats kernel and the fused truncate kernel's phase 0 give equal partials
// for equal inputs, and truncate_fused(x) equals truncate_apply(x, stats(x)) bit
// for bit.  The fused truncate is one cooperative launch: phase 0 writes
// the partials, a grid-wide barrier, then every block sums all partials
// in the same order (so every block derives the same (alpha, beta) without
// a second barrier) and applies Eq. 5 in a grid-stride loop: the TPU
// kernel's two passes over x in one call.  Quantize-with-stats is the
// stats launches followed by quant_apply reading (alpha, beta) from
// device memory.
#include <cooperative_groups.h>

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

__global__ void __launch_bounds__(s2fp8::kStatsThreads)
    stats_partials_kernel(const void* __restrict__ x, int x_dtype,
                          long long n, s2fp8::StatsPartial* parts) {
  __shared__ s2fp8::StatsPartial smem[32];
  s2fp8::StatsPartial p = s2fp8::stats_block_reduce(
      s2fp8::stats_thread_partial(x, x_dtype, n), smem);
  if (threadIdx.x == 0) parts[blockIdx.x] = p;
}

__global__ void __launch_bounds__(s2fp8::kStatsThreads)
    stats_finish_kernel(const s2fp8::StatsPartial* parts, int nparts,
                        float* __restrict__ triplet, float* __restrict__ ab,
                        float target_max) {
  __shared__ s2fp8::StatsPartial smem[32];
  s2fp8::StatsPartial t = s2fp8::stats_reduce_partials(parts, nparts, smem);
  if (threadIdx.x == 0) s2fp8::stats_finish(t, target_max, triplet, ab);
}

__global__ void __launch_bounds__(s2fp8::kStatsThreads)
    truncate_fused_kernel(const void* __restrict__ x, int x_dtype,
                          void* __restrict__ out, int out_dtype, long long n,
                          s2fp8::StatsPartial* parts,
                          float* __restrict__ triplet,
                          float* __restrict__ ab_out, float target_max,
                          int fmt) {
  __shared__ s2fp8::StatsPartial smem[32];
  __shared__ float s_ab[2];
  // phase 0: this block's partial, as stats_partials_kernel computes it
  s2fp8::StatsPartial p = s2fp8::stats_block_reduce(
      s2fp8::stats_thread_partial(x, x_dtype, n), smem);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = p;
    __threadfence();
  }
  cooperative_groups::this_grid().sync();
  // every block: the same total in the same order -> the same (alpha, beta)
  s2fp8::StatsPartial t = s2fp8::stats_reduce_partials(parts, gridDim.x,
                                                       smem);
  if (threadIdx.x == 0) {
    float tri[3];
    s2fp8::stats_finish(t, target_max, tri, s_ab);
    if (blockIdx.x == 0) {
      triplet[0] = tri[0];
      triplet[1] = tri[1];
      triplet[2] = tri[2];
      ab_out[0] = s_ab[0];
      ab_out[1] = s_ab[1];
    }
  }
  __syncthreads();
  // phase 1: Eq. 5 with those stats
  const float alpha = s_ab[0], beta = s_ab[1];
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    s2fp8::store_from_f32(
        out, i,
        s2fp8::truncate(s2fp8::load_as_f32(x, i, x_dtype), alpha, beta, fmt),
        out_dtype);
}

int grid_for(long long n) {
  long long blocks = (n + 255) / 256;
  const long long cap = 132LL * 32;  // 32 resident-block waves of 132 SMs
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// The stats grid for n elements: one block per 256 elements, at most the
// number of fused-truncate blocks that fit on the card at once (the
// cooperative launch's limit), so the stats kernel and the fused kernel use
// the same grid for the same n.  Returns 0 after an error.
int stats_grid(long long n, cudaError_t* err) {
  static int cap[64] = {0};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, truncate_fused_kernel, s2fp8::kStatsThreads, 0);
    if (*err != cudaSuccess) return 0;
    if (sms * per_sm <= 0) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    cap[dev] = sms * per_sm;
  }
  long long blocks = (n + s2fp8::kStatsThreads - 1) / s2fp8::kStatsThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < cap[dev] ? blocks : cap[dev]);
}

// Launches the two stats stages; scratch holds the per-block partials.
cudaError_t launch_stats(const void* x, int x_dtype, long long n,
                         void* scratch, long long scratch_bytes,
                         float* triplet, float* ab, float target_max,
                         cudaStream_t stream) {
  cudaError_t err;
  int grid = stats_grid(n, &err);
  if (grid == 0) return err;
  if (static_cast<long long>(grid) * sizeof(s2fp8::StatsPartial) >
      scratch_bytes)
    return cudaErrorInvalidValue;
  auto* parts = static_cast<s2fp8::StatsPartial*>(scratch);
  stats_partials_kernel<<<grid, s2fp8::kStatsThreads, 0, stream>>>(
      x, x_dtype, n, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_finish_kernel<<<1, s2fp8::kStatsThreads, 0, stream>>>(
      parts, grid, triplet, ab, target_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" int s2fp8_stats(const void* x, int x_dtype, long long n,
                           void* scratch, long long scratch_bytes,
                           void* triplet, void* ab, float target_max,
                           void* stream) {
  return static_cast<int>(launch_stats(
      x, x_dtype, n, scratch, scratch_bytes, static_cast<float*>(triplet),
      static_cast<float*>(ab), target_max,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int s2fp8_quant(const void* x, int x_dtype, void* out, long long n,
                           void* scratch, long long scratch_bytes,
                           void* triplet, void* ab, float target_max, int fmt,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_stats(x, x_dtype, n, scratch, scratch_bytes,
                                 static_cast<float*>(triplet),
                                 static_cast<float*>(ab), target_max, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_apply_kernel<<<grid_for(n), 256, 0, s>>>(
      x, x_dtype, static_cast<unsigned char*>(out), n,
      static_cast<const float*>(ab), fmt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2fp8_truncate_fused(const void* x, int x_dtype, void* out,
                                    int out_dtype, long long n, void* scratch,
                                    long long scratch_bytes, void* triplet,
                                    void* ab, float target_max, int fmt,
                                    void* stream) {
  cudaError_t err;
  int grid = stats_grid(n, &err);
  if (grid == 0) return static_cast<int>(err);
  if (static_cast<long long>(grid) * sizeof(s2fp8::StatsPartial) >
      scratch_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* parts = static_cast<s2fp8::StatsPartial*>(scratch);
  auto* tri = static_cast<float*>(triplet);
  auto* abp = static_cast<float*>(ab);
  void* args[] = {const_cast<void**>(&x), &x_dtype, &out, &out_dtype, &n,
                  &parts, &tri, &abp, &target_max, &fmt};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(truncate_fused_kernel), dim3(grid),
      dim3(s2fp8::kStatsThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

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
