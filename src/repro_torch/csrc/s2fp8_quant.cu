// S2FP8 quantize-apply, truncate-apply and dequantize (elementwise maps
// with given (alpha, beta)), and the statistics kernels: stats,
// quantize-with-stats and the fused truncate.
//
// Replaces src/repro/kernels/s2fp8_quant.py: quant_apply_pallas
// (_apply_kernel), truncate_apply_pallas (_truncate_kernel and its body
// _truncate_body: here the code-table encode and lut[code]), dequant_pallas
// (_dequant_kernel), stats_pallas (_stats_kernel), quant_pallas (stats, then
// apply) and truncate_fused_pallas (_truncate_fused_kernel).
//
// Bound on the card: bytes for every one of them (each element read once,
// 4 B f32 or 2 B bf16, and written once: a 1 B payload or the 4 / 2 B
// truncated value).  The direct maps are not: full-precision log2f, exp2f
// and the fp8 convert on every element (a second log2f / exp2f / divide
// for the truncate) came to about 86 instructions an element, so
// quantize-apply ran at 389 G elements/s against the 1,117 G/s that HBM
// allows for bf16 (0.72 ms for 283 M elements on an H100; 132 SMs x 128
// lanes x 1.98 GHz).
//
// Quantize-apply (quant_apply_kernel<T, F>) and truncate-apply
// (truncate_apply_kernel<T, F>): the input dtype and the format are
// template parameters; each thread moves 16 bytes a step (4 f32 or 8 bf16
// in; 4 or 8 code bytes stored packed, or one 16-byte word of truncated
// values), the ragged edges (a head before x's first 16-byte boundary, a
// tail after its last whole vector) as scalars in the same kernel; the
// grid is one wave of the blocks the card holds at once, filled down to a
// 2304 x 2304 weight.  The encode keeps log2f and the rounded multiply-add
// of the forward map and replaces exp2f, the clamp and the convert by the
// card's code table (s2fp8_common.cuh: a bucket of t and one threshold
// compare; built once per card and format by build_code_table_kernel from
// the same exp2f and convert, held to the direct map over every f32 t by
// code_sweep_kernel).  log2f, a polynomial of about 30 instructions (no
// MUFU in its SASS), is what is left of the encode's cost.  Truncate-apply
// writes Eq. 5 as lut[code]: a 256-entry table of decode(c) in x's dtype,
// built once per block from (alpha, beta) (``fill_value_lut``, shared with
// the fused truncate), so truncate_apply(x) equals
// dequant(quant_apply(x)) in x's dtype bit for bit.  Dequantize looks each
// byte up in a per-block table of s2fp8::decode.
//
// Statistics: bound by bytes (one read of x; the f64 adds are far under
// the card's f64 rate).  A TPU grid runs in order and carries the sums
// from one step to the next; here blocks run in no order, so the reduction
// is two-stage: each block reduces its threads' shares (the element map of
// s2fp8_common.cuh: 16-byte vectors, round-robin over the grid's threads;
// warp shuffles, then the block, in a fixed order) to one partial, and the
// partials are summed once, in index order.  No float atomics: the same
// tensor gives the same bits on every run.  The grid is a function of n
// and the card alone (``stats_grid``: one block per 4,096 elements, at
// most the fused truncate's blocks that fit on the card at once), so the
// stats kernel and the fused truncate's phase 0 give equal partials, and
// truncate_fused(x) equals truncate_apply(x, stats(x)) bit for bit.
// Quantize-with-stats is the stats launches followed by quant_apply_kernel
// reading (alpha, beta) from device memory.
//
// The fused truncate (truncate_fused_kernel<T, F>) is one cooperative
// launch: phase 0 computes the block's partial and keeps each thread's
// first 16 elements and their log2 in registers; after a grid barrier,
// block 0 alone sums the partials and publishes (alpha, beta); after a
// second barrier every block builds the 256-entry table of decode(c) in
// x's dtype and writes Eq. 5 as table[encode(x)], equal to
// decode(encode(x)) bit for bit (the kept elements encoded from their kept
// log2).  Up to the grid's threads x
// 16 elements (2.16 M at 4 blocks of 256 a SM) nothing is read twice and
// no log2f runs twice; larger tensors re-read the rest, last round first,
// so the reads phase 0 left in the 50 MB L2 are the first ones taken
// again.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstddef>

#include "s2fp8_common.cuh"

namespace {

using s2fp8::CodeTable;
using s2fp8::kKeepVecs;
using s2fp8::kVec;
using s2fp8::StatsPartial;
using s2fp8::VecSplit;

template <typename T, int F>
struct Kind {
  using type = T;
  static constexpr int fmt = F;
};

// Calls fn(Kind<T, F>{}) for the runtime dtype and format ids.
template <typename Fn>
cudaError_t with_kind(int dtype, int fmt, Fn&& fn) {
  if (dtype == s2fp8::kF32)
    return fmt == s2fp8::kE5M2 ? fn(Kind<float, s2fp8::kE5M2>{})
                               : fn(Kind<float, s2fp8::kE4M3>{});
  return fmt == s2fp8::kE5M2 ? fn(Kind<__nv_bfloat16, s2fp8::kE5M2>{})
                             : fn(Kind<__nv_bfloat16, s2fp8::kE4M3>{});
}

__device__ __forceinline__ long long thread_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_threads() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// ---------------------------------------------------------------------------
// The code table: build and check.
// ---------------------------------------------------------------------------

// f32 in the order of its values: key 0 is +-0, +-0x7f800000 are +-inf.
__device__ __forceinline__ float key_to_float(long long key) {
  return key >= 0 ? __int_as_float(static_cast<int>(key))
                  : __int_as_float(static_cast<int>(0x80000000u |
                                                    static_cast<unsigned>(-key)));
}

// One block: thr[k] by bisection over the f32 keys for the least t with
// direct_mag(t) >= k, and base[b] = direct_mag at bucket b's least t.
template <int F>
__global__ void build_code_table_kernel(CodeTable* out) {
  const int k = threadIdx.x;
  if (k < 128) {
    float thr;
    if (k == 0) {
      thr = __int_as_float(0xff800000);              // -inf, never read
    } else if (k > static_cast<int>(s2fp8::max_code<F>())) {
      thr = __int_as_float(0x7fffffff);              // NaN: never reached
    } else {
      long long lo = -0x7f800000LL, hi = 0x7f800000LL;
      while (lo < hi) {
        long long mid = lo + (hi - lo) / 2;
        if (static_cast<int>(s2fp8::direct_mag(key_to_float(mid), F)) >= k)
          hi = mid;
        else
          lo = mid + 1;
      }
      thr = key_to_float(lo);
    }
    out->thr[k] = thr;
  }
  for (int b = threadIdx.x; b < s2fp8::kBuckets; b += blockDim.x) {
    float t = b == 0 ? __int_as_float(0xff800000)
                     : static_cast<float>(b + s2fp8::kBucketT0 *
                                                  s2fp8::kBucketsPerUnit) /
                           static_cast<float>(s2fp8::kBucketsPerUnit);
    out->base[b] = static_cast<unsigned char>(s2fp8::direct_mag(t, F));
  }
}

// Every f32 bit pattern t, both signs: the table's byte against the direct
// map's (to_fp8 of +-exp2f(t), as ``encode``).  Counts the mismatches and
// keeps the least mismatching pattern (integer atomics only).
template <int F>
__global__ void __launch_bounds__(256)
    code_sweep_kernel(const CodeTable* __restrict__ table,
                      unsigned long long* bad, unsigned int* first) {
  __shared__ CodeTable tab;
  s2fp8::load_code_table(tab, table);
  __syncthreads();
  unsigned long long mine = 0;
  unsigned int least = 0xffffffffu;
  for (unsigned long long i = thread_index(); i < (1ULL << 32);
       i += grid_threads()) {
    float t = __uint_as_float(static_cast<unsigned int>(i));
    float y = exp2f(t);
#pragma unroll
    for (int neg = 0; neg < 2; ++neg) {
      unsigned int direct = s2fp8::to_fp8(neg ? -y : y, F);
      if (direct != s2fp8::code_from_t<F>(t, neg, tab)) {
        ++mine;
        least = min(least, static_cast<unsigned int>(i));
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mine += __shfl_down_sync(0xffffffffu, mine, off);
    least = min(least, __shfl_down_sync(0xffffffffu, least, off));
  }
  if ((threadIdx.x & 31) == 0 && mine) {
    atomicAdd(bad, mine);
    atomicMin(first, least);
  }
}

// ---------------------------------------------------------------------------
// Quantize-apply.
// ---------------------------------------------------------------------------

// V code bytes to p: one 4- or 8-byte store where p is aligned for it.
template <int V>
__device__ __forceinline__ void store_codes(unsigned char* p,
                                            const unsigned int (&c)[V],
                                            bool packed) {
  if (packed) {
    unsigned int w[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      w[i] = c[4 * i] | (c[4 * i + 1] << 8) | (c[4 * i + 2] << 16) |
             (c[4 * i + 3] << 24);
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<unsigned int*>(p) = w[0];
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = static_cast<unsigned char>(c[e]);
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(256)
    quant_apply_kernel(const T* __restrict__ x,
                       unsigned char* __restrict__ out, long long n,
                       const float* __restrict__ ab,
                       const CodeTable* __restrict__ table) {
  constexpr int V = kVec<T>, U = kKeepVecs<T>;
  __shared__ CodeTable tab;
  s2fp8::load_code_table(tab, table);
  const float alpha = ab[0], beta = ab[1];
  __syncthreads();
  const VecSplit<T> s(x, n);
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.head);
  unsigned char* o = out + s.head;
  const bool packed = reinterpret_cast<unsigned long long>(o) % V == 0;
  const long long grid = grid_threads(), g = thread_index();
  for (long long j0 = g; j0 < s.nvec; j0 += U * grid) {
    uint4 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (j0 + k * grid < s.nvec) v[k] = xv[j0 + k * grid];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long j = j0 + k * grid;
      if (j >= s.nvec) break;
      unsigned int c[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        c[e] = s2fp8::encode_table<F>(s2fp8::vec_elem<T>(v[k], e), alpha,
                                      beta, tab);
      store_codes<V>(o + j * V, c, packed);
    }
  }
  if (g < s.edges()) {
    const long long i = s.edge_index(g);
    out[i] = static_cast<unsigned char>(s2fp8::encode_table<F>(
        s2fp8::scalar_as_f32(x, i), alpha, beta, tab));
  }
}

// ---------------------------------------------------------------------------
// Truncate-apply and dequantize.
// ---------------------------------------------------------------------------

// Raw bits of v in T (f32, or bf16 rounded to nearest even).
template <typename T>
__device__ __forceinline__ unsigned int bits_in(float v) {
  if constexpr (sizeof(T) == 4) return __float_as_uint(v);
  else return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ void store_bits(T* out, long long i,
                                           unsigned int bits) {
  if constexpr (sizeof(T) == 4)
    reinterpret_cast<unsigned int*>(out)[i] = bits;
  else
    reinterpret_cast<unsigned short*>(out)[i] =
        static_cast<unsigned short>(bits);
}

// Eq. 5 of one vector's elements as table lookups (the codes given),
// stored as one 16-byte word where the output is aligned for it.
template <typename T>
__device__ __forceinline__ void store_truncated(
    const unsigned int (&c)[kVec<T>], const unsigned int* lut, T* o,
    bool aligned) {
  constexpr int V = kVec<T>;
  unsigned int b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) b[e] = lut[c[e]];
  if (aligned) {
    uint4 w;
    if constexpr (V == 4)
      w = make_uint4(b[0], b[1], b[2], b[3]);
    else
      w = make_uint4(b[0] | (b[1] << 16), b[2] | (b[3] << 16),
                     b[4] | (b[5] << 16), b[6] | (b[7] << 16));
    *reinterpret_cast<uint4*>(o) = w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) store_bits<T>(o, e, b[e]);
  }
}

// Eq. 4 of every code as raw bits in T: lut[c] = decode(c) rounded to T.
// Every thread of the block calls it, then the block syncs.
template <typename T, int F>
__device__ __forceinline__ void fill_value_lut(unsigned int* lut, float alpha,
                                               float beta) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x)
    lut[c] = bits_in<T>(
        s2fp8::decode(static_cast<unsigned char>(c), alpha, beta, F));
}

// Eq. 5 of this thread's kKeepVecs rounds from vector j0 on (vectors j0,
// j0 + grid, ...): loads them, encodes through the code table and stores
// lut[code].
template <typename T, int F>
__device__ __forceinline__ void truncate_rounds(
    const uint4* __restrict__ xv, long long nvec, long long j0,
    long long grid, float alpha, float beta, const CodeTable& tab,
    const unsigned int* lut, T* o, bool aligned) {
  constexpr int V = kVec<T>, U = kKeepVecs<T>;
  uint4 v[U];
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (j0 + k * grid < nvec) v[k] = xv[j0 + k * grid];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long j = j0 + k * grid;
    if (j >= nvec) break;
    unsigned int c[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      c[e] = s2fp8::encode_table<F>(s2fp8::vec_elem<T>(v[k], e), alpha, beta,
                                    tab);
    store_truncated<T>(c, lut, o + j * V, aligned);
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(256)
    truncate_apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                          long long n, const float* __restrict__ ab,
                          const CodeTable* __restrict__ table) {
  __shared__ CodeTable tab;
  __shared__ unsigned int lut[256];
  s2fp8::load_code_table(tab, table);
  const float alpha = ab[0], beta = ab[1];
  fill_value_lut<T, F>(lut, alpha, beta);
  __syncthreads();
  const VecSplit<T> s(x, n);
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.head);
  T* o = out + s.head;
  const bool aligned = reinterpret_cast<unsigned long long>(o) % 16 == 0;
  const long long grid = grid_threads(), g = thread_index();
  for (long long j0 = g; j0 < s.nvec; j0 += kKeepVecs<T> * grid)
    truncate_rounds<T, F>(xv, s.nvec, j0, grid, alpha, beta, tab, lut, o,
                          aligned);
  if (g < s.edges()) {
    const long long i = s.edge_index(g);
    store_bits<T>(out, i, lut[s2fp8::encode_table<F>(
                              s2fp8::scalar_as_f32(x, i), alpha, beta, tab)]);
  }
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

// ---------------------------------------------------------------------------
// Statistics and the fused truncate.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(s2fp8::kStatsThreads)
    stats_partials_kernel(const T* __restrict__ x, long long n,
                          StatsPartial* parts) {
  __shared__ StatsPartial smem[32];
  s2fp8::Kept<T> unused;
  StatsPartial p = s2fp8::stats_block_reduce(
      s2fp8::stats_thread_partial<T, false>(x, n, unused), smem);
  if (threadIdx.x == 0) parts[blockIdx.x] = p;
}

__global__ void __launch_bounds__(s2fp8::kStatsThreads)
    stats_finish_kernel(const StatsPartial* parts, int nparts,
                        float* __restrict__ triplet, float* __restrict__ ab,
                        float target_max) {
  __shared__ StatsPartial smem[32];
  StatsPartial t = s2fp8::stats_reduce_partials(parts, nparts, smem);
  if (threadIdx.x == 0) s2fp8::stats_finish(t, target_max, triplet, ab);
}

// Blocks of the fused truncate a SM holds at once: 64 registers a thread,
// so the grid keeps 4 x 132 x 256 x kKeepElems elements in registers.
constexpr int kFusedBlocksPerSm = 4;

template <typename T, int F>
__global__ void __launch_bounds__(s2fp8::kStatsThreads, kFusedBlocksPerSm)
    truncate_fused_kernel(const T* __restrict__ x, T* __restrict__ out,
                          long long n, StatsPartial* parts,
                          float* __restrict__ triplet, float* ab_out,
                          float target_max,
                          const CodeTable* __restrict__ table) {
  constexpr int V = kVec<T>, KV = kKeepVecs<T>;
  __shared__ StatsPartial smem[32];
  __shared__ CodeTable tab;
  __shared__ unsigned int lut[256];
  s2fp8::load_code_table(tab, table);
  // phase 0: this block's partial, as stats_partials_kernel computes it,
  // keeping the thread's first batch and its log2 in registers
  s2fp8::Kept<T> kept;
  StatsPartial p = s2fp8::stats_block_reduce(
      s2fp8::stats_thread_partial<T, true>(x, n, kept), smem);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = p;
    __threadfence();
  }
  cooperative_groups::grid_group grid_sync = cooperative_groups::this_grid();
  grid_sync.sync();
  // block 0 sums the partials once, in index order, and publishes
  if (blockIdx.x == 0) {
    StatsPartial t = s2fp8::stats_reduce_partials(parts, gridDim.x, smem);
    if (threadIdx.x == 0) {
      s2fp8::stats_finish(t, target_max, triplet, ab_out);
      __threadfence();
    }
  }
  grid_sync.sync();
  const float alpha = __ldcg(&ab_out[0]), beta = __ldcg(&ab_out[1]);
  fill_value_lut<T, F>(lut, alpha, beta);
  __syncthreads();
  // phase 1: Eq. 5 with those stats; the kept batch first, then the rest
  // re-read, last round first
  const VecSplit<T> s(x, n);
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.head);
  T* o = out + s.head;
  const bool aligned = reinterpret_cast<unsigned long long>(o) % 16 == 0;
  const long long grid = grid_threads(), g = thread_index();
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const long long j = g + k * grid;
    if (j >= s.nvec) break;
    unsigned int c[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      c[e] = s2fp8::encode_log<F>(s2fp8::vec_elem<T>(kept.v[k], e),
                                  kept.logs[k][e], alpha, beta, tab);
    store_truncated<T>(c, lut, o + j * V, aligned);
  }
  const long long step = KV * grid;
  if (g + step < s.nvec) {
    for (long long j0 = g + (s.nvec - 1 - g) / step * step; j0 > g;
         j0 -= step)
      truncate_rounds<T, F>(xv, s.nvec, j0, grid, alpha, beta, tab, lut, o,
                            aligned);
  }
  if (g < s.edges()) {
    const long long i = s.edge_index(g);
    store_bits<T>(out, i, lut[s2fp8::encode_table<F>(
                              s2fp8::scalar_as_f32(x, i), alpha, beta, tab)]);
  }
}

// ---------------------------------------------------------------------------
// Grids and launches.
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

int grid_for(long long n) {
  long long blocks = (n + 255) / 256;
  const long long cap = 132LL * 32;  // 32 resident-block waves of 132 SMs
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

cudaError_t sm_count(int* sms) {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

// The grid of quantize-apply (kTruncate false) or truncate-apply: one
// block of 256 threads per 256 vectors, at most the blocks the card holds
// at once (one wave; a 2304 x 2304 bf16 weight fills it).
template <typename T, int F, bool kTruncate>
cudaError_t apply_grid(long long n, int* grid) {
  static int per_sm[kMaxDevices] = {0};
  int sms = 0, dev = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (per_sm[dev] == 0) {
    if constexpr (kTruncate)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[dev], truncate_apply_kernel<T, F>, 256, 0);
    else
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[dev], quant_apply_kernel<T, F>, 256, 0);
    if (err != cudaSuccess) return err;
    if (per_sm[dev] <= 0) return cudaErrorInvalidConfiguration;
  }
  const long long cap = static_cast<long long>(sms) * per_sm[dev];
  long long blocks = ((n + kVec<T> - 1) / kVec<T> + 255) / 256;
  if (blocks < 1) blocks = 1;
  *grid = static_cast<int>(blocks < cap ? blocks : cap);
  return cudaSuccess;
}

template <typename T, int F>
cudaError_t fused_blocks_per_sm(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, truncate_fused_kernel<T, F>, s2fp8::kStatsThreads, 0);
}

// The stats grid for n elements: one block per kStatsThreads x kKeepElems
// elements (so the fused truncate keeps a whole small tensor in registers
// with as few blocks as that takes), at most the fused truncate's blocks
// that fit on the card at once (the cooperative launch's limit; the least
// over its dtypes and formats).  A function of n and the card alone.
// Returns 0 after an error.
int stats_grid(long long n, cudaError_t* err) {
  static int cap[kMaxDevices] = {0};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < 0 || dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cap[dev] == 0) {
    int sms = 0, per_sm[4] = {0, 0, 0, 0};
    if ((*err = sm_count(&sms)) != cudaSuccess ||
        (*err = fused_blocks_per_sm<float, s2fp8::kE5M2>(&per_sm[0])) !=
            cudaSuccess ||
        (*err = fused_blocks_per_sm<float, s2fp8::kE4M3>(&per_sm[1])) !=
            cudaSuccess ||
        (*err = fused_blocks_per_sm<__nv_bfloat16, s2fp8::kE5M2>(
             &per_sm[2])) != cudaSuccess ||
        (*err = fused_blocks_per_sm<__nv_bfloat16, s2fp8::kE4M3>(
             &per_sm[3])) != cudaSuccess)
      return 0;
    int least = std::min(std::min(per_sm[0], per_sm[1]),
                         std::min(per_sm[2], per_sm[3]));
    if (sms * least <= 0) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    cap[dev] = sms * least;
  }
  const long long per_block =
      static_cast<long long>(s2fp8::kStatsThreads) * s2fp8::kKeepElems;
  long long blocks = (n + per_block - 1) / per_block;
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
  if (static_cast<long long>(grid) * sizeof(StatsPartial) > scratch_bytes)
    return cudaErrorInvalidValue;
  auto* parts = static_cast<StatsPartial*>(scratch);
  if (x_dtype == s2fp8::kF32)
    stats_partials_kernel<float><<<grid, s2fp8::kStatsThreads, 0, stream>>>(
        static_cast<const float*>(x), n, parts);
  else
    stats_partials_kernel<__nv_bfloat16>
        <<<grid, s2fp8::kStatsThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), n, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_finish_kernel<<<1, s2fp8::kStatsThreads, 0, stream>>>(
      parts, grid, triplet, ab, target_max);
  return cudaGetLastError();
}

cudaError_t launch_quant_apply(const void* x, int x_dtype, void* out,
                               long long n, const void* ab, int fmt,
                               const void* table, cudaStream_t stream) {
  return with_kind(x_dtype, fmt, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int F = decltype(kind)::fmt;
    int grid = 0;
    cudaError_t err = apply_grid<T, F, false>(n, &grid);
    if (err != cudaSuccess) return err;
    quant_apply_kernel<T, F><<<grid, 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<unsigned char*>(out), n,
        static_cast<const float*>(ab), static_cast<const CodeTable*>(table));
    return cudaGetLastError();
  });
}

}  // namespace

// The code table's layout: out[0] its size in bytes, out[1] the byte
// offset of thr, out[2] its length (f32); the wrapper allocates and reads
// the table by these.
extern "C" int s2fp8_code_table_layout(long long* out) {
  out[0] = sizeof(CodeTable);
  out[1] = offsetof(CodeTable, thr);
  out[2] = sizeof(CodeTable::thr) / sizeof(float);
  return 0;
}

extern "C" int s2fp8_code_table(void* out, int fmt, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* tab = static_cast<CodeTable*>(out);
  if (fmt == s2fp8::kE5M2)
    build_code_table_kernel<s2fp8::kE5M2><<<1, 1024, 0, s>>>(tab);
  else
    build_code_table_kernel<s2fp8::kE4M3><<<1, 1024, 0, s>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s2fp8_code_sweep(const void* table, int fmt, void* bad,
                                void* first, void* stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto* tab = static_cast<const CodeTable*>(table);
  auto* b = static_cast<unsigned long long*>(bad);
  auto* f = static_cast<unsigned int*>(first);
  if (fmt == s2fp8::kE5M2)
    code_sweep_kernel<s2fp8::kE5M2><<<8 * sms, 256, 0, s>>>(tab, b, f);
  else
    code_sweep_kernel<s2fp8::kE4M3><<<8 * sms, 256, 0, s>>>(tab, b, f);
  return static_cast<int>(cudaGetLastError());
}

// *out: the most elements the fused truncate keeps in registers across
// its grid barrier on the current card.
extern "C" int s2fp8_fused_capacity(long long* out) {
  cudaError_t err;
  int grid = stats_grid(1LL << 40, &err);
  if (grid == 0) return static_cast<int>(err);
  *out = static_cast<long long>(grid) * s2fp8::kStatsThreads *
         s2fp8::kKeepElems;
  return 0;
}

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
                           const void* table, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_stats(x, x_dtype, n, scratch, scratch_bytes,
                                 static_cast<float*>(triplet),
                                 static_cast<float*>(ab), target_max, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_quant_apply(x, x_dtype, out, n, ab, fmt, table, s));
}

extern "C" int s2fp8_truncate_fused(const void* x, int x_dtype, void* out,
                                    long long n, void* scratch,
                                    long long scratch_bytes, void* triplet,
                                    void* ab, float target_max, int fmt,
                                    const void* table, void* stream) {
  cudaError_t err;
  int grid = stats_grid(n, &err);
  if (grid == 0) return static_cast<int>(err);
  if (static_cast<long long>(grid) * sizeof(StatsPartial) > scratch_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* parts = static_cast<StatsPartial*>(scratch);
  auto* tri = static_cast<float*>(triplet);
  auto* abp = static_cast<float*>(ab);
  auto* tab = static_cast<const CodeTable*>(table);
  return static_cast<int>(with_kind(x_dtype, fmt, [&](auto kind) {
    using T = typename decltype(kind)::type;
    auto* xt = static_cast<const T*>(x);
    auto* ot = static_cast<T*>(out);
    void* args[] = {&xt, &ot, &n, &parts, &tri, &abp, &target_max, &tab};
    cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(
            truncate_fused_kernel<T, decltype(kind)::fmt>),
        dim3(grid), dim3(s2fp8::kStatsThreads), args, 0,
        static_cast<cudaStream_t>(stream));
    return e != cudaSuccess ? e : cudaGetLastError();
  }));
}

extern "C" int s2fp8_quant_apply(const void* x, int x_dtype, void* out,
                                 long long n, const void* ab, int fmt,
                                 const void* table, void* stream) {
  return static_cast<int>(launch_quant_apply(
      x, x_dtype, out, n, ab, fmt, table,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int s2fp8_truncate_apply(const void* x, int x_dtype, void* out,
                                    long long n, const void* ab, int fmt,
                                    const void* table, void* stream) {
  return static_cast<int>(with_kind(x_dtype, fmt, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int F = decltype(kind)::fmt;
    int grid = 0;
    cudaError_t err = apply_grid<T, F, true>(n, &grid);
    if (err != cudaSuccess) return err;
    truncate_apply_kernel<T, F>
        <<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<T*>(out), n,
            static_cast<const float*>(ab),
            static_cast<const CodeTable*>(table));
    return cudaGetLastError();
  }));
}

extern "C" int s2fp8_dequant(const void* payload, void* out, long long n,
                             const void* ab, int fmt, void* stream) {
  dequant_kernel<<<grid_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(payload), static_cast<float*>(out), n,
      static_cast<const float*>(ab), fmt);
  return static_cast<int>(cudaGetLastError());
}
