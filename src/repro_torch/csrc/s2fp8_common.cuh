// The one device-side copy of the S2FP8 element maps (paper Eq. 2-5).
//
// Every kernel of the port uses these bodies: the quantize and truncate
// kernels, the payload GEMM's dequant table and Eq. 5 epilogue, the flash
// kernel's dequant table and epilogue, and the paged-decode dequant table.
// It is the counterpart of ``_truncate_body`` / ``_dequant`` in
// src/repro/kernels/s2fp8_quant.py and s2fp8_matmul.py.  Also here: the
// exp2-free encode that quantize-apply, truncate-apply, quantize-with-stats
// and the fused truncate run (the card's code table), their 16-byte vector
// I/O, and the statistics reduction (Eq. 3-4) with the element map that the
// stats kernel and the two fused kernels share, and
// ``stats_from_reduction``.
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

#include <cuda/atomic>

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

// ---------------------------------------------------------------------------
// The exp2-free encode.  The payload byte's magnitude is a non-decreasing
// step function of t = alpha * log2|x| + beta: exp2f, the clamp at the
// format's max finite and the RNE convert with SATFINITE.  Its steps
// depend on the format alone, not on (alpha, beta) or the input dtype.  So
// a table built once per card and format (build_code_table_kernel, with
// the very exp2f and to_fp8 of ``encode``) replaces them per element:
// ``thr[k]`` is the least t whose magnitude code is >= k (k = 1..127; NaN
// past the format's max code, so no t reaches it), and ``base[b]`` the
// code at the start of bucket b, t in [b / 16 - 32, (b + 1) / 16 - 32)
// (the first and last buckets open-ended).  Neighbouring thresholds are at
// least 0.096 apart in t for both formats, so a 1/16-wide bucket holds at
// most one: the code is base[b], plus one if t >= thr[base[b] + 1].  That
// equals the direct map wherever exp2f is non-decreasing; the sweep
// kernel checks every f32 t against ``encode``'s arithmetic.
// ---------------------------------------------------------------------------

constexpr int kBucketsPerUnit = 16;
constexpr int kBucketT0 = -32;                       // buckets cover [-32, 32)
constexpr int kBuckets = 64 * kBucketsPerUnit;

struct alignas(16) CodeTable {
  float thr[128];
  unsigned char base[kBuckets];
};

template <int F>
__host__ __device__ constexpr unsigned int max_code() {
  return F == kE5M2 ? 0x7Bu : 0x7Eu;   // 57344 and 448
}

// The magnitude code of t by the direct map (exp2f, clamp, convert).
__device__ __forceinline__ unsigned int direct_mag(float t, int fmt) {
  return to_fp8(exp2f(t), fmt) & 0x7Fu;
}

// ``encode``'s byte for a nonzero x with t = alpha * log2|x| + beta, by the
// table: the sign bit of x, and for a NaN t (which only non-finite stats
// give) the byte ``to_fp8`` makes of NaN, the negative max finite.
template <int F>
__device__ __forceinline__ unsigned int code_from_t(float t, bool neg,
                                                    const CodeTable& tab) {
  constexpr int kLo = kBucketT0 * kBucketsPerUnit;
  // floor(16 t), saturated by the convert for |t| past 2^27 (NaN gives 0)
  int b = __float2int_rd(t * static_cast<float>(kBucketsPerUnit));
  b = min(max(b, kLo), kLo + kBuckets - 1) - kLo;
  unsigned int c = tab.base[b];
  c += t >= tab.thr[c + 1] ? 1u : 0u;
  c |= neg ? 0x80u : 0u;
  return t == t ? c : (0x80u | max_code<F>());
}

// The payload byte of x (``encode``) from l = log2f(|x|) and x's sign bit:
// zeros (l = -inf) and NaNs (l NaN) give 0, whatever the sign bit; the
// multiply and add round as ``forward_map``'s.
template <int F>
__device__ __forceinline__ unsigned int encode_log(float l, bool neg,
                                                   float alpha, float beta,
                                                   const CodeTable& tab) {
  unsigned int c = code_from_t<F>(__fadd_rn(__fmul_rn(alpha, l), beta), neg,
                                  tab);
  return l > __int_as_float(0xff800000) ? c : 0u;
}

template <int F>
__device__ __forceinline__ unsigned int encode_table(float x, float alpha,
                                                     float beta,
                                                     const CodeTable& tab) {
  return encode_log<F>(log2f(fabsf(x)), __float_as_uint(x) >> 31, alpha, beta,
                        tab);
}

// Copies the table into shared memory: every thread of the block calls
// it, then the block syncs.
__device__ __forceinline__ void load_code_table(CodeTable& dst,
                                                const CodeTable* src) {
  constexpr int kWords = sizeof(CodeTable) / 16;
  for (int i = threadIdx.x; i < kWords; i += blockDim.x)
    reinterpret_cast<uint4*>(&dst)[i] =
        __ldg(reinterpret_cast<const uint4*>(src) + i);
}

// ---------------------------------------------------------------------------
// Vector I/O: 16 bytes a thread a step (4 f32 or 8 bf16).  An element of a
// 16-byte word as f32, and the element type's raw bits packed back.
// ---------------------------------------------------------------------------

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ unsigned int word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ float vec_elem(const uint4& v, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word_of(v, e));
  } else {
    unsigned int w = word_of(v, e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T>
__device__ __forceinline__ float scalar_as_f32(const T* p, long long i) {
  if constexpr (sizeof(T) == 4) return p[i];
  else return __bfloat162float(p[i]);
}

// The split of a flat tensor of n elements at x into the head (elements
// before x's first 16-byte boundary, fewer than kVec), nvec whole 16-byte
// vectors, and the tail.  Head and tail are the "edge" elements, numbered
// head first.
template <typename T>
struct VecSplit {
  long long head, nvec, n;
  __device__ __forceinline__ VecSplit(const T* x, long long n_) : n(n_) {
    head = static_cast<long long>(
        ((16u - (reinterpret_cast<unsigned long long>(x) & 15u)) & 15u) /
        sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / kVec<T>;
  }
  __device__ __forceinline__ long long edges() const {
    return n - nvec * kVec<T>;
  }
  __device__ __forceinline__ long long edge_index(long long e) const {
    return e < head ? e : e + nvec * kVec<T>;
  }
};

// ---------------------------------------------------------------------------
// Statistics (Eq. 3-4): (sum log2|x|, max log2|x|, nonzero count) over the
// nonzero elements.  Zeros and NaNs are left out (their log2 is -inf or
// NaN, never above -inf), as in the reference.  The sum is kept in f64 and
// the count in 64-bit integers past the thread (32 bits in it: a thread
// sees far fewer than 2^32 elements), so the result does not depend on the
// grid beyond f64 rounding; every reduction below runs in a fixed order (no
// float atomics), so a tensor gives the same bits on every run with the
// same grid.
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

// A thread's running share.
struct ThreadStats {
  double sum;
  float max;
  unsigned int count;
};

// Adds l = log2f(|x|) of one element.
__device__ __forceinline__ void stats_add(ThreadStats& p, float l) {
  if (l > __int_as_float(0xff800000)) {
    p.sum += static_cast<double>(l);
    p.max = fmaxf(p.max, l);
    p.count += 1;
  }
}

// The sign bit of element e of a 16-byte vector.
template <typename T>
__device__ __forceinline__ unsigned int vec_sign(const uint4& v, int e) {
  if constexpr (sizeof(T) == 4)
    return word_of(v, e) >> 31;
  else
    return (word_of(v, e >> 1) >> ((e & 1) ? 31 : 15)) & 1u;
}

// The element map the stats kernel and the fused kernels' phase 0 share (so
// they give equal partials for equal inputs).  With G threads in the grid
// (VecSplit above): whole vector j goes to thread j mod G, in round j / G;
// edge element e to thread e.  A thread sums in round order, each vector's
// elements in order, the edge element last.  The grid has one block per
// kStatsThreads x kGridElems elements, up to what the card holds.  The
// fused kernels keep what they need to encode a thread's elements after
// their grid barrier without reading x or taking a log2 again: the log2
// and the sign bit of its first kKeepElems elements (kKeepVecs<T> rounds)
// in registers (``Kept``), and of the next ``SharedKeep::rounds`` rounds in
// shared memory.  (The edge elements, fewer than two vectors' worth in
// all, are read again.)
constexpr int kGridElems = 16;
constexpr int kKeepElems = 8;
template <typename T>
constexpr int kKeepVecs = kKeepElems / kVec<T>;

struct Kept {
  float logs[kKeepElems];   // round k, element e at k * kVec<T> + e
  unsigned int neg;         // their sign bits
};

// Round kKeepVecs<T> + q of thread t (q < rounds) keeps element e's log2 at
// logs[(q * kVec<T> + e) * blockDim.x + t] and its sign bits at
// neg[q * blockDim.x + t] (bit e): a warp reads and writes consecutive
// words.  The wrapper sizes the dynamic shared memory to ``rounds``.
struct SharedKeep {
  float* logs;
  unsigned char* neg;
  int rounds;
};

// Loads NV rounds of this thread from vector v on (v, v + grid, ...; none
// at or past end).
template <int NV>
__device__ __forceinline__ void load_rounds(const uint4* v, const uint4* end,
                                            int grid, uint4 (&r)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (v + k * grid < end) r[k] = v[k * grid];
}

// This thread's partial of x under the map above.  Past the register batch
// the rounds stream NS at a time, the next NS's loads issued before this
// batch's log2 are taken.  NS changes when x is loaded, not the order of
// the sums, so the stats kernel (deeper) and the fused kernels (fewer
// registers beside the kept ones) give the same bits.  Vectors are walked
// by pointer (fewer registers than 64-bit indices).
template <typename T, int NS, bool kKeep>
__device__ __forceinline__ StatsPartial stats_thread_partial(
    const T* x, long long n, Kept& keep, const SharedKeep& sk) {
  constexpr int V = kVec<T>, KV = kKeepVecs<T>;
  const VecSplit<T> s(x, n);
  const uint4* const xv = reinterpret_cast<const uint4*>(x + s.head);
  const uint4* const end = xv + s.nvec;
  const int grid = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* v = xv + g;                          // this thread's round 0
  ThreadStats p{0.0, __int_as_float(0xff800000), 0u};
  if constexpr (kKeep) {
    uint4 r[KV];
    load_rounds<KV>(v, end, grid, r);
    keep.neg = 0u;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      if (v + k * grid >= end) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float l = log2f(fabsf(vec_elem<T>(r[k], e)));
        stats_add(p, l);
        keep.logs[k * V + e] = l;
        keep.neg |= vec_sign<T>(r[k], e) << (k * V + e);
      }
    }
    v += KV * grid;
  }
  uint4 cur[NS];
  load_rounds<NS>(v, end, grid, cur);
  for (int q = 0; v < end; v += NS * grid, q += NS) {
    uint4 next[NS];
    load_rounds<NS>(v + NS * grid, end, grid, next);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (v + k * grid >= end) break;
      const bool shared = kKeep && q + k < sk.rounds;
      unsigned int neg = 0u;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float l = log2f(fabsf(vec_elem<T>(cur[k], e)));
        stats_add(p, l);
        if (shared) {
          sk.logs[((q + k) * V + e) * blockDim.x + threadIdx.x] = l;
          neg |= vec_sign<T>(cur[k], e) << e;
        }
      }
      if (shared)
        sk.neg[(q + k) * blockDim.x + threadIdx.x] =
            static_cast<unsigned char>(neg);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) cur[k] = next[k];
  }
  if (g < s.edges())
    stats_add(p, log2f(fabsf(scalar_as_f32(x, s.edge_index(g)))));
  return StatsPartial{p.sum, p.max, static_cast<long long>(p.count)};
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

// Total over the per-block partials, valid in thread 0: thread t combines
// partials t, t + blockDim.x, ... in index order (four loads in flight),
// then the block reduces, so every block that calls it on the same
// partials gets the same bits.  The partials are read through L2
// (__ldcg): the kernels read them in the launch that wrote them.
__device__ __forceinline__ StatsPartial stats_reduce_partials(
    const StatsPartial* parts, int nparts, StatsPartial* smem) {
  constexpr int kBatch = 4;   // loads in flight a thread
  StatsPartial p = stats_identity();
  for (int i0 = threadIdx.x; i0 < nparts; i0 += kBatch * blockDim.x) {
    StatsPartial q[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < nparts)
        q[k] = StatsPartial{__ldcg(&parts[i].sum), __ldcg(&parts[i].max),
                            __ldcg(&parts[i].count)};
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i0 + k * static_cast<int>(blockDim.x) < nparts)
        p = stats_combine(p, q[k]);
  }
  return stats_block_reduce(p, smem);
}

// Counts a block in on the launch's ticket (acquire-release at device
// scope: what the block wrote before is visible to the block that sees
// the count of the others, which acquires it) and returns the count before.
__device__ __forceinline__ unsigned int arrive(unsigned int* ticket) {
  return cuda::atomic_ref<unsigned int, cuda::thread_scope_device>(*ticket)
      .fetch_add(1u, cuda::memory_order_acq_rel);
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
