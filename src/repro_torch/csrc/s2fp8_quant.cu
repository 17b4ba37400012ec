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
// Statistics (stats_kernel<T>, one launch): bound by bytes on f32 (one
// read of x) and by log2f on bf16 (about 36 issue slots an element with
// the f64 add, the max and the count).  A TPU grid runs in order and
// carries the sums from one step to the next; here blocks run in no order,
// so each block reduces its threads' shares (the element map of
// s2fp8_common.cuh: 16-byte vectors, round-robin over the grid's threads,
// four rounds a thread in flight; warp shuffles, then the block, in a fixed
// order) to one partial, and the last block to finish (an integer ticket,
// which it sets back to 0 for the stream's next launch) sums the partials
// in index order and writes the triplet and (alpha, beta).  No float
// atomics: the same tensor gives the same bits on every run.  The grid is a
// function of n and the card alone (``stats_grid``: one block per 4,096
// elements, at most the fused kernels' blocks that fit on the card at
// once), so the stats kernel and the fused kernels' phase 0 give equal
// partials.
//
// Quantize-with-stats (quant_fused_kernel<T, F>) and the fused truncate
// (truncate_fused_kernel<T, F>) share one body, a cooperative launch that
// reads x once and takes each element's log2f once wherever the card can
// keep it: phase 0 is the stats kernel's partial, keeping each thread's
// log2 and sign bits, its first 8 elements in registers and its next
// rounds in dynamic shared memory (as many as leave 4 blocks of 256 on a
// SM: 40 elements a thread on the H100, 6.49 M elements in all); the last
// block to arrive sums the partials as the stats kernel does and
// publishes them before the launch's one grid barrier (no second barrier
// and no serial finish after it); then the kept elements are encoded from
// their kept log2 (``encode_log``), the rest re-read last round first
// (the reads phase 0 left in the 50 MB L2 are the first taken again) and
// encoded as quantize-apply encodes.  The payload is stored as
// quantize-apply stores it, the truncate writes lut[code], so quant(x)
// equals quant_apply(x, stats(x)) and truncate_fused(x) equals
// truncate_apply(x, stats(x)), bit for bit.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstddef>
#include <type_traits>

#include "s2fp8_common.cuh"

namespace {

using s2fp8::CodeTable;
using s2fp8::kVec;
using s2fp8::SharedKeep;
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
// Encoded output: payload codes (quantize) or Eq. 5 in x's dtype (truncate).
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

// Where the codes of x's elements go: with kTruncate, Eq. 5 as lut[code]
// in x's dtype (16-byte stores where aligned), else the payload bytes
// (4- or 8-byte stores where aligned).  Vector j is x's whole vector j
// (after the head), element i is x's element i.
template <typename T, bool kTruncate>
struct Emit {
  using Out = std::conditional_t<kTruncate, T, unsigned char>;
  Out* out;
  long long head;
  const unsigned int* lut;
  bool aligned;
  __device__ __forceinline__ Emit(Out* o, long long h, const unsigned int* l)
      : out(o), head(h), lut(l) {
    aligned = reinterpret_cast<unsigned long long>(o + h) %
                  (kTruncate ? 16 : kVec<T>) == 0;
  }
  __device__ __forceinline__ void vec(long long j,
                                      const unsigned int (&c)[kVec<T>]) const {
    if constexpr (kTruncate)
      store_truncated<T>(c, lut, out + head + j * kVec<T>, aligned);
    else
      store_codes<kVec<T>>(out + head + j * kVec<T>, c, aligned);
  }
  __device__ __forceinline__ void scalar(long long i, unsigned int c) const {
    if constexpr (kTruncate)
      store_bits<T>(out, i, lut[c]);
    else
      out[i] = static_cast<unsigned char>(c);
  }
};

// Rounds a thread of the apply kernels (and of the fused kernels' re-read)
// loads at a time: 64 bytes.
template <typename T>
constexpr int kApplyVecs = 16 / kVec<T>;

// Vectors j0, j0 + grid, ... (NV of them, none at or past nvec).
template <int NV>
__device__ __forceinline__ void load_at(const uint4* __restrict__ xv,
                                        long long nvec, long long j0,
                                        long long grid, uint4 (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (j0 + k * grid < nvec) v[k] = xv[j0 + k * grid];
}

// Encodes the NV loaded vectors j0, j0 + grid, ... through the code table
// and emits them.
template <typename T, int F, bool kTruncate, int NV>
__device__ __forceinline__ void encode_rounds(const uint4 (&v)[NV],
                                              long long nvec, long long j0,
                                              long long grid, float alpha,
                                              float beta, const CodeTable& tab,
                                              const Emit<T, kTruncate>& w) {
  constexpr int V = kVec<T>;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const long long j = j0 + k * grid;
    if (j >= nvec) break;
    unsigned int c[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      c[e] = s2fp8::encode_table<F>(s2fp8::vec_elem<T>(v[k], e), alpha, beta,
                                    tab);
    w.vec(j, c);
  }
}

// ---------------------------------------------------------------------------
// Quantize-apply, truncate-apply and dequantize.
// ---------------------------------------------------------------------------

// The body of quantize-apply (kTruncate false) and truncate-apply: every
// round of the grid's threads, then the edge elements.
template <typename T, int F, bool kTruncate>
__device__ __forceinline__ void apply_body(
    const T* __restrict__ x, typename Emit<T, kTruncate>::Out* out,
    long long n, const float* __restrict__ ab,
    const CodeTable* __restrict__ table) {
  __shared__ CodeTable tab;
  __shared__ unsigned int lut[kTruncate ? 256 : 1];
  s2fp8::load_code_table(tab, table);
  const float alpha = ab[0], beta = ab[1];
  if constexpr (kTruncate) fill_value_lut<T, F>(lut, alpha, beta);
  __syncthreads();
  const VecSplit<T> s(x, n);
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.head);
  const Emit<T, kTruncate> w(out, s.head, lut);
  const long long grid = grid_threads(), g = thread_index();
  for (long long j0 = g; j0 < s.nvec; j0 += kApplyVecs<T> * grid) {
    uint4 v[kApplyVecs<T>];
    load_at(xv, s.nvec, j0, grid, v);
    encode_rounds<T, F, kTruncate>(v, s.nvec, j0, grid, alpha, beta, tab, w);
  }
  if (g < s.edges()) {
    const long long i = s.edge_index(g);
    w.scalar(i, s2fp8::encode_table<F>(s2fp8::scalar_as_f32(x, i), alpha,
                                       beta, tab));
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(256)
    quant_apply_kernel(const T* __restrict__ x,
                       unsigned char* __restrict__ out, long long n,
                       const float* __restrict__ ab,
                       const CodeTable* __restrict__ table) {
  apply_body<T, F, false>(x, out, n, ab, table);
}

template <typename T, int F>
__global__ void __launch_bounds__(256)
    truncate_apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                          long long n, const float* __restrict__ ab,
                          const CodeTable* __restrict__ table) {
  apply_body<T, F, true>(x, out, n, ab, table);
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
// Statistics, quantize-with-stats and the fused truncate.
// ---------------------------------------------------------------------------

// Blocks of the fused kernels a SM holds at once: 64 registers a thread.
constexpr int kFusedBlocksPerSm = 4;
// Rounds a thread streams at a time past its register batch (and as many
// loads again in flight): the stats kernel keeps nothing, so it has the
// registers for four; the fused kernels, beside their kept log2, one; and
// two when they read x again.
constexpr int kStatsStreamVecs = 4;
constexpr int kFusedStreamVecs = 1;
constexpr int kRereadVecs = 2;

// The most blocks of a stats grid (the wrapper's partials scratch).
constexpr int kMaxStatsBlocks = 4096;
// Up to this many blocks every block of a fused launch sums the partials.
constexpr int kSmallGrid = 64;

// Each block's partial to parts; the last block of the launch to arrive
// (an integer ticket, kept per stream by the wrapper and set back to 0 for
// the stream's next launch) sums the partials in index order and writes
// the triplet and (alpha, beta).  Every thread of the block calls it.
__device__ __forceinline__ void reduce_last(StatsPartial p,
                                            StatsPartial* parts,
                                            unsigned int* ticket,
                                            float* __restrict__ triplet,
                                            float* __restrict__ ab,
                                            float target_max,
                                            StatsPartial* smem) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = p;
    last = s2fp8::arrive(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  StatsPartial t = s2fp8::stats_reduce_partials(parts, gridDim.x, smem);
  if (threadIdx.x == 0) {
    s2fp8::stats_finish(t, target_max, triplet, ab);
    *ticket = 0u;
  }
}

// The stats in one launch (``reduce_last``).
template <typename T>
__global__ void __launch_bounds__(s2fp8::kStatsThreads, kFusedBlocksPerSm)
    stats_kernel(const T* __restrict__ x, long long n, StatsPartial* parts,
                 unsigned int* ticket, float* __restrict__ triplet,
                 float* __restrict__ ab, float target_max) {
  __shared__ StatsPartial smem[32];
  s2fp8::Kept unused;
  reduce_last(s2fp8::stats_block_reduce(
                  s2fp8::stats_thread_partial<T, kStatsStreamVecs, false>(
                      x, n, unused, SharedKeep{}),
                  smem),
              parts, ticket, triplet, ab, target_max, smem);
}

// Quantize-with-stats (kTruncate false) and the fused truncate, one
// cooperative launch.  Phase 0 is the stats kernel's partial, keeping each
// thread's log2 and sign bits (registers, then ``smem_rounds`` rounds in
// dynamic shared memory).  The last block to arrive sums the partials as
// the stats kernel does and publishes them before the launch's one grid
// barrier, after which every block reads (alpha, beta): no block sums the
// partials but one, and none waits for a second barrier.  (With every
// block reading all 528 partials after the barrier, the reads of the same
// lines queued in the L2 for longer than the barrier itself; up to
// kSmallGrid blocks, where that costs less than the ticket's round trip,
// every block sums them after the barrier, with the same bits.)  Then the
// kept elements are encoded from their kept log2, and the rest re-read,
// last batch first (what phase 0 read last is the likeliest to be in the
// L2), the next batch's loads in flight while one is encoded.
template <typename T, int F, bool kTruncate>
__device__ __forceinline__ void fused_body(
    const T* __restrict__ x, typename Emit<T, kTruncate>::Out* out,
    long long n, StatsPartial* parts, unsigned int* ticket,
    float* __restrict__ triplet, float* __restrict__ ab_out,
    float target_max, const CodeTable* __restrict__ table, int smem_rounds) {
  constexpr int V = kVec<T>, KV = s2fp8::kKeepVecs<T>;
  __shared__ StatsPartial smem[32];
  __shared__ CodeTable tab;
  __shared__ unsigned int lut[kTruncate ? 256 : 1];
  __shared__ float ab[2];
  extern __shared__ float4 keep_words[];
  float* keep_logs = reinterpret_cast<float*>(keep_words);
  const SharedKeep sk{
      keep_logs,
      reinterpret_cast<unsigned char*>(keep_logs +
                                       smem_rounds * V * blockDim.x),
      smem_rounds};
  s2fp8::load_code_table(tab, table);
  s2fp8::Kept kept;
  const StatsPartial p = s2fp8::stats_block_reduce(
      s2fp8::stats_thread_partial<T, kFusedStreamVecs, true>(x, n, kept, sk),
      smem);
  if (gridDim.x > kSmallGrid) {
    reduce_last(p, parts, ticket, triplet, ab_out, target_max, smem);
    cooperative_groups::this_grid().sync();
    if (threadIdx.x == 0) {
      ab[0] = __ldcg(&ab_out[0]);
      ab[1] = __ldcg(&ab_out[1]);
    }
  } else {
    if (threadIdx.x == 0) parts[blockIdx.x] = p;
    cooperative_groups::this_grid().sync();
    const StatsPartial t =
        s2fp8::stats_reduce_partials(parts, gridDim.x, smem);
    if (threadIdx.x == 0) {
      float tri[3];
      s2fp8::stats_finish(t, target_max, tri, ab);
      if (blockIdx.x == 0) {
        triplet[0] = tri[0];
        triplet[1] = tri[1];
        triplet[2] = tri[2];
        ab_out[0] = ab[0];
        ab_out[1] = ab[1];
      }
    }
  }
  __syncthreads();
  const float alpha = ab[0], beta = ab[1];
  if constexpr (kTruncate) {
    fill_value_lut<T, F>(lut, alpha, beta);
    __syncthreads();
  }
  const VecSplit<T> s(x, n);
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.head);
  const Emit<T, kTruncate> w(out, s.head, lut);
  const long long grid = grid_threads(), g = thread_index();
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const long long j = g + k * grid;
    if (j >= s.nvec) break;
    unsigned int c[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      c[e] = s2fp8::encode_log<F>(kept.logs[k * V + e],
                                  (kept.neg >> (k * V + e)) & 1u, alpha, beta,
                                  tab);
    w.vec(j, c);
  }
  for (int q = 0; q < smem_rounds; ++q) {
    const long long j = g + (KV + q) * grid;
    if (j >= s.nvec) break;
    const unsigned int neg = sk.neg[q * blockDim.x + threadIdx.x];
    unsigned int c[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      c[e] = s2fp8::encode_log<F>(
          sk.logs[(q * V + e) * blockDim.x + threadIdx.x], (neg >> e) & 1u,
          alpha, beta, tab);
    w.vec(j, c);
  }
  const long long first = g + (KV + smem_rounds) * grid,
                  step = kRereadVecs * grid;
  if (first < s.nvec) {
    long long j0 = first + (s.nvec - 1 - first) / step * step;
    uint4 cur[kRereadVecs];
    load_at(xv, s.nvec, j0, grid, cur);
    for (; j0 >= first; j0 -= step) {
      uint4 next[kRereadVecs];
      if (j0 - step >= first) load_at(xv, s.nvec, j0 - step, grid, next);
      encode_rounds<T, F, kTruncate>(cur, s.nvec, j0, grid, alpha, beta, tab,
                                     w);
#pragma unroll
      for (int k = 0; k < kRereadVecs; ++k) cur[k] = next[k];
    }
  }
  if (g < s.edges()) {
    const long long i = s.edge_index(g);
    w.scalar(i, s2fp8::encode_table<F>(s2fp8::scalar_as_f32(x, i), alpha,
                                       beta, tab));
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(s2fp8::kStatsThreads, kFusedBlocksPerSm)
    quant_fused_kernel(const T* __restrict__ x,
                       unsigned char* __restrict__ out, long long n,
                       StatsPartial* parts, unsigned int* ticket,
                       float* __restrict__ triplet, float* __restrict__ ab,
                       float target_max, const CodeTable* __restrict__ table,
                       int smem_rounds) {
  fused_body<T, F, false>(x, out, n, parts, ticket, triplet, ab, target_max,
                          table, smem_rounds);
}

template <typename T, int F>
__global__ void __launch_bounds__(s2fp8::kStatsThreads, kFusedBlocksPerSm)
    truncate_fused_kernel(const T* __restrict__ x, T* __restrict__ out,
                          long long n, StatsPartial* parts,
                          unsigned int* ticket, float* __restrict__ triplet,
                          float* __restrict__ ab, float target_max,
                          const CodeTable* __restrict__ table,
                          int smem_rounds) {
  fused_body<T, F, true>(x, out, n, parts, ticket, triplet, ab, target_max,
                         table, smem_rounds);
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

// What the fused kernels may take on one card: ``cap`` blocks in all (SMs
// x the least of their resident blocks a SM, over dtypes, formats and both
// kernels: the cooperative launch's limit), and with that many resident,
// ``rounds[dtype]`` rounds a thread kept in dynamic shared memory.
struct FusedPlan {
  int cap;
  int rounds[2];   // by s2fp8::DType
};

// Dynamic shared memory of ``rounds`` kept rounds of 256 threads: V f32
// log2 and one byte of sign bits a round.
constexpr long long keep_bytes(int dtype, int rounds) {
  return static_cast<long long>(rounds) * s2fp8::kStatsThreads *
         (4 * (dtype == s2fp8::kF32 ? 4 : 8) + 1);
}

template <typename T, int F>
void fused_kernels(const void** out) {
  out[0] = reinterpret_cast<const void*>(quant_fused_kernel<T, F>);
  out[1] = reinterpret_cast<const void*>(truncate_fused_kernel<T, F>);
}

cudaError_t fused_plan(const FusedPlan** out) {
  static FusedPlan plans[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  FusedPlan& fp = plans[dev];
  if (fp.cap == 0) {
    const void* fns[8];   // f32 e5m2, e4m3, then bf16: quant, truncate each
    fused_kernels<float, s2fp8::kE5M2>(fns);
    fused_kernels<float, s2fp8::kE4M3>(fns + 2);
    fused_kernels<__nv_bfloat16, s2fp8::kE5M2>(fns + 4);
    fused_kernels<__nv_bfloat16, s2fp8::kE4M3>(fns + 6);
    int sms = 0, least = 1 << 30;
    if ((err = sm_count(&sms)) != cudaSuccess) return err;
    for (const void* fn : fns) {
      int per_sm = 0;
      if ((err = cudaFuncSetAttribute(
               fn, cudaFuncAttributePreferredSharedMemoryCarveout,
               cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, fn, s2fp8::kStatsThreads, 0)) != cudaSuccess)
        return err;
      least = std::min(least, per_sm);
    }
    if (sms * least <= 0) return cudaErrorInvalidConfiguration;
    size_t avail = ~size_t{0};
    for (const void* fn : fns) {
      size_t bytes = 0;
      if ((err = cudaOccupancyAvailableDynamicSMemPerBlock(
               &bytes, fn, least, s2fp8::kStatsThreads)) != cudaSuccess)
        return err;
      avail = std::min(avail, bytes);
    }
    int rounds[2];
    for (int dtype = 0; dtype < 2; ++dtype) {
      rounds[dtype] = static_cast<int>(avail / keep_bytes(dtype, 1));
      // as many rounds as keep `least` blocks resident in every kernel
      for (; rounds[dtype] > 0; --rounds[dtype]) {
        const int bytes = static_cast<int>(keep_bytes(dtype, rounds[dtype]));
        bool fits = true;
        for (int i = 4 * dtype; i < 4 * dtype + 4 && fits; ++i) {
          int per_sm = 0;
          if ((err = cudaFuncSetAttribute(
                   fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                   bytes)) != cudaSuccess ||
              (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, fns[i], s2fp8::kStatsThreads, bytes)) !=
                  cudaSuccess)
            return err;
          fits = per_sm >= least;
        }
        if (fits) break;
      }
    }
    fp.rounds[0] = rounds[0];
    fp.rounds[1] = rounds[1];
    fp.cap = sms * least;
  }
  *out = &fp;
  return cudaSuccess;
}

// The stats grid for n elements: one block per kStatsThreads x kGridElems
// elements (so the fused kernels keep a small tensor in registers with as
// few blocks as that takes), at most the fused kernels' cap.  A function
// of n and the card alone, so the stats kernel and the fused kernels give
// the same partials.  Returns 0 after an error.
int stats_grid(long long n, cudaError_t* err) {
  const FusedPlan* fp = nullptr;
  if ((*err = fused_plan(&fp)) != cudaSuccess) return 0;
  const long long per_block =
      static_cast<long long>(s2fp8::kStatsThreads) * s2fp8::kGridElems;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < fp->cap ? blocks : fp->cap);
}

// The shared-memory rounds a fused launch over n elements at x keeps: the
// rounds past the register batch of the thread with the most (thread 0),
// at most the plan's.
int fused_rounds(const void* x, int x_dtype, long long n, int grid,
                 const FusedPlan& fp) {
  const int v = x_dtype == s2fp8::kF32 ? 4 : 8, elt = 16 / v;
  long long head =
      static_cast<long long>((16 - reinterpret_cast<unsigned long long>(x) %
                                       16) % 16) / elt;
  if (head > n) head = n;
  const long long nvec = (n - head) / v;
  const long long threads =
      static_cast<long long>(grid) * s2fp8::kStatsThreads;
  const long long past =
      (nvec + threads - 1) / threads - s2fp8::kKeepElems / v;
  return static_cast<int>(
      std::max(0LL, std::min(past, static_cast<long long>(
                                       fp.rounds[x_dtype]))));
}

// The stats kernel; scratch holds the per-block partials, ticket the
// stream's one unsigned int (``reduce_last``: 0 before the launch and 0
// after it).
cudaError_t launch_stats(const void* x, int x_dtype, long long n,
                         void* scratch, long long scratch_bytes, void* ticket,
                         float* triplet, float* ab, float target_max,
                         cudaStream_t stream) {
  cudaError_t err;
  int grid = stats_grid(n, &err);
  if (grid == 0) return err;
  if (grid > kMaxStatsBlocks ||
      static_cast<long long>(grid) * sizeof(StatsPartial) > scratch_bytes)
    return cudaErrorInvalidValue;
  auto* parts = static_cast<StatsPartial*>(scratch);
  auto* t = static_cast<unsigned int*>(ticket);
  if (x_dtype == s2fp8::kF32)
    stats_kernel<float><<<grid, s2fp8::kStatsThreads, 0, stream>>>(
        static_cast<const float*>(x), n, parts, t, triplet, ab, target_max);
  else
    stats_kernel<__nv_bfloat16><<<grid, s2fp8::kStatsThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n, parts, t, triplet, ab,
        target_max);
  return cudaGetLastError();
}

// One cooperative launch of quantize-with-stats (kTruncate false) or the
// fused truncate.  A launch the card refuses returns its error.
template <bool kTruncate>
cudaError_t launch_fused(const void* x, int x_dtype, void* out, long long n,
                         void* scratch, long long scratch_bytes, void* ticket,
                         void* triplet, void* ab, float target_max, int fmt,
                         const void* table, cudaStream_t stream) {
  const FusedPlan* fp = nullptr;
  cudaError_t err = fused_plan(&fp);
  if (err != cudaSuccess) return err;
  int grid = stats_grid(n, &err);
  if (grid == 0) return err;
  if (grid > kMaxStatsBlocks ||
      static_cast<long long>(grid) * sizeof(StatsPartial) > scratch_bytes)
    return cudaErrorInvalidValue;
  int rounds = fused_rounds(x, x_dtype, n, grid, *fp);
  auto* parts = static_cast<StatsPartial*>(scratch);
  auto* tk = static_cast<unsigned int*>(ticket);
  auto* tri = static_cast<float*>(triplet);
  auto* abp = static_cast<float*>(ab);
  auto* tab = static_cast<const CodeTable*>(table);
  return with_kind(x_dtype, fmt, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int F = decltype(kind)::fmt;
    using Out = typename Emit<T, kTruncate>::Out;
    auto* xt = static_cast<const T*>(x);
    auto* ot = static_cast<Out*>(out);
    const void* fn;
    if constexpr (kTruncate)
      fn = reinterpret_cast<const void*>(truncate_fused_kernel<T, F>);
    else
      fn = reinterpret_cast<const void*>(quant_fused_kernel<T, F>);
    void* args[] = {&xt,  &ot,  &n,          &parts, &tk,
                    &tri, &abp, &target_max, &tab,   &rounds};
    cudaError_t e = cudaLaunchCooperativeKernel(
        fn, dim3(grid), dim3(s2fp8::kStatsThreads), args,
        static_cast<size_t>(keep_bytes(x_dtype, rounds)), stream);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

// Quantize-apply (kTruncate false) or truncate-apply.
template <bool kTruncate>
cudaError_t launch_apply(const void* x, int x_dtype, void* out, long long n,
                         const void* ab, int fmt, const void* table,
                         cudaStream_t stream) {
  return with_kind(x_dtype, fmt, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int F = decltype(kind)::fmt;
    using Out = typename Emit<T, kTruncate>::Out;
    int grid = 0;
    cudaError_t err = apply_grid<T, F, kTruncate>(n, &grid);
    if (err != cudaSuccess) return err;
    auto* xt = static_cast<const T*>(x);
    auto* ot = static_cast<Out*>(out);
    auto* abp = static_cast<const float*>(ab);
    auto* tab = static_cast<const CodeTable*>(table);
    if constexpr (kTruncate)
      truncate_apply_kernel<T, F><<<grid, 256, 0, stream>>>(xt, ot, n, abp,
                                                            tab);
    else
      quant_apply_kernel<T, F><<<grid, 256, 0, stream>>>(xt, ot, n, abp, tab);
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

// The elements a fused launch keeps across its grid barrier on the
// current card, for x of ``dtype``: out[0] in all (a tensor up to that many
// is read once and takes one log2f an element), out[1] in registers.
extern "C" int s2fp8_fused_capacity(long long* out, int dtype) {
  const FusedPlan* fp = nullptr;
  cudaError_t err = fused_plan(&fp);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads =
      static_cast<long long>(fp->cap) * s2fp8::kStatsThreads;
  const int v = dtype == s2fp8::kF32 ? 4 : 8;
  out[0] = threads * (s2fp8::kKeepElems + fp->rounds[dtype] * v);
  out[1] = threads * s2fp8::kKeepElems;
  return 0;
}

extern "C" int s2fp8_stats(const void* x, int x_dtype, long long n,
                           void* scratch, long long scratch_bytes,
                           void* ticket, void* triplet, void* ab,
                           float target_max, void* stream) {
  return static_cast<int>(launch_stats(
      x, x_dtype, n, scratch, scratch_bytes, ticket,
      static_cast<float*>(triplet), static_cast<float*>(ab), target_max,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int s2fp8_quant(const void* x, int x_dtype, void* out, long long n,
                           void* scratch, long long scratch_bytes,
                           void* ticket, void* triplet, void* ab,
                           float target_max, int fmt, const void* table,
                           void* stream) {
  return static_cast<int>(launch_fused<false>(
      x, x_dtype, out, n, scratch, scratch_bytes, ticket, triplet, ab,
      target_max, fmt, table, static_cast<cudaStream_t>(stream)));
}

extern "C" int s2fp8_truncate_fused(const void* x, int x_dtype, void* out,
                                    long long n, void* scratch,
                                    long long scratch_bytes, void* ticket,
                                    void* triplet, void* ab, float target_max,
                                    int fmt, const void* table,
                                    void* stream) {
  return static_cast<int>(launch_fused<true>(
      x, x_dtype, out, n, scratch, scratch_bytes, ticket, triplet, ab,
      target_max, fmt, table, static_cast<cudaStream_t>(stream)));
}

extern "C" int s2fp8_quant_apply(const void* x, int x_dtype, void* out,
                                 long long n, const void* ab, int fmt,
                                 const void* table, void* stream) {
  return static_cast<int>(launch_apply<false>(
      x, x_dtype, out, n, ab, fmt, table, static_cast<cudaStream_t>(stream)));
}

extern "C" int s2fp8_truncate_apply(const void* x, int x_dtype, void* out,
                                    long long n, const void* ab, int fmt,
                                    const void* table, void* stream) {
  return static_cast<int>(launch_apply<true>(
      x, x_dtype, out, n, ab, fmt, table, static_cast<cudaStream_t>(stream)));
}

extern "C" int s2fp8_dequant(const void* payload, void* out, long long n,
                             const void* ab, int fmt, void* stream) {
  dequant_kernel<<<grid_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(payload), static_cast<float*>(out), n,
      static_cast<const float*>(ab), fmt);
  return static_cast<int>(cudaGetLastError());
}
