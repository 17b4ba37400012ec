// Flash attention on Hopper's tensor cores, END-aligned causal / window
// mask, grouped-query K/V.  Three kernels:
//
// * qflash_fwd_kernel<kPayload>: Q/K/V are S2FP8 payloads; softmax(QK^T *
//   scale) V, rowwise logsumexp, optional fused Eq. 5 epilogue on the
//   output.  Replaces src/repro/kernels/flash_attention.py:
//   qflash_fwd_pallas (_qflash_fwd_kernel, mask from _attn_mask).
// * qflash_fwd_kernel<kF32 / kBF16>: the same tile loop over f32 or bf16
//   values (no dequantize); the output has their dtype, accumulated in
//   f32; no logsumexp, no epilogue.  Replaces flash_attention_pallas
//   (_flash_kernel): masked logits -1e30, a row that sees no key gives 0.
// * qflash_dq_kernel + qflash_dkdv_kernel: the recompute backward over
//   payload residuals.  Replaces qflash_bwd_pallas (_qflash_dq_kernel and
//   _qflash_dkdv_kernel).
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (the
// warp-level TF32 tensor-core product, f32 accumulation; HMMA.1688 in
// SASS).  Numerics: compensated TF32 ("3xTF32").  Every f32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (truncated toward zero),
// so hi + lo = x to within 2^-21 |x|, and a product accumulates lo*hi +
// hi*lo + hi*hi (the lo*lo term, under 2^-20 relative, is dropped).  One
// TF32 pass keeps 11 bits of an operand; the dequantized S2FP8 values
// 2^((log2|y| - b) / a) are not exact in it, so one pass would miss the
// f32 tolerances the kernels are held to (tests/test_torch_flash_split.py
// rehearses both on the CPU).  Payload operands cost no split: each
// block's dequantize table holds the (hi, lo) pair of every code.  bf16
// operands are exact in TF32 (8 significant bits), so the bf16 forward
// takes one pass for QK^T and two for PV (the probabilities are split).
//
// Bound on the card: operations.  A visible (query, key) pair costs 4d
// FLOPs forward (QK^T, PV) and 10d backward (five products), about half of
// Sq*Sk pairs under a causal mask; at 3 TF32 passes the least time is 3x
// the FLOPs at 495 TFLOP/s, below the f32 cores' 67 TFLOP/s for 1x.  The
// payloads are 1 B/elt and move orders of magnitude fewer bytes than that.
// What the design does about it:
//
// * Each warp owns 16 rows of the product (query rows forward and for dq,
//   key rows for dk/dv); a block is 4 warps, 64 rows, and the other
//   operand streams through shared memory in tiles of 64 rows (32 for
//   the f32 forward, whose tiles would otherwise leave room for one block
//   a SM).
// * S = QK^T (and dP, S^T, dP^T) stays in the mma accumulator fragment;
//   the online softmax runs in registers (row max and sum over the quad of
//   lanes that hold a row, by shuffles); p and ds are formed in registers
//   and fed back as the A operand of the next product without a shuffle:
//   the accumulator's column pair (2t, 2t+1) of an 8-column tile is taken
//   as the k indices (t, t+4) of the next product, and the B operand's
//   rows are read in the same order.  No score tile in shared memory, and
//   two block barriers per tile (tile landed; tile free).
// * The three passes of a product run over several accumulators at a
//   time (NG below), so the tensor core's latency, several times its
//   issue interval, is covered by independent products.
// * Tiles are copied global -> shared with cp.async, 16 bytes per thread
//   along d where the row length allows it (8 or 4 bytes otherwise, a
//   synchronous copy for rows of an odd number of bytes), double-buffered:
//   the next tile is in flight while this one computes.  Payloads land as
//   raw bytes and are dequantized through the (hi, lo) table as fragments
//   are built; f32 and bf16 tiles land as values.  Each operand is held
//   once; its transposed uses (K for dq; Q and G for dk/dv; V forward) are
//   fragment loads along the other axis.  d is zero-padded to a multiple of
//   16 in shared memory (exact), so one 4-element load feeds two k-steps.
// * Row strides are chosen so that every fragment load is free of bank
//   conflicts: a stride of 16 (mod 32) elements for loads along d, and for
//   loads across rows 16 (payload), 8 (bf16) or 4 (f32) (mod 32 / 16).
//   The payload tables are kept in 4 interleaved copies (a lane reads its
//   own), so a warp's random lookups meet few bank conflicts.
// * What holds the kernels back from that bound is latency: a warp's
//   products wait on chains of shared-memory loads, table lookups or
//   splits, and tensor-core results, and the registers the accumulators
//   take leave two or three warps to each SM sub-partition to hide them.
//   Each operand element costs a lookup or a split per warp and use.
//   Larger warp tiles (two 16-row tiles a warp, sharing B fragments), a
//   dequantize pass into split shared-memory tiles shared by the block's
//   warps, and software-pipelined fragment loads are the next steps;
//   wgmma would need the split operands in shared memory as well.
// * Tiles that the mask hides completely are skipped (block-wide for the
//   copies, per warp for the products); tiles that the mask leaves whole
//   skip the per-element mask.  Masked logits are -1e30, so the online
//   rescaling never sees inf - inf, and a row that sees no key gives 0.
//   Query head h reads K/V head h / g.  Head dims 1..256.
// * Head dims above 128 split the output's columns: a block owns one of
//   two column chunks (gridDim.z = 2, each dpad / 2 <= 128 columns wide)
//   of its rows' output (forward), dq, or dk and dv, and forms the score
//   tile from the full d itself.  The accumulators stay at 16 x 128 f32 a
//   warp (the DC = 128 kernels' registers, which leave no headroom for
//   16 x 256), at the cost of forming the score tiles (S, and dP) in both
//   chunks: 3 products a tile forward against 2, 11 backward against 7
//   (dq: S, dP, dS K; dk/dv: S^T, dv, dP^T, dk).  Both chunks do the same
//   arithmetic on the score tile, so their softmax statistics agree bit
//   for bit and chunk 0 writes the logsumexp.
// * Backward: two kernels, as the reference.  dq over key tiles; per-head
//   dk and dv over query tiles (the sum over the G query heads of a K/V
//   head happens outside).  Every output element is written once by one
//   block: no float atomics, and two launches give the same bits.  The
//   dk/dv kernel keeps both accumulators (2 x 16 x d f32 a warp) in
//   registers and parks p in shared memory while dP^T is formed, so that
//   no kernel spills; two blocks a SM at d = 128.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "tc_common.cuh"

namespace {

using tc::cp_async;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::split;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int FQ = 16 * WARPS;   // query rows (dq, forward) / key rows (dk/dv)
constexpr int FK = 64;           // rows of the streamed operand per tile
constexpr int DMAX = 256;
constexpr int CMAX = 128;        // output columns a block accumulates
constexpr float kMask = -1e30f;

// what the forward's Q/K/V hold (and, for the plain forms, its output)
enum Src { kPayload = 0, kF32 = 1, kBF16 = 2 };

__host__ __device__ __forceinline__ int pad16(int d) { return (d + 15) & ~15; }

// Row stride (elements) for loads along d: 16 (mod 32), so the 8 rows x 4
// lanes of a fragment load fall in distinct banks for 1-, 2- and 4-byte
// elements alike.
__host__ __device__ __forceinline__ int row_stride(int dpad) {
  return (dpad / 16) % 2 ? dpad : dpad + 16;
}

// ---------------------------------------------------------------------------
// tensor-core product (the compensated split is tc::split, tc_common.cuh)
// ---------------------------------------------------------------------------

// c += a (16 x 8, row) . b (8 x 8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// operand element loads from shared memory, as (hi, lo) TF32 pairs
// ---------------------------------------------------------------------------

// A payload table holds decode(c) of every code c as its (hi, lo) split,
// in LUT_COPIES interleaved copies (lane l reads copy l % LUT_COPIES), so
// a warp's random lookups meet few bank conflicts: a lookup is a byte
// extract, an address and one 64-bit load.
constexpr int LUT_COPIES = 4;
constexpr int LUT_SIZE = 256 * LUT_COPIES;   // float2 entries a table

template <int SRC> struct Op;

template <> struct Op<kPayload> {
  using T = uint8_t;
  static constexpr bool kExact = false;
  // row stride for loads across rows (8 rows x 4 lanes, one column each)
  __host__ __device__ static int col_stride(int dpad) {
    return row_stride(dpad);
  }
  // lut: the table offset by this lane's copy
  __device__ static void lookup(uint32_t code, const float2* lut,
                                uint32_t& h, uint32_t& l) {
    const float2 e = lut[code * LUT_COPIES];
    h = __float_as_uint(e.x);
    l = __float_as_uint(e.y);
  }
  __device__ static void load4(const T* p, const float2* lut, uint32_t (&h)[4],
                               uint32_t (&l)[4]) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lookup((w >> (8 * i)) & 0xffu, lut, h[i], l[i]);
  }
  __device__ static void load1(const T* p, const float2* lut, uint32_t& h,
                               uint32_t& l) {
    lookup(*p, lut, h, l);
  }
};

template <> struct Op<kF32> {
  using T = float;
  static constexpr bool kExact = false;
  __host__ __device__ static int col_stride(int dpad) { return dpad + 4; }
  __device__ static void load4(const T* p, const float2*, uint32_t (&h)[4],
                               uint32_t (&l)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
  }
  __device__ static void load1(const T* p, const float2*, uint32_t& h,
                               uint32_t& l) {
    split(*p, h, l);
  }
};

// bf16 as raw bits: exact in TF32 (the f32 bit pattern is the bf16 bits
// shifted up), so lo is 0 and never used.
template <> struct Op<kBF16> {
  using T = uint16_t;
  static constexpr bool kExact = true;
  __host__ __device__ static int col_stride(int dpad) { return dpad + 8; }
  __device__ static void load4(const T* p, const float2*, uint32_t (&h)[4],
                               uint32_t (&l)[4]) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    h[0] = w.x << 16;
    h[1] = w.x & 0xffff0000u;
    h[2] = w.y << 16;
    h[3] = w.y & 0xffff0000u;
    l[0] = l[1] = l[2] = l[3] = 0u;
  }
  __device__ static void load1(const T* p, const float2*, uint32_t& h,
                               uint32_t& l) {
    h = static_cast<uint32_t>(*p) << 16;
    l = 0u;
  }
};

// The compensated products run pass by pass over NG accumulators at a
// time (lo.hi for all, hi.lo for all, hi.hi for all), so that two products
// on one accumulator are NG instructions apart and the tensor core's
// latency is covered.  The forward takes 4 (QK^T) and 8 (PV); the
// backward, which holds more accumulators, 4 and 2, which keeps it in
// registers.

// acc[n] += A . B^T for n < NKT: A is 16 rows of a shared tile (rows gid
// and gid + 8 of this lane), B the 8 * NKT rows of another, both read
// along d (stride `stride`, d padded to dpad).  Columns 16c + 4t .. + 3 of
// a row feed k-steps 2c (as k = t, t + 4) and 2c + 1, the same for A and
// B.  An operand exact in TF32 (bf16) has lo = 0: its passes are left out.
template <int SRC, int NKT, int NG>
__device__ __forceinline__ void rows_product(float (&acc)[NKT][4],
                                             const typename Op<SRC>::T* a,
                                             const float2* alut,
                                             const typename Op<SRC>::T* b,
                                             const float2* blut, int stride,
                                             int dpad, int gid, int tig) {
  using L = Op<SRC>;
  constexpr bool X = L::kExact;
  static_assert(NKT % NG == 0, "groups must tile the key block");
  const auto* a0 = a + gid * stride + 4 * tig;
  const auto* a1 = a0 + 8 * stride;
  const auto* b0 = b + gid * stride + 4 * tig;
#pragma unroll 1
  for (int c = 0; c < dpad; c += 16) {
    uint32_t eh[4], el[4], fh[4], fl[4];
    L::load4(a0 + c, alut, eh, el);
    L::load4(a1 + c, alut, fh, fl);
    const uint32_t ah[2][4] = {{eh[0], fh[0], eh[1], fh[1]},
                               {eh[2], fh[2], eh[3], fh[3]}};
    const uint32_t al[2][4] = {{el[0], fl[0], el[1], fl[1]},
                               {el[2], fl[2], el[3], fl[3]}};
#pragma unroll
    for (int n0 = 0; n0 < NKT; n0 += NG) {
      uint32_t kh[NG][4], kl[NG][4];
#pragma unroll
      for (int i = 0; i < NG; ++i)
        L::load4(b0 + (n0 + i) * 8 * stride + c, blut, kh[i], kl[i]);
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        if constexpr (!X) {
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const uint32_t bh[2] = {kh[i][2 * st], kh[i][2 * st + 1]};
            mma(acc[n0 + i], al[st], bh);
          }
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const uint32_t bl[2] = {kl[i][2 * st], kl[i][2 * st + 1]};
            mma(acc[n0 + i], ah[st], bl);
          }
        }
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const uint32_t bh[2] = {kh[i][2 * st], kh[i][2 * st + 1]};
          mma(acc[n0 + i], ah[st], bh);
        }
      }
    }
  }
}

// acc[n] += P . B for the output columns 8n .. 8n + 7, n < nt: P is the
// 16 x 8NKT accumulator of rows_product (f32, split here), B the 8NKT rows
// of a shared tile read across rows (stride `stride`).  Accumulator
// columns (8j + 2t, 8j + 2t + 1) are k = (t, t + 4) of k-step j, so B's
// rows are taken in that order.
template <int SRC, int NKT, int NT, int NG>
__device__ __forceinline__ void cols_product(float (&acc)[NT][4],
                                             const float (&p)[NKT][4],
                                             const typename Op<SRC>::T* b,
                                             const float2* blut, int stride,
                                             int nt, int gid, int tig) {
  using L = Op<SRC>;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
    const auto* r0 = b + (8 * j + 2 * tig) * stride + gid;
    const auto* r1 = r0 + stride;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      if (n0 >= nt) continue;
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (n0 + i < nt) {
          L::load1(r0 + 8 * (n0 + i), blut, bh[i][0], bl[i][0]);
          L::load1(r1 + 8 * (n0 + i), blut, bh[i][1], bl[i][1]);
        }
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (n0 + i < nt) mma(acc[n0 + i], al, bh[i]);
      if constexpr (!L::kExact) {
#pragma unroll
        for (int i = 0; i < NG; ++i)
          if (n0 + i < nt) mma(acc[n0 + i], ah, bl[i]);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (n0 + i < nt) mma(acc[n0 + i], ah, bh[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// copies, tables, masks
// ---------------------------------------------------------------------------

// Rows [row0, row0 + n) of a row-major matrix with `rows` rows of
// `row_bytes` bytes into a shared tile whose rows are `stride_bytes` apart;
// rows at or past `rows` read as 0.  `gran` bytes per copy, dividing
// row_bytes and the matrix's alignment: 16, 8 or 4 through cp.async
// (complete at cp_async_wait), 2 or 1 copied synchronously.  Consecutive
// threads copy consecutive pieces of a row.
__device__ __forceinline__ void copy_rows(void* dst, int stride_bytes,
                                          const void* src, int row0, int rows,
                                          int row_bytes, int n, int gran) {
  auto* d8 = static_cast<uint8_t*>(dst);
  const auto* s8 = static_cast<const uint8_t*>(src);
  const int per = row_bytes / gran, total = n * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per, c = (i - r * per) * gran;
    const bool ok = row0 + r < rows;
    const uint8_t* sp =
        s8 + (ok ? static_cast<size_t>(row0 + r) * row_bytes + c : 0);
    uint8_t* dp = d8 + r * stride_bytes + c;
    switch (gran) {
      case 16: cp_async<16>(dp, sp, ok); break;
      case 8: cp_async<8>(dp, sp, ok); break;
      case 4: cp_async<4>(dp, sp, ok); break;
      case 2:
        *reinterpret_cast<uint16_t*>(dp) =
            ok ? *reinterpret_cast<const uint16_t*>(sp) : 0;
        break;
      default: *dp = ok ? *sp : 0;
    }
  }
}

// Zero columns [d, dpad) of every row of a tile (never written by a copy).
template <typename T>
__device__ __forceinline__ void zero_pad(T* tile, int rows, int stride, int d,
                                         int dpad) {
  const int w = dpad - d;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w;
    tile[r * stride + d + (i - r * w)] = T(0);
  }
}

// The block's dequantize table (Op<kPayload>): entry c of every copy is
// decode(c) split into (hi, lo).  Call with the whole block, then sync.
__device__ __forceinline__ void fill_lut_split(float2* lut, const float* ab,
                                               int fmt) {
  const float alpha = ab[0], beta = ab[1];
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    uint32_t h, l;
    split(s2fp8::decode(static_cast<unsigned char>(c), alpha, beta, fmt), h,
          l);
    const float2 e = make_float2(__uint_as_float(h), __uint_as_float(l));
#pragma unroll
    for (int k = 0; k < LUT_COPIES; ++k) lut[c * LUT_COPIES + k] = e;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sk,
                                        int causal, int window) {
  if (kpos >= sk) return false;
  if (causal && kpos > qpos) return false;
  if (window > 0 && kpos <= qpos - window) return false;
  return true;
}

// Whether any key of [k0, k0 + n) is visible to some query position of
// [qlo, qhi].
__device__ __forceinline__ bool any_visible(int qlo, int qhi, int k0, int n,
                                            int sk, int causal, int window) {
  const int khi = min(k0 + n, sk) - 1;
  return k0 < sk && qlo <= qhi && (!causal || k0 <= qhi) &&
         (window <= 0 || khi > qlo - window);
}

// Whether every key of [k0, k0 + n) is visible to every position of
// [qlo, qhi] (the per-element mask can be skipped).
__device__ __forceinline__ bool all_visible(int qlo, int qhi, int k0, int n,
                                            int sk, int causal, int window) {
  return k0 + n <= sk && (!causal || k0 + n - 1 <= qlo) &&
         (window <= 0 || k0 > qhi - window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Keys a forward tile holds: 32 for f32 values, whose tiles would
// otherwise leave room for one block a SM; 64 otherwise.
template <int SRC>
__host__ __device__ constexpr int fwd_keys() {
  return SRC == kF32 ? 32 : FK;
}

// At d = 256: 205,824 B for f32 values (KT 32), 172,032 for bf16 and
// 111,616 for payloads.
template <int SRC>
size_t fwd_smem_bytes(int d) {
  using L = Op<SRC>;
  constexpr int KT = fwd_keys<SRC>();
  const int dpad = pad16(d), sr = row_stride(dpad), sv = L::col_stride(dpad);
  return (SRC == kPayload ? 3 * LUT_SIZE * sizeof(float2) : 0) +
         sizeof(typename L::T) *
             (static_cast<size_t>(FQ) * sr + 2 * KT * sr + 2 * KT * sv);
}

// Grid (ceil(Sq / FQ), BH, column chunks): one block per (query head, FQ
// query rows, cw output columns from blockIdx.z * cw), heaviest (last,
// under a causal mask) query blocks first.  DC: the chunk's class (64 or
// 128), which sizes the output accumulator.
// At DC = 64 the registers are capped so that three blocks share a SM:
// the kernel waits on latency more than it issues, so occupancy pays.
template <int SRC, int DC>
__global__ __launch_bounds__(THREADS, DC == 64 ? 3 : 1) void qflash_fwd_kernel(
    const typename Op<SRC>::T* __restrict__ qp,
    const typename Op<SRC>::T* __restrict__ kp,
    const typename Op<SRC>::T* __restrict__ vp,
    typename std::conditional<SRC == kBF16, __nv_bfloat16, float>::type*
        __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int d, int g,
    const float* __restrict__ q_ab, const float* __restrict__ k_ab,
    const float* __restrict__ v_ab, const float* __restrict__ o_ab,
    int epilogue, int causal, int window, float scale, int fmt, int gran,
    int cw) {
  using L = Op<SRC>;
  using T = typename L::T;
  constexpr int NT = DC / 8;
  constexpr int KT = fwd_keys<SRC>(), NKT = KT / 8;
  constexpr int E = sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  const int dpad = pad16(d), col0 = blockIdx.z * cw;
  const int nt = min(cw, dpad - col0) / 8;   // the chunk's 8-column tiles
  const int sr = row_stride(dpad), sv = L::col_stride(dpad);
  float2* lut = reinterpret_cast<float2*>(smem);      // q, k, v tables
  T* Qs = reinterpret_cast<T*>(lut + (SRC == kPayload ? 3 * LUT_SIZE : 0));
  T* Ks = Qs + FQ * sr;          // two stages of [KT][sr]
  T* Vs = Ks + 2 * KT * sr;      // two stages of [KT][sv]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;           // query head (flattened B*KV*G)
  const int bkv = bh / g;              // its K/V head
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
  const int shift = sk - sq;           // END alignment of query rows

  if constexpr (SRC == kPayload) {
    fill_lut_split(lut, q_ab, fmt);
    fill_lut_split(lut + LUT_SIZE, k_ab, fmt);
    fill_lut_split(lut + 2 * LUT_SIZE, v_ab, fmt);
  }
  zero_pad(Qs, FQ, sr, d, dpad);
  zero_pad(Ks, 2 * KT, sr, d, dpad);
  zero_pad(Vs, 2 * KT, sv, d, dpad);

  // the key tiles some row of the block sees: [t0, t1)
  const int nk = (sk + KT - 1) / KT;
  const int qlo = q0 + shift, qhi = min(q0 + FQ, sq) - 1 + shift;
  int t0 = 0;
  while (t0 < nk && !any_visible(qlo, qhi, t0 * KT, KT, sk, causal, window))
    ++t0;
  int t1 = t0;
  while (t1 < nk && any_visible(qlo, qhi, t1 * KT, KT, sk, causal, window))
    ++t1;

  const T* qbase = qp + static_cast<size_t>(bh) * sq * d;
  const T* kbase = kp + static_cast<size_t>(bkv) * sk * d;
  const T* vbase = vp + static_cast<size_t>(bkv) * sk * d;
  if (t0 < t1) {
    copy_rows(Qs, sr * E, qbase, q0, sq, d * E, FQ, gran);
    copy_rows(Ks, sr * E, kbase, t0 * KT, sk, d * E, KT, gran);
    copy_rows(Vs, sv * E, vbase, t0 * KT, sk, d * E, KT, gran);
  }
  cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kMask, m1 = kMask, l0 = 0.0f, l1 = 0.0f;
  const int wq0 = q0 + 16 * warp;      // the warp's first query row
  const int wlo = wq0 + shift, whi = min(wq0 + 16, sq) - 1 + shift;
  const int pos0 = wq0 + gid + shift, pos1 = pos0 + 8;
  const float2* lq = lut + lane % LUT_COPIES;    // this lane's copies
  const float2* lk = lq + LUT_SIZE;
  const float2* lv = lq + 2 * LUT_SIZE;

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      copy_rows(Ks + (st ^ 1) * KT * sr, sr * E, kbase, (t + 1) * KT, sk,
                d * E, KT, gran);
      copy_rows(Vs + (st ^ 1) * KT * sv, sv * E, vbase, (t + 1) * KT, sk,
                d * E, KT, gran);
    }
    cp_async_commit();
    cp_async_wait<1>();                // tile t (and Q) have landed
    __syncthreads();
    const int k0 = t * KT;
    if (wq0 < sq && any_visible(wlo, whi, k0, KT, sk, causal, window)) {
      const bool full = all_visible(wlo, whi, k0, KT, sk, causal, window);
      float s[NKT][4];
#pragma unroll
      for (int n = 0; n < NKT; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      rows_product<SRC, NKT, 4>(s, Qs + 16 * warp * sr, lq,
                                Ks + st * KT * sr, lk, sr, dpad, gid, tig);

      // scale and mask; lane holds rows gid (e = 0, 1) and gid + 8 (e = 2,
      // 3), keys k0 + 8n + 2 tig + (e & 1)
      uint32_t vis = 0xffffffffu;
      float mx0 = kMask, mx1 = kMask;
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full && !visible(e < 2 ? pos0 : pos1, k0 + 8 * n + 2 * tig +
                                                          (e & 1),
                                sk, causal, window))
            vis &= ~(1u << (4 * n + e));
          const float x =
              (vis >> (4 * n + e)) & 1u ? __fmul_rn(s[n][e], scale) : kMask;
          s[n][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (vis >> (4 * n + e)) & 1u
                              ? expf(s[n][e] - (e < 2 ? mn0 : mn1))
                              : 0.0f;
          s[n][e] = p;
          if (e < 2) sum0 += p;
          else sum1 += p;
        }
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      l0 = l0 * c0 + quad_sum(sum0);
      l1 = l1 * c1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
      cols_product<SRC, NKT, NT, 8>(o, s, Vs + st * KT * sv + col0, lv, sv,
                                    nt, gid, tig);
    }
    __syncthreads();                   // stage st is free for tile t + 2
  }

  float oa = 1.0f, ob = 0.0f;
  if (SRC == kPayload && epilogue) {
    oa = o_ab[0];
    ob = o_ab[1];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gq = wq0 + gid + 8 * half;
    if (gq >= sq) continue;
    const float l = half ? l1 : l0;
    const float denom = l == 0.0f ? 1.0f : l;
    auto* orow = out + (static_cast<size_t>(bh) * sq + gq) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        const int c = col0 + 8 * n + 2 * tig + (e & 1);
        if (n >= nt || c >= d) continue;
        float v = o[n][e] / denom;
        if constexpr (SRC == kPayload) {
          if (epilogue) v = s2fp8::truncate(v, oa, ob, fmt);
          orow[c] = v;
        } else if constexpr (SRC == kBF16) {
          orow[c] = __float2bfloat16_rn(v);
        } else {
          orow[c] = v;
        }
      }
    if (lse != nullptr && tig == 0 && blockIdx.z == 0)
      lse[static_cast<size_t>(bh) * sq + gq] =
          (half ? m1 : m0) + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// Backward.  Inputs: the Q/K/V payloads, the quantized output cotangent G
// ([BH, Sq, d], same format), lse and delta = rowsum(deq(G) * deq(O))
// ([BH, Sq] f32).  Per visible (query r, key t) pair, as the reference:
//   p  = exp(q.k * scale - lse[r])        (0 where the mask hides the pair)
//   ds = p * (g.v - delta[r]) * scale
//   dq[r] += ds * k[t];  dk[t] += ds * q[r];  dv[t] += p * g[r]
// Outputs are raw f32: dq [BH, Sq, d] and PER-HEAD dk, dv [BH, Sk, d].
// Shared memory (payload bytes, the four (hi, lo) tables, lse / delta;
// dk/dv also a p stage): 33,792 B + 6 x 64 rows x row_stride(dpad) bytes,
// so dq 64,512 B at d = 64, 89,088 B at d = 128 and 138,240 B at d = 256
// (row stride 272); dk/dv 16,384 B more (154,624 B at d = 256, under the
// 232,448 a block may take).  Two blocks a SM at d = 128, one above it.
// Above d = 128 each block owns one column chunk of dq (or of dk and dv)
// and forms s and dP from the full d.  The mask is applied
// as the reference does: p is computed only for visible pairs, so exp
// never sees a masked logit and a masked pair gives exactly 0.
// ---------------------------------------------------------------------------

// p stage of the dk/dv kernel: 16 x 64 f32 a warp
constexpr int PSTAGE = WARPS * 32 * 32;

size_t bwd_smem_bytes(int d, bool dkdv) {
  const int sr = row_stride(pad16(d));
  return 4 * LUT_SIZE * sizeof(float2) + 4 * FQ * sizeof(float) +
         static_cast<size_t>(6) * 64 * sr +
         (dkdv ? PSTAGE * sizeof(float) : 0);
}

// Grid (ceil(Sq / FQ), BH, column chunks); key tiles innermost.
template <int DC>
__global__ __launch_bounds__(THREADS) void qflash_dq_kernel(
    const uint8_t* __restrict__ qp, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ vp, const uint8_t* __restrict__ gp,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int sq, int sk, int d, int g,
    const float* __restrict__ q_ab, const float* __restrict__ k_ab,
    const float* __restrict__ v_ab, const float* __restrict__ g_ab,
    int causal, int window, float scale, int fmt, int gran, int cw) {
  constexpr int NT = DC / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int dpad = pad16(d), sr = row_stride(dpad), col0 = blockIdx.z * cw;
  const int nt = min(cw, dpad - col0) / 8;
  float2* lut = reinterpret_cast<float2*>(smem);    // q, k, v, g
  float* lse_s = reinterpret_cast<float*>(lut + 4 * LUT_SIZE);
  float* dlt_s = lse_s + FQ;
  uint8_t* Qs = reinterpret_cast<uint8_t*>(lse_s + 4 * FQ);
  uint8_t* Gs = Qs + FQ * sr;
  uint8_t* Ks = Gs + FQ * sr;          // two stages of [FK][sr]
  uint8_t* Vs = Ks + 2 * FK * sr;      // two stages of [FK][sr]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, bkv = bh / g;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
  const int shift = sk - sq;

  fill_lut_split(lut, q_ab, fmt);
  fill_lut_split(lut + LUT_SIZE, k_ab, fmt);
  fill_lut_split(lut + 2 * LUT_SIZE, v_ab, fmt);
  fill_lut_split(lut + 3 * LUT_SIZE, g_ab, fmt);
  zero_pad(Qs, 2 * FQ, sr, d, dpad);   // Qs and Gs
  zero_pad(Ks, 4 * FK, sr, d, dpad);   // both stages of Ks and Vs
  if (tid < FQ) {
    const int gq = q0 + tid;
    const size_t row = static_cast<size_t>(bh) * sq + gq;
    lse_s[tid] = gq < sq ? lse[row] : 0.0f;
    dlt_s[tid] = gq < sq ? delta[row] : 0.0f;
  }

  const int nk = (sk + FK - 1) / FK;
  const int qlo = q0 + shift, qhi = min(q0 + FQ, sq) - 1 + shift;
  int t0 = 0;
  while (t0 < nk && !any_visible(qlo, qhi, t0 * FK, FK, sk, causal, window))
    ++t0;
  int t1 = t0;
  while (t1 < nk && any_visible(qlo, qhi, t1 * FK, FK, sk, causal, window))
    ++t1;

  const size_t qoff = static_cast<size_t>(bh) * sq * d;
  const uint8_t* kbase = kp + static_cast<size_t>(bkv) * sk * d;
  const uint8_t* vbase = vp + static_cast<size_t>(bkv) * sk * d;
  if (t0 < t1) {
    copy_rows(Qs, sr, qp + qoff, q0, sq, d, FQ, gran);
    copy_rows(Gs, sr, gp + qoff, q0, sq, d, FQ, gran);
    copy_rows(Ks, sr, kbase, t0 * FK, sk, d, FK, gran);
    copy_rows(Vs, sr, vbase, t0 * FK, sk, d, FK, gran);
  }
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const int wq0 = q0 + 16 * warp;
  const int wlo = wq0 + shift, whi = min(wq0 + 16, sq) - 1 + shift;
  const int r0 = 16 * warp + gid;      // the lane's rows in the block
  const float2* lq = lut + lane % LUT_COPIES;    // this lane's copies
  const float2* lk = lq + LUT_SIZE;
  const float2* lv = lq + 2 * LUT_SIZE;
  const float2* lg = lq + 3 * LUT_SIZE;

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      copy_rows(Ks + (st ^ 1) * FK * sr, sr, kbase, (t + 1) * FK, sk, d, FK,
                gran);
      copy_rows(Vs + (st ^ 1) * FK * sr, sr, vbase, (t + 1) * FK, sk, d, FK,
                gran);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = t * FK;
    if (wq0 < sq && any_visible(wlo, whi, k0, FK, sk, causal, window)) {
      const bool full = wq0 + 16 <= sq &&
                        all_visible(wlo, whi, k0, FK, sk, causal, window);
      const uint8_t* kt = Ks + st * FK * sr;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      rows_product<kPayload, 8, 4>(s, Qs + 16 * warp * sr, lq, kt, lk, sr,
                                   dpad, gid, tig);
      rows_product<kPayload, 8, 4>(dp, Gs + 16 * warp * sr, lg,
                                   Vs + st * FK * sr, lv, sr, dpad, gid, tig);
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = r0 + 8 * e2, gq = q0 + r;
        const float lr = lse_s[r], dr = dlt_s[r];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int e = 2 * e2 + e1;
            const bool vis =
                full || (gq < sq && visible(gq + shift,
                                            k0 + 8 * n + 2 * tig + e1, sk,
                                            causal, window));
            const float p =
                vis ? expf(__fmul_rn(s[n][e], scale) - lr) : 0.0f;
            s[n][e] = p * (dp[n][e] - dr) * scale;       // ds
          }
      }
      cols_product<kPayload, 8, NT, 2>(acc, s, kt + col0, lk, sr, nt, gid,
                                       tig);
    }
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gq = wq0 + gid + 8 * half;
    if (gq >= sq) continue;
    float* orow = dq + (static_cast<size_t>(bh) * sq + gq) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        const int c = col0 + 8 * n + 2 * tig + (e & 1);
        if (n < nt && c < d) orow[c] = acc[n][e];
      }
  }
}

// Grid (ceil(Sk / FQ), BH, column chunks): one block per (query head, FQ
// key rows, cw columns of dk and dv), each warp 16 keys; query tiles
// innermost.  The warp computes S^T = K Q^T,
// then p^T and dv += p^T G, then dP^T = V G^T, ds^T and dk += ds^T Q.
template <int DC>
__global__ __launch_bounds__(THREADS) void qflash_dkdv_kernel(
    const uint8_t* __restrict__ qp, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ vp, const uint8_t* __restrict__ gp,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int d,
    int g, const float* __restrict__ q_ab, const float* __restrict__ k_ab,
    const float* __restrict__ v_ab, const float* __restrict__ g_ab,
    int causal, int window, float scale, int fmt, int gran, int cw) {
  constexpr int NT = DC / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int dpad = pad16(d), sr = row_stride(dpad), col0 = blockIdx.z * cw;
  const int nt = min(cw, dpad - col0) / 8;
  float2* lut = reinterpret_cast<float2*>(smem);    // q, k, v, g
  float* lse_s = reinterpret_cast<float*>(lut + 4 * LUT_SIZE);  // [2][FK]
  float* dlt_s = lse_s + 2 * FK;                                 // [2][FK]
  float* pst = dlt_s + 2 * FK;         // [WARPS][32][32]: p between products
  uint8_t* Ks = reinterpret_cast<uint8_t*>(pst + PSTAGE);
  uint8_t* Vs = Ks + FQ * sr;
  uint8_t* Qs = Vs + FQ * sr;          // two stages of [FK][sr]
  uint8_t* Gs = Qs + 2 * FK * sr;      // two stages of [FK][sr]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, bkv = bh / g;
  const int k0 = blockIdx.x * FQ;
  const int shift = sk - sq;

  fill_lut_split(lut, q_ab, fmt);
  fill_lut_split(lut + LUT_SIZE, k_ab, fmt);
  fill_lut_split(lut + 2 * LUT_SIZE, v_ab, fmt);
  fill_lut_split(lut + 3 * LUT_SIZE, g_ab, fmt);
  zero_pad(Ks, 2 * FQ, sr, d, dpad);   // Ks and Vs
  zero_pad(Qs, 4 * FK, sr, d, dpad);   // both stages of Qs and Gs

  // the query tiles whose rows see some key of the block: [t0, t1)
  const int nq = (sq + FK - 1) / FK;
  auto tile_vis = [&](int i, int klo, int n) {
    const int qa = i * FK + shift, qb = min(i * FK + FK, sq) - 1 + shift;
    return any_visible(qa, qb, klo, n, sk, causal, window);
  };
  int t0 = 0;
  while (t0 < nq && !tile_vis(t0, k0, FQ)) ++t0;
  int t1 = t0;
  while (t1 < nq && tile_vis(t1, k0, FQ)) ++t1;

  const size_t kvoff = static_cast<size_t>(bkv) * sk * d;
  const uint8_t* qbase = qp + static_cast<size_t>(bh) * sq * d;
  const uint8_t* gbase = gp + static_cast<size_t>(bh) * sq * d;
  const float* lbase = lse + static_cast<size_t>(bh) * sq;
  const float* dbase = delta + static_cast<size_t>(bh) * sq;
  auto load_q = [&](int i, int st) {
    copy_rows(Qs + st * FK * sr, sr, qbase, i * FK, sq, d, FK, gran);
    copy_rows(Gs + st * FK * sr, sr, gbase, i * FK, sq, d, FK, gran);
    copy_rows(lse_s + st * FK, 4, lbase, i * FK, sq, 4, FK, 4);
    copy_rows(dlt_s + st * FK, 4, dbase, i * FK, sq, 4, FK, 4);
  };
  if (t0 < t1) {
    copy_rows(Ks, sr, kp + kvoff, k0, sk, d, FQ, gran);
    copy_rows(Vs, sr, vp + kvoff, k0, sk, d, FQ, gran);
    load_q(t0, 0);
  }
  cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  const int kw0 = k0 + 16 * warp;      // the warp's first key
  const float2* lq = lut + lane % LUT_COPIES;    // this lane's copies
  const float2* lk = lq + LUT_SIZE;
  const float2* lv = lq + 2 * LUT_SIZE;
  const float2* lg = lq + 3 * LUT_SIZE;
  float* pw = pst + warp * 32 * 32 + lane;       // this lane's p stage

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) load_q(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = t * FK;
    const int qa = q0 + shift, qb = min(q0 + FK, sq) - 1 + shift;
    if (any_visible(qa, qb, kw0, 16, sk, causal, window)) {
      const bool full = q0 + FK <= sq &&
                        all_visible(qa, qb, kw0, 16, sk, causal, window);
      const uint8_t* qt = Qs + st * FK * sr;
      const uint8_t* gt = Gs + st * FK * sr;
      const float* ls = lse_s + st * FK;
      const float* dl = dlt_s + st * FK;
      // lane holds keys kw0 + gid (e = 0, 1) and + 8 (e = 2, 3), queries
      // q0 + 8n + 2 tig + (e & 1)
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      rows_product<kPayload, 8, 4>(s, Ks + 16 * warp * sr, lk, qt, lq, sr,
                                   dpad, gid, tig);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tig + (e & 1), gq = q0 + c;
          const int kpos = kw0 + gid + (e < 2 ? 0 : 8);
          const bool vis =
              full ||
              (gq < sq && visible(gq + shift, kpos, sk, causal, window));
          s[n][e] = vis ? expf(__fmul_rn(s[n][e], scale) - ls[c]) : 0.0f;
        }
      cols_product<kPayload, 8, NT, 2>(dva, s, gt + col0, lg, sr, nt, gid,
                                       tig);
      // p waits in shared memory while dP^T is formed (registers: the two
      // accumulators take 2 x 16 x d / 32 a lane)
#pragma unroll
      for (int i = 0; i < 32; ++i) pw[32 * i] = s[i / 4][i % 4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      rows_product<kPayload, 8, 4>(s, Vs + 16 * warp * sr, lv, gt, lg, sr,
                                   dpad, gid, tig);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tig + (e & 1);
          s[n][e] = pw[32 * (4 * n + e)] * (s[n][e] - dl[c]) * scale;  // ds^T
        }
      cols_product<kPayload, 8, NT, 2>(dka, s, qt + col0, lq, sr, nt, gid,
                                       tig);
    }
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gk = kw0 + gid + 8 * half;
    if (gk >= sk) continue;
    const size_t row = (static_cast<size_t>(bh) * sk + gk) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        const int c = col0 + 8 * n + 2 * tig + (e & 1);
        if (n < nt && c < d) {
          dk[row + c] = dka[n][e];
          dv[row + c] = dva[n][e];
        }
      }
  }
}

// The largest copy granule (16, 8, 4, 2 or 1 bytes) that divides a row and
// every base address.
int granule(int row_bytes, std::initializer_list<const void*> bases) {
  for (int gran = 16; gran > 1; gran /= 2) {
    bool ok = row_bytes % gran == 0;
    for (const void* b : bases)
      ok = ok && reinterpret_cast<uintptr_t>(b) % gran == 0;
    if (ok) return gran;
  }
  return 1;
}

// Column chunks of a padded head dim: one of dpad columns up to CMAX, two
// of dpad / 2 (a multiple of 8, at most CMAX) above it.
int col_chunks(int dpad) { return dpad <= CMAX ? 1 : 2; }
int chunk_width(int dpad) { return dpad <= CMAX ? dpad : dpad / 2; }

template <int SRC, int DC>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int bh, int sq, int sk, int d, int g,
               const void* q_ab, const void* k_ab, const void* v_ab,
               const void* o_ab, int epilogue, int causal, int window,
               float scale, int fmt, cudaStream_t st) {
  using T = typename Op<SRC>::T;
  using O =
      typename std::conditional<SRC == kBF16, __nv_bfloat16, float>::type;
  const size_t smem = fwd_smem_bytes<SRC>(d);
  auto kern = qflash_fwd_kernel<SRC, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gran = granule(d * static_cast<int>(sizeof(T)), {q, k, v});
  const int dpad = pad16(d);
  kern<<<dim3((sq + FQ - 1) / FQ, bh, col_chunks(dpad)), THREADS, smem,
         st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<O*>(out),
      static_cast<float*>(lse), sq, sk, d, g,
      static_cast<const float*>(q_ab), static_cast<const float*>(k_ab),
      static_cast<const float*>(v_ab), static_cast<const float*>(o_ab),
      epilogue, causal, window, scale, fmt, gran, chunk_width(dpad));
  return static_cast<int>(cudaGetLastError());
}

template <int SRC>
int launch_fwd_d(const void* q, const void* k, const void* v, void* out,
                 void* lse, int bh, int sq, int sk, int d, int g,
                 const void* q_ab, const void* k_ab, const void* v_ab,
                 const void* o_ab, int epilogue, int causal, int window,
                 float scale, int fmt, cudaStream_t st) {
  return pad16(d) <= 64
             ? launch_fwd<SRC, 64>(q, k, v, out, lse, bh, sq, sk, d, g, q_ab,
                                   k_ab, v_ab, o_ab, epilogue, causal, window,
                                   scale, fmt, st)
             : launch_fwd<SRC, 128>(q, k, v, out, lse, bh, sq, sk, d, g,
                                    q_ab, k_ab, v_ab, o_ab, epilogue, causal,
                                    window, scale, fmt, st);
}

template <int DC>
int launch_bwd(const uint8_t* q, const uint8_t* k, const uint8_t* v,
               const uint8_t* gout, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, int bh, int sq, int sk,
               int d, int g, const float* q_ab, const float* k_ab,
               const float* v_ab, const float* g_ab, int causal, int window,
               float scale, int fmt, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(d, false);
  const size_t smem_kv = bwd_smem_bytes(d, true);
  cudaError_t err = cudaFuncSetAttribute(
      qflash_dq_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(qflash_dkdv_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gran = granule(d, {q, k, v, gout});
  const int dpad = pad16(d), nc = col_chunks(dpad), cw = chunk_width(dpad);
  qflash_dq_kernel<DC><<<dim3((sq + FQ - 1) / FQ, bh, nc), THREADS, smem,
                         st>>>(
      q, k, v, gout, lse, delta, dq, sq, sk, d, g, q_ab, k_ab, v_ab, g_ab,
      causal, window, scale, fmt, gran, cw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  qflash_dkdv_kernel<DC><<<dim3((sk + FQ - 1) / FQ, bh, nc), THREADS,
                           smem_kv, st>>>(
      q, k, v, gout, lse, delta, dk, dv, sq, sk, d, g, q_ab, k_ab, v_ab, g_ab,
      causal, window, scale, fmt, gran, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int s2fp8_qflash_fwd(const void* q, const void* k, const void* v,
                                void* out, void* lse, int bh, int sq, int sk,
                                int d, int g, const void* q_ab,
                                const void* k_ab, const void* v_ab,
                                const void* o_ab, int epilogue, int causal,
                                int window, float scale, int fmt,
                                void* stream) {
  if (d < 1 || d > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_d<kPayload>(q, k, v, out, lse, bh, sq, sk, d, g, q_ab,
                                k_ab, v_ab, o_ab, epilogue, causal, window,
                                scale, fmt, static_cast<cudaStream_t>(stream));
}

// The plain forward: q [bh, sq, d], k / v [bh, sk, d] and out [bh, sq, d]
// all f32 (dtype 0) or all bf16 (dtype 1); the K/V heads already
// broadcast (g = 1).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, int bh, int sq, int sk, int d, int dtype,
                         int causal, int window, float scale, void* stream) {
  if (d < 1 || d > DMAX || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_fwd_d<kF32>(q, k, v, out, nullptr, bh, sq, sk, d, 1,
                                  nullptr, nullptr, nullptr, nullptr, 0,
                                  causal, window, scale, 0, st)
             : launch_fwd_d<kBF16>(q, k, v, out, nullptr, bh, sq, sk, d, 1,
                                   nullptr, nullptr, nullptr, nullptr, 0,
                                   causal, window, scale, 0, st);
}

// Both backward kernels on the stream: dq [bh, sq, d], per-head dk / dv
// [bh, sk, d].
extern "C" int s2fp8_qflash_bwd(const void* q, const void* k, const void* v,
                                const void* gout, const void* lse,
                                const void* delta, void* dq, void* dk,
                                void* dv, int bh, int sq, int sk, int d,
                                int g, const void* q_ab, const void* k_ab,
                                const void* v_ab, const void* g_ab,
                                int causal, int window, float scale, int fmt,
                                void* stream) {
  if (d < 1 || d > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pq = static_cast<const uint8_t*>(q);
  const auto* pk = static_cast<const uint8_t*>(k);
  const auto* pv = static_cast<const uint8_t*>(v);
  const auto* pg = static_cast<const uint8_t*>(gout);
  const auto* pl = static_cast<const float*>(lse);
  const auto* pd = static_cast<const float*>(delta);
  auto* pdq = static_cast<float*>(dq);
  auto* pdk = static_cast<float*>(dk);
  auto* pdv = static_cast<float*>(dv);
  const auto* sq_ab = static_cast<const float*>(q_ab);
  const auto* sk_ab = static_cast<const float*>(k_ab);
  const auto* sv_ab = static_cast<const float*>(v_ab);
  const auto* sg_ab = static_cast<const float*>(g_ab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pad16(d) <= 64)
    return launch_bwd<64>(pq, pk, pv, pg, pl, pd, pdq, pdk, pdv, bh, sq, sk,
                          d, g, sq_ab, sk_ab, sv_ab, sg_ab, causal, window,
                          scale, fmt, st);
  return launch_bwd<128>(pq, pk, pv, pg, pl, pd, pdq, pdk, pdv, bh, sq, sk, d,
                         g, sq_ab, sk_ab, sv_ab, sg_ab, causal, window, scale,
                         fmt, st);
}
