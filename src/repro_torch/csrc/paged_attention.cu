// Paged S2FP8 decode attention: one query token per slot against that
// slot's payload KV blocks, gathered through the block table.
//
// Replaces src/repro/kernels/paged_attention.py: paged_decode_attention
// (_paged_kernel).
//
// Bound on the card: bytes.  Per slot and KV head it reads the live
// prefix's K and V payloads (1 B/elt) once; the arithmetic is 4*G*hd
// FLOPs per cached position.  The TPU kernel walks a slot's blocks in
// order, one grid step each; a block per (KV head, slot) doing the same
// here leaves the card idle behind the longest slot (64 serial steps at
// position 1,023 against 1 at position 0) on 288 blocks for 132 SMs.
//
// Design: split-KV decode in one launch, paged_decode_kernel<LP, GC>.  The
// grid is (KV head x query-row chunk, slot, split); a split is kSplit cache
// positions, a constant of the kernel (not of the card), so the same inputs
// give the same bits on any card.  A split wholly past positions[slot]
// exits at once; the block reads table[slot, j] itself (Hopper has no
// scalar prefetch), its first rows' entries beside the slot's position.  A
// payload row of hd bytes (hd any multiple of 16 up to 256) is read by a
// lane group of LP lanes, LP = hd / 16 rounded up to a power of two (1 at
// hd 16, 4 at hd 64, 8 at hd 128, 16 at hd 160, 192 and 256); its first
// hd / 16 lanes take one 16-byte load each and the rest idle (6 of 16 at
// hd 160, 4 at 192), so a warp covers 32 / LP whole rows at a time and
// neighbouring lanes read neighbouring bytes.  An idle lane holds zeros
// and adds 0 to its group's sums, so a padded group computes the
// unpadded one's values.  Codes are dequantized through 256-entry K and V
// tables (s2fp8::decode) in shared memory, built while the block's first
// rows load.  The lane's 16 dims of the block's GC query rows (GC <=
// kMaxGroup of the KV head's G) live in registers and share every K/V
// load; a row's score ends in shuffles inside its lane group.  Each lane
// group keeps an online softmax (m, l, acc) in registers; the groups of a
// warp merge by shuffles in a fixed tree, the warps in shared memory in
// warp order, and the split writes (m, l, acc) to the wrapper's scratch.
// The last live split of a (slot, head, chunk) to finish, found by an
// integer ticket, merges the splits in split order and writes the output.
// No float atomics: two launches on the same inputs give the same bits.
// Positions past positions[slot] are masked (never read); a dead slot at
// position 0 reads row 0 of the trash block 0 and returns finite values,
// as in the reference.
#include "s2fp8_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 256;          // cache positions a block covers
constexpr int kMaxGroup = 4;         // query rows of a KV head a block holds
constexpr float kMask = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The code byte i (0..15) of a 16-byte word.
__device__ __forceinline__ unsigned int byte_of(const uint4& w, int i) {
  return (s2fp8::word_of(w, i >> 2) >> (8 * (i & 3))) & 0xffu;
}

// The K and V dequant tables (entry c: s2fp8::decode(c)).  decode is odd
// in the sign bit (the inverse map keeps the sign; a zero magnitude gives
// +0 for both signs), so each of the block's 128 threads decodes one
// magnitude code of each table, the two chains overlapping, and writes both
// signs.  Ends with the block synced.
__device__ __forceinline__ void fill_tables(float* lut_k, float* lut_v,
                                            const float* k_ab,
                                            const float* v_ab, int fmt) {
  static_assert(kThreads == 128, "one magnitude code a thread");
  const auto c = static_cast<unsigned char>(threadIdx.x);
  const float dk = s2fp8::decode(c, k_ab[0], k_ab[1], fmt);
  const float dv = s2fp8::decode(c, v_ab[0], v_ab[1], fmt);
  lut_k[c] = dk;
  lut_v[c] = dv;
  lut_k[c | 0x80] = dk != 0.0f ? -dk : dk;
  lut_v[c | 0x80] = dv != 0.0f ? -dv : dv;
  __syncthreads();
}

// LP: the lane group (a power of two, 1..16); hd: the head dim, a multiple
// of 16 with hd / 16 <= LP.
template <int LP, int GC>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ kp,
    const unsigned char* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ positions, float* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ tickets, int kvh, int g, int hd, int blk, int max_b,
    const float* __restrict__ k_ab, const float* __restrict__ v_ab,
    float inv_sqrt_d, int fmt) {
  constexpr int NG = kThreads / LP;    // rows in flight in the block
  constexpr int R = kSplit / NG;       // rows of a lane group per split
  constexpr int NB = R < 4 ? R : 4;    // rows a lane loads at once
  __shared__ float lut_k[256], lut_v[256];
  __shared__ float red[kWarps][GC][16 * LP + 2];
  __shared__ bool last;

  const int chunks = (g + GC - 1) / GC;
  const int h = blockIdx.x / chunks, g0 = blockIdx.x % chunks * GC;
  const int b = blockIdx.y, split = blockIdx.z;
  const int s0 = split * kSplit, span = max_b * blk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / LP, sub = tid % LP;
  const bool act = sub < hd / 16;      // a lane that reads 16 bytes of a row
  const int* trow = table + static_cast<size_t>(b) * max_b;
  // the first rows' block ids load beside the slot's position
  int bid[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k)
    bid[k] = trow[min(s0 + grp + k * NG, span - 1) / blk];
  const int end = min(positions[b] + 1, span);          // live positions
  if (s0 >= end) return;                                // whole block

  float qr[GC][16];
  const float* qh =
      q + (static_cast<size_t>(b) * kvh + h) * g * hd + (act ? sub * 16 : 0);
#pragma unroll
  for (int gi = 0; gi < GC; ++gi)
#pragma unroll
    for (int e = 0; e < 16; ++e)
      qr[gi][e] = act && g0 + gi < g ? qh[(g0 + gi) * hd + e] : 0.0f;
  float m[GC], l[GC], acc[GC][16];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    m[gi] = kMask;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[gi][e] = 0.0f;
  }

  const size_t head_bytes = static_cast<size_t>(blk) * hd;
  const size_t block_bytes = head_bytes * kvh;
#pragma unroll
  for (int k0 = 0; k0 < R; k0 += NB) {
    uint4 kw[NB], vw[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int t = s0 + grp + (k0 + k) * NG;
      if (k0 > 0) bid[k] = trow[min(t, span - 1) / blk];
      kw[k] = vw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (act && t < end) {
        const size_t at = static_cast<size_t>(bid[k]) * block_bytes +
                          h * head_bytes +
                          static_cast<size_t>(t % blk) * hd + sub * 16;
        kw[k] = __ldg(reinterpret_cast<const uint4*>(kp + at));
        vw[k] = __ldg(reinterpret_cast<const uint4*>(vp + at));
      }
    }
    if (k0 == 0)            // the tables are built while the first rows load
      fill_tables(lut_k, lut_v, k_ab, v_ab, fmt);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      float dot[GC];
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) dot[gi] = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float kv = lut_k[byte_of(kw[k], e)];
#pragma unroll
        for (int gi = 0; gi < GC; ++gi)
          dot[gi] = fmaf(qr[gi][e], kv, dot[gi]);
      }
#pragma unroll
      for (int off = LP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int gi = 0; gi < GC; ++gi)
          dot[gi] += __shfl_xor_sync(kFull, dot[gi], off);
      if (s0 + grp + (k0 + k) * NG >= end) continue;    // masked
      float corr[GC], p[GC];
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        const float s = dot[gi] * inv_sqrt_d;
        const float mn = fmaxf(m[gi], s);
        corr[gi] = expf(m[gi] - mn);
        p[gi] = expf(s - mn);
        l[gi] = l[gi] * corr[gi] + p[gi];
        m[gi] = mn;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float vv = lut_v[byte_of(vw[k], e)];
#pragma unroll
        for (int gi = 0; gi < GC; ++gi)
          acc[gi][e] = acc[gi][e] * corr[gi] + p[gi] * vv;
      }
    }
  }

  // the warp's lane groups into group 0, in a fixed tree
#pragma unroll
  for (int off = 16; off >= LP; off >>= 1) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      const float mo = __shfl_down_sync(kFull, m[gi], off);
      const float lo = __shfl_down_sync(kFull, l[gi], off);
      const float mn = fmaxf(m[gi], mo);
      const float ca = expf(m[gi] - mn), cb = expf(mo - mn);
      l[gi] = l[gi] * ca + lo * cb;
      m[gi] = mn;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        acc[gi][e] = acc[gi][e] * ca +
                     __shfl_down_sync(kFull, acc[gi][e], off) * cb;
    }
  }
  if (lane < LP && act) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
      for (int e = 0; e < 16; ++e) red[warp][gi][sub * 16 + e] = acc[gi][e];
      if (sub == 0) {
        red[warp][gi][hd] = m[gi];
        red[warp][gi][hd + 1] = l[gi];
      }
    }
  }
  __syncthreads();
  // the warps, in warp order, into the split's (m, l, acc)
  const size_t row0 =
      (static_cast<size_t>(b) * kvh + h) * gridDim.z * g + g0;  // split 0
  for (int i = tid; i < GC * hd; i += kThreads) {
    const int gi = i / hd, d = i % hd;
    if (g0 + gi >= g) break;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w][gi][hd]);
    float ls = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(red[w][gi][hd] - mx);
      ls += red[w][gi][hd + 1] * c;
      a += red[w][gi][d] * c;
    }
    const size_t row = row0 + static_cast<size_t>(split) * g + gi;
    part_acc[row * hd + d] = a;
    if (d == 0) {
      part_ml[2 * row] = mx;
      part_ml[2 * row + 1] = ls;
    }
  }

  // The last of the slot's live splits to finish (an integer ticket)
  // merges them all, in split order, and resets the ticket for the next
  // launch on the stream.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int live = (end + kSplit - 1) / kSplit;
    int* ticket = tickets + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
    last = atomicAdd(ticket, 1) == live - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int live = (end + kSplit - 1) / kSplit;
  for (int i = tid; i < GC * hd; i += kThreads) {
    const int gi = i / hd, d = i % hd;
    if (g0 + gi >= g) break;
    float mx = kMask;
    for (int s = 0; s < live; ++s)
      mx = fmaxf(mx, __ldcg(&part_ml[2 * (row0 + s * g + gi)]));
    float ls = 0.0f, a = 0.0f;
    for (int s = 0; s < live; ++s) {
      const size_t row = row0 + static_cast<size_t>(s) * g + gi;
      const float c = expf(__ldcg(&part_ml[2 * row]) - mx);
      ls += __ldcg(&part_ml[2 * row + 1]) * c;
      a += __ldcg(&part_acc[row * hd + d]) * c;
    }
    out[((static_cast<size_t>(b) * kvh + h) * g + g0 + gi) * hd + d] =
        a / (ls == 0.0f ? 1.0f : ls);
  }
}

struct Args {
  const float* q;
  const unsigned char *kp, *vp;
  const int *table, *positions;
  float *out, *part_acc, *part_ml;
  int* tickets;
  int kvh, g, hd, blk, max_b;
  const float *k_ab, *v_ab;
  float inv_sqrt_d;
  int fmt;
};

template <int LP, int GC>
void launch(dim3 grid, cudaStream_t stream, const Args& a) {
  paged_decode_kernel<LP, GC><<<grid, kThreads, 0, stream>>>(
      a.q, a.kp, a.vp, a.table, a.positions, a.out, a.part_acc, a.part_ml,
      a.tickets, a.kvh, a.g, a.hd, a.blk, a.max_b, a.k_ab, a.v_ab,
      a.inv_sqrt_d, a.fmt);
}

template <int LP>
void launch_g(int gc, dim3 grid, cudaStream_t stream, const Args& a) {
  auto* fn = gc == 1   ? &launch<LP, 1>
             : gc == 2 ? &launch<LP, 2>
                       : &launch<LP, kMaxGroup>;
  fn(grid, stream, a);
}

}  // namespace

// ``scratch``: per (slot, KV head, split, query row) hd floats of acc, then
// 2 floats (m, l) each; ``tickets``: one int per (slot, KV head, query-row
// chunk), zero before the launch and left zero after it (the wrapper keeps
// one buffer per stream); ``split`` must be the kernel's kSplit (the
// wrapper sizes the scratch by it).
extern "C" int s2fp8_paged_decode(const void* q, const void* kp,
                                  const void* vp, const void* table,
                                  const void* positions, void* out,
                                  void* scratch, long long scratch_floats,
                                  void* tickets, long long n_tickets, int b,
                                  int kvh, int g, int hd, int blk, int max_b,
                                  const void* k_ab, const void* v_ab,
                                  float inv_sqrt_d, int fmt, int split,
                                  void* stream) {
  if (split != kSplit || hd < 16 || hd > 256 || hd % 16 || g < 1 || blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || kvh == 0 || max_b == 0) return 0;
  const int nsplit = (max_b * blk + kSplit - 1) / kSplit;
  const long long rows = static_cast<long long>(b) * kvh * nsplit * g;
  const int gc = g == 1 ? 1 : g == 2 ? 2 : kMaxGroup;
  const int chunks = (g + gc - 1) / gc;
  if (rows * (hd + 2) > scratch_floats ||
      static_cast<long long>(b) * kvh * chunks > n_tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.kp = static_cast<const unsigned char*>(kp);
  a.vp = static_cast<const unsigned char*>(vp);
  a.table = static_cast<const int*>(table);
  a.positions = static_cast<const int*>(positions);
  a.out = static_cast<float*>(out);
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = a.part_acc + rows * hd;
  a.tickets = static_cast<int*>(tickets);
  a.kvh = kvh;
  a.g = g;
  a.hd = hd;
  a.blk = blk;
  a.max_b = max_b;
  a.k_ab = static_cast<const float*>(k_ab);
  a.v_ab = static_cast<const float*>(v_ab);
  a.inv_sqrt_d = inv_sqrt_d;
  a.fmt = fmt;
  const dim3 grid(kvh * chunks, b, nsplit);
  const int lanes = hd / 16;
  auto* fn = lanes <= 1   ? &launch_g<1>
             : lanes <= 2 ? &launch_g<2>
             : lanes <= 4 ? &launch_g<4>
             : lanes <= 8 ? &launch_g<8>
                          : &launch_g<16>;
  fn(gc, grid, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
