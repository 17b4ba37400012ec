// Flash attention forward, END-aligned causal / window mask, grouped-query
// K/V, in two forms that share one tile loop (qflash_fwd_kernel<SRC>):
//
// * payload (SRC = kPayload): Q/K/V are S2FP8 payloads; softmax(QK^T *
//   scale) V, rowwise logsumexp, optional fused Eq. 5 epilogue on the
//   output.  Replaces src/repro/kernels/flash_attention.py:
//   qflash_fwd_pallas (_qflash_fwd_kernel, mask from _attn_mask).
// * plain (SRC = kF32 / kBF16): Q/K/V are f32 or bf16 values, read with
//   no dequantize; the output has their dtype, accumulated in f32; no
//   logsumexp, no epilogue.  Replaces flash_attention_pallas
//   (_flash_kernel): masked logits -1e30, a row that sees no key gives 0.
//
// Backward (below qflash_fwd_kernel): the recompute schedule over payload
// residuals, two kernels.  Replaces qflash_bwd_pallas (_qflash_dq_kernel
// and _qflash_dkdv_kernel).
//
// Forward bound on the card: operations (about 4*Sq*Sk*d f32 FLOPs per
// head, half of that under a causal mask, over 67 TFLOP/s); the payloads
// are 1 B/elt (plain: 4 or 2 B/elt) and read a few times.  Design: one
// block per (head, 64 query rows); K/V stream through shared memory 64
// rows at a time (payloads dequantized through per-block 256-entry tables
// built with the shared s2fp8::decode); the 64x64 score tile and the
// running (max, denominator) live in shared memory and the output
// accumulator in registers, so nothing of size Sq*Sk reaches device
// memory.  Tiles that the mask hides completely are skipped, which leaves
// every sum unchanged (their probabilities are 0 and their correction
// factor 1).  Masked logits are filled with -1e30, as in the reference,
// so the online rescaling never sees inf - inf.  Query head h reads K/V
// head h / g.  Head dims up to 128 (32, 64, 80, 128 tested).
#include <type_traits>

#include "s2fp8_common.cuh"

namespace {

constexpr int FQ = 64, FK = 64, THREADS = 256, DMAX = 128, SLD = FK + 1;
constexpr float kMask = -1e30f;

// what the forward's Q/K/V hold (and, for the plain forms, its output)
enum Src { kPayload = 0, kF32 = 1, kBF16 = 2 };
template <int SRC> struct Elem { using T = unsigned char; };
template <> struct Elem<kF32> { using T = float; };
template <> struct Elem<kBF16> { using T = __nv_bfloat16; };

template <int SRC>
__device__ __forceinline__ float load_elem(const typename Elem<SRC>::T* p,
                                           size_t i, const float* lut) {
  if constexpr (SRC == kPayload) return lut[p[i]];
  else if constexpr (SRC == kF32) return p[i];
  else return __bfloat162float(p[i]);
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(d) * FQ      // Qt [d][FQ]
          + static_cast<size_t>(d) * FK    // Kt [d][FK]
          + static_cast<size_t>(FK) * d    // Vs [FK][d]
          + static_cast<size_t>(FQ) * SLD  // S  [FQ][FK+1]
          + 3 * FQ                         // m, l, corr
          + 3 * 256);                      // dequant tables q, k, v
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sk,
                                        int causal, int window) {
  if (kpos >= sk) return false;
  if (causal && kpos > qpos) return false;
  if (window > 0 && kpos <= qpos - window) return false;
  return true;
}

template <int SRC>
__global__ __launch_bounds__(THREADS) void qflash_fwd_kernel(
    const typename Elem<SRC>::T* __restrict__ qp,
    const typename Elem<SRC>::T* __restrict__ kp,
    const typename Elem<SRC>::T* __restrict__ vp,
    typename std::conditional<SRC == kBF16, __nv_bfloat16, float>::type*
        __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int d, int g,
    const float* __restrict__ q_ab, const float* __restrict__ k_ab,
    const float* __restrict__ v_ab, const float* __restrict__ o_ab,
    int epilogue, int causal, int window, float scale, int fmt) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + d * FQ;
  float* Vs = Kt + d * FK;
  float* S = Vs + FK * d;
  float* m_s = S + FQ * SLD;
  float* l_s = m_s + FQ;
  float* c_s = l_s + FQ;
  float* lut_q = c_s + FQ;
  float* lut_k = lut_q + 256;
  float* lut_v = lut_k + 256;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;           // query head (flattened B*KV*G)
  const int bkv = bh / g;              // its K/V head
  const int q0 = blockIdx.x * FQ;
  const int shift = sk - sq;           // END alignment of query rows

  if constexpr (SRC == kPayload) {
    s2fp8::fill_lut(lut_q, q_ab, fmt);
    s2fp8::fill_lut(lut_k, k_ab, fmt);
    s2fp8::fill_lut(lut_v, v_ab, fmt);
  }
  if (tid < FQ) {
    m_s[tid] = kMask;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  const auto* qbase = qp + static_cast<size_t>(bh) * sq * d;
  for (int idx = tid; idx < FQ * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    const int gq = q0 + r;
    Qt[c * FQ + r] =
        gq < sq ? load_elem<SRC>(qbase, static_cast<size_t>(gq) * d + c, lut_q)
                : 0.0f;
  }

  // score micro-tile: rows tr*4..+3, cols tc*4..+3; output micro-tile: rows
  // tr*4..+3, cols tc + 16*j.
  const int tr = tid / 16, tc = tid % 16;
  const int ncol = (d + 15) / 16;      // <= DMAX / 16 = 8
  float acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.0f;

  const int qpos_lo = q0 + shift;
  const int qpos_hi = min(q0 + FQ, sq) - 1 + shift;
  const auto* kbase = kp + static_cast<size_t>(bkv) * sk * d;
  const auto* vbase = vp + static_cast<size_t>(bkv) * sk * d;

  for (int k0 = 0; k0 < sk; k0 += FK) {
    if (causal && k0 > qpos_hi) break;                       // all later too
    if (window > 0 && k0 + FK - 1 <= qpos_lo - window) continue;
    __syncthreads();   // previous tile's readers are done with Kt/Vs/S
    for (int idx = tid; idx < FK * d; idx += THREADS) {
      const int t = idx / d, c = idx % d;
      const int gk = k0 + t;
      const bool in = gk < sk;
      const size_t off = static_cast<size_t>(gk) * d + c;
      Kt[c * FK + t] = in ? load_elem<SRC>(kbase, off, lut_k) : 0.0f;
      Vs[t * d + c] = in ? load_elem<SRC>(vbase, off, lut_v) : 0.0f;
    }
    __syncthreads();

    {  // S = (Q K^T) * scale, masked
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      for (int c = 0; c < d; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qt[c * FQ + tr * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Kt[c * FK + tc * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tc * 4 + j;
          const bool vis = visible(q0 + r + shift, k0 + t, sk, causal, window);
          S[r * SLD + t] = vis ? s[i][j] * scale : kMask;
        }
      }
    }
    __syncthreads();

    {  // online softmax, 4 threads per row (16 columns each)
      const int r = tid / 4, part = tid % 4;
      const int qpos = q0 + r + shift;
      float mx = kMask;
      for (int t = part * 16; t < part * 16 + 16; ++t)
        mx = fmaxf(mx, S[r * SLD + t]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = part * 16; t < part * 16 + 16; ++t) {
        const float p = visible(qpos, k0 + t, sk, causal, window)
                            ? expf(S[r * SLD + t] - m_new)
                            : 0.0f;
        S[r * SLD + t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    {  // acc = acc * corr + P V
      float pv[4][DMAX / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DMAX / 16; ++j) pv[i][j] = 0.0f;
      for (int t = 0; t < FK; ++t) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = S[(tr * 4 + i) * SLD + t];
#pragma unroll
        for (int j = 0; j < DMAX / 16; ++j) {
          const int c = tc + 16 * j;
          if (j < ncol && c < d) {
            const float v = Vs[t * d + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i][j] = fmaf(p[i], v, pv[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float corr = c_s[tr * 4 + i];
#pragma unroll
        for (int j = 0; j < DMAX / 16; ++j)
          acc[i][j] = acc[i][j] * corr + pv[i][j];
      }
    }
  }
  __syncthreads();

  float oa = 1.0f, ob = 0.0f;
  if (SRC == kPayload && epilogue) {
    oa = o_ab[0];
    ob = o_ab[1];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int gq = q0 + r;
    if (gq >= sq) continue;
    const float l = l_s[r];
    const float denom = l == 0.0f ? 1.0f : l;
    auto* orow = out + (static_cast<size_t>(bh) * sq + gq) * d;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int c = tc + 16 * j;
      if (j >= ncol || c >= d) continue;
      float v = acc[i][j] / denom;
      if constexpr (SRC == kPayload) {
        if (epilogue) v = s2fp8::truncate(v, oa, ob, fmt);
        orow[c] = v;
      } else if constexpr (SRC == kBF16) {
        orow[c] = __float2bfloat16_rn(v);
      } else {
        orow[c] = v;
      }
    }
    if (lse != nullptr && tc == 0)
      lse[static_cast<size_t>(bh) * sq + gq] =
          m_s[r] + logf(fmaxf(l, 1e-30f));
  }
}


// ---------------------------------------------------------------------------
// Backward.  Inputs: the Q/K/V payloads, the quantized output cotangent G
// ([BH, Sq, d], same format), lse and delta = rowsum(deq(G) * deq(O))
// ([BH, Sq] f32).  Per visible (query r, key t) pair, as the reference:
//   p  = exp(q.k * scale - lse[r])        (0 where the mask hides the pair)
//   ds = p * (g.v - delta[r]) * scale
//   dq[r] += ds * k[t];  dk[t] += ds * q[r];  dv[t] += p * g[r]
// Outputs are raw f32: dq [BH, Sq, d] and PER-HEAD dk, dv [BH, Sk, d]; the
// sum over the G query heads sharing a K/V head happens outside, so every
// output element is written once by one block (no float atomics: the
// result does not depend on scheduling).
//
// Bound on the card: operations (5 products of 2*d FLOPs per visible pair;
// the two kernels recompute the score and dP tiles, 7 products in all).
// Tiles: 64 query rows x 64 key rows, 256 threads, each thread owning a
// 4 x 4 micro-tile of the score / dP / ds tile and a 4 x (d/16) micro-tile
// of its output rows.  Shared memory, d = 64 (d = 128): the dq kernel keeps
// Q^T, G^T, K^T, V^T, K and ds: 97 KB (177 KB); the dk/dv kernel keeps
// K^T, V^T, Q^T, G^T, Q, G and one p / ds tile: 113 KB (213 KB) — under
// the 227 KB a block may use.  Transposed tiles are filled with the row
// index fastest across threads and row-major tiles with the column index
// fastest, so no shared-memory store conflicts.  The mask is applied
// twice, as the reference does: p is computed only for visible pairs, so
// exp never sees a masked -inf or -1e30 and a masked pair gives exactly 0.
// Tile pairs that the mask hides completely are skipped (they add 0).
// ---------------------------------------------------------------------------

constexpr int NT4 = DMAX / 16;

size_t dq_smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(d) * FQ * 2    // Qt, Gt [d][FQ]
          + static_cast<size_t>(d) * FK * 2  // Kt, Vt [d][FK]
          + static_cast<size_t>(FK) * d      // Ks [FK][d]
          + static_cast<size_t>(FQ) * SLD    // dS [FQ][FK+1]
          + 2 * FQ                           // lse, delta
          + 4 * 256);                        // dequant tables q, k, v, g
}

size_t dkdv_smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(d) * FK * 2    // Kt, Vt [d][FK]
          + static_cast<size_t>(d) * FQ * 2  // Qt, Gt [d][FQ]
          + static_cast<size_t>(FQ) * d * 2  // Qs, Gs [FQ][d]
          + static_cast<size_t>(FK) * SLD    // P^T / dS^T [FK][FQ+1]
          + 2 * FQ                           // lse, delta
          + 4 * 256);                        // dequant tables q, k, v, g
}

// rows [row0, row0 + F) of a [S, d] payload, dequantized: transposed into
// xt[d][F] (row index fastest across threads); rows past S read as 0.
__device__ __forceinline__ void load_t(float* xt, const unsigned char* base,
                                       const float* lut, int row0, int s,
                                       int d, int f) {
  for (int idx = threadIdx.x; idx < f * d; idx += THREADS) {
    const int r = idx % f, c = idx / f;
    const int gr = row0 + r;
    xt[c * f + r] = gr < s ? lut[base[static_cast<size_t>(gr) * d + c]] : 0.0f;
  }
}

// the same rows kept row-major in xs[F][d] (column index fastest).
__device__ __forceinline__ void load_r(float* xs, const unsigned char* base,
                                       const float* lut, int row0, int s,
                                       int d, int f) {
  for (int idx = threadIdx.x; idx < f * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    const int gr = row0 + r;
    xs[r * d + c] = gr < s ? lut[base[static_cast<size_t>(gr) * d + c]] : 0.0f;
  }
}

__global__ __launch_bounds__(THREADS) void qflash_dq_kernel(
    const unsigned char* __restrict__ qp, const unsigned char* __restrict__ kp,
    const unsigned char* __restrict__ vp, const unsigned char* __restrict__ gp,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int sq, int sk, int d, int g,
    const float* __restrict__ q_ab, const float* __restrict__ k_ab,
    const float* __restrict__ v_ab, const float* __restrict__ g_ab,
    int causal, int window, float scale, int fmt) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Gt = Qt + d * FQ;
  float* Kt = Gt + d * FQ;
  float* Vt = Kt + d * FK;
  float* Ks = Vt + d * FK;
  float* dS = Ks + FK * d;
  float* lse_s = dS + FQ * SLD;
  float* dlt_s = lse_s + FQ;
  float* lut_q = dlt_s + FQ;
  float* lut_k = lut_q + 256;
  float* lut_v = lut_k + 256;
  float* lut_g = lut_v + 256;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;           // query head (flattened B*KV*G)
  const int bkv = bh / g;              // its K/V head
  const int q0 = blockIdx.x * FQ;
  const int shift = sk - sq;           // END alignment of query rows

  s2fp8::fill_lut(lut_q, q_ab, fmt);
  s2fp8::fill_lut(lut_k, k_ab, fmt);
  s2fp8::fill_lut(lut_v, v_ab, fmt);
  s2fp8::fill_lut(lut_g, g_ab, fmt);
  if (tid < FQ) {
    const int gq = q0 + tid;
    const size_t row = static_cast<size_t>(bh) * sq + gq;
    lse_s[tid] = gq < sq ? lse[row] : 0.0f;
    dlt_s[tid] = gq < sq ? delta[row] : 0.0f;
  }
  __syncthreads();
  const size_t qoff = static_cast<size_t>(bh) * sq * d;
  load_t(Qt, qp + qoff, lut_q, q0, sq, d, FQ);
  load_t(Gt, gp + qoff, lut_g, q0, sq, d, FQ);

  const int tr = tid / 16, tc = tid % 16;
  const int ncol = (d + 15) / 16;
  float acc[4][NT4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT4; ++j) acc[i][j] = 0.0f;

  const int qpos_lo = q0 + shift;
  const int qpos_hi = min(q0 + FQ, sq) - 1 + shift;
  const auto* kbase = kp + static_cast<size_t>(bkv) * sk * d;
  const auto* vbase = vp + static_cast<size_t>(bkv) * sk * d;

  for (int k0 = 0; k0 < sk; k0 += FK) {
    if (causal && k0 > qpos_hi) break;                       // all later too
    if (window > 0 && k0 + FK - 1 <= qpos_lo - window) continue;
    __syncthreads();   // previous tile's readers are done with K/V/dS
    load_t(Kt, kbase, lut_k, k0, sk, d, FK);
    load_t(Vt, vbase, lut_v, k0, sk, d, FK);
    load_r(Ks, kbase, lut_k, k0, sk, d, FK);
    __syncthreads();

    {  // score and dP micro-tiles, then ds into shared memory
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
      for (int c = 0; c < d; ++c) {
        float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = Qt[c * FQ + tr * 4 + i];
          ga[i] = Gt[c * FQ + tr * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kb[j] = Kt[c * FK + tc * 4 + j];
          vb[j] = Vt[c * FK + tc * 4 + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        const int gq = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tc * 4 + j;
          const bool vis = gq < sq &&
                           visible(gq + shift, k0 + t, sk, causal, window);
          const float p =
              vis ? expf(__fmul_rn(s[i][j], scale) - lse_s[r]) : 0.0f;
          dS[r * SLD + t] = p * (dp[i][j] - dlt_s[r]) * scale;
        }
      }
    }
    __syncthreads();

    // dq += ds . K
    for (int t = 0; t < FK; ++t) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = dS[(tr * 4 + i) * SLD + t];
#pragma unroll
      for (int j = 0; j < NT4; ++j) {
        const int c = tc + 16 * j;
        if (j < ncol && c < d) {
          const float kv = Ks[t * d + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + tr * 4 + i;
    if (gq >= sq) continue;
    float* orow = dq + (static_cast<size_t>(bh) * sq + gq) * d;
#pragma unroll
    for (int j = 0; j < NT4; ++j) {
      const int c = tc + 16 * j;
      if (j < ncol && c < d) orow[c] = acc[i][j];
    }
  }
}

__global__ __launch_bounds__(THREADS) void qflash_dkdv_kernel(
    const unsigned char* __restrict__ qp, const unsigned char* __restrict__ kp,
    const unsigned char* __restrict__ vp, const unsigned char* __restrict__ gp,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int d,
    int g, const float* __restrict__ q_ab, const float* __restrict__ k_ab,
    const float* __restrict__ v_ab, const float* __restrict__ g_ab,
    int causal, int window, float scale, int fmt) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;
  float* Vt = Kt + d * FK;
  float* Qt = Vt + d * FK;
  float* Gt = Qt + d * FQ;
  float* Qs = Gt + d * FQ;
  float* Gs = Qs + FQ * d;
  float* PT = Gs + FQ * d;             // p^T, then ds^T: [FK][FQ+1]
  float* lse_s = PT + FK * SLD;
  float* dlt_s = lse_s + FQ;
  float* lut_q = dlt_s + FQ;
  float* lut_k = lut_q + 256;
  float* lut_v = lut_k + 256;
  float* lut_g = lut_v + 256;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;           // query head: per-head dk / dv
  const int bkv = bh / g;
  const int k0 = blockIdx.x * FK;
  const int shift = sk - sq;

  s2fp8::fill_lut(lut_q, q_ab, fmt);
  s2fp8::fill_lut(lut_k, k_ab, fmt);
  s2fp8::fill_lut(lut_v, v_ab, fmt);
  s2fp8::fill_lut(lut_g, g_ab, fmt);
  __syncthreads();
  const size_t kvoff = static_cast<size_t>(bkv) * sk * d;
  load_t(Kt, kp + kvoff, lut_k, k0, sk, d, FK);
  load_t(Vt, vp + kvoff, lut_v, k0, sk, d, FK);

  const int tr = tid / 16, tc = tid % 16;
  const int ncol = (d + 15) / 16;
  float dka[4][NT4], dva[4][NT4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT4; ++j) dka[i][j] = dva[i][j] = 0.0f;

  const size_t qoff = static_cast<size_t>(bh) * sq * d;
  const int kpos_hi = min(k0 + FK, sk) - 1;
  for (int q0 = 0; q0 < sq; q0 += FQ) {
    const int qpos_lo = q0 + shift;
    const int qpos_hi = min(q0 + FQ, sq) - 1 + shift;
    if (causal && k0 > qpos_hi) continue;                    // all hidden
    if (window > 0 && kpos_hi <= qpos_lo - window) continue;
    __syncthreads();   // previous tile's readers are done with Q/G/PT
    if (tid < FQ) {
      const int gq = q0 + tid;
      const size_t row = static_cast<size_t>(bh) * sq + gq;
      lse_s[tid] = gq < sq ? lse[row] : 0.0f;
      dlt_s[tid] = gq < sq ? delta[row] : 0.0f;
    }
    load_t(Qt, qp + qoff, lut_q, q0, sq, d, FQ);
    load_t(Gt, gp + qoff, lut_g, q0, sq, d, FQ);
    load_r(Qs, qp + qoff, lut_q, q0, sq, d, FQ);
    load_r(Gs, gp + qoff, lut_g, q0, sq, d, FQ);
    __syncthreads();

    // transposed micro-tiles: rows t = tr*4+i (keys), cols r = tc*4+j
    float p[4][4], ds[4][4];
    {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
      for (int c = 0; c < d; ++c) {
        float ka[4], va[4], qb[4], gb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = Kt[c * FK + tr * 4 + i];
          va[i] = Vt[c * FK + tr * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = Qt[c * FQ + tc * 4 + j];
          gb[j] = Gt[c * FQ + tc * 4 + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qb[j], ka[i], s[i][j]);
            dp[i][j] = fmaf(gb[j], va[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tc * 4 + j;
          const int gq = q0 + r;
          const bool vis = gq < sq &&
                           visible(gq + shift, k0 + t, sk, causal, window);
          p[i][j] = vis ? expf(__fmul_rn(s[i][j], scale) - lse_s[r]) : 0.0f;
          ds[i][j] = p[i][j] * (dp[i][j] - dlt_s[r]) * scale;
          PT[t * SLD + r] = p[i][j];
        }
      }
    }
    __syncthreads();
    // dv += p^T . G
    for (int r = 0; r < FQ; ++r) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = PT[(tr * 4 + i) * SLD + r];
#pragma unroll
      for (int j = 0; j < NT4; ++j) {
        const int c = tc + 16 * j;
        if (j < ncol && c < d) {
          const float gv = Gs[r * d + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dva[i][j] = fmaf(w[i], gv, dva[i][j]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        PT[(tr * 4 + i) * SLD + tc * 4 + j] = ds[i][j];
    __syncthreads();
    // dk += ds^T . Q
    for (int r = 0; r < FQ; ++r) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = PT[(tr * 4 + i) * SLD + r];
#pragma unroll
      for (int j = 0; j < NT4; ++j) {
        const int c = tc + 16 * j;
        if (j < ncol && c < d) {
          const float qv = Qs[r * d + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dka[i][j] = fmaf(w[i], qv, dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + tr * 4 + i;
    if (gk >= sk) continue;
    const size_t row = (static_cast<size_t>(bh) * sk + gk) * d;
#pragma unroll
    for (int j = 0; j < NT4; ++j) {
      const int c = tc + 16 * j;
      if (j < ncol && c < d) {
        dk[row + c] = dka[i][j];
        dv[row + c] = dva[i][j];
      }
    }
  }
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
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      qflash_fwd_kernel<kPayload>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + FQ - 1) / FQ, bh);
  qflash_fwd_kernel<kPayload><<<grid, THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, d, g,
      static_cast<const float*>(q_ab), static_cast<const float*>(k_ab),
      static_cast<const float*>(v_ab), static_cast<const float*>(o_ab),
      epilogue, causal, window, scale, fmt);
  return static_cast<int>(cudaGetLastError());
}

// The plain forward: q [bh, sq, d], k / v [bh, sk, d] and out [bh, sq, d]
// all f32 (dtype 0) or all bf16 (dtype 1); the K/V heads already
// broadcast (g = 1).
template <int SRC>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     int bh, int sq, int sk, int d, int causal, int window,
                     float scale, cudaStream_t st) {
  using T = typename Elem<SRC>::T;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      qflash_fwd_kernel<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  qflash_fwd_kernel<SRC><<<dim3((sq + FQ - 1) / FQ, bh), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nullptr, sq, sk, d, 1,
      nullptr, nullptr, nullptr, nullptr, 0, causal, window, scale, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, int bh, int sq, int sk, int d, int dtype,
                         int causal, int window, float scale, void* stream) {
  if (d < 1 || d > DMAX || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_flash_fwd<kF32>(q, k, v, out, bh, sq, sk, d,
                                             causal, window, scale, st)
                    : launch_flash_fwd<kBF16>(q, k, v, out, bh, sq, sk, d,
                                              causal, window, scale, st);
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
  const size_t smem_dq = dq_smem_bytes(d), smem_kv = dkdv_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      qflash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(qflash_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* pq = static_cast<const unsigned char*>(q);
  const unsigned char* pk = static_cast<const unsigned char*>(k);
  const unsigned char* pv = static_cast<const unsigned char*>(v);
  const unsigned char* pg = static_cast<const unsigned char*>(gout);
  const float* pl = static_cast<const float*>(lse);
  const float* pd = static_cast<const float*>(delta);
  const float* sq_ab = static_cast<const float*>(q_ab);
  const float* sk_ab = static_cast<const float*>(k_ab);
  const float* sv_ab = static_cast<const float*>(v_ab);
  const float* sg_ab = static_cast<const float*>(g_ab);
  qflash_dq_kernel<<<dim3((sq + FQ - 1) / FQ, bh), THREADS, smem_dq, st>>>(
      pq, pk, pv, pg, pl, pd, static_cast<float*>(dq), sq, sk, d, g, sq_ab,
      sk_ab, sv_ab, sg_ab, causal, window, scale, fmt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  qflash_dkdv_kernel<<<dim3((sk + FK - 1) / FK, bh), THREADS, smem_kv, st>>>(
      pq, pk, pv, pg, pl, pd, static_cast<float*>(dk), static_cast<float*>(dv),
      sq, sk, d, g, sq_ab, sk_ab, sv_ab, sg_ab, causal, window, scale, fmt);
  return static_cast<int>(cudaGetLastError());
}
