// Payload flash attention forward: softmax(QK^T * scale) V over S2FP8
// payloads, END-aligned causal / window mask, grouped-query K/V, rowwise
// logsumexp, optional fused Eq. 5 epilogue on the output.
//
// Replaces src/repro/kernels/flash_attention.py: qflash_fwd_pallas
// (_qflash_fwd_kernel, mask from _attn_mask).
//
// Bound on the card: operations (about 4*Sq*Sk*d f32 FLOPs per head, half
// of that under a causal mask, over 67 TFLOP/s); the payloads are 1 B/elt
// and read a few times.  Design: one block per (head, 64 query rows); K/V
// stream through shared memory 64 rows at a time, dequantized through
// per-block 256-entry tables built with the shared s2fp8::decode; the
// 64x64 score tile and the running (max, denominator) live in shared
// memory and the output accumulator in registers, so nothing of size
// Sq*Sk reaches device memory.  Tiles that the mask hides completely are
// skipped, which leaves every sum unchanged (their probabilities are 0 and
// their correction factor 1).  Masked logits are filled with -1e30, as in
// the reference, so the online rescaling never sees inf - inf.  Query
// head h reads K/V head h / g.  Head dims up to 128 (32, 64, 80 tested).
#include "s2fp8_common.cuh"

namespace {

constexpr int FQ = 64, FK = 64, THREADS = 256, DMAX = 128, SLD = FK + 1;
constexpr float kMask = -1e30f;

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

__global__ __launch_bounds__(THREADS) void qflash_fwd_kernel(
    const unsigned char* __restrict__ qp, const unsigned char* __restrict__ kp,
    const unsigned char* __restrict__ vp, float* __restrict__ out,
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

  s2fp8::fill_lut(lut_q, q_ab, fmt);
  s2fp8::fill_lut(lut_k, k_ab, fmt);
  s2fp8::fill_lut(lut_v, v_ab, fmt);
  if (tid < FQ) {
    m_s[tid] = kMask;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  const unsigned char* qbase = qp + static_cast<size_t>(bh) * sq * d;
  for (int idx = tid; idx < FQ * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    const int gq = q0 + r;
    Qt[c * FQ + r] = gq < sq ? lut_q[qbase[static_cast<size_t>(gq) * d + c]]
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
  const unsigned char* kbase = kp + static_cast<size_t>(bkv) * sk * d;
  const unsigned char* vbase = vp + static_cast<size_t>(bkv) * sk * d;

  for (int k0 = 0; k0 < sk; k0 += FK) {
    if (causal && k0 > qpos_hi) break;                       // all later too
    if (window > 0 && k0 + FK - 1 <= qpos_lo - window) continue;
    __syncthreads();   // previous tile's readers are done with Kt/Vs/S
    for (int idx = tid; idx < FK * d; idx += THREADS) {
      const int t = idx / d, c = idx % d;
      const int gk = k0 + t;
      const bool in = gk < sk;
      const size_t off = static_cast<size_t>(gk) * d + c;
      Kt[c * FK + t] = in ? lut_k[kbase[off]] : 0.0f;
      Vs[t * d + c] = in ? lut_v[vbase[off]] : 0.0f;
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
  if (epilogue) {
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
    float* orow = out + (static_cast<size_t>(bh) * sq + gq) * d;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int c = tc + 16 * j;
      if (j >= ncol || c >= d) continue;
      float v = acc[i][j] / denom;
      if (epilogue) v = s2fp8::truncate(v, oa, ob, fmt);
      orow[c] = v;
    }
    if (tc == 0)
      lse[static_cast<size_t>(bh) * sq + gq] =
          m_s[r] + logf(fmaxf(l, 1e-30f));
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
      qflash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + FQ - 1) / FQ, bh);
  qflash_fwd_kernel<<<grid, THREADS, smem,
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
