// Paged S2FP8 decode attention: one query token per slot against that
// slot's payload KV blocks, gathered through the block table.
//
// Replaces src/repro/kernels/paged_attention.py: paged_decode_attention
// (_paged_kernel).
//
// Bound on the card: bytes.  Per slot and KV head it reads the live
// prefix's K and V payloads (1 B/elt) once; the arithmetic is 4*G*hd
// FLOPs per cached position.  Design: one block per (KV head, slot).
// Hopper has no scalar prefetch, so the block reads table[slot, j] itself
// and walks only the blocks that hold positions <= positions[slot] (a
// block past the position is fully masked, and skipping it leaves the
// online softmax unchanged).  Each payload block is dequantized through
// 256-entry tables built with the shared s2fp8::decode into shared memory;
// scores, the running max / denominator and the output accumulator stay in
// shared memory.  Block 0 is the trash block: a dead slot (position 0)
// attends to it and returns finite garbage, as in the reference.
#include "s2fp8_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float kMask = -1e30f;

size_t smem_bytes(int g, int hd, int blk) {
  return sizeof(float) *
         (static_cast<size_t>(g) * hd         // q
          + static_cast<size_t>(hd) * blk     // Kt [hd][blk]
          + static_cast<size_t>(blk) * hd     // Vs [blk][hd]
          + static_cast<size_t>(g) * blk      // S  [g][blk]
          + static_cast<size_t>(g) * hd       // acc
          + 3 * static_cast<size_t>(g)        // m, l, corr
          + 2 * 256);                         // dequant tables k, v
}

__global__ __launch_bounds__(THREADS) void paged_decode_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ kp,
    const unsigned char* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ positions, float* __restrict__ out, int kvh,
    int g, int hd, int blk, int max_b, const float* __restrict__ k_ab,
    const float* __restrict__ v_ab, float inv_sqrt_d, int fmt) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* Kt = qs + g * hd;
  float* Vs = Kt + hd * blk;
  float* S = Vs + blk * hd;
  float* acc = S + g * blk;
  float* m_s = acc + g * hd;
  float* l_s = m_s + g;
  float* c_s = l_s + g;
  float* lut_k = c_s + g;
  float* lut_v = lut_k + 256;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];

  s2fp8::fill_lut(lut_k, k_ab, fmt);
  s2fp8::fill_lut(lut_v, v_ab, fmt);
  const float* qrow = q + (static_cast<size_t>(b) * kvh + h) * g * hd;
  for (int i = tid; i < g * hd; i += THREADS) {
    qs[i] = qrow[i];
    acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += THREADS) {
    m_s[i] = kMask;
    l_s[i] = 0.0f;
  }
  __syncthreads();

  const int nblocks = min(max_b, pos / blk + 1);
  const int lane = tid % 32, warp = tid / 32;
  for (int j = 0; j < nblocks; ++j) {
    const int bid = table[static_cast<size_t>(b) * max_b + j];
    const size_t base = (static_cast<size_t>(bid) * kvh + h) * blk * hd;
    for (int i = tid; i < blk * hd; i += THREADS) {
      const int t = i / hd, c = i % hd;
      Kt[c * blk + t] = lut_k[kp[base + i]];
      Vs[i] = lut_v[vp[base + i]];
    }
    __syncthreads();
    for (int i = tid; i < g * blk; i += THREADS) {
      const int gi = i / blk, t = i % blk;
      float s = 0.0f;
      for (int c = 0; c < hd; ++c) s = fmaf(qs[gi * hd + c], Kt[c * blk + t], s);
      S[i] = (j * blk + t <= pos) ? s * inv_sqrt_d : kMask;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += THREADS / 32) {   // one warp per row
      float mx = kMask;
      for (int t = lane; t < blk; t += 32) mx = fmaxf(mx, S[gi * blk + t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < blk; t += 32) {
        const float p =
            (j * blk + t <= pos) ? expf(S[gi * blk + t] - m_new) : 0.0f;
        S[gi * blk + t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[gi] = corr;
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * hd; i += THREADS) {
      const int gi = i / hd, c = i % hd;
      float pv = 0.0f;
      for (int t = 0; t < blk; ++t) pv = fmaf(S[gi * blk + t], Vs[t * hd + c], pv);
      acc[i] = acc[i] * c_s[gi] + pv;
    }
    __syncthreads();
  }

  float* orow = out + (static_cast<size_t>(b) * kvh + h) * g * hd;
  for (int i = tid; i < g * hd; i += THREADS) {
    const float l = l_s[i / hd];
    orow[i] = acc[i] / (l == 0.0f ? 1.0f : l);
  }
}

}  // namespace

extern "C" int s2fp8_paged_decode(const void* q, const void* kp,
                                  const void* vp, const void* table,
                                  const void* positions, void* out, int b,
                                  int kvh, int g, int hd, int blk, int max_b,
                                  const void* k_ab, const void* v_ab,
                                  float inv_sqrt_d, int fmt, void* stream) {
  const size_t smem = smem_bytes(g, hd, blk);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(kvh, b);
  paged_decode_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(kp),
      static_cast<const unsigned char*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<float*>(out), kvh, g,
      hd, blk, max_b, static_cast<const float*>(k_ab),
      static_cast<const float*>(v_ab), inv_sqrt_d, fmt);
  return static_cast<int>(cudaGetLastError());
}
