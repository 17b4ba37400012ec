// Payload GEMM, NN layout: C[M,N] = deq(A)[M,K] . deq(B)[K,N] in f32, with
// an optional fused Eq. 5 epilogue on the finished output tile.
//
// Replaces src/repro/kernels/s2fp8_matmul.py: s2fp8_matmul_pallas
// (_matmul_kernel), layout "nn".
//
// Bound on the card: operations at prefill widths (M = admitted rows x
// bucket, 2*M*K*N f32 FLOPs over 67 TFLOP/s), bytes at decode (M = 8: the
// K*N weight payload, 1 B/elt, over 3.35 TB/s).  The inverse map is a
// power law, not a scale, so fp8 tensor-core MMA cannot take the payloads;
// the product runs on the f32 CUDA cores with f32 accumulation (no TF32),
// as preferred_element_type=f32 does in the reference.
//
// Design: 128x128 output tiles, 256 threads each owning an 8x8 register
// micro-tile, K stepped 16 at a time through shared memory.  Each block
// first builds two 256-entry dequant tables (one per operand) with the
// shared s2fp8::decode, so dequantization of a tile is a table lookup —
// the same values as decoding each element, at 512 transcendental pairs
// per block.  Ragged M/N/K edges are masked at load (zeros contribute
// nothing) and at store.  The epilogue truncates each accumulator with
// the output site's stats before the single write.
#include "s2fp8_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8, THREADS = 256;

__global__ __launch_bounds__(THREADS) void qmatmul_nn_kernel(
    const unsigned char* __restrict__ A, const unsigned char* __restrict__ B,
    float* __restrict__ C, int M, int N, int K,
    const float* __restrict__ a_ab, const float* __restrict__ b_ab,
    const float* __restrict__ o_ab, int epilogue, int fmt_a, int fmt_b,
    int fmt_o) {
  __shared__ float lut_a[256], lut_b[256];
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  s2fp8::fill_lut(lut_a, a_ab, fmt_a);
  s2fp8::fill_lut(lut_b, b_ab, fmt_b);
  __syncthreads();

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // load assignment: A tile [BM x BK]: row tid/2, 8 columns from (tid%2)*8;
  // B tile [BK x BN]: row tid/16, 8 columns from (tid%16)*8.
  const int ar = tid >> 1, ac = (tid & 1) * 8;
  const int br = tid >> 4, bc = (tid & 15) * 8;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int gm = m0 + ar;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gk = k0 + ac + j;
        As[ac + j][ar] = (gm < M && gk < K)
                             ? lut_a[A[static_cast<size_t>(gm) * K + gk]]
                             : 0.0f;
      }
    }
    {
      const int gk = k0 + br;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gn = n0 + bc + j;
        Bs[br][bc + j] = (gk < K && gn < N)
                             ? lut_b[B[static_cast<size_t>(gk) * N + gn]]
                             : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float oa = 1.0f, ob = 0.0f;
  if (epilogue) {
    oa = o_ab[0];
    ob = o_ab[1];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (epilogue) v = s2fp8::truncate(v, oa, ob, fmt_o);
      C[static_cast<size_t>(gm) * N + gn] = v;
    }
  }
}

}  // namespace

extern "C" int s2fp8_qmatmul_nn(const void* a, const void* b, void* c, int m,
                                int n, int k, const void* a_ab,
                                const void* b_ab, const void* o_ab,
                                int epilogue, int fmt_a, int fmt_b, int fmt_o,
                                void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  qmatmul_nn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(b), static_cast<float*>(c), m, n, k,
      static_cast<const float*>(a_ab), static_cast<const float*>(b_ab),
      static_cast<const float*>(o_ab), epilogue, fmt_a, fmt_b, fmt_o);
  return static_cast<int>(cudaGetLastError());
}
