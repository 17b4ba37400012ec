// Payload GEMM, layouts NN / NT / TN: C[M,N] = deq(A) . deq(B) in f32, with
// an optional fused Eq. 5 epilogue on the finished output tile.
//
//   nn: C[M,N] = A[M,K]   . B[K,N]      (forward GEMMs)
//   nt: C[M,N] = A[M,K]   . B[N,K]^T    (dA = g . B^T; the tied LM head)
//   tn: C[M,N] = A[K,M]^T . B[K,N]      (dB = A^T . g)
//
// Replaces src/repro/kernels/s2fp8_matmul.py: s2fp8_matmul_pallas
// (_matmul_kernel with _operand_specs), all three layouts, and
// s2fp8_matmul_batched_pallas (_batched_matmul_kernel with
// _batched_operand_specs): the batched GEMM C[Go,M,N] from A[Ga,.,.] and
// B[Gb,.,.] over the combined batch G = max(Ga, Gb), where combined step g
// reads A slice g % Ga and B slice g % Gb (the trailing-aligned broadcast
// of the MoE "becd,edf" einsums), and output slice gz sums the G / Go steps
// g = gr * Go + gz (the dW of a broadcast operand).  A 2-D GEMM is the
// batched one with G = Go = 1.
//
// Bound on the card: operations at training and prefill widths (2*M*K*N
// f32 FLOPs over 67 TFLOP/s), bytes at decode (M = 8: the K*N weight
// payload, 1 B/elt, over 3.35 TB/s); the MoE expert GEMMs (G = 64, M =
// capacity 256, K and N 2048 / 1408) are bound by operations too.  The
// inverse map is a power law, not
// a scale, so fp8 tensor-core MMA cannot take the payloads; the product
// runs on the f32 CUDA cores with f32 accumulation (no TF32), as
// preferred_element_type=f32 does in the reference.
//
// Design: 128x128 output tiles, 256 threads each owning an 8x8 register
// micro-tile, K stepped 16 at a time through shared memory tiles
// As[BK][BM] and Bs[BK][BN].  Each block first builds two 256-entry
// dequant tables (one per operand) with the shared s2fp8::decode, so
// dequantization of a tile is a table lookup — the same values as decoding
// each element, at 512 transcendental pairs per block.  A layout is only
// the addressing of the tile loads (the reference's index-map swaps): no
// transpose is materialized.  An operand stored with K contiguous (A in
// nn/nt, B in nt) is read 8 consecutive K per thread and stored transposed
// into the K-major tile; an operand stored with M or N contiguous (A in
// tn, B in nn/tn) is read 8 consecutive M/N per thread and stored as is.
// The compute loop is the same for every layout, so the three sum each
// output in the same order.  Ragged M/N/K edges are masked at load (zeros
// contribute nothing) and at store.  The epilogue truncates each
// accumulator with the output site's stats before the single write.
//
// Batched: grid axis z walks the Go output slices; each block loops over
// its G / Go reduction groups and, inside each, over the K tiles, keeping
// one accumulator.  So each output element is summed in one fixed order
// (group by group, K ascending) with no atomics, the result does not
// depend on scheduling, and the epilogue runs once, on the finished tile.
// (alpha, beta) are per tensor, so the dequant tables serve every slice.
#include "s2fp8_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8, THREADS = 256;
enum Layout { kNN = 0, kNT = 1, kTN = 2 };

// BATCHED = false is the 2-D GEMM (one slice, one group); the two
// instantiations also keep the batched launches apart in a profile.
template <int LAYOUT, bool BATCHED>
__global__ __launch_bounds__(THREADS) void qmatmul_kernel(
    const unsigned char* __restrict__ A, const unsigned char* __restrict__ B,
    float* __restrict__ C, int M, int N, int K, int ga, int gb, int go,
    int groups, const float* __restrict__ a_ab, const float* __restrict__ b_ab,
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
  const int gz = BATCHED ? blockIdx.z : 0;
  if (!BATCHED) groups = 1;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // load assignment.  K-contiguous operand: row tid/2 of the 128 M (or N)
  // rows, 8 K from (tid%2)*8.  M/N-contiguous operand: K row tid/16 of 16,
  // 8 columns from (tid%16)*8.
  const int rr = tid >> 1, rc = (tid & 1) * 8;
  const int kr = tid >> 4, kc = (tid & 15) * 8;

  for (int gr = 0; gr < groups; ++gr) {
    const int g = gr * go + gz;
    const unsigned char* __restrict__ Ag =
        A + static_cast<size_t>(g % ga) * M * K;
    const unsigned char* __restrict__ Bg =
        B + static_cast<size_t>(g % gb) * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
      if (LAYOUT == kTN) {           // A stored [K, M]
        const int gk = k0 + kr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gm = m0 + kc + j;
          As[kr][kc + j] = (gk < K && gm < M)
                               ? lut_a[Ag[static_cast<size_t>(gk) * M + gm]]
                               : 0.0f;
        }
      } else {                       // A stored [M, K]
        const int gm = m0 + rr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gk = k0 + rc + j;
          As[rc + j][rr] = (gm < M && gk < K)
                               ? lut_a[Ag[static_cast<size_t>(gm) * K + gk]]
                               : 0.0f;
        }
      }
      if (LAYOUT == kNT) {           // B stored [N, K]
        const int gn = n0 + rr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gk = k0 + rc + j;
          Bs[rc + j][rr] = (gn < N && gk < K)
                               ? lut_b[Bg[static_cast<size_t>(gn) * K + gk]]
                               : 0.0f;
        }
      } else {                       // B stored [K, N]
        const int gk = k0 + kr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gn = n0 + kc + j;
          Bs[kr][kc + j] = (gk < K && gn < N)
                               ? lut_b[Bg[static_cast<size_t>(gk) * N + gn]]
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
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  C += static_cast<size_t>(gz) * M * N;

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

template <bool BATCHED>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           int ga, int gb, int go, int groups, int layout, const void* a_ab,
           const void* b_ab, const void* o_ab, int epilogue, int fmt_a,
           int fmt_b, int fmt_o, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, go);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* pa = static_cast<const unsigned char*>(a);
  const unsigned char* pb = static_cast<const unsigned char*>(b);
  float* pc = static_cast<float*>(c);
  const float* sa = static_cast<const float*>(a_ab);
  const float* sb = static_cast<const float*>(b_ab);
  const float* so = static_cast<const float*>(o_ab);
  switch (layout) {
    case kNN:
      qmatmul_kernel<kNN, BATCHED><<<grid, THREADS, 0, st>>>(
          pa, pb, pc, m, n, k, ga, gb, go, groups, sa, sb, so, epilogue,
          fmt_a, fmt_b, fmt_o);
      break;
    case kNT:
      qmatmul_kernel<kNT, BATCHED><<<grid, THREADS, 0, st>>>(
          pa, pb, pc, m, n, k, ga, gb, go, groups, sa, sb, so, epilogue,
          fmt_a, fmt_b, fmt_o);
      break;
    case kTN:
      qmatmul_kernel<kTN, BATCHED><<<grid, THREADS, 0, st>>>(
          pa, pb, pc, m, n, k, ga, gb, go, groups, sa, sb, so, epilogue,
          fmt_a, fmt_b, fmt_o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout: 0 nn, 1 nt, 2 tn; (m, n, k) are the logical GEMM's dimensions.
extern "C" int s2fp8_qmatmul(const void* a, const void* b, void* c, int m,
                             int n, int k, int layout, const void* a_ab,
                             const void* b_ab, const void* o_ab, int epilogue,
                             int fmt_a, int fmt_b, int fmt_o, void* stream) {
  return launch<false>(a, b, c, m, n, k, 1, 1, 1, 1, layout, a_ab, b_ab,
                       o_ab, epilogue, fmt_a, fmt_b, fmt_o, stream);
}

// Batched: a holds ga slices, b gb slices, c go slices of the per-slice
// (m, n, k) GEMM; groups = max(ga, gb) / go reduction groups per output
// slice.  The caller checks that ga, gb and go divide max(ga, gb).
extern "C" int s2fp8_qmatmul_batched(
    const void* a, const void* b, void* c, int m, int n, int k, int ga,
    int gb, int go, int groups, int layout, const void* a_ab,
    const void* b_ab, const void* o_ab, int epilogue, int fmt_a, int fmt_b,
    int fmt_o, void* stream) {
  return launch<true>(a, b, c, m, n, k, ga, gb, go, groups, layout, a_ab,
                      b_ab, o_ab, epilogue, fmt_a, fmt_b, fmt_o, stream);
}
