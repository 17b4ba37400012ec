// Payload GEMM, layouts NN / NT / TN: C[M,N] = deq(A) . deq(B) in f32, with
// an optional fused Eq. 5 epilogue on the finished output.
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
// Operands: row-major payload bytes whose rows are `lda` / `ldb` bytes
// apart, a multiple of 16, at 16-byte aligned addresses; bytes past a
// row's logical end are code 0, which decodes to 0 (the wrapper pads a
// payload whose rows are not so, e.g. the 122,753-column vocabulary).
// The inverse map is a power law, not a scale, so fp8 tensor-core MMA
// cannot take the payloads.  Two paths, chosen by the wrapper's planner
// (kernels/s2fp8_matmul.py: plan_gemm) from the shape:
//
// Large M (training, prefill, the MoE experts): bound by operations.  The
// products run on TF32 tensor cores in three passes ("3xTF32", as the
// flash kernels): every dequantized value is split into hi = tf32(x) and
// lo = tf32(x - hi), truncated, and a k8 step accumulates lo.hi + hi.lo +
// hi.hi in f32 (lo.lo, under 2^-20 relative, is dropped); one pass would
// keep 11 bits and miss the 1e-5 * |A||B| tolerance
// (tests/test_torch_gemm_split.py rehearses both).  The bound is 3 x
// 2MKN FLOPs at 495 TFLOP/s.  Design:
//
// * One block a SM walks a share of the BM x 128 output tiles (BM = 128,
//   or 64 for M <= 64), so its tables are built once and the next tile's
//   stages fill while one tile's epilogue runs.  A block has BM / 64
//   consumer warpgroups and one producer warpgroup, which hands registers
//   to the consumers (setmaxnreg).
// * The producer copies raw payload tiles (BM x 32 and 128 x 32 bytes) into
//   a ring of RAW_STAGES stages with 16-byte cp.async.  It dequantizes B's
//   tile once a stage: every code is looked up in the block's table (32
//   interleaved copies, a warp's lookups free of bank conflicts), split
//   into (hi, lo) in registers and written into K-major hi and lo tiles
//   with the 128-byte swizzle that wgmma reads.  A's codes it only moves
//   into K-contiguous rows.  A layout is only how these passes address
//   their reads: a K-contiguous operand (A in nn / nt, B in nt) is read 4
//   codes along K per row, an M/N-contiguous one (A in tn, B in nn / tn) as
//   4 x 4 blocks transposed in registers; raw M/N-contiguous tiles are
//   stored with their 16-byte chunks XOR-swizzled, so these passes read and
//   write shared memory without bank conflicts.  No transpose is
//   materialized.
// * Consumers run wgmma.mma_async m64n128k8 .f32.tf32.tf32 with A from
//   registers and B from shared memory.  Each thread looks A's 16 codes of
//   a stage up itself and splits them into its (hi, lo) fragments, so A's
//   dequantized tile never passes through shared memory.  Per k8 step
//   lo.hi, hi.lo, hi.hi go into one accumulator (64 f32 a thread), which
//   is added to a second in f32 once a stage: the tensor cores' adds do
//   not round to nearest, and a sum over all of K drifted past the
//   tolerance.  Three stages hand over through mbarriers (full: the
//   producer's 128 threads; empty: the consumers'), so the producer
//   prepares later stages while the tensor cores work.  A's tile is not
//   dequantized into shared memory: that doubles the producer's pass,
//   which then bounds the kernel, and the shared-memory traffic.
// * Epilogue: Eq. 5 with the output site's stats on the finished
//   accumulator, then the single write.  Ragged M/N/K edges: rows and
//   chunks past the operand are zero-filled by the copy, outputs masked.
// * Batched: the Go output slices' tiles are items too; an item loops
//   over its G / Go reduction groups and, inside each, over the K tiles,
//   with one accumulator.  So each output element is summed in one fixed
//   order (group by group, K ascending) with no atomics, and the epilogue
//   runs once.  (alpha, beta) are per tensor, so the tables serve every
//   slice.
//
// Small M (decode: M <= 16 slots, NN projections and the NT tied head):
// bound by the weight's bytes (K x N at 1 B/elt over 3.35 TB/s).  The
// weight streams once in 16-byte coalesced loads; each code is decoded
// once (a table lookup) and used for every row of A with exact f32 FMAs
// (A's rows, dequantized, wait in shared memory).  K is split S ways so
// that the grid covers at least two waves of the card: the first kernel
// writes partial sums to a scratch [S, M, N] f32 tensor, a second sums the
// S partials in index order and applies the epilogue (no atomics: two
// launches give the same bits).  With S = 1 (the tied head's 959 column
// tiles fill the card) the first kernel writes the output itself.
#include <algorithm>
#include <climits>
#include <cstdint>

#include "tc_common.cuh"

namespace {

enum Layout { kNN = 0, kNT = 1, kTN = 2 };

// ---------------------------------------------------------------------------
// shared memory, barriers, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();   // a lost arrival: fail, never hang
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
  __syncwarp();
}

// Make this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int PRODUCERS = 128;   // threads of the producer warpgroup

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
}

// Hand registers from the producer warpgroup to the consumers.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes (32 f32 along K), 8-row groups 1024 bytes
// apart (stride byte offset), tile base 1024-byte aligned; a k8 step
// advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// d[64 x 128] = a[64 x 8] . b[8 x 128] (+ d if `accumulate`), TF32 in, f32
// accumulate, A from registers and B from shared memory (descriptor b).
// Thread t of the warpgroup holds a[0..3] = A rows 16 (t / 32) + (t % 32)
// / 4 (+ 8 for a[1], a[3]), columns t % 4 (+ 4 for a[2], a[3]), as TF32 bit
// patterns, and d[4j .. 4j + 3] = D rows 16 (t / 32) + (t % 32) / 4 (+ 8
// for d[4j + 2], d[4j + 3]), columns 8j + 2 (t % 4) (+ 1 for d[4j + 1],
// d[4j + 3]).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// Keep the compiler from moving reads of the accumulator above a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// large-M path
// ---------------------------------------------------------------------------

constexpr int BN = 128;           // output columns a block
constexpr int BK = 32;            // K a stage: one 128-byte swizzle row of f32
constexpr int RAW_STAGES = 4;     // raw payload tiles in flight
constexpr int SPLIT_STAGES = 3;   // B's (hi, lo) tiles and A's codes
constexpr int LUT_COPIES = 32;
constexpr int LUT_ENTRIES = 256 * LUT_COPIES;   // floats a table

template <int WGS>   // consumer warpgroups
struct Large {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS + PRODUCERS;
  static constexpr int B_SPLIT = BN * BK * 4;   // bytes of B's hi or lo
  static constexpr int A_CODES = BM * BK;       // A's codes, K-contiguous
  static constexpr int STAGE_SPLIT = 2 * B_SPLIT + A_CODES;
  // registers a thread after the hand-over (setmaxnreg), within the
  // THREADS x 168 (or 248) that ptxas reserves at launch
  static constexpr int PRODUCER_REGS = 96, CONSUMER_REGS = 200;
  static_assert(PRODUCERS * PRODUCER_REGS + 128 * WGS * CONSUMER_REGS <=
                    THREADS * (THREADS > 256 ? 168 : 248),
                "register hand-over");
  static_assert(STAGE_SPLIT % 1024 == 0, "swizzled tiles 1024-aligned");
  static constexpr int A_RAW = BM * BK, B_RAW = BN * BK;
  static constexpr int STAGE_RAW = A_RAW + B_RAW;
  static constexpr int SMEM = 1024 /* alignment */ +
                              SPLIT_STAGES * STAGE_SPLIT +
                              RAW_STAGES * STAGE_RAW +
                              2 * LUT_ENTRIES * 4 + 256 * 4 +
                              2 * SPLIT_STAGES * 8;
};
static_assert(Large<2>::SMEM <= 232448, "shared memory of a 128-row block");

// The block's dequantize tables for the large path, A's then B's: entry
// c * LUT_COPIES + k (copy k of code c) is decode(c); lane l reads copy l,
// so a warp's 32 lookups of random codes meet no bank conflict.  The 512
// decodes go through `stage` (2 KB), then are copied out.  Whole block.
__device__ __forceinline__ void fill_tables(float* lut, float* stage,
                                            const float* a_ab,
                                            const float* b_ab, int fmt_a,
                                            int fmt_b) {
  for (int c = threadIdx.x; c < 512; c += blockDim.x) {
    const float* ab = c < 256 ? a_ab : b_ab;
    stage[c] = s2fp8::decode(static_cast<unsigned char>(c & 255), ab[0],
                             ab[1], c < 256 ? fmt_a : fmt_b);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * LUT_ENTRIES; i += blockDim.x)
    lut[i] = stage[i / LUT_COPIES];
}

// Byte offset of row r, 16-byte chunk q in a K-major 128-byte-swizzled tile.
__device__ __forceinline__ int sw128(int r, int q) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((q ^ (r & 7)) << 4);
}

// One operand's raw tile for K rows [k0, k0 + BK) and rows (M or N)
// [r0, r0 + R), issued by the producer threads (thread `pt`).  KC
// (stored [rows][ld], K contiguous): raw tile [R][BK].  Otherwise (stored
// [K][ld]): raw tile [BK][R], chunk c of K row kk at chunk position
// c ^ ((kk / 4) % (R / 16)).  Chunks past the operand read as zeros.
template <int R, bool KC>
__device__ __forceinline__ void copy_raw(uint8_t* dst, const uint8_t* src,
                                         int ld, int rows, int r0, int K,
                                         int k0, int pt) {
  constexpr int NCH = R / 16;
  static_assert(2 * R % PRODUCERS == 0, "every producer copies as much");
#pragma unroll
  for (int j = 0; j < 2 * R / PRODUCERS; ++j) {
    const int i = pt + PRODUCERS * j;
    if constexpr (KC) {
      const int r = i >> 1, c = i & 1;
      const bool ok = r0 + r < rows && k0 + 16 * c < K;
      const uint8_t* s =
          ok ? src + static_cast<size_t>(r0 + r) * ld + k0 + 16 * c : src;
      tc::cp_async<16>(dst + r * BK + 16 * c, s, ok);
    } else {
      const int kk = i / NCH, c = i % NCH;
      const bool ok = k0 + kk < K && r0 + 16 * c < rows;
      const uint8_t* s =
          ok ? src + static_cast<size_t>(k0 + kk) * ld + r0 + 16 * c : src;
      tc::cp_async<16>(dst + kk * R + 16 * (c ^ ((kk >> 2) & (NCH - 1))), s,
                       ok);
    }
  }
}

// Dequantize one operand's raw tile into its hi / lo tiles.  Producer
// warp `pw` (of 4) takes the 16-row units pw, pw + 4, ...; lane 8p + q
// covers K chunk q (4 codes) of 4 of a unit's rows, so a quarter-warp
// writes 8 chunks of one row.  A K-contiguous tile gives a lane rows
// 16u + p + 4r, one word of 4 codes each; an M/N-contiguous one rows
// 16u + 4p + r, byte r of the words of K rows 4q .. 4q + 3.  Every raw
// word, then every table entry, is loaded before the first store, so the
// loads' latencies overlap.  `lut` is this lane's copy of the table; the
// (hi, lo) split is taken in registers.
template <int R, bool KC>
__device__ __forceinline__ void dequant(const uint8_t* raw, uint8_t* hi,
                                        uint8_t* lo, const float* lut,
                                        int pw, int lane) {
  constexpr int NCH = R / 16, W = PRODUCERS / 32, U = NCH / W;
  static_assert(U * W == NCH, "every producer warp takes as many units");
  const int q = lane & 7, p = lane >> 3;
  uint32_t w[U][4];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = pw + W * i;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      w[i][t] = *reinterpret_cast<const uint32_t*>(
          KC ? raw + (16 * u + p + 4 * t) * BK + 4 * q
             : raw + (4 * q + t) * R + 16 * (u ^ (q & (NCH - 1))) + 4 * p);
  }
  float e[U][4][4];   // [unit][row][K]
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        e[i][r][c] = lut[(KC ? (w[i][r] >> (8 * c)) : (w[i][c] >> (8 * r))) %
                         256 * LUT_COPIES];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = pw + W * i;
      const int off = sw128(KC ? 16 * u + p + 4 * r : 16 * u + 4 * p + r, q);
      uint4 h, l;
      tc::split(e[i][r][0], h.x, l.x);
      tc::split(e[i][r][1], h.y, l.y);
      tc::split(e[i][r][2], h.z, l.z);
      tc::split(e[i][r][3], h.w, l.w);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
}

// Byte offset of A's codes of row r, K 4c .. 4c + 3 in a stage: rows of 32
// bytes, whose two 16-byte halves swap in every other group of 4 rows, so
// the consumers' 8-byte fragment loads (8 rows 8 apart, 4 lanes a row)
// meet no bank conflict.
__device__ __forceinline__ int a_code_off(int r, int c) {
  return r * BK + 16 * ((c >> 2) ^ ((r >> 2) & 1)) + 4 * (c & 3);
}

// A's raw tile into the stage's code rows (the producer, thread `pt` of
// warp `pw`): K-contiguous tiles move in 16-byte halves; M-contiguous ones
// as 4 x 4 blocks transposed in registers, addressed as in `dequant`.
template <int R, bool KC>
__device__ __forceinline__ void stage_a(const uint8_t* raw, uint8_t* dst,
                                        int pt, int pw, int lane) {
  if constexpr (KC) {
#pragma unroll
    for (int j = 0; j < 2 * R / PRODUCERS; ++j) {
      const int i = pt + PRODUCERS * j, r = i >> 1, h = i & 1;
      *reinterpret_cast<uint4*>(dst + a_code_off(r, 4 * h)) =
          *reinterpret_cast<const uint4*>(raw + r * BK + 16 * h);
    }
  } else {
    constexpr int NCH = R / 16, W = PRODUCERS / 32, U = NCH / W;
    const int q = lane & 7, p = lane >> 3;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = pw + W * i;
      uint32_t w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        w[t] = *reinterpret_cast<const uint32_t*>(
            raw + (4 * q + t) * R + 16 * (u ^ (q & (NCH - 1))) + 4 * p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // row 16u + 4p + j, K 4q .. 4q + 3
        const uint32_t sel = j | ((j + 4) << 4);
        *reinterpret_cast<uint32_t*>(dst + a_code_off(16 * u + 4 * p + j, q)) =
            __byte_perm(__byte_perm(w[0], w[1], sel),
                        __byte_perm(w[2], w[3], sel), 0x5410);
      }
    }
  }
}

// BATCHED = false is the 2-D GEMM (one slice, one group); the two
// instantiations also keep the batched launches apart in a profile.
template <int LAYOUT, int WGS, bool BATCHED>
__global__ __launch_bounds__(Large<WGS>::THREADS, 1) void gemm_large_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
    float* __restrict__ C, int M, int N, int K, int lda, int ldb, int ga,
    int gb, int go, int groups, const float* __restrict__ a_ab,
    const float* __restrict__ b_ab, const float* __restrict__ o_ab,
    int epilogue, int fmt_a, int fmt_b, int fmt_o) {
  using G = Large<WGS>;
  constexpr int BM = G::BM;
  constexpr bool A_KC = LAYOUT != kTN, B_KC = LAYOUT == kNT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* split = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* raw = split + SPLIT_STAGES * G::STAGE_SPLIT;
  float* lut_a = reinterpret_cast<float*>(raw + RAW_STAGES * G::STAGE_RAW);
  float* lut_b = lut_a + LUT_ENTRIES;
  float* lut_o = lut_b + LUT_ENTRIES;
  uint64_t* full = reinterpret_cast<uint64_t*>(lut_o + 256);
  uint64_t* empty = full + SPLIT_STAGES;

  fill_tables(lut_a, reinterpret_cast<float*>(raw), a_ab, b_ab, fmt_a,
              fmt_b);   // the raw ring is free until the first copy
  if (epilogue) s2fp8::fill_lut(lut_o, o_ab, fmt_o);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < SPLIT_STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], 128 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's output tiles (items) are blockIdx.x, + gridDim.x, ...:
  // item w is column tile w % NT of row tile (w / NT) % MT of output slice
  // w / (NT MT).  Producer and consumers walk the same sequence of stages,
  // item by item, groups and K tiles within each, so the producer fills
  // the next item's stages while the consumers finish one.
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (!BATCHED) groups = 1;
  const int NT = (N + BN - 1) / BN, MT = (M + BM - 1) / BM;
  const int items = NT * MT * (BATCHED ? go : 1);
  const int mine = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int KT = max(1, (K + BK - 1) / BK), TI = groups * KT, T = mine * TI;
  auto item = [&](int i, int& gz, int& m0, int& n0) {
    const int w = blockIdx.x + i * gridDim.x;
    n0 = (w % NT) * BN;
    m0 = (w / NT % MT) * BM;
    gz = w / (NT * MT);
  };

  if (wg >= WGS) {   // producer: copies, B's dequantize pass, A's codes
    regs_dec<G::PRODUCER_REGS>();
    const int pt = threadIdx.x - 128 * WGS, pw = pt >> 5;
    const size_t a_slice = static_cast<size_t>(A_KC ? M : K) * lda;
    const size_t b_slice = static_cast<size_t>(B_KC ? N : K) * ldb;
    const float* lb = lut_b + lane % LUT_COPIES;
    // the next stage to copy: item i, reduction group gr, K tile kt (the
    // stages are issued in order, so the cursor only steps forward)
    int i = 0, gr = 0, kt = 0, gz, m0, n0;
    const uint8_t *ag, *bg;   // the operand slices of step g = gr Go + gz
    auto slices = [&] {
      const int g = gr * go + gz;
      ag = A + (g % ga) * a_slice;
      bg = B + (g % gb) * b_slice;
    };
    item(0, gz, m0, n0);
    slices();
    auto issue = [&](int t) {
      if (t < T) {
        uint8_t* dst = raw + (t % RAW_STAGES) * G::STAGE_RAW;
        copy_raw<BM, A_KC>(dst, ag, lda, M, m0, K, kt * BK, pt);
        copy_raw<BN, B_KC>(dst + G::A_RAW, bg, ldb, N, n0, K, kt * BK, pt);
        if (++kt == KT) {
          kt = 0;
          if (++gr == groups) {
            gr = 0;
            if (++i < mine) item(i, gz, m0, n0);
          }
          slices();
        }
      }
      tc::cp_async_commit();
    };
#pragma unroll 1
    for (int t = 0; t < RAW_STAGES - 1; ++t) issue(t);
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      // tile t has landed (every thread's copies), and every thread is done
      // with tile t - 1's raw stage, which the next copy overwrites
      tc::cp_async_wait<RAW_STAGES - 2>();
      producer_sync();
      issue(t + RAW_STAGES - 1);
      const int s = t % SPLIT_STAGES;
      mbar_wait(&empty[s], ((t / SPLIT_STAGES) & 1) ^ 1);
      const uint8_t* src = raw + (t % RAW_STAGES) * G::STAGE_RAW;
      uint8_t* st = split + s * G::STAGE_SPLIT;
      dequant<BN, B_KC>(src + G::A_RAW, st, st + G::B_SPLIT, lb, pw, lane);
      stage_a<BM, A_KC>(src, st + 2 * G::B_SPLIT, pt, pw, lane);
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns output rows m0 + 64 wg .. + 63 of each
  // item.  Each thread looks up its 16 codes of A a stage (rows ra and
  // ra + 8, K 8j + tq and 8j + tq + 4) and splits them into its fragments.
  // The tensor cores sum a stage's 12 products into `part` (their adds do
  // not round to nearest: a sum over all of K drifts by ~K/8 ulps); each
  // stage's part is added to `acc` in f32, stage by stage.
  regs_inc<G::CONSUMER_REGS>();
  const int ra = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int tq = lane & 3;
  const float* la = lut_a + lane % LUT_COPIES;
  // Eq. 5 as encode, then the output table's decode(code): the same value
  // as s2fp8::truncate at half its transcendentals
  float oa = 1.0f, ob = 0.0f;
  if (epilogue) {
    oa = o_ab[0];
    ob = o_ab[1];
  }
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
#pragma unroll 1
  for (int t = 0, tl = 0, i = 0; t < T; ++t) {
    const int s = t % SPLIT_STAGES;
    mbar_wait(&full[s], (t / SPLIT_STAGES) & 1);
    const uint8_t* codes = split + s * G::STAGE_SPLIT + 2 * G::B_SPLIT;
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint2 x = *reinterpret_cast<const uint2*>(
          codes + a_code_off(ra, 2 * j));
      const uint2 y = *reinterpret_cast<const uint2*>(
          codes + a_code_off(ra + 8, 2 * j));
      const uint32_t c[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        tc::split(la[((c[v] >> (8 * tq)) & 0xffu) * LUT_COPIES], ah[j][v],
                  al[j][v]);
    }
    const uint32_t bh = smem_u32(split + s * G::STAGE_SPLIT);
    const uint32_t bl = bh + G::B_SPLIT;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      wgmma_tf32_rs(part, al[j], desc_sw128(bh + 32 * j), j > 0);
      wgmma_tf32_rs(part, ah[j], desc_sw128(bl + 32 * j), 1);
      wgmma_tf32_rs(part, ah[j], desc_sw128(bh + 32 * j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[s]);   // the stage is free
    fence_acc(part);
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] += part[v];
    if (++tl < TI) continue;

    // the item's last stage: epilogue, single write, fresh accumulator
    int gz, m0, n0;
    item(i, gz, m0, n0);
    float* Cg = C + static_cast<size_t>(gz) * M * N;
    const int row0 = m0 + ra, col0 = n0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        const int col = col0 + 8 * j;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (epilogue) {
          v0 = lut_o[s2fp8::encode(v0, oa, ob, fmt_o)];
          v1 = lut_o[s2fp8::encode(v1, oa, ob, fmt_o)];
        }
        float* c = Cg + static_cast<size_t>(row) * N + col;
        if (col + 1 < N && N % 2 == 0) {   // a lane quad writes 32 bytes
          *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
        } else {
          if (col < N) c[0] = v0;
          if (col + 1 < N) c[1] = v1;
        }
      }
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = 0.0f;
    tl = 0;
    ++i;
  }
}

// ---------------------------------------------------------------------------
// small-M path
// ---------------------------------------------------------------------------

constexpr int SMALL_ROWS = 8;     // rows of A a pass (M <= 16: one or two)
constexpr int SNN_THREADS = 128;  // 16 column lanes x 8 K lanes
constexpr int SNN_COLS = 256;     // 16 lanes x 16 columns
constexpr int SNT_THREADS = 256;  // 8 warps of 16 rows of B
constexpr int SNT_ROWS = 128;     // rows of B (output columns) a block
constexpr int SNT_CHUNK = 20;     // floats 16 K of A take in shared memory:
                                  // 8 chunks' float4 loads hit 8 bank groups
// copies of B's table, interleaved (lane l reads copy l % copies): NN's 32
// leave a warp's lookups free of bank conflicts; NT's 8 keep two blocks a
// SM beside A's rows
constexpr int SNN_COPIES = 32, SNT_COPIES = 8;

// `copies` interleaved copies of the table of (alpha, beta) = ab, through
// `stage` (256 floats).  Whole block; sync before use.
template <int COPIES>
__device__ __forceinline__ void fill_copies(float* lut, float* stage,
                                            const float* ab, int fmt) {
  s2fp8::fill_lut(stage, ab, fmt);
  __syncthreads();
  for (int i = threadIdx.x; i < 256 * COPIES; i += blockDim.x)
    lut[i] = stage[i / COPIES];
}

// The 16 codes of w decoded; `lut` is this lane's copy of the table.
template <int COPIES>
__device__ __forceinline__ void decode16(const uint4 w, const float* lut,
                                         float (&b)[16]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[4 * i + j] = lut[((v[i] >> (8 * j)) & 0xffu) * COPIES];
}

// A's rows mp .. mp + 7 (rows past M as zeros), K [kbeg, kbeg + 16 nch),
// dequantized into As: row m at m * stride floats, each 16 K at c * cstride
// (16 or SNT_CHUNK).  16-byte loads; the bytes past K in the last are the
// padding, code 0.
__device__ __forceinline__ void stage_rows(float* As, int stride, int cstride,
                                           const uint8_t* A, int lda, int mp,
                                           int mr, int kbeg, int nch,
                                           const float* lut) {
  for (int i = threadIdx.x; i < SMALL_ROWS * nch; i += blockDim.x) {
    const int m = i / nch, c = i - m * nch;
    float v[16];
    decode16<1>(m < mr ? __ldg(reinterpret_cast<const uint4*>(
                             A + static_cast<size_t>(mp + m) * lda + kbeg +
                             16 * c))
                       : make_uint4(0, 0, 0, 0),
                lut, v);
    float4* d = reinterpret_cast<float4*>(As + m * stride + c * cstride);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      d[f] = make_float4(v[4 * f], v[4 * f + 1], v[4 * f + 2], v[4 * f + 3]);
  }
}

// acc[m][j] += A[m][k] * deq(B[k][n0 + j]): `a` points at column k of A's
// staged rows (`stride` floats apart), w holds the 16 codes of B's row k.
__device__ __forceinline__ void nn_step(float (&acc)[SMALL_ROWS][16],
                                        const float* a, int stride,
                                        const float* lut, const uint4 w) {
  float b[16];
  decode16<SNN_COPIES>(w, lut, b);
#pragma unroll
  for (int m = 0; m < SMALL_ROWS; ++m) {
    const float x = a[m * stride];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(x, b[j], acc[m][j]);
  }
}

// acc[m] += A[m][k .. k + 15] . deq(B[n][k .. k + 15]) in K order: `a`
// points at the chunk of A's staged rows (`stride` floats apart), w holds
// the chunk's 16 codes of B's row n.
__device__ __forceinline__ void nt_step(float (&acc)[SMALL_ROWS],
                                        const float* a, int stride,
                                        const float* lut, const uint4 w) {
  float b[16];
  decode16<SNT_COPIES>(w, lut, b);
#pragma unroll
  for (int m = 0; m < SMALL_ROWS; ++m) {
    const float4* ap = reinterpret_cast<const float4*>(a + m * stride);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float4 x = ap[f];
      acc[m] = fmaf(x.x, b[4 * f], acc[m]);
      acc[m] = fmaf(x.y, b[4 * f + 1], acc[m]);
      acc[m] = fmaf(x.z, b[4 * f + 2], acc[m]);
      acc[m] = fmaf(x.w, b[4 * f + 3], acc[m]);
    }
  }
}

// Output (row, n) of split s: the result itself when there is one split,
// else a partial for the finishing kernel.
__device__ __forceinline__ void put_out(float v, float* C, float* P, int row,
                                        int n, int M, int N, int s, int S,
                                        float oa, float ob, int epilogue,
                                        int fmt_o) {
  if (S == 1)
    C[static_cast<size_t>(row) * N + n] =
        epilogue ? s2fp8::truncate(v, oa, ob, fmt_o) : v;
  else
    P[(static_cast<size_t>(s) * M + row) * N + n] = v;
}

// NN, B [K, ldb]: thread (tx, ty) owns columns n0 + 16 tx .. + 15 and K
// rows ty, ty + 8, ... of split s; the 8 K lanes are summed through shared
// memory in lane order.
__global__ __launch_bounds__(SNN_THREADS) void gemm_small_nn_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
    float* __restrict__ C, float* __restrict__ P, int M, int N, int K,
    int lda, int ldb, int kchunk, const float* __restrict__ a_ab,
    const float* __restrict__ b_ab, const float* __restrict__ o_ab,
    int epilogue, int fmt_a, int fmt_b, int fmt_o) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [SMALL_ROWS][kchunk]
  float* red = As + SMALL_ROWS * kchunk;          // [8][SNN_COLS]
  __shared__ float lut_a[256], lut_b[256 * SNN_COPIES];
  s2fp8::fill_lut(lut_a, a_ab, fmt_a);
  fill_copies<SNN_COPIES>(lut_b, red, b_ab, fmt_b);
  const float* lb = lut_b + (threadIdx.x & 31) % SNN_COPIES;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int s = blockIdx.y, S = gridDim.y;
  const int kbeg = s * kchunk, kc = min(K - kbeg, kchunk);
  const int nb = blockIdx.x * SNN_COLS, n0 = nb + 16 * tx;
  const bool nok = n0 < N;
  const uint8_t* Bp = B + static_cast<size_t>(kbeg) * ldb + (nok ? n0 : 0);
  float oa = 1.0f, ob = 0.0f;
  if (epilogue) {
    oa = o_ab[0];
    ob = o_ab[1];
  }
  for (int mp = 0; mp < M; mp += SMALL_ROWS) {
    const int mr = min(SMALL_ROWS, M - mp);
    __syncthreads();   // tables filled; the last pass is done with As
    stage_rows(As, kchunk, 16, A, lda, mp, mr, kbeg, (kc + 15) >> 4, lut_a);
    __syncthreads();
    float acc[SMALL_ROWS][16];
#pragma unroll
    for (int m = 0; m < SMALL_ROWS; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] = 0.0f;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    int k = ty;
#pragma unroll 1
    for (; k + 24 < kc; k += 32) {   // four rows' loads in flight
      uint4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = nok ? __ldg(reinterpret_cast<const uint4*>(
                         Bp + static_cast<size_t>(k + 8 * u) * ldb))
                   : zero;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        nn_step(acc, As + k + 8 * u, kchunk, lb, w[u]);
    }
#pragma unroll 1
    for (; k < kc; k += 8)
      nn_step(acc, As + k, kchunk, lb,
              nok ? __ldg(reinterpret_cast<const uint4*>(
                        Bp + static_cast<size_t>(k) * ldb))
                  : zero);
#pragma unroll
    for (int m = 0; m < SMALL_ROWS; ++m) {
      if (m >= mr) break;   // uniform over the block
      float4* r4 = reinterpret_cast<float4*>(red + ty * SNN_COLS + 16 * tx);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        r4[f] = make_float4(acc[m][4 * f], acc[m][4 * f + 1],
                            acc[m][4 * f + 2], acc[m][4 * f + 3]);
      __syncthreads();
      for (int c = threadIdx.x; c < SNN_COLS; c += SNN_THREADS) {
        float v = 0.0f;
#pragma unroll
        for (int y = 0; y < 8; ++y) v += red[y * SNN_COLS + c];
        if (nb + c < N)
          put_out(v, C, P, mp + m, nb + c, M, N, s, S, oa, ob, epilogue,
                  fmt_o);
      }
      __syncthreads();
    }
  }
}

// NT, B [N, ldb]: each warp takes 16 rows of B, 4 at a time; lane 8r + c
// reads 16-byte chunks c, c + 8, ... of row r, and the 8 chunk lanes of a
// row are summed by shuffles in a fixed order.  The block's outputs meet
// in shared memory and leave in coalesced rows.
__global__ __launch_bounds__(SNT_THREADS) void gemm_small_nt_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
    float* __restrict__ C, float* __restrict__ P, int M, int N, int K,
    int lda, int ldb, int kchunk, const float* __restrict__ a_ab,
    const float* __restrict__ b_ab, const float* __restrict__ o_ab,
    int epilogue, int fmt_a, int fmt_b, int fmt_o) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [SMALL_ROWS][chunks][20]
  __shared__ float lut_a[256], lut_b[256 * SNT_COPIES];
  __shared__ float res[SMALL_ROWS][SNT_ROWS];
  s2fp8::fill_lut(lut_a, a_ab, fmt_a);
  fill_copies<SNT_COPIES>(lut_b, &res[0][0], b_ab, fmt_b);
  const float* lb = lut_b + (threadIdx.x & 31) % SNT_COPIES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kl = lane & 7, rl = lane >> 3;
  const int s = blockIdx.y, S = gridDim.y;
  const int kbeg = s * kchunk, kc = min(K - kbeg, kchunk);
  const int nch = (kc + 15) >> 4, stride = (kchunk >> 4) * SNT_CHUNK;
  const int nb = blockIdx.x * SNT_ROWS;
  float oa = 1.0f, ob = 0.0f;
  if (epilogue) {
    oa = o_ab[0];
    ob = o_ab[1];
  }
  for (int mp = 0; mp < M; mp += SMALL_ROWS) {
    const int mr = min(SMALL_ROWS, M - mp);
    __syncthreads();   // tables filled; the last pass is done with As, res
    stage_rows(As, stride, SNT_CHUNK, A, lda, mp, mr, kbeg, nch, lut_a);
    __syncthreads();
#pragma unroll 1
    for (int it = 0; it < 4; ++it) {
      const int r = 16 * warp + 4 * it + rl;
      const bool nok = nb + r < N;
      const uint8_t* Bp =
          B + static_cast<size_t>(nok ? nb + r : 0) * ldb + kbeg;
      float acc[SMALL_ROWS];
#pragma unroll
      for (int m = 0; m < SMALL_ROWS; ++m) acc[m] = 0.0f;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      int c = kl;
#pragma unroll 1
      for (; c + 24 < nch; c += 32) {   // four chunks' loads in flight
        uint4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = nok ? __ldg(reinterpret_cast<const uint4*>(
                           Bp + 16 * (c + 8 * u)))
                     : zero;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          nt_step(acc, As + (c + 8 * u) * SNT_CHUNK, stride, lb, w[u]);
      }
#pragma unroll 1
      for (; c < nch; c += 8)
        nt_step(acc, As + c * SNT_CHUNK, stride, lb,
                nok ? __ldg(reinterpret_cast<const uint4*>(Bp + 16 * c))
                    : zero);
#pragma unroll
      for (int m = 0; m < SMALL_ROWS; ++m) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
        if (kl == 0) res[m][r] = acc[m];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < mr * SNT_ROWS; i += SNT_THREADS) {
      const int m = i / SNT_ROWS, r = i - m * SNT_ROWS;
      if (nb + r < N)
        put_out(res[m][r], C, P, mp + m, nb + r, M, N, s, S, oa, ob,
                epilogue, fmt_o);
    }
  }
}

// C = sum over the S partials in index order, then the epilogue.
__global__ void splitk_finish_kernel(const float* __restrict__ P,
                                     float* __restrict__ C, int S,
                                     long long mn,
                                     const float* __restrict__ o_ab,
                                     int epilogue, int fmt_o) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= mn) return;
  float v = 0.0f;
  for (int s = 0; s < S; ++s) v += P[s * mn + i];
  if (epilogue) v = s2fp8::truncate(v, o_ab[0], o_ab[1], fmt_o);
  C[i] = v;
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------

struct Args {
  const uint8_t *a, *b;
  float* c;
  int m, n, k, lda, ldb, ga, gb, go, groups;
  const float *a_ab, *b_ab, *o_ab;
  int epilogue, fmt_a, fmt_b, fmt_o;
  cudaStream_t st;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// One block a SM (shared memory allows no more), each walking its items.
int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

template <int LAYOUT, int WGS, bool BATCHED>
int launch_large(const Args& x) {
  using G = Large<WGS>;
  auto kernel = gemm_large_kernel<LAYOUT, WGS, BATCHED>;
  static const cudaError_t attr = allow_smem(kernel, G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long items = static_cast<long long>((x.n + BN - 1) / BN) *
                          ((x.m + G::BM - 1) / G::BM) * x.go;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(std::min<long long>(items, sm_count()));
  kernel<<<grid, G::THREADS, G::SMEM, x.st>>>(
      x.a, x.b, x.c, x.m, x.n, x.k, x.lda, x.ldb, x.ga, x.gb, x.go, x.groups,
      x.a_ab, x.b_ab, x.o_ab, x.epilogue, x.fmt_a, x.fmt_b, x.fmt_o);
  return static_cast<int>(cudaGetLastError());
}

template <bool BATCHED>
int dispatch_large(const Args& x, int layout, int bm) {
  const bool wide = bm == 128;
  switch (layout) {
    case kNN:
      return wide ? launch_large<kNN, 2, BATCHED>(x)
                  : launch_large<kNN, 1, BATCHED>(x);
    case kNT:
      return wide ? launch_large<kNT, 2, BATCHED>(x)
                  : launch_large<kNT, 1, BATCHED>(x);
    case kTN:
      return wide ? launch_large<kTN, 2, BATCHED>(x)
                  : launch_large<kTN, 1, BATCHED>(x);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_small(const Args& x, float* partials, int layout, int splits,
                 int kchunk) {
  if (kchunk % 16 || (splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = splits > 1 ? partials : nullptr;
  if (layout == kNN) {
    const int smem = (SMALL_ROWS * kchunk + 8 * SNN_COLS) * 4;
    static const cudaError_t attr = allow_smem(gemm_small_nn_kernel, 160 << 10);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((x.n + SNN_COLS - 1) / SNN_COLS, splits);
    gemm_small_nn_kernel<<<grid, SNN_THREADS, smem, x.st>>>(
        x.a, x.b, x.c, p, x.m, x.n, x.k, x.lda, x.ldb, kchunk, x.a_ab,
        x.b_ab, x.o_ab, x.epilogue, x.fmt_a, x.fmt_b, x.fmt_o);
  } else if (layout == kNT) {
    const int smem = SMALL_ROWS * (kchunk / 16) * SNT_CHUNK * 4;
    static const cudaError_t attr = allow_smem(gemm_small_nt_kernel, 160 << 10);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((x.n + SNT_ROWS - 1) / SNT_ROWS, splits);
    gemm_small_nt_kernel<<<grid, SNT_THREADS, smem, x.st>>>(
        x.a, x.b, x.c, p, x.m, x.n, x.k, x.lda, x.ldb, kchunk, x.a_ab,
        x.b_ab, x.o_ab, x.epilogue, x.fmt_a, x.fmt_b, x.fmt_o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long mn = static_cast<long long>(x.m) * x.n;
  splitk_finish_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                         x.st>>>(partials, x.c, splits, mn, x.o_ab,
                                 x.epilogue, x.fmt_o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout: 0 nn, 1 nt, 2 tn; (m, n, k) are the logical GEMM's dimensions;
// lda / ldb the stored operands' row strides in bytes.  path 0: the large-M
// kernel with bm = 64 or 128 rows a block; path 1: the small-M kernels
// (nn and nt) with K split `splits` ways of `kchunk` (a multiple of 16)
// each, and `scratch` an f32 [splits, m, n] tensor when splits > 1.
extern "C" int s2fp8_qmatmul(const void* a, const void* b, void* c,
                             void* scratch, int m, int n, int k, int lda,
                             int ldb, int layout, int path, int bm,
                             int splits, int kchunk, const void* a_ab,
                             const void* b_ab, const void* o_ab, int epilogue,
                             int fmt_a, int fmt_b, int fmt_o, void* stream) {
  const Args x{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
               static_cast<float*>(c), m, n, k, lda, ldb, 1, 1, 1, 1,
               static_cast<const float*>(a_ab), static_cast<const float*>(b_ab),
               static_cast<const float*>(o_ab), epilogue, fmt_a, fmt_b, fmt_o,
               static_cast<cudaStream_t>(stream)};
  if (path == 1)
    return launch_small(x, static_cast<float*>(scratch), layout, splits,
                        kchunk);
  return dispatch_large<false>(x, layout, bm);
}

// Batched (large-M kernel): a holds ga slices, b gb slices, c go slices of
// the per-slice (m, n, k) GEMM; groups = max(ga, gb) / go reduction groups
// per output slice.  The caller checks that ga, gb and go divide
// max(ga, gb).
extern "C" int s2fp8_qmatmul_batched(
    const void* a, const void* b, void* c, int m, int n, int k, int lda,
    int ldb, int ga, int gb, int go, int groups, int layout, int bm,
    const void* a_ab, const void* b_ab, const void* o_ab, int epilogue,
    int fmt_a, int fmt_b, int fmt_o, void* stream) {
  const Args x{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
               static_cast<float*>(c), m, n, k, lda, ldb, ga, gb, go, groups,
               static_cast<const float*>(a_ab), static_cast<const float*>(b_ab),
               static_cast<const float*>(o_ab), epilogue, fmt_a, fmt_b, fmt_o,
               static_cast<cudaStream_t>(stream)};
  return dispatch_large<true>(x, layout, bm);
}
