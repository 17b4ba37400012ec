// Selective scan, forward and backward.  For each (batch row, channel) the
// n-state recurrence over the sequence,
//   h = h * exp(dt A) + (dt x) B,   y = h . C + D x,
// returning y [B, S, di] and the final state h [B, di, n].  Two variants:
//   * Mamba-1 (per channel): dt [B, S, di], A [di, n], D [di];
//   * Mamba-2 (per head, HEADS): di = nh x hd channels, dt [B, S, nh], A and
//     D [nh], one decay exp(dt A) a (row, step, head) shared by the head's
//     hd channels and n states.
// The forward replaces src/repro/kernels/selective_scan.py:
// selective_scan_pallas (_scan_kernel), which has the per-channel form; the
// per-head form is the reference's mamba2 scan (src/repro/models/blocks.py
// mamba2_apply, its lax.scan step and _ssd_chunked compute it).  The
// backward replaces no TPU kernel: the reference differentiates lax.scan.
//
// Bound on the card: x, dt and y stream once ([B, S, di] f32 each; dt
// [B, S, nh] per head), B and C once ([B, S, n]); the state never leaves
// the chip.  Per channel the exps (one a state and step) are no tighter
// bound: an exp2 runs on the SFUs or as a polynomial on the FMA pipes.  Per
// head there is one exp a head and step, 1/(hd n) of the per-channel
// count.  Instruction slots lie above the bytes: the state update is 14 a
// state and step with the accurate expf (5 without it), plus the step's
// loads, the shuffle tree and y.
//
// Forward design: the TPU kernel's grid walks (batch row, block of
// channels) and keeps a [bd, n] state slab in VMEM across a sequential loop
// over S.  Here each channel's states are split over LANES neighbouring
// lanes of a warp, SPL = 4 states (and, per channel, their 4 entries of A)
// in each lane's registers, and a block of 256 threads covers CHANNELS =
// 256 / LANES channels of one batch row (grid (ceil(di / CHANNELS), B)):
//   * n <= 16: LANES = 4, 64 channels a block (the n 16 of falcon-mamba);
//   * n <= 64: LANES = 16, 16 channels a block (the n 64 of zamba2).
// Four states a lane, and not 16 states on 4 lanes, so that a thread keeps
// the registers of the n <= 16 kernel (64, no spill at 4 blocks an SM) and
// the state update stays 4 long: the 16-lane shuffle tree costs 4 shuffles
// and adds a step against 20 operations of the update.  A wider lane
// count also keeps the grid at 512 blocks at zamba2's prefill (8 rows x
// 4,096 channels), one wave on 132 SMs at 4 blocks each.  Each lane sums
// its share of h.C in state order; the LANES shares are summed by
// __shfl_xor_sync over lane distance 1, 2, ... LANES / 2 (every lane ends
// with the same bits), and D x is added.  A state past n has a = 0 and b =
// c = 0: it stays 0 and adds 0, so no lane branches on n.  Chunks of
// TCHUNK timesteps are staged in shared memory with cp.async,
// double-buffered: chunk k + 1's x and dt (16 bytes a copy, coalesced along
// di) and its B_t and C_t (4 bytes a copy) are in flight while chunk k
// computes.  Per head, the chunk's dt is staged per head of the block and
// its decays exp(dt A) are taken once a (step, head) into shared memory
// after the chunk lands; every channel of the head reads them.  A lane
// reads its 4 B_t and 4 C_t as one 16-byte shared-memory load each; the
// chunk's y is gathered in shared memory (UNROLL steps at a time from
// registers, so no store sits between one step's loads and the next's)
// and stored as 16-byte vectors along di.  Ragged di and S not a multiple
// of TCHUNK are masked (the copies zero-fill, the stores skip); di % 4 != 0
// or a pointer off 16 bytes takes 4-byte copies and stores.  Shared memory
// is 24 KB a block at n <= 16 (28 KB per head); the registers (launch
// bounds: MINBLOCKS blocks an SM, 64 a thread) hold the SM at 4 blocks, 32
// warps (50%).  Blocks of 32 channels, other unrolls and 5 or 8 blocks an
// SM (8 spill) measured slower at n 16, chunks of 32 steps (at the 48 KB
// static shared-memory limit) under 2% faster.  With training, the forward
// also writes h at the start of every chunk ([B, chunks, di, n]), from
// which the backward replays one chunk at a time.
//
// The state update rounds each multiply and add on its own (__fmul_rn /
// __fadd_rn, no FMA contraction), as PyTorch's separate elementwise ops do,
// and exp is the accurate expf (no --use_fast_math), so h is the plain
// version's bit for bit but for the math library's exp.  No float atomics:
// two launches give the same bits.  The TPU kernel's VMEM sizing of its
// tiles does not carry over.
//
// Backward design (one block a (row, block of channels), the forward's
// geometry): the sequence is walked from the last chunk to the first.  For
// each chunk the block stages x, dt, dy, B and C (and the per-head decays),
// replays the chunk forward from its saved start state, keeping every step's
// h in shared memory ([TCHUNK][4][256] f32, 64 KB), then walks t down:
//   g_t = dy_t C_t + g_{t+1} exp(dt_{t+1} A)        (per channel and state)
//   dx_t = dt_t sum_j g_t B_t + D dy_t,  ddt_t = x_t sum_j g_t B_t
//          + sum_j g_t h_{t-1} exp(dt_t A) A,
//   dA += g_t h_{t-1} exp(dt_t A) dt_t,  dD += dy_t x_t,
//   dB_t = sum_c g_t dt_t x_t,  dC_t = sum_c dy_t h_t.
// Each step's h is read once as h_{t-1} and then overwritten with the
// step's dB term g_t dt_t x_t.  The sums across channels (dB and dC over
// the block's channels; per head, ddt over the head's channels; dA and dD
// over the block's channels and the sequence) are taken in channel order
// in the block, written as per-block partials, and summed over blocks and
// batch rows by a second kernel in index order: a fixed order that does not
// depend on the card's SM count, and no float atomics, so two launches give
// the same bits.  Shared memory is about 91 KB a block (2 blocks an SM).
// Bound: the same streams as the forward plus dy, dx and ddt, and the
// chunk states read once; a simple kernel, not tuned.
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace {

constexpr int SPL = 4;                    // states a lane
constexpr int THREADS = 256;
constexpr int TCHUNK = 16, MINBLOCKS = 4, UNROLL = 8;

template <int LANES>
struct Geo {
  static constexpr int NMAX = LANES * SPL;            // states a channel
  static constexpr int CHANNELS = THREADS / LANES;    // channels a block
  static constexpr int GROUPS = CHANNELS / 4;         // 4-channel vectors
};

template <int LANES, bool HEADS>
struct Stage {
  static constexpr int CH = Geo<LANES>::CHANNELS, NM = Geo<LANES>::NMAX;
  float x[2][TCHUNK][CH], dt[2][TCHUNK][CH];   // per head: dt[..][head slot]
  float b[2][TCHUNK][NM], c[2][TCHUNK][NM];
  float y[TCHUNK][CH];
  float da[HEADS ? TCHUNK : 1][CH];            // per head: the chunk's decays
};

// How many heads a block of channels [c0, c0 + CH) touches (per head).
__device__ __forceinline__ int heads_in_block(int c0, int ch, int di,
                                              int hd) {
  return (min(c0 + ch, di) - 1) / hd - c0 / hd + 1;
}

// Start chunk [t0, t0 + tn)'s copies into buffer `buf`: x as 4-channel
// vectors (or its 4 channels one by one), dt alike per channel or element
// by element per head, B and C element by element; out-of-range sources
// zero-fill.
template <int LANES, bool HEADS, bool VEC>
__device__ __forceinline__ void stage_chunk(
    Stage<LANES, HEADS>& sm, int buf, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, size_t row0, int t0, int tn, int c0, int di,
    int n, int nh, int h0, int nhb) {
  using G = Geo<LANES>;
  for (int v = threadIdx.x; v < TCHUNK * G::GROUPS; v += THREADS) {
    const int t = v / G::GROUPS, c = c0 + 4 * (v % G::GROUPS);
    const size_t off = (row0 + t0 + t) * di + c;
    float* dx = &sm.x[buf][t][c - c0];
    float* dd = &sm.dt[buf][t][c - c0];
    if (VEC) {
      const bool ok = t < tn && c < di;
      tc::cp_async<16>(dx, ok ? x + off : x, ok);
      if (!HEADS) tc::cp_async<16>(dd, ok ? dt + off : dt, ok);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = t < tn && c + k < di;
        tc::cp_async<4>(dx + k, ok ? x + off + k : x, ok);
        if (!HEADS) tc::cp_async<4>(dd + k, ok ? dt + off + k : dt, ok);
      }
    }
  }
  if (HEADS) {
    for (int e = threadIdx.x; e < TCHUNK * nhb; e += THREADS) {
      const int t = e / nhb, q = e % nhb;
      const bool ok = t < tn;
      tc::cp_async<4>(&sm.dt[buf][t][q],
                      ok ? dt + (row0 + t0 + t) * nh + h0 + q : dt, ok);
    }
  }
  for (int e = threadIdx.x; e < TCHUNK * G::NMAX; e += THREADS) {
    const int t = e / G::NMAX, j = e % G::NMAX;
    const bool ok = t < tn && j < n;
    const size_t off = (row0 + t0 + t) * n + j;
    tc::cp_async<4>(&sm.b[buf][t][j], ok ? bm + off : bm, ok);
    tc::cp_async<4>(&sm.c[buf][t][j], ok ? cm + off : cm, ok);
  }
}

// The LANES lanes of a channel sum their shares: distance 1, 2, ...
template <int LANES>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int LANES, bool HEADS, bool VEC, bool SAVE>
__global__ __launch_bounds__(THREADS, MINBLOCKS) void selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    float* __restrict__ y, float* __restrict__ hout,
    float* __restrict__ hchunk, int s, int di, int n, int hd) {
  using G = Geo<LANES>;
  constexpr int CH = G::CHANNELS;
  __shared__ __align__(16) Stage<LANES, HEADS> sm;

  const int lane = threadIdx.x % LANES, ch = threadIdx.x / LANES;
  const int b = blockIdx.y, c0 = blockIdx.x * CH;
  const int c = c0 + ch;
  const bool live = c < di;
  const size_t row0 = static_cast<size_t>(b) * s;
  const int nh = HEADS ? di / hd : 0, h0 = HEADS ? c0 / hd : 0;
  const int nhb = HEADS ? heads_in_block(c0, CH, di, hd) : 0;
  const int slot = HEADS && live ? c / hd - h0 : 0;

  // A missing state (lane * SPL + j >= n) has a = 0 here and b = c = 0
  // in shared memory (zero-filled): it stays 0 and adds 0 to y.
  float av[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int st = lane * SPL + j;
    av[j] = (!HEADS && live && st < n) ? a[static_cast<size_t>(c) * n + st]
                                        : 0.0f;
    h[j] = 0.0f;
  }
  const float dd = live ? dskip[HEADS ? c / hd : c] : 0.0f;

  const int chunks = (s + TCHUNK - 1) / TCHUNK;
  stage_chunk<LANES, HEADS, VEC>(sm, 0, x, dt, bm, cm, row0, 0,
                                 min(TCHUNK, s), c0, di, n, nh, h0, nhb);
  tc::cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1, t0 = k * TCHUNK, tn = min(TCHUNK, s - t0);
    if (SAVE && live) {   // the state at the chunk's start
      float* hrow = hchunk + ((static_cast<size_t>(b) * chunks + k) * di + c)
                                 * n + lane * SPL;
#pragma unroll
      for (int j = 0; j < SPL; ++j)
        if (lane * SPL + j < n) hrow[j] = h[j];
    }
    if (k + 1 < chunks)
      stage_chunk<LANES, HEADS, VEC>(sm, buf ^ 1, x, dt, bm, cm, row0,
                                     t0 + TCHUNK,
                                     min(TCHUNK, s - t0 - TCHUNK), c0, di, n,
                                     nh, h0, nhb);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();   // chunk k has landed (k + 1 may be in flight)
    __syncthreads();
    if (HEADS) {   // one exp a (step, head); the last chunk's are all read
      for (int e = threadIdx.x; e < TCHUNK * nhb; e += THREADS) {
        const int t = e / nhb, q = e % nhb;
        sm.da[t][q] = expf(__fmul_rn(sm.dt[buf][t][q], a[h0 + q]));
      }
      __syncthreads();
    }
    // one step's y: every lane of a channel ends with the same sum
    auto step = [&](int t) {
      const float xt = sm.x[buf][t][ch];
      const float dtt = HEADS ? sm.dt[buf][t][slot] : sm.dt[buf][t][ch];
      const float4 bq = *reinterpret_cast<const float4*>(
          &sm.b[buf][t][lane * SPL]);
      const float4 cq = *reinterpret_cast<const float4*>(
          &sm.c[buf][t][lane * SPL]);
      const float bv[SPL] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[SPL] = {cq.x, cq.y, cq.z, cq.w};
      const float dtx = __fmul_rn(dtt, xt);
      float acc;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const float da = HEADS ? sm.da[t][slot]
                               : expf(__fmul_rn(dtt, av[j]));
        h[j] = __fadd_rn(__fmul_rn(h[j], da), __fmul_rn(dtx, bv[j]));
        const float hc = __fmul_rn(h[j], cv[j]);
        acc = j == 0 ? hc : __fadd_rn(acc, hc);
      }
      acc = lane_sum<LANES>(acc);
      return __fadd_rn(acc, __fmul_rn(dd, xt));
    };
    // every lane stores its channel's y (the same value); a full chunk
    // keeps UNROLL steps' y in registers and stores them after the group,
    // so no shared-memory store sits between one step's loads and the next
    if (tn == TCHUNK) {
      for (int t = 0; t < TCHUNK; t += UNROLL) {
        float yv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) yv[u] = step(t + u);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) sm.y[t + u][ch] = yv[u];
      }
    } else {
      for (int t = 0; t < tn; ++t) sm.y[t][ch] = step(t);
    }
    __syncthreads();   // the chunk's y is gathered; its buffer is free
    for (int v = threadIdx.x; v < TCHUNK * G::GROUPS; v += THREADS) {
      const int t = v / G::GROUPS, cv0 = c0 + 4 * (v % G::GROUPS);
      if (t >= tn) break;
      float* dst = y + (row0 + t0 + t) * di + cv0;
      const float* src = &sm.y[t][cv0 - c0];
      if (VEC) {
        if (cv0 < di)
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (cv0 + q < di) dst[q] = src[q];
      }
    }
  }
  if (live) {
    float* hrow = hout + (static_cast<size_t>(b) * di + c) * n + lane * SPL;
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (lane * SPL + j < n) hrow[j] = h[j];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int LANES, bool HEADS>
struct BwdStage {
  static constexpr int CH = Geo<LANES>::CHANNELS, NM = Geo<LANES>::NMAX;
  float x[TCHUNK][CH], dt[TCHUNK][CH], dy[TCHUNK][CH];  // per head: dt slots
  float da[HEADS ? TCHUNK : 1][CH];
  float b[TCHUNK][NM], c[TCHUNK][NM];
  float dx[TCHUNK][CH], q[TCHUNK][CH];   // dx and ddt of each channel
  float red[2 * CH];                     // per head: each channel's dA, dD
  float hs[TCHUNK][SPL][THREADS];        // h_t, then the dB term g_t dt_t x_t
};

template <int LANES, bool HEADS>
__global__ __launch_bounds__(THREADS, 2) void selective_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* __restrict__ dy, const float* __restrict__ hchunk,
    float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ pdb, float* __restrict__ pdc,
    float* __restrict__ pda, float* __restrict__ pdd,
    float* __restrict__ pddt, int s, int di, int n, int hd, int nbatch) {
  using G = Geo<LANES>;
  constexpr int CH = G::CHANNELS, NM = G::NMAX;
  extern __shared__ __align__(16) unsigned char smraw[];
  auto& sm = *reinterpret_cast<BwdStage<LANES, HEADS>*>(smraw);

  const int tid = threadIdx.x, lane = tid % LANES, ch = tid / LANES;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int c0 = blk * CH, c = c0 + ch;
  const bool live = c < di;
  const size_t row0 = static_cast<size_t>(b) * s;
  const int nh = HEADS ? di / hd : 0, h0 = HEADS ? c0 / hd : 0;
  const int nhb = HEADS ? heads_in_block(c0, CH, di, hd) : 0;
  const int slot = HEADS && live ? c / hd - h0 : 0;
  // per head with hd > CH: a head spans bph blocks, this one its kin-th
  const int bph = HEADS && hd > CH ? hd / CH : 1;
  const int kin = HEADS && hd > CH ? (c0 % hd) / CH : 0;

  float av[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int st = lane * SPL + j;
    av[j] = (!HEADS && live && st < n) ? a[static_cast<size_t>(c) * n + st]
                                        : 0.0f;
  }
  const float ah = HEADS && live ? a[h0 + slot] : 0.0f;
  const float dd = live ? dskip[HEADS ? c / hd : c] : 0.0f;
  // g: g_{t+1} exp(dt_{t+1} A) carried down the sequence; dacc: dA of the
  // lane's states (per channel); dah, ddc: the channel's dA (per head,
  // lane 0) and dD terms
  float g[SPL], dacc[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) g[j] = dacc[j] = 0.0f;
  float dah = 0.0f, ddc = 0.0f;

  const int chunks = (s + TCHUNK - 1) / TCHUNK;
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * TCHUNK, tn = min(TCHUNK, s - t0);
    __syncthreads();   // the chunk after this one is done with the buffers
    for (int e = tid; e < TCHUNK * CH; e += THREADS) {
      const int t = e / CH, q = e % CH;
      const bool ok = t < tn && c0 + q < di;
      const size_t off = (row0 + t0 + t) * di + c0 + q;
      sm.x[t][q] = ok ? x[off] : 0.0f;
      sm.dy[t][q] = ok ? dy[off] : 0.0f;
      if (HEADS)
        sm.dt[t][q] = (t < tn && q < nhb)
                          ? dt[(row0 + t0 + t) * nh + h0 + q] : 0.0f;
      else
        sm.dt[t][q] = ok ? dt[off] : 0.0f;
    }
    for (int e = tid; e < TCHUNK * NM; e += THREADS) {
      const int t = e / NM, j = e % NM;
      const bool ok = t < tn && j < n;
      const size_t off = (row0 + t0 + t) * n + j;
      sm.b[t][j] = ok ? bm[off] : 0.0f;
      sm.c[t][j] = ok ? cm[off] : 0.0f;
    }
    __syncthreads();
    if (HEADS) {
      for (int e = tid; e < TCHUNK * nhb; e += THREADS) {
        const int t = e / nhb, q = e % nhb;
        sm.da[t][q] = expf(__fmul_rn(sm.dt[t][q], a[h0 + q]));
      }
      __syncthreads();
    }
    // replay the chunk from its saved start state, as the forward runs it
    float hst[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int st = lane * SPL + j;
      hst[j] = (live && st < n)
                   ? hchunk[((static_cast<size_t>(b) * chunks + k) * di + c)
                            * n + st]
                   : 0.0f;
    }
    {
      float h[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j) h[j] = hst[j];
      for (int t = 0; t < tn; ++t) {
        const float xt = sm.x[t][ch];
        const float dtt = HEADS ? sm.dt[t][slot] : sm.dt[t][ch];
        const float4 bq = *reinterpret_cast<const float4*>(
            &sm.b[t][lane * SPL]);
        const float bv[SPL] = {bq.x, bq.y, bq.z, bq.w};
        const float dtx = __fmul_rn(dtt, xt);
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const float da = HEADS ? sm.da[t][slot]
                                 : expf(__fmul_rn(dtt, av[j]));
          h[j] = __fadd_rn(__fmul_rn(h[j], da), __fmul_rn(dtx, bv[j]));
          sm.hs[t][j][tid] = h[j];
        }
      }
    }
    __syncthreads();
    // dC_t = sum over the block's channels of dy_t h_t, in channel order
    for (int e = tid; e < TCHUNK * NM; e += THREADS) {
      const int t = e / NM, st = e % NM;
      if (t >= tn || st >= n) continue;
      const int ln = st / SPL, j = st % SPL;
      float acc = __fmul_rn(sm.dy[t][0], sm.hs[t][j][ln]);
      for (int q = 1; q < CH; ++q)
        acc = __fadd_rn(acc, __fmul_rn(sm.dy[t][q], sm.hs[t][j][q * LANES + ln]));
      pdc[((row0 + t0 + t) * nblk + blk) * n + st] = acc;
    }
    __syncthreads();
    // the walk down the chunk
    for (int t = tn - 1; t >= 0; --t) {
      const float xt = sm.x[t][ch], dyt = sm.dy[t][ch];
      const float dtt = HEADS ? sm.dt[t][slot] : sm.dt[t][ch];
      const float4 bq = *reinterpret_cast<const float4*>(
          &sm.b[t][lane * SPL]);
      const float4 cq = *reinterpret_cast<const float4*>(
          &sm.c[t][lane * SPL]);
      const float bv[SPL] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[SPL] = {cq.x, cq.y, cq.z, cq.w};
      const float dtx = __fmul_rn(dtt, xt);
      float gb = 0.0f, qa = 0.0f;   // sum_j g B; sum_j g h_{t-1} (da A)
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const float hp = t > 0 ? sm.hs[t - 1][j][tid] : hst[j];
        const float gj = __fadd_rn(g[j], __fmul_rn(dyt, cv[j]));
        gb = __fadd_rn(gb, __fmul_rn(gj, bv[j]));
        float da;
        if (HEADS) {
          da = sm.da[t][slot];
          qa = __fadd_rn(qa, __fmul_rn(gj, hp));
        } else {
          da = expf(__fmul_rn(dtt, av[j]));
          const float gz = __fmul_rn(__fmul_rn(gj, hp), da);
          qa = __fadd_rn(qa, __fmul_rn(gz, av[j]));
          dacc[j] = __fadd_rn(dacc[j], __fmul_rn(gz, dtt));
        }
        sm.hs[t][j][tid] = __fmul_rn(gj, dtx);   // h_t is read: dB's term
        g[j] = __fmul_rn(gj, da);
      }
      gb = lane_sum<LANES>(gb);
      qa = lane_sum<LANES>(qa);
      float dtc;   // d loss / d dt of the channel
      if (HEADS) {
        const float gz = __fmul_rn(qa, sm.da[t][slot]);
        dtc = __fadd_rn(__fmul_rn(gb, xt), __fmul_rn(gz, ah));
        dah = __fadd_rn(dah, __fmul_rn(gz, dtt));
      } else {
        dtc = __fadd_rn(__fmul_rn(gb, xt), qa);
      }
      if (lane == 0) {
        sm.dx[t][ch] = __fadd_rn(__fmul_rn(gb, dtt), __fmul_rn(dd, dyt));
        sm.q[t][ch] = dtc;
        ddc = __fadd_rn(ddc, __fmul_rn(dyt, xt));
      }
    }
    __syncthreads();
    // dB_t = sum over the block's channels of g_t dt_t x_t, in order
    for (int e = tid; e < TCHUNK * NM; e += THREADS) {
      const int t = e / NM, st = e % NM;
      if (t >= tn || st >= n) continue;
      const int ln = st / SPL, j = st % SPL;
      float acc = sm.hs[t][j][ln];
      for (int q = 1; q < CH; ++q)
        acc = __fadd_rn(acc, sm.hs[t][j][q * LANES + ln]);
      pdb[((row0 + t0 + t) * nblk + blk) * n + st] = acc;
    }
    for (int e = tid; e < TCHUNK * CH; e += THREADS) {
      const int t = e / CH, q = e % CH;
      if (t >= tn || c0 + q >= di) continue;
      const size_t off = (row0 + t0 + t) * di + c0 + q;
      dx[off] = sm.dx[t][q];
      if (!HEADS) ddt[off] = sm.q[t][q];
    }
    if (HEADS) {   // ddt of each (step, head): its channels in order
      for (int e = tid; e < TCHUNK * nhb; e += THREADS) {
        const int t = e / nhb, hq = e % nhb;
        if (t >= tn) continue;
        const int head = h0 + hq;
        const int lo = max(c0, head * hd) - c0;
        const int hi = min(min(c0 + CH, (head + 1) * hd), di) - c0;
        float acc = sm.q[t][lo];
        for (int q = lo + 1; q < hi; ++q) acc = __fadd_rn(acc, sm.q[t][q]);
        pddt[((row0 + t0 + t) * nh + head) * bph + kin] = acc;
      }
    }
  }
  if (HEADS) {   // dA and dD of each head: the block's channels in order
    if (lane == 0) {
      sm.red[ch] = dah;
      sm.red[CH + ch] = ddc;
    }
    __syncthreads();
    if (tid < nhb) {
      const int head = h0 + tid;
      const int lo = max(c0, head * hd) - c0;
      const int hi = min(min(c0 + CH, (head + 1) * hd), di) - c0;
      float sa = sm.red[lo], sd = sm.red[CH + lo];
      for (int q = lo + 1; q < hi; ++q) {
        sa = __fadd_rn(sa, sm.red[q]);
        sd = __fadd_rn(sd, sm.red[CH + q]);
      }
      const size_t off = (static_cast<size_t>(head) * nbatch + b) * bph + kin;
      pda[off] = sa;
      pdd[off] = sd;
    }
  } else if (live) {
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (lane * SPL + j < n)
        pda[(static_cast<size_t>(b) * di + c) * n + lane * SPL + j] = dacc[j];
    if (lane == 0) pdd[static_cast<size_t>(b) * di + c] = ddc;
  }
}

// out[o * inner + i] = sum over k < kk, in order, of p[o so + i si + k sk]
__global__ void sum_partials_kernel(const float* __restrict__ p,
                                    float* __restrict__ out, long long total,
                                    int inner, int kk, long long so,
                                    long long si, long long sk) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= total) return;
  const long long o = idx / inner, i = idx % inner;
  const float* q = p + o * so + i * si;
  float acc = q[0];
  for (int k = 1; k < kk; ++k) acc = __fadd_rn(acc, q[k * sk]);
  out[idx] = acc;
}

cudaError_t sum_partials(const float* p, float* out, long long outer,
                         int inner, int kk, long long so, long long si,
                         long long sk, cudaStream_t stream) {
  const long long total = outer * inner;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  sum_partials_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      p, out, total, inner, kk, so, si, sk);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int LANES, bool HEADS>
cudaError_t launch_fwd(const float* x, const float* dt, const float* bm,
                       const float* cm, const float* a, const float* dskip,
                       float* y, float* hout, float* hchunk, int b, int s,
                       int di, int n, int hd, bool vec,
                       cudaStream_t stream) {
  dim3 grid((di + Geo<LANES>::CHANNELS - 1) / Geo<LANES>::CHANNELS, b);
  // training's forward saves the chunk states; serving's has no such store
  auto kernel =
      hchunk != nullptr
          ? (vec ? selective_scan_kernel<LANES, HEADS, true, true>
                 : selective_scan_kernel<LANES, HEADS, false, true>)
          : (vec ? selective_scan_kernel<LANES, HEADS, true, false>
                 : selective_scan_kernel<LANES, HEADS, false, false>);
  kernel<<<grid, THREADS, 0, stream>>>(x, dt, bm, cm, a, dskip, y, hout,
                                       hchunk, s, di, n, hd);
  return cudaGetLastError();
}

// The backward's scratch, in floats: the per-block partials of dB, dC, dA,
// dD and (per head) ddt, laid out as selective_scan_bwd reads them.
struct Scratch {
  long long db, dc, da, dd, ddt;
  long long total() const { return db + dc + da + dd + ddt; }
};

template <int LANES>
Scratch scratch_of(int b, int s, int di, int n, int nh) {
  constexpr int CH = Geo<LANES>::CHANNELS;
  const long long nblk = (di + CH - 1) / CH;
  Scratch r{};
  r.db = r.dc = static_cast<long long>(b) * s * nblk * n;
  if (nh == 0) {
    r.da = static_cast<long long>(b) * di * n;
    r.dd = static_cast<long long>(b) * di;
    r.ddt = 0;
  } else {
    const int hd = di / nh;
    const long long bph = hd > CH ? hd / CH : 1;
    r.da = r.dd = static_cast<long long>(nh) * b * bph;
    r.ddt = static_cast<long long>(b) * s * nh * bph;
  }
  return r;
}

template <int LANES, bool HEADS>
cudaError_t launch_bwd(const float* x, const float* dt, const float* bm,
                       const float* cm, const float* a, const float* dskip,
                       const float* dy, const float* hchunk, float* dx,
                       float* ddt, float* db, float* dc, float* da,
                       float* dd, float* scratch, int b, int s, int di, int n,
                       int nh, cudaStream_t stream) {
  constexpr int CH = Geo<LANES>::CHANNELS;
  const int hd = HEADS ? di / nh : 1;
  const int nblk = (di + CH - 1) / CH;
  const Scratch sz = scratch_of<LANES>(b, s, di, n, HEADS ? nh : 0);
  float* pdb = scratch;
  float* pdc = pdb + sz.db;
  float* pda = pdc + sz.dc;
  float* pdd = pda + sz.da;
  float* pddt = pdd + sz.dd;
  auto kernel = selective_scan_bwd_kernel<LANES, HEADS>;
  const int smem = static_cast<int>(sizeof(BwdStage<LANES, HEADS>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nblk, b), THREADS, smem, stream>>>(
      x, dt, bm, cm, a, dskip, dy, hchunk, dx, ddt, pdb, pdc, pda, pdd, pddt,
      s, di, n, hd, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long bs = static_cast<long long>(b) * s;
  // dB, dC [B, S, n]: the blocks of channels in order
  if ((err = sum_partials(pdb, db, bs, n, nblk, 1LL * nblk * n, 1, n,
                          stream)) != cudaSuccess)
    return err;
  if ((err = sum_partials(pdc, dc, bs, n, nblk, 1LL * nblk * n, 1, n,
                          stream)) != cudaSuccess)
    return err;
  if (!HEADS) {   // dA [di, n], dD [di]: the batch rows in order
    if ((err = sum_partials(pda, da, 1, di * n, b, 0, 1, 1LL * di * n,
                            stream)) != cudaSuccess)
      return err;
    return sum_partials(pdd, dd, 1, di, b, 0, 1, di, stream);
  }
  const int bph = hd > CH ? hd / CH : 1;
  // ddt [B, S, nh]: a head's blocks in order; dA, dD [nh]: batch rows,
  // then a head's blocks, in order
  if ((err = sum_partials(pddt, ddt, bs, nh, bph, 1LL * nh * bph, bph, 1,
                          stream)) != cudaSuccess)
    return err;
  if ((err = sum_partials(pda, da, 1, nh, b * bph, 0, 1LL * b * bph, 1,
                          stream)) != cudaSuccess)
    return err;
  return sum_partials(pdd, dd, 1, nh, b * bph, 0, 1LL * b * bph, 1, stream);
}

// The geometry and shape checks both entry points share: 1 <= n <= 64; per
// head (nh > 0) di a multiple of nh.
bool shapes_ok(int b, int s, int di, int n, int nh) {
  return n >= 1 && n <= Geo<16>::NMAX && b >= 1 && s >= 1 && di >= 1 &&
         nh >= 0 && (nh == 0 || di % nh == 0);
}

}  // namespace

// x, y [b, s, di]; bm, cm [b, s, n]; per channel (nh == 0) dt [b, s, di],
// a [di, n], dskip [di]; per head (nh > 0, head dim di / nh) dt [b, s, nh],
// a, dskip [nh]; hout [b, di, n]; hchunk (nullable) [b, ceil(s / 16), di,
// n], the state at the start of every 16-step chunk.  All f32,
// contiguous.  1 <= n <= 64.
extern "C" int selective_scan(const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a,
                              const void* dskip, void* y, void* hout,
                              void* hchunk, int b, int s, int di, int n,
                              int nh, void* stream) {
  if (!shapes_ok(b, s, di, n, nh))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = di % 4 == 0 && aligned16(x) && aligned16(y) &&
                   (nh > 0 || aligned16(dt));
  const int hd = nh > 0 ? di / nh : 1;
  using Fwd = cudaError_t (*)(const float*, const float*, const float*,
                              const float*, const float*, const float*,
                              float*, float*, float*, int, int, int, int, int,
                              bool, cudaStream_t);
  const Fwd fwd = n <= Geo<4>::NMAX
                      ? (nh > 0 ? &launch_fwd<4, true> : &launch_fwd<4, false>)
                      : (nh > 0 ? &launch_fwd<16, true>
                                : &launch_fwd<16, false>);
  return static_cast<int>(
      fwd(static_cast<const float*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(bm), static_cast<const float*>(cm),
          static_cast<const float*>(a), static_cast<const float*>(dskip),
          static_cast<float*>(y), static_cast<float*>(hout),
          static_cast<float*>(hchunk), b, s, di, n, hd, vec,
          static_cast<cudaStream_t>(stream)));
}

// Floats of scratch selective_scan_bwd needs (an int: the wrapper's shapes
// keep it below 2^31).
extern "C" int selective_scan_bwd_scratch(int b, int s, int di, int n,
                                          int nh) {
  if (!shapes_ok(b, s, di, n, nh)) return -1;
  const Scratch r = n <= Geo<4>::NMAX ? scratch_of<4>(b, s, di, n, nh)
                                      : scratch_of<16>(b, s, di, n, nh);
  return r.total() > 0x7fffffffLL ? -1 : static_cast<int>(r.total());
}

// The gradients of y = selective_scan(x, dt, bm, cm, a, dskip) for the
// cotangent dy [b, s, di]: dx [b, s, di], ddt (dt's shape), db, dc [b, s,
// n], da (a's shape), dd (dskip's shape), from the forward's hchunk.
// scratch: selective_scan_bwd_scratch(...) floats.  Per head the head dim
// di / nh must divide the block's channels (64 at n <= 16, 16 above) or be
// a multiple of them.
extern "C" int selective_scan_bwd(const void* x, const void* dt,
                                  const void* bm, const void* cm,
                                  const void* a, const void* dskip,
                                  const void* dy, const void* hchunk,
                                  void* dx, void* ddt, void* db, void* dc,
                                  void* da, void* dd, void* scratch, int b,
                                  int s, int di, int n, int nh,
                                  void* stream) {
  if (!shapes_ok(b, s, di, n, nh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ch = n <= Geo<4>::NMAX ? Geo<4>::CHANNELS : Geo<16>::CHANNELS;
  if (nh > 0) {
    const int hd = di / nh;
    if (hd % ch != 0 && ch % hd != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  using Bwd = cudaError_t (*)(const float*, const float*, const float*,
                              const float*, const float*, const float*,
                              const float*, const float*, float*, float*,
                              float*, float*, float*, float*, float*, int,
                              int, int, int, int, cudaStream_t);
  const Bwd bwd = n <= Geo<4>::NMAX
                      ? (nh > 0 ? &launch_bwd<4, true> : &launch_bwd<4, false>)
                      : (nh > 0 ? &launch_bwd<16, true>
                                : &launch_bwd<16, false>);
  return static_cast<int>(
      bwd(static_cast<const float*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(bm), static_cast<const float*>(cm),
          static_cast<const float*>(a), static_cast<const float*>(dskip),
          static_cast<const float*>(dy), static_cast<const float*>(hchunk),
          static_cast<float*>(dx), static_cast<float*>(ddt),
          static_cast<float*>(db), static_cast<float*>(dc),
          static_cast<float*>(da), static_cast<float*>(dd),
          static_cast<float*>(scratch), b, s, di, n, nh,
          static_cast<cudaStream_t>(stream)));
}
