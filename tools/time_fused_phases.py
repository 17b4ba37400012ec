"""Where the time of the stats-then-encode kernels goes, phase by phase,
on one card, from ``%globaltimer`` / ``clock64`` stamps per block in a
copy of the fused kernel compiled here (the tree's sources stay without
stamps: the tool includes the tree's ``s2fp8_quant.cu`` and adds the
stamped copy beside it, so the copy shares every helper of the kernel it
times).  A ``__syncthreads()`` precedes each stamp, so a stamp is the
block's end of a phase.

    python3 tools/time_fused_phases.py --src build/parent/src
    python3 tools/time_fused_phases.py --src src

The tree's design is read from its source: the two-barrier fused truncate
of commit fec118b (phase 0, a barrier, block 0's sum, a second barrier,
the value table, the kept and the re-read elements), timed beside that
tree's quantize-with-stats as three launches (stats partials, the
one-block finish, quantize-apply) and the gaps between them; or the
one-barrier body that quantize-with-stats and the fused truncate share
(phase 0, the last block's sum before the one grid barrier, the value
table, the register, shared-memory and re-read rounds; the path of grids
over kSmallGrid blocks, which the shapes below take), both kernels
stamped.

Per shape (the exact-stats path's bf16 activation 2048 x 2304 and GEMM
output 2048 x 5760 f32), the L2 flushed before each call (128 MB zeroed),
20 calls each: when the last block reached each stamp, from the first
block's start (mean over calls), each phase's mean length in a block
(``clock64``, converted to ns by the block's own clock over its
globaltimer span), and the stamped and unstamped kernels' device ms.
Needs a CUDA card; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timing harnesses)

STAMPS = {
    "two-barrier": ("start", "phase 0 done (partial written)",
                    "barrier 1 released", "block 0's sum published",
                    "barrier 2 released", "value table filled",
                    "kept elements encoded", "re-read and edges done"),
    "one-barrier": ("start", "phase 0 done (block total)",
                    "partial in (the last block: stats published)",
                    "barrier released", "value table filled",
                    "register rounds encoded", "shared-memory rounds encoded",
                    "re-read and edges done")}

STAMP_HELPERS = r"""
namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int kStampCount = 8;

__device__ __forceinline__ void stamp(unsigned long long* st, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* p = st + (blockIdx.x * kStampCount + k) * 2;
    p[0] = global_ns();
    p[1] = clock64();
  }
}

}  // namespace

extern "C" int stamped_grid(long long n) {
  cudaError_t err;
  return stats_grid(n, &err);
}
"""

TWO_BARRIER = r"""

namespace {

// truncate_fused_kernel<T, F> with stamps; the body is the tree's.
template <typename T, int F>
__global__ void __launch_bounds__(s2fp8::kStatsThreads, kFusedBlocksPerSm)
    stamped_fused_kernel(const T* __restrict__ x, T* __restrict__ out,
                         long long n, StatsPartial* parts,
                         float* __restrict__ triplet, float* ab_out,
                         float target_max,
                         const CodeTable* __restrict__ table,
                         unsigned long long* st) {
  constexpr int V = kVec<T>, KV = kKeepVecs<T>;
  __shared__ StatsPartial smem[32];
  __shared__ CodeTable tab;
  __shared__ unsigned int lut[256];
  stamp(st, 0);
  s2fp8::load_code_table(tab, table);
  s2fp8::Kept<T> kept;
  StatsPartial p = s2fp8::stats_block_reduce(
      s2fp8::stats_thread_partial<T, true>(x, n, kept), smem);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = p;
    __threadfence();
  }
  stamp(st, 1);
  cooperative_groups::grid_group grid_sync = cooperative_groups::this_grid();
  grid_sync.sync();
  stamp(st, 2);
  if (blockIdx.x == 0) {
    StatsPartial t = s2fp8::stats_reduce_partials(parts, gridDim.x, smem);
    if (threadIdx.x == 0) {
      s2fp8::stats_finish(t, target_max, triplet, ab_out);
      __threadfence();
    }
  }
  stamp(st, 3);
  grid_sync.sync();
  stamp(st, 4);
  const float alpha = __ldcg(&ab_out[0]), beta = __ldcg(&ab_out[1]);
  fill_value_lut<T, F>(lut, alpha, beta);
  stamp(st, 5);
  const VecSplit<T> s(x, n);
  const uint4* xv = reinterpret_cast<const uint4*>(x + s.head);
  T* o = out + s.head;
  const bool aligned = reinterpret_cast<unsigned long long>(o) % 16 == 0;
  const long long grid = grid_threads(), g = thread_index();
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const long long j = g + k * grid;
    if (j >= s.nvec) break;
    unsigned int c[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      c[e] = s2fp8::encode_log<F>(s2fp8::vec_elem<T>(kept.v[k], e),
                                  kept.logs[k][e], alpha, beta, tab);
    store_truncated<T>(c, lut, o + j * V, aligned);
  }
  stamp(st, 6);
  const long long step = KV * grid;
  if (g + step < s.nvec) {
    for (long long j0 = g + (s.nvec - 1 - g) / step * step; j0 > g;
         j0 -= step)
      truncate_rounds<T, F>(xv, s.nvec, j0, grid, alpha, beta, tab, lut, o,
                            aligned);
  }
  if (g < s.edges()) {
    const long long i = s.edge_index(g);
    store_bits<T>(out, i, lut[s2fp8::encode_table<F>(
                              s2fp8::scalar_as_f32(x, i), alpha, beta, tab)]);
  }
  stamp(st, 7);
}

}  // namespace

extern "C" int stamped_run(const void* x, int x_dtype, void* out,
                           long long n, void* scratch, void* ticket,
                           void* triplet, void* ab, float target_max,
                           const void* table, void* stamps, int truncate,
                           void* stream) {
  if (!truncate) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  int grid = stats_grid(n, &err);
  if (grid == 0) return static_cast<int>(err);
  auto* parts = static_cast<StatsPartial*>(scratch);
  auto* tri = static_cast<float*>(triplet);
  auto* abp = static_cast<float*>(ab);
  auto* tab = static_cast<const CodeTable*>(table);
  auto* st = static_cast<unsigned long long*>(stamps);
  return static_cast<int>(with_kind(x_dtype, s2fp8::kE5M2, [&](auto kind) {
    using T = typename decltype(kind)::type;
    auto* xt = static_cast<const T*>(x);
    auto* ot = static_cast<T*>(out);
    void* args[] = {&xt, &ot, &n, &parts, &tri, &abp, &target_max, &tab,
                    &st};
    cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(
            stamped_fused_kernel<T, decltype(kind)::fmt>),
        dim3(grid), dim3(s2fp8::kStatsThreads), args, 0,
        static_cast<cudaStream_t>(stream));
    return e != cudaSuccess ? e : cudaGetLastError();
  }));
}
"""

ONE_BARRIER = r"""
namespace {

// fused_body<T, F, kTruncate> with stamps; the body is the tree's.
template <typename T, int F, bool kTruncate>
__global__ void __launch_bounds__(s2fp8::kStatsThreads, kFusedBlocksPerSm)
    stamped_kernel(const T* __restrict__ x,
                   typename Emit<T, kTruncate>::Out* out, long long n,
                   StatsPartial* parts, unsigned int* ticket,
                   float* __restrict__ triplet, float* __restrict__ ab_out,
                   float target_max, const CodeTable* __restrict__ table,
                   int smem_rounds, unsigned long long* st) {
  constexpr int V = kVec<T>, KV = s2fp8::kKeepVecs<T>;
  __shared__ StatsPartial smem[32];
  __shared__ CodeTable tab;
  __shared__ unsigned int lut[kTruncate ? 256 : 1];
  __shared__ float ab[2];
  extern __shared__ float4 keep_words[];
  stamp(st, 0);
  float* keep_logs = reinterpret_cast<float*>(keep_words);
  const SharedKeep sk{
      keep_logs,
      reinterpret_cast<unsigned char*>(keep_logs +
                                       smem_rounds * V * blockDim.x),
      smem_rounds};
  s2fp8::load_code_table(tab, table);
  s2fp8::Kept kept;
  StatsPartial p = s2fp8::stats_block_reduce(
      s2fp8::stats_thread_partial<T, kFusedStreamVecs, true>(x, n, kept, sk),
      smem);
  stamp(st, 1);
  reduce_last(p, parts, ticket, triplet, ab_out, target_max, smem);
  stamp(st, 2);
  cooperative_groups::this_grid().sync();
  if (threadIdx.x == 0) {
    ab[0] = __ldcg(&ab_out[0]);
    ab[1] = __ldcg(&ab_out[1]);
  }
  stamp(st, 3);
  const float alpha = ab[0], beta = ab[1];
  if constexpr (kTruncate) fill_value_lut<T, F>(lut, alpha, beta);
  stamp(st, 4);
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
  stamp(st, 5);
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
  stamp(st, 6);
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
  stamp(st, 7);
}

template <typename T, bool kTruncate>
cudaError_t stamped_launch(const void* x, int x_dtype, void* out, long long n,
                           void* scratch, void* ticket, void* triplet,
                           void* ab,
                           float target_max, const void* table, void* stamps,
                           cudaStream_t stream) {
  const FusedPlan* fp = nullptr;
  cudaError_t err = fused_plan(&fp);
  if (err != cudaSuccess) return err;
  int grid = stats_grid(n, &err);
  if (grid == 0) return err;
  int rounds = fused_rounds(x, x_dtype, n, grid, *fp);
  const void* fn =
      reinterpret_cast<const void*>(stamped_kernel<T, s2fp8::kE5M2, kTruncate>);
  if ((err = cudaFuncSetAttribute(
           fn, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(keep_bytes(x_dtype, fp->rounds[x_dtype])))) !=
          cudaSuccess)
    return err;
  auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<typename Emit<T, kTruncate>::Out*>(out);
  auto* parts = static_cast<StatsPartial*>(scratch);
  auto* tk = static_cast<unsigned int*>(ticket);
  auto* tri = static_cast<float*>(triplet);
  auto* abp = static_cast<float*>(ab);
  auto* tab = static_cast<const CodeTable*>(table);
  auto* st = static_cast<unsigned long long*>(stamps);
  void* args[] = {&xt,        &ot,  &n,      &parts, &tk, &tri,
                  &abp, &target_max, &tab, &rounds, &st};
  err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(s2fp8::kStatsThreads), args,
      static_cast<size_t>(keep_bytes(x_dtype, rounds)), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int stamped_run(const void* x, int x_dtype, void* out,
                           long long n, void* scratch, void* ticket,
                           void* triplet, void* ab, float target_max,
                           const void* table, void* stamps, int truncate,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == s2fp8::kF32)
    err = truncate ? stamped_launch<float, true>(x, x_dtype, out, n, scratch,
                                                 ticket, triplet, ab, target_max,
                                                 table, stamps, s)
                   : stamped_launch<float, false>(x, x_dtype, out, n, scratch,
                                                  ticket, triplet, ab,
                                                  target_max, table, stamps,
                                                  s);
  else
    err = truncate ? stamped_launch<__nv_bfloat16, true>(
                         x, x_dtype, out, n, scratch, ticket, triplet, ab,
                         target_max, table, stamps, s)
                   : stamped_launch<__nv_bfloat16, false>(
                         x, x_dtype, out, n, scratch, ticket, triplet, ab,
                         target_max, table, stamps, s);
  return static_cast<int>(err);
}
"""

SHAPES = [((2048, 2304), torch.bfloat16, 1.0),
          ((2048, 5760), torch.float32, 0.3)]
CALLS = 20


def build(csrc: Path, nvcc: str, design: str) -> ctypes.CDLL:
    out_dir = ROOT / "build" / "time_fused_phases" / design
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "stamped.cu"
    src.write_text('#include "s2fp8_quant.cu"\n' + STAMP_HELPERS + (
        TWO_BARRIER if design == "two-barrier" else ONE_BARRIER))
    lib = out_dir / "libstamped.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(csrc), "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    dll.stamped_run.argtypes = [P, I, P, LL, P, P, P, P, F, P, P, I, P]
    dll.stamped_grid.argtypes = [LL]
    for fn in (dll.stamped_run, dll.stamped_grid):
        fn.restype = ctypes.c_int
    return dll


def kernel_spans(fn, calls: int):
    """Per call, the (name, start us, duration us) of each kernel fn
    launches, the L2 flushed before each call (the flush left out)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 4, device="cuda")
    primer = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        primer.fill_(0)
        torch.cuda.synchronize()
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.loads(Path(f.name).read_text())["traceEvents"]
    kern = sorted((e for e in events if e.get("cat") == "kernel"),
                  key=lambda e: e["ts"])
    spans, cur = [], None
    for e in kern:
        name = e["name"]
        if "FillFunctor" in name:
            if "<float>" in name:           # the flush opens each call
                cur = []
                spans.append(cur)
            continue
        if cur is not None:
            cur.append((name, float(e["ts"]), float(e["dur"])))
    return spans


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the tree's src directory (holds repro_torch)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core import s2fp8
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import s2fp8_quant as sq

    csrc = src / "repro_torch" / "csrc"
    design = ("one-barrier" if "quant_fused_kernel" in
              (csrc / "s2fp8_quant.cu").read_text() else "two-barrier")
    stamps = STAMPS[design]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; {design} design", flush=True)
    dll = build(csrc, kbuild.nvcc_path(), design)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = sq.code_table(dev, "e5m2")
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 4, device=dev)
    report = {"card": smi, "design": design, "shapes": []}
    kinds = ([("truncate_fused", 1)] if design == "two-barrier"
             else [("quant", 0), ("truncate_fused", 1)])
    for shape, dtype, scale in SHAPES:
        x = (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
        n = x.numel()
        grid = dll.stamped_grid(n)
        scratch = torch.empty(24 * 4096, dtype=torch.uint8, device=dev)
        res = torch.empty(5, dtype=torch.float32, device=dev)
        # the one-barrier design's ticket (the two-barrier copy takes none)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        st = torch.zeros(grid * len(stamps) * 2, dtype=torch.int64,
                         device=dev)
        row = {"shape": list(shape), "dtype": str(dtype)[6:], "grid": grid}
        for name, trunc in kinds:
            out = torch.empty(x.shape, dtype=dtype if trunc else torch.uint8,
                              device=dev)

            def stamped():
                kbuild.check(dll.stamped_run(
                    x.data_ptr(), sq.DTYPE_ID[dtype], out.data_ptr(), n,
                    scratch.data_ptr(), ticket.data_ptr(), res[:3].data_ptr(),
                    res[3:].data_ptr(), s2fp8.FMT_TARGET_MAX["e5m2"],
                    table.data_ptr(), st.data_ptr(), trunc,
                    kbuild.stream_ptr(dev)), "stamped_run")

            def real():
                return (sq.truncate_fused(x) if trunc else sq.quant(x))[0]

            stamped()
            assert torch.equal(out.view(torch.uint8),
                               real().view(torch.uint8)), \
                f"the stamped {name} differs"
            reach = [[] for _ in stamps]
            length = [[] for _ in stamps]
            for _ in range(CALLS):
                flush.zero_()
                stamped()
                torch.cuda.synchronize()
                t = st.view(grid, len(stamps), 2).cpu().double()
                gt, clk = t[:, :, 0], t[:, :, 1]
                t0 = gt[:, 0].min()
                ns_per_clk = (gt[:, -1] - gt[:, 0]) / (clk[:, -1] - clk[:, 0])
                for k in range(len(stamps)):
                    reach[k].append(float(gt[:, k].max() - t0) / 1e3)
                    if k:
                        length[k].append(float(
                            ((clk[:, k] - clk[:, k - 1]) * ns_per_clk).mean())
                            / 1e3)
            r = {"device_ms": chip_smoke.device_ms(real, cold=True),
                 "stamped_device_ms": chip_smoke.device_ms(stamped,
                                                           cold=True),
                 "last_block_reaches_us": {
                     k: statistics.mean(v) for k, v in zip(stamps, reach)},
                 "phase_mean_us_in_a_block": {
                     k: statistics.mean(v) for k, v in
                     zip(stamps[1:], length[1:])}}
            row[name] = r
            print(f"{name} {tuple(shape)} {row['dtype']}: grid {grid}; "
                  f"device {r['device_ms']:.4f} ms, stamped "
                  f"{r['stamped_device_ms']:.4f} ms", flush=True)
            for k in stamps:
                print(f"  last block at '{k}': "
                      f"{r['last_block_reaches_us'][k]:.2f} us", flush=True)
            for k in stamps[1:]:
                print(f"  mean length of the phase ending at '{k}': "
                      f"{r['phase_mean_us_in_a_block'][k]:.2f} us",
                      flush=True)
        for name, fn in (("quant", lambda: sq.quant(x)),
                         ("stats", lambda: sq.stats_partials(x))):
            spans = kernel_spans(fn, CALLS)
            count = len(spans[0])
            spans = [c for c in spans if len(c) == count]
            names = [chip_smoke.kernel_function(k[0]) for k in spans[0]]
            durs = [statistics.mean(c[i][2] for c in spans)
                    for i in range(count)]
            gaps = [statistics.mean(c[i + 1][1] - (c[i][1] + c[i][2])
                                    for c in spans) for i in range(count - 1)]
            row[f"{name}_launches"] = {"kernels": names, "device_us": durs,
                                       "gap_us": gaps}
            print(f"{name} {tuple(shape)} {row['dtype']}: {len(spans)} calls "
                  f"of {count} launches; device us " + ", ".join(
                      f"{k} {d:.2f}" for k, d in zip(names, durs))
                  + "; gaps " + ", ".join(f"{g:.2f}" for g in gaps) + " us",
                  flush=True)
        report["shapes"].append(row)
        del x
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
