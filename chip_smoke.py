"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only kernels  # build + kernel-vs-plain checks

Phases, each fatal on failure:

1. device  — CUDA must be present; prints the card's name and power limit
             (nvidia-smi) and the software versions.
2. build   — compiles every CUDA kernel of the serving path from
             src/repro_torch/csrc (one nvcc per source, all at once).
3. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving path's shapes, with the tolerance stated
             beside each check, and times kernel, plain version and a
             library yardstick with CUDA events.
4. serve   — full-width minicpm_2b (40 layers, d=2304, vocab 122,753) from
             a seeded generator: calibrate the frozen bank, then serve 16
             requests through PayloadLMServer (8 slots, max_len 1024,
             block 16, e5m2 pool).  Every kernel must have launched during
             this phase and no plain version may have run.

Prints a ``kernels:`` JSON line and then, as the last line, the device
contract line.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12           # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12               # f32 outside the tensor cores

# TPU kernel each port replaces (src/repro/... file:line of the Pallas entry)
REPLACES = {
    "quant_apply": "src/repro/kernels/s2fp8_quant.py:176",
    "truncate_apply": "src/repro/kernels/s2fp8_quant.py:229",
    "qmatmul_nn": "src/repro/kernels/s2fp8_matmul.py:189",
    "qflash_fwd": "src/repro/kernels/flash_attention.py:287",
    "paged_decode": "src/repro/kernels/paged_attention.py:89",
}
SOURCES = {
    "quant_apply": "src/repro_torch/csrc/s2fp8_quant.cu",
    "truncate_apply": "src/repro_torch/csrc/s2fp8_quant.cu",
    "qmatmul_nn": "src/repro_torch/csrc/s2fp8_matmul.cu",
    "qflash_fwd": "src/repro_torch/csrc/flash_attention.cu",
    "paged_decode": "src/repro_torch/csrc/paged_attention.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def code_ordinal(payload: torch.Tensor) -> torch.Tensor:
    """Signed ordinal of 8-bit payload codes: neighbouring grid points
    differ by 1, so |ordinal difference| counts grid steps (flips)."""
    u = payload.view(torch.uint8).int()
    mag = u & 0x7F
    return torch.where(u >= 0x80, -mag, mag)


def ordinal(values: torch.Tensor, stats, fmt: str) -> torch.Tensor:
    """Ordinal of on-grid values (truncate / epilogue outputs), read back
    through the plain quantizer."""
    from repro_torch.core import s2fp8
    return code_ordinal(
        s2fp8.quantize(values.float(), stats=stats, fmt=fmt).payload)


def flips(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a - b).abs()
    return {"max_step": int(d.max().item()) if d.numel() else 0,
            "frac": float((d != 0).float().mean().item()) if d.numel() else 0.0}


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device() -> None:
    if not torch.cuda.is_available():
        log("FAIL device: torch.cuda.is_available() is False")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])         # name, power limit
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    # the plain versions' f32 products must be full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build(ptxas: bool) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.SOURCES, ptxas_verbose=ptxas)
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        if ptxas:
            lines = [l for l in text.splitlines()
                     if "registers" in l or "spill" in l or "smem" in l]
            log(f"ptxas {name}: " + " | ".join(l.strip() for l in lines))
    for name in build.SOURCES:
        build.load(name)
    log(f"build: {len(build.SOURCES)} libraries in {dt:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def phase_kernels(dev) -> dict:
    """Returns name -> {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}; raises on any disagreement."""
    from repro_torch.core import s2fp8
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     s2fp8_matmul, s2fp8_quant)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def record(name, err, ms, plain_ms, lib_ms, nbytes, flops, shape):
        """Keep the worst error over every shape checked, and the times and
        bound of the last shape (each list ends with a main-path shape)."""
        tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], float(err))
        row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(tb, tf),
                   bound_by="bytes" if tb >= tf else "operations",
                   shape=shape)
        log(f"time {name} [{shape}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
            f"{max(tb, tf):.4f} ms ({row['bound_by']})")

    # -- quant_apply / truncate_apply at the path's largest operands: a
    # prefill activation and the tied head weight (bf16, quantized per
    # call) for quantize; the prefill K cache (bf16) and the f32 embedding
    # table (truncated per call) for truncate.  Tolerance: payload codes of
    # kernel and plain version at most one grid step apart, in at most 1e-4
    # of the elements (the maps round each step alike; the allowance is for
    # the math library).
    quant_shapes = [((8 * 1024, 2304), torch.bfloat16),
                    ((122753, 2304), torch.bfloat16)]
    trunc_shapes = [((8 * 36 * 1024, 64), torch.bfloat16),
                    ((122753, 2304), torch.float32)]
    for fmt in ("e4m3", "e5m2"):
        for shape, dtype in quant_shapes:
            x = rnd(*shape, dtype=dtype, scale=0.05)
            ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
            pk = s2fp8_quant.quant_apply(x, ab, fmt)
            pp = s2fp8_quant.quant_apply_plain(x, ab, fmt)
            f = flips(code_ordinal(pk), code_ordinal(pp))
            log(f"quant_apply {fmt} {shape} {dtype}: flips {f}")
            assert f["max_step"] <= 1 and f["frac"] <= 1e-4, f
            dq = s2fp8.dequantize(s2fp8.S2FP8Tensor(pk, ab, fmt))
            dp = s2fp8.dequantize(s2fp8.S2FP8Tensor(pp, ab, fmt))
            record("quant_apply", (dq - dp).abs().max().item(),
                   cuda_time(lambda: s2fp8_quant.quant_apply(x, ab, fmt)),
                   cuda_time(lambda: s2fp8_quant.quant_apply_plain(
                       x, ab, fmt), iters=3), None,
                   x.numel() * (x.element_size() + 1), 0,
                   f"{fmt} {tuple(shape)} {dtype}")
            del x, pk, pp, dq, dp
        for shape, dtype in trunc_shapes:
            x = rnd(*shape, dtype=dtype, scale=0.05)
            ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
            tk = s2fp8_quant.truncate_apply(x, ab, fmt)
            tp = s2fp8_quant.truncate_apply_plain(x, ab, fmt)
            f = flips(ordinal(tk, ab, fmt), ordinal(tp, ab, fmt))
            log(f"truncate_apply {fmt} {shape} {dtype}: flips {f}")
            assert f["max_step"] <= 1 and f["frac"] <= 1e-4, f
            record("truncate_apply",
                   (tk.float() - tp.float()).abs().max().item(),
                   cuda_time(lambda: s2fp8_quant.truncate_apply(x, ab, fmt)),
                   cuda_time(lambda: s2fp8_quant.truncate_apply_plain(
                       x, ab, fmt), iters=3), None,
                   x.numel() * 2 * x.element_size(), 0,
                   f"{fmt} {tuple(shape)} {dtype}")
            del x, tk, tp

    # -- qmatmul_nn at decode (M = 8 slots) and prefill (M = 8 rows x
    # bucket 1024) widths, with minicpm's K/N.  Tolerance: without the
    # epilogue |kernel - plain| <= 1e-5 * (|A| @ |B|) + 1e-30 (f32
    # accumulation order); with it, output codes differ by at most one grid
    # step in at most 1e-3 of the elements.
    gemms = [(8, 2304, 5760), (8, 5760, 2304), (8 * 1024, 2304, 5760),
             (8 * 1024, 5760, 2304)]
    for m, k, n in gemms:
        a = rnd(m, k, dtype=torch.bfloat16)
        b = rnd(k, n, dtype=torch.bfloat16, scale=k ** -0.5)
        aab = s2fp8.compute_stats(a)
        bab = s2fp8.compute_stats(b)
        qa = s2fp8_quant.quant_apply(a, aab)
        qb = s2fp8_quant.quant_apply(b, bab)
        raw_k = s2fp8_matmul.qmatmul_nn(qa, aab, qb, bab)
        raw_p = s2fp8_matmul.qmatmul_plain(qa, aab, qb, bab)
        deq_a = s2fp8.dequantize(s2fp8.S2FP8Tensor(qa, aab))
        deq_b = s2fp8.dequantize(s2fp8.S2FP8Tensor(qb, bab))
        scale = deq_a.abs() @ deq_b.abs()
        err = (raw_k - raw_p).abs()
        assert bool((err <= 1e-5 * scale + 1e-30).all()), \
            f"qmatmul raw {m}x{k}x{n}: max err {err.max().item()}"
        oab = s2fp8.compute_stats(raw_p)
        ek = s2fp8_matmul.qmatmul_nn(qa, aab, qb, bab, oab)
        ep = s2fp8_matmul.qmatmul_plain(qa, aab, qb, bab, oab)
        f = flips(ordinal(ek, oab, "e5m2"), ordinal(ep, oab, "e5m2"))
        log(f"qmatmul_nn {m}x{k}x{n}: raw max err {err.max().item():.3e}, "
            f"epilogue flips {f}")
        assert f["max_step"] <= 1 and f["frac"] <= 1e-3, f
        record("qmatmul_nn", (ek - ep).abs().max().item(),
               cuda_time(lambda: s2fp8_matmul.qmatmul_nn(qa, aab, qb, bab,
                                                         oab)),
               cuda_time(lambda: s2fp8_matmul.qmatmul_plain(
                   qa, aab, qb, bab, oab), iters=3),
               cuda_time(lambda: torch.matmul(deq_a, deq_b)),
               m * k + k * n + 4 * m * n, 2.0 * m * k * n,
               f"M={m} K={k} N={n} epilogue")
        del a, b, qa, qb, raw_k, raw_p, deq_a, deq_b, scale, err, ek, ep

    # -- qflash_fwd: prefill attention at buckets P = 128 and 512 (8 rows x
    # 36 heads, head dim 64, causal), plus head dims 32 and 80.  Tolerance:
    # output codes differ by at most one grid step in at most 1% of the
    # elements (online-softmax blocking differs: 64 here, 512 in the
    # plain version), |lse| error <= 1e-4.
    cases = [(64, 200, 32), (64, 130, 80), (8 * 36, 128, 64),
             (8 * 36, 512, 64)]
    for bh, p, d in cases:
        qf, kf, vf = (rnd(bh, p, d) for _ in range(3))
        sts = [s2fp8.compute_stats(t) for t in (qf, kf, vf)]
        qq, qk, qv = (s2fp8_quant.quant_apply(t, s)
                      for t, s in zip((qf, kf, vf), sts))
        raw, _ = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts, g=1)
        oab = s2fp8.compute_stats(raw)
        ok, lk = flash_attention.qflash_fwd(qq, qk, qv, *sts, g=1,
                                            out_ab=oab)
        op, lp = flash_attention.qflash_fwd_plain(qq, qk, qv, *sts, g=1,
                                                  out_ab=oab)
        f = flips(ordinal(ok, oab, "e5m2"), ordinal(op, oab, "e5m2"))
        lerr = (lk - lp).abs().max().item()
        log(f"qflash_fwd bh={bh} P={p} d={d}: flips {f}, lse err {lerr:.2e}")
        assert f["max_step"] <= 1 and f["frac"] <= 1e-2 and lerr <= 1e-4, \
            (f, lerr)
        deq = [s2fp8.dequantize(s2fp8.S2FP8Tensor(t, s))
               for t, s in zip((qq, qk, qv), sts)]
        pairs = p * (p + 1) // 2
        record("qflash_fwd", (ok - op).abs().max().item(),
               cuda_time(lambda: flash_attention.qflash_fwd(
                   qq, qk, qv, *sts, g=1, out_ab=oab)),
               cuda_time(lambda: flash_attention.qflash_fwd_plain(
                   qq, qk, qv, *sts, g=1, out_ab=oab), iters=3),
               cuda_time(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             deq[0][None], deq[1][None], deq[2][None],
                             is_causal=True)),
               3 * bh * p * d + bh * p * d * 4 + bh * p * 4,
               4.0 * bh * pairs * d, f"BH={bh} P={p} d={d} causal")

    # -- paged_decode: 8 slots x 36 KV heads, head dim 64, block 16, 64
    # blocks per slot, positions across the whole context, both formats.
    # Tolerance: |kernel - plain| <= 1e-4 * |plain| + 1e-5 (f32 softmax
    # order; no truncation on this path).
    for fmt in ("e4m3", "e5m2"):
        b, kvh, g, hd, blk, max_b = 8, 36, 1, 64, 16, 64
        nb = b * max_b + 1
        q = rnd(b, kvh, g, hd)
        kf, vf = rnd(nb, kvh, blk, hd), rnd(nb, kvh, blk, hd)
        kab = s2fp8.compute_stats(kf, s2fp8.FMT_TARGET_MAX[fmt])
        vab = s2fp8.compute_stats(vf, s2fp8.FMT_TARGET_MAX[fmt])
        kp = s2fp8_quant.quant_apply(kf, kab, fmt)
        vp = s2fp8_quant.quant_apply(vf, vab, fmt)
        perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
        table = perm.reshape(b, max_b).to(torch.int32)
        pos = torch.tensor([0, 15, 16, 100, 511, 700, 1000, 1023],
                           dtype=torch.int32, device=dev)
        ok = paged_attention.paged_decode_attention(q, kp, vp, kab, vab,
                                                    table, pos, fmt)
        op = paged_attention.paged_decode_plain(q, kp, vp, kab, vab, table,
                                                pos, fmt)
        err = (ok - op).abs()
        log(f"paged_decode {fmt}: max err {err.max().item():.3e}")
        assert bool((err <= 1e-4 * op.abs() + 1e-5).all()), err.max().item()
        live = int((pos.long() + 1).sum().item())
        record("paged_decode", err.max().item(),
               cuda_time(lambda: paged_attention.paged_decode_attention(
                   q, kp, vp, kab, vab, table, pos, fmt)),
               cuda_time(lambda: paged_attention.paged_decode_plain(
                   q, kp, vp, kab, vab, table, pos, fmt), iters=3),
               None,
               2 * live * kvh * hd + 2 * b * kvh * g * hd * 4
               + table.numel() * 4 + b * 4,
               4.0 * live * kvh * g * hd,
               f"{fmt} B={b} KV={kvh} hd={hd} block={blk} live={live}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the same slice on the card, cuda engine vs plain engine (small)
# ---------------------------------------------------------------------------

def phase_small_reference(dev) -> None:
    """Reduced minicpm_2b (2 layers, d=128) served on the card twice, once
    through the kernels (cuda engine) and once through plain PyTorch
    (plain engine), from one seeded bank: the same greedy tokens, and at
    every prefill and decode step per-step logits of live rows within
    max |diff| <= 0.1, mean <= 0.02 (kernel and plain version differ only
    by f32 summation order, which flips a rare output code; the CPU tests
    bound the port against JAX the same way), and finite."""
    import numpy as np
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.serving.bank import calibrate_serving_bank
    from repro_torch.serving.engine import PayloadLMServer, Request

    cfg = get_reduced_config("minicpm_2b").replace(n_layers=2)
    params = tlm.init_lm(cfg, seed=1, device=dev)
    rng = np.random.default_rng(1)
    calib = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)), device=dev)
    bank = calibrate_serving_bank(params, cfg, make_policy("s2fp8", "plain"),
                                  calib, passes=2)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (5, 11, 30, 17)]
    runs = {}
    for engine in ("cuda", "plain"):
        srv = PayloadLMServer(cfg, params, make_policy("s2fp8", engine),
                              bank=bank, slots=4, max_len=64, block=8)
        steps = []
        prefill, decode = srv._prefill, srv._decode

        def p(params_, tokens, last, _s=steps, _f=prefill):
            out = _f(params_, tokens, last)
            live = (tokens != 0).any(dim=1)
            _s.append(out[0][live].float())
            return out

        def d(*args, _s=steps, _f=decode, _srv=srv):
            live = torch.tensor([r is not None for r in _srv.slot_req])
            out = _f(*args)
            _s.append(out[0][live.to(out[0].device)].float())
            return out

        srv._prefill, srv._decode = p, d
        reqs = [Request(prompt=x, max_new_tokens=6) for x in prompts]
        for r in reqs:
            srv.submit(r)
        srv.run_to_completion()
        runs[engine] = ([r.out for r in reqs], steps)
    (tk, sk), (tp, sp) = runs["cuda"], runs["plain"]
    same = sum(a == b for ra, rb in zip(tk, tp) for a, b in zip(ra, rb))
    log(f"small reference: tokens cuda {tk} plain {tp} "
        f"({same}/{sum(len(r) for r in tk)} equal)")
    assert tk == tp, "cuda and plain engines chose different tokens"
    assert len(sk) == len(sp), (len(sk), len(sp))
    for i in range(len(sk)):
        assert sk[i].shape == sp[i].shape, (i, sk[i].shape, sp[i].shape)
        dlt = (sk[i] - sp[i]).abs()
        assert bool(torch.isfinite(sk[i]).all())
        log(f"small reference step {i}: max {dlt.max().item():.4f} "
            f"mean {dlt.mean().item():.5f}")
        assert dlt.max().item() <= 0.1 and dlt.mean().item() <= 0.02


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def phase_serve(dev) -> dict:
    """Full-width minicpm_2b through the port's entry points: seeded
    params, calibrate_serving_bank, PayloadLMServer.  Returns the kernel
    launch counts of this phase and its metrics."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    from repro_torch.models import transformer as tlm
    from repro_torch.serving.bank import calibrate_serving_bank
    from repro_torch.serving.engine import PayloadLMServer, Request

    cfg = get_config("minicpm_2b")
    pol = make_policy("s2fp8")
    t0 = time.perf_counter()
    params = tlm.init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve: minicpm_2b {cfg.n_layers} layers, d={cfg.d_model}, "
        f"vocab {cfg.vocab}, {cfg.n_params() / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    calib = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), device=dev)
    prompt_lens = rng.integers(64, 701, 16)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, int(n),
                                        dtype=np.int32), max_new_tokens=32)
            for n in prompt_lens]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # the main path starts here
    t0 = time.perf_counter()
    bank = calibrate_serving_bank(params, cfg, pol, calib, passes=2)
    torch.cuda.synchronize()
    t_calib = time.perf_counter() - t0
    server = PayloadLMServer(cfg, params, pol, bank=bank, slots=8,
                             max_len=1024, block=16, cache_fmt="e5m2")
    timing = {"prefill": [], "decode": []}
    prefill, decode = server._prefill, server._decode

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = fn(*args)
            assert bool(torch.isfinite(out[0].float()).all()), kind
            torch.cuda.synchronize()
            timing[kind].append((time.perf_counter() - ts) * 1e3)
            return out
        return run

    server._prefill = timed("prefill", prefill)
    server._decode = timed("decode", decode)
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    ticks = server.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.counts()                     # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    pool_b, stats_b = server.cache_bytes()

    for r in reqs:
        assert len(r.out) == 32, ("request did not complete", len(r.out))
        assert all(0 <= t < cfg.vocab for t in r.out)
    for name, c in counts.items():
        assert c["launches"] > 0, f"kernel {name} never launched: {counts}"
        assert c["plain_calls"] == 0, f"plain {name} ran: {counts}"
    tokens = sum(len(r.out) for r in reqs)
    metrics = {
        "requests": len(reqs), "tokens": tokens, "ticks": ticks,
        "prompt_tokens": int(prompt_lens.sum()),
        "wall_s": wall, "tok_per_s": tokens / wall,
        "calibrate_s": t_calib,
        "prefill_calls": len(timing["prefill"]),
        "prefill_ms_mean": float(np.mean(timing["prefill"])),
        "prefill_ms_total": float(np.sum(timing["prefill"])),
        "decode_ticks": len(timing["decode"]),
        "decode_ms_median": float(np.median(timing["decode"])),
        "decode_ms_mean": float(np.mean(timing["decode"])),
        "prefill_shapes": sorted(server.prefill_shapes),
        "preemptions": server.preemptions,
        "max_memory_allocated_gb": peak / 1e9,
        "pool_bytes": pool_b, "pool_stats_bytes": stats_b,
    }
    log("serve metrics: " + json.dumps(metrics))
    log("serve launches: " + json.dumps(counts))
    for i, r in enumerate(reqs[:2]):
        log(f"  req{i} ({len(r.prompt)} prompt tokens): {r.out[:8]}...")
    return {"counts": counts, "metrics": metrics, "server": server}


def phase_profile(server) -> None:
    """Optional (--profile): device time by kernel and the device's idle
    share over two windows of the full-width server — one admission tick
    (8 prompts of 256 tokens: a prefill at bucket 256, then a decode) and
    five decode ticks — with torch.profiler (CPU + CUDA activities)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    for _ in range(8):
        server.submit(Request(prompt=rng.integers(
            0, server.cfg.vocab, 256, dtype=np.int32), max_new_tokens=12))

    def window(label, ticks):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                server.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CPU:
                continue        # host ops; their kernels are listed apart
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
            f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
        for ms, count, key in rows[:12]:
            log(f"  {ms:9.2f} ms  {count:7d}x  {key[:90]}")

    window("admission tick (prefill bucket 256 x 8 rows + decode)", 1)
    window("5 decode ticks", 5)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels",), default=None)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v register/smem reports")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, print torch.profiler device time "
                         "by kernel for one admission and five decode ticks")
    args = ap.parse_args()

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build(args.ptxas)
    rows = phase_kernels(dev)
    if args.only == "kernels":
        return 0
    phase_small_reference(dev)
    served = phase_serve(dev)
    if args.profile:
        phase_profile(served["server"])
    out = []
    for name, row in rows.items():
        out.append({"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": served["counts"][name]["launches"],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "shape": row["shape"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
