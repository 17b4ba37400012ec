"""Times the S2FP8 quantize, truncate, stats and dequantize kernels, the
paged decode and the selective scan of one source tree, so that two trees
can be compared on one card in one run.

    python3 tools/pair_quant_kernels.py --src OTHER_TREE/src --label parent
    python3 tools/pair_quant_kernels.py --src src --label change
    python3 tools/pair_quant_kernels.py --src src --label change \
        --only selective_scan,dequant

Imports ``repro_torch`` from ``--src`` (its kernels are built into that
tree's ``build/``) and times each wrapper with chip_smoke.py's harnesses at
the shapes chip_smoke.py phase 3 checks: device ms with the L2 flushed
before each call (torch.profiler, ``device_ms(cold=True)``) and CUDA-event
ms per call (host gaps included).  For a paired comparison run the trees
as A, B, B, A in one command.  Needs a CUDA card; prints one line per
shape and, last, one JSON object {"label": ..., "rows": [...]}.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its timing harnesses)

SHAPES = {
    "quant_apply": [((8 * 1024, 2304), torch.bfloat16),
                    ((2304, 5760), torch.bfloat16),
                    ((122753, 2304), torch.bfloat16)],
    "truncate_apply": [((8 * 36 * 1024, 64), torch.bfloat16),
                       ((122753, 2304), torch.float32)],
    # (slots, KV heads, head dim, block, blocks a slot) and the positions:
    # serve's pool (phase 5) across the context and at the serve run's
    # first 8 prompts' 16th decode token (chip_smoke.serve_prompts)
    "paged_decode": [((8, 36, 64, 16, 64),
                      [0, 15, 16, 100, 511, 700, 1000, 1023]),
                     ((8, 36, 64, 16, 64),
                      [int(n) + 15
                       for n in chip_smoke.serve_prompts(122753)[2][:8]])],
    # the exact-stats path's tensors: (shape, dtype, scale); minicpm's
    # (phases 8-9: table, fig4 logits, bf16 activation, GEMM output), then
    # serve-mamba's (phase 10): a decode activation and the in_proj weight,
    # bf16 as the payload GEMM quantizes them
    "stats": [((122753, 2304), torch.float32, 0.05),
              ((2048, 122753), torch.float32, 3.0),
              ((2048, 2304), torch.bfloat16, 1.0),
              ((2048, 5760), torch.float32, 0.3),
              ((8, 4096), torch.bfloat16, 1.0),
              ((4096, 16384), torch.bfloat16, 0.02)],
    # the flash delta's e5m2 g / o payloads (core/qdot.py _flash_delta):
    # train's 4 x 36 heads x 512 x 64 and train-moe's 4 x 16 x 512 x 128
    "dequant": [((4 * 36 * 512, 64), "e5m2"), ((4 * 16 * 512, 128), "e5m2")],
    # (B, S, di, n): serve-mamba's three prefill buckets (8 slots)
    "selective_scan": [(8, 128, 8192, 16), (8, 256, 8192, 16),
                       (8, 512, 8192, 16)],
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", required=True)
    ap.add_argument("--only", default=",".join(SHAPES),
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if only - set(SHAPES):
        ap.error(f"unknown kernels {sorted(only - set(SHAPES))}")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import s2fp8
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels import s2fp8_quant as sq
    from repro_torch.kernels import selective_scan as ss

    def shapes(name):
        return SHAPES[name] if name in only else []

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def timed(name, shape, dtype, fn, nbytes, bound_ms=None):
        fn()
        row = {"kernel": name, "shape": list(shape),
               "dtype": str(dtype)[6:],
               "device_ms": chip_smoke.device_ms(fn, cold=True),
               "events_ms": chip_smoke.cuda_time(fn),
               "bound_ms": (bound_ms if bound_ms is not None else
                            chip_smoke.bound_ms(nbytes, 0)[0])}
        rows.append(row)
        print(f"{args.label} {name} {tuple(shape)} {row['dtype']}: device "
              f"{row['device_ms']:.4f} ms (L2 flushed), events "
              f"{row['events_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms",
              flush=True)

    def rnd(shape, dtype, scale):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(dtype)

    for shape, dtype in shapes("quant_apply"):
        x = rnd(shape, dtype, 0.05)
        ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX["e5m2"])
        timed("quant_apply", shape, dtype,
              lambda: sq.quant_apply(x, ab, "e5m2"),
              x.numel() * (x.element_size() + 1))
    for shape, dtype in shapes("truncate_apply"):
        x = rnd(shape, dtype, 0.05)
        ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX["e5m2"])
        timed("truncate_apply", shape, dtype,
              lambda: sq.truncate_apply(x, ab, "e5m2"),
              x.numel() * 2 * x.element_size())
    for shape, dtype, scale in shapes("stats"):
        x = rnd(shape, dtype, scale)
        n, elt = x.numel(), x.element_size()
        timed("stats", shape, dtype, lambda: sq.stats_partials(x),
              n * elt + 20)
        timed("quant", shape, dtype, lambda: sq.quant(x), n * (elt + 1) + 8)
        timed("truncate_fused", shape, dtype, lambda: sq.truncate_fused(x),
              2 * n * elt + 8)
        del x
    for (b, kvh, hd, blk, max_b), positions in shapes("paged_decode"):
        nb = b * max_b + 1
        q = rnd((b, kvh, 1, hd), torch.float32, 1.0)
        ab = torch.tensor([1.0, 0.0], device=dev)
        kp = sq.quant_apply(rnd((nb, kvh, blk, hd), torch.float32, 1.0), ab)
        vp = sq.quant_apply(rnd((nb, kvh, blk, hd), torch.float32, 1.0), ab)
        perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
        table = perm.reshape(b, max_b).to(torch.int32)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        live = sum(positions) + len(positions)
        timed("paged_decode", (b, kvh, hd, blk, live), torch.float8_e5m2,
              lambda: paged_attention.paged_decode_attention(
                  q, kp, vp, ab, ab, table, pos),
              2 * live * kvh * hd + 8 * b * kvh * hd + table.numel() * 4
              + b * 4)
    for shape, fmt in shapes("dequant"):
        x = rnd(shape, torch.float32, 0.05)
        ab = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
        p = sq.quant_apply(x, ab, fmt)
        del x
        timed("dequant", shape, p.dtype, lambda: sq.dequant(p, ab),
              p.numel() * 5 + 8)
        del p
    for b, s, di, n in shapes("selective_scan"):
        scan_args = chip_smoke.scan_inputs(dev, gen, b, s, di, n)
        timed("selective_scan", (b, s, di, n), torch.float32,
              lambda: ss.selective_scan(*scan_args), 0,
              bound_ms=chip_smoke.scan_bound_ms(b, s, di, n)[0])
        del scan_args
    print(json.dumps({"label": args.label,
                      "card": torch.cuda.get_device_name(0), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
