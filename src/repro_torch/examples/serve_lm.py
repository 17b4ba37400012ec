"""End-to-end serving demo: the dense-cache engine, then the paged payload
engine (port of ``examples/serve_lm.py``).

The dense engine (``LMServer``) takes any block pattern, here reduced
gemma3_1b's sliding-window mix; the payload engine (``PayloadLMServer``)
keeps K/V as S2FP8 payload blocks (1 byte an element) with (alpha, beta)
frozen by calibration, so decode runs no stats reduction.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.core.policy import make_policy
from repro_torch.launch import api
from repro_torch.serving import bank as sbank
from repro_torch.serving.engine import LMServer, PayloadLMServer, Request


def run(server, reqs, label) -> dict:
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    ticks = server.run_to_completion()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in reqs)
    print(f"[{label}] served {len(reqs)} requests / {tok} tokens in "
          f"{ticks} ticks, {dt:.2f}s ({tok / dt:.1f} tok/s)")
    for i, r in enumerate(reqs[:2]):
        print(f"  req{i}: {r.prompt[:4].tolist()}... -> {r.out}")
    return {"requests": len(reqs), "tokens": tok, "ticks": ticks,
            "outs": [list(r.out) for r in reqs]}


def make_reqs(cfg, n, seed=0, prompt_len=12, new_tokens=12):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab, prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=new_tokens) for _ in range(n)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # dense engine: any block pattern (gemma3's sliding-window mix)
    cfg = get_reduced_config("gemma3_1b").replace(remat=False)
    params = api.init_params(cfg, seed=0, device=dev)
    server = LMServer(cfg, params, make_policy("s2fp8"), slots=4,
                      max_len=96)
    out["dense"] = run(server, make_reqs(cfg, args.requests),
                       "dense/gemma3_1b")

    # payload engine: global attention; K/V as S2FP8 payload blocks with
    # (alpha, beta) frozen by calibration
    cfg = get_reduced_config("minicpm_2b").replace(n_layers=2, remat=False)
    pol = make_policy("s2fp8", gemm_mode="payload")
    params = api.init_params(cfg, seed=0, device=dev)
    calib = make_reqs(cfg, 4, seed=2)
    tokens = torch.as_tensor(np.stack([r.prompt for r in calib]),
                             dtype=torch.int64)
    bank = sbank.calibrate_serving_bank(params, cfg, pol, tokens, passes=1)
    server = PayloadLMServer(cfg, params, pol, bank=bank, slots=4,
                             max_len=96, block=16, cache_fmt="e5m2")
    pool_b, stats_b = server.cache_bytes()
    print(f"[payload] paged cache: {pool_b / 1e6:.2f} MB pool (1 B/elt) + "
          f"{stats_b} B frozen stats")
    out["payload"] = run(server, make_reqs(cfg, args.requests, seed=1),
                         "payload/minicpm_2b")
    return out


if __name__ == "__main__":
    main()
