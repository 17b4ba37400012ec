"""Serving launcher of the port: the paged-payload engine (global
attention models: dense, attn, dense_first and moe blocks) and the
dense-cache engine (every attention model, gemma3_1b's sliding-window
``local`` blocks included, and the SSM models: falcon_mamba_7b's mamba1
blocks, zamba2_1p2b's mamba2 blocks beside its attention blocks).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \
        --requests 16 --slots 8 --max-len 1024            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \
        --reduced --device cpu --requests 4 --max-len 64  # plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek_moe_16b --reduced --device cpu --cache-fmt f32_e5m2 \
        --metrics jsonl:/tmp/ticks.jsonl      # MoE, comparator pool, sink
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon_mamba_7b --reduced --engine dense --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2_1p2b --reduced --engine dense --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_1b \
        --reduced --engine dense --device cpu --prompt-len 70 --max-len 128

Params are random from ``--seed`` (``api.init_params``).  The payload
engine serves from a frozen bank calibrated on the device from seeded
random prompts (serving/bank.py, prefill and decode probes) into the pool
``--cache-fmt`` (the payload formats e5m2 / e4m3, the grid-snapped f32
comparators f32_e5m2 / f32_e4m3, raw f32), and ``--metrics`` sends one
``serving_tick`` event a tick to a sink (``obs.sinks.make_sink``:
``jsonl:<path>``, ``csv:<path>``, ``console``); the dense engine uses
exact per-call stats, and its s2fp8 default is payload GEMMs on the
``cuda_fused`` engine (every stats reduction in a kernel).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core.policy import make_policy
from repro_torch.launch import api
from repro_torch.obs.sinks import make_sink
from repro_torch.serving import bank as sbank
from repro_torch.serving import paged_cache
from repro_torch.serving.engine import LMServer, PayloadLMServer, Request


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default="s2fp8",
                    choices=("s2fp8", "s2fp8_e4m3"))
    ap.add_argument("--engine", choices=("dense", "payload"),
                    default="payload")
    ap.add_argument("--backend", default=None,
                    choices=("auto", "plain", "cuda", "cuda_fused"),
                    help="numerics engine (default: cuda_fused for the "
                         "dense engine, auto for the payload engine)")
    ap.add_argument("--cache-fmt", default="e5m2",
                    choices=paged_cache.CACHE_FMTS)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--export-passes", "--calib-passes",
                    dest="export_passes", type=int, default=2,
                    help="stats-bank probe passes of the frozen bank's "
                         "calibration (payload engine); --calib-passes is "
                         "an alias")
    ap.add_argument("--metrics", default=None,
                    help="per-tick metrics sink spec (obs.sinks.make_sink)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.enc_dec:
        raise SystemExit("serve launcher covers decoder LMs; whisper uses "
                         "encdec.serve_prefill / serve_decode "
                         "(api.make_prefill_step / make_decode_step)")
    dense = args.engine == "dense"
    backend = args.backend or ("cuda_fused" if dense else "auto")
    pol = make_policy(args.policy, backend, "payload")
    print(f"[serve] {cfg.name}, engine {args.engine}, policy {pol.mode}, "
          f"numerics {pol.backend_obj.name}, gemm payload, on {dev}")
    params = api.init_params(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    if dense:
        server = LMServer(cfg, params, pol, slots=args.slots,
                          max_len=args.max_len)
        print(f"[serve] dense cache: {server.cache_bytes()/1e6:.2f} MB, "
              f"exact per-call stats")
    else:
        calib = torch.as_tensor(rng.integers(0, cfg.vocab, (2, min(
            args.prompt_len, 32)), dtype=np.int64), device=dev)
        print(f"[serve] calibrating frozen bank ({args.export_passes} "
              f"passes)...")
        bank = sbank.calibrate_serving_bank(params, cfg, pol, calib,
                                            passes=args.export_passes)
        sink = make_sink(args.metrics) if args.metrics else None
        server = PayloadLMServer(cfg, params, pol, bank=bank,
                                 slots=args.slots, max_len=args.max_len,
                                 block=args.block, cache_fmt=args.cache_fmt,
                                 sink=sink)
        pool_b, stats_b = server.cache_bytes()
        print(f"[serve] paged cache: {pool_b/1e6:.2f} MB pool + {stats_b} B "
              f"frozen stats ({args.cache_fmt}, block={args.block}, "
              f"{server.n_blocks} blocks)")
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    for r in reqs:
        server.submit(r)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = server.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in reqs)
    print(f"[serve] {args.requests} requests, {total} tokens, {ticks} ticks, "
          f"{dt:.2f}s ({total/dt:.1f} tok/s), {len(server.prefill_shapes)} "
          f"prefill shapes"
          + ("" if dense else f", {server.preemptions} preemptions"))
    for i, r in enumerate(reqs[:3]):
        print(f"  req{i}: {r.out[:8]}...")
    if not dense and server.sink is not None:
        server.sink.close()


if __name__ == "__main__":
    main()
