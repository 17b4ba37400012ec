"""Training launcher of the port: the decoder LM on synthetic Markov data,
and the encoder-decoder archs (``whisper_medium``, ``transformer_tiny``)
on the seq2seq reversal task with ``--seq`` as both lengths, as the
reference's launcher trains them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
        --steps 4 --batch 4 --seq 512 --stats-refresh-every 8   # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
        --reduced --device cpu --steps 3 --batch 2 --seq 32   # plain versions
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek_moe_16b --n-layers 4 --steps 4 --batch 4 --seq 512 \
        --stats-refresh-every 8      # full width, depth cut to 4 layers
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
        --backend cuda_fused --gemm-mode fig4 --steps 3 --batch 4 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
        --policy fp8_ls --loss-scale 100 --track-stats --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
        --batch 1 --seq 4096 --attn-impl flash --stats-refresh-every 8
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch transformer_tiny --reduced --device cpu --steps 2

Params are random from ``--seed``; AdamW (weight decay 0.01) on the
config's schedule (WSD for minicpm, else cosine) with a 5% warmup, as the
reference's launcher.  ``--stats-refresh-every k`` trains with the
StatsBank (refresh every k steps); 0 trains s2fp8 with exact per-call
stats.  ``--backend`` picks the numerics engine (``cuda_fused``: the
exact stats in the stats kernels) and ``--gemm-mode`` the s2fp8 GEMM path
(``payload``, or ``fig4``: the truncation chain around f32 products).
``--policy`` also takes the baselines ``bf16`` (bf16 operands, f32
products) and ``fp8_ls`` (raw e5m2 with the loss scaled by
``--loss-scale``, paper Eq. 6); ``--track-stats`` adds the last gradient
leaf's (mu, m, alpha, beta) to each step's line; ``--attn-impl`` picks the
attention of sequences above 2048 tokens (``naive``: chunked, ``flash``:
the flash path).  The header line prints the resolved mode, loss scale,
attention, engine and GEMM path, and whether f32 products may use TF32.  ``--n-layers N`` cuts the depth to the first N layers of the
config's pattern (widths unchanged) and says so.  Prints one JSON line per step: loss, the MoE aux loss (0
for an encoder-decoder), step ms, tokens/s (decoder tokens).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import backend as nbackend
from repro_torch.core import statsbank
from repro_torch.core.policy import GEMM_MODES, S2FP8_MODES, make_policy
from repro_torch.data import synthetic
from repro_torch.models import encdec
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers, schedules
from repro_torch.training.trainer import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to the pattern's first N layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default="s2fp8",
                    choices=("fp32", "bf16", "fp8", "fp8_ls", "s2fp8"))
    ap.add_argument("--loss-scale", type=float, default=100.0,
                    help="the loss scale of --policy fp8_ls (Eq. 6)")
    ap.add_argument("--track-stats", action="store_true",
                    help="report (mu, m, alpha, beta) of the last gradient "
                         "leaf each step")
    ap.add_argument("--attn-impl", default=None, choices=("naive", "flash"),
                    help="attention above 2048 tokens (default: the "
                         "config's)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto",) + tuple(nbackend.BACKENDS),
                    help="numerics engine: 'cuda' (kernels, torch stats "
                         "reductions), 'cuda_fused' (kernels, stats "
                         "kernels), 'plain'; 'auto' = cuda")
    ap.add_argument("--gemm-mode", default="auto", choices=GEMM_MODES,
                    help="s2fp8 GEMMs: 'payload' = qdot_train (payload "
                         "GEMM kernels), 'fig4' = truncation chain around "
                         "f32 products; 'auto' = payload on the kernel "
                         "engines, fig4 on plain (as the reference)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--stats-refresh-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.n_layers:
        cfg = cut_depth(cfg, args.n_layers)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    pol = make_policy(args.policy, args.backend, args.gemm_mode,
                      loss_scale=args.loss_scale)
    opt = optimizers.adamw(weight_decay=0.01)
    sched = schedules.make_schedule(
        cfg.schedule if cfg.schedule == "wsd" else "cosine", args.lr,
        total_steps=args.steps, warmup=max(args.steps // 20, 1))
    stats_cfg = (statsbank.StatsConfig(refresh_every=args.stats_refresh_every)
                 if args.stats_refresh_every > 0 else None)

    gen = torch.Generator().manual_seed(args.seed)
    if cfg.enc_dec:
        def loss_fn(params, batch, policy):
            return encdec.loss_fn(params, batch["enc_tokens"],
                                  batch["dec_tokens"], batch["dec_labels"],
                                  cfg, policy)

        def data(_step):
            return synthetic.seq2seq_batch(gen, args.batch, args.seq,
                                           args.seq, cfg.vocab, dev)

        params = encdec.init_encdec(cfg, seed=args.seed, device=dev)
    else:
        def loss_fn(params, batch, policy):
            return tlm.loss_fn(params, batch["tokens"], batch["labels"], cfg,
                               policy)

        chain = synthetic.markov_chain(args.seed, cfg.vocab)

        def data(_step):
            return synthetic.lm_batch(chain, gen, args.batch, args.seq, dev)

        params = tlm.init_lm(cfg, seed=args.seed, device=dev)
    opt_state = opt.init(params)
    step_fn = make_train_step(loss_fn, opt, sched, pol,
                              track_stats=args.track_stats, stats=stats_cfg)
    bank = None
    if stats_cfg is not None:
        bank = statsbank.init_bank(loss_fn, params, data(0), pol, stats_cfg)
    gemm = ("-" if pol.mode not in S2FP8_MODES
            else "payload" if pol.uses_payload_gemm else "fig4")
    print(f"[train] {cfg.name} {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_params() / 1e6:.1f} M params, policy {pol.mode}, "
          f"loss scale "
          f"{pol.loss_scale if pol.mode == 'fp8_ls' else 1.0}, attention "
          f"{cfg.attn_impl}, "
          f"backend {args.backend} -> {pol.backend_obj.name}, gemm {gemm}, "
          f"tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"bank {'off' if bank is None else f'{len(bank)} sites'}, on {dev}",
          flush=True)
    for s in range(args.steps):
        batch = data(s)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if bank is None:
            params, opt_state, m = step_fn(params, opt_state, batch, s)
        else:
            params, opt_state, bank, m = step_fn(params, opt_state, bank,
                                                 batch, s)
        loss = float(m["loss"])            # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        line = {"step": s, "loss": loss, "aux": float(m.get("aux", 0.0)),
                "step_ms": ms,
                "tokens_per_s": args.batch * args.seq / ms * 1e3}
        if args.track_stats:
            line["probe_stats"] = {k: float(v)
                                   for k, v in m["probe_stats"].items()}
        print(json.dumps(line), flush=True)


def cut_depth(cfg, n_layers: int):
    """``cfg`` with only the first ``n_layers`` layers of its pattern
    (``dataclasses.replace`` of ``n_layers`` and ``pattern``; no width
    changes), announced on stdout."""
    pattern = cfg.resolved_pattern[:n_layers]
    if len(pattern) != n_layers:
        raise ValueError(f"{cfg.name} has {cfg.n_layers} layers; cannot cut "
                         f"to {n_layers}")
    print(f"[depth cut] {cfg.name}: {cfg.n_layers} -> {n_layers} layers, "
          f"pattern {pattern}", flush=True)
    return dataclasses.replace(cfg, n_layers=n_layers, pattern=pattern)


if __name__ == "__main__":
    main()
