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
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_1p2b \
        --steps 4 --batch 4 --seq 512 --stats-refresh-every 8  # mamba2 + attn
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch falcon_mamba_7b --n-layers 4 --steps 4 --batch 4 --seq 512 \
        --stats-refresh-every 8      # mamba1, full width, 4 of 64 layers
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
        --reduced --device cpu --steps 12 --batch 2 --seq 32 \
        --stats-refresh-every 4 --telemetry --snapshot-every 2 \
        --ckpt-dir /tmp/ck --ckpt-every 4 --resume auto \
        --chaos nan_grad@5x3,corrupt_ckpt@8    # the resilient loop
    torchrun --nproc_per_node 4 -m repro_torch.launch.train \
        --arch minicpm_2b --reduced --device cpu --steps 3 --batch 8 \
        --seq 32 --stats-refresh-every 2 --mesh host --grad-sync s2fp8 \
        --shard-params fsdp_q          # 4 gloo ranks on the CPU

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
attention, engine and GEMM path, and whether f32 products may use TF32.
``--n-layers N`` cuts the depth to the first N layers of the config's
pattern (widths unchanged) and says so.

The steps run in ``training.trainer.TrainLoop``, with the reference's
resilience flags and defaults: ``--ckpt-dir`` / ``--ckpt-every`` /
``--resume auto`` (checkpoints of params, AdamW state, bank and guard,
quarantine of corrupt ones), ``--stats-ema``, ``--telemetry`` (per-site
FP8 health in the bank, drained every refresh), ``--metrics-sink``
(``jsonl:<path>``, ``csv:<path>``, ``console``), ``--guard`` and its
thresholds, ``--snapshot-every`` / ``--snapshot-ring`` /
``--snapshot-compress`` (the rollback ring), ``--watchdog-escalate-after``
and ``--chaos <spec>`` (``training/chaos.py``; implies ``--guard``).
Batches are a function of ``--seed`` and the step, so a rollback replays
the same data.  Without ``--metrics-sink`` the console prints one JSON
line per step: loss, the MoE aux loss (0 for an encoder-decoder), step
ms, tokens/s (decoder tokens); events print as ``[event] ...`` lines.

The step is mesh-native unless ``--mesh none`` (the reference's flags
and defaults): ``--mesh host`` (the default: every rank of the process
group on the ``data`` axis; run alone, a 1-rank group), ``single`` /
``multi`` (the production 16 x 16 / 2 x 16 x 16), or a ``DxT`` /
``PxDxT`` spec; ``--grad-sync {f32,s2fp8}`` (the S2FP8-compressed legs
for leaves of at least ``--grad-sync-min-size`` elements);
``--shard-params {replicated,fsdp,fsdp_q}``.  Under ``torchrun`` each
rank is one process (NCCL on ``cuda``, gloo on ``cpu``); every rank
builds the same global batch and trains on its slice, and rank 0 prints
and writes checkpoints.  The header gains a mesh line.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import backend as nbackend
from repro_torch.core import statsbank
from repro_torch.core.policy import GEMM_MODES, S2FP8_MODES, make_policy
from repro_torch.data import synthetic
from repro_torch.launch import api
from repro_torch.launch import mesh as mesh_mod
from repro_torch.obs.sinks import ConsoleSink
from repro_torch.optim import optimizers, schedules
from repro_torch.parallel import sharding as shd
from repro_torch.training import chaos as chaos_mod
from repro_torch.training import guard as guard_mod
from repro_torch.training.trainer import (PARAM_SHARDING_MODES, TrainLoop,
                                          make_train_step)


class StepLines(ConsoleSink):
    """The launcher's console: one JSON line per ``train_step`` record
    (step, loss, aux, step ms, tokens/s, and probe stats when tracked);
    every other record as :class:`ConsoleSink` prints it."""

    def __init__(self, tokens_per_step: int, print_fn=print):
        super().__init__(print_fn)
        self.tokens = tokens_per_step

    def emit(self, record):
        if record.get("kind") != "train_step":
            return super().emit(record)
        line = {"step": record["step"], "loss": record["loss"],
                "aux": record.get("aux", 0.0), "step_ms": record["step_ms"],
                "tokens_per_s": self.tokens / record["step_ms"] * 1e3}
        if "probe_stats" in record:
            line["probe_stats"] = record["probe_stats"]
        self.print_fn(json.dumps(line))


def main(argv=None):
    """Parse ``argv``, build the run (:func:`build`), resume it when asked,
    train ``--steps`` steps and return the loop."""
    args = parse_args(argv)
    loop = build(args)
    if args.resume == "auto" and loop.ckpt is not None:
        loop.maybe_resume()
    history = loop.run(args.steps)
    loop.sink.close()
    if args.metrics_sink and history and loop.lead:
        print(f"[train] done: final loss {history[-1]['loss']:.4f}",
              flush=True)
    return loop


def parse_args(argv=None) -> argparse.Namespace:
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
                    choices=("auto",) + nbackend.available_backends(),
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--mesh", default="host",
                    help="'host' (every rank of the process group on the "
                         "data axis), 'single'/'multi' (production 16x16 / "
                         "2x16x16), a 'DxT' / 'PxDxT' spec (e.g. '4x1'), "
                         "or 'none' for the meshless step")
    ap.add_argument("--grad-sync", default="f32", choices=["f32", "s2fp8"],
                    help="cross-shard gradient sync under the mesh: plain "
                         "f32 all-reduce, or the S2FP8-compressed reduce-"
                         "scatter/all-gather legs (core/collectives.py) "
                         "for every compressible leaf")
    ap.add_argument("--grad-sync-min-size", type=int, default=1 << 16,
                    help="element-count floor below which a gradient leaf "
                         "takes the exact f32 path even under s2fp8 sync "
                         "(also the floor of the FSDP compressed scatter "
                         "leg)")
    ap.add_argument("--shard-params", default="replicated",
                    choices=PARAM_SHARDING_MODES,
                    help="param/optimizer placement under the mesh: "
                         "'replicated' (every rank holds full copies), "
                         "'fsdp' (ZeRO-3: leaves shard dim 0 over the "
                         "fsdp axis, f32 all-gather just-in-time, grads "
                         "reduce-scatter back), or 'fsdp_q' (gather "
                         "S2FP8 payloads — 1 byte/elt on the wire — "
                         "straight into the banked GEMMs; requires "
                         "--stats-refresh-every and a payload-GEMM "
                         "policy)")
    ap.add_argument("--stats-ema", type=float, default=0.0,
                    help="EMA decay on the raw (mu, m) moments at each "
                         "StatsBank refresh (0 = replace)")
    ap.add_argument("--metrics-sink", default=None,
                    help="route loop records (step spans, watchdog / "
                         "checkpoint / guard events, per-site FP8 health) "
                         "to a sink: jsonl:<path>, csv:<path>, console")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry per-site FP8 health metrics in the "
                         "StatsBank (requires --stats-refresh-every) and "
                         "drain them to the sink each refresh")
    ap.add_argument("--guard", action="store_true",
                    help="arm the StepGuard: non-finite loss/grad and "
                         "grad-norm-spike sentinels reject bad updates and "
                         "the loop escalates skip -> forced refresh -> "
                         "snapshot rollback -> checkpoint restore")
    ap.add_argument("--guard-spike-factor", type=float, default=10.0,
                    help="trip when grad_norm exceeds this multiple of "
                         "its accepted-step EMA")
    ap.add_argument("--guard-warmup", type=int, default=8,
                    help="accepted steps before the spike sentinel arms")
    ap.add_argument("--guard-sat-threshold", type=float, default=0.0,
                    help="trip when any StatsBank site's sat_frac "
                         "telemetry exceeds this fraction (0 = off; "
                         "needs --telemetry)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="push (params, opt, bank, guard) onto an "
                         "in-memory snapshot ring every K clean steps — "
                         "the ladder's rollback target (0 = ring off)")
    ap.add_argument("--snapshot-ring", type=int, default=4,
                    help="snapshot ring depth")
    ap.add_argument("--snapshot-compress", action="store_true",
                    help="S2FP8-compress big snapshot leaves (~4x less "
                         "host memory; rollback no longer bitwise)")
    ap.add_argument("--watchdog-escalate-after", type=int, default=0,
                    help="N consecutive watchdog trips push a proactive "
                         "snapshot + watchdog_escalated event (0 = trips "
                         "stay log-only)")
    ap.add_argument("--chaos", default=None,
                    help="deterministic fault injection spec "
                         "(training/chaos.py), e.g. 'nan_grad@5x3,"
                         "slow_step@12:0.5'; injectors: nan_grad, "
                         "inf_loss, reject, saturating_bank, "
                         "corrupt_ckpt, slow_step, corrupt_batch. "
                         "Implies --guard.")
    args = ap.parse_args(argv)
    if args.telemetry and args.stats_refresh_every <= 0:
        raise SystemExit("--telemetry requires --stats-refresh-every > 0 "
                         "(health metrics ride the StatsBank refresh)")
    if args.guard_sat_threshold > 0 and not args.telemetry:
        raise SystemExit("--guard-sat-threshold reads the StatsBank's "
                         "sat_frac telemetry leaves: add --telemetry "
                         "(and --stats-refresh-every)")
    if args.shard_params != "replicated":
        if args.mesh == "none":
            raise SystemExit("--shard-params needs a mesh (--mesh != none)")
        if args.shard_params == "fsdp_q" and args.stats_refresh_every <= 0:
            raise SystemExit("--shard-params fsdp_q streams payloads into "
                             "the banked GEMMs: add --stats-refresh-every "
                             "(and an s2fp8 payload-GEMM policy)")
    return args


def make_mesh(spec: str, device):
    """(mesh or None, this rank's device) for ``--mesh``: the process
    group first (``mesh.init_distributed``: torchrun's environment, else
    one rank), then the named mesh over it."""
    if spec == "none":
        return None, resolve_device(device)
    dev = mesh_mod.init_distributed(device)
    if spec == "host":
        return mesh_mod.make_host_mesh(), dev
    if spec in ("single", "multi"):
        return mesh_mod.make_production_mesh(multi_pod=spec == "multi"), dev
    return mesh_mod.make_mesh_from_spec(spec), dev


def build(args: argparse.Namespace) -> TrainLoop:
    """The run ``args`` describe, ready to resume and run: params and
    AdamW state from ``--seed``, the bank (one probe pass), the step, the
    sink, the checkpoint manager and the :class:`TrainLoop` around them
    (the header lines are printed here)."""
    mesh, dev = make_mesh(args.mesh, args.device)
    lead = mesh is None or mesh.rank == 0
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
    stats_cfg = (statsbank.StatsConfig(
        refresh_every=args.stats_refresh_every, ema_decay=args.stats_ema,
        telemetry=args.telemetry) if args.stats_refresh_every > 0 else None)

    def gen(step):
        # each step's batch is a function of (seed, step): a rollback or a
        # resume replays the same data
        return torch.Generator().manual_seed(int(
            np.random.SeedSequence([args.seed, step]).generate_state(1)[0]))
    loss_fn = api.make_loss_fn(cfg)
    if cfg.enc_dec:
        def data(step):
            b = synthetic.seq2seq_batch(gen(step), args.batch, args.seq,
                                        args.seq, cfg.vocab, dev)
            return {"enc_inputs": b["enc_tokens"],
                    "dec_tokens": b["dec_tokens"],
                    "dec_labels": b["dec_labels"]}
    else:
        chain = synthetic.markov_chain(args.seed, cfg.vocab)

        def data(step):
            return synthetic.lm_batch(chain, gen(step), args.batch, args.seq,
                                      dev)
    params = api.init_params(cfg, seed=args.seed, device=dev)
    out = (functools.partial(print, flush=True) if lead
           else (lambda *a, **k: None))
    console = StepLines(args.batch * args.seq, out)
    sink = obs.make_sink(args.metrics_sink, out) if args.metrics_sink \
        else console
    if not lead:
        sink = obs.NullSink()
    telemetry = (obs.Telemetry(sink, every=args.stats_refresh_every)
                 if args.telemetry else None)
    chaos_plan = chaos_mod.ChaosPlan.parse(args.chaos) if args.chaos else None
    guard_cfg = None
    if args.guard or chaos_plan is not None:
        guard_cfg = guard_mod.GuardConfig(
            spike_factor=args.guard_spike_factor, warmup=args.guard_warmup,
            sat_threshold=args.guard_sat_threshold)
    step_fn = make_train_step(loss_fn, opt, sched, pol,
                              track_stats=args.track_stats, stats=stats_cfg,
                              telemetry=telemetry, guard=guard_cfg,
                              mesh=mesh, grad_sync_mode=args.grad_sync,
                              grad_sync_min_size=args.grad_sync_min_size,
                              param_sharding=args.shard_params)
    bank = None
    if stats_cfg is not None:
        # the probe pass sees the full params, before any sharding
        bank = statsbank.init_bank(loss_fn, params, data(0), pol, stats_cfg)
    if mesh is not None:
        params = shd.shard_tree(params, mesh, args.shard_params)
    opt_state = shd.mark_opt_state(opt.init(params), params)
    gemm = ("-" if pol.mode not in S2FP8_MODES
            else "payload" if pol.uses_payload_gemm else "fig4")
    out(f"[train] {cfg.name} {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_params() / 1e6:.1f} M params, policy {pol.mode}, "
        f"loss scale "
        f"{pol.loss_scale if pol.mode == 'fp8_ls' else 1.0}, attention "
        f"{cfg.attn_impl}, "
        f"backend {args.backend} -> {pol.backend_obj.name}, gemm {gemm}, "
        f"tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"bank {'off' if bank is None else f'{len(bank)} sites'}, on {dev}")
    if mesh is not None:
        sizes = mesh_mod.axis_sizes(mesh)
        n_shards = shd.mesh_batch_size(mesh)
        out(f"[train] mesh {sizes}: {n_shards}-way data-parallel step, "
            f"grad sync {args.grad_sync}, params {args.shard_params}"
            + (f" ({shd.fsdp_axis_size(mesh)}-way over "
               f"'{shd.fsdp_axis_entry(mesh)}')"
               if args.shard_params != "replicated" else "")
            + f", {mesh.size} ranks ({mesh.device_type})")
        if args.batch % n_shards != 0:
            out(f"[train] WARNING: --batch {args.batch} does not divide "
                f"the {n_shards}-way data axis — the divisibility guard "
                f"will REPLICATE the batch (every rank computes the full "
                f"batch; no data-parallel speedup)")
        if sizes.get("model", 1) > 1:
            out(f"[train] WARNING: the mesh-native train step "
                f"parallelizes the batch and (with --shard-params) the "
                f"param store over the data axis only — the "
                f"{sizes['model']}-way model axis runs duplicate compute; "
                f"size the mesh as Nx1 to use every rank for data")
    if guard_cfg is not None:
        out(f"[train] step guard armed: spike x{guard_cfg.spike_factor} "
            f"(warmup {guard_cfg.warmup}), sat_threshold "
            f"{guard_cfg.sat_threshold}"
            + (f", chaos: {args.chaos}" if chaos_plan else ""))
    engine = pol.backend_obj.name
    ckpt = (CheckpointManager(args.ckpt_dir, event_fn=sink.emit,
                              backend=engine, mesh=mesh)
            if args.ckpt_dir else None)
    loop = TrainLoop(step_fn, params, opt_state,
                     chaos_mod.wrap_data_fn(data, chaos_plan),
                     ckpt_manager=ckpt, ckpt_every=args.ckpt_every,
                     log_every=1, stats_bank=bank, sink=sink,
                     guard_state=(guard_mod.init_state(dev)
                                  if guard_cfg is not None else None),
                     chaos=chaos_plan, snapshot_every=args.snapshot_every,
                     snapshot_ring=args.snapshot_ring,
                     snapshot_compress=args.snapshot_compress,
                     watchdog_escalate_after=args.watchdog_escalate_after,
                     codec_backend=engine, mesh=mesh)
    return loop


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
