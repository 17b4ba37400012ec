"""End-to-end driver: train a ~134M-param LM for a few hundred steps with
S2FP8, checkpointing and auto-resume (port of
``examples/train_100m_e2e.py``): config -> model -> policy -> optimizer
and schedule -> data -> ``TrainLoop`` with its watchdog and checkpoints.

    PYTHONPATH=src python -m repro_torch.examples.train_100m_e2e --steps 300

Mesh-native: ``--mesh host`` (the default) runs the train step over every
rank of the process group (``torchrun`` starts them; alone it is one
rank), the batch data-parallel and the gradients synced per
``--grad-sync``; ``--mesh none`` is the meshless step.  Checkpoints
gather sharded leaves, so a run checkpointed on 4 ranks resumes on 1:

    PYTHONPATH=src torchrun --nproc_per_node 4 \\
        -m repro_torch.examples.train_100m_e2e --device cpu --steps 200 \\
        --batch 8 --grad-sync s2fp8
    PYTHONPATH=src python -m repro_torch.examples.train_100m_e2e \\
        --device cpu --steps 300 --batch 8 --mesh none

``--shard-params fsdp`` shards param and optimizer leaves over the data
axis (ZeRO-3) with just-in-time f32 gathers; ``fsdp_q`` gathers the S2FP8
payloads (1 byte an element on the wire) straight into the banked GEMMs.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import statsbank
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic
from repro_torch.launch.train import make_mesh
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers, schedules
from repro_torch.parallel import sharding as shd
from repro_torch.training import guard as guard_mod
from repro_torch.training.trainer import TrainLoop, make_train_step

CFG = ArchConfig(
    name="lm-134m", family="dense",
    n_layers=12, d_model=768, n_heads=12, kv_heads=4, d_ff=2048,
    vocab=32_000, head_dim=64, activation="silu_glu", tie_embeddings=True,
    remat=False, attn_impl="flash",
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--policy", default="s2fp8")
    ap.add_argument("--ckpt-dir", default="/tmp/ckpt_100m")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="keep the first N layers (a smoke run)")
    ap.add_argument("--vocab", type=int, default=0,
                    help="cut the vocabulary to N tokens (a smoke run)")
    ap.add_argument("--mesh", default="host",
                    help="'host' (every rank on the data axis), a 'DxT' "
                         "spec like '4x1', or 'none' for the meshless step")
    ap.add_argument("--grad-sync", default="f32", choices=["f32", "s2fp8"],
                    help="cross-shard gradient sync: plain f32 all-reduce "
                         "or the S2FP8-compressed reduce-scatter / "
                         "all-gather")
    ap.add_argument("--grad-sync-min-size", type=int, default=1 << 16,
                    help="element floor below which leaves keep the exact "
                         "f32 sync even under s2fp8 (and the floor of the "
                         "FSDP compressed scatter leg)")
    ap.add_argument("--shard-params", default="replicated",
                    choices=["replicated", "fsdp", "fsdp_q"],
                    help="param / optimizer placement: replicated, ZeRO-3 "
                         "fsdp (f32 just-in-time gather), or fsdp_q (S2FP8 "
                         "payload gather straight into the banked GEMMs; "
                         "needs an s2fp8 policy + --stats-refresh-every)")
    ap.add_argument("--stats-refresh-every", type=int, default=16,
                    help="StatsBank refresh cadence for s2fp8 policies "
                         "(0 = exact stats every truncation)")
    ap.add_argument("--metrics-sink", default=None,
                    help="route loop records and per-site FP8 health "
                         "telemetry to a sink: jsonl:<path>, csv:<path>, "
                         "console")
    ap.add_argument("--guard", action="store_true",
                    help="arm the in-step StepGuard + the TrainLoop "
                         "escalation ladder (training/guard.py)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="with --guard: push the train carry onto the "
                         "in-memory snapshot ring every K clean steps")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mesh, dev = make_mesh(args.mesh, args.device)
    lead = mesh is None or mesh.rank == 0
    out = print if lead else (lambda *a, **k: None)
    cfg = CFG
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    if args.vocab:
        cfg = cfg.replace(vocab=args.vocab)
    if mesh is not None:
        n_shards = shd.mesh_batch_size(mesh)
        if args.batch % n_shards != 0:
            out(f"[e2e] WARNING: --batch {args.batch} does not divide the "
                f"{n_shards}-way data axis — the batch will be REPLICATED "
                f"(every rank computes the full batch)")
    out(f"[e2e] {cfg.name}: {cfg.n_params() / 1e6:.0f}M params, "
        f"policy={args.policy}, device={dev}, mesh="
        f"{'none' if mesh is None else dict(mesh.shape)}, "
        f"grad-sync={args.grad_sync}")
    # fsdp_q hands gathered payloads straight to qdot_train, so the GEMMs
    # must take the payload route on every engine
    pol = make_policy(args.policy, gemm_mode=(
        "payload" if args.shard_params == "fsdp_q" else "auto"))
    params = tlm.init_lm(cfg, seed=args.seed, device=dev)
    opt = optimizers.adamw(weight_decay=0.01)
    sched = schedules.cosine(3e-4 * 8, warmup=20, total=args.steps)

    def loss_fn(p, batch, pol_):
        return tlm.loss_fn(p, batch["tokens"], batch["labels"], cfg, pol_)

    chain = synthetic.markov_chain(args.seed, cfg.vocab)

    def data_fn(step):
        gen = torch.Generator().manual_seed(int(
            np.random.SeedSequence([args.seed, step]).generate_state(1)[0]))
        return synthetic.lm_batch(chain, gen, args.batch, args.seq, dev)

    sink = obs.make_sink(args.metrics_sink) if args.metrics_sink else None
    if not lead:
        sink = None
    stats_cfg = bank = telemetry = None
    if args.policy in ("s2fp8", "s2fp8_e4m3") and args.stats_refresh_every:
        stats_cfg = statsbank.StatsConfig(
            refresh_every=args.stats_refresh_every,
            telemetry=sink is not None)
        bank = statsbank.init_bank(loss_fn, params, data_fn(0), pol,
                                   stats_cfg)
        out(f"[e2e] statsbank: {len(bank)} sites, refresh every "
            f"{stats_cfg.refresh_every} steps"
            + (" (global under the mesh)" if mesh is not None else "")
            + (", telemetry on" if stats_cfg.telemetry else ""))
        if sink is not None:
            telemetry = obs.Telemetry(sink, every=args.stats_refresh_every)
    guard_cfg = guard_state = None
    if args.guard:
        guard_cfg = guard_mod.GuardConfig()
        guard_state = guard_mod.init_state(dev)
        out("[e2e] stepguard armed"
            + (f", snapshot ring every {args.snapshot_every}"
               if args.snapshot_every else ""))
    if args.shard_params != "replicated":
        if mesh is None:
            raise SystemExit("--shard-params needs a mesh (--mesh != none)")
        if args.shard_params == "fsdp_q" and stats_cfg is None:
            raise SystemExit("--shard-params fsdp_q needs an s2fp8 policy "
                             "with --stats-refresh-every > 0")
        out(f"[e2e] params {args.shard_params}: opt / param leaves shard "
            f"dim 0 over the data axis (ZeRO-3)")
    step_fn = make_train_step(loss_fn, opt, sched, pol, stats=stats_cfg,
                              mesh=mesh, grad_sync_mode=args.grad_sync,
                              grad_sync_min_size=args.grad_sync_min_size,
                              telemetry=telemetry, guard=guard_cfg,
                              param_sharding=args.shard_params)
    if mesh is not None:
        params = shd.shard_tree(params, mesh, args.shard_params)
    opt_state = shd.mark_opt_state(opt.init(params), params)
    ck = CheckpointManager(args.ckpt_dir, keep=2,
                           event_fn=sink.emit if sink is not None else None,
                           mesh=mesh)
    loop = TrainLoop(step_fn, params, opt_state, data_fn, ckpt_manager=ck,
                     ckpt_every=args.ckpt_every, log_every=10,
                     stats_bank=bank, sink=sink, guard_state=guard_state,
                     snapshot_every=args.snapshot_every, mesh=mesh)
    loop.maybe_resume()
    hist = loop.run(args.steps)
    if sink is not None:
        sink.close()
    if hist:
        first = hist[0]["loss"] if loop.start_step == 0 else float("nan")
        out(f"[e2e] done: start-loss "
            f"{first if first == first else 'resumed'} final-loss "
            f"{hist[-1]['loss']:.4f} over {len(hist)} steps "
            f"(ln V = {math.log(cfg.vocab):.2f})")
    return loop, hist


if __name__ == "__main__":
    main()
