"""s2fp8-doctor: per-site FP8 health report for a checkpointed run (port
of ``repro.launch.doctor``).

Loads a checkpoint (params + optimizer state + StatsBank), replays ONE
synthetic batch per requested engine with every StatsBank refresh
forced, and prints a ranked per-site health report: saturation /
underflow fractions measured against the bank's carried stats,
quantization SNR, EMA-vs-live moment drift, staleness, and an e4m3/e5m2
format recommendation per site.

    PYTHONPATH=src python -m repro_torch.launch.doctor --arch minicpm_2b \\
        --reduced --ckpt-dir /tmp/ckpt --backends cuda,cuda_fused
    PYTHONPATH=src python -m repro_torch.launch.doctor --smoke \\
        --device cpu --backends plain

It runs on the card unless ``--device cpu``.  The checkpoint may come from
either package (the two managers' files are the same, both ways).  A
checkpoint saved without a bank, or with a bank of another site structure
(a fig4-mode checkpoint probed under the payload GEMM routing), falls back
to a cold bank for that engine: its sites bootstrap with fresh stats and
report clean, which is what a fresh run would do.  The doctor reads the
newest checkpoint that validates and quarantines nothing.

``--smoke`` is the self-test, on each selected engine: a fresh reduced
transformer_tiny checkpoint reports clean, then a deliberately saturating
tensor is flagged (sat_frac > 0, e4m3 -> e5m2 recommendation).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from repro_torch import convert, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config, get_reduced_config
from repro_torch.core import backend as nbackend
from repro_torch.core import policy as policy_mod
from repro_torch.core import statsbank
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic
from repro_torch.launch import api
from repro_torch.obs import doctor as obs_doctor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import optimizers


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="s2fp8-doctor",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="transformer_tiny")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default="s2fp8",
                    choices=["s2fp8", "s2fp8_e4m3"])
    ap.add_argument("--backends", default="cuda",
                    help="comma-separated numerics engines to probe "
                         f"(available: "
                         f"{', '.join(nbackend.available_backends())})")
    ap.add_argument("--gemm-mode", default="auto",
                    choices=policy_mod.GEMM_MODES)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to load (default: newest)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refresh-every", type=int, default=16,
                    help="refresh cadence for the staleness flag context")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="self-test: fresh tiny-transformer checkpoint "
                         "reports clean; a saturating tensor is flagged")
    return ap


def _data(cfg, args, device):
    gen = torch.Generator().manual_seed(args.seed)
    if cfg.enc_dec:
        b = synthetic.seq2seq_batch(gen, args.batch, args.seq, args.seq,
                                    cfg.vocab, device)
        return {"enc_inputs": b["enc_tokens"], "dec_tokens": b["dec_tokens"],
                "dec_labels": b["dec_labels"]}
    chain = synthetic.markov_chain(args.seed, cfg.vocab)
    return synthetic.lm_batch(chain, gen, args.batch, args.seq, device)


def _newest_valid(ck: CheckpointManager) -> int:
    for s in reversed(ck._committed_steps()):
        if ck.validate(s)[0]:
            return s
    raise FileNotFoundError(f"no valid checkpoint in {ck.dir}")


def _lead_leaves(ck: CheckpointManager, step: int, params, opt_state):
    """(params, opt_state) from a checkpoint whose tree is (params,
    opt_state[, anything]): those two lead its leaves in the flatten
    order, whatever follows them."""
    with open(os.path.join(ck._step_dir(step), "META.json")) as f:
        n = json.load(f)["n_leaves"]
    extra = n - len(convert.jax_leaves((params, opt_state)))
    if extra <= 0:
        return ck.restore((params, opt_state), step)[0]
    rest = [torch.zeros(()) for _ in range(extra)]
    p, o, _ = ck.restore((params, opt_state, rest), step)[0]
    return p, o


def _restore(ckpt_dir, step, params, opt_state, bank):
    """(params, opt_state, bank_or_None, step): try (params, opt, bank)
    templates with and without telemetry leaves, then the params and
    optimizer state alone (a bankless checkpoint, or one whose bank has
    another site structure).  The step is the one asked for, else the
    newest that validates, so a template that does not match raises
    instead of sending the checkpoint to quarantine."""
    ck = CheckpointManager(ckpt_dir)
    step = _newest_valid(ck) if step is None else step
    for tmpl_bank in (bank, obs_metrics.ensure_telemetry(bank)):
        try:
            (p, o, b), s = ck.restore((params, opt_state, tmpl_bank), step)
            return p, o, b, s
        except ValueError:
            continue
    p, o = _lead_leaves(ck, step, params, opt_state)
    return p, o, None, step


def probe(args) -> list:
    """One probe per engine of ``args.backends``: a dict of the engine,
    its ranked rows, the probe loss, whether the checkpoint's bank was
    used, and the seconds (bank discovery, restore and probe)."""
    dev = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    loss_fn = api.make_loss_fn(cfg)
    params = api.init_params(cfg, seed=args.seed, device=dev)
    opt = optimizers.adamw(weight_decay=0.01)
    opt_state = opt.init(params)
    batch = _data(cfg, args, dev)
    base_cfg = statsbank.StatsConfig(refresh_every=args.refresh_every)
    out = []
    for backend_name in args.backends.split(","):
        t0 = time.perf_counter()
        pol = make_policy(args.policy, backend=backend_name,
                          gemm_mode=args.gemm_mode)
        # this engine's expected site structure (the GEMM routing differs
        # between payload and fig4 modes)
        expected = statsbank.init_bank(loss_fn, params, batch, pol, base_cfg)
        bank, probe_step, p, restored = expected, 0, params, False
        if args.ckpt_dir:
            p, _, got, probe_step = _restore(args.ckpt_dir, args.step,
                                             params, opt_state, expected)
            if got is not None:
                bank, restored = got, True
            else:
                print(f"[s2fp8-doctor] checkpoint bank does not match "
                      f"backend {backend_name!r}'s site structure "
                      f"(or has no bank) — probing a cold bank")
        probed, loss = obs_doctor.probe_bank(loss_fn, p, batch, pol, bank,
                                             base_cfg, step=probe_step)
        rows = obs_doctor.site_report(probed, step=probe_step,
                                      refresh_every=args.refresh_every)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append({"backend": backend_name, "rows": rows, "loss": loss,
                    "restored": restored,
                    "seconds": time.perf_counter() - t0})
    return out


def run(args) -> int:
    for r in probe(args):
        print(obs_doctor.format_report(r["rows"], backend=r["backend"],
                                       loss=r["loss"], top=args.top))
    return 0


def _smoke_one(args, backend_name: str, dev) -> bool:
    # 1) freshly-initialized tiny transformer checkpoint -> clean report
    cfg = get_reduced_config("transformer_tiny")
    loss_fn = api.make_loss_fn(cfg)
    params = api.init_params(cfg, seed=args.seed, device=dev)
    opt = optimizers.adamw(weight_decay=0.01)
    opt_state = opt.init(params)
    batch = _data(cfg, args, dev)
    pol = make_policy(args.policy, backend=backend_name,
                      gemm_mode=args.gemm_mode)
    base_cfg = statsbank.StatsConfig(refresh_every=args.refresh_every)
    bank = statsbank.init_bank(loss_fn, params, batch, pol, base_cfg)
    with tempfile.TemporaryDirectory() as td:
        CheckpointManager(td).save(0, (params, opt_state, bank))
        p, _, restored, s = _restore(td, None, params, opt_state, bank)
        if restored is None:
            print("[s2fp8-doctor] smoke FAILED: bank failed to restore")
            return False
        probed, loss = obs_doctor.probe_bank(loss_fn, p, batch, pol,
                                             restored, base_cfg, step=s)
    rows = obs_doctor.site_report(probed, step=s,
                                  refresh_every=args.refresh_every)
    print(obs_doctor.format_report(rows, backend=backend_name, loss=loss,
                                   top=args.top))
    if not rows:
        print("[s2fp8-doctor] smoke FAILED: no sites probed")
        return False
    unhealthy = [r for r in rows if not obs_doctor.is_clean(r)]
    if unhealthy:
        print(f"[s2fp8-doctor] smoke FAILED: fresh checkpoint reported "
              f"{len(unhealthy)} unhealthy sites")
        return False

    # 2) saturating synthetic tensor -> SAT flag + e4m3 -> e5m2 rec
    def toy_loss(p_, b_, pol_):
        return torch.sum(pol_.dot(b_, p_["w"]) ** 2), {}

    tpol = make_policy("s2fp8_e4m3", backend=backend_name, gemm_mode="fig4")
    gen = torch.Generator().manual_seed(1)
    tparams = {"w": (torch.randn((16, 8), generator=gen) * 0.1).to(dev)}
    tbatch = torch.randn((8, 16), generator=gen).to(dev)
    tbank = statsbank.init_bank(toy_loss, tparams, tbatch, tpol, base_cfg)
    # warm the bank on the in-range batch, then probe one scaled 2^12x
    # hotter: the carried stats must report saturation
    warm, _ = obs_doctor.probe_bank(toy_loss, tparams, tbatch, tpol, tbank,
                                    base_cfg, step=0)
    probed, _ = obs_doctor.probe_bank(toy_loss, tparams,
                                      tbatch * float(2.0 ** 12), tpol, warm,
                                      base_cfg, step=1)
    rows = obs_doctor.site_report(probed, step=1,
                                  refresh_every=args.refresh_every)
    print(obs_doctor.format_report(rows, backend=backend_name, top=args.top))
    worst = rows[0]
    if not (worst["sat_frac"] > 0 and "SAT" in worst["flags"]
            and worst["recommend"] == "e5m2"):
        print("[s2fp8-doctor] smoke FAILED: saturating tensor not flagged")
        return False
    return True


def _smoke(args) -> int:
    args.batch, args.seq = 2, 16
    dev = resolve_device(args.device)
    names = args.backends.split(",")
    for name in names:
        if not _smoke_one(args, name, dev):
            return 1
    print(f"[s2fp8-doctor] smoke ok ({', '.join(names)}): fresh checkpoint "
          f"clean, saturating site flagged with e5m2 recommendation")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        return _smoke(args)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
