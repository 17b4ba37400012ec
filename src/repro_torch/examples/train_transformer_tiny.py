"""Paper Table 3 (mechanism): transformer-tiny seq2seq across formats (port
of ``examples/train_transformer_tiny.py``).

The encoder-decoder (2 + 2 layers, d 128, ff 512 — the paper's tiny
config, vocab 256) on the reversal task; AdamW on a cosine schedule
(peak 2e-3, 10 warmup steps), as in section 4.3.  Reports the last nll
and the token accuracy on a held-out batch (a proxy for BLEU's
direction).

    PYTHONPATH=src python -m repro_torch.examples.train_transformer_tiny \\
        --steps 150
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic
from repro_torch.models import encdec
from repro_torch.optim import optimizers, schedules
from repro_torch.training.trainer import make_train_step


def run(mode: str, steps: int, seed: int = 0, loss_scale: float = 100.0,
        device=None):
    """(last nll, held-out token accuracy)."""
    dev = resolve_device(device)
    cfg = get_config("transformer_tiny").replace(vocab=256)
    pol = make_policy(mode, loss_scale=loss_scale)
    params = encdec.init_encdec(cfg, seed=seed, device=dev)
    opt = optimizers.adamw()
    sched = schedules.cosine(2e-3, warmup=10, total=steps)

    def loss_fn(p, b, pol_):
        return encdec.loss_fn(p, b["enc_tokens"], b["dec_tokens"],
                              b["dec_labels"], cfg, pol_)

    step = make_train_step(loss_fn, opt, sched, pol)
    opt_state = opt.init(params)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for s in range(steps):
        b = synthetic.seq2seq_batch(gen, 16, 16, 16, cfg.vocab, dev)
        params, opt_state, m = step(params, opt_state, b, s)
        losses.append(float(m["nll"]))
    b = synthetic.seq2seq_batch(torch.Generator().manual_seed(seed + 1), 32,
                                16, 16, cfg.vocab, dev)
    with torch.no_grad():
        enc = encdec.encode(params, b["enc_tokens"], cfg, pol)
        ekv = encdec.cross_kv(params, enc, cfg, pol)
        logits, _ = encdec.decode_stack(params, b["dec_tokens"], ekv, cfg,
                                        pol)
    acc = float((logits.argmax(-1) == b["dec_labels"]).float().mean())
    return losses[-1], acc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    out = {}
    print(f"{'format':>12} {'final_nll':>10} {'tok_acc':>8}")
    for mode in ("fp32", "s2fp8", "fp8", "fp8_ls"):
        nll, acc = out[mode] = run(mode, args.steps, device=args.device)
        label = "fp8_ls(100)" if mode == "fp8_ls" else mode
        print(f"{label:>12} {nll:10.4f} {acc:8.3f}")
    return out


if __name__ == "__main__":
    main()
