"""Paper Table 1 (mechanism): ResNet-20 on a CIFAR-shaped task across
formats (port of ``examples/train_resnet_cifar.py``).

FP32 vs S2FP8 vs FP8 vs FP8+LS(100), SGD momentum 0.9, weight decay 1e-4
and the step decay at 60% and 85% of the run — the paper's section 4.2
recipe on class-conditional blobs.  The batch-norm state rides beside the
train step.

    PYTHONPATH=src python -m repro_torch.examples.train_resnet_cifar \\
        --steps 80
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic
from repro_torch.models import resnet
from repro_torch.optim import optimizers, schedules
from repro_torch.training.trainer import make_train_step


def run(mode: str, steps: int, depth: int = 20, batch: int = 16,
        seed: int = 0, loss_scale: float = 100.0, device=None):
    """(mean accuracy over the last tenth of the steps, last nll)."""
    dev = resolve_device(device)
    pol = make_policy(mode, loss_scale=loss_scale)
    params, bn = resnet.init_resnet(depth, seed=seed, device=dev)
    carry = {"bn": bn}

    def loss_fn(p, b, pol_):
        loss, (metrics, new_bn) = resnet.loss_fn(p, carry["bn"], b, pol_)
        carry["new"] = new_bn
        return loss, metrics

    opt = optimizers.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    sched = schedules.step_decay(0.05, [int(steps * 0.6),
                                        int(steps * 0.85)])
    step = make_train_step(loss_fn, opt, sched, pol)
    opt_state = opt.init(params)
    centers = synthetic.cifar_centers(seed)
    gen = torch.Generator().manual_seed(seed)
    accs, losses = [], []
    for s in range(steps):
        b = synthetic.cifar_batch(centers, gen, batch, dev)
        params, opt_state, m = step(params, opt_state, b, s)
        carry["bn"] = carry["new"]
        losses.append(float(m["nll"]))
        accs.append(float(m["acc"]))
    tail = max(1, len(accs) // 10)
    return sum(accs[-tail:]) / tail, losses[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--depth", type=int, default=20)
    args = ap.parse_args(argv)
    out = {}
    print(f"{'format':>12} {'final_acc':>10} {'final_loss':>11}")
    for mode in ("fp32", "s2fp8", "fp8", "fp8_ls"):
        acc, loss = out[mode] = run(mode, args.steps, depth=args.depth,
                                    device=args.device)
        label = "fp8_ls(100)" if mode == "fp8_ls" else mode
        print(f"{label:>12} {acc:10.3f} {loss:11.4f}")
    return out


if __name__ == "__main__":
    main()
