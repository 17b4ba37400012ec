"""Paper Table 4 (mechanism): NCF on a synthetic MovieLens-scale task (port
of ``examples/train_ncf.py``).

NeuMF, AdamW at a constant 2e-3 (5e-4 x 4), batch 1,024, 8 predictive
factors — the paper's section 4.4 recipe.  Reports HR@10 against 99
sampled negatives (the paper's metric).

    PYTHONPATH=src python -m repro_torch.examples.train_ncf --steps 200
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import make_policy
from repro_torch.data import synthetic
from repro_torch.models import ncf
from repro_torch.optim import optimizers, schedules
from repro_torch.training.trainer import make_train_step

N_USERS, N_ITEMS = 1024, 512
BATCH = 1024


def run(mode: str, steps: int, seed: int = 0, device=None, batch=BATCH):
    """(HR@10, last loss) of ``steps`` steps under ``mode``."""
    dev = resolve_device(device)
    pol = make_policy(mode)
    params = ncf.init_ncf(N_USERS, N_ITEMS, factors=8, seed=seed, device=dev)
    opt = optimizers.adamw()
    step = make_train_step(ncf.loss_fn, opt, schedules.constant(5e-4 * 4),
                           pol)
    opt_state = opt.init(params)
    prefs = synthetic.ncf_preferences(seed, N_USERS, N_ITEMS)
    gen = torch.Generator().manual_seed(seed)
    for s in range(steps):
        b = synthetic.ncf_batch(prefs, gen, batch, dev)
        params, opt_state, m = step(params, opt_state, b, s)
    # HR@10 against 99 negatives
    rng = np.random.default_rng(seed + 1)
    b = synthetic.ncf_batch(prefs, torch.Generator().manual_seed(10_000),
                            256, dev)
    neg = torch.as_tensor(rng.integers(0, N_ITEMS, (256, 99)), device=dev)
    with torch.no_grad():
        hr = float(ncf.hit_ratio(params, b["users"], b["items"], neg, pol))
    return hr, float(m["loss"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    out = {}
    print(f"{'format':>8} {'HR@10':>7} {'loss':>8}")
    for mode in ("fp32", "s2fp8", "fp8"):
        hr, loss = out[mode] = run(mode, args.steps, device=args.device)
        print(f"{mode:>8} {hr:7.3f} {loss:8.4f}")
    return out


if __name__ == "__main__":
    main()
