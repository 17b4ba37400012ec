"""Train-step factory (port of the meshless part of
``repro.training.trainer``): numerics policy, FP32 master weights, the
StatsBank carry.

Loss scaling (paper Eq. 6): under ``fp8_ls`` the loss is multiplied by
``policy.loss_scale`` before the gradients are taken, so every truncated
cotangent is one of the scaled loss; the gradients and the reported loss
are divided by it after, with or without a bank.

``make_train_step`` returns

    step(params, opt_state, batch, step)       -> (params, opt_state, metrics)
    step(params, opt_state, bank, batch, step) -> (params, opt_state, bank,
                                                   metrics)      # stats=...

as the reference's does.  PyTorch runs eagerly, so the step is a plain
function: the loss runs under a :func:`statsbank.bind` session, autograd
gives the gradients, the session's refreshed states are merged into the
returned bank, and the optimizer updates ``params`` and ``opt_state`` in
place (see ``optim/optimizers.py``).

The bank's refresh decision is made on the host: a site refreshes when
``step % refresh_every == 0`` or while it has never been refreshed
(``last < 0``).  The step keeps the cold-site map of the last bank it
returned and re-reads it (one device read, ``statsbank.cold_sites``) only
after a step that refreshed something, so a steady step reads no device
scalar.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import s2fp8, statsbank
from repro_torch.core.policy import S2FP8_MODES, Policy
from repro_torch.optim.optimizers import (Optimizer, global_norm,
                                          tree_leaves, tree_unflatten)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    schedule: Callable, policy: Policy,
                    track_stats: bool = False,
                    stats: Optional[statsbank.StatsConfig] = None):
    """``loss_fn(params, batch, policy) -> (loss, metrics)``; ``stats``
    enables the StatsBank carry (build the first bank with
    ``statsbank.init_bank(loss_fn, params, batch, policy, stats)``).
    Metrics: loss, grad_norm (before clipping), lr, the loss_fn's own, with
    a bank ``stats_refreshed`` (1.0 when any site refreshed), and with
    ``track_stats`` ``probe_stats``: ``s2fp8.tensor_stats`` (mu, m, alpha,
    beta) of the last gradient leaf in the reference's leaf order (paper
    Fig. 5)."""
    if stats is not None and policy.mode not in S2FP8_MODES:
        raise ValueError(
            f"StatsBank requires an s2fp8-mode policy, got {policy.mode!r}")
    scale = policy.loss_scale if policy.mode == "fp8_ls" else 1.0

    def scaled(loss):
        return loss * scale if scale != 1.0 else loss
    # the cold-site map of the bank this step returned last
    carried = {"bank": None, "cold": None}

    def _step(params, opt_state, bank, batch, step):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        sess = None
        if bank is None:
            loss, metrics = loss_fn(params, batch, policy)
            loss = scaled(loss)
            grads = torch.autograd.grad(loss, leaves)
        else:
            cold = (carried["cold"] if bank is carried["bank"]
                    else statsbank.cold_sites(bank))
            with statsbank.bind(bank, step, stats, cold) as sess:
                loss, metrics = loss_fn(params, batch, policy)
                loss = scaled(loss)
                # inside the session: remat replays layers in the backward
                grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if scale != 1.0:
            grads = tuple(g / scale for g in grads)
            loss = loss / scale
        grads = tree_unflatten(params, grads)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss
        out["grad_norm"] = global_norm(grads)
        out["lr"] = schedule(step)
        if track_stats:
            out["probe_stats"] = s2fp8.tensor_stats(tree_leaves(grads)[-1])
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             out["lr"])
        if sess is None:
            return params, opt_state, None, out
        new_bank = statsbank.merge_updates(bank, sess.updates)
        refreshed = bool(sess.updates)
        out["stats_refreshed"] = float(refreshed)
        carried["bank"] = new_bank
        carried["cold"] = (statsbank.cold_sites(new_bank) if refreshed
                           else cold)
        return params, opt_state, new_bank, out

    if stats is None:
        def train_step(params, opt_state, batch, step):
            p, o, _, out = _step(params, opt_state, None, batch, step)
            return p, o, out
        return train_step

    def banked_train_step(params, opt_state, bank, batch, step):
        return _step(params, opt_state, bank, batch, step)
    return banked_train_step


def make_eval_step(loss_fn: Callable, policy: Policy):
    """``eval_step(params, batch) -> metrics`` (no autograd)."""
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, policy)
        return metrics
    return eval_step
