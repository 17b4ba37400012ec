"""The frozen serving StatsBank: load one exported by the JAX package, or
calibrate one on the card (port of ``repro.serving.bank``).

Serving never updates stats: every (alpha, beta) a request sees is fixed
before the engine starts, and prefill/decode run under
``statsbank.freeze``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import statsbank
from repro_torch.core.policy import Policy
from repro_torch.models import transformer as tlm


def load_serving_bank(d: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Torch bank from the numpy dict ``repro.serving.bank.
    export_serving_bank`` returns: the same site keys, directions and
    fields, leaves as f32 tensors ([L]-stacked inside segments)."""
    dev = resolve_device(device)
    return {site: {direction: {f: torch.as_tensor(np.array(v, np.float32),
                                                  device=dev)
                               for f, v in state.items()}
                   for direction, state in entry.items()}
            for site, entry in d.items()}


def calibrate_serving_bank(params, cfg: ArchConfig, policy: Policy,
                           tokens: torch.Tensor, passes: int = 2
                           ) -> Dict[str, Any]:
    """Calibrate a frozen serving bank on the device that holds ``params``.

    Runs ``passes`` prefill forwards over ``tokens`` [B, S] under a
    calibrating session (no autograd): every site refreshes its forward
    stats from the tensor it sees and uses them at once (refresh-then-use),
    with the export probe's rule — ``refresh_every=1``, ``ema_decay=0.5``,
    sites visited in the order of the reference's probe.

    One deliberate difference from the reference's export: it also probes
    a dense-cache decode step, whose attention is the reference's
    ``decode_attention`` over a dense cache, which is not ported (its
    ``policy.einsum`` runs on the batched payload GEMM, which is).  The
    decode probe is left out.  The prefill probe alone mints every key
    the port's frozen prefill and paged decode read (embed/t0, head/qt0,
    the per-layer attn/qt0..3, mlp/qt0..2, qf0 and kv_cache/t0,t1 sites);
    a site's cotangent ("bwd") states stay at their initial values.
    """
    probe_cfg = statsbank.StatsConfig(refresh_every=1, ema_decay=0.5)
    dev = params["embed"].device
    bank: Dict[str, Any] = {}
    with torch.no_grad():
        for _ in range(max(1, passes)):
            caches = tlm.init_caches(cfg, tokens.shape[0], tokens.shape[1],
                                     device=dev)
            with statsbank.calibrate(bank, probe_cfg, dev):
                tlm.prefill(params, tokens.to(dev), cfg, policy, caches)
    return bank
