"""The frozen serving StatsBank: load one exported by the JAX package, or
calibrate one on the card (port of ``repro.serving.bank``).

Serving never updates stats: every (alpha, beta) a request sees is fixed
before the engine starts, and prefill/decode run under
``statsbank.freeze``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

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
                           tokens: torch.Tensor, passes: int = 2,
                           train_bank: Optional[Dict[str, Any]] = None
                           ) -> Dict[str, Any]:
    """Calibrate a frozen serving bank on the device that holds ``params``,
    probing both serving graphs as the reference's export does
    (``repro.serving.bank.export_serving_bank``).

    ``tokens`` [B, S] are the prompts.  The decode probe is one
    ``tlm.decode_step`` over dense caches at position S: its caches come
    from one sessionless prefill of ``tokens`` under ``policy`` (exact
    per-call stats, so decode sees real magnitudes), its token is that
    prefill's argmax.  Each of ``passes`` passes refreshes the prefill
    graph, then the decode graph, under a forward-only calibrating session
    with the export probe's rule (``refresh_every=1``, ``ema_decay=0.5``):
    every site refreshes its forward stats from the tensor it sees and
    uses them at once.  The sites the two graphs share (every weight's
    ``b.fwd``, ``embed/t0``, ``head/qt0``, ``attn/qt*``, ``mlp/qt*``,
    ``kv_cache/t*``) are refreshed by both; decode adds its attention's
    two einsum sites (``seg*/qt0``, ``qt1``), which the f32 comparator
    pools read; prefill's flash site ``seg*/qf0`` keeps its prefill
    calibration (the reference's export resets it, ROADMAP queue 3).
    ``train_bank`` seeds every site the graphs visit whose entry there has
    the same layout, before its first refresh.  Cotangent ("bwd") states
    stay at their initial (or seeded) values.
    """
    probe_cfg = statsbank.StatsConfig(refresh_every=1, ema_decay=0.5)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    b, s = tokens.shape
    with torch.no_grad():
        filled = tlm.init_caches(cfg, b, s + 4, device=dev)
        logits, filled = tlm.prefill(params, tokens, cfg, policy, filled)
        token = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        bank: Dict[str, Any] = {}
        for _ in range(max(1, passes)):
            with statsbank.calibrate(bank, probe_cfg, dev, seed=train_bank):
                tlm.prefill(params, tokens, cfg, policy,
                            tlm.init_caches(cfg, b, s + 4, device=dev))
            with statsbank.calibrate(bank, probe_cfg, dev, seed=train_bank):
                tlm.decode_step(params, token, cfg, policy, filled, pos)
    return bank
