"""StepGuard: in-step numerics sentinels + the snapshot ring they protect
(port of ``repro.training.guard``).

A single divergent step poisons params, optimizer moments AND the
StatsBank EMAs.  The guard closes that loop in two halves:

* **In the step** (this module + trainer.py): a verdict from scalars the
  step already computes — non-finite loss or gradient (the global grad
  norm is NaN/Inf iff any leaf is), a global-grad-norm spike against a
  carried EMA (``guard_state``, two 0-d f32 tensors riding the step like
  the bank), and bank saturation read from the telemetry leaves
  (``sat_frac``).  The reference computes the update and then picks
  between the candidate and the pre-step trees (``lax.cond``); the port's
  optimizer updates in place and a second copy of params, m and v does
  not fit at full width, so the train step evaluates the verdict BEFORE
  the update, reads ``ok`` / ``ok_bank`` on the host (one read) and, on a
  reject, skips the update: params and optimizer state (``step``
  included) are not touched, the bank is merged only under ``ok_bank``
  and the guard carry integrates only accepted steps — a rejected step is
  invisible, bit for bit.

* **On the host** (:class:`SnapshotRing` + TrainLoop's escalation
  ladder): skip the step -> force a StatsBank refresh -> roll back to an
  in-memory snapshot -> restore from checkpoint.  The ring keeps the
  last-good (params, opt, bank, guard) on the HOST every k steps,
  optionally S2FP8-compressed through the checkpoint manager's codec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import convert, resolve_device
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.core import statsbank


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """In-step sentinel thresholds.

    * ``spike_factor`` — trip when the (global) grad norm exceeds
      ``spike_factor * EMA``; the EMA only integrates ACCEPTED steps, so a
      rejected spike cannot drag the baseline up after it.
    * ``ema_decay``    — grad-norm EMA decay (first accepted step seeds it).
    * ``warmup``       — accepted steps before the spike sentinel arms.
    * ``sat_threshold`` — trip when any bank site's ``sat_frac`` telemetry
      leaf exceeds this fraction; 0 disables the sentinel (it needs a
      telemetry-enabled StatsBank).  A saturation trip rejects the
      param/optimizer update but NOT the bank: the refresh that measured
      the saturation is the remedy, and discarding it would wedge the
      guard in a reject loop.
    """
    spike_factor: float = 10.0
    ema_decay: float = 0.9
    warmup: int = 8
    sat_threshold: float = 0.0

    def __post_init__(self):
        if self.spike_factor <= 1.0:
            raise ValueError("guard spike_factor must be > 1")
        if not (0.0 <= self.ema_decay < 1.0):
            raise ValueError("guard ema_decay must be in [0, 1)")


def init_state(device=None) -> Dict[str, torch.Tensor]:
    """Fresh guard carry: no grad-norm history, spike sentinel disarmed
    (two 0-d f32 tensors on ``device``: the card unless the CPU is
    asked for)."""
    dev = resolve_device(device)
    return {"gnorm_ema": torch.zeros((), dtype=torch.float32, device=dev),
            "steps": torch.zeros((), dtype=torch.float32, device=dev)}


# ---------------------------------------------------------------------------
# bank probes
# ---------------------------------------------------------------------------

def saturation_leaves(bank: Dict[str, Any]) -> Optional[torch.Tensor]:
    """Every site-direction's ``sat_frac`` telemetry leaf, concatenated
    (None for a telemetry-off bank)."""
    leaves = [st["sat_frac"].reshape(-1) for e in bank.values()
              for st in e.values() if "sat_frac" in st]
    if not leaves:
        return None
    return leaves[0] if len(leaves) == 1 else torch.cat(leaves)


def bank_probe(input_bank: Dict[str, Any], new_bank: Dict[str, Any],
               sat_threshold: float
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(cold_min, sat_margin)`` from ONE min: the cold row reads the
    INPUT bank's ``last`` (did any site bootstrap-refresh this step), the
    saturation row the NEW bank's ``sat_frac`` (so a forced refresh clears
    the verdict the same step it lands), both padded with +inf to one
    length.  ``sat_margin`` is ``sat_threshold - max(sat_frac)``: negative
    means some site saturates past the threshold; None when the bank
    carries no telemetry or the sentinel is off.  (The port's train step
    decides refreshes on the host, so it calls this only with the sentinel
    armed.)"""
    cold = statsbank.bookkeeping_last(input_bank)
    sat = saturation_leaves(new_bank) if sat_threshold > 0 else None
    if sat is None:
        return torch.min(cold), None
    margin = sat_threshold - sat
    n = max(cold.shape[0], margin.shape[0])

    def pad(v):
        if v.shape[0] == n:
            return v
        return torch.cat([v, torch.full((n - v.shape[0],), float("inf"),
                                        dtype=torch.float32,
                                        device=v.device)])

    mins = torch.min(torch.stack([pad(cold), pad(margin)]), dim=1).values
    return mins[0], mins[1]


# ---------------------------------------------------------------------------
# verdict
# ---------------------------------------------------------------------------

def evaluate(cfg: GuardConfig, state: Dict[str, torch.Tensor],
             loss: torch.Tensor, grad_norm: torch.Tensor,
             sat_margin: Optional[torch.Tensor] = None,
             force_reject=None
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One step's verdict: ``(flags, new_guard_state)``, every check
    elementwise (no reduction).

    ``flags`` (0-d bool tensors):
      * ``ok``        — accept the param/optimizer update
      * ``ok_bank``   — accept the bank update (saturation exempted, see
                        :class:`GuardConfig`)
      * ``nonfinite`` / ``spike`` / ``sat`` / ``forced`` — the cause bits
        the host ladder reads.

    The carry only integrates accepted steps: on a rejected step the EMA
    and the warmup counter keep their values (a NaN grad norm never
    touches the baseline)."""
    dev = loss.device
    finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
    nonfinite = ~finite
    armed = state["steps"] >= cfg.warmup
    spike = armed & finite & (grad_norm > cfg.spike_factor
                              * state["gnorm_ema"])
    false = torch.zeros((), dtype=torch.bool, device=dev)
    sat = (sat_margin < 0.0) if sat_margin is not None else false
    forced = (false if force_reject is None
              else torch.as_tensor(force_reject, device=dev).bool())
    bad_numerics = nonfinite | spike | forced
    ok = ~(bad_numerics | sat)
    ok_bank = ~bad_numerics

    # the EMA fallback keeps a NaN grad_norm out of the arithmetic
    gn_safe = torch.where(finite, grad_norm, state["gnorm_ema"])
    first = state["steps"] == 0
    ema_next = torch.where(
        first, gn_safe,
        cfg.ema_decay * state["gnorm_ema"] + (1.0 - cfg.ema_decay) * gn_safe)
    new_state = {
        "gnorm_ema": torch.where(ok, ema_next, state["gnorm_ema"]),
        "steps": state["steps"] + ok.float(),
    }
    flags = {"ok": ok, "ok_bank": ok_bank, "nonfinite": nonfinite,
             "spike": spike, "sat": sat, "forced": forced}
    return flags, new_state


def flag_metrics(flags: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Verdict bits as f32 metric leaves (the host reads
    ``guard_ok < 0.5``)."""
    return {f"guard_{k}": v.float() for k, v in flags.items()
            if k != "ok_bank"}


# ---------------------------------------------------------------------------
# host-side snapshot ring (escalation ladder rung 3)
# ---------------------------------------------------------------------------

class _CompressedLeaf:
    """Host-side S2FP8-compressed leaf: 1-byte payload + (alpha, beta),
    encoded on the leaf's device by the checkpoint codec."""

    __slots__ = ("payload", "stats", "dtype")

    def __init__(self, leaf: torch.Tensor, backend: Optional[str]):
        self.payload, self.stats = ckpt_mod.encode(leaf, backend)
        self.dtype = leaf.dtype


class SnapshotRing:
    """Last-good train state on the HOST, every k steps, bounded depth.

    ``push(step, tree)`` copies the tree's leaves to the host (complete
    when ``push`` returns) and appends them; the ring keeps the newest
    ``size`` entries.  ``compress=True`` routes big f32 leaves through the
    S2FP8 codec on their device (``backend``: the numerics engine) and
    keeps only the payload and (alpha, beta) on the host; scalars, small
    and integer leaves stay raw so optimizer counters and bank bookkeeping
    restore bit-exact.  A compressed rollback is NOT bitwise for the big
    leaves — leave it off when the run must replay exactly (the default).
    """

    def __init__(self, size: int = 4, compress: bool = False,
                 backend: Optional[str] = None):
        if size < 1:
            raise ValueError("snapshot ring size must be >= 1")
        self.size = int(size)
        self.compress = compress
        self.backend = backend
        self._ring: List[Tuple[int, Any]] = []

    def __len__(self) -> int:
        return len(self._ring)

    def _encode(self, leaf):
        if self.compress and ckpt_mod.compressible(leaf):
            return _CompressedLeaf(leaf, self.backend)
        return ckpt_mod.host_copy(leaf)

    def push(self, step: int, tree: Any) -> None:
        leaves = [self._encode(x) for x in convert.jax_leaves(tree)]
        self._ring.append((int(step), (convert.skeleton(tree), leaves)))
        if len(self._ring) > self.size:
            del self._ring[:len(self._ring) - self.size]

    def latest(self) -> Optional[Tuple[int, Any]]:
        """Newest ``(step, tree)`` — the state ENTERING ``step``, as new
        tensors on the devices it was pushed from — or None."""
        if not self._ring:
            return None
        step, (skel, leaves) = self._ring[-1]
        tmpl = convert.jax_leaves(skel)
        out = [ckpt_mod.decode(x.payload, x.stats, t.device, x.dtype,
                               self.backend)
               if isinstance(x, _CompressedLeaf) else x
               for x, t in zip(leaves, tmpl)]
        return step, convert.unflatten(skel, out)
