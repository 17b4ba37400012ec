"""Per-site FP8 health metrics (port of ``repro.obs.metrics``) — the
numbers behind the telemetry layer.

Each metric answers one question the loss curve cannot:

* ``sat_frac``   — fraction of nonzero elements whose shifted/squeezed
  log-magnitude lands at or past the payload format's max finite value
  (``log2|Y| >= log2(fmax)``): the carried (alpha, beta) no longer keep
  the tensor inside the representable range (paper Eq. 5 clamps these).
* ``uflow_frac`` — fraction of nonzero elements the truncation flushes to
  exactly zero.
* ``qmse``       — mean squared truncation error, ``mean((truncate(x) -
  x)^2)``.
* ``qsnr_db``    — ``10*log10(sum(x^2) / sum((truncate(x) - x)^2))``; 0
  when either sum is exactly zero.
* ``drift_mu`` / ``drift_m`` — ``|EMA - live|`` distance between the
  bank's carried (mu, m) moments and the live tensor's raw Eq. 3–4
  moments at refresh time.

:func:`repro_torch.core.statsbank.refresh_state` calls
:func:`health_update` on a refresh of a state that carries the telemetry
leaves, so the metrics are measured against the **pre-refresh carried
stats** (on the bootstrap refresh, ``last < 0``, against the fresh ones:
a cold site reports clean).  Steady steps run none of this.  The four
sums are f32 ``torch.sum``s, as the reference's ``jnp.sum``s; the
truncation runs through the numerics engine (truncate-apply, #5, on the
card).

This module must not import ``repro_torch.core.statsbank`` (statsbank
imports it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import backend as nbackend
from repro_torch.core import s2fp8

# Extra per-direction site-state leaves carried by a telemetry-enabled
# bank (StatsConfig(telemetry=True)); they ride the bank through the
# sessions' updates, merge_updates and checkpoints like the five stats.
TELE_FIELDS = ("sat_frac", "uflow_frac", "qmse", "qsnr_db",
               "drift_mu", "drift_m")

# Reverse lookup: refresh callers pass target_max; the metric needs the
# payload format's max finite value.  Falls back to e5m2 (the paper's
# format) for non-standard target_max values.
_FMT_FROM_TARGET = {float(v): k for k, v in s2fp8.FMT_TARGET_MAX.items()}


def resolve_fmt(target_max: float) -> str:
    return _FMT_FROM_TARGET.get(float(target_max), "e5m2")


def init_tele_state(shape: Tuple[int, ...] = (), device=None
                    ) -> Dict[str, torch.Tensor]:
    """Zeroed telemetry leaves (a cold site reports clean)."""
    return {f: torch.zeros(shape, dtype=torch.float32, device=device)
            for f in TELE_FIELDS}


def has_telemetry(state: Dict[str, torch.Tensor]) -> bool:
    return TELE_FIELDS[0] in state


def health_update(x: torch.Tensor, state: Dict[str, torch.Tensor],
                  new_stats: Dict[str, torch.Tensor],
                  mu_t: torch.Tensor, m_t: torch.Tensor,
                  has: torch.Tensor, first: torch.Tensor,
                  count: torch.Tensor, *, fmt: str,
                  backend: Optional[str] = None,
                  axis_name=None) -> Dict[str, torch.Tensor]:
    """One refresh's health metrics (module docstring).  ``new_stats``
    holds the freshly derived (alpha, beta); ``mu_t`` / ``m_t`` are the
    live raw moments and ``count`` the (already global) nonzero count of
    the refresh's reduction.  Under ``axis_name`` the metric partials are
    summed over those mesh axes like the stats partials, so a sharded
    tensor's metrics are those of the global tensor."""
    # measure with the stats that truncated recent steps: the carried
    # pair, except on bootstrap where only the fresh pair exists
    a_used = torch.where(first, new_stats["alpha"], state["alpha"])
    b_used = torch.where(first, new_stats["beta"], state["beta"])
    xf = x.float()
    be = nbackend.get_backend(backend)
    t = be.truncate(xf, stats=torch.stack([a_used, b_used]),
                    fmt=fmt).float()

    absx = xf.abs()
    nonzero = absx > 0.0
    ylog = a_used * torch.log2(torch.where(nonzero, absx, 1.0)) + b_used
    log_fmax = math.log2(s2fp8.FMT_MAX_FINITE[fmt])

    sat = torch.sum((nonzero & (ylog >= log_fmax)).float())
    uflow = torch.sum((nonzero & (t == 0.0)).float())
    err2 = torch.sum(torch.square(t - xf))
    sig2 = torch.sum(torch.square(xf))
    size = float(xf.numel())
    if axis_name is not None:
        from repro_torch.core import collectives
        sums = collectives.all_reduce(torch.stack(
            [sat, uflow, err2, sig2,
             torch.tensor(size, device=xf.device)]), axis_name)
        sat, uflow, err2, sig2 = sums[0], sums[1], sums[2], sums[3]
        size = float(sums[4])

    denom = torch.clamp(count, min=1.0)
    qmse = err2 / max(size, 1.0)
    # dB via a log-ratio with floored operands; exactly-zero error or
    # signal reports 0 rather than +/-inf
    ok = (err2 > 0.0) & (sig2 > 0.0)
    qsnr_db = torch.where(
        ok, 10.0 * (torch.log10(torch.clamp(sig2, min=1e-38))
                    - torch.log10(torch.clamp(err2, min=1e-38))), 0.0)
    live = has & ~first
    drift_mu = torch.where(live, torch.abs(state["ema_mu"] - mu_t), 0.0)
    drift_m = torch.where(live, torch.abs(state["ema_m"] - m_t), 0.0)
    return {"sat_frac": (sat / denom).float(),
            "uflow_frac": (uflow / denom).float(),
            "qmse": qmse.float(), "qsnr_db": qsnr_db.float(),
            "drift_mu": drift_mu.float(), "drift_m": drift_m.float()}


def ensure_telemetry(bank: Dict[str, Dict[str, Dict[str, torch.Tensor]]]
                     ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Widen a bank's site states with zeroed telemetry leaves (no-op for
    states that already carry them) — how the doctor probes a bank that
    was trained with telemetry off."""
    out = {}
    for site, entry in bank.items():
        out[site] = {}
        for d, st in entry.items():
            widened = dict(st)
            if not has_telemetry(st):
                widened.update(init_tele_state(tuple(st["alpha"].shape),
                                               st["alpha"].device))
            out[site][d] = widened
    return out


def strip_telemetry(bank: Dict[str, Dict[str, Dict[str, torch.Tensor]]]
                    ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Drop telemetry leaves — restores the plain five-leaf site layout
    (e.g. to restore a telemetry-on checkpoint into a telemetry-off run)."""
    return {site: {d: {k: v for k, v in st.items() if k not in TELE_FIELDS}
                   for d, st in entry.items()}
            for site, entry in bank.items()}
