"""s2fp8-doctor library (port of ``repro.obs.doctor``): probe a bank
with one replayed batch and rank sites by FP8 health.

:func:`probe_bank` replays ONE batch through the banked loss with every
refresh forced (``refresh_every=1``), so each site recomputes its health
metrics against the bank's CARRIED stats — exactly what the next real
training step would have truncated with.  A warm bank fed a drifted batch
reports saturation/underflow; a cold (freshly-initialized) bank
bootstraps with fresh stats and reports clean.  :func:`site_report`
flattens the probed bank into ranked rows and :func:`recommend_fmt`
applies the e4m3/e5m2 range-vs-resolution rule.

This module imports ``core/statsbank.py`` (which imports
``repro_torch.obs.metrics``) — import it directly, never through the
``repro_torch.obs`` package root.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import statsbank
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

# Underflow-to-zero fraction above which a site is flagged and pushed
# toward the wider-range format.  Flushing a few percent of near-zero
# values is intrinsic S2FP8 behavior even with fresh stats (the squeeze
# trades the low tail for range — ~3-8% on small Gaussian tensors);
# well past that means the carried shift is discarding real signal.
UFLOW_THRESH = 0.15
# A site whose last refresh is more than this many refresh periods old is
# flagged stale (its carried stats describe a long-gone tensor).
STALE_FACTOR = 4.0


def probe_bank(loss_fn, params, batch, policy, bank: Dict[str, Any],
               cfg: statsbank.StatsConfig, step: int = 0
               ) -> Tuple[Dict[str, Any], float]:
    """One forced-refresh banked forward+backward over ``batch``.

    Every site refreshes (``refresh_every=1``) with telemetry on, so the
    returned bank carries health metrics measured against the input
    bank's carried stats.  Returns ``(probed_bank, loss)``; the input
    bank is not mutated (the session's updates are merged into a new
    bank) and the gradients are discarded."""
    probe_cfg = dataclasses.replace(cfg, refresh_every=1, telemetry=True)
    bank_t = obs_metrics.ensure_telemetry(bank)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    probe_params = tree_unflatten(params, leaves)
    with statsbank.bind(bank_t, step, probe_cfg) as sess:
        loss, _ = loss_fn(probe_params, batch, policy)
        # inside the session: the backward refreshes the cotangent sites
        torch.autograd.grad(loss, leaves)
    return statsbank.merge_updates(bank_t, sess.updates), loss.item()


def _flags(row: Dict[str, Any], refresh_every: int) -> List[str]:
    fl = []
    if row["last"] < 0:
        fl.append("COLD")
    if row["sat_frac"] > 0:
        fl.append("SAT")
    if row["uflow_frac"] > UFLOW_THRESH:
        fl.append("UFLOW")
    if row["staleness"] > STALE_FACTOR * refresh_every:
        fl.append("STALE")
    return fl


def recommend_fmt(row: Dict[str, Any]) -> Tuple[str, str]:
    """The e4m3/e5m2 range-vs-resolution rule on one site row: any range
    distress (saturation at the format max, or meaningful underflow-to-
    zero) wants e5m2's wider exponent; a site comfortably in range can
    take e4m3's extra mantissa bit."""
    if row["sat_frac"] > 0:
        return "e5m2", "saturating at format max -> needs range"
    if row["uflow_frac"] > UFLOW_THRESH:
        return "e5m2", "underflow-to-zero above threshold -> needs range"
    return "e4m3", "in range -> can take the mantissa bit"


def is_clean(row: Dict[str, Any]) -> bool:
    """Healthy = no range distress and not stale (COLD just means no
    data has reached the site yet)."""
    return not (set(row["flags"]) & {"SAT", "UFLOW", "STALE"})


def site_report(bank: Dict[str, Any], *, step: int = 0,
                refresh_every: int = 16) -> List[Dict[str, Any]]:
    """Flatten a (probed) bank into per-site-direction rows, ranked most
    distressed first: saturation fraction, then underflow, then
    staleness.  Scanned segments ([L]-shaped leaves) yield one row per
    layer.  Sites without telemetry leaves are skipped."""
    rows: List[Dict[str, Any]] = []
    for site in sorted(bank):
        for d in sorted(bank[site]):
            st = bank[site][d]
            if not obs_metrics.has_telemetry(st):
                continue
            leaves = {k: v.detach().cpu().numpy()
                      for k, v in st.items()}
            scalar = leaves["last"].ndim == 0
            n = 1 if scalar else leaves["last"].shape[0]
            for i in range(n):
                def get(k):
                    return float(leaves[k]) if scalar else float(leaves[k][i])
                row = {"site": site, "dir": d,
                       "layer": None if scalar else i,
                       **{k: get(k) for k in obs_metrics.TELE_FIELDS},
                       "alpha": get("alpha"), "beta": get("beta"),
                       "last": get("last")}
                row["staleness"] = (step - row["last"]
                                    if row["last"] >= 0 else -1.0)
                row["flags"] = _flags(row, refresh_every)
                row["recommend"], row["why"] = recommend_fmt(row)
                rows.append(row)
    rows.sort(key=lambda r: (r["sat_frac"], r["uflow_frac"],
                             r["staleness"]), reverse=True)
    return rows


def format_report(rows: List[Dict[str, Any]], *, backend: str = "?",
                  loss: Optional[float] = None, top: int = 10) -> str:
    """Human-readable ranked health report for one backend's probe."""
    lines = []
    n_clean = sum(is_clean(r) for r in rows)
    head = (f"[s2fp8-doctor] backend={backend} sites={len(rows)} "
            f"clean={n_clean} flagged={len(rows) - n_clean}")
    if loss is not None:
        head += f" probe_loss={loss:.4f}"
    lines.append(head)
    if not rows:
        lines.append("  (no telemetry-bearing sites)")
        return "\n".join(lines)
    lines.append(f"  {'site':<40s} {'dir':<8s} {'sat':>7s} {'uflow':>7s} "
                 f"{'snr_dB':>7s} {'drift_m':>8s} {'stale':>6s} "
                 f"{'rec':>5s}  flags")
    for r in rows[:top]:
        name = r["site"] + (f"[{r['layer']}]" if r["layer"] is not None
                            else "")
        lines.append(
            f"  {name:<40.40s} {r['dir']:<8s} {r['sat_frac']:>7.3f} "
            f"{r['uflow_frac']:>7.3f} {r['qsnr_db']:>7.1f} "
            f"{r['drift_m']:>8.3f} {r['staleness']:>6.0f} "
            f"{r['recommend']:>5s}  {','.join(r['flags']) or '-'}")
    worst = rows[0]
    if is_clean(worst):
        lines.append("  verdict: all sites healthy")
    else:
        wname = worst["site"] + (f"[{worst['layer']}]"
                                 if worst["layer"] is not None else "")
        lines.append(f"  verdict: worst site {wname}.{worst['dir']} "
                     f"({','.join(worst['flags'])}) — {worst['why']}")
    stale = [r for r in rows if "STALE" in r["flags"] or "COLD" in r["flags"]]
    if stale:
        names = ", ".join(
            f"{r['site']}.{r['dir']}" for r in stale[:5])
        lines.append(f"  stalest/cold: {names}"
                     + (" …" if len(stale) > 5 else ""))
    return "\n".join(lines)
