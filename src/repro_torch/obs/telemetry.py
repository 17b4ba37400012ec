"""The telemetry view of a telemetry-enabled StatsBank and its host-side
drain into sink records (port of ``repro.obs.telemetry``).

The health metrics (:mod:`repro_torch.obs.metrics`) live as extra leaves
of the bank's site states, recomputed on refresh.
:func:`telemetry_state` is a pure elementwise extraction of those leaves
(plus derived staleness), so it adds no reduction to a step.  The
reference ships that state to the host every step (``io_callback``) and
forwards it every ``every`` steps; here the train step asks
:meth:`Telemetry.due` first and reads the device only on the steps it
forwards (one transfer of every leaf), which sends the same records.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.sinks import MetricsSink


def telemetry_state(bank: Dict[str, Any], step) -> Dict[str, Any]:
    """Extract ``{site: {dir: {metric: leaf}}}`` from a bank.  Purely
    elementwise (zero reductions).  Sites without telemetry leaves are
    skipped; the result is ``{}`` for a telemetry-off bank.  ``staleness``
    is steps since the direction's last refresh (-1 = never refreshed)."""
    step_f = float(step)
    out: Dict[str, Any] = {}
    for site, entry in bank.items():
        dirs = {}
        for d, st in entry.items():
            if not obs_metrics.has_telemetry(st):
                continue
            rec = {f: st[f] for f in obs_metrics.TELE_FIELDS}
            rec["staleness"] = torch.where(st["last"] >= 0,
                                           step_f - st["last"], -1.0)
            rec["alpha"] = st["alpha"]
            rec["beta"] = st["beta"]
            dirs[d] = rec
        if dirs:
            out[site] = dirs
    return out


def to_host(state: Dict[str, Any]) -> Dict[str, Any]:
    """``state`` with every leaf a numpy array, read from the device in
    one transfer."""
    keys = [(s, d, k) for s in state for d in state[s] for k in state[s][d]]
    if not keys:
        return {}
    leaves = [state[s][d][k] for s, d, k in keys]
    flat = torch.cat([v.reshape(-1).float() for v in leaves]).cpu().numpy()
    out: Dict[str, Any] = {}
    i = 0
    for (s, d, k), v in zip(keys, leaves):
        out.setdefault(s, {}).setdefault(d, {})[k] = \
            flat[i:i + v.numel()].reshape(tuple(v.shape))
        i += v.numel()
    return out


def state_records(state: Dict[str, Any], step: int
                  ) -> Iterator[Dict[str, Any]]:
    """Flatten a host-side telemetry state into ``"site_health"`` sink
    records — one per site-direction, or one per layer row for segment
    sites ([L]-shaped leaves)."""
    for site in sorted(state):
        for d in sorted(state[site]):
            rec = state[site][d]
            leaf = np.asarray(rec["staleness"])
            if leaf.ndim == 0:
                yield {"kind": "site_health", "step": step, "site": site,
                       "dir": d, "layer": None,
                       **{k: float(np.asarray(v)) for k, v in rec.items()}}
            else:
                for i in range(leaf.shape[0]):
                    yield {"kind": "site_health", "step": step, "site": site,
                           "dir": d, "layer": i,
                           **{k: float(np.asarray(v)[i])
                              for k, v in rec.items()}}


class Telemetry:
    """Host endpoint of the telemetry drain: forwards a step's records to
    the sink every ``every`` steps (telemetry values only change on
    refresh steps, so ``every`` is typically the bank's
    ``refresh_every``)."""

    def __init__(self, sink: MetricsSink, every: int = 1):
        if every < 1:
            raise ValueError("Telemetry every must be >= 1")
        self.sink = sink
        self.every = int(every)

    def due(self, step) -> bool:
        return int(step) % self.every == 0

    def drain(self, state: Dict[str, Any], step) -> None:
        step_i = int(step)
        if not self.due(step_i):
            return
        for rec in state_records(to_host(state), step_i):
            self.sink.emit(rec)

    def flush(self) -> None:
        self.sink.flush()
