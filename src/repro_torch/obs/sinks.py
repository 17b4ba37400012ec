"""Pluggable metrics sinks (port of ``repro.obs.sinks``; no torch needed).

A sink consumes flat dict records.  Every record carries a ``kind``:

* ``"train_step"``  — TrainLoop per-step line: loss/lr plus span timings
  (``data_ms``/``step_ms``/``ckpt_ms``/``refresh_ms``).
* ``"site_health"`` — one StatsBank site-direction's telemetry snapshot
  (keys per :data:`repro_torch.obs.metrics.TELE_FIELDS` plus ``site``,
  ``dir``, ``staleness``, ``layer`` for segment sites).
* ``"event"``       — irregular happenings: watchdog trips, checkpoint
  saves.

The protocol is three methods — ``emit(record)``, ``flush()``,
``close()`` — so file formats, consoles and test doubles interchange.
:func:`make_sink` parses the CLI spec syntax (``jsonl:<path>``,
``csv:<path>``, ``console``, ``null``).
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, List, Optional

import numpy as np


class MetricsSink:
    """Base protocol; subclasses override :meth:`emit`."""

    def emit(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


def _to_py(v):
    """Host-side scalars for serialization (numpy scalars and 0-d tensors
    -> float/int)."""
    if isinstance(v, (np.generic,)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.item() if v.ndim == 0 else v.tolist()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v


def _clean(record: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _to_py(v) for k, v in record.items()}


class NullSink(MetricsSink):
    def emit(self, record: Dict[str, Any]) -> None:
        pass


class MemorySink(MetricsSink):
    """Buffers records in a list — test double and programmatic consumer."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def emit(self, record: Dict[str, Any]) -> None:
        self.records.append(_clean(record))

    def by_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("kind") == kind]


class JsonlSink(MetricsSink):
    """One JSON object per line, append mode — the default file sink."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def emit(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(_clean(record)) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class CsvSink(MetricsSink):
    """Single CSV whose header is the union of keys across all records
    (records buffer until :meth:`flush`/:meth:`close`, which rewrites the
    file — the column set is not knowable up front)."""

    def __init__(self, path: str):
        self.path = path
        self._records: List[Dict[str, Any]] = []

    def emit(self, record: Dict[str, Any]) -> None:
        self._records.append(_clean(record))

    def flush(self) -> None:
        if not self._records:
            return
        cols: List[str] = []
        for r in self._records:
            for k in r:
                if k not in cols:
                    cols.append(k)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols, restval="")
            w.writeheader()
            w.writerows(self._records)


class ConsoleSink(MetricsSink):
    """Human-oriented formatting through a ``print``-like callable.

    Reproduces TrainLoop's historical log lines (``step ... loss ...``)
    and watchdog warnings, so a loop with no explicit sink behaves as it
    always did."""

    def __init__(self, print_fn=print):
        self.print_fn = print_fn

    def emit(self, record: Dict[str, Any]) -> None:
        r = _clean(record)
        kind = r.get("kind")
        if kind == "train_step":
            self.print_fn(
                f"step {r['step']:5d} loss {r['loss']:.4f} "
                f"lr {r['lr']:.2e} t {r.get('step_ms', 0.0):.0f}ms")
        elif kind == "event" and r.get("event") == "watchdog":
            self.print_fn(
                f"[watchdog] step {r['step']} took {r['dt_s']:.3f}s "
                f"(median {r['median_s']:.3f}s) — straggler suspected")
        elif kind == "event" and r.get("event") == "checkpoint_saved":
            self.print_fn(
                f"[ckpt] step {r['step']} saved "
                f"(write {r.get('write_s', 0.0):.2f}s)")
        elif kind == "site_health":
            layer = f"[{r['layer']}]" if r.get("layer") is not None else ""
            self.print_fn(
                f"[obs] step {r['step']} {r['site']}{layer}.{r['dir']} "
                f"sat {r['sat_frac']:.3f} uflow {r['uflow_frac']:.3f} "
                f"snr {r['qsnr_db']:.1f}dB stale {r['staleness']:.0f}")
        else:
            body = " ".join(f"{k}={v}" for k, v in r.items() if k != "kind")
            self.print_fn(f"[{kind or 'metric'}] {body}")


class TeeSink(MetricsSink):
    """Fan one stream out to several sinks."""

    def __init__(self, *sinks: MetricsSink):
        self.sinks = list(sinks)

    def emit(self, record: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(record)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def make_sink(spec: Optional[str], print_fn=print) -> MetricsSink:
    """Parse a CLI sink spec: ``jsonl:<path>`` | ``csv:<path>`` |
    ``console`` | ``null`` (None -> NullSink)."""
    if spec is None or spec == "" or spec == "null":
        return NullSink()
    if spec == "console":
        return ConsoleSink(print_fn)
    if spec == "memory":
        return MemorySink()
    head, sep, rest = spec.partition(":")
    if head == "jsonl" and sep:
        return JsonlSink(rest)
    if head == "csv" and sep:
        return CsvSink(rest)
    raise ValueError(
        f"unknown metrics sink spec {spec!r} — expected jsonl:<path>, "
        f"csv:<path>, console, or null")
