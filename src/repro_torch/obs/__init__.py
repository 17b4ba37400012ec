"""Numerics observability (port of ``repro.obs``): per-site FP8 health
metrics riding the StatsBank refresh, pluggable metrics sinks, and the
telemetry drain.

Import layering (``core/statsbank.py`` imports
``repro_torch.obs.metrics``, so nothing here may import statsbank):

* :mod:`repro_torch.obs.metrics`   — metric math + telemetry leaves
* :mod:`repro_torch.obs.sinks`     — MetricsSink protocol + jsonl/csv/console
* :mod:`repro_torch.obs.telemetry` — telemetry state extraction + drain
* :mod:`repro_torch.obs.doctor`    — bank health reports (imports
  statsbank; import it directly, not through this package root)
"""
from repro_torch.obs.metrics import (TELE_FIELDS, ensure_telemetry,
                                     has_telemetry, init_tele_state,
                                     strip_telemetry)
from repro_torch.obs.sinks import (ConsoleSink, CsvSink, JsonlSink,
                                   MemorySink, MetricsSink, NullSink,
                                   TeeSink, make_sink)
from repro_torch.obs.telemetry import (Telemetry, state_records,
                                       telemetry_state)

__all__ = [
    "TELE_FIELDS", "ensure_telemetry", "has_telemetry", "init_tele_state",
    "strip_telemetry", "ConsoleSink", "CsvSink", "JsonlSink", "MemorySink",
    "MetricsSink", "NullSink", "TeeSink", "make_sink", "Telemetry",
    "state_records", "telemetry_state",
]
