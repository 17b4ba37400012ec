"""Straggler detection for the training loop (port of
``repro.training.fault``).

The resilience layer's other parts: the in-step sentinels and the
snapshot ring (``training/guard.py``), the escalation ladder
(``training/trainer.py``, ``TrainLoop``), hardened checkpoint I/O
(``checkpoint/manager.py``) and fault injection (``training/chaos.py``).
This module keeps the host-side straggler detector the loop feeds with
per-step wall times.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional


class Watchdog:
    """Per-step wall-time straggler detector.

    ``observe(step, dt)`` compares ``dt`` against ``factor`` times the
    median of the trailing ``window`` step times seen BEFORE this step
    (the current step must not dilute its own baseline), once at least
    ``min_history`` steps have accumulated.  Returns an event dict
    (``dt_s`` / ``median_s`` / ``factor``) on a trip, None otherwise —
    TrainLoop forwards trips to its metrics sink as ``"watchdog"``
    events (and, with ``watchdog_escalate_after``, escalates N
    consecutive trips into a proactive snapshot).  Trips are recorded in
    ``events`` for post-hoc inspection.

    ``times`` is a bounded deque (maxlen ``window``): the baseline only
    ever needs the trailing window.  The even-window median is the true
    midpoint average, not the upper-middle element.
    """

    def __init__(self, factor: float = 3.0, window: int = 32,
                 min_history: int = 8):
        if factor <= 0:
            raise ValueError("watchdog factor must be > 0")
        if window < 1:
            raise ValueError("watchdog window must be >= 1")
        self.factor = float(factor)
        self.window = int(window)
        # the deque caps history at window, so a larger min_history would
        # never be reached — clamp it
        self.min_history = min(int(min_history), self.window)
        self.times: Deque[float] = deque(maxlen=self.window)
        self.events: List[Dict[str, float]] = []

    def observe(self, step: int, dt: float) -> Optional[Dict[str, float]]:
        event = None
        if len(self.times) >= self.min_history:
            trail = sorted(self.times)      # already capped at window
            n = len(trail)
            if n % 2:
                med = trail[n // 2]
            else:
                med = 0.5 * (trail[n // 2 - 1] + trail[n // 2])
            if dt > self.factor * med:
                event = {"step": step, "dt_s": float(dt),
                         "median_s": float(med), "factor": self.factor}
                self.events.append(event)
        self.times.append(float(dt))
        return event
