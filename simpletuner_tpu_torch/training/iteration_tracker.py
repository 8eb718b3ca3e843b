"""Rolling iteration-rate tracking → ETA for progress events.

Reference: helpers/training/iteration_tracker.py:11-60 ``IterationTracker``
(monotonic per-step durations, rolling rate windows of 5/15/30/60 minutes,
used by trainer.py:6380,6856 to compute progress/ETA webhook payloads).

The torch port's own copy of ``simpletuner_tpu/training/iteration_tracker.py``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

_WINDOWS = (300, 900, 1800, 3600)  # seconds


class IterationTracker:
    def __init__(self, max_window: int = 3600):
        self.max_window = max_window
        self._events: deque = deque()  # (monotonic_ts, duration_s)
        self._last: Optional[float] = None

    def record_step(self) -> None:
        now = time.monotonic()
        if self._last is not None:
            self._events.append((now, now - self._last))
        self._last = now
        cutoff = now - self.max_window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rate(self, window_seconds: int = 300) -> Optional[float]:
        """Iterations/second over the trailing window; None until 2 steps seen."""
        if not self._events:
            return None
        now = time.monotonic()
        cutoff = now - window_seconds
        durations = [d for ts, d in self._events if ts >= cutoff]
        if not durations:
            durations = [self._events[-1][1]]
        total = sum(durations)
        return len(durations) / total if total > 0 else None

    def rates(self) -> Dict[str, Optional[float]]:
        return {f"{w // 60}m": self.rate(w) for w in _WINDOWS}

    def eta_seconds(self, remaining_steps: int, window_seconds: int = 900) -> Optional[float]:
        rate = self.rate(window_seconds) or self.rate(300)
        if not rate or remaining_steps <= 0:
            return None
        return remaining_steps / rate
