"""Per-step wall-clock timing (port of utils/profiling.py's StepTimer).

:class:`StepTimer` keeps step durations after ``warmup`` steps and reports
p50/p90/mean in ms. The caller makes a timed step end with the device work
done (the trainer reads the loss). ``skip_next`` drops samples the fixed
warm-up cannot foresee: under chained dispatch, the first step a run
dispatches alone.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class StepTimer:
    def __init__(self, warmup: int = 1):
        self.durations: List[float] = []
        self.warmup = warmup
        self._seen = 0
        self._skip = 0
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.add(time.perf_counter() - self._t0)

    def add(self, dt: float) -> None:
        if self._skip:
            self._skip -= 1
            return
        self._seen += 1
        if self._seen > self.warmup:
            self.durations.append(dt)

    def skip_next(self, n: int = 1) -> None:
        """Drop the next ``n`` samples."""
        self._skip += n

    def percentile(self, q: float) -> float:
        if not self.durations:
            return float("nan")
        xs = sorted(self.durations)
        return xs[min(int(len(xs) * q / 100.0), len(xs) - 1)]

    def summary_ms(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        return {
            "step_ms_p50": self.percentile(50) * 1e3,
            "step_ms_p90": self.percentile(90) * 1e3,
            "step_ms_mean": sum(self.durations) / len(self.durations) * 1e3,
        }
