"""Per-step wall-clock timing (port of utils/profiling.py's StepTimer and
PhaseTimer).

:class:`StepTimer` keeps step durations after ``warmup`` steps and reports
p50/p90/mean in ms. The caller makes a timed step end with the device work
done (the trainer reads the loss). ``skip_next`` drops samples the fixed
warm-up cannot foresee: under chained dispatch, the first step a run
dispatches alone. :class:`PhaseTimer` splits a step's wall time into named
host phases (the trainers' ``SD_TRAIN_PROFILE=1``).
"""

from __future__ import annotations

import contextlib
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


class PhaseTimer:
    """Per-step wall time by named phase: each name keeps its samples after
    its own first ``warmup``; ``skip_next(name)`` drops the next samples of
    one name. The trainers' phases under ``SD_TRAIN_PROFILE=1`` are
    ``fetch`` (the loader), ``place`` (to the device), ``dispatch`` (the
    step's launches, or a graph's replays) and ``sync`` (the pull that waits
    for the device); ``summary_ms`` -> ``{name}_ms_p50`` and
    ``{name}_ms_mean`` of each."""

    def __init__(self, warmup: int = 2):
        self.samples: Dict[str, List[float]] = {}
        self.warmup = warmup
        self._seen: Dict[str, int] = {}
        self._skip: Dict[str, int] = {}

    def add(self, name: str, dt: float) -> None:
        if self._skip.get(name, 0) > 0:
            self._skip[name] -= 1
            return
        self._seen[name] = self._seen.get(name, 0) + 1
        if self._seen[name] > self.warmup:
            self.samples.setdefault(name, []).append(dt)

    def skip_next(self, name: str, n: int = 1) -> None:
        """Drop the next ``n`` samples of ``name``."""
        self._skip[name] = self._skip.get(name, 0) + n

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def timed_iter(self, iterable, name: str = "fetch"):
        """Yield from ``iterable``, each ``next()`` a sample of ``name``."""
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.add(name, time.perf_counter() - t0)
            yield item

    def summary_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, xs in sorted(self.samples.items()):
            s = sorted(xs)
            out[f"{name}_ms_p50"] = s[len(s) // 2] * 1e3
            out[f"{name}_ms_mean"] = sum(xs) / len(xs) * 1e3
        return out
