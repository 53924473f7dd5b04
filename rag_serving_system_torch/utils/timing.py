"""Per-stage wall-time accumulation (the /stats and /metrics stage means).

A copy of `StageTimer` from `rag_serving_system_tpu/utils/timing.py`; that
module's `device_trace` (a `jax.profiler` context) is not carried over, as
nothing in the port calls it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    """Accumulates wall-time per named stage. Lock-guarded: the prefetch
    worker and the processor thread time stages concurrently."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
                self.last[name] = dt

    def reset(self) -> None:
        """Drop accumulated timings (after warmup)."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.last.clear()

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
                "last_s": self.last.get(name, 0.0),
            }
            for name in self.totals
        }
