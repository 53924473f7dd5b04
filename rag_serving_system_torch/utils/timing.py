"""Per-stage wall-time accumulation (the /stats and /metrics stage means),
and a device trace.

Counterpart of `rag_serving_system_tpu/utils/timing.py`: `StageTimer` is a
copy; `device_trace` runs `torch.profiler` where the JAX module runs
`jax.profiler`, and writes a Chrome trace. The module imports torch only
inside `device_trace`, so the API role can time stages without it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict

logger = logging.getLogger(__name__)


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


@contextlib.contextmanager
def device_trace(log_dir: str | None, device=None):
    """A `torch.profiler` trace of the block into `log_dir`; a no-op that
    yields None when `log_dir` is falsy. CPU activity always, CUDA activity
    on a CUDA `device` (`resolve_device`'s default: the card, which raises
    without one). Yields the profiler (its `events()` and `key_averages()`
    for the caller); the trace is written, and the profiler stopped, also
    when the block raises."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from rag_serving_system_torch.device import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("torch profiler trace written to %s", path)
