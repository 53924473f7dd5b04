"""The device trace of a `--trace 1` run: `torch.profiler` with CUDA activity
over the timed window, read in memory (nothing is written to disk).

From the kernels, copies and fills the card ran, it keeps: the busy time
(the union of their intervals), the time of each by name, and the idle
gaps between them, each named by the device operation that ended it.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

GAP_FLOOR_NS = 10_000     # shorter gaps are launch spacing, not waiting


@dataclass
class Trace:
    window_s: float
    busy_s: float
    n_ops: int
    by_name: dict = field(default_factory=dict)      # name -> (seconds, count)
    gaps: list = field(default_factory=list)         # [(label, seconds)] longest first
    t0: float = 0.0                                  # the traced window, host clock
    t1: float = 0.0

    def time_of(self, pattern: str) -> tuple:
        """(seconds, launches) of the device operations whose name matches."""
        rx = re.compile(pattern)
        s = n = 0
        for name, (sec, cnt) in self.by_name.items():
            if rx.search(name):
                s += sec
                n += cnt
        return s, n

    def lost(self, launched: dict) -> list:
        """[(pattern, traced, launched)] for each kernel-name pattern the
        trace holds fewer launches of than `launched` says were made."""
        out = []
        for pattern, n in launched.items():
            got = self.time_of(pattern)[1]
            if got < n:
                out.append((pattern, got, n))
        return out

    def top_ops(self, n: int = 10) -> list:
        return [[name[:200], sec] for name, (sec, _) in
                sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]]


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    @staticmethod
    def prime() -> None:
        """Start and stop the profiler once around a trivial launch: its
        first start sets up CUPTI, which took ~10 s on an H100 and would
        otherwise eat the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.time()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time()
        self.prof.stop()

    def read(self) -> Trace:
        """The summary of the device operations of the window."""
        from torch.autograd import DeviceType

        res = getattr(self.prof.profiler, "kineto_results", None)
        if res is not None:
            evs = [(e.start_ns(), e.duration_ns(), e.name()) for e in res.events()
                   if e.device_type() == DeviceType.CUDA]
        else:   # an older profiler: its parsed events
            evs = [(int(e.time_range.start * 1000), int((e.time_range.end - e.time_range.start) * 1000),
                    e.name) for e in self.prof.events() if e.device_type == DeviceType.CUDA]
        tr = summarize(evs, self.t1 - self.t0)
        tr.t0, tr.t1 = self.t0, self.t1
        return tr


def summarize(evs: list, window_s: float) -> Trace:
    """`evs`: (start_ns, duration_ns, name) of the device operations."""
    evs.sort()
    by_name = defaultdict(lambda: [0.0, 0])
    busy = 0
    cur_s = cur_e = None
    gaps = []
    for s, d, name in evs:
        e = s + d
        rec = by_name[name]
        rec[0] += d * 1e-9
        rec[1] += 1
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            if s - cur_e >= GAP_FLOOR_NS:
                gaps.append((s - cur_e, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    return Trace(window_s=window_s, busy_s=busy * 1e-9, n_ops=len(evs),
                 by_name={k: (v[0], v[1]) for k, v in by_name.items()},
                 gaps=[[f"host work before {name[:160]}", g * 1e-9] for g, name in gaps[:10]])
