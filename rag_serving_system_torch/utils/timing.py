"""Per-stage wall-time accumulation (the /stats and /metrics stage means), a
span log on the profiler's clock, and a device trace.

Counterpart of `rag_serving_system_tpu/utils/timing.py`: `device_trace` runs
`torch.profiler` where the JAX module runs `jax.profiler`, and writes a
Chrome trace. The module imports torch only inside the functions that read
a trace, so the API role can time stages without it.

**The clock.** Every span is stamped with `time.time_ns()`, the clock in
which `torch.profiler` (kineto) stamps its host events: the spans, the
operators and the runtime's launch calls of one trace lie on one time axis.

**The totals.** `totals` and `counts` (one entry a stage name) are always
kept: `/stats`, `/metrics` and the benchmark's window snapshots read them.
A count is a call, except where the caller counts steps (`add(..., n=)`):
`decode` counts its decode steps, so its mean is a step's.

**The log.** While a `torch.profiler` session is active, every span is
also put in a bounded log (`spans`, the newest `SPAN_LOG_SIZE`) as
`(name, thread, start_ns, end_ns, id, parent)`: `id` is the request id of a
per-request span (`http`, `queue_wait`) and the batch number of a per-batch
one; `parent` is the innermost span open on the same thread when it was
recorded. `batch_log` maps each batch number to its request ids. Without a
profiler a span pays one check of a module flag and no log entry.

**The device's stamps** (CUPTI's) are meant to lie on that axis too, and
in some sessions do not: on an H100 they were stamped milliseconds before
their own launch calls, or ran 12% fast against the host for seconds and
then jumped back by 0.4 s. `clock_ok` checks a trace by its own evidence
(every device op at or after its own launch call, matched by correlation
id); `host_shifts` finds each op's place on the host's axis by the launch
calls, and `device_trace` moves each idle gap there (keeping the length the
device measured) before it puts the gaps down to the spans.

The spans the port records, and where (the innermost first):

| stage | thread | count | what |
|---|---|---|---|
| `http` | the event loop | a request | `POST /rag`'s own time: accept to enqueued, and result stored to response |
| `queue_wait` | stage 1 | a request | enqueued to dequeued |
| `embed_retrieve` | stage 1 | a call | encode, retrieve, prompt build |
| `generate` | stage 2 | a batch | `generate_tokens`, its children below |
| `stage_prompts` | stage 2 (or 1) | a batch | tokenizing, prefix split, padding, the copies to the device |
| `prefix_resolve` | stage 2 | a batch | cache lookups, B2 on the misses (host time: ends unsynced) |
| `prefill` | stage 2 | a batch | first prefill launch to the decode loop's first host read of `done` |
| `decode` | stage 2 | a step | from there to the loop's end |
| `decode_replay` | stage 2 | a step | the `decode` span again where its steps were CUDA graph replays |
| `decode_capture` | stage 2 | a capture | a decode step's warm-up run and graph capture, inside `decode` |
| `finalize` | stage 3 | a batch | the token copy to the host, detokenizing |
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Dict

logger = logging.getLogger(__name__)

SPAN_LOG_SIZE = 1 << 16
GAP_FLOOR_NS = 10_000        # shorter idle gaps are launch spacing, not waiting
NO_BATCH = "no batch ready"
GENERATE_SELF = "generate (self)"


def profiler_active() -> bool:
    """Whether a `torch.profiler` session is running in this process (any
    thread). Reads torch's module flag; never imports torch."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None and getattr(prof, "_is_profiler_enabled", False))


# A CUDA graph launch and a `torch.profiler` session's set-up, start or
# stop exclude each other (`guard_profiler`). On an H100 (torch 2.11, CUDA
# 12.8) a graph launched on one thread while another stopped a profiler
# deadlocked, the stopping thread holding the interpreter lock: at the first
# or second stop of 80, replays on the default stream or on a stream of
# their own alike; serialized, 80 of 80 stops ran through.
GRAPH_LAUNCH_LOCK = threading.Lock()
_GUARD_ONCE = threading.Lock()


def guard_profiler() -> None:
    """Make the three calls into the profiler's core that set a session up,
    start and stop it (`torch.autograd.profiler._prepare_profiler`,
    `_enable_profiler`, `_disable_profiler`, which every `torch.profiler`
    session makes, whoever runs it) hold GRAPH_LAUNCH_LOCK; once a
    process. Code that launches CUDA graphs calls it, and holds the lock
    across each launch and capture."""
    with _GUARD_ONCE:
        import torch.autograd.profiler as ap

        if getattr(ap, "_graph_launch_guarded", False):
            return

        def guarded(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                with GRAPH_LAUNCH_LOCK:
                    return fn(*args, **kwargs)
            return call

        for name in ("_prepare_profiler", "_enable_profiler", "_disable_profiler"):
            setattr(ap, name, guarded(getattr(ap, name)))
        ap._graph_launch_guarded = True


class StageTimer:
    """Accumulates wall-time per named stage, and logs spans while a
    profiler runs. Lock-guarded: the prefetch worker, the processor thread,
    the finalize worker and the HTTP loop record concurrently."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.spans: deque = deque(maxlen=SPAN_LOG_SIZE)
        self.batch_log: deque = deque(maxlen=SPAN_LOG_SIZE)
        self._lock = threading.Lock()
        self._local = threading.local()     # .stack (open stage names), .batch
        self._numbers = itertools.count(1)

    def _open(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name, seconds, n, start_ns, end_ns, id) -> None:
        entry = None
        if profiler_active():
            stack = self._open()
            entry = (name, threading.current_thread().name, start_ns, end_ns,
                     getattr(self._local, "batch", None) if id is None else id,
                     stack[-1] if stack else None)
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += n
            if entry is not None:
                self.spans.append(entry)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block as one call of stage `name`."""
        stack = self._open()
        t0 = time.time_ns()
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()
            t1 = time.time_ns()
            self._record(name, (t1 - t0) * 1e-9, 1, t0, t1, None)

    def add(self, name: str, seconds: float, n: int = 1, *, start_ns: int,
            id=None) -> None:
        """A span measured by the caller (across threads, or a loop of `n`
        steps): `seconds` and `n` join the totals; the logged interval is
        `seconds` long from `start_ns`."""
        self._record(name, seconds, n, start_ns, start_ns + round(seconds * 1e9), id)

    def number(self, request_ids) -> int:
        """A new batch number, logged with its request ids."""
        number = next(self._numbers)
        if profiler_active():
            with self._lock:
                self.batch_log.append((number, tuple(request_ids)))
        return number

    @contextlib.contextmanager
    def batch(self, number: int):
        """Tag this thread's spans in the block with batch `number`."""
        prev = getattr(self._local, "batch", None)
        self._local.batch = number
        try:
            yield
        finally:
            self._local.batch = prev

    def window(self, start_ns: int, end_ns: int) -> list:
        """The logged spans that overlap [start_ns, end_ns]."""
        with self._lock:
            logged = list(self.spans)
        return [s for s in logged if s[3] >= start_ns and s[2] <= end_ns]

    def reset(self) -> None:
        """Drop accumulated timings (after warmup)."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.spans.clear()
            self.batch_log.clear()

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "total_s": self.totals[name],
                    "count": self.counts[name],
                    "mean_s": self.totals[name] / max(self.counts[name], 1),
                }
                for name in list(self.totals)
            }


# ---------------------------------------------------------------------------
# idle gaps, put down to spans
# ---------------------------------------------------------------------------

def _union(intervals) -> list:
    """Sorted disjoint [start, end) of the intervals' union."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost_timeline(spans: list) -> list:
    """[(start, end, label)] over the spans of one thread: the innermost
    open span's name (the latest started; `generate` as `GENERATE_SELF`),
    and `NO_BATCH` where none is open."""
    cuts = sorted({t for s in spans for t in (s[2], s[3])})
    out: list = []
    if not cuts:
        return out
    by_start = sorted(spans, key=lambda s: (s[2], -s[3]))
    i, active = 0, []
    for a, b in zip(cuts, cuts[1:]):
        while i < len(by_start) and by_start[i][2] <= a:
            active.append(by_start[i])
            i += 1
        active = [s for s in active if s[3] > a]
        if active:
            name = max(active, key=lambda s: (s[2], -s[3]))[0]
            label = GENERATE_SELF if name == "generate" else name
        else:
            label = NO_BATCH
        if out and out[-1][2] == label and out[-1][1] == a:
            out[-1] = (out[-1][0], b, label)
        else:
            out.append((a, b, label))
    return out


def _overlaps(pieces: list, intervals: list):
    """Yield (piece index, overlap ns) of sorted disjoint `pieces` (start,
    end, ...) with sorted disjoint `intervals`."""
    j = 0
    for i, (a, b, *_rest) in enumerate(pieces):
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            ov = min(b, intervals[k][1]) - max(a, intervals[k][0])
            if ov > 0:
                yield i, ov
            k += 1


def idle_by_span(device_ops, spans, shifts) -> dict:
    """The device's idle gaps put down to the host's spans.

    `device_ops`: (start_ns, duration_ns, ...) of the kernels, copies and
    fills of a trace; `spans`: the span log of the same window
    (`StageTimer.window`); `shifts`: each op's device stamp less its time on
    the host's clock (`host_shifts`).
    Every gap of at least `GAP_FLOOR_NS` between the ops' busy intervals,
    as long as the device measured it, is moved by the shift of the op that
    ends it, cut at the span boundaries of the stage-2 thread (the thread that logs
    `generate`) and each piece is put down to the innermost span open there:
    `generate (self)` between its children, `no batch ready` outside it.

    Returns {"idle_s": the gaps' seconds, "gaps": their count, "by_span":
    {label: seconds}, "beside": {label: {name: seconds}}}: under each label,
    the seconds of those pieces in which a span of that name was open on
    another thread (a union over its spans, so 32 overlapping `queue_wait`
    spans count once)."""
    busy = _union((op[0], op[0] + op[1]) for op in device_ops)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] - a[1] >= GAP_FLOOR_NS]
    shift_at = {op[0]: sh for op, sh in zip(device_ops, shifts)}
    gaps = sorted((a - shift_at[b], b - shift_at[b]) for a, b in gaps)
    stage2 = {s[1] for s in spans if s[0] == "generate"}
    timeline = _innermost_timeline([s for s in spans if s[1] in stage2])
    # the gaps cut at the timeline's boundaries; before or after it: no batch
    pieces: list = []
    j = 0
    for a, b in gaps:
        t = a
        while j < len(timeline) and timeline[j][1] <= t:
            j += 1
        k = j
        while t < b:
            if k >= len(timeline) or timeline[k][0] >= b:
                pieces.append((t, b, NO_BATCH))
                break
            s, e, label = timeline[k]
            if t < s:
                pieces.append((t, s, NO_BATCH))
                t = s
            end = min(b, e)
            pieces.append((t, end, label))
            t = end
            k += 1
    by_span: dict = defaultdict(int)
    for a, b, label in pieces:
        by_span[label] += b - a
    beside: dict = defaultdict(lambda: defaultdict(int))
    others: dict = defaultdict(list)
    for s in spans:
        if s[1] not in stage2:
            others[s[0]].append((s[2], s[3]))
    for name, ivs in others.items():
        for i, ov in _overlaps(pieces, _union(ivs)):
            beside[pieces[i][2]][name] += ov
    return {"idle_s": sum(b - a for a, b in gaps) * 1e-9, "gaps": len(gaps),
            "by_span": {k: v * 1e-9 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
            "beside": {k: {n: v * 1e-9 for n, v in sorted(d.items(), key=lambda kv: -kv[1])}
                       for k, d in beside.items()}}


ALIGN_WINDOW = 2    # anchors on either side whose least lag shifts an op


def clock_ok(ops) -> bool | None:
    """Whether a trace's device stamps lie on the host's clock, by the
    trace's own evidence: no device op stamped before its own launch call.
    `ops`: (start_ns, duration_ns, launch_ns or None) of the device ops.
    True without device ops; None where no op's launch call is traced."""
    if not ops:
        return True
    matched = [(t, call) for t, _, call in ops if call is not None]
    if not matched:
        return None
    return all(t >= call for t, call in matched)


def host_shifts(ops):
    """Each device op's stamp less its time on the host's clock, in ns.

    In launch order (the host's stamps: the order one stream runs them in),
    an op that starts on an idle device is an anchor: it ran when its launch
    call came, so its lag (device stamp less launch call) is the clock's
    offset there plus a few microseconds of launch latency. An anchor's
    shift is the least lag among the `ALIGN_WINDOW` anchors on either side
    (an op that waited for something besides its launch lags more), and a
    queued op takes its anchor's. A device stamp earlier than the one before it in
    launch order is the clock jumping back: a new run of anchors starts
    there. An op without a traced launch call takes the shift of the op next
    to it on the device. `ops`: as `read_trace` gives them. [] without
    device ops; None where no launch call is traced."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    if not ops:
        return []
    start = np.array([o[0] for o in ops], dtype=np.int64)
    dur = np.array([o[1] for o in ops], dtype=np.int64)
    call = np.array([-1 if o[2] is None else o[2] for o in ops], dtype=np.int64)
    matched = np.flatnonzero(call >= 0)
    if not len(matched):
        return None
    order = matched[np.argsort(call[matched], kind="stable")]
    d, lag = start[order] - start.min(), start[order] - call[order]
    run = np.concatenate([[0], np.cumsum(d[1:] < d[:-1])])       # jumps back
    # the latest end of the earlier ops of the same run (runs made monotone)
    lift = run << 40
    ends = np.maximum.accumulate(d + dur[order] + lift) - lift
    anchor = np.concatenate([[True], (d[1:] > ends[:-1]) | (run[1:] != run[:-1])])
    a = np.flatnonzero(anchor)
    far = np.iinfo(np.int64).max
    w = ALIGN_WINDOW
    pad = lambda x, v: np.concatenate([np.full(w, v), x, np.full(w, v)])  # noqa: E731
    lags = sliding_window_view(pad(lag[a], far), 2 * w + 1)
    runs = sliding_window_view(pad(run[a], -1), 2 * w + 1)
    a_shift = np.where(runs == run[a][:, None], lags, far).min(axis=1)
    shift = np.zeros(len(ops), dtype=np.int64)
    shift[order] = a_shift[np.cumsum(anchor) - 1]
    unmatched = np.flatnonzero(call < 0)
    if len(unmatched):
        by_start = matched[np.argsort(start[matched], kind="stable")]
        k = np.searchsorted(start[by_start], start[unmatched]).clip(0, len(by_start) - 1)
        shift[unmatched] = shift[by_start[k]]
    return shift.tolist()


def read_trace(prof) -> list:
    """(start_ns, duration_ns, launch_ns or None) of every CUDA-typed event
    (kernels, copies, fills) of a stopped `torch.profiler` session:
    `launch_ns` is the start of the CUDA API call of its
    correlation id."""
    from torch.autograd import DeviceType

    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        return []
    evs = res.events()
    calls = {e.correlation_id(): e.start_ns() for e in evs
             if e.device_type() == DeviceType.CPU and e.correlation_id()
             and e.name().startswith("cu")}
    return [(e.start_ns(), e.duration_ns(), calls.get(e.correlation_id()))
            for e in evs if e.device_type() == DeviceType.CUDA]


def _add_host_tracks(path: str, spans: list, batches: list) -> None:
    """Put the spans into a written Chrome trace as host tracks, one a
    thread, under a process of their own."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    ids = dict(batches)
    evs = trace.setdefault("traceEvents", [])
    evs.append({"ph": "M", "name": "process_name", "pid": "spans", "args": {"name": "spans"}})
    for name, thread, t0, t1, sid, parent in spans:
        args = {"id": str(sid), "parent": parent}
        if sid in ids:
            args["requests"] = list(ids[sid])
        evs.append({"ph": "X", "cat": "span", "name": name, "pid": "spans", "tid": thread,
                    "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3, "args": args})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir: str | None, device=None, spans: StageTimer | None = None):
    """A `torch.profiler` trace of the block into `log_dir`; a no-op that
    yields None when `log_dir` is falsy. CPU activity always, CUDA activity
    on a CUDA `device` (`resolve_device`'s default: the card, which raises
    without one). Yields the profiler (its `events()` and `key_averages()`
    for the caller); the trace is written, and the profiler stopped, also
    when the block raises.

    The profiler is left with `prof.clock_ok` (`clock_ok` of the trace).
    With `spans` (a `StageTimer`), the spans it logged during the trace
    become host tracks of the written trace, and the device's idle gaps,
    moved onto the host's clock (`host_shifts`), are put down to them
    (`idle_by_span`), logged and left as `prof.idle_by_span`: None where no
    launch call was traced to place them by."""
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
    t0 = time.time_ns()
    try:
        yield prof
    finally:
        t1 = time.time_ns()
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        ops = read_trace(prof)
        prof.clock_ok = clock_ok(ops)
        if not prof.clock_ok:
            logger.warning("the trace's device stamps are off the host clock (clock_ok=%s)",
                           prof.clock_ok)
        if spans is not None:
            window = spans.window(t0, t1)
            with spans._lock:
                batches = list(spans.batch_log)
            _add_host_tracks(path, window, batches)
            shifts = host_shifts(ops)
            prof.idle_by_span = None if shifts is None else idle_by_span(ops, window, shifts)
            logger.info("idle gaps by span: %s", json.dumps(prof.idle_by_span))
        logger.info("torch profiler trace written to %s", path)
