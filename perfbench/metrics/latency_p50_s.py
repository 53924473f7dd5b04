"""The 50th percentile of the latency of every request due in the window,
from when it was due to when its answer came (a failed request at the time
it failed), by linear interpolation between order statistics."""

from perfbench import readers

LAYER = None
SOURCE = "host_clock"
MOVES = None
UNIT = "s"


def read(run):
    win = run.window_records()
    return readers.percentile([r["done"] - r["due"] for r in win], 0.50) if win else None
