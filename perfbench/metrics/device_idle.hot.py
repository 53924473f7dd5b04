"""Share of the traced window in which no kernel, copy or fill ran on the card."""

from perfbench import readers

LAYER = "device"
SOURCE = "device_trace"
MOVES = "latency_p95_s"
UNIT = "%"


def read(run):
    return readers.idle_pct(run)
