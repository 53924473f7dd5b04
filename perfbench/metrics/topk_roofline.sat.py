"""Retrieval's share of its roofline: the least time of the traced top-k calls (B1 over a float32 corpus, B4 over an int8 one: the corpus read once at 3.35 TB/s) over the device time of their kernels."""

from perfbench import readers

LAYER = "kernels (ops/*.py over csrc/*.cu)"
SOURCE = "device_trace"
MOVES = "throughput_rps"
UNIT = "%"


def read(run):
    return readers.topk_roofline_pct(run)
