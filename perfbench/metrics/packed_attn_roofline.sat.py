"""Packed prefill attention's (B3) share of its roofline: the least time of its traced launches (q, k, v and o of the real tokens, causal pairs within each prompt) over their device time."""

from perfbench import readers

LAYER = "kernels (ops/*.py over csrc/*.cu)"
SOURCE = "device_trace"
MOVES = "throughput_rps"
UNIT = "%"


def read(run):
    return readers.packed_attn_roofline_pct(run)
