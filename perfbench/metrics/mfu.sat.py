"""The whole model step's share of the card's bf16 peak (989 TFLOP/s, in both configurations): model FLOPs of the requests answered in the window over its length."""

from perfbench import readers

LAYER = "model step (models/e5.py and models/qwen2.py)"
SOURCE = "host_clock"
MOVES = "throughput_rps"
UNIT = "%"


def read(run):
    return readers.model_flops_pct(run)
