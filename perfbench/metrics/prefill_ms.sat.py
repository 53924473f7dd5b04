"""The prefill a batch, first launch to the decode loop's first host read: the stage timer's prefill over the window, mean a batch."""

from perfbench import readers

LAYER = "engine stage 2 (core/engine.py generate_tokens: models/qwen2.py)"
SOURCE = "program_span"
MOVES = "throughput_rps"
UNIT = "ms"


def read(run):
    return readers.stage_mean_ms(run, "prefill")
