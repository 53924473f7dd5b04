"""A decode step, after the prefill's first host read to the loop's end: the stage timer's decode over the window, mean a step."""

from perfbench import readers

LAYER = "engine stage 2 (core/engine.py generate_tokens: models/qwen2.py)"
SOURCE = "program_span"
MOVES = "throughput_rps"
UNIT = "ms"


def read(run):
    return readers.stage_mean_ms(run, "decode")
