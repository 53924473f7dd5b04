"""Stage 1 a batch (encode, retrieve, build prompts): the stage timer's embed_retrieve over the window, mean a call."""

from perfbench import readers

LAYER = "engine stage 1 (core/engine.py prepare: models/e5.py, ops/topk.py)"
SOURCE = "program_span"
MOVES = "throughput_rps"
UNIT = "ms"


def read(run):
    return readers.stage_mean_ms(run, "embed_retrieve")
