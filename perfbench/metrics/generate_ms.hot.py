"""Stage 2 a batch (prefix resolve, prefill, decode): the processor's stage timer generate over the window, mean a batch."""

from perfbench import readers

LAYER = "engine stage 2 (core/engine.py generate_tokens: models/qwen2.py)"
SOURCE = "program_span"
MOVES = "latency_p95_s"
UNIT = "ms"


def read(run):
    return readers.stage_mean_ms(run, "generate")
