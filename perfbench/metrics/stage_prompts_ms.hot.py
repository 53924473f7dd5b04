"""Prompt staging a batch (tokenizing, the prefix split, padding, the copies to the card): the stage timer's stage_prompts over the window, mean a batch."""

from perfbench import readers

LAYER = "engine stage 2 (core/engine.py generate_tokens: models/qwen2.py)"
SOURCE = "program_span"
MOVES = "latency_p95_s"
UNIT = "ms"


def read(run):
    return readers.stage_mean_ms(run, "stage_prompts")
