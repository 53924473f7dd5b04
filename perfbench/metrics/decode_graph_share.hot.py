"""The decode steps replayed from a captured CUDA graph, over all decode steps in the window: 100 x the stage timer's decode_replay count over its decode count (both counted in steps). None where the program records no decode_replay."""

LAYER = "engine stage 2 (core/engine.py generate_tokens: models/qwen2.py)"
SOURCE = "program_span"
MOVES = "latency_p50_s"
UNIT = "%"


def _steps(snap, stage):
    return snap["stages"].get(stage, (0.0, 0))[1]


def read(run):
    if "decode_replay" not in run.snap1["stages"]:
        return None
    steps = _steps(run.snap1, "decode") - _steps(run.snap0, "decode")
    replayed = _steps(run.snap1, "decode_replay") - _steps(run.snap0, "decode_replay")
    return 100.0 * replayed / steps if steps > 0 else None
