"""POST /rag's own time in the handler (accept to enqueued, result stored to response): the stage timer's http over the window, mean a request."""

from perfbench import readers

LAYER = "HTTP"
SOURCE = "program_span"
MOVES = "latency_p50_s"
UNIT = "ms"


def read(run):
    return readers.stage_mean_ms(run, "http")
