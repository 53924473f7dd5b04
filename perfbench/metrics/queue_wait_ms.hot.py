"""A request's wait in the queue, enqueue to dequeue by stage 1: the stage timer's queue_wait over the window, mean a request."""

from perfbench import readers

LAYER = "batch processor (core/batch_processor.py, core/request_queue.py)"
SOURCE = "program_span"
MOVES = "latency_p50_s"
UNIT = "ms"


def read(run):
    return readers.stage_mean_ms(run, "queue_wait")
