"""Rows a batch over the window: the change in requests_processed over the change in batches_processed."""

from perfbench import readers

LAYER = "batch processor (core/batch_processor.py, core/request_queue.py)"
SOURCE = "program_counter"
MOVES = "throughput_rps"
UNIT = "rows"


def read(run):
    return readers.rows_per_batch(run)
