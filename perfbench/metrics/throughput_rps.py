"""Requests answered in the window (status ok, answered between its open
and its close), over the window's seconds."""

LAYER = None
SOURCE = "host_clock"
MOVES = None
UNIT = "req/s"


def read(run):
    return len(run.answered_in(run.t0, run.t1)) / run.seconds
