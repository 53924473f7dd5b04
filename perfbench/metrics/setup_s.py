"""From the process's start to the window's open: the kernels' build on a
checkout's first run, the corpus and the weights (`weights.MODEL_SEED`), the engine's
own set-up, its warm-up and the warm-up traffic."""

LAYER = None
SOURCE = "host_clock"
MOVES = None
UNIT = "s"


def read(run):
    return run.setup_s
