"""Share of prefix-cache lookups that hit over the window: the change in hits over the change in hits and misses of prefix_cache.stats()."""

from perfbench import readers

LAYER = "prefix cache (core/prefix_cache.py)"
SOURCE = "program_counter"
MOVES = "latency_p95_s"
UNIT = "%"


def read(run):
    return readers.prefix_hit_pct(run)
