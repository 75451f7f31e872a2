"""Mean ms a request spends in the chunked sweep's loop (program span
``map_sweep_chunked``): each chunk's host pack and the launches of its
upload and join, host time only."""
from kbo_bench.metrics._chunked import chunked


def read(run):
    return chunked(run, "map_sweep_chunked_s", 1e3)
