"""Chunks a request's map sweep takes past the rows join's slot budget
(program counter ``map_sweep_chunks``, added once a sweep)."""
from kbo_bench.metrics._chunked import chunked


def read(run):
    return chunked(run, "map_sweep_chunks")
