"""Lanes the host gap pass's left extension walks along the device index's
chain links a request (program counter ``host_ext_walk_lanes``), one walk
for all of a pass's lanes."""
from kbo_bench.metrics._spans import per_request


def read(run):
    return per_request(run, "host_ext_walk_lanes")
