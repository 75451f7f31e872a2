"""Mean ms a request spends packing the reference's chunks on the host
(program span ``map_chunk_pack``, one a chunk)."""
from kbo_bench.metrics._chunked import chunked


def read(run):
    return chunked(run, "map_chunk_pack_s", 1e3)
