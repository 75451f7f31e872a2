"""Bytes a request's index build writes into its construction buffer on
the host (program counter ``build_pack_bytes``, the bucketed buffer, added
once a build). None for a program without the counter."""
from kbo_bench.metrics._spans import per_request


def read(run):
    if "build_pack_bytes" not in run.stats:
        return None
    return per_request(run, "build_pack_bytes")
