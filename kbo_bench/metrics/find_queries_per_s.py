"""Queries whose segment lists reached the host, per second."""
from kbo_bench.metrics._lib import rate


def read(run):
    return rate(run, "queries")
