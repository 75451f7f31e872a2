"""Reference bases mapped in the window per second."""
from kbo_bench.metrics._lib import rate


def read(run):
    return rate(run, "bases")
