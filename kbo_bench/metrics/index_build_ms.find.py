"""Mean ms a request spends in `build_device`, to a synchronise."""
from kbo_bench.metrics._lib import span_ms


def read(run):
    return span_ms(run, "index_build")
