"""Mean ms a request spends in `map_` (it returns host bytes)."""
from kbo_bench.metrics._lib import span_ms


def read(run):
    return span_ms(run, "map")
