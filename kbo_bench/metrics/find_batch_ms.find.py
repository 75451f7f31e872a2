"""Mean ms a request spends in `find_batch` (it returns host lists)."""
from kbo_bench.metrics._lib import span_ms


def read(run):
    return span_ms(run, "find_batch")
