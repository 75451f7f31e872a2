"""Mean ms a request spends painting map's delta runs onto the reference
on the host (program span ``map_paint``)."""
from kbo_bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "map_paint")
