"""Mean ms a request spends in map's host gap pass, its re-assembly and
its re-fetch (program span ``map_host_gaps``)."""
from kbo_bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "map_host_gaps")
