"""Mean ms a request waits on map's delta-run fetch (program span
``map_fetch``): the map's device work the host could not hide."""
from kbo_bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "map_fetch")
