"""Mean ms a request spends turning the fetched segment table into
segment lists on the host (program span ``find_rle``)."""
from kbo_bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "find_rle")
