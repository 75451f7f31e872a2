"""Mean ms a request waits on find_batch's segment-table fetches (program
span ``find_fetch``): the join's device work the host could not hide."""
from kbo_bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "find_fetch")
