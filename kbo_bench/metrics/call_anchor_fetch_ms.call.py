"""Mean ms a request spends in the interval reads of call's anchor rounds
(program span ``call_anchor_fetch``, summed over its contigs)."""
from kbo_bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "call_anchor_fetch")
