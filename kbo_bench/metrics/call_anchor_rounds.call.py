"""Anchor rounds of call a request, summed over its contigs (program
counter ``call_anchor_rounds``), one interval read and host sync each."""
from kbo_bench.metrics._lib import counter_per_request


def read(run):
    return counter_per_request(run, "call_anchor_rounds")
