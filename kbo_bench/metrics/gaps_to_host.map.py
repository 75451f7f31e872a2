"""Gaps the map refinement sends to the host evaluator, per request
(run-stat counter `gaps_to_host`)."""
from kbo_bench.metrics._lib import counter_per_request


def read(run):
    return counter_per_request(run, "gaps_to_host")
