"""Rounds of the host gap pass's left extension a request (program counter
``host_ext_rounds``), one batched probe and a host sync each."""
from kbo_bench.metrics._spans import per_request


def read(run):
    return per_request(run, "host_ext_rounds")
