"""Mean ms a request spends packing the draft's text on the host in
``build_device`` (program span ``build_pack``)."""
from kbo_bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "build_pack")
