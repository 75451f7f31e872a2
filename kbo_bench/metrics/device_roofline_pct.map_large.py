"""Least bytes of the traced requests over 3.35 TB/s, as a share of
their summed kernel time (the yardstick is `_bytes.request_bytes`)."""
from kbo_bench.metrics._lib import roofline_pct


def read(run):
    return roofline_pct(run)
