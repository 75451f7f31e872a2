"""Share of the traced window in which no operation ran on the device."""
from kbo_bench.metrics._lib import idle_pct


def read(run):
    return idle_pct(run)
