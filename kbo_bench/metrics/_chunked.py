"""Per-request means of the chunked rows sweep's spans and counter
(``kbo_tpu_torch/kernels/mapsweep.py``), read from the window's run stats.

In a cell whose every map sweeps in chunks, a window without the span
``map_sweep_chunked`` comes from a program that predates these spans: a
reader then reads None, not 0."""
from kbo_bench.metrics._spans import per_request

MARK = "map_sweep_chunked_calls"


def chunked(run, key: str, scale: float = 1.0):
    """``scale`` times the window's total of ``key`` over its requests."""
    if MARK not in run.stats:
        return None
    return per_request(run, key, scale)
