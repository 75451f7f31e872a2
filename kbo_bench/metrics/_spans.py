"""Per-request means of the program's own spans and counters
(``kbo_tpu_torch/utils/stats.py``), read from the window's run stats.

Every cell's request builds its index first, so a program that records
spans inside its calls records ``build_sort`` in every window. Where that
is absent the program predates these spans, and a reader reads None, as it
does for a window without requests. Otherwise a span or counter that never
ran in the window reads 0.0."""

MARK = "build_sort_calls"


def per_request(run, key: str, scale: float = 1.0):
    """``scale`` times the window's total of ``key`` over its requests."""
    if not run.requests or MARK not in run.stats:
        return None
    return scale * run.stats.get(key, 0) / len(run.requests)


def span_ms(run, name: str):
    """Mean ms a request spends in the program span ``name``."""
    return per_request(run, f"{name}_s", 1e3)
