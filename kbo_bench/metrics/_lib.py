"""Arithmetic the readers share."""

from __future__ import annotations

import numpy as np


def rate(run, key: str):
    """Work done in the window over the window's seconds."""
    total = sum(r.get(key, 0) for r in run.requests)
    return total / run.window_s if run.requests and total else None


def span_ms(run, name: str):
    """Mean milliseconds per request of a harness span."""
    vals = [r["spans"][name] for r in run.requests if name in r["spans"]]
    return 1e3 * float(np.mean(vals)) if vals else None


def counter_per_request(run, name: str):
    if not run.requests:
        return None
    return run.stats.get(name, 0) / len(run.requests)


def roofline_pct(run):
    """Bytes the traced requests must move over the peak bandwidth, as a
    share of their summed kernel time."""
    t = run.trace
    if not t or t["kernel_s"] <= 0 or not run.peak_bytes_per_s:
        return None
    return 100.0 * t["bytes"] / run.peak_bytes_per_s / t["kernel_s"]


def idle_pct(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
