"""Structured per-run statistics and profiling.

The reference has no observability layer (SURVEY §5: no logging/timing
crates); this module provides the new framework's equivalent: lightweight
counters + stage timers that the pipelines update as they run, a JSON dump
for CLI/batch consumers. (The device trace context ``profile_trace`` of
kbo_tpu.utils.stats comes with a later slice of the port.)

Counters are process-global and cheap (plain dict increments); they are
always collected. ``as_dict`` derives rates (bases/s per stage) from the
recorded totals.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time


class RunStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {}
        self.timers: dict[str, float] = {}

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + int(n)

    def add_time(self, key: str, seconds: float) -> None:
        with self._lock:
            self.timers[key] = self.timers.get(key, 0.0) + float(seconds)

    def as_dict(self) -> dict:
        out: dict = dict(self.counters)
        for key, secs in self.timers.items():
            out[f"{key}_s"] = round(secs, 6)
            bases = self.counters.get(f"{key}_bases")
            if bases and secs > 0:
                out[f"{key}_bases_per_s"] = round(bases / secs)
        return out

    def dump_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)


_stats = RunStats()


def get_stats() -> RunStats:
    return _stats


def reset_stats() -> None:
    global _stats
    _stats = RunStats()


@contextlib.contextmanager
def stage(name: str, bases: int | None = None):
    """Time a pipeline stage; optionally record its base count for rates."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _stats.add_time(name, time.perf_counter() - t0)
        _stats.add(f"{name}_calls")
        if bases is not None:
            _stats.add(f"{name}_bases", bases)
