"""Structured per-run statistics and profiling.

The reference has no observability layer (SURVEY §5: no logging/timing
crates); this module provides the new framework's equivalent: lightweight
counters + stage timers that the pipelines update as they run, a JSON dump
for CLI/batch consumers, and an optional ``torch.profiler`` trace context
for device-level profiling.

Counters are process-global and cheap (plain dict increments); they are
always collected. While a ``torch.profiler`` records, each :func:`stage` is
also a ``record_function`` span: a ``user_annotation`` in the Chrome trace,
on the clock of the kernels and copies it launched.

A stage times host work and launches; one named ``*_fetch`` times a
device-to-host fetch, so its host time is device work the host could not
hide. Stages wrap the waits that are there and add none.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function


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
    """Time a pipeline stage (``<name>_s``, ``<name>_calls``; with
    ``bases``, ``<name>_bases``). Under a recording profiler the stage is
    also a ``record_function(name)`` span; without one it enters none."""
    span = record_function(name) if _profiler._is_profiler_enabled else None
    if span is not None:
        span.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _stats.add_time(name, time.perf_counter() - t0)
        _stats.add(f"{name}_calls")
        if bases is not None:
            _stats.add(f"{name}_bases", bases)
        if span is not None:
            span.__exit__(None, None, None)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Wrap a block in a ``torch.profiler`` trace (the CPU, and the card
    when there is one) written into ``log_dir`` as a Chrome trace (view
    with TensorBoard or Perfetto); a no-op without ``log_dir``."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
