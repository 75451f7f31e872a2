"""A short traced phase under ``torch.profiler``, reduced to what the run
reports: each card's union of device-operation intervals (busy), the summed
kernel time, the device operations that took most time, and the longest
idle gaps with what the host was doing in each."""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced(fn, n: int, cards: int = 1) -> tuple[list, dict]:
    """Run ``fn(j)`` for j < n under the profiler; returns the results and
    the reduced trace. The window closes once each of the cell's ``cards``
    cards (``cuda:0`` on) has finished its work."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    outs = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j in range(n):
            with record_function(f"request {j}"):
                outs.append(fn(j))
        for d in range(cards):
            torch.cuda.synchronize(d)
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    red = reduce_events(events, cards)
    red["window_s"] = window
    return outs, red


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _card(e: dict):
    """The card a device event ran on: its ``device`` argument, else its
    process id (the profiler gives a card's rows that card's index)."""
    return e.get("args", {}).get("device", e.get("pid"))


def reduce_events(events: list[dict], cards: int = 1, top: int = 10) -> dict:
    """Busy and kernel seconds, top device ops and longest idle gaps from a
    Chrome trace's events (times in microseconds).

    ``busy_s`` is the mean over the cell's ``cards`` of each card's own
    union of device intervals (``busy_s_by_card``), a card without events
    counting as idle, so ``1 - busy_s / window`` is a card's mean idle
    share; with one card every device event is that card's. ``kernel_s``
    sums over all cards (card-seconds). The idle gaps are those of the union
    over all cards: times when no card worked."""
    dev, kern_s, by_name = [], 0.0, {}
    by_card: dict = {}
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            by_card.setdefault(_card(e) if cards > 1 else 0, []).append(
                (s, s + d))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
            if cat == "kernel":
                kern_s += d * 1e-6
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((s, s + d, e["name"]))
    busy = _union(dev)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        cover = [h for h in host if h[0] <= mid <= h[1]]
        inner = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "idle"
        before = [h for h in host if h[1] <= mid]
        last = max(before, key=lambda h: h[1])[2] if before else "start"
        labelled.append([f"in {inner} after {last}"[:120], (e - s) * 1e-6])
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    busy_by_card = [sum(e - s for s, e in _union(by_card[c])) * 1e-6
                    for c in sorted(by_card, key=str)]
    busy_by_card += [0.0] * (cards - len(busy_by_card))
    return {
        "busy_s": sum(busy_by_card) / len(busy_by_card),
        "busy_s_by_card": busy_by_card,
        "kernel_s": kern_s,
        "device_ops": [[n[:120], d * 1e-6] for n, d in ops],
        "idle_gaps": labelled,
    }
