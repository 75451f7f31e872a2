"""The reduction of a profiler trace: each card's own union of device
intervals, their mean over the cell's cards, and on one card the very
output of the single union it replaced."""

import numpy as np
import pytest

from kbo_bench import run, trace
from kbo_bench.metrics import _lib

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_before(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _reduce_before(events, top=10):
    """``reduce_events`` as it was while every device event went into one
    union (a copy)."""
    dev, kern_s, by_name = [], 0.0, {}
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
            if cat == "kernel":
                kern_s += d * 1e-6
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((s, s + d, e["name"]))
    busy = _union_before(dev)
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
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernel_s": kern_s,
        "device_ops": [[n[:120], d * 1e-6] for n, d in ops],
        "idle_gaps": labelled,
    }


def _dev(card, ts, dur, name="k", cat="kernel", by_pid=False):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": card, "tid": 7}
    if not by_pid:
        e["args"] = {"device": card, "stream": 7}
    return e


def _host(ts, dur, name):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 100, "tid": 1}


def _random_events(seed):
    g = np.random.default_rng(seed)
    cats = list(DEVICE_CATS) + ["cpu_op", "user_annotation",
                                "python_function", "cuda_runtime", "ac2g"]
    out = []
    for _ in range(int(g.integers(0, 300))):
        e = {"ph": str(g.choice(["X", "X", "X", "i", "f"])),
             "cat": str(g.choice(cats)),
             "name": f"op{int(g.integers(0, 12))}",
             "ts": float(g.uniform(0, 5e4)),
             "pid": int(g.integers(0, 3)), "tid": int(g.integers(0, 4))}
        if g.random() < 0.95:
            e["dur"] = float(g.exponential(300))
        if g.random() < 0.5:
            e["args"] = {"device": int(g.integers(0, 3))}
        out.append(e)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_one_card_gives_the_single_union(seed):
    events = _random_events(seed)
    new = trace.reduce_events(events)
    old = _reduce_before(events)
    assert new.pop("busy_s_by_card") == [old["busy_s"]]
    assert new == old


def _idle(red, window_s):
    t = dict(red, window_s=window_s, bytes=0)
    return _lib.idle_pct(run.Run([], 1.0, 1.0, {}, t, None))


def test_two_cards_read_the_mean_of_each_cards_idle_share():
    events = [_dev(0, 0, 10), _dev(0, 5, 10), _dev(0, 40, 20),
              _dev(1, 20, 30, cat="gpu_memcpy"), _dev(1, 60, 10),
              _host(0, 100, "request 0"), _host(14, 4, "find_fetch")]
    red = trace.reduce_events(events, cards=2)
    assert red["busy_s_by_card"] == pytest.approx([35e-6, 40e-6])
    assert red["busy_s"] == pytest.approx(37.5e-6)
    # card-seconds of kernels; the only time no card worked is 15-20
    assert red["kernel_s"] == pytest.approx(50e-6)
    assert len(red["idle_gaps"]) == 1
    assert red["idle_gaps"][0][0] == "in find_fetch after start"
    assert red["idle_gaps"][0][1] == pytest.approx(5e-6)
    shares = [1 - b / 100e-6 for b in red["busy_s_by_card"]]
    assert _idle(red, 100e-6) == pytest.approx(100 * np.mean(shares))


def test_four_cards_a_card_without_events_is_idle():
    events = [_dev(0, 0, 50), _dev(1, 0, 30, by_pid=True),
              _dev(3, 10, 10, cat="gpu_memset")]
    red = trace.reduce_events(events, cards=4)
    assert red["busy_s_by_card"] == pytest.approx([50e-6, 30e-6, 10e-6, 0.0])
    assert red["busy_s"] == pytest.approx(22.5e-6)
    assert _idle(red, 100e-6) == pytest.approx(77.5)
    # one card alone: the same events are that card's, in one union
    one = trace.reduce_events(events)
    assert one["busy_s_by_card"] == pytest.approx([50e-6])
    none = trace.reduce_events([], cards=4)
    assert none["busy_s_by_card"] == [0.0] * 4 and none["busy_s"] == 0.0
