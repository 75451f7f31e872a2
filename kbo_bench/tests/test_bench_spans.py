"""The readers of the program's own spans and counters: on synthetic runs,
and in the result line of a whole CPU run with its traced phase stood in
for (the card's profiler is not here)."""

import pytest

from kbo_bench import run
from kbo_bench.tests.bench_fixtures import BENCH, TINY_CFG, cell, tiny_traffic

# reader -> (run-stat key, scale)
SPANS = {
    "build_pack_ms.map": ("build_pack_s", 1e3),
    "map_fetch_ms.map": ("map_fetch_s", 1e3),
    "map_host_gaps_ms.map": ("map_host_gaps_s", 1e3),
    "host_ext_rounds.map": ("host_ext_rounds", 1.0),
    "map_paint_ms.map": ("map_paint_s", 1e3),
    "build_pack_ms.find": ("build_pack_s", 1e3),
    "find_fetch_ms.find": ("find_fetch_s", 1e3),
    "find_rle_ms.find": ("find_rle_s", 1e3),
    "call_anchor_fetch_ms.call": ("call_anchor_fetch_s", 1e3),
    "call_anchor_rounds.call": ("call_anchor_rounds", 1.0),
}
# readers of a counter the program kept before it recorded spans
OLDER = {"call_anchor_rounds.call"}
MARK = {"build_sort_calls": 4}


def _reader(name):
    return run.load(run.HERE / "metrics" / f"{name}.py").read


def _run(stats, n_requests=4):
    return run.Run([{"spans": {}}] * n_requests, 1.0, 1.0, stats, None, None)


def test_every_reader_has_an_entry():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, (key, _) in SPANS.items():
        m = entries[name]
        assert m["source"] == ("program_span" if key.endswith("_s")
                               else "program_counter")
        assert len(m["workloads"]) == 1


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_on_synthetic_runs(name):
    key, scale = SPANS[name]
    read = _reader(name)
    assert read(_run({**MARK, key: 8.0}, n_requests=0)) is None
    assert read(_run(MARK)) == 0.0
    assert read(_run({**MARK, key: 8.0})) == pytest.approx(scale * 2.0)
    # a program without the spans (no build_sort) reads nothing new
    if name in OLDER:
        assert read(_run({key: 8.0})) == pytest.approx(scale * 2.0)
    else:
        assert read(_run({key: 8.0})) is None


@pytest.mark.parametrize("name", ["ecoli_mg1655.map_close",
                                  "ecoli_mg1655.find_panel",
                                  "kpneumo_hs11286.call_close"])
def test_traced_cpu_run_prints_every_new_reader(name, monkeypatch):
    def traced(fn, n, cards=1):
        outs = [fn(j) for j in range(n)]
        return outs, {"busy_s": 0.0, "busy_s_by_card": [0.0] * cards,
                      "kernel_s": 0.0, "window_s": 1.0,
                      "device_ops": [], "idle_gaps": []}

    monkeypatch.setattr(run.tracing, "traced", traced)
    res, rc = run.run_cell(BENCH, cell(name), 2**31 + 77, 0.2, True,
                           device="cpu", cfg=TINY_CFG,
                           traffic=tiny_traffic(name))
    assert rc == 0 and res["correct"]
    mine = {m["name"] for m in run.cell_metrics(BENCH, name, True)} & set(SPANS)
    assert mine and mine <= set(res["metrics"])
    for m in mine:
        assert res["metrics"][m]["value"] >= 0
    if name.endswith("map_close"):
        assert res["metrics"]["map_fetch_ms.map"]["value"] > 0
