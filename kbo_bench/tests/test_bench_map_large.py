"""The cell scoelicolor_a3_2.map_large: its files against the contract,
the route its full size takes, a whole CPU run of a small copy of it
through the chunked sweep, and its new readers."""

import copy
import json
import math

import pytest

from kbo_bench import run
from kbo_bench.tests.bench_fixtures import BENCH, ROOT, cell

CELL = "scoelicolor_a3_2.map_large"
NEW = ["map_sweep_chunks.map_large", "map_sweep_chunked_ms.map_large",
       "map_chunk_pack_ms.map_large", "device_roofline_pct.map_large",
       "device_idle_pct.map_large"]


def _cfg():
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == cell(CELL)["config"])
    return json.loads((ROOT / entry["file"]).read_text())


def _tiny_cfg():
    """The configuration at 100 kbase, its shapes kept: GC, the inverted
    repeat pair, the deleted and island shares (in smaller blocks)."""
    cfg = copy.deepcopy(_cfg())
    cfg["reference"][0]["length"] = 100_000
    cfg["repeats"] = [{"name": "rrn_operon", "length": 500, "copies": 2},
                      {"name": "TIR", "length": 2000, "copies": 2},
                      {"name": "IS_element", "length": 300, "copies": 1}]
    cfg["assembly"].update(deleted_block=[300, 900], island_block=[300, 900],
                           contigs=10)
    return cfg


def test_config_keeps_the_keys_of_the_other_map_configuration():
    cfg = _cfg()
    ecoli = json.loads(
        (ROOT / "kbo_bench" / "configs" / "ecoli_mg1655.json").read_text())
    assert set(cfg) == set(ecoli)
    assert set(cfg["assembly"]) == set(ecoli["assembly"])
    assert cfg["reduced"] == [] and cfg["k"] == 51 and cfg["gc"] == 0.721
    assert cfg["reference"] == [{"name": "NC_003888.3", "length": 8667507}]
    assert [(r["name"], r["length"], r["copies"]) for r in cfg["repeats"]] == [
        ("rrn_operon", 5000, 6), ("TIR", 21653, 2), ("IS_element", 1300, 10)]
    assert cfg["assembly"]["deleted_share"] == 0.02


def test_cell_and_its_entries():
    w = cell(CELL)
    assert w["chips"] == 1 and w["traffic"] == "map_large"
    traffic = json.loads(
        (ROOT / "kbo_bench" / "traffic" / "map_large.json").read_text())
    assert traffic == {"verb": "map", "pool": 4, "check": 1,
                       "trace_requests": 3}
    e2e = {m["name"] for m in run.cell_metrics(BENCH, CELL, False)}
    assert e2e == {"map_bases_per_s", "map_p90_ms", "setup_s"}
    layer = {m["name"]: m for m in run.cell_metrics(BENCH, CELL, True)}
    assert set(layer) == set(NEW)
    for m in layer.values():
        assert m["workloads"] == [CELL] and m["moves"] == "map_bases_per_s"


@pytest.mark.parametrize("drafted", [0.96, 1.04])
def test_full_size_takes_two_chunks(drafted):
    """A draft of the chromosome's length, 4% either way, buckets to a key
    table too wide for the reference's sweep in one shot."""
    from kbo_tpu_torch import api
    from kbo_tpu_torch.kernels import ms

    n = _cfg()["reference"][0]["length"]
    L = ms._bucket(n)
    T = ms._bucket(int(drafted * n))
    assert L == 9_437_184 and L + 50 + T > ms._PACKED_SLOT_LIMIT
    route, chunk = api.map_route(51, 1, L, T)
    assert (route, chunk) == ("rows", 4_718_592)
    assert math.ceil(L / chunk) == 2


def _reader(name):
    return run.load(run.HERE / "metrics" / f"{name}.py").read


def _tiny_run(monkeypatch, trace, alter=False):
    """A whole CPU run of the small copy, the slot limit lowered so that
    its reference sweeps in chunks; the traced phase stood in for."""
    from kbo_tpu_torch import api
    from kbo_tpu_torch.kernels import ms

    cfg = _tiny_cfg()
    L = ms._bucket(cfg["reference"][0]["length"])
    # a bucket at or above any draft's key table (2% islands, 2% deleted):
    # the reference then sweeps in two or three chunks
    T = ms._bucket(int(1.1 * cfg["reference"][0]["length"]))
    monkeypatch.setattr(ms, "_PACKED_SLOT_LIMIT", T + L // 2 + 1)

    def traced(fn, n, cards=1):
        outs = [fn(j) for j in range(n)]
        return outs, {"busy_s": 0.25, "busy_s_by_card": [0.25] * cards,
                      "kernel_s": 0.2, "window_s": 1.0,
                      "device_ops": [], "idle_gaps": []}

    monkeypatch.setattr(run.tracing, "traced", traced)
    monkeypatch.setattr(run, "peak_bandwidth", lambda kind: 3.35e12)
    if alter:
        orig = api.map_batch

        def altered(*a, **kw):
            outs = orig(*a, **kw)
            out = bytearray(outs[0])
            out[len(out) // 2] ^= 0x20
            return [bytes(out)] + outs[1:]

        monkeypatch.setattr(api, "map_batch", altered)
    traffic = dict(json.loads(
        (ROOT / "kbo_bench" / "traffic" / "map_large.json").read_text()),
        pool=2, trace_requests=1)
    res, rc = run.run_cell(BENCH, cell(CELL), 2**31 + 4421, 0.2, trace,
                           device="cpu", cfg=cfg, traffic=traffic)
    assert rc == 0
    return res


def test_tiny_copy_sweeps_in_chunks_and_is_correct(monkeypatch):
    res = _tiny_run(monkeypatch, trace=True)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    got = {n: v["value"] for n, v in res["metrics"].items()}
    assert set(NEW) <= set(got)
    assert got["map_sweep_chunks.map_large"] >= 2
    assert got["map_chunk_pack_ms.map_large"] > 0
    assert (got["map_sweep_chunked_ms.map_large"]
            >= got["map_chunk_pack_ms.map_large"])
    assert got["device_idle_pct.map_large"] == pytest.approx(75.0)
    assert got["device_roofline_pct.map_large"] > 0


def test_tiny_copy_altered_answer_is_not_correct(monkeypatch):
    res = _tiny_run(monkeypatch, trace=False, alter=True)
    assert not res["correct"]
    assert res["checks"]["map_bytes_wrong"]["value"] > 0


def test_new_readers_read_none_without_their_source():
    mark = {"build_sort_calls": 4}
    chunked = {**mark, "map_sweep_chunked_calls": 4, "map_sweep_chunks": 8,
               "map_sweep_chunked_s": 0.4, "map_chunk_pack_s": 0.2}
    trace = {"busy_s": 0.5, "window_s": 2.0, "kernel_s": 0.5,
             "bytes": 3.35e11}
    reqs = [{"spans": {}}] * 4

    def one(stats, tr, n=4):
        return run.Run(reqs[:n], 1.0, 1.0, stats, tr, 3.35e12)

    want = {"map_sweep_chunks.map_large": 2.0,
            "map_sweep_chunked_ms.map_large": 100.0,
            "map_chunk_pack_ms.map_large": 50.0,
            "device_roofline_pct.map_large": 20.0,
            "device_idle_pct.map_large": 75.0}
    for name in NEW:
        assert _reader(name)(one(chunked, trace)) == pytest.approx(want[name])
    for name in NEW[:3]:  # no requests; a program without the spans
        assert _reader(name)(one(chunked, trace, n=0)) is None
        assert _reader(name)(one(mark, trace)) is None
    for name in NEW[3:]:  # a run without a trace
        assert _reader(name)(one(chunked, None)) is None
