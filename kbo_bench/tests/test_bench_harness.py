"""A whole run on the CPU at a small size, its look for a card skipped:
sound runs come out correct, and each fault a cell can have comes out as
not correct. Also the ways a run must refuse to print a result."""

import importlib
import json
import shutil
import subprocess
import sys

import pytest

from kbo_bench import run
from kbo_bench.tests.bench_fixtures import (BENCH, ROOT, SCREEN_CELL, TINY_CFG,
                                           cell, tiny_traffic)

CELLS = {"map": "ecoli_mg1655.map_close", "find": "ecoli_mg1655.find_panel",
         "call": "kpneumo_hs11286.call_close", "screen": SCREEN_CELL["name"]}


def _run(name, trace=False):
    res, rc = run.run_cell(BENCH, cell(name), 2**31 + 21, 0.2, trace,
                           device="cpu", cfg=TINY_CFG,
                           traffic=tiny_traffic(name))
    assert rc == 0
    return res


def _alter_map(orig):  # map_ goes through map_batch too
    def f(*a, **kw):
        outs = orig(*a, **kw)
        out = bytearray(outs[0])
        out[len(out) // 2] ^= 0x20  # a base's case flipped
        return [bytes(out)] + outs[1:]
    return f


def _half_map(orig):
    def f(refs, *a, **kw):
        return orig(refs[: (len(refs) + 1) // 2], *a, **kw) + [
            b"-" * len(r) for r in refs[(len(refs) + 1) // 2:]]
    return f


def _alter_find(orig):
    def f(queries, *a, **kw):
        res = orig(queries, *a, **kw)
        i = next(j for j, segs in enumerate(res) if segs)
        res[i][0].end -= 1
        return res
    return f


def _half_find(orig):
    def f(queries, *a, **kw):
        return orig(queries[: len(queries) // 2], *a, **kw)
    return f


def _alter_call(orig):
    def f(*a, **kw):
        vs = orig(*a, **kw)
        if vs:
            vs[0].query_pos += 1
        return vs
    return f


def _half_call(orig):
    calls = {"n": 0}

    def f(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw) if calls["n"] % 2 else []
    return f


def _first_shard_only(orig):  # the other shards' answers never gathered
    def f(mesh, parts, *a, **kw):
        return orig(mesh, [parts[0]] * len(parts), *a, **kw)
    return f


FAULTS = {  # (verb, fault): (what of kbo_tpu_torch is broken, how)
    ("map", "alter"): ("api.map_batch", _alter_map),
    ("map", "half"): ("api.map_batch", _half_map),
    ("find", "alter"): ("api.find_batch", _alter_find),
    ("find", "half"): ("api.find_batch", _half_find),
    ("call", "alter"): ("api.call", _alter_call),
    ("call", "half"): ("api.call", _half_call),
    ("screen", "alter"): ("api.find_batch", _alter_find),
    ("screen", "half"): ("api.find_batch", _half_find),
    ("screen", "gather"): ("parallel.mesh.gather_to_host", _first_shard_only),
}


@pytest.mark.parametrize("verb", sorted(CELLS))
def test_sound_run_is_correct(verb):
    res = _run(CELLS[verb], trace=False)
    assert res["correct"] and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())
    cards = cell(CELLS[verb])["chips"]
    assert res["device"]["count"] == cards
    assert res["device"]["memory_peak_bytes_by_card"] == [0] * cards


@pytest.mark.parametrize("verb,fault", sorted(FAULTS))
def test_fault_in_the_timed_path_is_not_correct(verb, fault, monkeypatch):
    path, wrap = FAULTS[(verb, fault)]
    mod_name, attr = path.rsplit(".", 1)
    mod = importlib.import_module(f"kbo_tpu_torch.{mod_name}")
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    res = _run(CELLS[verb])
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_no_card_prints_no_result_and_fails():
    p = subprocess.run([sys.executable, "-m", "kbo_bench.run", "--workload",
                        CELLS["map"], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True)
    if p.returncode == 0:
        pytest.skip("a CUDA card is visible")
    assert p.returncode == 3 and p.stdout == ""


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kbo_bench", tmp_path / "kbo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "kbo_bench.run", "--workload",
                        CELLS["map"], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_per_layer_readers_on_a_cpu_run():
    res = _run(CELLS["map"], trace=False)
    assert set(res["metrics"]) == {"map_bases_per_s", "map_p90_ms", "setup_s"}
    json.dumps(res)
