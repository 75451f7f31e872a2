"""The benchmark's files against its contract, read without running it."""

import ast
import json
import re
from pathlib import Path

import pytest

from kbo_bench import run
from kbo_bench.tests.bench_fixtures import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "kbo_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("package", ["kbo_bench", "kbo_tpu_torch"])
def test_no_jax_import_by_whole_top_level_name(package):
    found = {}
    for path in (ROOT / package).rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        if tops & FORBIDDEN:
            found[str(path)] = sorted(tops & FORBIDDEN)
    assert found == {}


def test_forbidden_check_compares_whole_names():
    assert run.forbidden_modules(["kbo_tpu_torch.api", "numpy"]) == []
    assert run.forbidden_modules(["kbo_tpu.api", "jaxlib.xla"]) == [
        "jaxlib", "kbo_tpu"]


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "kbo_bench" / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"__future__", "math", "numpy"}, (path, tops)


def test_benchmark_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kbo_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kbo_bench/") and (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        t = ROOT / "kbo_bench" / "traffic" / f"{w['traffic']}.json"
        verb = json.loads(t.read_text())["verb"]
        assert (ROOT / "kbo_bench" / "verbs" / f"{verb}.py").exists()
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "kbo_bench" / "metrics" / f"{m['name']}.py").exists()
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for n in names:
        assert NAME.match(n), n
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_and_a_layer(w):
    e2e = {m["name"] for m in run.cell_metrics(BENCH, w, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in run.cell_metrics(BENCH, w, True):
        assert w in BENCH_CELLS_REPORTING(m["moves"])
    assert run.cell_metrics(BENCH, w, True)


def BENCH_CELLS_REPORTING(metric):
    m = next(e for e in BENCH["end_to_end"] if e["name"] == metric)
    return m.get("workloads", [w["name"] for w in BENCH["workloads"]])
