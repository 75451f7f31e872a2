"""Short runs on the card (skip without one): each one-card cell of
``BENCHMARK.json``, and a read screen over every visible card."""

import io
import json
import subprocess
import sys

import pytest

from kbo_bench import run
from kbo_bench.tests.bench_fixtures import BENCH, ROOT, SCREEN_TRAFFIC


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if w["chips"] == 1])
def test_short_run_on_the_card_is_correct(name):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    p = subprocess.run([sys.executable, "-m", "kbo_bench.run", "--workload",
                        name, "--seed", "7", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
def test_screen_over_the_visible_cards_is_correct():
    """``screen`` at full length: the ``ecoli_mg1655`` reference's index on
    a mesh of up to four cards, requests of 65,536 reads, traced."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cards = min(torch.cuda.device_count(), 4)
    cfg = json.loads((ROOT / "kbo_bench" / "configs"
                      / "ecoli_mg1655.json").read_text())
    cell = {"name": f"ecoli_mg1655.screen_x{cards}", "config": "ecoli_mg1655",
            "traffic": "screen", "chips": cards,
            "why": "65,536 reads of 150 bases a request on every card"}
    log = io.StringIO()
    res, rc = run.run_cell(BENCH, cell, 2**31 + 1907, 2.0, True,
                           device="cuda", cfg=cfg, traffic=SCREEN_TRAFFIC,
                           log=log)
    print(log.getvalue(), json.dumps(res), sep="\n")
    assert rc == 0 and res["correct"], log.getvalue()[-2000:]
    dev = res["device"]
    assert dev["count"] == cards
    peaks = dev["memory_peak_bytes_by_card"]
    assert len(peaks) == cards and min(peaks) > 0
    assert dev["memory_peak_bytes"] == max(peaks)
    assert len(dev["busy_s_by_card"]) == cards
    assert min(dev["busy_s_by_card"]) > 0  # every card ran the batch
