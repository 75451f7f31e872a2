"""One short run of each cell on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from kbo_bench.tests.bench_fixtures import BENCH, ROOT


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
