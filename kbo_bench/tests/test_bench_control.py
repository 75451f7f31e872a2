"""The control (only whole k-mer hits count) fails each cell's check at a
small size."""

import pytest

from kbo_bench import control
from kbo_bench.tests.bench_fixtures import SCREEN_CELL, TINY_CFG, tiny_traffic

CELLS = ["ecoli_mg1655.map_close", "ecoli_mg1655.find_panel",
         "kpneumo_hs11286.call_close", SCREEN_CELL["name"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = control.control_checks(TINY_CFG, tiny_traffic(name), 2**31 + 9)
    assert any(v > 0 for v in res.values())
