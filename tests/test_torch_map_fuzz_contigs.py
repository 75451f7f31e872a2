"""Two more seeds of kbo_tpu's map fuzz matrix against the port (see
tests/test_torch_map_fuzz.py), both with three reference contigs:

- seed 5: k=63, p=1e-7, add_revcomp (the tagged join at W=8);
- seed 6: k=41, p=1e-3, fragmented index.
"""

import pytest

from test_torch_map_fuzz import check_seed


@pytest.mark.parametrize("seed", [5, 6])
def test_map_fuzz_contigs_equals_kbo_tpu(seed):
    check_seed(seed)
