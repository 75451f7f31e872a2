"""The port's map_batch with the default refinements against kbo_tpu's, on
seeds of kbo_tpu's own end-to-end map fuzz matrix
(tests/test_fuzz_map.py::_config), on the CPU.

The seeds cover several contigs (the tagged variant join at W=7 and W=8),
both-strand inner indexes (``add_revcomp``), fragmented indexes and all
three error probabilities; each costs kbo_tpu one set of compiles (about
20 s), so they are split over two files:

- seed 0: k=51, p=1e-7, 2 contigs, fragmented index;
- seed 4: k=51, p=1e-5, 1 contig, add_revcomp;
- seed 5 and 6 in tests/test_torch_map_fuzz_contigs.py.
"""

import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from test_fuzz_map import _config

torch.set_num_threads(2)


def check_seed(seed):
    q_contigs, ref_contigs, bo, mo, p_err, k = _config(seed)
    want = japi.map_batch(list(ref_contigs), kbo_tpu.build(q_contigs, bo), mo)
    tbo = kbo_tpu_torch.BuildOpts(k=k, build_select=True,
                                  add_revcomp=bo.add_revcomp)
    got = kbo_tpu_torch.map_batch(
        list(ref_contigs), kbo_tpu_torch.build(q_contigs, tbo),
        kbo_tpu_torch.MapOpts(max_error_prob=p_err, sbwt_build_opts=tbo),
        device="cpu",
    )
    assert got == want, f"seed={seed} k={k} p={p_err} refs={len(ref_contigs)}"


@pytest.mark.parametrize("seed", [0, 4])
def test_map_fuzz_equals_kbo_tpu(seed):
    check_seed(seed)
