"""The port's 2-bit map flow (api._map_classic) at k = 31, where the rows
join would serve the same batch: called directly, against kbo_tpu's
classic branch (KBO_TPU_MAP_FUSED=0) and against the port's own default
route, as tests/test_mapsweep.py::test_classic_and_fused_map_paths_identical
holds kbo_tpu's two paths equal. On the CPU; outputs equal byte for byte.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _genome_pair():
    """(reference contigs, indexed query): a SNP every 700 bases, a
    3-base deletion, a dense-SNP stretch (gap runs), a short contig."""
    rng = np.random.default_rng(31)
    ref = bytearray(BASES[rng.integers(0, 4, 12_000)].tobytes())
    query = bytearray(ref)
    for p in range(300, 11_500, 700):
        query[p] = BASES[(np.searchsorted(BASES, query[p]) + 1) % 4]
    del query[6_000:6_003]
    for p in range(9_000, 9_080, 3):
        query[p] = BASES[rng.integers(0, 4)]
    return [bytes(ref[:8000]), bytes(ref[8000:]), bytes(ref[500:800])], \
        bytes(query)


@pytest.mark.parametrize("fmt", [True, False])
def test_classic_flow_k31(monkeypatch, fmt):
    contigs, query = _genome_pair()
    bo = {"k": 31, "build_select": True}
    tidx = kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(**bo))
    jidx = kbo_tpu.build([query], kbo_tpu.BuildOpts(**bo))
    # threshold 11 at this error bound: k = 31 resolves isolated SNPs
    topts = kbo_tpu_torch.MapOpts(format=fmt, max_error_prob=1e-3,
                                  sbwt_build_opts=kbo_tpu_torch.BuildOpts(**bo))
    reset_stats()
    got = tapi._map_classic(contigs, tidx, topts, "cpu")
    st = get_stats().as_dict()
    assert st["map_gap_fill_calls"] == st["map_call_calls"] == 3
    assert st["variants_called"] > 10 and st["gaps_filled"] > 0
    assert tapi.map_route(31, 3, 8192, tidx.n_rows) == ("rows", 0)
    assert got == kbo_tpu_torch.map_batch(contigs, tidx, topts, device="cpu")
    monkeypatch.setenv("KBO_TPU_MAP_FUSED", "0")
    want = japi.map_batch(contigs, jidx, kbo_tpu.MapOpts(
        format=fmt, max_error_prob=1e-3,
        sbwt_build_opts=kbo_tpu.BuildOpts(**bo)))
    assert got == want
    assert [len(g) for g in got] == [len(c) for c in contigs]
