"""The port's map_batch with the default MapOpts() against kbo_tpu's on the
inputs of kbo_tpu's device-refinement tests (tests/test_device_refine.py),
on the CPU: k=31 and k=51 single contigs, where the variant join reuses the
sweep's sorted query tables, and a low-identity block whose gaps go to the
host evaluator. Each input costs kbo_tpu one set of compiles (about 20 s),
so the multi-contig, insertion and overflow inputs are in
tests/test_torch_map_contigs.py.
"""

import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu_torch.refine import device_map
from kbo_tpu_torch.utils.stats import get_stats, reset_stats
from test_device_refine import _pair

torch.set_num_threads(2)


def map_both(refs, query, k, fmt=True):
    """(port bytes, kbo_tpu bytes) for MapOpts() at k, both built from
    ``query``."""
    jbo = kbo_tpu.BuildOpts(k=k, build_select=True)
    want = japi.map_batch(
        list(refs), kbo_tpu.build([query], jbo),
        kbo_tpu.MapOpts(format=fmt, sbwt_build_opts=jbo),
    )
    tbo = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    got = kbo_tpu_torch.map_batch(
        list(refs), kbo_tpu_torch.build([query], tbo),
        kbo_tpu_torch.MapOpts(format=fmt, sbwt_build_opts=tbo), device="cpu",
    )
    return got, want


@pytest.mark.parametrize("k", [31, 51])
def test_devref_single_contig(k):
    ref, query = _pair(20_000, k, seed=11)
    reset_stats()
    got, want = map_both([ref], query, k)
    assert got == want
    stats = get_stats().as_dict()
    assert stats["gaps_filled"] > 0
    # k=31 is below the reference's calling regime (k >= 2t + len)
    assert (stats["variants_called"] > 0) == (k == 51)


def test_devref_low_identity_host_fallback(monkeypatch):
    ref, query = _pair(16_384, 31, seed=7, snp_every=0, del_every=0,
                       noise_block=120)
    calls = []
    real = device_map.gap_filling.fill_gaps_patches

    def spy(runs, *a, **kw):
        calls.append(len(runs))
        return real(runs, *a, **kw)

    monkeypatch.setattr(device_map.gap_filling, "fill_gaps_patches", spy)
    got, want = map_both([ref], query, 31, fmt=False)
    assert got == want
    assert calls and sum(calls) > 0, "the host evaluator must run"
