"""The refinement's one capacity policy on every rows-join map route, on the
CPU and without kbo_tpu: each route's output with the first capacities
forced small (refine.device_map.start_caps) equals its own unforced output
and the single card's, and the overflow shows in the run's
``map_overflow_retries``.

``candidates``: the first drop and gap-run capacities are too small for
the contigs' SNPs, so every route overflows once and retries at the exact
need. ``runs``: only the first run budget is too small; the single-fetch
routes (single card, sequence- and index-sharded) re-assemble at the exact
size inside their attempt, the contig-sharded ones (contig blocks over
``data``, the 2-D mesh) run one more attempt.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import kbo_tpu_torch
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.parallel import mesh as tmesh
from kbo_tpu_torch.refine import device_map
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
K = 31
SMALL = 16


@pytest.fixture(scope="module")
def case():
    """Four 3 kbase contigs of a genome against an assembly of it with a
    SNP every 150 bases (20 drops a contig, more than SMALL)."""
    rng = np.random.default_rng(23)
    genome = BASES[rng.integers(0, 4, 12_000)].tobytes()
    query = bytearray(genome)
    for p in range(75, len(query), 150):
        query[p] = BASES[(np.searchsorted(BASES, query[p]) + 1) % 4]
    bo = kbo_tpu_torch.BuildOpts(k=K, build_select=True)
    index = kbo_tpu_torch.build([bytes(query)], bo)
    refs = [genome[i * 3000 : (i + 1) * 3000] for i in range(4)]
    opts = kbo_tpu_torch.MapOpts(sbwt_build_opts=bo)
    return refs, index, opts, {}


def _data(refs, index, opts):
    thr = random_match_threshold(K, index.n_kmers, 4, opts.max_error_prob)
    return tmesh.map_devref_data_sharded(
        refs, index, [encode_ascii(r) for r in refs], opts, thr,
        tmesh.make_mesh(2, device="cpu"))


ROUTES = {
    "single": lambda refs, index, opts: tapi.map_batch(
        refs, index, opts, device="cpu"),
    "seq": lambda refs, index, opts: tmesh.map_seq_sharded(
        refs, index, opts, mesh=tmesh.make_mesh(8, device="cpu")),
    "index": lambda refs, index, opts: tmesh.map_batch_index_sharded(
        refs, index, opts, tmesh.make_mesh(4, axis="model", device="cpu")),
    "data": _data,
    "2d": lambda refs, index, opts: tmesh.map_batch_2d_sharded(
        refs, index, opts, tmesh.make_mesh(
            (2, 2), axis=("data", "model"), device="cpu")),
}
SINGLE_FETCH = ("single", "seq", "index")


@pytest.mark.parametrize("forced", ["candidates", "runs"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_forced_small_capacities_equal_unforced(case, route, forced,
                                                monkeypatch):
    refs, index, opts, unforced = case
    run = ROUTES[route]
    for name in (route, "single"):
        if name not in unforced:
            unforced[name] = ROUTES[name](refs, index, opts)
    assert unforced[route] is not None and unforced[route] == unforced["single"]

    real = device_map.start_caps
    small = ({"d": SMALL, "g": SMALL, "r": SMALL} if forced == "candidates"
             else {"r": SMALL})
    monkeypatch.setattr(device_map, "start_caps",
                        lambda L, q: replace(real(L, q), **small))
    reset_stats()
    got = run(refs, index, opts)
    stats = get_stats().as_dict()
    assert got == unforced[route]
    if forced == "runs" and route in SINGLE_FETCH:
        assert "map_overflow_retries" not in stats
        assert stats["map_fetch_calls"] == 2
    else:
        assert stats["map_overflow_retries"] >= 1
