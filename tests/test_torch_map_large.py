"""map_ past the rows join's one-shot slot budget, on the CPU: a draft
shaped as the benchmark's scoelicolor_a3_2 configuration (GC 72.1%, an
inverted repeat pair, 2% of the chromosome deleted in blocks, query-only
islands) against its reference, with the default ``MapOpts()`` (variant
calling and gap filling on).

The slot limit is lowered so that the reference takes the chunked rows
sweep in three or more chunks, as an 8.67 Mbase chromosome takes two at
the real limit. The chunked answer must equal the one-shot route's and the
benchmark's plain reference (kbo_bench/reference/kbo_ref.py) byte for
byte, and the chunked sweep's spans and counter must read its chunks.
"""

import re

import numpy as np
import pytest
import torch

from kbo_bench import generate
from kbo_bench.reference import kbo_ref
from kbo_tpu_torch import api
from kbo_tpu_torch.kernels import mapsweep
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.opts import BuildOpts, MapOpts
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

K = 31
CFG = {
    "k": K, "max_error_prob": 1e-7, "gc": 0.721,
    "reference": [{"name": "chr", "length": 80000}],
    "repeats": [{"name": "TIR", "length": 1500, "copies": 2},
                {"name": "rrn_operon", "length": 600, "copies": 2}],
    "assembly": {"snp_every": 1000, "indel_every": 20000, "indel_len": [1, 10],
                 "deleted_share": 0.02, "deleted_block": [300, 900],
                 "island_share": 0.02, "island_block": [300, 900],
                 "contigs": 8},
}
SEED = 2**31 + 2113
OPTS = MapOpts(max_error_prob=CFG["max_error_prob"],
               sbwt_build_opts=BuildOpts(k=K, build_select=True))


@pytest.fixture(scope="module")
def case():
    ref, mids = generate.reference(CFG, SEED)
    draft = generate.assemblies(CFG, {"pool": 1}, ref, mids, SEED)[0]
    idx = api.build_device(draft, OPTS.sbwt_build_opts, full=True,
                           device="cpu")
    reset_stats()
    one_shot = api.map_(ref[0], idx, OPTS, device="cpu")
    stats = get_stats().as_dict()
    want = kbo_ref.map_(kbo_ref.Rows(draft, K), ref[0], CFG["max_error_prob"])
    return {"ref": ref[0], "draft": draft, "idx": idx, "want": want,
            "one_shot": one_shot, "one_shot_stats": stats}


def test_draft_has_the_configurations_shape(case):
    ref = np.frombuffer(case["ref"], dtype=np.uint8)
    gc = np.isin(ref, np.frombuffer(b"GC", dtype=np.uint8)).mean()
    assert abs(gc - CFG["gc"]) < 0.01
    drafted = sum(len(c) for c in case["draft"])
    assert len(case["draft"]) >= 5 and drafted != len(ref)
    # deleted blocks leave long gaps in the answer, past the device's
    # extension budget: the host gap pass takes them
    longest = max(map(len, re.findall(rb"-+", case["one_shot"])), default=0)
    assert longest >= CFG["assembly"]["deleted_block"][0]
    assert case["one_shot_stats"]["gaps_to_host"] > 0


@pytest.mark.parametrize("soft_masked", [False, True])
def test_chunked_map_equals_one_shot_and_reference(case, soft_masked,
                                                  monkeypatch):
    """Soft-masked (lower-case) bases leave the packed upload's exception
    list too long, so that reference takes the one-shot upload and
    ms3_rows_sweep_chunked; upper-case takes the pipelined upload."""
    ref = case["ref"].lower() if soft_masked else case["ref"]
    idx = case["idx"]
    L = tms._bucket(len(ref))
    T = int(idx.keys3.shape[1])
    monkeypatch.setattr(tms, "_PACKED_SLOT_LIMIT", T + L // 3 + 1)
    route, chunk = api.map_route(K, 1, L, T)
    n_chunks = -(-L // chunk)
    assert route == "rows" and n_chunks >= 3
    piped = []
    real = mapsweep.upload_sweep_chunked_pipelined

    def spy(*a, **kw):
        out = real(*a, **kw)
        piped.append(out is not None)
        return out

    monkeypatch.setattr(mapsweep, "upload_sweep_chunked_pipelined", spy)
    reset_stats()
    got = api.map_(ref, idx, OPTS, device="cpu")
    stats = get_stats().as_dict()
    want = (kbo_ref.map_(kbo_ref.Rows(case["draft"], K), ref,
                         CFG["max_error_prob"]) if soft_masked
            else case["want"])
    assert got == want
    if not soft_masked:
        assert got == case["one_shot"]
    assert piped == [not soft_masked]
    assert stats["map_sweep_chunks"] == n_chunks
    assert stats["map_sweep_chunked_s"] > 0
    if soft_masked:
        # the pipelined attempt gave up at its first chunk's pack; the
        # sweep that followed is counted once, its bases by map_sweep
        assert stats["map_sweep_chunked_calls"] == 2
        assert stats["map_chunk_pack_calls"] == 1
        assert stats["map_sweep_bases"] == len(ref)
    else:
        assert stats["map_sweep_chunked_calls"] == 1
        assert stats["map_sweep_chunked_bases"] == len(ref)
        assert stats["map_chunk_pack_calls"] == n_chunks
        assert 0 < stats["map_chunk_pack_s"] <= stats["map_sweep_chunked_s"]
        assert "map_sweep_calls" not in stats


def test_one_shot_route_reads_no_chunks(case):
    stats = case["one_shot_stats"]
    assert case["one_shot"] == case["want"]
    assert stats.get("map_sweep_chunks", 0) == 0
    assert "map_sweep_chunked_calls" not in stats
    assert "map_chunk_pack_calls" not in stats
    assert stats["map_sweep_bases"] == len(case["ref"])
