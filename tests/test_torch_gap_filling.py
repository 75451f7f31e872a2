"""The port's interval gap path (refine/gap_filling.py: fill_gaps,
fill_gaps_patches without a grid, _evaluate_gaps, the lane-batched rank
search for short patterns, the spec helpers) against kbo_tpu's, on the CPU:
a mirror of tests/test_gap_filling.py and tests/test_gap_filling_golden.py.

Every golden scenario runs with the intervals as an [n, 2] array (the
scalar walk's), as an engine.SparseIntervals over the host index, and over
a device-built full index (its membership probes in place of the binary
search); each must equal the reference's literal output and kbo_tpu's.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import engine as jengine
from kbo_tpu.refine import gap_filling as jgap
from kbo_tpu.utils.stats import get_stats as jstats
from kbo_tpu.utils.stats import reset_stats as jreset
from kbo_tpu_torch import api, engine
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.ops.derandomize import (
    derandomize_ms_vec,
    random_match_threshold,
)
from kbo_tpu_torch.ops.ms import query_ms_codes
from kbo_tpu_torch.ops.translate import translate_ms_vec
from kbo_tpu_torch.refine import gap_filling as tgap
from kbo_tpu_torch.utils.stats import get_stats, reset_stats
from test_gap_filling_golden import (
    DEFAULT_EXPECTED,
    DEFAULT_QUERY,
    DEFAULT_REF,
    K51_EXPECTED,
    K51_QUERY,
    K51_REF,
)

torch.set_num_threads(2)

# keys of the port's run stats that kbo_tpu does not keep: the rounds of
# the host left extension on a host index
# (refine/gap_filling.py::_left_extend_batch) and the lanes of the walk that
# takes their place on a device index (kernels/refine.py::ext_walk), and
# the chunks of map's chunked rows sweep (kernels/mapsweep.py)
PORT_ONLY = {"host_ext_rounds", "host_ext_walk_lanes", "map_sweep_chunks"}


def assert_stats_match():
    """The port's run stats equal kbo_tpu's on every key kbo_tpu reports,
    and its other keys are the port's own counters."""
    got, want = get_stats().as_dict(), jstats().as_dict()
    assert {key: got.get(key) for key in want} == want
    assert set(got) - set(want) <= PORT_ONLY

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
IVALS = ["array", "sparse", "device_full"]


def _indexes(query, k):
    tbo = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    return (kbo_tpu_torch.build([query], tbo),
            kbo_tpu.build([query], kbo_tpu.BuildOpts(k=k, build_select=True)),
            api.build_device([query], tbo, full=True, device="cpu"))


def _ivals(kind, tidx, didx, codes, ms):
    """(index, intervals) of one form: the scalar walk's [n, 2] array, a
    SparseIntervals over the host index, or one over the device index."""
    if kind == "array":
        return tidx, query_ms_codes(tidx, codes)[1]
    index = tidx if kind == "sparse" else didx
    return index, engine.SparseIntervals(index, codes, ms=ms, device="cpu")


def _refine_both(query, reference, k, threshold, kind, p=0.001):
    tidx, jidx, didx = _indexes(query, k)
    codes = encode_ascii(reference)
    ms, iv = query_ms_codes(tidx, codes)
    translated = translate_ms_vec(
        derandomize_ms_vec(ms, k, threshold), k, threshold)
    index, ivals = _ivals(kind, tidx, didx, codes, ms)
    reset_stats()
    got = tgap.fill_gaps(translated, ms, ivals, reference, index, threshold, p)
    jreset()
    want = jgap.fill_gaps(translated, ms, iv, reference, jidx, threshold, p)
    assert_stats_match()
    return got, want


GOLDEN = [
    # (query, reference, k, threshold, expected): src/gap_filling.rs tests
    (b"TTGAGGCTGGGGAGAGCTG", b"TTGATTGGCTGGGCAGAGCTG", 7, 3,
     "MMMM--MMMMMMMGMMMMMMM"),
    (b"TTGATGTACAGACTGCGGAGAGCTG", b"TTGATTAACAGGCTGCGCAGAGCTG", 9, 4,
     "MMMMMGTMMMMAMMMMMGMMMMMMM"),
    (b"TTGATCTGGCTGCGGAGAGCTG", b"TTGAACAGGCTGCGCAGAGCTG", 9, 3,
     "MMMMTMTMMMMMMMGMMMMMMM"),
    (b"TTGGGCTGGCTGGGGAGAGCTG", b"TTGGACAGGCTGGGCAGAGCTG", 9, 3,
     "MMMMGMTMMMMMMMRRMMMMMM"),
    (b"TTGATCAGACTGCGGAGAGCTG", b"TTGAACAGGCTGCGCAGAGCTG", 9, 3,
     "MMMMTMMMAMMMMMGMMMMMMM"),
]


@pytest.mark.parametrize("kind", IVALS)
@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_fill_gaps_golden(case, kind):
    query, reference, k, t, expected = GOLDEN[case]
    got, want = _refine_both(query, reference, k, t, kind)
    assert got == want == list(expected)


@pytest.mark.parametrize("kind", IVALS)
def test_fill_gaps_k51_golden(kind):
    # reference: src/gap_filling.rs:860-891 (threshold 23)
    got, want = _refine_both(K51_QUERY.encode(), K51_REF.encode(), 51, 23,
                             kind, p=1e-7)
    assert got == want == list(K51_EXPECTED)


@pytest.mark.parametrize("kind", IVALS)
def test_fill_gaps_default_build_opts(kind):
    # reference: src/gap_filling.rs:894-922 (k = 31, derived threshold)
    q = DEFAULT_QUERY.encode()
    idx = kbo_tpu_torch.build([q], kbo_tpu_torch.BuildOpts(build_select=True))
    t = random_match_threshold(idx.k, idx.n_kmers, 4, 1e-7)
    got, want = _refine_both(q, DEFAULT_REF.encode(), idx.k, t, kind, p=1e-7)
    assert got == want == list(DEFAULT_EXPECTED)


@pytest.mark.parametrize("kind", IVALS)
def test_spec_helpers(kind):
    """nearest_unique_context and left_extend_over_gap on the reference's
    scenarios (src/gap_filling.rs:534-564, :91-125, :602-638, :258-293)."""
    for query, reference, k, args, want in [
        (b"TTGATGTACAGACAGCTGAGAGCTG", b"TTGATTAACAGGCAGCTCAGAGCTG", 9,
         (11, 16), (16, b"CAGACAGCT")),
        (b"TTGAACAGGCTGCGTAGAGCTG", b"TTGATCTGGCTGCTGAGAGCTG", 7,
         (8, 14), (12, b"AGGCTGC")),
    ]:
        tidx, jidx, didx = _indexes(query, k)
        codes = encode_ascii(reference)
        ms, iv = query_ms_codes(tidx, codes)
        index, ivals = _ivals(kind, tidx, didx, codes, ms)
        got = tgap.nearest_unique_context(ivals, index, *args)
        assert got == want == jgap.nearest_unique_context(iv, jidx, *args)
    for query, reference, k, args, want in [
        (b"TTGATCTGGCTGCGGAGAGCTG", b"TTGAACAGGCTGCGCAGAGCTG", 5,
         (3, 3, 4, 7, 4), b"TGATCTGGC"),
        (b"TTGATGTACAGACTGCGGAGAGCTG", b"TTGATTAACAGGCTGCGCAGAGCTG", 9,
         (4, 4, 5, 12, 6), b"TGATGTACAGACTGC"),
    ]:
        tidx, jidx, didx = _indexes(query, k)
        codes = encode_ascii(reference)
        ms, iv = query_ms_codes(tidx, codes)
        index, ivals = _ivals(kind, tidx, didx, codes, ms)
        got = tgap.left_extend_over_gap(ivals, reference, index, *args)
        assert got == want == jgap.left_extend_over_gap(
            iv, reference, jidx, *args)


def test_left_extend_kmer():
    """Full-length extension on all three indexes (src/gap_filling.rs:
    566-600, :168-204), and a short pattern (K0 < k, the rank walk) on the
    host index, against kbo_tpu; the device index refuses short patterns
    as kbo_tpu's does."""
    seq = b"TTGATGTACAGACTGCGGAGAGCTG"
    tidx, jidx, didx = _indexes(seq, 6)
    kmer = tidx.access_kmer(tidx.search_codes(encode_ascii(b"GACTGC"))[0])
    for index in (tidx, didx):
        assert tgap.left_extend_kmer(kmer, index, 8) == b"GATGTACAGACTGC"
    seq2 = b"TTGAACAGGCTGCCGTAACAGG"
    tidx, jidx, didx = _indexes(seq2, 7)
    for index in (tidx, didx):
        assert tgap.left_extend_kmer(b"AGGCTGC", index, 5) == b"AACAGGCTGC"
    for pat in (b"GGCTG", b"AACAG", b"CTGCC", b"TAAC"):
        assert tgap.left_extend_kmer(pat, tidx, 6) == jgap.left_extend_kmer(
            pat, jidx, 6)
    with pytest.raises(AssertionError, match="rank-backed"):
        tgap.left_extend_kmer(b"GGCTG", didx, 6)


def test_search_codes_batch_and_rank():
    """The lane-batched rank walk: intervals of random patterns (empty
    ones too) equal kbo_tpu's and the index's scalar search; the rank of
    every row boundary and past the end equals kbo_tpu's."""
    rng = np.random.default_rng(21)
    genome = BASES[rng.integers(0, 4, 700)].tobytes()
    tidx, jidx, _ = _indexes(genome, 11)
    pats = np.stack([encode_ascii(genome[p : p + 6])
                     for p in rng.integers(0, 690, 60)])
    pats = np.concatenate([pats, rng.integers(1, 5, (40, 6)).astype(np.uint8)])
    l, r = tgap.search_codes_batch(tidx, pats)
    jl, jr = jgap.search_codes_batch(jidx, pats)
    np.testing.assert_array_equal(l, jl)
    np.testing.assert_array_equal(r, jr)
    for i in range(pats.shape[0]):
        res = tidx.search_codes(pats[i])  # None: the empty interval
        assert (res is None) == (r[i] <= l[i])
        assert res is None or tuple(res) == (l[i], r[i])
    assert (r > l).sum() >= 60
    pos = np.arange(0, tidx.n_rows + 40, 7)
    for base in range(4):
        np.testing.assert_array_equal(
            tgap._rank_batch(tidx, base, pos), jgap._rank_batch(jidx, base, pos))


def _pair(seed, n=2500, k=31):
    """A reference against an indexed query with SNPs, a 3-base deletion,
    an insertion and a low-identity block, so that gaps need left
    extension and some stay unfilled."""
    rng = np.random.default_rng(seed)
    query = BASES[rng.integers(0, 4, n)].tobytes()
    ref = bytearray(query)
    for p in range(300, n - 300, 170):
        ref[p] = BASES[(BASES.tolist().index(ref[p]) + 1) % 4]
    del ref[1000:1003]
    ref[1500:1500] = b"GATTA"
    ref[1800:1860] = BASES[rng.integers(0, 4, 60)].tobytes()
    return bytes(ref), query


@pytest.mark.parametrize("seed,k", [(1, 31), (2, 51)])
def test_fill_gaps_patches_without_grid(seed, k):
    """fill_gaps_patches(grid=None) over every gap run of a translation,
    with the intervals as an array and as SparseIntervals over the host
    and the device index, at two error bounds: the patches and the run's
    stats equal kbo_tpu's; gap_probe_positions and _gap_runs too."""
    ref, query = _pair(seed, k=k)
    tidx, jidx, didx = _indexes(query, k)
    codes = encode_ascii(ref)
    ms = engine.compute_ms_values(tidx, codes, "cpu")
    t = random_match_threshold(k, tidx.n_kmers, 4, 1e-7)
    translated = translate_ms_vec(derandomize_ms_vec(ms, k, t), k, t)
    runs = tgap._gap_runs(translated, t)
    assert runs == jgap._gap_runs(translated, t) and len(runs) > 5
    probe = tgap.gap_probe_positions(runs, len(ref), k, t)
    np.testing.assert_array_equal(
        probe, jgap.gap_probe_positions(runs, len(ref), k, t))
    iv = engine.compute_ms_intervals_at(tidx, codes, np.arange(len(ref)),
                                        ms=ms, device="cpu")[1]
    np.testing.assert_array_equal(
        iv[probe], jengine.compute_ms_intervals_at(jidx, codes, probe, ms=ms)[1])
    n_patch = 0
    for p_err in (1e-7, 1e-3):
        jreset()
        want = jgap.fill_gaps_patches(runs, iv, ref, jidx, t, p_err)
        for index, ivals in [
            (tidx, iv),
            (tidx, engine.SparseIntervals(tidx, codes, ms=ms, device="cpu")),
            (didx, engine.SparseIntervals(didx, codes, ms=ms, device="cpu")),
        ]:
            reset_stats()
            got = tgap.fill_gaps_patches(runs, ivals, ref, index, t, p_err)
            assert got == want
            assert_stats_match()
        n_patch += len(want)
    assert n_patch > 0
    reset_stats()
    got = tgap.fill_gaps(translated, ms, iv, ref, tidx, t, 1e-7)
    assert got == jgap.fill_gaps(translated, ms, iv, ref, jidx, t, 1e-7)
    assert got != translated
