"""The host gap pass's left extension on a device index: the walk along the
chain table's links (kernels/refine.py ``ext_walk``) against the rounds of
refine/gap_filling.py::_left_extend_batch, lane for lane, on the CPU.

The rounds run on the host index (its binary search) and on a device-built
full index (its membership probes); the walk reads the links of the same
key table. The indexed sequences hold a segment after two different chars
(a row with two predecessors), sequence starts (none), a pure tandem repeat
(a chain that cycles) and the '$' dummy rows every start brings.
"""

import numpy as np
import pytest
import torch

import kbo_tpu_torch
from kbo_tpu_torch import api, engine
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import refine as tref
from kbo_tpu_torch.ops.derandomize import (
    derandomize_ms_vec,
    random_match_threshold,
)
from kbo_tpu_torch.ops.ms import query_ms_codes
from kbo_tpu_torch.ops.translate import translate_ms_vec
from kbo_tpu_torch.refine import gap_filling as tgap
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random(rng, n: int) -> bytes:
    return BASES[rng.integers(0, 4, n)].tobytes()


def _seqs(rng):
    """A random sequence holding segment s after 'A' and after 'C', and a
    sequence that is a tandem repeat of a 7-base unit and nothing else."""
    s = _random(rng, 40)
    main = (_random(rng, 300) + b"A" + s + _random(rng, 300) + b"C" + s
            + _random(rng, 300))
    return [main, b"ACGTTGA" * 20], s


def _walked(link, kmers, rows, budgets):
    chars, n_ext = tref.ext_walk(link, torch.from_numpy(rows),
                                 torch.from_numpy(budgets),
                                 int(budgets.max()))
    chars, n_ext = chars.numpy(), n_ext.numpy()
    assert chars.shape == (rows.size, int(budgets.max()))
    for i in range(rows.size):
        assert not chars[i, n_ext[i]:].any()
    return [np.concatenate([chars[i, : n_ext[i]][::-1], kmers[i]])
            for i in range(rows.size)], n_ext


@pytest.mark.parametrize("kind", ["host", "device_full"])
@pytest.mark.parametrize("k", [15, 31])
def test_walk_equals_rounds(kind, k):
    """Every row of the index as a lane at budgets 0, 1, k-1, k, k+1 and
    4k: the same extended codes and lengths as the rounds."""
    rng = np.random.default_rng(k)
    seqs, s = _seqs(rng)
    bo = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    if kind == "host":
        index = kbo_tpu_torch.build(seqs, bo)
        link = tref.get_ext_links(engine.device_index(index, "cpu"))
    else:
        index = api.build_device(seqs, bo, full=True, device="cpu")
        link = tref.get_ext_links(index)
    n = index.n_rows
    rows = np.tile(np.arange(n, dtype=np.int64), 6)
    budgets = np.repeat(
        np.asarray([0, 1, k - 1, k, k + 1, 4 * k], dtype=np.int64), n)
    kmers = index.access_kmers_codes(rows).astype(np.uint8)
    reset_stats()
    want = tgap._left_extend_batch(index, kmers, budgets)
    assert get_stats().as_dict()["host_ext_rounds"] == 4 * k
    got, n_ext = _walked(link, kmers, rows, budgets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    top = budgets == 4 * k
    text = [index.access_kmer(int(r)) for r in range(n)]
    # the tandem repeat's chain cycles past its 7 rows up to the budget
    cyc = [r for r in range(n) if text[r] == (b"ACGTTGA" * 20)[7 : 7 + k]]
    assert n_ext[top][cyc] == 4 * k
    # s's first k-mer has two predecessors, 'A' and 'C': a lane five chars
    # to its right stops after five
    at5 = [r for r in range(n) if text[r] == s[5 : 5 + k]]
    assert n_ext[top][at5] == 5
    # the first k-mer of a sequence has none but '$'
    first = [r for r in range(n) if text[r] == seqs[0][:k]]
    assert n_ext[top][first] == 0
    # the '$' rows (and the all-'$' row) never extend
    dollar = [r for r in range(n) if text[r][:1] == b"$"]
    assert len(dollar) >= 2 * (k - 1) and not n_ext[top][dollar].any()
    assert (n_ext[top] > k).any() and (n_ext[top] < 4 * k).any()


def _grid(tasks, iv, w: int) -> np.ndarray:
    """The device sweep's candidate grid from an interval array: the colex
    row of position search_lo + c where its interval is a singleton, else
    -1 (kernels.mapsweep.map_postprocess3_core)."""
    grid = np.full((len(tasks), w), -1, dtype=np.int64)
    for g, t in enumerate(tasks):
        for c in range(w):
            p = t.search_lo + c
            if p <= t.search_hi and iv[p, 1] - iv[p, 0] == 1:
                grid[g, c] = iv[p, 0]
    return grid


def test_fill_gaps_patches_walk_equals_rounds():
    """A gap wider than k (an unrelated 100-base stretch at k = 31, which
    the evaluator extends past k and rejects) and SNP pairs 8, 16 and 24
    bases apart (gaps filled through extensions) through the host evaluator
    from a grid and from intervals: a device full index (the walk) gives
    the host index's patches (the rounds)."""
    rng = np.random.default_rng(5)
    k = 31
    query = _random(rng, 4000)
    ref = bytearray(query)
    ref[1000:1100] = _random(rng, 100)
    for p in (2000, 2008, 2600, 2616, 3200, 3224):
        ref[p] = BASES[(BASES.tolist().index(ref[p]) + 1) % 4]
    ref = bytes(ref)
    bo = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    host = kbo_tpu_torch.build([query], bo)
    full = api.build_device([query], bo, full=True, device="cpu")
    t = random_match_threshold(k, host.n_kmers, 4, 1e-7)
    ms, iv = query_ms_codes(host, encode_ascii(ref))
    runs = tgap._gap_runs(translate_ms_vec(derandomize_ms_vec(ms, k, t), k, t),
                          t)
    assert max(e - s for s, e in runs) > k
    grid = _grid(tgap._gap_tasks(runs, len(ref), k, t), iv, k - t + 1)
    for g in (grid, None):
        out = {}
        for name, index in (("host", host), ("full", full)):
            reset_stats()
            out[name] = tgap.fill_gaps_patches(runs, iv, ref, index, t, 1e-7,
                                               grid=g)
            out[name + "_stats"] = get_stats().as_dict()
        assert out["full"] == out["host"] and len(out["host"]) > 20
        assert out["full_stats"]["gaps_filled"] == 4
        assert out["host_stats"]["host_ext_rounds"] > 0
        assert "host_ext_walk_lanes" not in out["host_stats"]
        assert out["full_stats"]["host_ext_walk_lanes"] > 0
        assert "host_ext_rounds" not in out["full_stats"]
