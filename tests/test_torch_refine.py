"""The port's device refinement (kernels/refine.py) and host gap evaluator
(refine/gap_filling.py) against kbo_tpu's, element for element, on the CPU.

One small pair at k=51 (SNPs, deletions and a low-identity block, so that
variants resolve, gap runs need left extension and some gaps go to the host
evaluator). Both sides get the same sweep tables; kbo_tpu runs its jitted
cores on the JAX CPU backend, the port its plain torch path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kbo_tpu_torch
from kbo_tpu.kernels import refine as jref
from kbo_tpu.refine import gap_filling as jgap
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import mapsweep as tmap
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.kernels import refine as tref
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.refine import gap_filling as tgap

torch.set_num_threads(2)

K = 51
L = 8192
CAP = 256
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pair(seed, n=6000):
    """(reference contigs, indexed query): SNPs every 400, 3-base deletions
    every 2500, and a 120-base low-identity block."""
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(500, n - 500, 400):
        query[p] = BASES[rng.integers(0, 4)]
    for p in range(n // 6, n - n // 6, 2500):
        del query[p : p + 3]
    for p in range(n // 2, n // 2 + 120):
        query[p] = BASES[rng.integers(0, 4)]
    return ref, bytes(query)


@pytest.fixture(scope="module")
def case():
    ref, query = _pair(23)
    idx = kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=K))
    t = random_match_threshold(K, idx.n_kmers, 4, 1e-7)
    contigs = [ref, ref[:2500], ref[2500:]]  # one contig, then three
    keys3 = torch.from_numpy(np.ascontiguousarray(idx.keys3).view(np.int32))
    packed = tms.rows_ref_packed(tms.lcs3_from_keys3(keys3, K), K)
    out = {"idx": idx, "t": t, "keys3": keys3}
    for name, refs in (("one", contigs[:1]), ("three", contigs)):
        Q = len(refs)
        codes = np.full((Q, L), 255, np.uint8)
        ref_mat = np.zeros((Q, L), np.uint8)
        for q, r in enumerate(refs):
            codes[q, : len(r)] = encode_ascii(r)
            ref_mat[q, : len(r)] = np.frombuffer(r, np.uint8)
        lengths = np.asarray([len(r) for r in refs], np.int32)
        ms, uniq, rows, qtabs = tmap.ms3_rows_sweep(
            keys3, packed, torch.from_numpy(codes), K, want_qtable=True
        )
        w = K - t + 1
        _, pk, pieces = tmap.map_postprocess3_core(
            ms, uniq, rows, torch.from_numpy(lengths), K, t, CAP, CAP, w
        )
        out[name] = dict(refs=refs, codes=codes, ref_mat=ref_mat,
                         lengths=lengths, ms=ms, pieces=pieces, packed=pk,
                         qtabs=qtabs)
    return out


def _j(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("name", ["one", "three"])
def test_seq_keys3_tagged_equal(case, name, rc):
    codes = case[name]["codes"]
    if rc:
        got = tref.seq_keys3_tagged_rc(torch.from_numpy(codes), K)
        want = jref.seq_keys3_tagged_rc(jnp.asarray(codes), k=K)
    else:
        got = tref.seq_keys3_tagged_core(torch.from_numpy(codes), K)
        want = jref.seq_keys3_tagged(jnp.asarray(codes), k=K)
    want = np.stack([np.asarray(w) for w in want]).view(np.int32)
    assert got.shape[0] == (7 if name == "three" else 6)  # tag word at W=6
    _eq(got, want)


@pytest.mark.parametrize(
    "branch", ["seq_tables", "tagged", "revcomp", "untagged_d_lo0"]
)
def test_resolve_variants_equal(case, branch):
    c = case["three" if branch == "tagged" else "one"]
    t = case["t"]
    codes = torch.from_numpy(c["codes"])
    pieces = c["pieces"]
    d_lo = 0 if branch == "untagged_d_lo0" else t - 1
    seq_tables = seq_words = j_tables = j_words = None
    if branch == "seq_tables":
        seq_tables = c["qtabs"]
        j_tables = [(tuple(_j(w) for w in tw), _j(tl)) for tw, tl in seq_tables]
    elif branch == "revcomp":
        seq_words = tref.seq_keys3_tagged_rc(codes, K)
        j_words = jref.seq_keys3_tagged_rc(jnp.asarray(c["codes"]), k=K)
    else:
        seq_words = tref.seq_keys3_tagged_core(codes, K)
        j_words = jref.seq_keys3_tagged(jnp.asarray(c["codes"]), k=K)
    got = tref.resolve_variants_core(
        case["keys3"], seq_words, codes, torch.from_numpy(c["ref_mat"]),
        c["ms"], torch.from_numpy(c["lengths"]), pieces["drop_pos"],
        pieces["apos"], pieces["arow"], t, K, CAP, d_lo=d_lo,
        seq_tables=seq_tables,
    )
    want = jref.resolve_variants(
        jnp.asarray(case["idx"].keys3), j_words, jnp.asarray(c["codes"]),
        jnp.asarray(c["ref_mat"]), _j(c["ms"]), jnp.asarray(c["lengths"]),
        _j(pieces["drop_pos"]), _j(pieces["apos"]), _j(pieces["arow"]),
        jnp.int32(t), k=K, cap_d=CAP, d_lo=d_lo, seq_tables=j_tables,
    )
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[2]) > 0, "the pair must resolve variants"
    if branch == "seq_tables":
        # the bitonic merge in the rk-vs-seq join gives the same patches
        again = tref.resolve_variants_core(
            case["keys3"], None, codes, torch.from_numpy(c["ref_mat"]),
            c["ms"], torch.from_numpy(c["lengths"]), pieces["drop_pos"],
            pieces["apos"], pieces["arow"], t, K, CAP, d_lo=d_lo,
            seq_tables=seq_tables, merge="bitonic",
        )
        for g, w in zip(again, got):
            assert torch.equal(g, w)


def test_ext_table_equal(case):
    keys3 = case["keys3"]
    ew, el = tref.build_ext_table_core(keys3, K)
    jw, jl = jref.build_ext_table(jnp.asarray(case["idx"].keys3), K)
    _eq(ew, np.asarray(jw).view(np.int32))
    _eq(el, jl)
    assert (el > 0).any(), "chains must exist on this input"
    rng = np.random.default_rng(5)
    n = keys3.shape[1]
    rows = rng.integers(-1, n, 300).astype(np.int32)
    budgets = np.concatenate(
        [np.zeros(40), np.ones(40), np.full(40, K), rng.integers(-2, K + 3, 180)]
    ).astype(np.int32)
    km = tref.unpack_rows3(keys3, torch.from_numpy(rows), K)
    _eq(km, jref.unpack_rows3(jnp.asarray(case["idx"].keys3),
                              jnp.asarray(rows), K))
    got = tref.ext_from_table(ew, el, torch.from_numpy(rows), km,
                              torch.from_numpy(budgets), K)
    want = jref.ext_from_table(jw, jl, jnp.asarray(rows), _j(km),
                               jnp.asarray(budgets), K)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("cap_ext,with_bound", [(256, True), (2, True),
                                                (256, False)])
@pytest.mark.parametrize("name", ["one", "three"])
def test_score_gaps_equal(case, name, cap_ext, with_bound):
    """cap_ext=2 overflows the extension lanes: those gaps are flagged for
    the host evaluator on both sides."""
    c = case[name]
    t = case["t"]
    p = c["pieces"]
    bound = tref.prob_bound(1e-7) if with_bound else None
    ext = tref.build_ext_table_core(case["keys3"], K)
    got = tref.score_gaps_core(
        case["keys3"], torch.from_numpy(c["ref_mat"]),
        torch.from_numpy(c["lengths"]), p["gap_start"], p["gap_end_at"],
        p["grid"], t, K, CAP, cap_ext, ext, bound,
    )
    want = jref.score_gaps(
        jnp.asarray(case["idx"].keys3), jnp.asarray(c["ref_mat"]),
        jnp.asarray(c["lengths"]), _j(p["gap_start"]), _j(p["gap_end_at"]),
        _j(p["grid"]), jnp.int32(t), k=K, cap_ge=CAP, cap_ext=cap_ext,
        ext_tab=(_j(ext[0]), _j(ext[1])), bound=bound,
    )
    for g, w in zip(got, want):
        _eq(g, w)
    seen, filled, _ = got[3].tolist()
    assert seen > 0 and filled > 0
    if cap_ext == 2:
        assert got[2].any(), "a lane overflow must flag a gap for the host"


def test_fill_gaps_patches_grid_equal(case):
    """Every gap of the three-contig batch through the host evaluator, from
    the device grid, on both sides (stats included)."""
    from kbo_tpu.utils.stats import reset_stats as jreset
    from kbo_tpu_torch.utils.stats import reset_stats
    from test_torch_gap_filling import assert_stats_match

    import kbo_tpu

    c = case["three"]
    t = case["t"]
    ref0 = c["refs"][0]
    _, query = _pair(23)
    jindex = kbo_tpu.build([query], kbo_tpu.BuildOpts(k=K))
    block = c["packed"].numpy()
    w = c["pieces"]["grid"].shape[-1]
    n_patch = 0
    for q, ref in enumerate(c["refs"]):
        ng = int(block[q, 1])
        starts = block[q, 2 + CAP : 2 + CAP + ng]
        ends = block[q, 2 + 2 * CAP : 2 + 2 * CAP + ng]
        grid = block[q, 2 + 5 * CAP : 2 + 5 * CAP + CAP * w].reshape(CAP, w)[:ng]
        runs = [(int(s), int(e)) for s, e in zip(starts, ends)]
        for p_err in (1e-7, 1e-3):
            reset_stats()
            jreset()
            got = tgap.fill_gaps_patches(runs, None, ref, case["idx"], t,
                                         p_err, grid=grid)
            want = jgap.fill_gaps_patches(runs, None, ref, jindex, t, p_err,
                                          grid=grid)
            assert got == want
            assert_stats_match()
            n_patch += len(got)
    assert n_patch > 0
    # without a grid the same runs read colex intervals (the interval gap
    # path): equal to kbo_tpu's from the same interval array
    from kbo_tpu_torch import engine

    ng = int(block[0, 1])
    runs = [(int(s), int(e)) for s, e in zip(
        block[0, 2 + CAP : 2 + CAP + ng], block[0, 2 + 2 * CAP : 2 + 2 * CAP + ng])]
    iv = engine.compute_ms_intervals_at(
        case["idx"], encode_ascii(ref0), np.arange(len(ref0)), device="cpu")[1]
    got = tgap.fill_gaps_patches(runs, iv, ref0, case["idx"], t, 1e-7)
    assert got == jgap.fill_gaps_patches(runs, iv, ref0, jindex, t, 1e-7)


def test_overlap_helpers_equal():
    rng = np.random.default_rng(8)
    for _ in range(200):
        kmer = BASES[rng.integers(0, 2, rng.integers(1, 12))].tobytes()
        ref = BASES[rng.integers(0, 2, rng.integers(1, 16))].tobytes()
        end = int(rng.integers(0, len(ref) + 1))
        start = int(rng.integers(0, len(ref)))
        assert tgap.count_right_overlaps(kmer, ref, end) == \
            jgap.count_right_overlaps(kmer, ref, end)
        assert tgap.count_left_overlaps(kmer, ref, start) == \
            jgap.count_left_overlaps(kmer, ref, start)
    m = rng.random((50, 20)) < 0.7
    assert np.array_equal(tgap._leading_runs(m), jgap._leading_runs(m))
    assert np.array_equal(tgap._trailing_runs(m), jgap._trailing_runs(m))
    for row in m:
        for b in (-1e-7, -1e-3, -0.5):
            assert tgap._run_log_prob(row, b) == jgap._run_log_prob(row, b)
