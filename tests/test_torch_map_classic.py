"""The port's 2-bit map path (api._map_classic: the k >= 128 and
over-budget route) against kbo_tpu's classic branch, on the CPU.

Its pieces one by one (map_sweep_compact_core, fetch_candidates,
variant_patches / add_variants, assemble_map_core + fetch_delta_runs), the
route function at its boundaries, and map_ / map_batch at k = 151 against
kbo_tpu.api.map_batch, which takes its classic branch at every k >= 128.
Exact equality throughout (integers and bytes); the k = 31 classic flow
is in tests/test_torch_map_classic_k31.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu import engine as jengine
from kbo_tpu.kernels import mapsweep as jmap
from kbo_tpu.ops import translate as jtr
from kbo_tpu.refine.variant_calling import Variant as JVariant
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch.engine import device_index
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import mapsweep as tmap
from kbo_tpu_torch.kernels.ms import _PACKED_SLOT_LIMIT
from kbo_tpu_torch.ops import translate as ttr
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.refine.variant_calling import Variant
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pair(seed, n, snp_every=330):
    """(reference, indexed query): SNPs, a 12-base deletion, a 7-base
    insertion and an N run planted in the reference."""
    rng = np.random.default_rng(900 + seed)
    query = bytearray(BASES[rng.integers(0, 4, n)].tobytes())
    ref = bytearray(query)
    for p in range(40, n - 40, snp_every):
        ref[p] = BASES[(np.searchsorted(BASES, ref[p]) + 1) % 4]
    del ref[n // 2 : n // 2 + 12]
    ref[n // 4 : n // 4] = BASES[rng.integers(0, 4, 7)].tobytes()
    ref[700:706] = b"NNNNNN"
    return bytes(ref), bytes(query)


def _mopts(mod, k, fmt=True, **kw):
    return mod.MapOpts(format=fmt, sbwt_build_opts=mod.BuildOpts(k=k), **kw)


def _indexes(query, k):
    return (kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=k)),
            kbo_tpu.build([query], kbo_tpu.BuildOpts(k=k)))


# ------------------------------------------------- the sweep, one by one


@pytest.mark.parametrize("k", [31, 151])
def test_map_sweep_compact_core_equal(k):
    """chars and MS inside each row's length, counts, and the compacted
    drop / gap-start / gap-end arrays up to each count; three contigs, one
    unrelated and one shorter than k."""
    ref, query = _pair(1, 2600)
    rng = np.random.default_rng(k)
    contigs = [ref[:1500], BASES[rng.integers(0, 4, 400)].tobytes(),
               ref[1500 : 1500 + k - 9], ref[1500:]]
    L = 2048
    codes = np.full((len(contigs), L), 255, np.uint8)
    for q, c in enumerate(contigs):
        codes[q, : len(c)] = encode_ascii(c)
    lengths = np.asarray([len(c) for c in contigs], np.int32)
    tidx, jidx = _indexes(query, k)
    t = random_match_threshold(k, tidx.n_kmers, 4, 1e-7)
    tdev = device_index(tidx, "cpu")
    got = tmap.map_sweep_compact_core(
        tdev.keys2, tdev.cap2, torch.from_numpy(codes),
        torch.from_numpy(lengths), k, t,
    )
    jdev = jengine.device_index(jidx)
    want = jmap.map_sweep_compact(
        jdev.keys2, jdev.cap2, jnp.asarray(codes), jnp.asarray(lengths), k,
        jnp.int32(t),
    )
    chars, ms, counts, drop_pos, gap_start, gap_end = (
        x.numpy() for x in got)
    w = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(counts, w[2])
    assert counts[:, 0].sum() > 3 and counts[:, 1].sum() > 3
    for q, n in enumerate(lengths):
        np.testing.assert_array_equal(chars[q, :n], w[0][q, :n])
        np.testing.assert_array_equal(ms[q, :n], w[1][q, :n])
        nd, ng = counts[q]
        np.testing.assert_array_equal(drop_pos[q, :nd], w[3][q, :nd])
        np.testing.assert_array_equal(gap_start[q, :ng], w[4][q, :ng])
        np.testing.assert_array_equal(gap_end[q, :ng], w[5][q, :ng])
    assert drop_pos.shape == gap_start.shape == gap_end.shape == (4, L)
    assert (drop_pos[np.arange(L)[None] >= counts[:, :1]] == 2**31 - 1).all()


def test_fetch_candidates_short_reference():
    """Rows shorter than the capacities pad with BIG (kbo_tpu's regression
    tests/test_mapsweep.py::test_classic_map_path_short_reference), rows
    longer are sliced."""
    rng = np.random.default_rng(3)
    Q, L = 2, 100
    counts = np.asarray([[3, 2], [0, 1]], np.int32)
    arrs = [np.sort(rng.integers(0, L, (Q, L)), axis=1).astype(np.int32)
            for _ in range(3)]
    for cap_d, cap_g in ((256, 256), (64, 512), (16, 8)):
        got = tmap.fetch_candidates(
            *(torch.from_numpy(a) for a in (counts, *arrs)), cap_d, cap_g)
        want = jmap.fetch_candidates(
            *(jnp.asarray(a) for a in (counts, *arrs)), cap_d, cap_g)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (Q, 2 + cap_d + 2 * cap_g)


# ----------------------------------------------- variants as patches


def test_variant_patches_and_add_variants():
    """Substitution, insertion, deletion, unequal and uniform multi-base
    substitutions; later writes win; an insertion at position 0 asserts."""
    rows = [(3, b"A", b"G"), (10, b"", b"T"), (14, b"CC", b""),
            (20, b"ACG", b"TTA"), (25, b"AA", b"GG"), (30, b"ACG", b"TA"),
            (31, b"G", b"C"), (40, b"TT", b"GGG")]
    tv = [Variant(*r) for r in rows]
    jv = [JVariant(*r) for r in rows]
    assert ttr.variant_patches(tv) == jtr.variant_patches(jv)
    translation = list("M" * 50)
    got = ttr.add_variants(translation, tv)
    assert got == jtr.add_variants(translation, jv)
    assert "".join(got[9:11]) == "II" and got[14:16] == ["D", "D"]
    assert got[30:33] == ["N", "C", "N"] and got[25:27] == ["G", "G"]
    with pytest.raises(AssertionError, match="position 0"):
        ttr.variant_patches([Variant(0, b"", b"A")])


# ------------------------------------------------ assembly and fetch


@pytest.mark.parametrize("fmt", [True, False])
def test_assemble_map_core_and_fetch_equal(fmt):
    """Patches land (out-of-range and negative ones inert), the delta runs
    and their fetch at a capacity over and under the run count equal
    kbo_tpu's."""
    rng = np.random.default_rng(12)
    Q, L = 3, 1024
    chars = rng.choice(np.frombuffer(b"MMMMMMX-R", np.uint8), (Q, L))
    chars[1, 300:420] = ord("-")
    ref = rng.choice(BASES, (Q, L))
    lengths = np.asarray([L, 700, 37], np.int32)
    pos = np.asarray([5, 7, L + 301, L + 699, Q * L, Q * L + 9, 2 * L + 36],
                     np.int32)
    val = np.frombuffer(b"ACGTTGa", np.uint8).copy()
    got = tmap.assemble_map_core(
        *(torch.from_numpy(a) for a in (chars, ref, lengths, pos, val)), fmt)
    want = jmap.assemble_map(
        *(jnp.asarray(a) for a in (chars, ref, lengths, pos, val)), fmt)
    n = int(got[0][0])
    assert n > 64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])
    for cap in (64, 4096):
        d = tmap.fetch_delta_runs(*got, cap)
        np.testing.assert_array_equal(
            d.numpy(), np.asarray(jmap.fetch_delta_runs(*want, cap)))
        assert d.shape == (4, cap) and int(d[3, 0]) == n


# -------------------------------------------------------------- route


def test_map_route_boundary():
    """Single shot while Q (L + k - 1) fits the rows join's slot budget,
    chunked while a chunk of at least 4k positions fits, the 2-bit sweep
    past that and at every k >= 128; no compute."""
    T, L, k = 4_720_000, 1024, 31
    budget = _PACKED_SLOT_LIMIT - T
    q_single = -(-budget // (L + k - 1)) - 1
    assert tapi.map_route(k, q_single, L, T) == ("rows", 0)
    assert tapi.map_route(k, q_single + 1, L, T)[0] == "rows"
    # the last Q whose chunk still holds 4k positions, and the first past
    q_last = (budget - 1) // (5 * k - 1)
    route, chunk = tapi.map_route(k, q_last, L, T)
    assert route == "rows" and 4 * k <= chunk < L
    assert q_last * (chunk + k - 1) < budget
    assert tapi.map_route(k, q_last + 1, L, T) == ("classic", 0)
    # the over-budget many-contig shape: chunked at k = 31, not at 51
    assert tapi.map_route(k, 60_000, L, T)[0] == "rows"
    assert tapi.map_route(51, 60_000, L, T) == ("classic", 0)
    assert tapi.map_route(127, 1, L, T) == ("rows", 0)
    assert tapi.map_route(128, 1, L, T) == ("classic", 0)
    assert tapi.map_route(254, 1, 1 << 23, 0) == ("classic", 0)
    # a long single contig chunks
    route, chunk = tapi.map_route(k, 1, 40_000_000, T)
    assert route == "rows" and 0 < chunk < 40_000_000


# -------------------------------------------------------- end to end


@pytest.mark.parametrize("fmt", [True, False])
def test_map_k151_equals_kbo_tpu(fmt):
    ref, query = _pair(2, 3000)
    tidx, jidx = _indexes(query, 151)
    reset_stats()
    got = kbo_tpu_torch.map_(ref, tidx, _mopts(kbo_tpu_torch, 151, fmt),
                             device="cpu")
    st = get_stats().as_dict()
    want = japi.map_batch([ref], jidx, _mopts(kbo_tpu, 151, fmt))[0]
    assert got == want and len(got) == len(ref)
    assert st["variants_called"] > 3 and st["gaps_seen"] > 3
    assert "gap_bases_unfilled" in st and st["map_call_calls"] == 1
    if fmt:
        assert b"-" in got and set(got) <= set(b"ACGTN-")
    else:
        assert set(got) - set(b"MX-R")  # variant patches landed


def test_map_batch_k151_contigs():
    """Contigs at k = 151: one under 1024 bases (call builds its own host
    index), one shorter than k (no windows), one lower-case, one
    unrelated; format true and false. The lower-case contig takes gap
    filling alone: with variant calling kbo_tpu's host resolve asserts on
    it, and so does the port's."""
    ref, query = _pair(3, 4000, snp_every=250)
    rng = np.random.default_rng(4)
    contigs = [ref[:2200], ref[2200:2900], ref[2900:3000],
               BASES[rng.integers(0, 4, 1500)].tobytes()]
    tidx, jidx = _indexes(query, 151)
    for fmt in (True, False):
        got = kbo_tpu_torch.map_batch(
            contigs, tidx, _mopts(kbo_tpu_torch, 151, fmt), device="cpu")
        want = japi.map_batch(contigs, jidx, _mopts(kbo_tpu, 151, fmt))
        assert got == want
        assert [len(g) for g in got] == [len(c) for c in contigs]
    assert set(got[0]) - set(b"MX-R")  # variant patches landed
    lower = contigs + [ref[3000:].lower()]
    for fmt in (True, False):
        kw = {"call_variants": False}
        got = kbo_tpu_torch.map_batch(
            lower, tidx, _mopts(kbo_tpu_torch, 151, fmt, **kw), device="cpu")
        assert got == japi.map_batch(lower, jidx,
                                     _mopts(kbo_tpu, 151, fmt, **kw))
    assert b"X" in got[4] and got[4].count(b"M") > 900
    with pytest.raises(AssertionError):
        japi.map_batch(lower, jidx, _mopts(kbo_tpu, 151))
    with pytest.raises(AssertionError):
        kbo_tpu_torch.map_batch(lower, tidx, _mopts(kbo_tpu_torch, 151),
                                device="cpu")
