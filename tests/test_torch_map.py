"""The port's map_ / map_batch against kbo_tpu's, on the CPU: the sweep,
candidate tables and assembly with the refinements off, and the default
``MapOpts()`` on the reference's map doctests and tiny inputs
(tests/test_torch_map_devref.py and test_torch_map_fuzz.py hold the
refinement at larger sizes).

kbo_tpu.api.map_batch runs its single-device fused branch (the same one the
port carries over); kbo_tpu.api.map_ sends inputs under 256 bases to the
host oracle, a second, independent check. Outputs are equal byte for byte.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu_torch.kernels import mapsweep as tmap
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.kernels import refine as refine_kernels
from kbo_tpu_torch.refine import device_map
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _opts(mod, fmt, **kw):
    return mod.MapOpts(fill_gaps=False, call_variants=False, format=fmt, **kw)


def _both_indexes(query, k):
    return (
        kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=k)),
        kbo_tpu.build([query], kbo_tpu.BuildOpts(k=k)),
    )


def _planted(seed, n=900):
    """A reference and a query with SNPs, a deletion, an insertion and an N
    run planted between them."""
    rng = np.random.default_rng(700 + seed)
    query = bytearray(BASES[rng.integers(0, 4, n)].tobytes())
    ref = bytearray(query)
    for p in range(40, n - 40, 130):
        ref[p] = BASES[(np.searchsorted(BASES, ref[p]) + 1) % 4]
    del ref[n // 2 : n // 2 + 12]
    ref[n // 4 : n // 4] = BASES[rng.integers(0, 4, 7)].tobytes()
    ref[700:706] = b"NNNNNN"
    return bytes(ref), bytes(query)


@pytest.mark.parametrize("fmt", [True, False])
@pytest.mark.parametrize("k,seed", [(7, 0), (31, 1), (51, 2)])
def test_map_equals_kbo_tpu(k, seed, fmt):
    ref, query = _planted(seed)
    tidx, jidx = _both_indexes(query, k)
    got = kbo_tpu_torch.map_(ref, tidx, _opts(kbo_tpu_torch, fmt), device="cpu")
    want = japi.map_batch([ref], jidx, _opts(kbo_tpu, fmt))[0]
    assert got == want
    assert len(got) == len(ref)
    if fmt and k > 7:
        assert b"-" in got and set(got) <= set(b"ACGTN-")
    elif k > 7:
        assert set(got) <= set(b"MX-R")


@pytest.mark.parametrize("fmt", [True, False])
def test_map_batch_equals_kbo_tpu(fmt):
    """Several contigs, one shorter than k, one unrelated, lower case."""
    k = 31
    ref, query = _planted(5, n=2000)
    rng = np.random.default_rng(9)
    contigs = [
        ref[:800], ref[800:1500].lower(), ref[1500 : 1500 + k - 4],
        BASES[rng.integers(0, 4, 400)].tobytes(), ref[1500:],
    ]
    tidx, jidx = _both_indexes(query, k)
    reset_stats()
    got = kbo_tpu_torch.map_batch(contigs, tidx, _opts(kbo_tpu_torch, fmt),
                                  device="cpu")
    want = japi.map_batch(contigs, jidx, _opts(kbo_tpu, fmt))
    assert got == want
    assert [len(g) for g in got] == [len(c) for c in contigs]
    stats = get_stats().as_dict()
    assert stats["map_sweep_bases"] == sum(len(c) for c in contigs)
    assert stats["gap_bases_unfilled"] > 0
    # one contig at a time gives the same bytes
    for c, g in zip(contigs[:2], got[:2]):
        assert kbo_tpu_torch.map_(c, tidx, _opts(kbo_tpu_torch, fmt),
                                  device="cpu") == g


def test_map_batch_empty_and_bytearray():
    tidx, _ = _both_indexes(b"ACGTACGTAGGATTACAGATTACA", 5)
    assert kbo_tpu_torch.map_batch([], tidx, _opts(kbo_tpu_torch, True),
                                   device="cpu") == []
    a = kbo_tpu_torch.map_(bytearray(b"ACGTACGTAGG"), tidx,
                           _opts(kbo_tpu_torch, True), device="cpu")
    assert a == kbo_tpu_torch.map_(b"ACGTACGTAGG", tidx,
                                   _opts(kbo_tpu_torch, True), device="cpu")


@pytest.mark.parametrize(
    "fmt,want",
    [
        (True, b"CGTTGACT---GGTGCCTGGGTTCTCAGAGCTGGGC"),  # src/lib.rs:663-689
        (False, b"MMMMMMMM---MMMMMMMMMMMMMMMMMMMMMMMMM"),  # src/lib.rs:691-718
    ],
)
def test_map_doctests(fmt, want):
    reference = b"CGTTGACTCTAGGTGCCTGGGTTCTCAGAGCTGGGC"
    query = b"CGTTGACTGGTGCCTGGGTTCTCAGAGCTGGGC"
    tidx, jidx = _both_indexes(query, 7)
    got = kbo_tpu_torch.map_(
        reference, tidx, _opts(kbo_tpu_torch, fmt, max_error_prob=0.1),
        device="cpu",
    )
    assert got == want
    # kbo_tpu answers this one from its host oracle (under 256 bases)
    assert got == kbo_tpu.map_(
        reference, jidx, _opts(kbo_tpu, fmt, max_error_prob=0.1)
    )
    # the same doctest with the default refinements on, against kbo_tpu's
    # host oracle and its device refinement path
    full = kbo_tpu_torch.map_batch(
        [reference], tidx,
        kbo_tpu_torch.MapOpts(max_error_prob=0.1, format=fmt,
                              sbwt_build_opts=kbo_tpu_torch.BuildOpts(k=7)),
        device="cpu",
    )
    jopts = kbo_tpu.MapOpts(max_error_prob=0.1, format=fmt,
                            sbwt_build_opts=kbo_tpu.BuildOpts(k=7))
    assert full == [kbo_tpu.map_(reference, jidx, jopts)]
    assert full == japi.map_batch([reference], jidx, jopts)


@pytest.mark.parametrize("fmt", [True, False])
def test_map_overflow_retry(fmt, monkeypatch):
    """A dense-SNP contig has more drops than cap_d = 256: the first
    attempt overflows, the capacities grow once and the retry's output is
    kbo_tpu's."""
    k = 11
    rng = np.random.default_rng(21)
    query = bytearray(BASES[rng.integers(0, 4, 6000)].tobytes())
    ref = bytearray(query)
    for p in range(8, 6000, 16):
        ref[p] = BASES[(np.searchsorted(BASES, ref[p]) + 1) % 4]
    ref, query = bytes(ref), bytes(query)
    tidx, jidx = _both_indexes(query, k)
    grown = []
    real = device_map.Caps.grown

    def spy(caps, *needs):
        grown.append((caps, needs))
        return real(caps, *needs)

    monkeypatch.setattr(device_map.Caps, "grown", spy)
    reset_stats()
    got = kbo_tpu_torch.map_(ref, tidx, _opts(kbo_tpu_torch, fmt), device="cpu")
    assert len(grown) == 1
    assert get_stats().as_dict()["map_overflow_retries"] == 1
    caps, (need_d, need_g, _) = grown[0]
    assert caps.d == 256 and caps.g == 256 and need_d > 256
    assert got == japi.map_batch([ref], jidx, _opts(kbo_tpu, fmt))[0]


def test_map_run_budget_reassembly(monkeypatch):
    """More delta runs than the first run budget: one re-assembly at the
    exact size, same bytes."""
    ref, query = _planted(3)
    ref = bytearray(ref)
    for p in range(20, 880, 45):
        ref[p] = BASES[(np.searchsorted(BASES, ref[p]) + 1) % 4]
    ref = bytes(ref)
    tidx, _ = _both_indexes(query, 31)
    want = kbo_tpu_torch.map_(ref, tidx, _opts(kbo_tpu_torch, True), device="cpu")
    caps, runs = [], []
    real_assemble = tmap.assemble_map_prio_core
    real_fetch = tmap.fetch_delta_runs_extras
    real_start = device_map.start_caps

    def assemble(*a):
        caps.append(a[-1])
        return real_assemble(*a)

    def fetch(*a):
        out = real_fetch(*a)
        runs.append(int(out[3, 0]))
        return out

    monkeypatch.setattr(device_map, "assemble_map_prio_core", assemble)
    monkeypatch.setattr(device_map, "fetch_delta_runs_extras", fetch)
    monkeypatch.setattr(device_map, "start_caps",
                        lambda L, q: replace(real_start(L, q), r=10))
    got = kbo_tpu_torch.map_(ref, tidx, _opts(kbo_tpu_torch, True), device="cpu")
    assert got == want
    assert len(runs) == 2 and runs[0] == runs[1] > 10
    assert caps == [10, device_map._pow2_cap(runs[0])]


def test_map_chunked_sweep_equals_single_shot(monkeypatch):
    """Past the rows join's slot budget map_batch chunks the sweep along
    the sequence, with the upload chunked on the same grid; the output does
    not change."""
    ref, query = _planted(4, n=3000)
    tidx, jidx = _both_indexes(query, 31)
    want = kbo_tpu_torch.map_(ref, tidx, _opts(kbo_tpu_torch, True), device="cpu")
    chunks = []
    real = tmap.upload_sweep_chunked_pipelined

    def spy(keys3, ref_packed, ref_mat, lengths, k, chunk, **kw):
        chunks.append(chunk)
        return real(keys3, ref_packed, ref_mat, lengths, k, chunk, **kw)

    monkeypatch.setattr(tmap, "upload_sweep_chunked_pipelined", spy)
    monkeypatch.setattr(tms, "_PACKED_SLOT_LIMIT", tidx.keys3.shape[1] + 1500)
    got = kbo_tpu_torch.map_(ref, tidx, _opts(kbo_tpu_torch, True), device="cpu")
    assert got == want == japi.map_batch([ref], jidx, _opts(kbo_tpu, True))[0]
    assert len(chunks) == 1 and 4 * 31 <= chunks[0] < 1500


@pytest.mark.parametrize(
    "kw", [{"fill_gaps": True}, {"call_variants": True}, {}]
)
def test_map_refinement_equals_kbo_tpu(kw):
    """Gap filling, variant calling and both (the default MapOpts()) on a
    tiny input; kbo_tpu answers it from its host oracle (under 256 bases)."""
    tidx, jidx = _both_indexes(b"ACGTACGTAGGATTACAGATTACA", 5)
    base = {"fill_gaps": False, "call_variants": False}
    for fmt in (True, False):
        got = kbo_tpu_torch.map_(
            b"ACGTACGTAGG", tidx,
            kbo_tpu_torch.MapOpts(**({**base, **kw} if kw else {}), format=fmt,
                                  sbwt_build_opts=kbo_tpu_torch.BuildOpts(k=5)),
            device="cpu",
        )
        want = kbo_tpu.map_(
            b"ACGTACGTAGG", jidx,
            kbo_tpu.MapOpts(**({**base, **kw} if kw else {}), format=fmt,
                            sbwt_build_opts=kbo_tpu.BuildOpts(k=5)),
        )
        assert got == want and len(got) == 11


def test_map_other_paths_raise():
    tidx, _ = _both_indexes(b"ACGTACGTAGGATTACAGATTACA", 5)
    # a mesh (ROADMAP item 8a) names the devices: no device= beside it
    from kbo_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="mesh"):
        kbo_tpu_torch.map_batch([b"ACGTACGTAGG"], tidx,
                                _opts(kbo_tpu_torch, True),
                                mesh=make_mesh(2, device="cpu"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kbo_tpu_torch.map_(b"ACGTACGTAGG", tidx, _opts(kbo_tpu_torch, True))
    assert refine_kernels.max_tag(31) == 1 << 30
    with pytest.raises(ValueError, match="sbwt_build_opts.k"):
        kbo_tpu_torch.map_(b"ACGTACGTAGG", tidx, kbo_tpu_torch.MapOpts(),
                           device="cpu")
    # k >= 128 takes the 2-bit sweep (tests/test_torch_map_classic.py)
    big = kbo_tpu_torch.build([b"ACGT" * 40 + b"GATTACA"],
                              kbo_tpu_torch.BuildOpts(k=128))
    jbig = kbo_tpu.build([b"ACGT" * 40 + b"GATTACA"], kbo_tpu.BuildOpts(k=128))
    got = kbo_tpu_torch.map_(b"ACGT" * 40, big,
                             kbo_tpu_torch.MapOpts(call_variants=False),
                             device="cpu")
    assert got == japi.map_batch([b"ACGT" * 40], jbig,
                                 kbo_tpu.MapOpts(call_variants=False))[0]
    assert len(got) == 160


def test_paint_runs_and_canvas():
    L = 8
    refs = [b"ACGTAC", b"GG"]
    ref_mat = np.zeros((2, L), dtype=np.uint8)
    for q, r in enumerate(refs):
        ref_mat[q, : len(r)] = np.frombuffer(r, dtype=np.uint8)
    canvas, row_lens = device_map._canvas(refs, 2, L, True, ref_mat)
    assert not np.shares_memory(canvas, ref_mat)
    assert canvas.tobytes() == b"ACGTAC\0\0GG\0\0\0\0\0\0"
    device_map._paint_runs(
        canvas, np.asarray([1, 4, 8]), np.asarray([3, 8, 16]),
        np.asarray([45, 88, 45]), L, row_lens,
    )
    # ends clip to each row's true length
    assert canvas.tobytes() == b"A--TXX\0\0--\0\0\0\0\0\0"
    canvas, _ = device_map._canvas(refs, 2, L, False, ref_mat)
    assert canvas.tobytes() == b"M" * 16
    device_map._paint_runs(canvas, np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.int32), L, row_lens)
    assert device_map._pow2_cap(257) == 512 and device_map._pow2_cap(3, lo=64) == 64
