"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card these
skip. Run them on a GPU machine with

    python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import kbo_tpu_torch
from kbo_tpu_torch.engine import device_index
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels.join import clamp_scan, clamp_scan_plain
from kbo_tpu_torch.kernels.ms import make_flat_buffer, ms2_core
from kbo_tpu_torch.kernels import postprocess
from kbo_tpu_torch.kernels.postprocess import (
    _lib as _post_lib,
    derandomize_translate,
    derandomize_translate_plain,
)
from kbo_tpu_torch.kernels.sort import (
    _radix_sort,
    bitonic_merge,
    bitonic_merge_plain,
    bitonic_sort,
    bitonic_sort_plain,
    merge_path,
    merge_path_plain,
    to_i32,
)

pytestmark = pytest.mark.cuda

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_words(rng, W, n, top, device, pad_share=0.0):
    raw = rng.integers(0, 9, (W, n)).astype(np.int64) * (top // 8)
    raw[:, rng.random(n) < pad_share] = 0xFFFFFFFF
    words, _ = _radix_sort(to_i32(torch.from_numpy(raw)).to(device))
    return words


@pytest.mark.parametrize("na,nb", [(5000, 7000), (1, 3000), (2048 * 5, 0)])
def test_merge_path_kernel(cuda, na, nb):
    rng = np.random.default_rng(na + nb)
    a = _sorted_words(rng, 4, na, 0xFFFFFFFF, cuda)
    b = _sorted_words(rng, 4, nb, 0xFFFFFFFF, cuda)
    ap = torch.arange(na, dtype=torch.int32, device=cuda)
    bp = torch.arange(na, na + nb, dtype=torch.int32, device=cuda)
    got = merge_path(a, ap, b, bp)
    want = merge_path_plain(a, ap, b, bp)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bits,reverse", [(2, False), (2, True), (3, False),
                                          (3, True)])
def test_clamp_scan_kernel(cuda, bits, reverse):
    rng = np.random.default_rng(bits * 2 + reverse)
    M, W = 50_000, 4
    top = 0xFFFFFFFF if bits == 2 else 0x3FFFFFFF
    words = _sorted_words(rng, W, M, top, cuda, pad_share=0.02)
    per = 16 if bits == 2 else 10
    cap = torch.from_numpy(np.where(
        rng.random(M) < 0.4, rng.integers(0, W * per + 1, M), -1
    ).astype(np.int32)).to(cuda)
    got = clamp_scan(words, cap, bits, reverse)
    want = clamp_scan_plain(words, cap, bits, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# the merge and scan kernels' tile (kTile in csrc/merge_path.cu and
# csrc/clamp_scan.cu)
TILE = 2048


def _merge_corner(rng, W, case, device):
    """Sorted operands for one corner of the tiled merge (the cases of
    tests/test_torch_merge_tiles.py, on the card)."""
    T = TILE
    if case == "ragged":
        return (_sorted_words(rng, W, 2 * T + 333, 0xFFFFFFFF, device),
                _sorted_words(rng, W, T + 71, 0xFFFFFFFF, device))
    if case == "a_empty":
        return (_sorted_words(rng, W, 0, 0xFFFFFFFF, device),
                _sorted_words(rng, W, 2 * T + 5, 0xFFFFFFFF, device))
    if case == "b_empty":
        return (_sorted_words(rng, W, 3 * T - 1, 0xFFFFFFFF, device),
                _sorted_words(rng, W, 0, 0xFFFFFFFF, device))
    if case in ("a_before_b", "b_before_a"):
        lo = _sorted_words(rng, W, T + 100, 0x7FFFFFFF, device)
        hi = _sorted_words(rng, W, 2 * T - 3, 0x7FFFFFFF, device) | (-2**31)
        return (lo, hi) if case == "a_before_b" else (hi, lo)
    # all-equal keys across six tiles: stability decides every output
    return (torch.zeros((W, 3 * T + 17), dtype=torch.int32, device=device),
            torch.zeros((W, 3 * T - 250), dtype=torch.int32, device=device))


@pytest.mark.parametrize("W", [2, 4, 6, 7, 27])
@pytest.mark.parametrize("case", ["ragged", "a_empty", "b_empty",
                                  "a_before_b", "b_before_a", "all_equal"])
def test_merge_path_tile_corners(cuda, W, case):
    """Tiles whose A or B part is empty, the last partial tile, one side
    wholly before the other, all-equal keys across six tiles; W = 2 takes
    the runtime-W instantiation, W = 27 (the interval probe at k = 254) the
    half-length tiles."""
    rng = np.random.default_rng(W * 10 + len(case))
    a, b = _merge_corner(rng, W, case, cuda)
    na, nb = a.shape[1], b.shape[1]
    ap = torch.arange(na, dtype=torch.int32, device=cuda)
    bp = torch.arange(na, na + nb, dtype=torch.int32, device=cuda) | 2**30
    before = merge_path.launches
    got = merge_path(a, ap, b, bp)
    torch.cuda.synchronize()
    assert merge_path.launches == before + 1
    want = merge_path_plain(a, ap, b, bp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _scan_operands(rng, W, M, bits, device):
    top = 0xFFFFFFFF if bits == 2 else 0x3FFFFFFF
    words = _sorted_words(rng, W, M, top, device, pad_share=0.02)
    per = 16 if bits == 2 else 10
    cap = torch.from_numpy(np.where(
        rng.random(M) < 0.4, rng.integers(0, W * per + 1, M), -1
    ).astype(np.int32)).to(device)
    return words, cap


@pytest.mark.parametrize("M", [1, TILE - 1, TILE, TILE + 1, 9 * TILE + 77,
                               70 * TILE + 5])
@pytest.mark.parametrize("bits,W", [(2, 4), (3, 6), (3, 3)])
@pytest.mark.parametrize("reverse", [False, True])
def test_clamp_scan_tile_corners(cuda, M, bits, W, reverse):
    """One tile, a tile and one slot, many tiles (the look-back walks
    several windows of 32); W = 3 takes the runtime-W instantiation."""
    rng = np.random.default_rng(M + bits * 7 + W + reverse)
    words, cap = _scan_operands(rng, W, M, bits, cuda)
    before = clamp_scan.launches
    got = clamp_scan(words, cap, bits, reverse)
    torch.cuda.synchronize()
    assert clamp_scan.launches == before + 1
    assert torch.equal(got, clamp_scan_plain(words, cap, bits, reverse))


def test_clamp_scan_repeat(cuda):
    """20 runs at 2^22 + 1001 slots, each bit-equal: a look-back race
    would show only in some runs."""
    rng = np.random.default_rng(22)
    M = (1 << 22) + 1001
    words, cap = _scan_operands(rng, 6, M, 3, cuda)
    want = [clamp_scan_plain(words, cap, 3, rev) for rev in (False, True)]
    for run in range(20):
        got = clamp_scan(words, cap, 3, run % 2 == 1)
        torch.cuda.synchronize()
        assert torch.equal(got, want[run % 2]), f"run {run}"


def test_merge_scan_reject_wide_keys(cuda):
    """More key rows than the shared-memory slabs hold raise: 28 for the
    merge (27 take its half-length tiles), 27 for the scan."""
    pay = torch.zeros(10, dtype=torch.int32, device=cuda)
    keys = torch.zeros((28, 10), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="key rows"):
        merge_path(keys, pay, keys, pay)
    with pytest.raises(ValueError, match="key rows"):
        clamp_scan(keys[:27], pay, 2, False)


def test_find_batch_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(5)
    genome = BASES[rng.integers(0, 4, 20_000)].tobytes()
    idx = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=31))
    queries = []
    for s in rng.integers(0, 19_000, 16):
        q = bytearray(genome[s : s + 900])
        for p in rng.integers(0, len(q), 5):
            q[p] = BASES[rng.integers(0, 4)]
        queries.append(bytes(q))
    merge_path.launches = clamp_scan.launches = 0
    derandomize_translate.launches = 0
    got = kbo_tpu_torch.find_batch(queries, idx, device=cuda)
    assert merge_path.launches == 1 and clamp_scan.launches == 2
    assert derandomize_translate.launches == 1
    assert got == kbo_tpu_torch.find_batch(queries, idx, device="cpu")
    one = kbo_tpu_torch.matches(queries[0], idx, device=cuda)
    assert one == kbo_tpu_torch.matches(queries[0], idx, device="cpu")
    assert encode_ascii(queries[0]).size == len(one)


_DT_CONST = dict(re.findall(
    r"constexpr int (k\w+) = (\d+);",
    (Path(kbo_tpu_torch.__file__).resolve().parent / "kernels" / "csrc"
     / "derand_translate.cu").read_text()))
DT_TILE = int(_DT_CONST["kThreads"]) * int(_DT_CONST["kItems"])  # kTile
# rows of one tile and of several, many rows and few; 70 tiles make the
# look-back walk several windows of 32
DT_SHAPES = [(1, 1), (1, 1024), (3, 5000), (512, 300), (2, 1024 * 6 + 17),
             (64, DT_TILE), (512, 3 * DT_TILE + 77), (1, 70 * DT_TILE + 5),
             (3, 70 * DT_TILE + 5), (8, 9 * DT_TILE + 77)]


@pytest.mark.parametrize("Q,L", DT_SHAPES)
@pytest.mark.parametrize("lipschitz", [True, False])
@pytest.mark.parametrize("form", ["short-row", "look-back"])
def test_derandomize_translate_kernel(cuda, monkeypatch, Q, L, lipschitz,
                                      form):
    """Both forms of the kernel, forced in turn, bit-equal to the plain
    version below each row's true length, 0 at and past it; row lengths 0,
    1, 2, L, on a tile edge and mid-tile; rows as unaligned strided views;
    an int true length as a kernel argument."""
    assert _post_lib().kbo_derand_translate_tile() == DT_TILE
    monkeypatch.setattr(postprocess, "_short_rows",
                        lambda *a: form == "short-row")
    rng = np.random.default_rng(Q * L + lipschitz)
    k, t = 51, 19
    if lipschitz:
        steps = rng.choice(np.array([1, 1, 1, 0, -5, -40]), (Q, L))
        ms = np.clip(np.cumsum(steps, axis=1) % (k + 9), 0, k).astype(np.int32)
    else:
        ms = rng.integers(-3, k + 3, (Q, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, Q).astype(np.int32)
    edge = [L, 0, 1, 2, DT_TILE, 2 * DT_TILE, DT_TILE + 777, L - 1]
    lengths[: min(Q, len(edge))] = np.minimum(edge, L)[: min(Q, len(edge))]
    ms_d = torch.from_numpy(ms).to(cuda)
    tl_d = torch.from_numpy(lengths).to(cuda)
    before = derandomize_translate.launches
    got = derandomize_translate(ms_d, k, t, tl_d)
    torch.cuda.synchronize()
    assert derandomize_translate.launches == before + 1
    want = derandomize_translate_plain(ms_d, k, t, tl_d)
    in_len = torch.arange(L, device=cuda)[None, :] < tl_d[:, None]
    assert got.dtype == torch.uint8 and got.shape == (Q, L)
    assert torch.equal(got[in_len], want[in_len])
    assert not got[~in_len].any()
    # rows as strided views (the find pipeline's [Q, k-1+L] buffer: each
    # row starts 50 words, 200 bytes, past a 16-byte boundary)
    wide = torch.zeros((Q, L + 50), dtype=torch.int32, device=cuda)
    wide[:, 50:] = ms_d
    assert torch.equal(derandomize_translate(wide[:, 50:], k, t, tl_d), got)
    # an int true length (no host-to-device copy) and a one-element tensor
    # both stand for every row
    n = int(lengths[0])
    by_int = derandomize_translate(ms_d, k, t, n)
    assert torch.equal(by_int, derandomize_translate(
        ms_d, k, t, torch.tensor([n], dtype=torch.int32, device=cuda)))
    want_n = derandomize_translate_plain(ms_d, k, t, n)
    assert torch.equal(by_int[:, :n], want_n[:, :n])
    assert not by_int[:, n:].any()


def test_derandomize_translate_repeat(cuda):
    """A look-back race would show only in some runs: 20 back-to-back calls
    at 2^22 + 1001 positions in 2 rows, each one launch, each bit-equal;
    the status words and the ticket are cleared before every call."""
    rng = np.random.default_rng(77)
    k, t, L = 51, 19, (1 << 22) + 1001
    steps = rng.choice(np.array([1, 1, 1, 0, -5, -40]), (2, L))
    ms = torch.from_numpy(
        np.clip(np.cumsum(steps, axis=1) % (k + 9), 0, k).astype(np.int32)
    ).to(cuda)
    tl = torch.tensor([L, L - 3 * DT_TILE - 5], dtype=torch.int32,
                      device=cuda)
    want = derandomize_translate(ms, k, t, tl)
    in_len = torch.arange(L, device=cuda)[None, :] < tl[:, None]
    assert torch.equal(want[in_len],
                       derandomize_translate_plain(ms, k, t, tl)[in_len])
    before = derandomize_translate.launches
    outs = [derandomize_translate(ms, k, t, tl) for _ in range(20)]
    torch.cuda.synchronize()
    assert derandomize_translate.launches == before + 20
    for run, got in enumerate(outs):
        assert torch.equal(got, want), f"run {run} of 20 differs"


def test_derandomize_translate_rejects(cuda):
    ms = torch.zeros((2, 64), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        derandomize_translate(ms, 31, 11)
    with pytest.raises(ValueError):
        derandomize_translate(ms.to(torch.int32)[:, ::2], 31, 11)


@pytest.mark.parametrize("fmt", [True, False])
def test_map_on_card_equals_cpu(cuda, fmt):
    rng = np.random.default_rng(6)
    query = bytearray(BASES[rng.integers(0, 4, 30_000)].tobytes())
    ref = bytearray(query)
    for p in range(300, 29_000, 700):
        ref[p] = BASES[(np.searchsorted(BASES, ref[p]) + 1) % 4]
    del ref[15_000:15_020]
    ref[5000:5010] = b"N" * 10
    idx = kbo_tpu_torch.build([bytes(query)], kbo_tpu_torch.BuildOpts(k=31))
    opts = kbo_tpu_torch.MapOpts(fill_gaps=False, call_variants=False, format=fmt)
    contigs = [bytes(ref[:12_000]), bytes(ref[12_000:12_020]), bytes(ref[12_020:])]
    merge_path.launches = clamp_scan.launches = 0
    derandomize_translate.launches = 0
    got = kbo_tpu_torch.map_batch(contigs, idx, opts, device=cuda)
    assert merge_path.launches == 1 and clamp_scan.launches == 2
    assert derandomize_translate.launches == 1
    assert got == kbo_tpu_torch.map_batch(contigs, idx, opts, device="cpu")
    one = kbo_tpu_torch.map_(contigs[0], idx, opts, device=cuda)
    assert one == got[0]


@pytest.mark.parametrize("na,nb,W", [(70_000, 50_000, 2), (1, 3000, 4),
                                     (200_000, 1, 8), (0, 5, 4)])
def test_bitonic_merge_kernel(cuda, na, nb, W):
    """Bit-equal to the plain network, payloads and pads included; W=8
    (nine operand rows) takes the smaller shared-memory tile."""
    rng = np.random.default_rng(na + nb + W)
    a = _sorted_words(rng, W, na, 0xFFFFFFFF, cuda, pad_share=0.01)
    b = _sorted_words(rng, W, nb, 0xFFFFFFFF, cuda, pad_share=0.01)
    a_ops = torch.cat([a, torch.arange(na, dtype=torch.int32,
                                       device=cuda)[None]])
    b_ops = torch.cat([b, torch.arange(nb, dtype=torch.int32,
                                       device=cuda)[None] + na])
    before = bitonic_merge.launches
    got = bitonic_merge(a_ops, b_ops, W)
    torch.cuda.synchronize()
    assert bitonic_merge.launches == before + 1
    assert torch.equal(got, bitonic_merge_plain(a_ops, b_ops, W))


def test_bitonic_merge_17_rows(cuda):
    """k = 254: the 2-bit join's 16 key words and its payload are 17
    operand rows; ms2_core with merge="bitonic" equals merge="path"."""
    rng = np.random.default_rng(254)
    genome = BASES[rng.integers(0, 4, 40_000)].tobytes()
    idx = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=254))
    dev = device_index(idx, cuda)
    assert dev.keys2.shape[0] == 16
    query = bytearray(genome[5000:25_000])
    for p in range(300, 20_000, 900):
        query[p] = BASES[(np.searchsorted(BASES, query[p]) + 1) % 4]
    buf, _ = make_flat_buffer(encode_ascii(bytes(query)), 254)
    buf = torch.from_numpy(buf).to(cuda)
    before = bitonic_merge.launches
    got = ms2_core(dev.keys2, dev.cap2, buf, 254, merge="bitonic")
    torch.cuda.synchronize()
    assert bitonic_merge.launches == before + 1
    want = ms2_core(dev.keys2, dev.cap2, buf, 254)
    assert torch.equal(got, want) and int(want.max()) == 254


@pytest.mark.parametrize("n,W", [(100_000, 2), (65_536, 4), (300_000, 3)])
def test_bitonic_sort_kernel(cuda, n, W):
    rng = np.random.default_rng(n + W)
    raw = rng.integers(0, 9, (W, n)).astype(np.int64) * (0xFFFFFFFF // 8)
    ops = torch.cat([
        to_i32(torch.from_numpy(raw)).to(cuda),
        torch.arange(n, dtype=torch.int32, device=cuda)[None],
    ])
    before = bitonic_sort.launches
    got = bitonic_sort(ops, W)
    torch.cuda.synchronize()
    assert bitonic_sort.launches == before + 1
    assert torch.equal(got, bitonic_sort_plain(ops, W))
    keys, _ = _radix_sort(ops[:W])
    assert torch.equal(got[:W], keys)


@pytest.mark.parametrize("lm", [16, 17, 18])
@pytest.mark.parametrize("n_ops", [3, 5, 7, 9])
def test_bitonic_pass_corners(cuda, lm, n_ops):
    """Each pass type's corners: at M = 2^16..2^18 the stages above the
    largest tile leave every remainder of a register pass's r stages;
    merges with na = 0, nb = 0 and na + nb exactly M, and a sort. Bit-equal
    to the plain network, payloads and pads included."""
    M, W = 1 << lm, n_ops - 1
    rng = np.random.default_rng(lm * 10 + n_ops)

    def ops(n, first):
        words = _sorted_words(rng, W, n, 0xFFFFFFFF, cuda, pad_share=0.01)
        pay = torch.arange(first, first + n, dtype=torch.int32, device=cuda)
        return torch.cat([words, pay[None]])

    for na, nb in ((0, M // 2 + 1), (M // 2 + 3, 0), (M // 2, M // 2),
                   (M // 3, M // 5)):
        a, b = ops(na, 0), ops(nb, na)
        got = bitonic_merge(a, b, W)
        torch.cuda.synchronize()
        assert got.shape == (n_ops, M)
        assert torch.equal(got, bitonic_merge_plain(a, b, W))
    perm = torch.from_numpy(rng.permutation(M - 5)).to(cuda)
    unsorted = ops(M - 5, 0)[:, perm]
    got = bitonic_sort(unsorted, W)
    torch.cuda.synchronize()
    assert torch.equal(got, bitonic_sort_plain(unsorted, W))


@pytest.mark.parametrize("fmt", [True, False])
def test_default_map_on_card_equals_cpu(cuda, fmt):
    """MapOpts() on the card: gap scoring and variant resolution, one
    contig (sweep-table reuse) and three (the tagged join)."""
    rng = np.random.default_rng(8)
    ref = BASES[rng.integers(0, 4, 30_000)].tobytes()
    query = bytearray(ref)
    for p in range(300, 29_000, 700):
        query[p] = BASES[rng.integers(0, 4)]
    del query[15_000:15_003]
    for p in range(20_000, 20_120):
        query[p] = BASES[rng.integers(0, 4)]
    bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    idx = kbo_tpu_torch.build([bytes(query)], bo)
    opts = kbo_tpu_torch.MapOpts(format=fmt, sbwt_build_opts=bo)
    for refs in ([ref], [ref[:9000], ref[9000:9500], ref[9500:]]):
        merge_path.launches = clamp_scan.launches = 0
        got = kbo_tpu_torch.map_batch(refs, idx, opts, device=cuda)
        # the sweep's join and the variant join
        assert merge_path.launches == 2 and clamp_scan.launches == 4
        assert got == kbo_tpu_torch.map_batch(refs, idx, opts, device="cpu")


def _call_pair(n=8000):
    """tests/test_variant_calling.py::test_call_vs_seq_device_path's pair."""
    rng = np.random.default_rng(21)
    query = BASES[rng.integers(0, 4, n)].tobytes()
    ref = bytearray(query)
    ref[2000] = BASES[(np.frombuffer(query[2000:2001], np.uint8)[0] % 4 + 1)
                      % 4]
    del ref[5000:5002]
    ref[6500:6500] = b"TT"
    return query, bytes(ref)


@pytest.mark.parametrize("k,add_revcomp", [(51, False), (51, True),
                                           (254, False)])
def test_call_on_card_equals_cpu(cuda, k, add_revcomp):
    """call on the card (drop scan, interval rounds, the vs-sequence join)
    gives the CPU run's variants; every merge and scan ran as a kernel."""
    query, ref = _call_pair()
    bo = kbo_tpu_torch.BuildOpts(k=k, build_select=True,
                                 add_revcomp=add_revcomp)
    idx = kbo_tpu_torch.build([query], bo)
    opts = kbo_tpu_torch.CallOpts(sbwt_build_opts=bo)
    merge_path.launches = clamp_scan.launches = 0
    got = kbo_tpu_torch.call(idx, ref, opts, device=cuda)
    # the row's join, >= 1 interval round, the two phase-3 batches
    assert merge_path.launches >= 3 and clamp_scan.launches >= 6
    want = kbo_tpu_torch.call(idx, ref, opts, device="cpu")
    assert [(v.query_pos, v.query_chars, v.ref_chars) for v in got] == [
        (v.query_pos, v.query_chars, v.ref_chars) for v in want]
    assert len(got) == 3


def _probe_windows(k, seed=51):
    rng = np.random.default_rng(seed)
    genome = BASES[rng.integers(0, 4, 30_000)].tobytes()
    q = bytearray(genome[1000:21_000])
    for p in rng.integers(0, len(q), 40):
        q[p] = BASES[rng.integers(0, 4)]
    idx = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=k))
    codes = encode_ascii(bytes(q))
    pos = np.sort(rng.choice(len(q), 3000, replace=False))
    padded = np.full(codes.size + k - 1, 255, dtype=np.uint8)
    padded[k - 1:] = codes
    win = torch.from_numpy(padded[pos[:, None] + np.arange(k)[None, :]])
    ms = torch.from_numpy(rng.integers(0, k + 1, pos.size).astype(np.int32))
    return idx, win, ms


@pytest.mark.parametrize("k", [51, 254])
def test_interval_probe_on_card(cuda, k):
    """The interval merge (W + 1 = 7 and 27 key rows) on the card equals
    the CPU's; merge="bitonic" (W + 2 operand rows) equals it at k = 51
    and raises past the bitonic kernels' 17 rows at k = 254."""
    from kbo_tpu_torch.kernels.ms import intervals3_windows_core

    idx, win, ms = _probe_windows(k)
    keys_cpu = device_index(idx, "cpu").keys3
    keys = device_index(idx, cuda).keys3
    want = intervals3_windows_core(keys_cpu, win, ms, k)
    before = merge_path.launches
    got = intervals3_windows_core(keys, win.to(cuda), ms.to(cuda), k)
    torch.cuda.synchronize()
    assert merge_path.launches == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    if k == 51:
        bit = intervals3_windows_core(keys, win.to(cuda), ms.to(cuda), k,
                                      merge="bitonic")
        assert all(torch.equal(b.cpu(), w) for b, w in zip(bit, want))
    else:
        with pytest.raises(ValueError, match="17"):
            intervals3_windows_core(keys, win.to(cuda), ms.to(cuda), k,
                                    merge="bitonic")


@pytest.mark.parametrize("k", [51, 254])
def test_vs_seq_join_on_card(cuda, k):
    """The concat-sorted vs-sequence join (bits = 3, W = 6 and 26) on the
    card equals the CPU's, two scans and no merge."""
    from kbo_tpu_torch.engine import compute_ms_values_vs_seq_device

    rng = np.random.default_rng(k)
    ref_codes = encode_ascii(BASES[rng.integers(0, 4, 50_000)].tobytes())
    kmers = [ref_codes[s:s + k].copy() for s in rng.integers(0, 49_000, 300)]
    for km in kmers[::3]:
        km[rng.integers(0, k)] = 1 + (km[0] % 4)
    before = (merge_path.launches, clamp_scan.launches)
    got = compute_ms_values_vs_seq_device(ref_codes, kmers, k, cuda)
    torch.cuda.synchronize()
    assert (merge_path.launches, clamp_scan.launches) == (
        before[0], before[1] + 2)
    want = compute_ms_values_vs_seq_device(ref_codes, kmers, k, "cpu")
    assert torch.equal(got.cpu()[:, :k], want[:, :k])


@pytest.mark.parametrize("add_revcomp", [False, True])
def test_find_batch_device_seq_index_on_card(cuda, add_revcomp):
    """find_batch against build_device's sequence index on the card: one
    merge, two scans, one derandomize_translate; equal to the CPU run."""
    from kbo_tpu_torch import api

    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, 40_000)].tobytes()
    queries = []
    for s in rng.integers(0, 39_000, 32):
        q = bytearray(genome[s : s + 900])
        for p in rng.integers(0, len(q), 5):
            q[p] = BASES[rng.integers(0, 4)]
        queries.append(bytes(q))
    bo = kbo_tpu_torch.BuildOpts(k=31, add_revcomp=add_revcomp)
    gpu_index = api.build_device([genome], bo, device=cuda)
    cpu_index = api.build_device([genome], bo, device="cpu")
    assert gpu_index.n_kmers == cpu_index.n_kmers
    assert torch.equal(gpu_index.ref_words.cpu(), cpu_index.ref_words)
    merge_path.launches = clamp_scan.launches = 0
    derandomize_translate.launches = 0
    got = kbo_tpu_torch.find_batch(queries, gpu_index)
    assert (merge_path.launches, clamp_scan.launches,
            derandomize_translate.launches) == (1, 2, 1)
    assert got == kbo_tpu_torch.find_batch(queries, cpu_index)


def _full_pair(seed, n=60_000):
    """A genome with SNPs, a deletion and an N run on the indexed side,
    and the reference it is mapped against."""
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    q = bytearray(ref)
    for pos in range(700, n - 700, 1100):
        q[pos] = BASES[(BASES.tolist().index(q[pos]) + 1) % 4]
    del q[9100:9103]
    q[15000:15002] = b"NN"
    return ref, bytes(q)


@pytest.mark.parametrize("add_revcomp", [False, True])
def test_device_full_index_on_card(cuda, add_revcomp):
    """build_device(full=True) on the card: every table (sentinel tail
    included) equals the CPU build; find_batch (1 merge, 2 scans, 1
    derandomize_translate), the default map_ (2 merges, 4 scans, 1
    derandomize_translate) and call against it equal the CPU runs."""
    from kbo_tpu_torch import api

    ref, query = _full_pair(31)
    bo = kbo_tpu_torch.BuildOpts(k=51, add_revcomp=add_revcomp)
    gpu = api.build_device([query], bo, full=True, device=cuda)
    cpu = api.build_device([query], bo, full=True, device="cpu")
    assert (gpu.n_rows, gpu.n_kmers) == (cpu.n_rows, cpu.n_kmers)
    assert np.array_equal(gpu.C, cpu.C)
    for name in ("keys3", "row_pos", "keys2", "cap2", "lcs3", "rows_packed"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    queries = [ref[s : s + 1500] for s in range(0, 50_000, 2500)]
    merge_path.launches = clamp_scan.launches = 0
    derandomize_translate.launches = 0
    got = kbo_tpu_torch.find_batch(queries, gpu)
    assert (merge_path.launches, clamp_scan.launches,
            derandomize_translate.launches) == (1, 2, 1)
    assert got == kbo_tpu_torch.find_batch(queries, cpu)
    mo = kbo_tpu_torch.MapOpts(sbwt_build_opts=bo)
    merge_path.launches = clamp_scan.launches = 0
    derandomize_translate.launches = 0
    got = kbo_tpu_torch.map_(ref, gpu, mo)
    assert (merge_path.launches, clamp_scan.launches,
            derandomize_translate.launches) == (2, 4, 1)
    assert got == kbo_tpu_torch.map_(ref, cpu, mo, device="cpu")
    co = kbo_tpu_torch.CallOpts(sbwt_build_opts=bo)
    got = kbo_tpu_torch.call(gpu, ref, co)
    want = kbo_tpu_torch.call(cpu, ref, co, device="cpu")
    assert [(v.query_pos, v.query_chars, v.ref_chars) for v in got] == [
        (v.query_pos, v.query_chars, v.ref_chars) for v in want]
    assert len(got) > 0


def test_full_index_joins_on_card(cuda):
    """The merge and the scans at the full index's sentinel-tailed shapes
    (the 2-bit value join with its cap-0 tail, the 3-bit rows join with
    its all-ones tail) equal their plain versions slot for slot."""
    from kbo_tpu_torch import api
    from kbo_tpu_torch.kernels.ms import (
        _merge_scan,
        pack_windows_2bit,
        pack_windows_3bit,
    )

    ref, query = _full_pair(32)
    bo = kbo_tpu_torch.BuildOpts(k=51)
    gpu = api.build_device([query], bo, full=True, device=cuda)
    assert gpu.keys3.shape[1] > gpu.n_rows
    buf, _ = make_flat_buffer(encode_ascii(ref), 51)
    buf = torch.from_numpy(buf)
    meta = torch.arange(buf.shape[0], dtype=torch.int32)
    q2, _ = pack_windows_2bit(buf, 51)
    q3 = pack_windows_3bit(buf, 51)
    for ref_words, cap, q, bits, packed in [
        (gpu.keys2, gpu.cap2, q2, 2, None),
        (gpu.keys3, None, q3, 3, gpu.rows_packed),
    ]:
        before = (merge_path.launches, clamp_scan.launches)
        got = _merge_scan(ref_words, cap, q.to(cuda), meta.to(cuda), bits,
                          ref_packed=packed)
        assert (merge_path.launches, clamp_scan.launches) == (
            before[0] + 1, before[1] + 2)
        want = _merge_scan(
            ref_words.cpu(), None if cap is None else cap.cpu(), q, meta,
            bits, ref_packed=None if packed is None else packed.cpu())
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_member_widths_on_card(cuda):
    """The gap filler's membership probe on the card (one interval merge)
    equals the CPU's over 4000 probes: rows, mutated rows, junk."""
    from kbo_tpu_torch import api

    _, query = _full_pair(33)
    bo = kbo_tpu_torch.BuildOpts(k=51)
    gpu = api.build_device([query], bo, full=True, device=cuda)
    cpu = api.build_device([query], bo, full=True, device="cpu")
    rng = np.random.default_rng(4)
    probes = gpu.access_kmers_codes(rng.integers(0, gpu.n_rows, 2000))
    mutated = probes.copy()
    mutated[np.arange(2000), rng.integers(0, 51, 2000)] = rng.integers(
        1, 5, 2000)
    probes = np.concatenate([probes, mutated])
    before = merge_path.launches
    got = gpu.member_widths(probes)
    assert merge_path.launches == before + 1
    want = cpu.member_widths(probes)
    assert np.array_equal(got, want) and got.sum() > 1500


def test_fill_gaps_sparse_intervals_on_card(cuda):
    """fill_gaps over SparseIntervals of a card-resident MS row against
    the device full index equals the CPU run."""
    from kbo_tpu_torch import api, engine
    from kbo_tpu_torch.kernels.ms import query_ms_row_device
    from kbo_tpu_torch.ops.derandomize import (
        derandomize_ms_vec,
        random_match_threshold,
    )
    from kbo_tpu_torch.ops.translate import translate_ms_vec
    from kbo_tpu_torch.refine import gap_filling

    ref, query = _full_pair(34, n=20_000)
    ref = bytearray(ref)
    ref[5000:5060] = BASES[np.random.default_rng(1).integers(0, 4, 60)].tobytes()
    ref = bytes(ref)
    bo = kbo_tpu_torch.BuildOpts(k=31)
    codes = encode_ascii(ref)
    out = []
    for device in (cuda, "cpu"):
        idx = api.build_device([query], bo, full=True, device=device)
        row = query_ms_row_device(idx, codes)
        ms = row.cpu().numpy().astype(np.int64)
        t = random_match_threshold(31, idx.n_kmers, 4, 1e-7)
        tr = translate_ms_vec(derandomize_ms_vec(ms, 31, t), 31, t)
        iv = engine.SparseIntervals(idx, codes, ms=row)
        out.append(gap_filling.fill_gaps(tr, ms, iv, ref, idx, t, 1e-7))
    assert out[0] == out[1] and out[0] != tr


def _classic_pair(n=20_000):
    """A reference and its indexed query for the 2-bit map path: a SNP
    every 300 bases, a 3-base deletion, a 40-base stretch of noise."""
    rng = np.random.default_rng(254)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(150, n - 150, 300):
        query[p] = BASES[(np.searchsorted(BASES, query[p]) + 1) % 4]
    del query[n // 2 : n // 2 + 3]
    query[n // 3 : n // 3 + 40] = BASES[rng.integers(0, 4, 40)].tobytes()
    return ref, bytes(query)


def test_map_sweep_compact_254_on_card(cuda):
    """The 2-bit map sweep at k = 254 (16 key words: 17 merge rows, 16
    scan rows) on the card equals its CPU twin: one merge, two scans, one
    derandomize_translate."""
    from kbo_tpu_torch.kernels.mapsweep import map_sweep_compact_core
    from kbo_tpu_torch.ops.derandomize import random_match_threshold

    ref, query = _classic_pair()
    idx = kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=254))
    t = random_match_threshold(254, idx.n_kmers, 4, 1e-7)
    contigs = [ref[:12_000], ref[12_000:], ref[5000:5200]]
    codes = np.full((3, 12_288), 255, np.uint8)
    for q, c in enumerate(contigs):
        codes[q, : len(c)] = encode_ascii(c)
    lengths = np.asarray([len(c) for c in contigs], np.int32)
    out = {}
    for device in (cuda, "cpu"):
        dev = device_index(idx, device)
        assert dev.keys2.shape[0] == 16
        before = (merge_path.launches, clamp_scan.launches,
                  derandomize_translate.launches)
        out[device] = [x.cpu() for x in map_sweep_compact_core(
            dev.keys2, dev.cap2, torch.from_numpy(codes).to(device),
            torch.from_numpy(lengths).to(device), 254, t)]
        if device is cuda:
            torch.cuda.synchronize()
            assert (merge_path.launches, clamp_scan.launches,
                    derandomize_translate.launches) == (
                before[0] + 1, before[1] + 2, before[2] + 1)
    got, want = out[cuda], out["cpu"]
    assert torch.equal(got[2], want[2]) and int(got[2].sum()) > 40
    for q, n in enumerate(lengths):
        assert torch.equal(got[0][q, :n], want[0][q, :n])
        assert not got[0][q, n:].any()  # the kernel writes 0 past n
        assert torch.equal(got[1][q, :n], want[1][q, :n])
    for g, w in zip(got[3:], want[3:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fmt", [True, False])
def test_map_254_on_card_equals_cpu(cuda, fmt):
    """map_ at k = 254 with the default refinements (the 2-bit sweep, the
    host refinement over intervals of 27 merge rows, call's 26-word
    vs-sequence scans) on the card equals the CPU run."""
    ref, query = _classic_pair()
    bo = kbo_tpu_torch.BuildOpts(k=254, build_select=True)
    idx = kbo_tpu_torch.build([query], bo)
    opts = kbo_tpu_torch.MapOpts(format=fmt, sbwt_build_opts=bo)
    merge_path.launches = clamp_scan.launches = 0
    got = kbo_tpu_torch.map_(ref, idx, opts, device=cuda)
    # the sweep's merge, the interval probe's, the call's joins
    assert merge_path.launches >= 2 and clamp_scan.launches >= 4
    want = kbo_tpu_torch.map_(ref, idx, opts, device="cpu")
    assert got == want and len(got) == len(ref)
    assert (b"-" in got) if fmt else (set(got) - set(b"MX-R"))


# ------------------------------------------------ the mesh on the card


def _mesh_pair(n=30_000):
    """A reference and its indexed query: a SNP every 900 bases and a 2-base
    deletion (kbo_tpu's tests/test_mesh_map.py pair)."""
    rng = np.random.default_rng(9)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    q = bytearray(ref)
    for pos in range(700, n - 700, 900):
        q[pos] = BASES[(np.searchsorted(BASES, q[pos]) + 1) % 4]
    del q[n // 2 : n // 2 + 2]
    return ref, bytes(q)


def _routed_map(refs, idx, opts, **kw):
    from kbo_tpu_torch.utils.stats import get_stats, reset_stats

    reset_stats()
    out = kbo_tpu_torch.map_batch(refs, idx, opts, **kw)
    return out, sorted(k for k in get_stats().as_dict()
                       if k.startswith("mesh_"))


def test_mesh_find_and_call_on_card(cuda):
    """find_batch (both gap settings) and call over four shards on one card
    equal the single-device calls on it."""
    from kbo_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4, device="cuda:0")
    assert all(d == torch.device("cuda", 0) for d in mesh.devices)
    ref, query = _mesh_pair()
    bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    idx = kbo_tpu_torch.build([query], bo)
    qs = [ref[s : s + 700 + s % 300] for s in range(0, 25_000, 1900)]
    for gap in (0, 5):
        fo = kbo_tpu_torch.FindOpts(max_gap_len=gap)
        assert kbo_tpu_torch.find_batch(qs, idx, fo, mesh=mesh) == \
            kbo_tpu_torch.find_batch(qs, idx, fo, device=cuda)
    co = kbo_tpu_torch.CallOpts(sbwt_build_opts=bo)
    got = kbo_tpu_torch.call(idx, ref, co, mesh=mesh)
    want = kbo_tpu_torch.call(idx, ref, co, device=cuda)
    assert got == want and want


@pytest.mark.parametrize("route", ["seq", "data", "classic"])
def test_mesh_map_routes_on_card(cuda, route):
    """Each of map_batch's mesh routes over four shards on one card equals
    the single-device map_batch on it, byte for byte."""
    from kbo_tpu_torch.parallel.mesh import make_mesh

    ref, query = _mesh_pair()
    k = 151 if route == "classic" else 51
    bo = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    idx = kbo_tpu_torch.build([query], bo)
    refs = [ref] if route == "seq" else [
        ref[i * 3500 : (i + 1) * 3500] for i in range(8)]
    for fmt in (True, False):
        opts = kbo_tpu_torch.MapOpts(format=fmt, sbwt_build_opts=bo)
        got, taken = _routed_map(refs, idx, opts,
                                 mesh=make_mesh(4, device="cuda:0"))
        assert taken == [f"mesh_route_{route}"]
        assert got == kbo_tpu_torch.map_batch(refs, idx, opts, device=cuda)


def test_mesh_on_a_second_card(cuda):
    """Shards on cuda:1 allocate nothing on cuda:0 (each shard's work runs
    under its own card), and a mesh over two cards equals one card."""
    from kbo_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    ref, query = _mesh_pair()
    bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    idx = kbo_tpu_torch.build([query], bo)
    opts = kbo_tpu_torch.MapOpts(sbwt_build_opts=bo)
    qs = [ref[s : s + 900] for s in range(0, 25_000, 2100)]
    torch.cuda.synchronize(0)
    torch.cuda.reset_peak_memory_stats(0)
    base = torch.cuda.memory_allocated(0)
    on1 = make_mesh(2, device="cuda:1")
    got_find = kbo_tpu_torch.find_batch(qs, idx, mesh=on1)
    got_map = kbo_tpu_torch.map_batch([ref], idx, opts, mesh=on1)
    torch.cuda.synchronize(0)
    assert torch.cuda.max_memory_allocated(0) == base
    both = make_mesh(2)
    assert kbo_tpu_torch.find_batch(qs, idx, mesh=both) == got_find
    assert kbo_tpu_torch.map_batch([ref], idx, opts, mesh=both) == got_map
    assert got_map == kbo_tpu_torch.map_batch([ref], idx, opts, device=cuda)


@pytest.mark.parametrize("k", [51, 127])
def test_partial_rows_join_on_card(cuda, k):
    """The prefix-sharded rows join (kernels.ms.ms3_rows_partial_core) on
    the card equals its CPU twin pack for pack, at k = 127 (W = 13 key
    rows, the largest under the rows join's k < 128) and at k = 51; the
    four-shard sweep over one card equals the single-device sweep."""
    from kbo_tpu_torch.kernels.mapsweep import ms3_rows_sweep
    from kbo_tpu_torch.kernels.ms import ms3_rows_partial_core, w3_for_k
    from kbo_tpu_torch.parallel import mesh as pmesh
    from kbo_tpu_torch.pipeline import pad_batch

    ref, query = _mesh_pair()
    idx = kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=k))
    codes, _ = pad_batch([encode_ascii(ref)], bucket=True)
    mesh = pmesh.make_mesh(4, axis="model", device="cuda:0")
    sidx = pmesh.Sharded3Index(idx, mesh)
    assert sidx.keys3[0].shape[0] == w3_for_k(k)
    buf = torch.cat([torch.full((1, k - 1), 255, dtype=torch.uint8),
                     torch.from_numpy(codes)], dim=1).reshape(-1)
    m = sidx.shard_cols
    for i in range(4):
        got = ms3_rows_partial_core(sidx.keys3[i], sidx.down[i], sidx.up[i],
                                    i * m, buf.to(cuda), k)
        want = ms3_rows_partial_core(sidx.keys3[i].cpu(), sidx.down[i].cpu(),
                                     sidx.up[i].cpu(), i * m, buf, k)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    dev = device_index(idx, cuda)
    single = ms3_rows_sweep(dev.keys3, dev.rows_packed,
                            torch.from_numpy(codes).to(cuda), k)
    got = pmesh.ms3_rows_sweep_index_sharded(sidx, codes, mesh)
    assert torch.equal(got[0], single[0]) and torch.equal(got[1], single[1])
    assert torch.equal(got[2][single[1]], single[2][single[1]])


def test_map_e2e_equals_map_on_card(cuda):
    """The single-core engine's map (native.map_e2e) equals map_ with the
    default MapOpts() on the card over a 40 kbase pair, byte for byte."""
    from kbo_tpu_torch import native
    from kbo_tpu_torch.ops.derandomize import random_match_threshold

    rng = np.random.default_rng(3)
    ref = BASES[rng.integers(0, 4, 40_000)].tobytes()
    q = bytearray(ref)
    for p in range(700, 39_300, 1100):
        q[p] = BASES[(BASES.tolist().index(q[p]) + 1) % 4]
    del q[13_333:13_336]
    q[26_666:26_666] = b"GGA"
    bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    idx = kbo_tpu_torch.build([bytes(q)], bo)
    thr = random_match_threshold(51, idx.n_kmers, 4, 1e-7)
    out, n_var = native.map_e2e(idx, ref, thr, 1e-7)
    assert n_var > 0
    assert kbo_tpu_torch.map_(ref, idx, kbo_tpu_torch.MapOpts(
        sbwt_build_opts=bo), device=cuda) == out


def test_sharded_maps_on_card(cuda):
    """map_batch_index_sharded over four model shards and
    map_batch_2d_sharded over a 2 x 4 mesh on one card equal the CPU runs
    of the same calls and the card's single-device map_batch, byte for
    byte."""
    from kbo_tpu_torch.parallel import mesh as pmesh

    ref, query = _mesh_pair()
    bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    idx = kbo_tpu_torch.build([query], bo)
    opts = kbo_tpu_torch.MapOpts(sbwt_build_opts=bo)
    refs = [ref[:9000], ref[9000:14000], ref[14000:23000], ref[23000:]]
    model = pmesh.make_mesh(4, axis="model", device="cuda:0")
    model_cpu = pmesh.make_mesh(4, axis="model", device="cpu")
    got = pmesh.map_batch_index_sharded(refs, idx, opts, model)
    assert got == pmesh.map_batch_index_sharded(refs, idx, opts, model_cpu)
    assert got == kbo_tpu_torch.map_batch(refs, idx, opts, device=cuda)
    grid = pmesh.make_mesh((2, 4), axis=("data", "model"), device="cuda:0")
    grid_cpu = pmesh.make_mesh((2, 4), axis=("data", "model"), device="cpu")
    got2 = pmesh.map_batch_2d_sharded(refs, idx, opts, grid)
    assert got2 is not None
    assert got2 == pmesh.map_batch_2d_sharded(refs, idx, opts, grid_cpu)
    assert got2 == got


@pytest.mark.parametrize("k", [51, 127])
def test_search_loop_on_card(cuda, k):
    """The bucket table, the lower bound, membership and the left
    extension on the card equal the CPU twins, over the single table and
    over four shards on the card; at k = 127 the probes are 13 words (the
    rows join's largest W)."""
    from kbo_tpu_torch.kernels import refine
    from kbo_tpu_torch.parallel import mesh as pmesh

    _, query = _mesh_pair(8_000)
    idx = kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=k))
    keys3 = device_index(idx, "cpu").keys3
    rng = np.random.default_rng(k)
    rows = torch.from_numpy(rng.integers(-1, idx.n_rows, 512).astype(np.int32))
    kmers = refine.unpack_rows3(keys3, rows, k)
    packed = refine._pack_codes_matrix(kmers, k)
    assert packed.shape[0] == (k + 9) // 10
    probes = packed.clone()
    probes[0, ::3] ^= 1 << 3
    budgets = torch.from_numpy(rng.integers(0, k + 1, 512).astype(np.int32))
    tbl = refine.bucket_table(keys3)
    assert torch.equal(refine.bucket_table(keys3.to(cuda)).cpu(), tbl)
    assert torch.equal(refine._pack_codes_matrix(kmers.to(cuda), k).cpu(),
                       packed)
    for t in (None, tbl):
        tc = None if t is None else t.to(cuda)
        assert torch.equal(refine._lower_bound_device(
            keys3.to(cuda), probes.to(cuda), tc).cpu(),
            refine._lower_bound_device(keys3, probes, t))
        assert torch.equal(refine._member_rows_device(
            keys3.to(cuda), probes.to(cuda), tc).cpu(),
            refine._member_rows_device(keys3, probes, t))
    want = refine.left_extend_device(keys3, kmers, budgets, k, tbl)
    got = refine.left_extend_device(keys3.to(cuda), kmers.to(cuda),
                                    budgets.to(cuda), k, tbl.to(cuda))
    sk = pmesh.Sharded3Index(idx, pmesh.make_mesh(
        4, axis="model", device="cuda:0")).group()
    got4 = refine.left_extend_device(sk, kmers.to(cuda), budgets.to(cuda), k)
    for g, g4, w in zip(got, got4, want):
        assert torch.equal(g.cpu(), w) and torch.equal(g4.cpu(), w)
    assert torch.equal(refine.unpack_rows3(sk, rows.to(cuda), k).cpu()[
        rows >= 0], kmers[rows >= 0])


def test_ext_walk_on_card(cuda):
    """The chain-link walk (kernels/refine.py ext_walk) on the card equals
    its plain version at the benchmark's shape: the links of a 4.7 M row
    index holding a tandem repeat (a chain that cycles), 4096 random lanes
    and the repeat's 7 rows 8 times each, at budgets 0 to 200. Then one
    default map_ through a device full index with a gap for the host
    evaluator launches it once and equals the map through the host index,
    whose evaluator takes the rounds."""
    from kbo_tpu_torch import api
    from kbo_tpu_torch.kernels.refine import (
        ext_walk,
        ext_walk_plain,
        get_ext_links,
    )
    from kbo_tpu_torch.utils.stats import get_stats, reset_stats

    rng = np.random.default_rng(40)
    genome = BASES[rng.integers(0, 4, 4_700_000)].tobytes()
    # a sequence that is a tandem repeat and nothing else: every row of it
    # has one parent (its first is preceded by '$' alone), so chains cycle
    repeat = b"ACGTTGA" * 100
    k = 51
    bo = kbo_tpu_torch.BuildOpts(k=k)
    gpu = api.build_device([genome, repeat], bo, full=True, device=cuda)
    link = get_ext_links(gpu)
    assert link.shape[0] >= 4_700_000
    row_pos = gpu.row_pos[: gpu.n_rows].cpu().numpy()
    in_repeat = np.flatnonzero(row_pos >= 3 * k + len(genome) - 1)
    rows = np.concatenate([rng.integers(0, gpu.n_rows, 4096),
                           np.repeat(in_repeat, 8)]).astype(np.int64)
    budgets = rng.integers(0, 201, rows.size).astype(np.int64)
    n_rep = 8 * in_repeat.size
    budgets[-n_rep:] = 200
    r_d = torch.from_numpy(rows).to(cuda)
    b_d = torch.from_numpy(budgets).to(cuda)
    before = ext_walk.launches
    got = ext_walk(link, r_d, b_d, 200)
    assert ext_walk.launches == before + 1
    want = ext_walk_plain(link, r_d, b_d, 200)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert in_repeat.size == 7 and (got[1][-n_rep:] == 200).all()

    query = bytes(genome[:200_000])
    ref = bytearray(query)
    ref[100_000:100_200] = BASES[rng.integers(0, 4, 200)].tobytes()
    for p in (150_000, 150_012):
        ref[p] = BASES[(BASES.tolist().index(ref[p]) + 1) % 4]
    bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    opts = kbo_tpu_torch.MapOpts(sbwt_build_opts=bo)
    full = api.build_device([query], bo, full=True, device=cuda)
    reset_stats()
    before = ext_walk.launches
    out = api.map_(bytes(ref), full, opts, device=cuda)
    assert ext_walk.launches == before + 1
    d = get_stats().as_dict()
    assert d["gaps_to_host"] > 0 and d["host_ext_walk_lanes"] > 0
    assert "host_ext_rounds" not in d
    host = kbo_tpu_torch.build([query], bo)
    assert out == api.map_(bytes(ref), host, opts, device=cuda)
