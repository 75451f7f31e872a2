"""The anchor search of a standalone call on the device (the gated
interval probe over the resident MS row and code buffer,
refine/variant_calling.py ``_anchors_device``) against the interval
provider's rounds, the host ``cand`` pass and kbo_tpu's call, on the CPU.

The streamed reference carries SNPs, 1-10 base indels, a block the
indexed draft lacks (its drop never anchors), a SNP just before a short
repeat (the first candidates with ms >= d are not unique) and drops
within k of its end.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu_torch import api, engine
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.refine import variant_calling as tvc
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ERR = 1e-4


def _other(*avoid):
    return next(b for b in b"ACGT" if b not in avoid)


def _planted(k, n=8000, seed=7):
    """(draft, reference, repeat SNP position, block start) at k."""
    rng = np.random.default_rng(seed + k)
    d = random_match_threshold(k, n, 4, ERR)
    draft = bytearray(BASES[rng.integers(0, 4, n)].tobytes())
    # a repeat of d + 6 bases at two places with other flanks: past a SNP
    # just before its first copy, the matched suffix lies in both copies
    # (two k-mer rows) until it reaches the flank
    a, b, lr = 1200, 5200, d + 6
    draft[b : b + lr] = draft[a : a + lr]
    draft = bytes(draft)
    ref = bytearray(draft)
    ref[a - 1] = _other(draft[a - 1], draft[b - 1])
    for p in (600, 2400, 3900, n - d - 8, n - 12):
        ref[p] = _other(ref[p])
    # indels 1-10 bases, from the far end so that positions hold
    ref[7400:7400] = b"GATTACA"
    del ref[6800:6810]
    ref[4600:4600] = b"TT"
    del ref[3300:3303]
    del ref[1800]
    # a block the draft lacks
    block = 3000
    ref[block:block] = BASES[rng.integers(0, 4, 300)].tobytes()
    # the SNPs past the insertions moved by 7 + 2 + 300 - 10 - 3 - 1
    return draft, bytes(ref), a - 1, block


def _index(draft, bo):
    """The device-built full index below k = 64, the host build above."""
    if bo.k < 64:
        return api.build_device([draft], bo, full=True, device="cpu")
    return kbo_tpu_torch.build([draft], bo)


def _setup(k):
    draft, ref, rep_snp, block = _planted(k)
    bo = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    idx = _index(draft, bo)
    codes = encode_ascii(ref)
    d = random_match_threshold(k, idx.n_kmers, 4, ERR)
    row, buf = tms.query_ms_row_and_buffer_device(
        engine.device_index(idx, "cpu"), codes)
    drops = tms.ms_drops_device(row, d)
    return draft, ref, idx, bo, codes, d, row, buf, drops, rep_snp, block


def _branches(idx, codes, n, k, d, drops, row, buf):
    device = tvc._anchors(idx, codes, n, k, d, drops, None, None, None,
                          None, (row, buf), "cpu")
    rounds = tvc._anchors(idx, codes, n, k, d, drops, None,
                          engine.SparseIntervals(idx, codes, ms=row), None,
                          None, None, "cpu")
    cand = tvc._anchors(idx, codes, n, k, d, drops,
                        row.numpy().astype(np.int64), None, None, None, None,
                        "cpu")
    return device, rounds, cand


def _tuples(variants):
    return [(v.query_pos, v.query_chars, v.ref_chars) for v in variants]


@pytest.mark.parametrize("k", [31, 51, 151])
def test_device_anchors_equal_rounds_and_cand(k):
    """Sites, anchors and rows of the device branch equal the rounds'
    and the cand pass's on every planted case, and so do the variants
    (call_variants with the resident pair against the provider)."""
    (draft, ref, idx, bo, codes, d, row, buf, drops, rep_snp,
     block) = _setup(k)
    n = len(ref)
    reset_stats()
    device, rounds, cand = _branches(idx, codes, n, k, d, drops, row, buf)
    st = get_stats().as_dict()
    for x, y, z in zip(device, rounds, cand):
        assert x.dtype == y.dtype == np.int64
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    sites, anchors, rows = device
    # the planted cases are there: the block's drop never anchors, drops
    # lie within k of the end, and past the repeat SNP the first
    # candidate with ms >= d has a wider interval than one
    in_block = drops[(drops >= block) & (drops < block + 10)]
    assert in_block.size and not np.isin(in_block, sites).any()
    assert (drops + k >= n).any()
    assert rep_snp in sites
    ms_h, iv = engine.compute_ms(idx, codes, "cpu")
    js = rep_snp + np.arange(1, k + 1)
    first = js[np.argmax(ms_h[js] >= d)]
    assert iv[first, 1] - iv[first, 0] > 1
    assert anchors[sites.tolist().index(rep_snp)] > first
    np.testing.assert_array_equal(rows, iv[anchors, 0])
    # the device branch's probe and its two fetches (the provider's
    # rounds count on after it)
    assert st["call_anchor_probe_positions"] > 0
    assert st["call_anchor_fetch_calls"] >= 2
    res = tvc.call_variants(idx, codes, ref, ERR, drops=drops,
                            resident=(row, buf), device="cpu")
    want = tvc.call_variants(idx, codes, ref, ERR, drops=drops,
                             ivals=engine.SparseIntervals(idx, codes, ms=row),
                             device="cpu")
    assert _tuples(res) == _tuples(want) and res


@pytest.mark.parametrize("k", [31, 51, 151])
def test_call_device_anchors_equal_kbo_tpu(k):
    """api.call takes the device branch (one probe, two fetches) and
    equals kbo_tpu's call."""
    draft, ref, _, _ = _planted(k)
    tb = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    jb = kbo_tpu.BuildOpts(k=k, build_select=True)
    reset_stats()
    got = kbo_tpu_torch.call(
        _index(draft, tb), ref,
        kbo_tpu_torch.CallOpts(max_error_prob=ERR, sbwt_build_opts=tb),
        device="cpu")
    st = get_stats().as_dict()
    want = kbo_tpu.call(kbo_tpu.build([draft], jb), ref,
                        kbo_tpu.CallOpts(max_error_prob=ERR,
                                         sbwt_build_opts=jb))
    assert _tuples(got) == _tuples(want)
    assert len(got) >= 5
    assert st["call_anchor_rounds"] == 1
    assert st["call_anchor_fetch_calls"] == 2
    assert st["call_anchor_probe_positions"] > 0


@pytest.mark.parametrize("per_slab", [1, 2, 5])
def test_device_anchors_in_slabs(monkeypatch, per_slab):
    """Slabs of a few drops each: one probe a slab with gated positions,
    still two fetches, and the same anchors and rows."""
    k = 51
    (_, ref, idx, _, codes, d, row, buf, drops, _, _) = _setup(k)
    n = len(ref)
    whole = tvc._anchors(idx, codes, n, k, d, drops, None, None, None,
                         None, (row, buf), "cpu")
    monkeypatch.setattr(tvc, "_ANCHOR_SLAB", per_slab * k)
    probes = []
    real = tms._intervals_from_keys

    def counted(keys3, q_words, ms, *a, **kw):
        probes.append(q_words.shape[1])
        assert q_words.shape[1] <= per_slab * k
        return real(keys3, q_words, ms, *a, **kw)

    monkeypatch.setattr(tms, "_intervals_from_keys", counted)
    reset_stats()
    split = tvc._anchors(idx, codes, n, k, d, drops, None, None, None, None,
                         (row, buf), "cpu")
    st = get_stats().as_dict()
    for x, y in zip(whole, split):
        np.testing.assert_array_equal(x, y)
    assert len(probes) > 1 and st["call_anchor_rounds"] == len(probes)
    assert st["call_anchor_probe_positions"] == sum(probes)
    assert st["call_anchor_fetch_calls"] == 2


def test_call_zero_drops_and_short_contig():
    """A reference equal to the draft has no drop (no probe, no fetch); a
    contig under 1024 bases keeps the host-built index and the cand pass;
    both equal kbo_tpu's call. No drop at all gives empty anchors."""
    k = 31
    draft, ref, _, _ = _planted(k)
    tb = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    jb = kbo_tpu.BuildOpts(k=k, build_select=True)
    topts = kbo_tpu_torch.CallOpts(max_error_prob=ERR, sbwt_build_opts=tb)
    jopts = kbo_tpu.CallOpts(max_error_prob=ERR, sbwt_build_opts=jb)
    tidx = _index(draft, tb)
    jidx = kbo_tpu.build([draft], jb)
    reset_stats()
    assert kbo_tpu_torch.call(tidx, draft, topts, device="cpu") == []
    st = get_stats().as_dict()
    assert "call_anchor_rounds" not in st and st["call_drops_calls"] == 1
    assert kbo_tpu.call(jidx, draft, jopts) == []
    short = ref[500:1000]
    reset_stats()
    got = kbo_tpu_torch.call(tidx, short, topts, device="cpu")
    assert "call_anchor_rounds" not in get_stats().as_dict()
    assert _tuples(got) == _tuples(kbo_tpu.call(jidx, short, jopts))
    assert got
    row, buf = tms.query_ms_row_and_buffer_device(
        engine.device_index(tidx, "cpu"), encode_ascii(ref))
    none = tvc._anchors_device(tidx, row, buf, np.zeros(0, np.int64), k, 9)
    assert [x.size for x in none] == [0, 0]
