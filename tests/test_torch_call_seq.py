"""The port's sparse interval probes, the index-free vs-sequence join and
the device-built sequence index (kernels/ms.py, engine.py, pipeline.py,
api.build_device) against kbo_tpu's, on the CPU.

kbo_tpu runs its non-TPU branches (concat + radix sort); the port runs
the kernels' plain versions. Intervals are also held against kbo_tpu's
scalar SBWT walk, which kbo_tpu itself answers small probe sets with.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import engine as jengine
from kbo_tpu.kernels import ms as jms
from kbo_tpu.ops.ms import query_ms_codes
from kbo_tpu_torch import api, engine
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import ms as tms

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _interval_case(k):
    """A multi-segment reference (many dummy rows) and a query that
    overlaps its segment starts, with an N run."""
    rng = np.random.default_rng(37 + k)
    ref = bytearray(BASES[rng.integers(0, 4, 600)].tobytes())
    ref[60:62] = b"NN"
    ref[150] = ord("N")
    ref = bytes(ref)
    q = bytearray(BASES[rng.integers(0, 4, 400)].tobytes())
    q[5:125] = ref[0:120]
    q[180:300] = ref[62:182]
    q[330:340] = b"N" * 10
    return ref, bytes(q)


@pytest.mark.parametrize("k", [31, 51])
def test_intervals_at_three_branches(k):
    """compute_ms_intervals_at with a host ms, with a device ms row and
    host windows, and with a device ms row and device codes, at every
    query position: equal to kbo_tpu's and to its walk (counts over all
    rows, dummies included); the same through SparseIntervals' cache."""
    ref, q = _interval_case(k)
    tidx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build([ref], kbo_tpu.BuildOpts(k=k))
    codes = encode_ascii(q)
    ms_walk, iv_walk = query_ms_codes(jidx, codes)
    pos = np.arange(len(q))
    ms_j, iv_j = jengine.compute_ms_intervals_at(jidx, codes, pos)
    np.testing.assert_array_equal(iv_j, iv_walk)
    row = tms.query_ms_row_device(engine.device_index(tidx, "cpu"), codes)
    for kw in ({}, {"ms": ms_walk}, {"ms": row},
               {"ms": row, "dev_codes": torch.from_numpy(codes)}):
        ms_t, iv_t = engine.compute_ms_intervals_at(tidx, codes, pos,
                                                    device="cpu", **kw)
        assert ms_t.dtype == iv_t.dtype == np.int64
        np.testing.assert_array_equal(ms_t, ms_j)
        np.testing.assert_array_equal(iv_t, iv_j)
    # the full-buffer probe over the whole query (kbo_tpu's
    # query_ms_device pairs it with the 3-bit MS)
    buf, L = tms.make_flat_buffer(codes, k)
    l_full, r_full = tms.intervals3_core(
        engine.device_index(tidx, "cpu").keys3, torch.from_numpy(buf),
        torch.from_numpy(np.concatenate([np.zeros(k - 1), ms_walk, np.zeros(
            buf.size - k + 1 - L)]).astype(np.int32)), k)
    np.testing.assert_array_equal(l_full[k - 1:k - 1 + L].numpy(),
                                  iv_walk[:, 0])
    np.testing.assert_array_equal(r_full[k - 1:k - 1 + L].numpy(),
                                  iv_walk[:, 1])
    sp = engine.SparseIntervals(tidx, codes, ms=row)
    shuffled = np.random.default_rng(k).permutation(pos)
    for part in np.array_split(shuffled, 11):  # more blocks than it keeps
        sp.prefetch(part)
    np.testing.assert_array_equal(sp.get_batch(shuffled), iv_walk[shuffled])
    np.testing.assert_array_equal(sp.get_ms_batch(pos), ms_walk)
    assert sp[int(pos[7]), 1] == iv_walk[7, 1] and len(sp) == len(q)
    fresh = engine.SparseIntervals(tidx, codes, ms=row)
    with pytest.raises(KeyError):
        fresh[3, 0]


def test_intervals_under_host_cutoff():
    """A probe set small enough that kbo_tpu answers it with its scalar
    walk (probes x k < 256): the port's device probe gives the same
    intervals, so the same uniqueness r - l == 1."""
    k = 31
    ref, q = _interval_case(k)
    tidx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build([ref], kbo_tpu.BuildOpts(k=k))
    codes = encode_ascii(q)
    pos = np.array([3, 40, 124, 200, 335, 399])
    assert pos.size * k < jengine._HOST_CUTOFF
    ms_j, iv_j = jengine.compute_ms_intervals_at(jidx, codes, pos)
    ms_t, iv_t = engine.compute_ms_intervals_at(tidx, codes, pos,
                                                device="cpu")
    np.testing.assert_array_equal(ms_t, ms_j)
    np.testing.assert_array_equal(iv_t, iv_j)
    assert (iv_t[:, 1] - iv_t[:, 0] == 1).any()


def test_interval_probe_and_vs_seq_k254():
    """At k = 254 (W = 26: 27 key rows in the interval merge, 26 words in
    the vs-sequence scans) the interval probe and the index-free join equal
    kbo_tpu's cores, and merge="bitonic" equals merge="path"."""
    k = 254
    rng = np.random.default_rng(254)
    ref = BASES[rng.integers(0, 4, 1500)].tobytes()
    q = bytearray(ref[200:1100])
    q[300] = ord("A") if q[300] != ord("A") else ord("C")
    q = bytes(q)
    tidx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build([ref], kbo_tpu.BuildOpts(k=k))
    codes = encode_ascii(q)
    ms_walk, iv_walk = query_ms_codes(jidx, codes)
    pos = np.arange(0, len(q), 7)
    padded = np.full(codes.size + k - 1, 255, dtype=np.uint8)
    padded[k - 1:] = codes
    win = padded[pos[:, None] + np.arange(k)[None, :]]
    ms_at = ms_walk[pos].astype(np.int32)
    dev = engine.device_index(tidx, "cpu")
    got = tms.intervals3_windows_core(dev.keys3, torch.from_numpy(win),
                                      torch.from_numpy(ms_at), k)
    want = jms._intervals3_windows_jit(jnp.asarray(jidx.keys3),
                                       jnp.asarray(win), jnp.asarray(ms_at), k)
    for g, w, col in zip(got, want, (0, 1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), iv_walk[pos, col])
    bit = tms.intervals3_windows_core(dev.keys3, torch.from_numpy(win),
                                      torch.from_numpy(ms_at), k,
                                      merge="bitonic")
    assert all(torch.equal(a, b) for a, b in zip(bit, got))

    kmers = [codes[s:s + k] for s in (0, 100, 300 - k + 5, len(q) - k)]
    ref_codes = encode_ascii(ref)
    got = engine.compute_ms_values_vs_seq(ref_codes, kmers, k, "cpu")
    want = jengine.compute_ms_values_vs_seq(ref_codes, kmers, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert max(int(g.max()) for g in got) == k


def test_vs_seq_join_and_slot_limit(monkeypatch):
    """ms3_batch_vs_seq_core (the concat-sorted join, ref_sorted=False) on
    a reference with an N and the revcomp separator equals kbo_tpu's, and
    so does the two-operand path past the packed slot limit."""
    k = 31
    rng = np.random.default_rng(5)
    ref = bytearray(BASES[rng.integers(0, 4, 2000)].tobytes())
    ref[700] = ord("N")
    ref_codes = np.concatenate([encode_ascii(bytes(ref)), [255],
                                encode_ascii(bytes(ref[::-1]))])
    qs = [ref_codes[s:s + k] for s in (0, 650, 690, 1500, 2005)]
    qs.append(encode_ascii(BASES[rng.integers(0, 4, k)].tobytes()))
    want = jengine.compute_ms_values_vs_seq(ref_codes, qs, k)
    got = engine.compute_ms_values_vs_seq(ref_codes, qs, k, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(tms, "_PACKED_SLOT_LIMIT", 1000)
    for g, w in zip(engine.compute_ms_values_vs_seq(ref_codes, qs, k, "cpu"),
                    want):
        np.testing.assert_array_equal(g, w)


def _rows(rles):
    return [dataclasses.asdict(r) for r in rles]


@pytest.mark.parametrize("add_revcomp", [False, True])
def test_build_device_find_batch(add_revcomp):
    """build_device's sequence index (its sorted keys and distinct k-mer
    count) and find_batch against it, device RLE and gapped, equal
    kbo_tpu's DeviceSeqIndex path."""
    k = 31
    rng = np.random.default_rng(17)
    genome = bytearray(BASES[rng.integers(0, 4, 3000)].tobytes())
    genome[1200] = ord("N")
    other = BASES[rng.integers(0, 4, 500)].tobytes()
    genome, other = bytes(genome), bytes(other)
    queries = [genome[100:400], genome[1000:1700][::-1],
               b"ACGT" * 30 + genome[2000:2200], other[:120] + genome[:90],
               genome[1150:1260]]
    tb = kbo_tpu_torch.BuildOpts(k=k, add_revcomp=add_revcomp)
    jb = kbo_tpu.BuildOpts(k=k, add_revcomp=add_revcomp)
    tdi = api.build_device([genome, other], tb, device="cpu")
    jdi = kbo_tpu.api.build_device([genome, other], jb)
    assert isinstance(tdi, tms.DeviceSeqIndex)
    assert tdi.n_kmers == jdi.n_kmers
    np.testing.assert_array_equal(
        tdi.ref_words.numpy().view(np.uint32), np.stack(
            [np.asarray(w) for w in jdi.ref_words]))
    for gap in (0, 20):
        got = kbo_tpu_torch.find_batch(
            queries, tdi, kbo_tpu_torch.FindOpts(max_gap_len=gap))
        want = kbo_tpu.api.find_batch(queries, jdi,
                                      kbo_tpu.FindOpts(max_gap_len=gap))
        assert [_rows(g) for g in got] == [_rows(w) for w in want]
    assert any(len(r) for r in got)
    full = api.build_device([genome, other], tb, full=True, device="cpu")
    assert isinstance(full, tms.DeviceFullIndex)
    got_full = kbo_tpu_torch.find_batch(
        queries, full, kbo_tpu_torch.FindOpts(max_gap_len=20))
    assert [_rows(g) for g in got_full] == [_rows(w) for w in want]
