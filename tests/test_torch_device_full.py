"""The port's device-built full index (kernels.ms.DeviceFullIndex,
api.build_device(full=True)) against kbo_tpu's and the host build, on the
CPU: a mirror of tests/test_device_build.py.

Three radix sorts replace the host construction; the tables must equal the
host build's and kbo_tpu's device build (sentinel tail included), and
map / call / find / find_batch against the index must equal the same calls
against the host index, and kbo_tpu's.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu_torch import api, engine
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.kernels.sort import u32
from kbo_tpu_torch.refine import gap_filling as tgap

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rows(rles):
    return [(r.start, r.end, r.matches, r.mismatches, r.gap_bases,
             r.gap_opens) for r in rles]


def _vrows(vs):
    return [(v.query_pos, v.query_chars, v.ref_chars) for v in vs]


@pytest.fixture(scope="module")
def pair():
    """tests/test_device_build.py's pair: SNPs every 1100, a 3-base
    deletion and an N run inside the indexed side."""
    rng = np.random.default_rng(3)
    n = 30000
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    q = bytearray(ref)
    for pos in range(700, n - 700, 1100):
        q[pos] = BASES[(BASES.tolist().index(q[pos]) + 1) % 4]
    del q[9100:9103]
    q[15000:15002] = b"NN"
    return ref, bytes(q)


@pytest.fixture(scope="module")
def indexes(pair):
    ref, query = pair
    tbo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    jbo = kbo_tpu.BuildOpts(k=51, build_select=True)
    return (
        ref,
        kbo_tpu_torch.build([query], tbo),
        api.build_device([query], tbo, full=True, device="cpu"),
        kbo_tpu.build([query], jbo),
        japi.build_device([query], jbo, full=True),
        tbo,
        jbo,
    )


def test_tables_match_host_build(indexes):
    _, host, dev, _, jdev, _, _ = indexes
    assert isinstance(dev, tms.DeviceFullIndex)
    assert isinstance(dev, tms.DeviceIndex)
    assert (dev.n_rows, dev.n_kmers) == (host.n_rows, host.n_kmers)
    np.testing.assert_array_equal(dev.C, host.C)
    keys3 = dev.keys3.numpy().view(np.uint32)
    np.testing.assert_array_equal(keys3[:, : dev.n_rows], host.keys3)
    # the sentinel tail: all-ones keys3 and row position -1 past n_rows,
    # cap 0 on those keys2 rows (and on the all-'$' root row)
    assert (keys3[:, dev.n_rows :] == 0xFFFFFFFF).all()
    assert (dev.row_pos[dev.n_rows :] == -1).all()
    assert int((dev.cap2 == 0).sum()) == keys3.shape[1] - dev.n_rows + 1


def test_tables_match_kbo_tpu_device_build(indexes):
    """Every table, sentinel tail included, equals kbo_tpu's device build,
    and so do lcs3 and the rows join's payload over the whole tail."""
    _, _, dev, _, jdev, _, _ = indexes
    assert (dev.n_rows, dev.n_kmers) == (jdev.n_rows, jdev.n_kmers)
    np.testing.assert_array_equal(dev.C, jdev.C)
    for name in ("keys3", "keys2"):
        np.testing.assert_array_equal(
            getattr(dev, name).numpy().view(np.uint32),
            np.asarray(getattr(jdev, name)),
        )
    np.testing.assert_array_equal(dev.cap2.numpy(), np.asarray(jdev.cap2))
    np.testing.assert_array_equal(dev.row_pos.numpy(), np.asarray(jdev.row_pos))
    np.testing.assert_array_equal(dev.lcs3.numpy(), np.asarray(jdev.lcs3))
    np.testing.assert_array_equal(dev.text, jdev.text)
    lcs = u32(dev.lcs3)
    assert dev.rows_packed.shape == dev.lcs3.shape and (lcs <= 51).all()


def test_access_kmers_match(indexes):
    _, host, dev, _, jdev, _, _ = indexes
    rows = np.array([0, 1, 5, 1000, dev.n_rows - 1], dtype=np.int64)
    got = dev.access_kmers_codes(rows)
    np.testing.assert_array_equal(got, host.access_kmers_codes(rows))
    np.testing.assert_array_equal(got, jdev.access_kmers_codes(rows))
    assert dev.access_kmer(5) == host.access_kmer(5) == jdev.access_kmer(5)
    assert dev.alphabet() == b"ACGT"
    for bad in ([dev.n_rows], [-1], [0, dev.n_rows + 3]):
        with pytest.raises(IndexError):
            dev.access_kmers_codes(np.asarray(bad))


def test_member_widths(indexes):
    """Membership probes of every row's k-mer (width 1), of mutated
    k-mers, '$'-padded dummies and INVALID windows, against kbo_tpu's
    device probe; the gap filler's membership reads it."""
    _, host, dev, _, jdev, _, _ = indexes
    rng = np.random.default_rng(5)
    rows = rng.integers(0, dev.n_rows, 300)
    probes = dev.access_kmers_codes(rows).copy()
    mutated = probes.copy()
    mutated[:, rng.integers(0, 51, 300)] = rng.integers(1, 5, (300, 300))
    junk = rng.integers(0, 6, (77, 51)).astype(np.uint8)
    junk[junk == 5] = 255
    probes = np.concatenate([probes, mutated, junk])
    got = dev.member_widths(probes)
    np.testing.assert_array_equal(got, np.asarray(jdev.member_widths(probes)))
    real = ~(probes[:300] == 0).any(axis=1)  # '$'-padded rows never match
    assert real.sum() > 250 and (got[:300][real] == 1).all()
    assert set(np.unique(got)) == {0, 1}
    np.testing.assert_array_equal(
        tgap._member_rows(dev, probes), tgap._member_rows(host, probes)
    )


def test_map_call_find_parity(indexes):
    """map_ (MapOpts() with the index's BuildOpts), call and find against
    the device index equal the host index's and kbo_tpu's."""
    ref, host, dev, jhost, _, tbo, jbo = indexes
    mo = kbo_tpu_torch.MapOpts(sbwt_build_opts=tbo)
    got = api.map_(ref, dev, mo, device="cpu")
    assert got == api.map_(ref, host, mo, device="cpu")
    assert got == japi.map_(ref, jhost, kbo_tpu.MapOpts(sbwt_build_opts=jbo))
    co = kbo_tpu_torch.CallOpts(max_error_prob=1e-7, sbwt_build_opts=tbo)
    vd = api.call(dev, ref, co, device="cpu")
    assert _vrows(vd) == _vrows(api.call(host, ref, co, device="cpu"))
    jco = kbo_tpu.CallOpts(max_error_prob=1e-7, sbwt_build_opts=jbo)
    assert _vrows(vd) == _vrows(japi.call(jhost, ref, jco))
    assert len(vd) > 0
    fo = kbo_tpu_torch.FindOpts(max_gap_len=5)
    fd = api.find(ref, dev, fo, device="cpu")
    assert _rows(fd) == _rows(api.find(ref, host, fo, device="cpu"))
    assert _rows(fd) == _rows(
        japi.find(ref, jhost, kbo_tpu.FindOpts(max_gap_len=5)))
    assert api.matches(ref[:3000], dev, device="cpu") == api.matches(
        ref[:3000], host, device="cpu")


@pytest.mark.parametrize("gap", [0, 20])
def test_find_batch_device_full(indexes, gap):
    """find_batch against the device index (the device segment table at
    gap 0, chars and host RLE otherwise), both strands."""
    ref, host, dev, jhost, _, _, _ = indexes
    queries = [ref[100:900], ref[5000:7000][::-1], b"ACGT" * 50 + ref[:300],
               ref[9000:9300], ref[14900:15200]]
    got = kbo_tpu_torch.find_batch(
        queries, dev, kbo_tpu_torch.FindOpts(max_gap_len=gap), device="cpu")
    want = japi.find_batch(queries, jhost, kbo_tpu.FindOpts(max_gap_len=gap))
    assert [_rows(g) for g in got] == [_rows(w) for w in want]
    assert any(len(g) for g in got)


def test_device_index_passes_through(indexes):
    _, _, dev, _, _, _, _ = indexes
    assert engine.device_index(dev) is dev
    assert engine.device_index(dev, "cpu") is dev


def test_build_device_full_guards():
    with pytest.raises(AssertionError):
        api.build_device([b"ACGT" * 40], kbo_tpu_torch.BuildOpts(k=64),
                         full=True, device="cpu")
    with pytest.raises(AssertionError):
        api.build_device([b"NNNN"], kbo_tpu_torch.BuildOpts(k=5), full=True,
                         device="cpu")


@pytest.mark.parametrize("add_revcomp", [False, True])
def test_small_multi_sequence(add_revcomp):
    """Several sequences with '$' dummies and duplicate k-mers, k = 7:
    every table equals kbo_tpu's device build and the host build's rows."""
    rng = np.random.default_rng(12)
    seqs = [BASES[rng.integers(0, 4, n)].tobytes() for n in (40, 300, 9)]
    seqs.append(seqs[1][50:120] + b"N" + seqs[1][:60])
    tbo = kbo_tpu_torch.BuildOpts(k=7, add_revcomp=add_revcomp)
    jbo = kbo_tpu.BuildOpts(k=7, add_revcomp=add_revcomp)
    dev = api.build_device(seqs, tbo, full=True, device="cpu")
    jdev = japi.build_device(seqs, jbo, full=True)
    host = kbo_tpu_torch.build(seqs, tbo)
    assert (dev.n_rows, dev.n_kmers) == (host.n_rows, host.n_kmers)
    np.testing.assert_array_equal(dev.C, host.C)
    np.testing.assert_array_equal(
        dev.keys3.numpy().view(np.uint32)[:, : dev.n_rows], host.keys3)
    for name in ("keys3", "keys2", "cap2", "row_pos"):
        np.testing.assert_array_equal(
            getattr(dev, name).numpy(),
            np.asarray(getattr(jdev, name)).view(
                getattr(dev, name).numpy().dtype),
        )
