"""The port's variant calling (refine/variant_calling.py, api.call and
the drop scan) against kbo_tpu's, on the CPU.

kbo_tpu runs its own paths here: the scalar SBWT walk for the small
golden cases (its host cutoff) and its JAX device path for the 8 kbase
pairs; the port runs every join on the CPU with the kernels' plain
versions. Variants are compared as (query_pos, query_chars, ref_chars).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.kernels import ms as jms
from kbo_tpu.ops.ms import query_ms_codes
from kbo_tpu.refine import variant_calling as jvc
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.refine import variant_calling as tvc

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
GENE = b"GCGGGGCTGTTGACGTTTGGGGTTGAATAAATCTATTGTACCAATCGGCATCAACGTG"

# (reference, query, k, expected) of tests/test_variant_calling.py
CASES = {
    "single_subst": (GENE, GENE[:49] + b"T" + GENE[50:], 20,
                     [(49, b"T", b"A")]),
    "multi_subst": (
        GENE,
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAGCGTCTATTGTACCAATCGGCATCAACGTG", 30,
        [(29, b"GCG", b"AA")]),
    "multi_ins_non_overlap": (
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATATCTATTGTACCAATCGGCATCAACGTG",
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAGCGTCTATTGTACCAATCGGCATCAACGTG", 30,
        [(29, b"GCG", b"")]),
    "multi_ins_overlap": (
        GENE,
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAAAAAAATCTATTGTACCAATCGGCATCAACGTG",
        30, [(31, b"AAAA", b"")]),
    "single_ins_non_overlap": (
        GENE,
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAAATCTATTGTACCAATCGGCAGTCAACGTG", 20,
        [(50, b"G", b"")]),
    "single_ins_overlap": (
        GENE,
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAAATCTATTGTACCAATCGGCAATCAACGTG", 20,
        [(50, b"A", b"")]),
    "single_del_non_overlap": (
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAAATCTATTGTACCAATCGGCAGTCAACGTG",
        GENE, 20, [(50, b"", b"G")]),
    "single_del_overlap": (
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAAATCTATTGTACCAATCGGCATTCAACGTG",
        GENE, 20, [(51, b"", b"T")]),
    "multi_del_non_overlap": (
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAGCGTCTATTGTACCAATCGGCATCAACGTG",
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATATCTATTGTACCAATCGGCATCAACGTG", 30,
        [(29, b"", b"GCG")]),
    "multi_del_overlap": (
        b"GCGGGGCTGTTGACGTTTGGGGTTGAATAAAAAAATCTATTGTACCAATCGGCATCAACGTG",
        GENE, 30, [(31, b"", b"AAAA")]),
    "same_query": (
        b"TCGTGGATCGATACACGCTAGCAGGCTGACTCGATGGGATACTATGTGTTATAGCAATTCGGATC"
        b"GATCGA",
        b"TCGTGGATCGATACACGCTAGCAGCTGACTCGATGGGATACCATGTGTTATAGCAATTCCGGATC"
        b"GATCGA", 20,
        [(24, b"", b"G"), (41, b"C", b"T"), (59, b"C", b"")]),
}


def _tuples(variants):
    return [(v.query_pos, v.query_chars, v.ref_chars) for v in variants]


@pytest.mark.parametrize("case", list(CASES))
def test_call_variants_cases(case):
    """call_variants with two indexes (the cand pass and the stacked
    phase-3 fetch) and _resolve_all on kbo_tpu's walk MS equal kbo_tpu's
    call_variants / _resolve_all and the literal variants."""
    reference, query, k, expected = CASES[case]
    tb = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    jb = kbo_tpu.BuildOpts(k=k, build_select=True)
    got = tvc.call_variants(
        kbo_tpu_torch.build([reference], tb),
        kbo_tpu_torch.build([query], tb), query, 0.001, device="cpu",
    )
    jref, jq = kbo_tpu.build([reference], jb), kbo_tpu.build([query], jb)
    want = jvc.call_variants(jref, jq, query, 0.001)
    assert _tuples(got) == _tuples(want) == expected
    assert all(isinstance(v, tvc.Variant) for v in got)

    # the vectorized case analysis on the same inputs, every drop a site
    d = kbo_tpu.ops.derandomize.random_match_threshold(
        k, jref.n_kmers, 4, 0.001)
    codes = kbo_tpu.index.encode.encode_ascii(query)
    ms, iv = query_ms_codes(jref, codes)
    sites = np.flatnonzero((ms[1:] < ms[:-1]) & (ms[1:] < d)) + 1
    anchors = np.minimum(sites + 1, len(query) - 1)
    rows = iv[anchors, 0]
    rk = jref.access_kmers_codes(rows)
    widx = anchors[:, None] + np.arange(-(k - 1), 1)[None, :]
    qk = np.where(widx >= 0, np.frombuffer(query, np.uint8)[
        np.maximum(widx, 0)], ord("$")).astype(np.uint8)
    ms_ref = np.stack([query_ms_codes(jref, c)[0] for c in np.where(
        widx >= 0, codes[np.maximum(widx, 0)], 0).astype(np.uint8)])
    ms_q = np.stack([query_ms_codes(jq, c)[0] for c in rk])
    got = tvc._resolve_all(sites, rk, qk, ms_ref, ms_q, d)
    want = jvc._resolve_all(sites, rk, qk, ms_ref, ms_q, d)
    assert _tuples(got) == _tuples(want)


def test_resolve_variant_scalar():
    """The scalar spec, the reference's doctest (src/variant_calling.rs:
    107-137) and random k-mer pairs with a common suffix, raises included."""
    query = GENE[:49] + b"T" + GENE[50:]
    k = 20
    jref = kbo_tpu.build([GENE], kbo_tpu.BuildOpts(k=k, build_select=True))
    jq = kbo_tpu.build([query], kbo_tpu.BuildOpts(k=k, build_select=True))
    enc = kbo_tpu.index.encode.encode_ascii
    ms_vs_ref, _ = query_ms_codes(jref, enc(query))
    ms_vs_query, _ = query_ms_codes(jq, enc(GENE))
    assert tvc.resolve_variant(query, GENE, ms_vs_query, ms_vs_ref, 5) == \
        (b"T", b"A")
    rng = np.random.default_rng(4)
    outcomes = set()
    for _ in range(300):
        suffix = BASES[rng.integers(0, 4, rng.integers(1, 8))].tobytes()
        a = BASES[rng.integers(0, 4, 12 - len(suffix))].tobytes() + suffix
        b = BASES[rng.integers(0, 4, 12 - len(suffix))].tobytes() + suffix
        ma, mb = rng.integers(0, 9, 12), rng.integers(0, 9, 12)
        res = []
        for mod in (tvc, jvc):
            try:
                res.append(mod.resolve_variant(a, b, ma, mb, 4))
            except mod.ResolveVariantErr as e:
                res.append(("err", e.code, str(e)))
        assert res[0] == res[1]
        outcomes.add(res[0][0] if res[0][0] == "err" else len(res[0][1]) > 0)
    assert outcomes == {"err", True, False}
    assert tvc.get_kmer_ending_at(GENE, 3, 6) == jvc.get_kmer_ending_at(
        GENE, 3, 6) == b"$$GCGG"


def test_call_doctest():
    # reference: src/lib.rs:518-545 (a 72-base reference: the host build)
    reference = (b"TCGTGGATCGATACACGCTAGCAGGCTGACTCGATGGGATACTATGTGTTATAGCAATT"
                 b"CGGATCGATCGA")
    query = (b"TCGTGGATCGATACACGCTAGCCTGACTCGATGGGATACCATGTGTTATAGCAATTCCGG"
             b"ATCGATCGA")
    opts = kbo_tpu_torch.CallOpts(max_error_prob=0.001)
    opts.sbwt_build_opts.k = 20
    got = kbo_tpu_torch.call(kbo_tpu_torch.build([query], opts.sbwt_build_opts),
                             reference, opts, device="cpu")
    jopts = kbo_tpu.CallOpts(max_error_prob=0.001)
    jopts.sbwt_build_opts.k = 20
    want = kbo_tpu.call(kbo_tpu.build([query], jopts.sbwt_build_opts),
                        reference, jopts)
    assert _tuples(got) == _tuples(want) == [
        (22, b"AGG", b""), (42, b"T", b"C"), (60, b"", b"C")]
    # over a data mesh (ROADMAP item 8a): the k-mer re-runs shard, the
    # result does not change; a mesh takes no device=
    from kbo_tpu_torch.parallel.mesh import make_mesh

    index = kbo_tpu_torch.build([query], opts.sbwt_build_opts)
    mesh = make_mesh(3, device="cpu")
    assert _tuples(kbo_tpu_torch.call(index, reference, opts, mesh=mesh)) \
        == _tuples(want)
    with pytest.raises(ValueError, match="mesh"):
        kbo_tpu_torch.call(index, reference, opts, mesh=mesh, device="cpu")


def _pair(n=8000):
    """tests/test_variant_calling.py::test_call_vs_seq_device_path's pair:
    a SNP, a 2-base deletion and a 2-base insertion."""
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
def test_call_vs_seq_pair(k, add_revcomp):
    """The device path of call (drop scan, the gated anchor probe, the
    index-free join against the reference, with its reverse complement
    after a separator when add_revcomp) equals kbo_tpu's; k = 254 puts 27
    key rows through the interval merge and 26 words through the
    vs-sequence scans."""
    query, ref = _pair()
    tb = kbo_tpu_torch.BuildOpts(k=k, build_select=True,
                                 add_revcomp=add_revcomp)
    jb = kbo_tpu.BuildOpts(k=k, build_select=True, add_revcomp=add_revcomp)
    got = kbo_tpu_torch.call(kbo_tpu_torch.build([query], tb), ref,
                             kbo_tpu_torch.CallOpts(sbwt_build_opts=tb),
                             device="cpu")
    want = kbo_tpu.call(kbo_tpu.build([query], jb), ref,
                        kbo_tpu.CallOpts(sbwt_build_opts=jb))
    assert _tuples(got) == _tuples(want)
    assert len(got) == 3
    with pytest.raises(ValueError, match="k"):
        kbo_tpu_torch.call(kbo_tpu_torch.build([query], tb), ref,
                           kbo_tpu_torch.CallOpts(), device="cpu")


def test_ms_drops_device():
    """The drop scan equals kbo_tpu's on an MS row with more drops than
    kbo_tpu's first capacity (its retry runs), and on a real row."""
    rng = np.random.default_rng(11)
    L, d = 40_000, 9
    row = np.clip(np.cumsum(rng.choice([3, 3, -4, -9, 1], L)) % 23, 0, 20)
    row = row.astype(np.int32)
    got = tms.ms_drops_device(torch.from_numpy(row), d)
    want = jms.ms_drops_device(jnp.asarray(row), d)
    ref_np = np.flatnonzero(
        (row[1:] < row[:-1]) & (row[:-1] >= d) & (row[1:] < d)) + 1
    assert got.size > 4096  # kbo_tpu's first capacity
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_np)
    assert tms.ms_drops_device(torch.zeros(5, dtype=torch.int32), 1).size == 0

    query, ref = _pair()
    tidx = kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=51))
    jidx = kbo_tpu.build([query], kbo_tpu.BuildOpts(k=51))
    codes = kbo_tpu_torch.index.encode.encode_ascii(ref)
    trow = tms.query_ms_row_device(tidx, codes, "cpu")
    jrow = jms.query_ms_row_device(jidx, codes)
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(tms.ms_drops_device(trow, 20),
                                  jms.ms_drops_device(jrow, 20))
