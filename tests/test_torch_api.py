"""The port's public API (build / matches / find / find_batch) against
kbo_tpu's, on the CPU: the reference doctests and kbo_tpu's own device
batch paths."""

import dataclasses

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu_torch import FindOpts, MatchOpts

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rows(rles):
    return [dataclasses.asdict(r) for r in rles]


def test_exports():
    assert set(kbo_tpu_torch.__all__) == {
        "BuildOpts", "FindOpts", "MatchOpts", "RLE", "build", "find",
        "find_batch", "matches",
    }


def test_matches_doctest():
    # reference: src/lib.rs:594-610
    seqs, query = [b"AAAGAACCA-TCAGGGCG"], b"GTGACTATGAGGAT"
    sbwt = kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=3))
    got = kbo_tpu_torch.matches(query, sbwt, MatchOpts(), device="cpu")
    assert got == list("---------MMM--")
    jidx = kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=3))
    assert got == kbo_tpu.matches(query, jidx, kbo_tpu.MatchOpts())


GENE1 = (
    b"ATGGCTGTTCCATCATCAAAAGAAGAGTTAATTAAAGCTATTAATAGTAATTTTTCTTTATTAAATAAGA"
    b"AGCTAGAATCTATTACGCCCCAACTCGCCTTTGAACCTCTATTGGAAGGGCACGCGAAGGGGACTACGAT"
    b"TAGCGTAGCGAATCTGGTTTCCTATCTGATTGGCTGGGGAGAGCTGGTGTTACACTGGCATGACCAAGAG"
    b"GCAAAAGGAAAAACTATTATTTTTCCTGAGGAAGGATTTAAATGGAATGAATTGGGGCGTTTAGCACAGA"
    b"AATTCTACCGTGACTATGAGGATATTACAGAGTACGAAGTTTTATTGGCACGGTTAAAGGAAAATAAGCA"
    b"GCAACTCGTGGCTTTGATTGAACGATTCAGTAACGACGAGCTTTACGGTAAACCTTGGTATAATAAATGG"
    b"ACCCGAGGTCGTATGATTCAATTTAATACCGCCTCGCCTTATAAAAATGCTTCGGGGAGGTTAAATAAAC"
    b"TGCAGAAATGTCTTGCAGAATAG"
)
GENE2_RC = (
    b"CTACCCTACTATTTCGAGTGATTCAATCGTCTGGTTCACATAACCTACCACCTGTTCAAAATGCTTATCG"
    b"ACAAAAAAATGATCGGCAGCAGGAAATATAATAGTCCGCGTCTTTCGTGTGGTGAATTTTTCCCATGCAA"
    b"GTAATTCATCCTGCATTACCAGATTGTCAGCATCGCCATGAAATAGCACGATCGGACAGGTTAATGTGCG"
    b"CGCCTTGGCCTGAAATACATACTGCTCATAGAGCCGATAATCGTTTTTAATGATGGGGGTGAAAATTGTC"
    b"ATTAACTCTTTATTACGAAAGACATCAACCGGAGTTCCGCCCAGCTTGACGATCTCTTCCATAAACGCCT"
    b"GATCGGGCAAGGTATGCAGTATTACTTCATGAGAGGCCCGATCGGGTGGGCGACAGCCGGAAAAAAACAG"
    b"CGCGCATGGCATGTCATGTCCATGATCGAGAATATAATGCACCAGTTCGAAGGCCATGATCCCTCCGAGA"
    b"CTATGCCCAAAAATGGCGTAGTCTCCACCTGTGTAGTGTTTCACAAATTGTTGATAAAGGTCAGCGACGG"
    b"CATCCACCATCGTAAGACACAGCGGCTGGCGTATTCTAGTTCCCCTCCCCGCAGGTTCTAAAGGCCGCAA"
    b"AGTAATATTGTCCGACAGCACGCTACGCCATTTATAATACATGGCGGCAGAACCACCTGAATATGGCAAA"
    b"CAATACAAACTGATATTACTCAT"
)
QUERY = (
    b"ATGGCTGTTCCATCATCAAAAGAAGAGTTAATTAAAGCTATTAATAGTAATTTTTCTTTATTAAATAAGA"
    b"AGCTAGACTCTATTACGCCCCAACTCGCCTTTGAACCTCTATTGGAAGGGCACGCGAAGGGGACTACGAT"
    b"TAGCGTAGCGAATCTGGTTTCCTATCTGATTGGCTGGGGAGAGCTGGTGTTACACTGGCATGACCAAGAG"
    b"GCAAAAGGAAAAACTATTATTTTTCCTGAGGAAGGATTTAAATGGAATGAATTGGGGCGTTTAGCACAGA"
    b"AATTCTACCGTGACTATGAGGATATTACAGAGTACGAAGTTTTATTGGCACGGTTAAAGGAAAATAAGCA"
    b"GCAACTCGTGGCTTTGATTGAACGATTCAGTAACGACGAGCTTTACGGTAAACCTTGGTATAATAAATGG"
    b"ACCCGAGGTCGTATGATTCAATTTAATACCGCCTCGCCTTATAAAAATGCTTCGGGGAGGTTAAATAAAC"
    b"TGCAGAAATGTCTTGCAGAATAGAAAAAAAAAAAAAAAAAAAAAAAAAAAAAGGGGGGGGGGGGGGGGGG"
    b"GGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGG"
    b"CTACCCTACTATTTCGAGTGATTCAATCGTCTGGTTCACATAACCTACCACCTGTTCAAAATGCTTATCG"
    b"ACAAAAAAATGATCGGCAGCAGGAAATATAATAGTCCGCGTCTTTCGTGTGGTGAATTTTTCCCATGCAA"
    b"GTAATTCATCCTGCATTACCAGATTGTCAGCATCGCCATGAAATAGCACGATCGGACAGGTTAATGTGCG"
    b"CGCCTTGGCCTGAAATACATACTGCTCATAGAGCCGATAATCGTGTGTAATGATGGGGGTGAAAATTGTC"
    b"ATTAACTCTTTATTACGAAAGACATCAACCGGAGTTCCGCCCAGCTTGACGATCTCTTCCATAAACGCCT"
    b"GATCGGGCAAGGTATGCATTTTTTTTTTTTTTTTTTTTTTTTTT"
    b"GTATTACTTCATGAGAGGCCCGATCGGGTGGGCGACAGCCGGAAAAAAACAGCGCGCATGGCATGTCATG"
    b"TCCATGATCGAGAATATAATGCACCAGTTCGAAGGCCATGATCCCTCCGAGACTATGCCCAAAAATGGCG"
    b"TAGTCTCCACCTGTGTAGTGTTTCACAAATTGTTGATAAAGGTCAGCGACGGCATCCACCATCGTAAGAC"
    b"ACAGCGGCTGGCGTATTCTAGTTCCCCTCCCCGCAGGTTCTAAAGGCCGCAAAATAATATTGCGACAGCA"
    b"CGCTACGCCATTTATAATACATGGCGGCAGAACCACCTGAATATGGCAAACAATACAAACTGATATTACT"
    b"CAT"
)
FIND_DOCTEST = [
    dict(start=0, end=513, matches=512, mismatches=1, jumps=0, gap_bases=0,
         gap_opens=0),
    dict(start=593, end=1340, matches=709, mismatches=0, jumps=0,
         gap_bases=38, gap_opens=3),
]


def test_find_doctest():
    # reference: src/lib.rs:779-806 (2 genes + recombinant query, k=31)
    sbwt = kbo_tpu_torch.build([GENE1, GENE2_RC], kbo_tpu_torch.BuildOpts(k=31))
    got = kbo_tpu_torch.find(QUERY, sbwt, FindOpts(max_gap_len=50), device="cpu")
    assert _rows(got) == FIND_DOCTEST
    jidx = kbo_tpu.build([GENE1, GENE2_RC], kbo_tpu.BuildOpts(k=31))
    want = kbo_tpu.find(QUERY, jidx, kbo_tpu.FindOpts(max_gap_len=50))
    assert _rows(got) == _rows(want)


def _find_case(seed):
    """The generator of tests/test_fuzz_differential.py::
    test_find_device_rle_vs_host."""
    rng = np.random.default_rng([seed, 313])
    n = int(rng.integers(1200, 5000))
    genome = BASES[rng.integers(0, 4, n)].tobytes()
    k = int(rng.choice([15, 31, 51]))
    queries = []
    for _ in range(5):
        ln = int(rng.integers(200, 1100))
        s = int(rng.integers(0, n - ln))
        q = bytearray(genome[s : s + ln])
        for p in np.nonzero(rng.random(ln) < 0.02)[0]:
            q[p] = BASES[rng.integers(0, 4)]
        queries.append(bytes(q))
    return genome, k, queries


@pytest.mark.parametrize("seed,gap", [(0, 0), (1, 0), (2, 20)])
def test_find_batch_vs_kbo_tpu(seed, gap):
    """find_batch (device RLE at gap 0, host gapped RLE above) against
    kbo_tpu's find_batch on its own device batch path."""
    genome, k, queries = _find_case(seed)
    tidx = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build([genome], kbo_tpu.BuildOpts(k=k))
    from kbo_tpu.api import find_batch as jax_find_batch

    got = kbo_tpu_torch.find_batch(
        queries, tidx, FindOpts(max_gap_len=gap), device="cpu"
    )
    want = jax_find_batch(queries, jidx, kbo_tpu.FindOpts(max_gap_len=gap))
    assert [_rows(g) for g in got] == [_rows(w) for w in want]
    singles = [
        kbo_tpu_torch.find(q, tidx, FindOpts(max_gap_len=gap), device="cpu")
        for q in queries
    ]
    assert [_rows(s) for s in singles] == [_rows(w) for w in want]


def test_find_batch_guards():
    idx = kbo_tpu_torch.build([b"ACGTACGTAGGATTACA"], kbo_tpu_torch.BuildOpts(k=5))
    assert kbo_tpu_torch.find_batch([], idx, device="cpu") == []
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kbo_tpu_torch.find_batch([b"ACGT"], idx, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kbo_tpu_torch.find_batch([b"ACGT"], object(), device="cpu")
