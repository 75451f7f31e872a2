"""The generator: the same seed gives the same bytes, another seed the same
sizes with other bases; reads as their traffic states them."""

import hashlib

import numpy as np
import pytest

from kbo_bench import generate
from kbo_bench.tests.bench_fixtures import SCREEN_CELL, TINY_CFG, tiny_traffic

T = tiny_traffic("ecoli_mg1655.find_panel")


def test_same_seed_same_data():
    a = generate.make(TINY_CFG, T, 2**31 + 11)
    b = generate.make(TINY_CFG, T, 2**31 + 11)
    assert a == b


def test_other_seed_same_sizes_other_bases():
    a = generate.make(TINY_CFG, T, 5)
    b = generate.make(TINY_CFG, T, 2**40 + 3)
    assert a["reference"] != b["reference"]
    assert [len(r) for r in a["reference"]] == [len(r) for r in b["reference"]]
    assert sorted(map(len, a["panel"])) == sorted(map(len, b["panel"]))
    for pa, pb in zip(a["pool"], b["pool"]):
        la, lb = sum(map(len, pa)), sum(map(len, pb))
        assert abs(la - lb) <= 0.05 * la


def test_assembly_carries_the_planted_changes():
    d = generate.make(TINY_CFG, T, 17)
    ref = d["reference"][0]
    asm = d["pool"][0]
    # every draft contig but the plasmid's comes from the chromosome's strand
    assert all(len(c) >= 500 for c in asm)
    kmers = {ref[i:i + 31] for i in range(len(ref) - 30)}
    shared = np.mean([c[i:i + 31] in kmers for c in asm
                      for i in range(0, len(c) - 30, 97)])
    assert 0.3 < shared < 0.99


# digests of the data of each existing traffic at the tiny shape, taken
# before the generator could make reads: adding them changed none
DIGESTS = {
    "ecoli_mg1655.map_close": "239694dc4ca025153452bf6b4d0ca9951114567e",
    "ecoli_mg1655.find_panel": "e183d3647d4e9e7cd5d186b48dc1388e8efc494a",
    "kpneumo_hs11286.call_close": "239694dc4ca025153452bf6b4d0ca9951114567e",
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_existing_traffics_data_unchanged(name):
    d = generate.make(TINY_CFG, tiny_traffic(name), 2**31 + 33)
    assert "reads" not in d
    got = hashlib.sha1(repr(sorted(d.items())).encode()).hexdigest()
    assert got == DIGESTS[name]


S = tiny_traffic(SCREEN_CELL["name"])
SPEC = S["reads"]


def test_reads_same_seed_same_reads():
    a = generate.make(TINY_CFG, S, 2**31 + 41)
    b = generate.make(TINY_CFG, S, 2**31 + 41)
    assert a["reads"] == b["reads"]
    assert len(a["reads"]) == S["pool"]


def test_reads_other_seed_same_sizes_other_bases():
    a = generate.make(TINY_CFG, S, 5)["reads"]
    b = generate.make(TINY_CFG, S, 2**40 + 3)["reads"]
    assert a != b
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb) == SPEC["per_request"]
        assert {len(r) for r in ra} == {len(r) for r in rb} == {SPEC["length"]}


def _as_drawn(asm, read):
    """(strand, substitutions) of the draft's closest copy of a read."""
    best = None
    for strand, r in ((0, read), (1, generate.revcomp(
            np.frombuffer(read, dtype=np.uint8)).tobytes())):
        q = np.frombuffer(r, dtype=np.uint8)
        for c in asm:
            a = np.frombuffer(c, dtype=np.uint8)
            if a.size < q.size:
                continue
            win = np.lib.stride_tricks.sliding_window_view(a, q.size)
            d = int((win != q).sum(axis=1).min())
            if best is None or d < best[1]:
                best = (strand, d)
    return best


def test_reads_lie_in_their_draft_with_the_stated_counts():
    spec = dict(SPEC, per_request=40, subst=0.01)
    seed = 2**31 + 43
    d = generate.make(TINY_CFG, dict(S, reads=spec), seed)
    n, L = spec["per_request"], spec["length"]
    for member, (asm, batch) in enumerate(zip(d["pool"], d["reads"])):
        drawn = [_as_drawn(asm, r) for r in batch]
        # every read is a window of its own draft, up to its substitutions
        assert sum(s for _, s in drawn) == round(spec["subst"] * n * L)
        assert sum(st for st, _ in drawn) == round(spec["revcomp_share"] * n)
        # the substituted bases come from the seed, their places do not
        other = generate.reads(spec, asm, seed + 1, member)
        diff = [i for i, (x, y) in enumerate(zip(batch, other)) if x != y]
        assert diff and all(drawn[i][1] > 0 for i in diff)
