"""The generator: the same seed gives the same bytes, another seed the same
sizes with other bases."""

import numpy as np

from kbo_bench import generate
from kbo_bench.tests.bench_fixtures import TINY_CFG, tiny_traffic

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
