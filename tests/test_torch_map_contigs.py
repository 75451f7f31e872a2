"""More inputs of kbo_tpu's device-refinement tests
(tests/test_device_refine.py) through the port's map_batch with the default
MapOpts(), against kbo_tpu's, on the CPU: four contigs of varying length
(the tagged variant join), insertions in the indexed side, and a dense-SNP
contig (about 200 drops) whose first capacities the port is made to
undersize, so that its capacity retry runs with the refinement on.
"""

from dataclasses import replace

import numpy as np
import torch

from kbo_tpu_torch.refine import device_map
from kbo_tpu_torch.utils.stats import get_stats, reset_stats
from test_torch_map_devref import map_both

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def test_devref_multi_contig():
    rng = np.random.default_rng(5)
    genome = BASES[rng.integers(0, 4, 30_000)].tobytes()
    query = bytearray(genome)
    for p in range(400, len(query) - 400, 900):
        query[p] = BASES[rng.integers(0, 4)]
    refs = [genome[:9000], genome[9000:9600], genome[9600:21000],
            genome[21000:]]
    got, want = map_both(refs, bytes(query), 31)
    assert got == want and [len(g) for g in got] == [len(r) for r in refs]


def test_devref_insertion_variants():
    rng = np.random.default_rng(17)
    n = 14_000
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(2500, n - 2500, 3000):
        query[p:p] = BASES[rng.integers(0, 4, 2)].tobytes()
    got, want = map_both([ref], bytes(query), 31)
    assert got == want


def test_devref_overflow_retry(monkeypatch):
    rng = np.random.default_rng(29)
    n = 8192
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(200, n - 200, 40):
        query[p] = BASES[rng.integers(0, 4)]
    grown = []
    real_grown = device_map.Caps.grown
    real_start = device_map.start_caps

    def spy(caps, *needs):
        grown.append(needs[0])
        return real_grown(caps, *needs)

    monkeypatch.setattr(device_map.Caps, "grown", spy)
    # first capacities of 64 slots in the port (kbo_tpu keeps its 256)
    monkeypatch.setattr(device_map, "start_caps",
                        lambda L, q: replace(real_start(L, q), d=64, g=64))
    reset_stats()
    got, want = map_both([ref], bytes(query), 31)
    assert got == want
    assert len(grown) == 1 and grown[0] > 64
    assert get_stats().as_dict()["map_overflow_retries"] == 1
