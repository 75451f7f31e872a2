"""The port's contig-sharded map (kbo_tpu_torch.parallel.mesh.
map_devref_data_sharded), its degrade to the classic mesh sweep, and the
classic mesh route at k >= 128, with api.map_batch's choice of each, on the
CPU.

kbo_tpu's contig-sharded case (tests/test_mesh_map.py: 8 contigs of 5 kbase
at k = 31) is held against kbo_tpu's map_devref_data_sharded on its 8-device
CPU mesh (8 CPU shards in the port); the API cases at 3 shards against
kbo_tpu's single-device map_batch, which kbo_tpu's tests pin to its mesh
output. Exact equality throughout; three kbo_tpu map shapes.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu.parallel import mesh as jmesh
from kbo_tpu.refine import device_map as jdm
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.parallel import mesh as tmesh
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _genome_and_query(n=40_000):
    rng = np.random.default_rng(77)
    genome = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(genome)
    for p in range(400, n - 400, 1100):
        query[p] = BASES[rng.integers(0, 4)]
    del query[20_000:20_003]
    return genome, bytes(query)


def _both(query, k):
    t_bo = kbo_tpu_torch.BuildOpts(k=k, build_select=True)
    j_bo = kbo_tpu.BuildOpts(k=k, build_select=True)
    return (kbo_tpu_torch.build([query], t_bo), kbo_tpu.build([query], j_bo),
            kbo_tpu_torch.MapOpts(sbwt_build_opts=t_bo),
            kbo_tpu.MapOpts(sbwt_build_opts=j_bo))


@pytest.fixture(scope="module")
def case31():
    genome, query = _genome_and_query()
    refs = [genome[i * 5000 : (i + 1) * 5000] for i in range(8)]
    return (refs,) + _both(query, 31)


def _routed(refs, t_idx, opts, mesh):
    reset_stats()
    out = tapi.map_batch(refs, t_idx, opts, mesh=mesh)
    return out, sorted(k for k in get_stats().as_dict() if k.startswith("mesh_"))


def test_map_devref_data_sharded(case31):
    refs, t_idx, j_idx, t_mo, j_mo = case31
    want = japi.map_batch(list(refs), j_idx, j_mo)
    thr = random_match_threshold(31, t_idx.n_kmers, 4, t_mo.max_error_prob)
    codes = [encode_ascii(r) for r in refs]
    want8 = jdm.map_devref_data_sharded(list(refs), j_idx, codes, j_mo, thr,
                                        jmesh.make_mesh())
    assert want8 == want
    reset_stats()
    got8 = tmesh.map_devref_data_sharded(refs, t_idx, codes, t_mo, thr,
                                       tmesh.make_mesh(8, device="cpu"))
    assert got8 == want8
    assert get_stats().as_dict()["gaps_filled"] > 0
    got3, route = _routed(refs, t_idx, t_mo, tmesh.make_mesh(3, device="cpu"))
    assert route == ["mesh_route_data"] and got3 == want


def test_data_sharded_degrades_to_the_classic_sweep(case31):
    """100 unrelated bases inside one contig: a gap wider than k goes to
    the host evaluator, so the contig-sharded map returns None and
    map_batch takes the classic mesh sweep, with the same bytes."""
    refs, t_idx, j_idx, t_mo, j_mo = case31
    r2 = bytearray(refs[2])
    r2[2500:2500] = BASES[np.random.default_rng(5).integers(0, 4, 100)]\
        .tobytes()
    refs = list(refs)
    refs[2] = bytes(r2[:5000])
    thr = random_match_threshold(31, t_idx.n_kmers, 4, t_mo.max_error_prob)
    m3 = tmesh.make_mesh(3, device="cpu")
    assert tmesh.map_devref_data_sharded(
        refs, t_idx, [encode_ascii(r) for r in refs], t_mo, thr, m3) is None
    got, route = _routed(refs, t_idx, t_mo, m3)
    assert route == ["mesh_data_degraded", "mesh_route_classic"]
    assert got == japi.map_batch(refs, j_idx, j_mo)


def test_classic_mesh_route_at_k151():
    genome, query = _genome_and_query(6_000)
    t_idx, j_idx, t_mo, j_mo = _both(query, 151)
    refs = [genome[:1500], genome[1500:3500], genome[3500:]]
    want = japi.map_batch(refs, j_idx, j_mo)
    got, route = _routed(refs, t_idx, t_mo, tmesh.make_mesh(3, device="cpu"))
    assert route == ["mesh_route_classic"] and got == want
    assert got != [bytes(r) for r in refs]  # the refinement changed bases
