"""The port's sequence-sharded map (kbo_tpu_torch.parallel.mesh.
map_seq_sharded) and api.map_batch's choice of it, on the CPU.

One 30 kbase contig and three contigs, fewer than the shards: held against
kbo_tpu's map_seq_sharded on its 8-device CPU mesh (8 CPU shards in the
port), and through api.map_batch(mesh=) against kbo_tpu's single-device
map_batch, which kbo_tpu's tests pin to its mesh output
(tests/test_mesh_map.py). Exact equality throughout. Each kbo_tpu map
shape costs its compiles (10-16 s), so the file keeps three.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu.parallel import mesh as jmesh
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch.parallel import mesh as tmesh
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
K = 51


@pytest.fixture(scope="module")
def built():
    """kbo_tpu's test_mesh_map pair: SNPs every 900 bases and a 2-base
    deletion in the indexed side; both packages' indexes and MapOpts()."""
    rng = np.random.default_rng(9)
    n = 30000
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    q = bytearray(ref)
    for pos in range(700, n - 700, 900):
        q[pos] = BASES[(np.searchsorted(BASES, q[pos]) + 1) % 4]
    del q[n // 2 : n // 2 + 2]
    t_bo = kbo_tpu_torch.BuildOpts(k=K, build_select=True)
    j_bo = kbo_tpu.BuildOpts(k=K, build_select=True)
    return (ref, kbo_tpu_torch.build([bytes(q)], t_bo),
            kbo_tpu.build([bytes(q)], j_bo),
            kbo_tpu_torch.MapOpts(sbwt_build_opts=t_bo),
            kbo_tpu.MapOpts(sbwt_build_opts=j_bo))


def _routed(refs, t_idx, opts, mesh):
    """api.map_batch over the mesh, with the route its stats name."""
    reset_stats()
    out = tapi.map_batch(refs, t_idx, opts, mesh=mesh)
    st = get_stats().as_dict()
    return out, [key for key in st if key.startswith("mesh_")], st


def test_map_seq_sharded_one_contig(built):
    ref, t_idx, j_idx, t_mo, j_mo = built
    want = japi.map_batch([ref], j_idx, j_mo)
    want8 = jmesh.map_seq_sharded([ref], j_idx, j_mo, mesh=jmesh.make_mesh())
    assert want8 == want
    got8 = tmesh.map_seq_sharded([ref], t_idx, t_mo,
                                 mesh=tmesh.make_mesh(8, device="cpu"))
    assert got8 == want8
    # through the API at 3 shards: the sequence-sharded route, with the
    # single-device run's counters
    got3, route, st = _routed([ref], t_idx, t_mo,
                              tmesh.make_mesh(3, device="cpu"))
    assert route == ["mesh_route_seq"] and got3 == want
    reset_stats()
    tapi.map_batch([ref], t_idx, t_mo, device="cpu")
    single = get_stats().as_dict()
    for key in ("variants_called", "gaps_seen", "gaps_filled",
                "gap_bases_unfilled"):
        assert st[key] == single[key], key
    assert st["variants_called"] > 0
    # format=False: the port's single-device bytes (held against kbo_tpu in
    # tests/test_torch_map.py)
    t_mo.format = False
    try:
        got = tmesh.map_seq_sharded([ref], t_idx, t_mo,
                                    mesh=tmesh.make_mesh(3, device="cpu"))
        assert got == tapi.map_batch([ref], t_idx, t_mo, device="cpu")
    finally:
        t_mo.format = True


def test_map_seq_sharded_three_contigs(built):
    """Three contigs under eight shards: several tagged rows per chunk,
    padding in the last chunks."""
    ref, t_idx, j_idx, t_mo, j_mo = built
    refs = [ref[:9000], ref[9000:21000], ref[21000:]]
    want = japi.map_batch(refs, j_idx, j_mo)
    m8 = tmesh.make_mesh(8, device="cpu")
    assert tmesh.map_seq_sharded(refs, t_idx, t_mo, mesh=m8) == want
    got, route, _ = _routed(refs, t_idx, t_mo, m8)
    assert route == ["mesh_route_seq"] and got == want


def test_map_seq_sharded_rules(built):
    ref, t_idx, _, t_mo, _ = built
    rc = kbo_tpu_torch.MapOpts(sbwt_build_opts=kbo_tpu_torch.BuildOpts(
        k=K, build_select=True, add_revcomp=True))
    with pytest.raises(ValueError, match="forward strand"):
        tmesh.map_seq_sharded([ref], t_idx, rc,
                              mesh=tmesh.make_mesh(3, device="cpu"))
    # two processes without their process group
    two = tmesh.Mesh([torch.device("cpu")] * 4, process_count=2)
    with pytest.raises(RuntimeError, match="initialize_from_env"):
        tmesh.map_seq_sharded([ref], t_idx, t_mo, mesh=two)
    with pytest.raises(ValueError, match="no device"):
        tapi.map_batch([ref], t_idx, t_mo, device="cpu",
                       mesh=tmesh.make_mesh(3, device="cpu"))
    assert tmesh.map_seq_sharded([], t_idx, t_mo,
                                 mesh=tmesh.make_mesh(3, device="cpu")) == []
