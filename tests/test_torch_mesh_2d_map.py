"""The port's map over the 2-D ``("data", "model")`` mesh on the CPU:
map_batch_2d_sharded (contigs split over ``data``, the key table
prefix-sharded over ``model``) held against kbo_tpu's on a 2 x 4 JAX mesh
over the 8 CPU devices that tests/conftest.py gives JAX and against the
port's single-device map_batch, a low-identity input on which both return
None, the placement of one key-table copy per device, and the
refinement's two operations over the sharded table (refine.device_map.
KeyTable over a model group) against the single table's cores. Every
comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_torch_mesh_model_map import BASES, _indexes, _map_opts, _pair

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.parallel import mesh as jmesh
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch import engine as tengine
from kbo_tpu_torch.kernels import refine as tref
from kbo_tpu_torch.parallel import mesh as tmesh
from kbo_tpu_torch.refine.device_map import KeyTable
from kbo_tpu_torch.utils.stats import get_stats, reset_stats


@pytest.fixture(scope="module")
def case_2d():
    """kbo_tpu's tests/test_index_sharded_map.py:99 shape: a 36 kbase pair
    at k = 51 cut into five contigs (Q padded to 6 over 2 data rows)."""
    k = 51
    ref, query = _pair(36_000, seed=17)
    t_idx, j_idx = _indexes([query], k)
    cuts = (0, 9000, 14000, 23000, 28000, 36000)
    refs = [ref[a:b] for a, b in zip(cuts, cuts[1:])]
    jm = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    return k, refs, t_idx, j_idx, jm


def test_sharded_refinement_cores_equal_single_table(case_2d):
    """The gap scoring and variant resolution of a KeyTable over 3 shards
    (the index-sharded map's model group) on the candidates of three
    contigs at k = 51 equal the single table's score_gaps_core (with the
    chain table, and with the search loop; a 2-lane budget that flags gaps
    for the host too) and resolve_variants_core, output for output (the
    float64 acceptance included, as
    tests/test_torch_refine.py::test_score_gaps_equal)."""
    from kbo_tpu_torch.index.encode import encode_ascii
    from kbo_tpu_torch.kernels import mapsweep as tmap
    from kbo_tpu_torch.ops.derandomize import random_match_threshold
    from kbo_tpu_torch.pipeline import pad_batch

    k, refs, t_idx, _, _ = case_2d
    refs = refs[:3]
    t = random_match_threshold(k, t_idx.n_kmers, 4, 1e-7)
    codes, lengths = pad_batch([encode_ascii(r) for r in refs],
                               bucket=True)
    Q, L = codes.shape
    dev = tengine.device_index(t_idx, "cpu")
    codes_t, len_t = torch.from_numpy(codes), torch.from_numpy(lengths)
    ref_mat = torch.from_numpy(tmesh.ref_matrix(refs, Q, L))
    sweep = tmap.ms3_rows_sweep(dev.keys3, dev.rows_packed, codes_t, k)
    cap = 64
    _, _, p = tmap.map_postprocess3_core(*sweep, len_t, k, t, cap, cap,
                                         k - t + 1)
    sidx = tmesh.Sharded3Index(t_idx, tmesh.make_mesh(3, axis="model",
                                                      device="cpu"))
    table = KeyTable(sidx.group())
    gap_args = (ref_mat, len_t, p["gap_start"], p["gap_end_at"], p["grid"], t)
    bound = tref.prob_bound(1e-7)
    for cap_ext in (256, 2):
        got = table.score_gaps(*gap_args, k, cap, cap_ext, bound)
        for ext_tab in (tref.get_ext_table(dev), None):
            want = tref.score_gaps_core(dev.keys3, *gap_args, k, cap, cap_ext,
                                        ext_tab, bound)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[3][1] > 0 and (cap_ext == 256) != bool(got[2].any())
    seq_words = tref.seq_keys3_tagged_core(codes_t, k)
    var_args = (seq_words, codes_t, ref_mat, sweep[0], len_t, p["drop_pos"],
                p["apos"], p["arow"], t, k, cap)
    got = table.resolve_variants(*var_args[1:], t - 1)
    want = tref.resolve_variants_core(dev.keys3, *var_args, d_lo=t - 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[2]) > 0


def test_2d_placement_one_copy_per_device(case_2d):
    """On one device a 2 x 4 mesh holds four key shards, not eight: both
    data rows read the same tensors (and one ShardedKeys3 with its bucket
    tables), shard j equal to the one-axis mesh's shard j."""
    _, _, t_idx, _, _ = case_2d
    sidx = tmesh.Sharded3Index(t_idx, tmesh.make_mesh(
        (2, 4), axis=("data", "model"), device="cpu"))
    one = tmesh.Sharded3Index(t_idx, tmesh.make_mesh(4, axis="model",
                                                     device="cpu"))
    assert sidx.group(0) is sidx.group(1) and len(sidx.group().shards) == 4
    assert len({id(t) for i in (0, 1) for p in sidx.tables(i) for t in p}) \
        == 12
    for j in range(4):
        assert sidx.tables(0)[j] is sidx.tables(1)[j]
        for got, want in zip(sidx.tables(1)[j], one.tables()[j]):
            assert torch.equal(got, want)


def test_2d_map_equals_kbo_tpu(case_2d):
    k, refs, t_idx, j_idx, jm = case_2d
    want = jmesh.map_batch_2d_sharded(refs, j_idx, _map_opts(kbo_tpu, k),
                                      mesh=jm)
    t_mo = _map_opts(kbo_tpu_torch, k)
    mesh = tmesh.make_mesh((2, 4), axis=("data", "model"), device="cpu")
    reset_stats()
    got = tmesh.map_batch_2d_sharded(refs, t_idx, t_mo, mesh)
    assert get_stats().as_dict()["variants_called"] > 0
    assert want is not None and got == want
    assert got == tapi.map_batch(refs, t_idx, t_mo, device="cpu")


@pytest.mark.parametrize("grid", [(2, 2), (3, 1), (1, 3)])
def test_2d_map_equals_single_device(case_2d, grid):
    k, refs, t_idx, _, _ = case_2d
    t_mo = _map_opts(kbo_tpu_torch, k)
    mesh = tmesh.make_mesh(grid, axis=("data", "model"), device="cpu")
    assert tmesh.map_batch_2d_sharded(refs, t_idx, t_mo, mesh) == \
        tapi.map_batch(refs, t_idx, t_mo, device="cpu")


def test_2d_map_returns_none_with_a_host_gap(case_2d):
    """Contigs of the same lengths with an unrelated stretch wider than k
    in each: the gap needs the host evaluator, and both packages return
    None; without gap filling both map it, equal to the single-device
    map."""
    k, refs, t_idx, j_idx, jm = case_2d
    rng = np.random.default_rng(5)
    low = []
    for r in refs:
        r = bytearray(r)
        r[1000:1100] = BASES[rng.integers(0, 4, 100)].tobytes()
        low.append(bytes(r))
    mesh = tmesh.make_mesh((2, 4), axis=("data", "model"), device="cpu")
    assert jmesh.map_batch_2d_sharded(low, j_idx, _map_opts(kbo_tpu, k),
                                      mesh=jm) is None
    reset_stats()
    assert tmesh.map_batch_2d_sharded(low, t_idx, _map_opts(kbo_tpu_torch, k),
                                      mesh) is None
    assert get_stats().as_dict()["gaps_to_host"] > 0
    no_gaps = kbo_tpu_torch.MapOpts(fill_gaps=False, sbwt_build_opts=(
        kbo_tpu_torch.BuildOpts(k=k, build_select=True)))
    assert tmesh.map_batch_2d_sharded(low, t_idx, no_gaps, mesh) == \
        tapi.map_batch(low, t_idx, no_gaps, device="cpu")
