"""The port's map over a prefix-sharded key table on the CPU: the search loop
(kernels.refine's bucket table, lower bound, membership probes and left
extension), their forms over a ShardedKeys3, map_batch_index_sharded over a
one-axis ``model`` mesh (the 2-D mesh's map:
tests/test_torch_mesh_2d_map.py).

The single-table search loop is held against kbo_tpu's functions and the
port's chain-table extension; the sharded forms against kbo_tpu's
``axis="model"`` forms under ``jax.shard_map`` over the 8 CPU devices that
tests/conftest.py gives JAX (8 shards in the port), the four prepend-variants
of a suffix straddling a shard boundary included, and against the port's
single table at 3 and 4 shards (widths that do not divide). The map is
held against kbo_tpu's function of the same name and the port's
single-device map_batch. Every comparison is exact.
"""

import bisect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.kernels import refine as jref
from kbo_tpu.parallel import mesh as jmesh
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch import engine as tengine
from kbo_tpu_torch.kernels import refine as tref
from kbo_tpu_torch.parallel import mesh as tmesh
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pair(n, seed=3, every=900):
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(500, n - 500, every):
        query[p] = BASES[rng.integers(0, 4)]
    del query[n // 2 : n // 2 + 3]
    return ref, bytes(query)


def _indexes(seqs, k):
    return (kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(
                k=k, build_select=True)),
            kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=k, build_select=True)))


def _map_opts(pkg, k):
    return pkg.MapOpts(sbwt_build_opts=pkg.BuildOpts(k=k, build_select=True))


def _words(pw):
    """int32 [W, N] probe words -> kbo_tpu's list of uint32 arrays."""
    return [jnp.asarray(w) for w in pw.numpy().view(np.uint32)]


def _shard_map(fn, n_args):
    """fn(keys3 shard, *replicated args) under shard_map over kbo_tpu's
    8-device ``model`` mesh, jitted; outputs replicated."""
    mesh = jmesh.make_mesh(8, axis="model")
    return mesh, jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, "model"),) + (P(),) * n_args,
        out_specs=P(), check_vma=False,
    ))


def _sharded_jax_keys(keys3, m, mesh):
    """The uint32 key table padded with all-ones columns to 8 * m and
    placed over kbo_tpu's mesh, shard i = columns [i*m, (i+1)*m)."""
    W, n = keys3.shape
    padded = np.full((W, 8 * m), 0xFFFFFFFF, np.uint32)
    padded[:, :n] = keys3
    return jmesh.put_global(mesh, P(None, "model"), padded)


def _sharded_keys(keys3, m):
    """The port's int32 key table cut into shards of m columns."""
    W, n = keys3.shape
    ns = -(-n // m)
    full = torch.full((W, ns * m), -1, dtype=torch.int32)
    full[:, :n] = keys3
    return tref.ShardedKeys3([full[:, i * m : (i + 1) * m].clone()
                              for i in range(ns)], m)


@pytest.fixture(scope="module")
def table_case():
    """A k = 31 index over a 3 kbase sequence with SNPs, both packages'
    key tables, 200 rows with their k-mers (a few rows -1), probes (the
    k-mers' words, a quarter of them changed so they are absent) and
    extension budgets from 0 to k."""
    k = 31
    rng = np.random.default_rng(3)
    ref = BASES[rng.integers(0, 4, 3000)].tobytes()
    q = bytearray(ref)
    for p in range(100, 2900, 300):
        q[p] = BASES[rng.integers(0, 4)]
    t_idx, j_idx = _indexes([bytes(q)], k)
    keys3 = tengine.device_index(t_idx, "cpu").keys3
    j_keys3 = np.ascontiguousarray(j_idx.keys3, np.uint32)
    rows = rng.integers(0, t_idx.n_rows, 200).astype(np.int32)
    rows[:4] = -1
    kmers = tref.unpack_rows3(keys3, torch.from_numpy(rows), k)
    probes = tref._pack_codes_matrix(kmers, k)
    probes[0, ::4] ^= 1 << 3
    budgets = np.concatenate([np.zeros(8), np.full(8, k),
                              rng.integers(0, k + 1, 184)]).astype(np.int32)
    return k, t_idx, keys3, j_keys3, rows, kmers, probes, budgets


# ------------------------------------------------- the single-table loop


def test_bucket_table_and_packing_equal_kbo_tpu(table_case):
    k, _, keys3, j_keys3, _, kmers, probes, _ = table_case
    tbl = tref.bucket_table(keys3)
    assert tbl.dtype == torch.int32 and tbl.shape == (1 << 21,)
    np.testing.assert_array_equal(
        tbl.numpy(), np.asarray(jref.bucket_table(jnp.asarray(j_keys3))))
    want = jref._pack_codes_matrix(jnp.asarray(kmers.numpy()), k)
    got = tref._pack_codes_matrix(kmers, k)
    assert got.dtype == torch.int32 and got.shape == (len(want), 200)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.stack([np.asarray(w) for w in want]))


@pytest.mark.parametrize("bucketed", [False, True])
def test_search_loop_equals_kbo_tpu(table_case, bucketed):
    """The lower bound, membership and the left extension (exts and
    lengths in full), with and without the bucket table; the rounds and
    lanes reach the run's stats."""
    k, _, keys3, j_keys3, _, kmers, probes, budgets = table_case
    jk = jnp.asarray(j_keys3)
    tbl = tref.bucket_table(keys3) if bucketed else None
    jtbl = jref.bucket_table(jk) if bucketed else None
    np.testing.assert_array_equal(
        tref._lower_bound_device(keys3, probes, tbl).numpy(),
        np.asarray(jref._lower_bound_device(jk, _words(probes), jtbl)))
    member = tref._member_rows_device(keys3, probes, tbl).numpy()
    np.testing.assert_array_equal(
        member, np.asarray(jref._member_rows_device(jk, _words(probes),
                                                    tbl=jtbl)))
    assert 0 < member.sum() < member.size
    np.testing.assert_array_equal(
        tref._extend_members_device(keys3, kmers[:, : k - 1], k, tbl).numpy(),
        np.asarray(jref._extend_members_device(
            jk, jnp.asarray(kmers[:, : k - 1].numpy()), k, tbl=jtbl)))
    reset_stats()
    exts, ext_len = tref.left_extend_device(keys3, kmers,
                                            torch.from_numpy(budgets), k, tbl)
    stats = get_stats().as_dict()
    j_exts, j_len = jref.left_extend_device(
        jk, jnp.asarray(kmers.numpy()), jnp.asarray(budgets), k, tbl=jtbl)
    np.testing.assert_array_equal(exts.numpy(), np.asarray(j_exts))
    np.testing.assert_array_equal(ext_len.numpy(), np.asarray(j_len))
    assert exts.dtype == torch.uint8 and exts.shape == (200, 2 * k)
    assert (ext_len.numpy() > k).sum() > 50
    assert stats["left_ext_lanes"] == int((budgets > 0).sum())
    assert 1 < stats["left_ext_rounds"] <= k


def test_left_extension_equals_chain_table(table_case):
    """The search loop gives the chain table's extension (kbo_tpu's
    tests/test_device_refine.py:355 holds its two the same way)."""
    k, t_idx, keys3, _, rows, kmers, _, budgets = table_case
    ew, el = tref.get_ext_table(tengine.device_index(t_idx, "cpu"))
    exts, ext_len = tref.left_extend_device(
        keys3, kmers, torch.from_numpy(budgets), k, tref.bucket_table(keys3))
    t_exts, t_len = tref.ext_from_table(ew, el, torch.from_numpy(rows), kmers,
                                        torch.from_numpy(budgets), k)
    assert torch.equal(ext_len, t_len)
    for i, n_ext in enumerate(ext_len.tolist()):
        assert torch.equal(exts[i, :n_ext], t_exts[i, :n_ext]), i


@pytest.mark.parametrize("n", [1, 2, 9, 64, 5003])
def test_lower_bound_is_unsigned_bisect(n):
    """Against bisect over uint32 pairs, with and without the bucket table,
    all-ones pad rows at the end, and probes with the top bit set (int32
    negative) that an unsigned compare sorts after every real key."""
    rng = np.random.default_rng(n)
    w0 = np.sort(rng.integers(0, 2**30, n).astype(np.uint32))
    w1 = rng.integers(0, 2**30, n).astype(np.uint32)
    w1 = w1[np.lexsort((w1, w0))]
    keys = np.stack([w0, w1])
    keys = np.concatenate([keys, np.full((2, 3), 0xFFFFFFFF, np.uint32)], 1)
    pi = rng.integers(0, n, 64)
    probes = np.concatenate([
        keys[:, pi], rng.integers(0, 2**30, (2, 64)).astype(np.uint32),
        np.zeros((2, 2), np.uint32), np.full((2, 2), 2**31, np.uint32),
    ], axis=1)
    t_keys = torch.from_numpy(keys.view(np.int32))
    t_probes = torch.from_numpy(probes.view(np.int32))
    table = list(zip(*keys.tolist()))
    want = [bisect.bisect_left(table, p) for p in zip(*probes.tolist())]
    for tbl in (None, tref.bucket_table(t_keys)):
        got = tref._lower_bound_device(t_keys, t_probes, tbl)
        assert got.tolist() == want


# ------------------------------------------------------ the sharded forms


def test_sharded_forms_equal_kbo_tpu_8_shards(table_case):
    """unpack_rows3 (rows < 0 all zeros, as kbo_tpu's axis form gives),
    membership and the left extension over the port's 8-shard table, held
    against kbo_tpu's axis="model" forms under shard_map."""
    k, t_idx, keys3, j_keys3, rows, kmers, probes, budgets = table_case
    sk = tmesh.Sharded3Index(
        t_idx, tmesh.make_mesh(8, axis="model", device="cpu")).group()
    assert len(sk.shards) == 8 and sk.m * 8 >= t_idx.n_rows

    def fn(k3, r, pw, km, bud):
        return (jref.unpack_rows3(k3, r, k, axis="model"),
                jref._member_rows_device(k3, list(pw), axis="model",
                                         tbl=jref.bucket_table(k3)),
                *jref.left_extend_device(k3, km, bud, k, axis="model",
                                         tbl=jref.bucket_table(k3)))

    mesh, run = _shard_map(fn, 4)
    want = run(_sharded_jax_keys(j_keys3, sk.m, mesh), jnp.asarray(rows),
               jnp.asarray(probes.numpy().view(np.uint32)),
               jnp.asarray(kmers.numpy()), jnp.asarray(budgets))
    got = (tref.unpack_rows3(sk, torch.from_numpy(rows), k),
           tref._member_rows_device(sk, probes),
           *tref.left_extend_device(sk, kmers, torch.from_numpy(budgets), k))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[0][:4].any() and torch.equal(got[0][4:], kmers[4:])


@pytest.mark.parametrize("n_shards", [3, 4])
def test_sharded_forms_equal_single_table(table_case, n_shards):
    """At widths that do not divide the table: membership and the left
    extension equal the single table's; the unpack equals it at rows >= 0
    and is zero below."""
    k, t_idx, keys3, _, rows, kmers, probes, budgets = table_case
    assert t_idx.n_rows % n_shards
    sk = tmesh.Sharded3Index(t_idx, tmesh.make_mesh(
        n_shards, axis="model", device="cpu")).group()
    got = tref.unpack_rows3(sk, torch.from_numpy(rows), k)
    assert torch.equal(got[4:], kmers[4:]) and not got[:4].any()
    assert torch.equal(tref._member_rows_device(sk, probes),
                       tref._member_rows_device(keys3, probes))
    bud = torch.from_numpy(budgets)
    for g, w in zip(tref.left_extend_device(sk, kmers, bud, k),
                    tref.left_extend_device(keys3, kmers, bud, k)):
        assert torch.equal(g, w)


def test_extension_across_a_shard_boundary():
    """The prepend-variants of a (k-1)-suffix are consecutive rows: with
    the shard width set so that two of them straddle a boundary (the
    last row of shard 0 and the first of shard 1), each shard's own lower
    bound finds its half and the OR counts both, so such a lane does not
    extend. Held against kbo_tpu's axis form at that width and against the
    single table, for lanes around the boundary."""
    k = 5
    rng = np.random.default_rng(7)
    seq = BASES[rng.integers(0, 4, 400)].tobytes()
    t_idx, j_idx = _indexes([seq], k)
    keys3 = tengine.device_index(t_idx, "cpu").keys3
    n = keys3.shape[1]
    suffix = tref.unpack_rows3(keys3, torch.arange(n, dtype=torch.int32),
                               k)[:, 1:]
    # rows r, r + 1 with one (k-1)-suffix, past an eighth of the table
    r = next(r for r in range(-(-n // 8), n - 1)
             if torch.equal(suffix[r], suffix[r + 1]))
    m = r + 1
    lanes = torch.arange(r - 3, r + 5, dtype=torch.int32)
    kmers = torch.cat([suffix[lanes.long()],
                       torch.ones((8, 1), dtype=torch.uint8)], dim=1)
    budgets = np.full(8, k, np.int32)
    sk = _sharded_keys(keys3, m)
    assert sk.shards[0].shape[1] == m and len(sk.shards) >= 2
    got = tref.left_extend_device(sk, kmers, torch.from_numpy(budgets), k)
    member = tref._extend_members_device(sk, kmers[:, : k - 1], k)
    assert member[:, 3].sum() >= 2  # lane 3's suffix straddles
    assert got[1][3] == k

    def fn(k3, km, bud):
        return (jref._extend_members_device(
                    k3, km[:, : k - 1], k, axis="model",
                    tbl=jref.bucket_table(k3)),
                *jref.left_extend_device(k3, km, bud, k, axis="model",
                                         tbl=jref.bucket_table(k3)))

    mesh, run = _shard_map(fn, 2)
    want = run(_sharded_jax_keys(np.ascontiguousarray(j_idx.keys3, np.uint32),
                                 m, mesh),
               jnp.asarray(kmers.numpy()), jnp.asarray(budgets))
    for g, w in zip((member, *got), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    single = tref.left_extend_device(keys3, kmers, torch.from_numpy(budgets),
                                     k)
    assert all(torch.equal(g, s) for g, s in zip(got, single))


# ---------------------------------------------------------------- the maps


@pytest.fixture(scope="module")
def map_case():
    """A 12 kbase pair at k = 31 (kbo_tpu's tests/test_index_sharded_map.py
    shape, halved), both indexes and both packages' MapOpts."""
    k = 31
    genome, query = _pair(12_000, seed=9)
    t_idx, j_idx = _indexes([query], k)
    return genome, t_idx, j_idx, _map_opts(kbo_tpu_torch, k), \
        _map_opts(kbo_tpu, k)


@pytest.fixture(scope="module")
def j_index_sharded_maps(map_case):
    """kbo_tpu's index-sharded map of the whole genome and of its three
    contigs, in one batch (one compile): each contig maps on its own, so
    entry 0 is the 1-contig map and entries 1-3 the 3-contig one."""
    genome, _, j_idx, _, j_mo = map_case
    return jmesh.map_batch_index_sharded(
        [genome, *_three(genome)], j_idx, j_mo,
        jmesh.make_mesh(8, axis="model"))


def _three(genome):
    return [genome[:4000], genome[4000:7500], genome[7500:]]


@pytest.mark.parametrize("n_contigs", [1, 3])
def test_index_sharded_map_equals_kbo_tpu(map_case, j_index_sharded_maps,
                                          n_contigs):
    genome, t_idx, _, t_mo, _ = map_case
    refs = [genome] if n_contigs == 1 else _three(genome)
    single = tapi.map_batch(refs, t_idx, t_mo, device="cpu")
    want = (j_index_sharded_maps[:1] if n_contigs == 1
            else j_index_sharded_maps[1:])
    reset_stats()
    got = tmesh.map_batch_index_sharded(
        refs, t_idx, t_mo, tmesh.make_mesh(8, axis="model", device="cpu"))
    assert got == want == single
    stats = get_stats().as_dict()
    assert stats["gaps_filled"] > 0 and stats["left_ext_rounds"] > 0


@pytest.mark.parametrize("n_shards", [3, 4])
def test_index_sharded_map_equals_single_device(map_case, n_shards):
    """Both formats, and gap filling alone."""
    genome, t_idx, _, t_mo, _ = map_case
    refs = _three(genome)
    mesh = tmesh.make_mesh(n_shards, axis="model", device="cpu")
    for opts in (t_mo, kbo_tpu_torch.MapOpts(
            format=False, sbwt_build_opts=t_mo.sbwt_build_opts),
            kbo_tpu_torch.MapOpts(call_variants=False)):
        assert tmesh.map_batch_index_sharded(refs, t_idx, opts, mesh) == \
            tapi.map_batch(refs, t_idx, opts, device="cpu")


def test_index_sharded_map_refusals(map_case):
    genome, t_idx, _, t_mo, _ = map_case
    model = tmesh.make_mesh(2, axis="model", device="cpu")
    rc = kbo_tpu_torch.MapOpts(sbwt_build_opts=kbo_tpu_torch.BuildOpts(
        k=31, add_revcomp=True))
    with pytest.raises(ValueError, match="forward strand"):
        tmesh.map_batch_index_sharded([genome], t_idx, rc, model)
    with pytest.raises(ValueError, match="one-axis 'model' mesh"):
        tmesh.map_batch_index_sharded([genome], t_idx, t_mo, tmesh.make_mesh(
            2, device="cpu"))
    with pytest.raises(ValueError, match="'data', 'model'"):
        tmesh.map_batch_2d_sharded([genome], t_idx, t_mo, model)
    for n in (4, None, (2, 2, 1)):
        with pytest.raises(ValueError, match="needs n_devices"):
            tmesh.make_mesh(n, axis=("data", "model"), device="cpu")
    assert tmesh.map_batch_index_sharded([], t_idx, t_mo, model) == []
