"""The port's prefix-sharded index placement (kbo_tpu_torch.parallel.mesh
over a one-axis ``model`` mesh) on the CPU: ``Sharded3Index``,
``ms3_rows_sweep_index_sharded`` and ``matches_batch_index_sharded``, and
the per-shard ``kernels.ms.ms3_rows_partial_core`` /
``ms3_rows_from_packed``.

Each is held against kbo_tpu's function of the same name over
``make_mesh(8, axis="model")`` (tests/conftest.py gives JAX 8 CPU devices)
and against the port's single-device path at 3, 4 and 8 CPU shards: a
table whose row count does not divide the shard count (the last shard
padded with all-ones columns), and an index with fewer rows than shards
(whole shards of padding; kbo_tpu does not raise on it, and neither does
the port). Exact equality throughout; the rows of the rows join where
``uniq`` holds, as kbo_tpu's own test compares them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.kernels import ms as jms
from kbo_tpu.parallel import mesh as jmesh
from kbo_tpu.pipeline import pad_batch as jpad_batch
from kbo_tpu_torch import engine as tengine
from kbo_tpu_torch import pipeline as tpipe
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import mapsweep as tmap
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pair(n, seed=3):
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(500, n - 500, 900):
        query[p] = BASES[rng.integers(0, 4)]
    del query[n // 2 : n // 2 + 3]
    return ref, bytes(query)


def _indexes(seqs, k, **kw):
    return (kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=k, **kw)),
            kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=k, **kw)))


def _single_rows(t_idx, codes, k):
    dev = tengine.device_index(t_idx, "cpu")
    return tmap.ms3_rows_sweep(dev.keys3, dev.rows_packed,
                               torch.from_numpy(codes), k)


def _assert_rows_equal(got, want):
    ms, uniq, rows = (np.asarray(x) for x in got)
    ms_w, uniq_w, rows_w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ms, ms_w)
    np.testing.assert_array_equal(uniq, uniq_w)
    np.testing.assert_array_equal(rows[uniq_w], rows_w[uniq_w])


@pytest.fixture(scope="module")
def rows_case():
    """A 12 kbase pair at k = 31 (SNPs and a deletion), both indexes, the
    streamed side as a bucketed [1, L] batch, the single-device sweep."""
    k = 31
    ref, query = _pair(12_000, seed=3)
    t_idx, j_idx = _indexes([query], k, build_select=True)
    codes, _ = tpipe.pad_batch([encode_ascii(ref)], bucket=True)
    return k, t_idx, j_idx, codes, _single_rows(t_idx, codes, k)


def test_rows_sweep_equals_kbo_tpu_8_shards(rows_case):
    k, t_idx, j_idx, codes, single = rows_case
    jm = jmesh.make_mesh(8, axis="model")
    want = jmesh.ms3_rows_sweep_index_sharded(
        jmesh.Sharded3Index(j_idx, jm), codes, jm)
    tm = tmesh.make_mesh(8, axis="model", device="cpu")
    got = tmesh.ms3_rows_sweep_index_sharded(
        tmesh.Sharded3Index(t_idx, tm), codes, tm)
    assert all(g.shape == codes.shape for g in got)
    _assert_rows_equal(got, want)
    _assert_rows_equal(got, single)
    assert int(got[1].sum()) > codes.shape[1] // 2


@pytest.mark.parametrize("n_shards", [3, 4])
def test_rows_sweep_equals_single_device(rows_case, n_shards):
    """The row count does not divide the shard count: the last shard ends
    in all-ones pad columns; a torch tensor batch works as a numpy one."""
    k, t_idx, _, codes, single = rows_case
    assert t_idx.n_rows % n_shards != 0
    tm = tmesh.make_mesh(n_shards, axis="model", device="cpu")
    sidx = tmesh.Sharded3Index(t_idx, tm)
    _assert_rows_equal(tmesh.ms3_rows_sweep_index_sharded(sidx, codes, tm),
                       single)
    _assert_rows_equal(tmesh.ms3_rows_sweep_index_sharded(
        sidx, torch.from_numpy(codes), tm), single)


def test_partial_core_and_finish_equal_kbo_tpu(rows_case):
    """One shard's half of the join (the middle third of the table, its
    global LCS columns and row offset) and the finish over the max of the
    three shards' packs, against kbo_tpu's two functions."""
    k, t_idx, _, codes, single = rows_case
    buf = np.concatenate(
        [np.full((1, k - 1), tms.INVALID, np.uint8), codes], axis=1
    ).reshape(-1)
    keys3 = np.ascontiguousarray(t_idx.keys3, dtype=np.uint32)
    n = keys3.shape[1]
    m = -(-n // 3)
    lcs = np.asarray(t_idx.lcs, dtype=np.uint32)
    up = np.append(lcs[1:], 0).astype(np.uint32)
    packs_t, packs_j = [], []
    partial_j = jax.jit(jms.ms3_rows_partial_core, static_argnames=("k",))
    for i in range(3):
        lo, hi = i * m, min((i + 1) * m, n)
        k3 = np.full((keys3.shape[0], m), 0xFFFFFFFF, np.uint32)
        k3[:, : hi - lo] = keys3[:, lo:hi]
        dn = np.zeros(m, np.uint32)
        dn[: hi - lo] = lcs[lo:hi]
        u = np.zeros(m, np.uint32)
        u[: hi - lo] = up[lo:hi]
        packs_t.append(tms.ms3_rows_partial_core(
            torch.from_numpy(k3.view(np.int32)), torch.from_numpy(dn.astype(
                np.uint8)), torch.from_numpy(u.astype(np.uint8)), lo,
            torch.from_numpy(buf), k))
        packs_j.append(partial_j(
            jnp.asarray(k3), jnp.asarray(dn), jnp.asarray(u), jnp.int32(lo),
            jnp.asarray(buf), k=k))
    for (ft, bt), (fj, bj) in zip(packs_t, packs_j):
        assert ft.dtype == bt.dtype == torch.int64
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    fp = torch.maximum(torch.maximum(packs_t[0][0], packs_t[1][0]),
                       packs_t[2][0])
    bp = torch.maximum(torch.maximum(packs_t[0][1], packs_t[1][1]),
                       packs_t[2][1])
    got = tms.ms3_rows_from_packed(fp, bp, t_idx.n_rows, k)
    want = jms.ms3_rows_from_packed(jnp.asarray(fp.numpy()),
                                    jnp.asarray(bp.numpy()),
                                    jnp.int32(t_idx.n_rows), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    s = slice(k - 1, k - 1 + codes.shape[1])
    _assert_rows_equal([x[s][None] for x in got], single)


def test_partial_core_asserts_the_packed_limit():
    """n_shard + T < 2^24 per shard (the 24-bit slot id), asserted as the
    rows join asserts it."""
    keys3 = torch.zeros((1, 4), dtype=torch.int32)
    lcs = torch.zeros(4, dtype=torch.uint8)
    buf = torch.empty((1 << 24) - 4, dtype=torch.uint8, device="meta")
    with pytest.raises(AssertionError, match="16.7M slots"):
        tms.ms3_rows_partial_core(keys3, lcs, lcs, 0, buf, 31)


def _queries(rng, ref, n):
    out = []
    for _ in range(n):
        L = int(rng.integers(80, 400))
        s = int(rng.integers(0, len(ref) - L))
        q = bytearray(ref[s : s + L])
        for p in rng.integers(0, L, 3):
            q[p] = BASES[rng.integers(0, 4)]
        out.append(encode_ascii(bytes(q)))
    return out


@pytest.fixture(scope="module")
def matches_case():
    rng = np.random.default_rng(9)
    ref = BASES[rng.integers(0, 4, 3000)].tobytes()
    t_idx, j_idx = _indexes([ref], 21)
    t = random_match_threshold(21, t_idx.n_kmers, 4, 1e-7)
    queries = _queries(rng, ref, 9)
    single = tpipe.matches_batch(t_idx, queries, t, "cpu")
    return t_idx, j_idx, t, queries, single


def test_matches_equals_kbo_tpu_8_shards(matches_case):
    t_idx, j_idx, t, queries, single = matches_case
    want = jmesh.matches_batch_index_sharded(
        j_idx, queries, t, mesh=jmesh.make_mesh(8, axis="model"))
    got = tmesh.matches_batch_index_sharded(
        t_idx, queries, t, tmesh.make_mesh(8, axis="model", device="cpu"))
    assert len(got) == len(want) == len(single) == 9
    for g, w, s, q in zip(got, want, single, queries):
        assert g.dtype == np.uint8 and g.shape == q.shape
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("n_shards", [3, 4])
def test_matches_equals_single_device(matches_case, n_shards):
    t_idx, _, t, queries, single = matches_case
    assert t_idx.keys2.shape[1] % n_shards != 0
    got = tmesh.matches_batch_index_sharded(
        t_idx, queries, t, tmesh.make_mesh(n_shards, axis="model",
                                           device="cpu"))
    for g, s in zip(got, single):
        np.testing.assert_array_equal(g, s)


def test_fewer_rows_than_shards():
    """4 rows over 8 shards: shards 4-7 hold only pad columns. kbo_tpu
    computes it without complaint, and so does the port: both functions
    equal kbo_tpu's and the single-device paths."""
    t_idx, j_idx = _indexes([b"ACG"], 3)
    assert t_idx.n_rows < 8
    queries = [encode_ascii(b"ACGTACG"), encode_ascii(b"GGACGA"),
               encode_ascii(b"TTTT")]
    tm = tmesh.make_mesh(8, axis="model", device="cpu")
    jm = jmesh.make_mesh(8, axis="model")
    got = tmesh.matches_batch_index_sharded(t_idx, queries, 2, tm)
    want = jmesh.matches_batch_index_sharded(j_idx, queries, 2, mesh=jm)
    single = tpipe.matches_batch(t_idx, queries, 2, "cpu")
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, s)
    codes, _ = tpipe.pad_batch(queries)
    sidx = tmesh.Sharded3Index(t_idx, tm)
    assert sidx.shard_cols == 1
    assert [int((k3 == -1).all()) for k3 in sidx.keys3] == [0] * 4 + [1] * 4
    got = tmesh.ms3_rows_sweep_index_sharded(sidx, codes, tm)
    jcodes, _ = jpad_batch(queries)
    want = jmesh.ms3_rows_sweep_index_sharded(
        jmesh.Sharded3Index(j_idx, jm), jcodes, jm)
    _assert_rows_equal(got, want)
    _assert_rows_equal(got, _single_rows(t_idx, codes, 3))


def test_sharded_memory_footprint():
    """Each shard holds 1/n of the key columns on its own device, as
    kbo_tpu's placement does (tests/test_index_sharded_map.py:85): shard
    i is columns [i*m, (i+1)*m) of keys3 with its global LCS values, and no
    tensor holds the whole table."""
    k = 31
    _, query = _pair(16_000, seed=13)
    t_idx, j_idx = _indexes([query], k, build_select=True)
    jm = jmesh.make_mesh(8, axis="model")
    jsidx = jmesh.Sharded3Index(j_idx, jm)
    j_cols = jsidx.keys3.sharding.shard_shape(jsidx.keys3.shape)[1]
    for n_shards in (3, 8):
        tm = tmesh.make_mesh(n_shards, axis="model", device="cpu")
        sidx = tmesh.Sharded3Index(t_idx, tm)
        m = sidx.shard_cols
        n = t_idx.n_rows
        if n_shards == 8:
            assert m == j_cols
        assert m * n_shards >= n > (m - 1) * n_shards and m < n
        keys3 = np.ascontiguousarray(t_idx.keys3, np.uint32).view(np.int32)
        lcs = np.asarray(t_idx.lcs)
        assert len(sidx.keys3) == len(sidx.down) == len(sidx.up) == n_shards
        for i in range(n_shards):
            lo, hi = i * m, min((i + 1) * m, n)
            k3, dn, up = sidx.keys3[i], sidx.down[i], sidx.up[i]
            assert k3.shape == (keys3.shape[0], m) and dn.shape == up.shape \
                == (m,)
            assert k3.device == tm.devices[i]
            np.testing.assert_array_equal(k3[:, : hi - lo].numpy(),
                                          keys3[:, lo:hi])
            assert (k3[:, hi - lo :] == -1).all()
            np.testing.assert_array_equal(dn[: hi - lo].numpy(), lcs[lo:hi])
            np.testing.assert_array_equal(
                up[: hi - lo].numpy(), np.append(lcs, 0)[lo + 1 : hi + 1])
            assert sidx.shard_bytes == k3.nbytes + dn.nbytes + up.nbytes


def test_model_mesh_rules():
    """pmax is the elementwise max on the first device, and across two
    processes without their process group it raises naming
    initialize_from_env; the prefix-sharded functions refuse a data
    mesh."""
    tm = tmesh.make_mesh(3, axis="model", device="cpu")
    parts = [torch.tensor([1, 5, -2]), torch.tensor([4, 0, -3]),
             torch.tensor([2, 2, -1])]
    got = tmesh.pmax(tm, parts)
    assert got.tolist() == [4, 5, -1] and got.device == tm.devices[0]
    two = tmesh.Mesh([torch.device("cpu")] * 4, ("model",), process_count=2)
    with pytest.raises(RuntimeError, match="initialize_from_env"):
        tmesh.pmax(two, parts)
    t_idx, _ = _indexes([b"ACGTTGCAAGGCTTACG" * 4], 5)
    dm = tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="one-axis 'model' mesh"):
        tmesh.Sharded3Index(t_idx, dm)
    with pytest.raises(ValueError, match="one-axis 'model' mesh"):
        tmesh.matches_batch_index_sharded(
            t_idx, [encode_ascii(b"ACGTTG")], 2, dm)
