"""The port's mesh layer (kbo_tpu_torch.parallel.mesh, the ``data`` axis) on
the CPU: the mesh and its rules, placement and collectives, the mesh-only
helpers, data-parallel find and call.

Each sharded function is held once against kbo_tpu's own mesh function on
the 8-device CPU mesh that tests/conftest.py gives kbo_tpu (8 CPU shards in
the port), and against the port's single-device result at 3 shards, so
that padding rows and uneven chunks show. The API cases compare with
kbo_tpu's single-device API, which kbo_tpu's tests pin to its mesh output
(tests/test_parallel.py, tests/test_mesh_map.py). Every comparison is
exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import api as japi
from kbo_tpu import pipeline as jpipe
from kbo_tpu.kernels import postprocess as jpost
from kbo_tpu.parallel import mesh as jmesh
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch import pipeline as tpipe
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import postprocess as tpost
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _queries(rng, ref, n, lo=50, hi=300):
    out = []
    for _ in range(n):
        L = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(ref) - L))
        q = bytearray(ref[s : s + L])
        for p in rng.integers(0, L, 3):
            q[p] = BASES[rng.integers(0, 4)]
        out.append(bytes(q))
    return out


def _rles(lists):
    """RLE lists as tuples: the two packages' RLE classes differ."""
    return [[dataclasses.astuple(r) for r in rl] for rl in lists]


def _indexes(seqs, k):
    return (kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=k)),
            kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=k)))


@pytest.fixture(scope="module")
def find_case():
    """An index at k = 21, 13 queries (not a multiple of 3 or 8), one torn
    by an unrelated insert (several segments), and the threshold."""
    rng = np.random.default_rng(11)
    ref = BASES[rng.integers(0, 4, 2500)].tobytes()
    queries = _queries(rng, ref, 12)
    torn = bytearray(ref[100:400])
    torn[120:180] = BASES[rng.integers(0, 4, 60)].tobytes()
    queries.append(bytes(torn))
    t_idx, j_idx = _indexes([ref], 21)
    t = random_match_threshold(21, t_idx.n_kmers, 4, 1e-7)
    return ref, queries, t_idx, j_idx, t


# ------------------------------------------------------------ the mesh


def test_make_mesh_rules():
    m = tmesh.make_mesh(3, device="cpu")
    assert m.devices.size == 3 and m.shape == {"data": 3}
    assert m.axis_names == ("data",)
    assert all(d == torch.device("cpu") for d in m.devices)
    assert list(m.local_shards) == [0, 1, 2] and m.process_count == 1
    with pytest.raises(ValueError, match="n_devices"):
        tmesh.make_mesh(device="cpu")
    if not torch.cuda.is_available():
        # no quiet CPU mesh where cards were asked for
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tmesh.make_mesh(2, device=dev)


@pytest.mark.parametrize("build", [
    (lambda: tmesh.make_mesh(2, axis="model", device="cpu"), "model"),
    (lambda: tmesh.Mesh([torch.device("cpu")] * 2, ("model",)), "model"),
    (lambda: tmesh.make_mesh((2, 2), axis=("data", "model"), device="cpu"),
     "2-D"),
    (lambda: tmesh.Mesh(np.array([torch.device("cpu")] * 4,
                                 dtype=object).reshape(2, 2), ("data",)),
     "mismatch 1-D"),
    (lambda: tmesh.Mesh([torch.device("cpu")] * 4, ("data", "model")),
     "mismatch 2-D"),
])
def test_model_and_2d_meshes_build_the_api_refuses_them(build):
    """A one-axis 'model' mesh and the 2-D ('data', 'model') mesh build
    (the prefix-sharded placement, tests/test_torch_mesh_model.py and
    tests/test_torch_mesh_model_map.py), and the API entry points, which
    shard batches over a one-axis 'data' mesh, refuse them naming the
    functions that take them; a device array whose dimensions do not match
    the axes raises."""
    make, kind = build
    if kind.startswith("mismatch"):
        ndim = kind.split()[1]
        with pytest.raises(ValueError, match=f"takes a {ndim} device array"):
            make()
        return
    mesh = make()
    if kind == "2-D":
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 2, "model": 2}
        assert mesh.devices.shape == (2, 2) and list(mesh.local_shards) == [
            0, 1, 2, 3]
    else:
        assert mesh.axis_names == ("model",) and mesh.shape == {"model": 2}
        assert mesh.devices.size == 2 and list(mesh.local_shards) == [0, 1]
    rng = np.random.default_rng(2)
    ref = BASES[rng.integers(0, 4, 1200)].tobytes()
    t_idx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=9))
    calls = (
        lambda: tapi.find_batch([ref[:100]], t_idx, mesh=mesh),
        lambda: tapi.call(t_idx, ref, mesh=mesh),
        lambda: tapi.map_batch([ref[:300]], t_idx, mesh=mesh),
    )
    for fn in calls:
        with pytest.raises(ValueError, match="matches_batch_index_sharded"):
            fn()


def test_placement_and_collectives():
    m = tmesh.make_mesh(3, device="cpu")
    arr = np.arange(24, dtype=np.int32).reshape(6, 4)
    parts = tmesh.shard_rows(m, arr)
    assert [p.tolist() for p in parts] == [arr[:2].tolist(), arr[2:4].tolist(),
                                           arr[4:].tolist()]
    assert torch.equal(tmesh.all_gather(m, parts), torch.from_numpy(arr))
    assert torch.equal(tmesh.all_gather(m, parts, dim=1),
                       torch.from_numpy(np.concatenate(
                           [arr[:2], arr[2:4], arr[4:]], axis=1)))
    got = tmesh.psum(m, parts)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.from_numpy(arr[:2] + arr[2:4] + arr[4:]))
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_rows(m, arr[:5])
    # one copy per distinct device: the three shards share it
    x = torch.arange(5)
    rep = tmesh.replicate(m, x)
    assert rep[0] is rep[1] is rep[2]
    # the index replicas: one DeviceIndex for the one device, kept on the
    # index for this mesh
    t_idx = kbo_tpu_torch.build(
        [BASES[np.random.default_rng(1).integers(0, 4, 300)].tobytes()],
        kbo_tpu_torch.BuildOpts(k=9))
    reps = tmesh.index_replicas(t_idx, m)
    assert reps[0] is reps[1] is reps[2]
    assert tmesh.index_replicas(t_idx, m) is reps


def test_replica_of_a_device_built_index_moves_its_tables():
    full = tapi.build_device([b"ACGTTGCAAGGCTTACG" * 20],
                             kbo_tpu_torch.BuildOpts(k=9), full=True,
                             device="cpu")
    full.keys3  # noqa: B018 (cached tables move too)
    rep = tmesh._replica(full, torch.device("meta"))
    assert type(rep) is type(full) and rep.device == torch.device("meta")
    for name in ("keys2", "cap2", "keys3", "row_pos"):
        assert getattr(rep, name).device == torch.device("meta")
        assert getattr(full, name).device == torch.device("cpu")
    assert rep.n_rows == full.n_rows and rep.k == full.k


def test_collectives_need_one_process():
    """A collective over a mesh of two processes needs their process group:
    without one it raises, naming initialize_from_env, and never computes a
    one-process answer."""
    m = tmesh.Mesh([torch.device("cpu")] * 4, process_count=2,
                   process_index=1)
    assert list(m.local_shards) == [2, 3]
    with pytest.raises(RuntimeError, match="initialize_from_env"):
        tmesh.all_gather(m, [torch.zeros(1)] * 4)


# ------------------------------------------------ the mesh-only helpers


def test_pack_codes_host_and_device_decode():
    rng = np.random.default_rng(3)
    Q, L = 5, 64
    codes = rng.integers(1, 5, (Q, L)).astype(np.uint8)
    lengths = np.array([64, 1, 33, 0, 60], dtype=np.int32)
    got = tpipe.pack_codes_host(codes, lengths)
    want = jpipe.pack_codes_host(codes, lengths)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    dec = tpipe.decode_packed_codes_device(torch.from_numpy(got),
                                           torch.from_numpy(lengths))
    jdec = np.asarray(jpipe.decode_packed_codes_device(jnp.asarray(want),
                                                       jnp.asarray(lengths)))
    assert dec.dtype == torch.uint8 and np.array_equal(dec.numpy(), jdec)
    in_len = np.arange(L)[None, :] < lengths[:, None]
    assert np.array_equal(dec.numpy(), np.where(in_len, codes, 255))
    # an N inside a row's length, or L % 4 != 0: no packed form
    with_n = codes.copy()
    with_n[2, 10] = 0
    for c, le in ((with_n, lengths), (codes[:, :62], np.minimum(lengths, 62))):
        assert tpipe.pack_codes_host(c, le) is None
        assert jpipe.pack_codes_host(c, le) is None
    # past the length anything goes
    tail = codes.copy()
    tail[1, 5:] = 255
    assert np.array_equal(tpipe.pack_codes_host(tail, lengths),
                          jpipe.pack_codes_host(tail, lengths))


@pytest.mark.parametrize("cap", [2, 16, 80])
def test_rle_segments_core(cap):
    rng = np.random.default_rng(cap)
    Q, L = 6, 64
    chars = rng.choice(np.frombuffer(b"MMMMRRX- I", np.uint8), (Q, L))
    lengths = np.array([64, 0, 1, 17, 40, 63], dtype=np.int32)
    got = tpost.rle_segments_core(torch.from_numpy(chars),
                                  torch.from_numpy(lengths), cap)
    want = np.asarray(jpost.rle_segments_core(jnp.asarray(chars),
                                              jnp.asarray(lengths), cap))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ------------------------------------------------- data-parallel find


def test_matches_batch_sharded(find_case):
    _, queries, t_idx, j_idx, t = find_case
    codes = [encode_ascii(q) for q in queries]
    got8 = tmesh.matches_batch_sharded(t_idx, codes, t,
                                       tmesh.make_mesh(8, device="cpu"))
    want8 = jmesh.matches_batch_sharded(j_idx, codes, t, jmesh.make_mesh(8))
    single = tpipe.matches_batch(t_idx, codes, t, "cpu")
    got3 = tmesh.matches_batch_sharded(t_idx, codes, t,
                                       tmesh.make_mesh(3, device="cpu"))
    assert len(got8) == len(want8) == len(got3) == 13
    for a, b, c, d in zip(got8, want8, got3, single):
        assert a.dtype == np.uint8
        assert np.array_equal(a, b) and np.array_equal(c, d)


def test_find_rle_batch_sharded(find_case):
    ref, queries, t_idx, j_idx, t = find_case
    codes = [encode_ascii(q) for q in queries]
    got8 = tmesh.find_rle_batch_sharded(t_idx, codes, t,
                                        tmesh.make_mesh(8, device="cpu"))
    want8 = jmesh.find_rle_batch_sharded(j_idx, codes, t, jmesh.make_mesh(8))
    assert _rles(got8) == _rles(want8) and any(len(r) > 1 for r in got8)
    m3 = tmesh.make_mesh(3, device="cpu")
    assert tmesh.find_rle_batch_sharded(t_idx, codes, t, m3) == \
        tpipe.find_rle_batch(t_idx, codes, t, "cpu")
    # an N run defeats the packed upload: the raw batch goes up instead
    with_n = bytearray(ref[500:900])
    with_n[50:60] = b"N" * 10
    codes_n = codes + [encode_ascii(bytes(with_n))]
    assert tpipe.pack_codes_host(*tpipe.pad_batch(codes_n, bucket=True)) \
        is None
    assert tmesh.find_rle_batch_sharded(t_idx, codes_n, t, m3) == \
        tpipe.find_rle_batch(t_idx, codes_n, t, "cpu")


def test_find_rle_batch_sharded_cap_retry(find_case, monkeypatch):
    """Queries stitched from 40-base pieces of the reference, each followed
    by 20 unrelated bases, carry a segment per piece: a shard's first table
    (128 segments) overflows and the retry's table holds them all."""
    ref, _, t_idx, _, t = find_case
    rng = np.random.default_rng(4)
    queries = [b"".join(ref[s : s + 40] + BASES[rng.integers(0, 4, 20)]
                        .tobytes() for s in rng.integers(0, 2400, 80))
               for _ in range(6)]
    codes = [encode_ascii(q) for q in queries]
    caps = []
    real = tmesh.rle_segments_global_core

    def spy(chars, lengths, cap):
        caps.append(cap)
        return real(chars, lengths, cap)

    monkeypatch.setattr(tmesh, "rle_segments_global_core", spy)
    got = tmesh.find_rle_batch_sharded(t_idx, codes, t,
                                       tmesh.make_mesh(3, device="cpu"))
    assert sorted(set(caps)) == [128, 512]
    assert got == tpipe.find_rle_batch(t_idx, codes, t, "cpu")
    assert sum(len(r) for r in got[:2]) > 128


def _long_case(n=5000, k=31):
    rng = np.random.default_rng(77)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    streamed = bytearray(ref)
    for p in range(100, n - 100, 250):  # dense SNPs: resets near the halos
        streamed[p] = BASES[rng.integers(0, 4)]
    streamed[2000:2400] = BASES[rng.integers(0, 4, 400)].tobytes()
    streamed[1] = BASES[rng.integers(0, 4)]  # the sequence-start rule
    return ref, bytes(streamed)


def test_matches_long_sharded():
    ref, streamed = _long_case()
    t_idx, j_idx = _indexes([ref], 31)
    t = random_match_threshold(31, t_idx.n_kmers, 4, 1e-7)
    codes = encode_ascii(streamed)
    got = tmesh.matches_long_sharded(t_idx, codes, t,
                                     tmesh.make_mesh(8, device="cpu"))
    want = jmesh.matches_long_sharded(j_idx, codes, t, jmesh.make_mesh(8))
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    chars, ms = tpipe.matches_ms_batch(t_idx, [codes], t, "cpu")
    got3 = tmesh.matches_long_sharded(t_idx, codes, t,
                                      tmesh.make_mesh(3, device="cpu"))
    assert np.array_equal(got3[0], chars[0]) and np.array_equal(got3[1], ms[0])


@pytest.mark.parametrize("n_shards,L", [(8, 57), (8, 120), (32, 240),
                                        (32, 249)])
def test_matches_long_sharded_trailing_shards(n_shards, L):
    """Ceil-division chunks can start trailing shards at or past the
    sequence end (tests/test_parallel.py:112-176): they contribute
    nothing."""
    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, 4000)].tobytes()
    t_idx = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=3))
    codes = encode_ascii(genome[:L])
    chars, ms = tmesh.matches_long_sharded(
        t_idx, codes, 2, tmesh.make_mesh(n_shards, device="cpu"))
    want_chars, want_ms = tpipe.matches_ms_batch(t_idx, [codes], 2, "cpu")
    assert np.array_equal(ms, want_ms[0]) and np.array_equal(chars,
                                                             want_chars[0])
    with pytest.raises(ValueError, match="too short"):
        tmesh.matches_long_sharded(t_idx, codes[:40], 2,
                                   tmesh.make_mesh(n_shards, device="cpu"))


@pytest.mark.parametrize("gap", [0, 5])
def test_find_batch_over_a_mesh(find_case, gap):
    _, queries, t_idx, j_idx, _ = find_case
    got = tapi.find_batch(queries, t_idx, kbo_tpu_torch.FindOpts(
        max_gap_len=gap), mesh=tmesh.make_mesh(3, device="cpu"))
    assert _rles(got) == _rles(japi.find_batch(queries, j_idx,
                                               kbo_tpu.FindOpts(max_gap_len=gap)))
    seq = tapi.build_device([b"ACGT" * 100], kbo_tpu_torch.BuildOpts(k=21),
                            device="cpu")
    m = tmesh.make_mesh(2, device="cpu")
    for kw in ({"mesh": m, "device": "cpu"}, {"mesh": m}):
        with pytest.raises(ValueError, match="over a mesh"):
            tapi.find_batch(queries, seq if "device" not in kw else t_idx,
                            kbo_tpu_torch.FindOpts(), **kw)


def _tuples(variants):
    return [(v.query_pos, v.query_chars, v.ref_chars) for v in variants]


def test_ms_values_many_sharded_and_call_over_a_mesh():
    rng = np.random.default_rng(9)
    n = 30000
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    q = bytearray(ref)
    for pos in range(700, n - 700, 900):
        q[pos] = BASES[(np.searchsorted(BASES, q[pos]) + 1) % 4]
    del q[n // 2 : n // 2 + 2]
    t_bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    j_bo = kbo_tpu.BuildOpts(k=51, build_select=True)
    t_idx, j_idx = kbo_tpu_torch.build([bytes(q)], t_bo), kbo_tpu.build(
        [bytes(q)], j_bo)

    kmers = [encode_ascii(ref[s : s + 51]) for s in range(0, 2000, 97)]
    got = tmesh.ms_values_many_sharded(t_idx, kmers,
                                       tmesh.make_mesh(8, device="cpu"))
    want = jmesh.ms_values_many_sharded(j_idx, kmers, jmesh.make_mesh(8))
    assert all(a.dtype == np.int64 and np.array_equal(a, b)
               for a, b in zip(got, want))

    want_calls = _tuples(japi.call(j_idx, ref, kbo_tpu.CallOpts(
        sbwt_build_opts=j_bo)))
    got = tapi.call(t_idx, ref, kbo_tpu_torch.CallOpts(sbwt_build_opts=t_bo),
                    mesh=tmesh.make_mesh(3, device="cpu"))
    assert _tuples(got) == want_calls and want_calls
    with pytest.raises(ValueError, match="no device"):
        tapi.call(t_idx, ref, kbo_tpu_torch.CallOpts(sbwt_build_opts=t_bo),
                  mesh=tmesh.make_mesh(3, device="cpu"), device="cpu")


def test_map_sweep_compact_sharded():
    """The classic mesh route's sweep: per-shard outputs in shard order are
    kbo_tpu's sharded sweep (inside each row's length)."""
    rng = np.random.default_rng(2)
    genome = BASES[rng.integers(0, 4, 6000)].tobytes()
    t_idx, j_idx = _indexes([genome], 31)
    t = random_match_threshold(31, t_idx.n_kmers, 4, 1e-7)
    refs = [genome[s : s + 700] for s in (0, 900, 2500, 4000, 5100)]
    refs[1] = refs[1][:300] + BASES[rng.integers(0, 4, 80)].tobytes()
    codes, lengths = tmesh.pad_rows(*tpipe.pad_batch(
        [encode_ascii(r) for r in refs], 1024), 8)
    parts = tmesh.map_sweep_compact_sharded(
        t_idx, codes, lengths, t, tmesh.make_mesh(8, device="cpu"))
    got = [torch.cat([p[j] for p in parts]).numpy() for j in range(7)]
    from kbo_tpu.engine import device_index as jdevice_index

    j_codes, j_out = jmesh.map_sweep_compact_sharded(
        jdevice_index(j_idx), codes, lengths, t, jmesh.make_mesh(8))
    want = [np.asarray(j_codes)] + [np.asarray(x) for x in j_out]
    in_len = np.arange(1024)[None, :] < lengths[:, None]
    assert np.array_equal(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):  # chars, ms
        assert np.array_equal(np.where(in_len, g, 0), np.where(in_len, w, 0))
    assert np.array_equal(got[3], want[3])  # counts
    for g, w, col in zip(got[4:], want[4:], (0, 1, 1)):
        # the compacted positions, as many as each row counts
        for q in range(len(refs)):
            c = int(got[3][q, col])
            assert np.array_equal(g[q, :c], w[q, :c])
    assert got[3][:, 0].sum() > 0 and got[3][:, 1].sum() > 0
